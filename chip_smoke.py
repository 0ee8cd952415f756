"""chip_smoke.py — drive the receiver's main path once on the GPU and check it.

Usage (from the repository root):
  python chip_smoke.py               # one card: every phase below
  python chip_smoke.py --four-cards  # four cards: the sharded paths only

One-card phases, each through the entry points a user calls, at the
reference's design point (20 Msps complex, ~2M-sample ticks, 2 s of
signal):
  wbfm      apps.receive: WBFM at 20 Msps, int8 IQ (synthetic station)
  nbfm      apps.receive: NBFM at 20 Msps, cf32
  am        apps.receive: AM at 10 Msps, int8 IQ
  bank      apps.channels: 64-channel PFB FM bank at 20.48 Msps
  file      apps.receive on a recorded int8 capture, read once through
            FileIqSource and once through the native ring (--native)
  accuracy  each DSP stage against a float64 NumPy/SciPy reference at real
            widths, plus the FIR precision ladder (error and time per tick)
  bench     bench.py and bench_configs.py configs 1-4, once each

Four-card phases: the 100 MHz WBFM capture time-sharded (chain-wide and
stagewise halos) and the 64-channel bank channel-sharded, each compared
with the same input unsharded on one card.

Output: a device line first; one JSON line per phase with its compile
seconds, wall seconds, check results, peak device memory and the card's
name and power limit; last, {"ok": true, "device": {...}}.  The script
exits non-zero, without that last line, when JAX's default device is not
a GPU, when the repository is not beside it, or when any phase fails.
Everything runs in this one process: a second JAX process could not get
the card's memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile
import time
import traceback
import wave

import numpy as np

#: audio checks: the synthetic stations' tones must come back within 5 % of
#: the amplitude the chain's gain and de-emphasis give them, and with an SNR
#: above the BASELINE.md -60 dB accuracy bar.
AMP_TOL = 0.05
MIN_SNR_DB = 60.0
#: NBFM's 15 kHz channel filter trims the FM sidebands of its 5 kHz
#: deviation beyond 7.5 kHz; the harmonic distortion that leaves bounds its
#: audio SNR near 52 dB on any device (float64 rehearsal), so its bar is
#: lower than the others'.
NBFM_MIN_SNR_DB = 45.0

#: accuracy tolerances (dB of error power relative to the reference's
#: power).  The RF FIR cascade, whose banded matmul runs at FIR_PRECISION,
#: is held to the -60 dB bar; a precision qualifies as a default only with
#: 10 dB of margin (see ops/fir.py).  The other stages compute in float32
#: with no TF32 step: their error is float32 rounding, about -120 dB;
#: -90 dB leaves room for the card summing in another order.
BAR_DB = -60.0
MARGIN_DB = 10.0
F32_STAGE_DB = -90.0

#: sharded vs unsharded (four cards): the same math, but on other GEMM
#: shapes, for which XLA may pick other algorithms and summation orders.
#: Held to the -100 dB the CPU tests demand (tests/test_parallel.py
#: assert_shard_stable); four H100s measured -129 to -141 dB.
SHARD_DB = -100.0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _read_wav(path: str) -> tuple[float, np.ndarray]:
    with wave.open(path) as w:
        fs = float(w.getframerate())
        x = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    return fs, x.astype(np.float64) / 32767.0


def _deemph_gain(hz: float, tau: float = 75e-6) -> float:
    return 1.0 / math.hypot(1.0, 2 * math.pi * hz * tau)


def _audio_check(path: str, hz: float, expect_amp: float, min_seconds: float,
                 min_snr_db: float = MIN_SNR_DB) -> dict:
    from tpusdr.utils import reference

    fs, x = _read_wav(path)
    amp, snr = reference.tone_fit(x, fs, hz)
    ok = (
        abs(amp - expect_amp) <= AMP_TOL * expect_amp
        and snr > min_snr_db
        and len(x) >= 0.9 * min_seconds * fs
    )
    return {"ok": bool(ok), "amp": amp, "expect_amp": expect_amp, "snr_db": snr,
            "audio_seconds": len(x) / fs}


@contextlib.contextmanager
def _fir_precision(p):
    """Run the FIR paths at ``p`` (ops/fir.py reads FIR_PRECISION when a
    step is traced, so build fresh jitted steps inside)."""
    from tpusdr.ops import fir

    old = fir.FIR_PRECISION
    fir.FIR_PRECISION = p
    try:
        yield
    finally:
        fir.FIR_PRECISION = old


def _time_step(step, state, x, iters: int) -> float:
    """Seconds per call of a jitted streaming step (warm, carried state)."""
    import jax

    state, y = step(state, x)
    jax.block_until_ready(y)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, y = step(state, x)
    jax.block_until_ready((state, y))
    return (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# one-card phases (sizes are arguments so the CPU tests can rehearse them)
# ---------------------------------------------------------------------------


def phase_receiver(mod: str, rf_rate: float, fmt: str, seconds: float,
                   tick: int, workdir: str) -> dict:
    """apps.receive on its synthetic station; check the demodulated tone."""
    from tpusdr.apps import receive
    from tpusdr.models import receiver

    wav_path = os.path.join(workdir, f"{mod}.wav")
    # off any simple fraction of the sample rate: a carrier at fs/8 repeats
    # every 8 samples and its int8 rounding error lands in the channel as
    # envelope distortion (-55 dB for AM) instead of white noise
    offset = 0.1173 * rf_rate
    rc = receive.main([
        "--mod", mod, "--input", "synth", "--format", fmt,
        "--rf-rate", repr(rf_rate), "--offset", repr(offset),
        "--duration", repr(seconds), "--tick", str(tick), "--audio", wav_path,
    ])
    if mod == "am":
        hz, amp = 700.0, 0.25  # 0.5 * 0.5 modulation depth, DC-blocked
    else:
        wide = mod == "wbfm"
        dev = receiver.WBFM_DEVIATION if wide else receiver.NBFM_DEVIATION
        cw = receiver.WBFM_CHANNEL_WIDTH if wide else receiver.NBFM_CHANNEL_WIDTH
        hz, amp = 1000.0, dev / cw * _deemph_gain(1000.0)
    snr_bar = NBFM_MIN_SNR_DB if mod == "nbfm" else MIN_SNR_DB
    out = _audio_check(wav_path, hz, amp, seconds, snr_bar)
    out["ok"] = out["ok"] and rc == 0
    return out


def phase_bank(rf_rate: float, channels: int, seconds: float, tick: int,
               workdir: str) -> dict:
    """apps.channels on its two synthetic stations: channel 2 carries a
    700 Hz tone and channel M-3 a 1200 Hz tone; each must come back clean
    of the other."""
    from tpusdr.apps import channels as channels_app

    out_dir = os.path.join(workdir, "bank")
    k1, k2 = 2, channels - 3
    rc = channels_app.main([
        "--input", "synth", "--rf-rate", repr(rf_rate),
        "--channels", str(channels), "--audio-rate", "16000",
        "--write", f"{k1},{k2}", "--duration", repr(seconds),
        "--tick", str(tick), "--out-dir", out_dir,
    ])
    # the app's stations: deviation min(75 kHz, rate/4) over the channel
    # width (= channel rate), de-emphasised
    rate = rf_rate / channels
    dev = min(75e3, rate / 4)
    res = {}
    for k, hz in ((k1, 700.0), (k2, 1200.0)):
        res[f"ch{k}"] = _audio_check(
            os.path.join(out_dir, f"ch{k:03d}.wav"), hz,
            dev / rate * _deemph_gain(hz), seconds,
        )
    ok = rc == 0 and all(r["ok"] for r in res.values())
    return {"ok": bool(ok), **res}


def phase_file(rf_rate: float, seconds: float, tick: int, workdir: str,
               seed: int = 0) -> dict:
    """Write an int8 capture from ``seed``, then demodulate it through
    FileIqSource and through the native ring; both must carry the tone and
    agree with each other."""
    from tpusdr.apps import receive
    from tpusdr.io import native
    from tpusdr.io.sources import SyntheticIqSource
    from tpusdr.models import receiver
    from tpusdr.utils import reference

    rng = np.random.default_rng(seed)
    offset = float(rng.integers(-8, 9)) * rf_rate / 40  # seeded channel
    n_blocks = int(seconds * rf_rate / tick)
    path = os.path.join(workdir, "capture_int8.iq")
    with open(path, "wb") as f:
        for blk in SyntheticIqSource.fm(
            tick, rf_rate, 1000.0, receiver.WBFM_DEVIATION, offset, "int8",
            n_blocks,
        ):
            blk.tofile(f)
    amp = receiver.WBFM_DEVIATION / receiver.WBFM_CHANNEL_WIDTH * _deemph_gain(1000.0)
    res = {"offset_hz": offset}
    for name, extra in (("file", []), ("native", ["--native"])):
        wav_path = os.path.join(workdir, f"file_{name}.wav")
        rc = receive.main([
            "--mod", "wbfm", "--input", path, "--format", "int8",
            "--rf-rate", repr(rf_rate), "--offset", repr(offset),
            "--duration", repr(seconds), "--tick", str(tick),
            "--audio", wav_path, *extra,
        ])
        res[name] = _audio_check(wav_path, 1000.0, amp, seconds)
        res[name]["ok"] = res[name]["ok"] and rc == 0
    a = _read_wav(os.path.join(workdir, "file_file.wav"))[1]
    b = _read_wav(os.path.join(workdir, "file_native.wav"))[1]
    n = min(len(a), len(b))
    # same bytes, same float conversion (x/128), same chain after it: the
    # two ingest paths must agree to within the 16-bit WAV quantisation
    res["native_vs_file_db"] = reference.err_db(b[:n], a[:n])
    res["native_library"] = native.native_available()
    res["ok"] = bool(
        res["file"]["ok"] and res["native"]["ok"]
        and res["native_library"] and res["native_vs_file_db"] <= BAR_DB
    )
    return res


def phase_accuracy(rf_rate: float = 20e6, tick: int = 2_000_000,
                   bank_channels: int = 64, bank_block: int = 64 * 32768,
                   time_iters: int = 200) -> dict:
    """Every DSP stage of the WBFM receiver and the channelizer against a
    float64 reference at real widths, plus the FIR precision ladder on the
    interferer case (wanted FM channel 40 dB below a carrier)."""
    import jax
    from jax import lax

    from tpusdr.graph import blocks as B
    from tpusdr.models import receiver
    from tpusdr.ops import channelizer as chanops
    from tpusdr.ops import cplx, fir
    from tpusdr.utils import reference

    chain, _ = receiver.fm_receiver(rf_rate, 2.5e6, receiver.WBFM)
    named = dict(chain.blocks)
    front = [(n, b) for n, b in chain.blocks if n.startswith(("shiftfir", "rf_fir"))]
    tick = chain.granule * max(1, tick // chain.granule)
    x = reference.interferer_capture(tick, rf_rate, 2.5e6, -3.7e6, -40.0)
    xp = cplx.from_numpy(x)
    stages = [(np.asarray(b.taps), b.decimation) for _, b in front]
    v64 = reference.shift_fir_cascade(x, front[0][1].inc, stages)

    def front_end(states, v):
        new = []
        for (_, b), s in zip(front, states):
            s, v = b.apply(s, v)
            new.append(s)
        return new, v

    states0 = [b.init_state() for _, b in front]
    res: dict = {"fir_ladder": {}}
    ladder = [
        ("DEFAULT", lax.Precision.DEFAULT),
        ("HIGH", lax.Precision.HIGH),
        ("HIGHEST", lax.Precision.HIGHEST),
        ("BF16_BF16_F32_X3", lax.DotAlgorithmPreset.BF16_BF16_F32_X3),
    ]
    def fresh_step():
        # a new function object per precision: jax.jit caches traces by
        # function, and FIR_PRECISION is read only while tracing
        return jax.jit(lambda s, v: front_end(s, v))

    for name, p in ladder:
        with _fir_precision(p):
            step = fresh_step()
            try:
                _, v = step(states0, xp)
                err = reference.err_db(cplx.to_numpy(v), v64)
                sec = _time_step(step, states0, xp, time_iters)
            except Exception as e:  # a preset XLA cannot lower here
                res["fir_ladder"][name] = {"lowered": False, "error": repr(e)[:300]}
                continue
        res["fir_ladder"][name] = {
            "lowered": True, "err_db": err, "ms_per_tick": sec * 1e3,
            "msps": tick / sec / 1e6, "default": p == fir.FIR_PRECISION,
        }
    qualifying = [
        (r["ms_per_tick"], n) for n, r in res["fir_ladder"].items()
        if r["lowered"] and r["err_db"] <= BAR_DB - MARGIN_DB
    ]
    res["fastest_qualifying"] = min(qualifying)[1] if qualifying else None
    res["default"] = str(fir.FIR_PRECISION)

    # the interferer case at the shipped default precision
    step = fresh_step()
    _, v = step(states0, xp)
    res["interferer_db"] = reference.err_db(cplx.to_numpy(v), v64)
    res["rf_stage_ms_per_tick"] = _time_step(step, states0, xp, time_iters) * 1e3

    # discriminator, on the reference front-end output
    demod = named["demod"]
    vin = v64.astype(np.complex64)
    _, y = jax.jit(demod.apply)(demod.init_state(), cplx.from_numpy(vin))
    y_ref = reference.discriminator(vin, demod.gain)
    res["discriminator_db"] = reference.err_db(np.asarray(y), y_ref)

    # blocked de-emphasis IIR
    de = named["deemph"]
    a32 = y_ref.astype(np.float32)
    _, d = jax.jit(de.apply)(de.init_state(), a32)
    res["deemphasis_db"] = reference.err_db(np.asarray(d), reference.one_pole(a32, de.a, de.b))

    # rational resampler (quad rate -> 48 kHz)
    rsb = named["audio"]
    n_in = len(a32) - len(a32) % rsb.granule
    _, r = jax.jit(rsb.apply)(rsb.init_state(), a32[:n_in])
    r_ref = reference.resample(a32[:n_in], rsb.taps, rsb.up, rsb.down, r.shape[-1])
    res["resampler_db"] = reference.err_db(np.asarray(r), r_ref)

    # 64-channel channelizer (PFB + DFT) against numpy.fft
    chb = B.Channelizer(bank_channels)
    rng = np.random.default_rng(1)
    z = (rng.standard_normal(bank_block) + 1j * rng.standard_normal(bank_block)
         ).astype(np.complex64)
    plan = chanops.make_plan(chb.taps, bank_channels, bank_block)
    _, c = jax.jit(chb.apply)(chb.init_state(), cplx.from_numpy(z))
    c_ref = reference.channelize(z, chb.taps, bank_channels, plan.history)
    res["channelizer_db"] = reference.err_db(cplx.to_numpy(c).T, c_ref)

    # use_fused=True (FusedFmDemod, plain XLA) vs the same single-stage
    # unfused chain: one math in two float32 orderings, held to the bar
    fused, _ = receiver.fm_receiver(rf_rate, 2.5e6, receiver.WBFM, use_fused=True)
    plain, _ = receiver.fm_receiver(rf_rate, 2.5e6, receiver.WBFM, multistage=False)
    assert isinstance(dict(fused.blocks)["frontend"], B.FusedFmDemod)
    outs = [np.asarray(jax.jit(ch.apply)(ch.init_state(), xp)[1]) for ch in (fused, plain)]
    res["fused_vs_unfused_db"] = reference.err_db(outs[0], outs[1])

    res["ok"] = bool(
        res["interferer_db"] <= BAR_DB
        and res["resampler_db"] <= F32_STAGE_DB
        and res["discriminator_db"] <= F32_STAGE_DB
        and res["deemphasis_db"] <= F32_STAGE_DB
        and res["channelizer_db"] <= F32_STAGE_DB
        and res["fused_vs_unfused_db"] <= BAR_DB
    )
    return res


def phase_bench(tick_target: int | None = None, ks=None, reps=None) -> dict:
    """bench.py's headline and bench_configs.py configs 1-4, once each, at
    their own sizes unless the arguments shrink them."""
    import bench
    import bench_configs

    kw = {k: v for k, v in (("tick_target", tick_target), ("ks", ks),
                            ("reps", reps)) if v is not None}
    rows = [bench.measure(**kw)]
    rows += [bench_configs.CONFIGS[i](**kw) for i in sorted(bench_configs.CONFIGS)]
    ok = all(math.isfinite(r["value"]) and r["value"] > 0 for r in rows)
    return {"ok": bool(ok), "rows": rows}


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def _fm_capture(n: int, fs: float, offset: float) -> np.ndarray:
    t = np.arange(n) / fs
    audio = np.sin(2 * np.pi * 1000.0 * t)
    ph = 2 * np.pi * offset * t + 2 * np.pi * 75e3 * np.cumsum(audio) / fs
    rng = np.random.default_rng(2)
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (0.5 * np.exp(1j * ph) + 0.01 * noise).astype(np.complex64)


def _unsharded(block, x, n_ticks: int) -> np.ndarray:
    """The same ticks through ``block`` on the first device alone."""
    import jax

    from tpusdr.ops import cplx

    dev = jax.devices()[0]
    step = jax.jit(block.apply)
    s = jax.device_put(block.init_state(), dev)
    n = x.shape[-1] // n_ticks
    outs = []
    for i in range(n_ticks):
        s, y = step(s, jax.device_put(x[..., i * n:(i + 1) * n], dev))
        outs.append(cplx.to_numpy(y) if cplx.is_pair(y) else np.asarray(y))
    return np.concatenate(outs, axis=-1)


def phase_time_sharded(n_devices: int = 4, rf_rate: float = 100e6,
                       tick_target: int = 1 << 23, n_ticks: int = 3) -> dict:
    """BASELINE config 5: a 100 MHz WBFM capture time-sharded over the
    cards, chain-wide and stagewise halos, vs one card."""
    import jax

    from tpusdr.models import receiver
    from tpusdr.ops import cplx
    from tpusdr.parallel.halo import TimeShardedStream
    from tpusdr.parallel.mesh import make_mesh
    from tpusdr.utils import reference

    chain, _ = receiver.fm_receiver(rf_rate, 0.2 * rf_rate, receiver.WBFM)
    mesh = make_mesh(n_devices)
    res = {}
    for stagewise in (False, True):
        tss = TimeShardedStream(chain, mesh, stagewise=stagewise)
        g = tss.tick_granule
        tick = g * max(1, -(-max(tick_target, tss.halo * n_devices * 2) // g))
        x = cplx.from_numpy(_fm_capture(tick * n_ticks, rf_rate, 0.2 * rf_rate))
        carry = tss.init_carry()
        outs = []
        t0 = time.perf_counter()
        for i in range(n_ticks):
            xi = jax.device_put(x[..., i * tick:(i + 1) * tick], tss.input_sharding())
            carry, y = tss.step(carry, xi)
            outs.append(np.asarray(y))
        wall = time.perf_counter() - t0
        shd = np.concatenate(outs, axis=-1)
        ref = _unsharded(chain, x, n_ticks)
        key = "stagewise" if stagewise else "chainwide"
        res[key] = {"err_db": reference.err_db(shd, ref), "tick": tick,
                    "shape_ok": shd.shape == ref.shape, "wall_s": wall}
    res["ok"] = all(
        r["shape_ok"] and r["err_db"] <= SHARD_DB for r in res.values()
    )
    return res


def phase_channel_sharded(n_devices: int = 4, rf_rate: float = 20.48e6,
                          channels: int = 64, tick_target: int = 1 << 21,
                          n_ticks: int = 3) -> dict:
    """The 64-channel bank channel-sharded over the cards vs one card."""
    import jax

    from tpusdr.graph.chain import Chain
    from tpusdr.models import multichannel
    from tpusdr.ops import cplx
    from tpusdr.parallel.channels import ChannelShardedBank
    from tpusdr.parallel.mesh import make_mesh
    from tpusdr.utils import reference

    chain, _ = multichannel.fm_channel_bank(rf_rate, channels, 16000.0)
    chb = chain.blocks[0][1]
    bank = ChannelShardedBank(chb, Chain(chain.blocks[1:]), make_mesh(n_devices))
    g = n_devices * bank.chan_chain.granule
    g = g * chain.granule // math.gcd(g, chain.granule)
    tick = g * max(1, -(-max(tick_target, bank.halo * n_devices) // g))
    x = cplx.from_numpy(_fm_capture(tick * n_ticks, rf_rate, 2 * rf_rate / channels))
    carry = bank.init_carry()
    outs = []
    t0 = time.perf_counter()
    for i in range(n_ticks):
        xi = jax.device_put(x[..., i * tick:(i + 1) * tick], bank.input_sharding())
        carry, y = bank.step(carry, xi)
        outs.append(np.asarray(y))
    wall = time.perf_counter() - t0
    shd = np.concatenate(outs, axis=-1)
    ref = _unsharded(chain, x, n_ticks)
    err = reference.err_db(shd, ref)
    ok = shd.shape == ref.shape and err <= SHARD_DB
    return {"ok": bool(ok), "err_db": err, "tick": tick, "wall_s": wall}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


class _CompileClock:
    """Sums JAX's tracing, lowering and backend-compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, event: str, duration: float, **_kw) -> None:
        if event in self.EVENTS:
            self.seconds += duration


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_phase(name: str, fn, clock: _CompileClock, card: str) -> bool:
    c0, t0 = clock.seconds, time.perf_counter()
    try:
        result = fn()
        ok = bool(result.pop("ok"))
    except Exception:  # reported, and the run still exits non-zero
        traceback.print_exc()
        result, ok = {"error": traceback.format_exc(limit=3)[-600:]}, False
    line = {
        "phase": name, "ok": ok,
        "compile_s": clock.seconds - c0, "wall_s": time.perf_counter() - t0,
        "peak_bytes_in_use": _peak_bytes(), "card": card, "check": result,
    }
    print(json.dumps(line, default=str), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    ap.add_argument("--only", default="",
                    help="comma-separated phase names to run (default: all)")
    args = ap.parse_args(argv)

    import jax
    import jax.monitoring

    from tpusdr.utils import runtime

    cache = runtime.setup_compile_cache()
    info = runtime.device_info()
    card = runtime.gpu_name_and_power()
    print(
        f"chip_smoke device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']} jax={jax.__version__} compile_cache={cache} "
        f"card={card}",
        flush=True,
    )
    if info["platform"] != "gpu":
        print("chip_smoke: JAX's default device is not a GPU; nothing run",
              file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if info["count"] < need:
        print(f"chip_smoke: need {need} GPUs, have {info['count']}", file=sys.stderr)
        return 1

    clock = _CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    results = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            phases = [
                ("time_sharded", lambda: phase_time_sharded(4)),
                ("channel_sharded", lambda: phase_channel_sharded(4)),
            ]
        else:
            phases = [
                ("wbfm", lambda: phase_receiver("wbfm", 20e6, "int8", 2.0, 2_000_000, work)),
                ("nbfm", lambda: phase_receiver("nbfm", 20e6, "cf32", 2.0, 2_000_000, work)),
                ("am", lambda: phase_receiver("am", 10e6, "int8", 2.0, 2_000_000, work)),
                ("bank", lambda: phase_bank(20.48e6, 64, 2.0, 2_048_000, work)),
                ("file", lambda: phase_file(20e6, 2.0, 2_000_000, work)),
                ("accuracy", lambda: phase_accuracy()),
                ("bench", lambda: phase_bench()),
            ]
        only = {p for p in args.only.split(",") if p}
        unknown = only - {name for name, _ in phases}
        if unknown:
            print(f"chip_smoke: unknown phase(s) {sorted(unknown)}", file=sys.stderr)
            return 2
        for name, fn in phases:
            if not only or name in only:
                results.append(run_phase(name, fn, clock, card))
    if not all(results):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
