"""Extended benchmark: the BASELINE.json measurement configs, one JSON line
each (bench.py remains the single-line headline).

  1. CosineSource -> 64-tap FIR -> magnitude (FirTests/CosineSourceTests
     mirror), 1 Msample blocks
  2. int8 IQ -> convert -> shift -> decimating FIR -> QuadAmDemod
  3. WBFM chain: IQ -> shift -> decimating FIR -> QuadFmDemod -> 48 kHz
     audio
  4. 64-channel PFB channelizer + FM demod bank

The four-card 100 MHz capture (BASELINE config 5) is checked by
``chip_smoke.py --four-cards``.

All timings use the scan-marginal method (utils/profiling.scan_marginal):
the slope over scan lengths cancels fixed per-call costs.  Every line names
the device and the card; the script fails when JAX's default device is not
a GPU.

Usage: ``python bench_configs.py [--config N] [--out FILE]`` — all configs
run in one process by default; --out appends the result line(s) to a
JSON-lines file.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

#: real-size defaults: ~2M-sample ticks and long scan arms, so the slope
#: clears per-call jitter on fast chains
TICK = 1 << 21
KS = (16, 96, 176, 256)


def _measure_chain(chain, xs_np, ks=KS, reps: int = 9) -> dict:
    """Marginal per-tick seconds of chain.apply under lax.scan.

    ``xs_np`` holds a FEW unique ticks; they are tiled up to max(ks) on
    device (one small upload + one device copy, utils/profiling.tile_ticks)."""
    import jax
    from jax import lax

    from tpusdr.utils.profiling import scan_marginal, tile_ticks

    xs = tile_ticks(xs_np, max(ks))
    state0 = jax.device_put(chain.init_state())

    @jax.jit
    def run(state, xs):
        return lax.scan(chain.apply, state, xs)

    return scan_marginal(run, state0, xs, ks=ks, reps=reps)


def _stack_ticks(make_tick, k: int):
    return np.stack([make_tick() for _ in range(k)])


def _complex_ticks(rng, tick: int, k: int = 16):
    from tpusdr.ops import cplx

    return cplx.Complex(
        _stack_ticks(lambda: rng.standard_normal(tick).astype(np.float32), k),
        _stack_ticks(lambda: rng.standard_normal(tick).astype(np.float32), k),
    )


def config1(tick_target: int = 1 << 20, ks=(16, 128, 256), reps: int = 5) -> dict:
    """CosineSource -> 64-tap FIR -> Magnitude (tests/FirTests mirror)."""
    import jax
    from jax import lax
    import scipy.signal as sps

    from tpusdr.graph import blocks as B
    from tpusdr.utils.profiling import scan_marginal

    n1 = tick_target
    osc_b = B.CosineSource(20e6, 1.25e6, "FloatComplex")
    fir_b = B.Fir(sps.firwin(64, 0.2).astype(np.float32), 1)
    mag_b = B.Magnitude()

    def step(state, _):
        s = dict(state)
        s["osc"], v = osc_b.generate(state["osc"], n1)
        s["fir"], v = fir_b.apply(state["fir"], v)
        s["mag"], v = mag_b.apply(state["mag"], v)
        return s, v

    state0 = jax.device_put(
        {"osc": osc_b.init_state(), "fir": fir_b.init_state(), "mag": ()}
    )

    @jax.jit
    def run(state, xs):
        return lax.scan(step, state, xs)

    m = scan_marginal(run, state0, np.zeros(max(ks), np.float32), ks=ks, reps=reps)
    return {
        "metric": "cosine_fir64_magnitude_msps",
        "value": n1 / m["per_tick"] / 1e6,
        "unit": "Msamples/s",
        "spread_pct": 100 * m["spread"],
    }


def config2(tick_target: int = TICK, ks=KS, reps: int = 9) -> dict:
    from tpusdr.models import receiver

    rng = np.random.default_rng(0)
    chain, _ = receiver.am_receiver(10e6, 1.25e6, input_format="int8")
    # tick is in packed int16 words = complex samples (the int8 IQ wire
    # bytes viewed as words — graph/blocks.py IqToComplex)
    tick = chain.granule * max(1, tick_target // chain.granule)
    xs = _stack_ticks(
        lambda: rng.integers(-128, 128, size=2 * tick, dtype=np.int8).view(
            np.int16
        ),
        16,  # unique ticks; tiled to max(ks) on device (_measure_chain)
    )
    m = _measure_chain(chain, xs, ks=ks, reps=reps)
    return {
        "metric": "am_chain_int8_msps",
        "value": tick / m["per_tick"] / 1e6,
        "unit": "Mcsamples/s",
        "spread_pct": 100 * m["spread"],
    }


def config3(tick_target: int = TICK, ks=KS, reps: int = 9) -> dict:
    from tpusdr.models import receiver

    rng = np.random.default_rng(0)
    chain, _ = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, 48000.0)
    tick = chain.granule * max(1, tick_target // chain.granule)
    m = _measure_chain(chain, _complex_ticks(rng, tick), ks=ks, reps=reps)
    v = tick / m["per_tick"] / 1e6
    return {
        "metric": "wbfm_chain_unfused_msps",
        "method": "scan_marginal_2m_ticks",
        "value": v,
        "unit": "Msamples/s",
        "vs_baseline": v / 20.0,
        "spread_pct": 100 * m["spread"],
    }


def config4(tick_target: int = TICK, ks=KS, reps: int = 9) -> dict:
    from tpusdr.models import multichannel

    rng = np.random.default_rng(0)
    chain, _ = multichannel.fm_channel_bank(20.48e6, 64, 16000.0)
    tick = chain.granule * max(1, tick_target // chain.granule)
    m = _measure_chain(chain, _complex_ticks(rng, tick), ks=ks, reps=reps)
    return {
        "metric": "fm_channel_bank64_msps",
        "value": tick / m["per_tick"] / 1e6,
        "unit": "Msamples/s",
        "spread_pct": 100 * m["spread"],
    }


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4}


def main() -> None:
    from tpusdr.utils import runtime

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=None, choices=sorted(CONFIGS))
    ap.add_argument("--out", type=str, default=None, help="append JSON lines here")
    args = ap.parse_args()
    runtime.start()
    device = runtime.require_gpu()
    card = runtime.gpu_name_and_power()
    todo = [args.config] if args.config else sorted(CONFIGS)
    for i in todo:
        line = json.dumps({**CONFIGS[i](), "device": device, "card": card})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
