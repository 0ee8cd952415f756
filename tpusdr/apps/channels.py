"""Multi-channel receiver CLI: channelize a wideband capture and demodulate
every FM channel at once.

The reference's sdrtest app runs N independent single-channel graphs
(sdrtest.cpp:331-364); this app runs one PFB channelizer + batched demod
bank and writes one WAV per selected channel.

Example:
  python -m tpusdr.apps.channels --input synth --rf-rate 5.12e6 \
      --channels 16 --write 2,5 --duration 2 --out-dir /tmp/chans
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

import jax

from tpusdr.graph.runner import StreamRunner, _to_host
from tpusdr.io.sinks import WavSink
from tpusdr.io.sources import FileIqSource, SyntheticIqSource
from tpusdr.models import multichannel
from tpusdr.utils import runtime
from tpusdr.utils.logging import get_logger

log = get_logger("apps.channels")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpusdr multi-channel FM receiver")
    ap.add_argument("--input", default="synth")
    ap.add_argument("--format", default="cf32", choices=["int8", "int16", "cf32"])
    ap.add_argument("--rf-rate", type=float, default=5.12e6)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--audio-rate", type=float, default=16000.0)
    ap.add_argument("--write", default="", help="comma-separated channel indices")
    ap.add_argument("--out-dir", default="channels_out")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--tick", type=int, default=1 << 20)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    runtime.start(args.platform)

    chain, info = multichannel.fm_channel_bank(
        args.rf_rate, args.channels, args.audio_rate
    )
    tick = max(1, args.tick // chain.granule) * chain.granule
    n_blocks = max(1, int(args.duration * args.rf_rate / tick))

    if args.input == "synth":
        # Two stations on channels 2 and channels-3 for demonstration.
        m = args.channels
        k1, k2 = 2 % m, (m - 3) % m
        dev = min(75e3, info["channel_rate"] / 4)

        def make(t):
            def fm(fk, fa):
                # closed-form tone integral: phase-continuous across ticks
                w = 2 * np.pi * fa
                ph = 2 * np.pi * fk * t + 2 * np.pi * dev * (1.0 - np.cos(w * t)) / w
                return np.exp(1j * ph)

            z = 0.5 * fm(k1 * args.rf_rate / m, 700.0) + 0.5 * fm(
                k2 * args.rf_rate / m, 1200.0
            )
            return z.astype(np.complex64)

        src = SyntheticIqSource(tick, args.rf_rate, make, "cf32", n_blocks)
    else:
        src = FileIqSource(args.input, tick, args.format, max_blocks=n_blocks)

    write = [int(c) for c in args.write.split(",") if c != ""]
    os.makedirs(args.out_dir, exist_ok=True)
    sinks = {
        c: WavSink(os.path.join(args.out_dir, f"ch{c:03d}.wav"), info["audio_rate"])
        for c in write
    }

    runner = StreamRunner(chain)
    state = runner.init_state()
    total_in = 0
    import time

    t0 = time.perf_counter()
    for raw in iter(src):
        if np.iscomplexobj(raw):
            from tpusdr.ops import cplx

            x = cplx.Complex(
                jax.device_put(np.ascontiguousarray(raw.real)),
                jax.device_put(np.ascontiguousarray(raw.imag)),
            )
        else:
            x = jax.device_put(raw)
        state, y = runner._step(state, x)
        audio = _to_host(y)  # (channels, n)
        total_in += raw.shape[-1]
        for c, sink in sinks.items():
            sink.write(audio[c])
    dt = time.perf_counter() - t0
    for sink in sinks.values():
        sink.close()
    print(
        f"{args.channels} channels: {total_in/1e6:.2f} M RF samples in {dt:.2f}s "
        f"({total_in/dt/1e6:.2f} Msps); wrote {sorted(sinks)} to {args.out_dir}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
