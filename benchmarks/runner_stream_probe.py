"""Production streaming path on the GPU: capture file -> StreamRunner ->
WAV sink, sustained end-to-end Msps.  The seed of the served-path cell
(ROADMAP Queue 1, item 3).

Every other bench number uses the offline lax.scan; the reference's design
point is real-time streaming (nbfm_test.cpp:571-572: doFilter loop until
the byte counter passes the target).  This measures what the per-tick
runner actually sustains — host read + packed-word upload + jitted step +
depth-N pipelined audio fetch + WAV write — and reports the headroom over
the reference's 20 Msps design point.

The first block pays the jit compile, so throughput is measured from block
2 onward (stats are recomputed over the steady-state window, like any
warmed production process).  The capture and the WAV go to the temporary
directory.

Run: python benchmarks/runner_stream_probe.py [--source file|native]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_capture(path: str, fs: float, seconds: float, offset: float) -> int:
    """Write an int8 interleaved-IQ FM capture (1 kHz tone, WBFM deviation)."""
    n = int(fs * seconds)
    t = np.arange(n) / fs
    audio = np.sin(2 * np.pi * 1000.0 * t)
    phase = 2 * np.pi * offset * t + 2 * np.pi * 75e3 * np.cumsum(audio) / fs
    z = 0.9 * np.exp(1j * phase)
    inter = np.empty(2 * n, np.float32)
    inter[0::2] = z.real
    inter[1::2] = z.imag
    np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).tofile(path)
    return n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fs", type=float, default=20e6)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--tick", type=int, default=1 << 21)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--source", choices=("file", "native"), default="native")
    ap.add_argument(
        "--capture", default=os.path.join(tempfile.gettempdir(), "runner_capture.iq")
    )
    ap.add_argument("--platform", default=None, help="e.g. cpu for a smoke run")
    args = ap.parse_args()

    from tpusdr.utils import runtime

    device = runtime.start(args.platform)

    from tpusdr.graph.runner import StreamRunner
    from tpusdr.io.sinks import WavSink
    from tpusdr.io.sources import FileIqSource
    from tpusdr.models import receiver

    offset = 2.5e6
    if not os.path.exists(args.capture) or os.path.getsize(args.capture) != int(
        2 * args.fs * args.seconds
    ):
        n = make_capture(args.capture, args.fs, args.seconds, offset)
        print(json.dumps({"capture_samples": n, "path": args.capture}), flush=True)

    chain, _ = receiver.fm_receiver(
        args.fs, offset, receiver.WBFM, 48000.0, input_format="int8"
    )
    tick = chain.granule * max(1, args.tick // chain.granule)

    if args.source == "native":
        from tpusdr.io.native import NativeFileStream, get_lib

        if get_lib() is None:
            print(json.dumps({"error": "native lib unavailable"}), flush=True)
            return

        stream = NativeFileStream(args.capture, tick, "int8")
        # the chain front end takes packed int16 words (one per complex
        # sample) — a free view of the native block's int8 wire bytes
        src = (raw.view(np.int16) for raw in stream)
    else:
        src = iter(FileIqSource(args.capture, tick, "int8"))

    runner = StreamRunner(chain, pipeline_depth=args.depth)
    sink = WavSink(os.path.join(tempfile.gettempdir(), "runner_probe.wav"), 48000.0)

    # block 1 alone (compile + first upload), then the steady-state window
    state, warm = runner.run(src, sink, max_blocks=1)
    t0 = time.perf_counter()
    state, stats = runner.run(src, sink, state=state)
    dt = time.perf_counter() - t0
    sink.close()

    msps = stats.samples_in / dt / 1e6
    print(
        json.dumps(
            {
                "metric": "runner_stream_msps_sustained",
                "value": msps,
                "unit": "Msamples/s",
                "blocks": stats.blocks,
                "tick": tick,
                "pipeline_depth": args.depth,
                "source": args.source,
                "audio_samples": stats.samples_out,
                "vs_realtime_20msps": msps / 20.0,
                "compile_block_s": warm.wall_seconds,
                "device": device,
                "card": runtime.gpu_name_and_power(),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
