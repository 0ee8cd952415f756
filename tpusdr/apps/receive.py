"""RF -> audio receiver CLI.

Replaces the reference demod apps (nbfm_test.cpp:489-583, am_test.cpp:435,
fm_simpletest.cpp:516): reads IQ from a file / TCP socket / synthetic
source, runs a WBFM/NBFM/AM chain on the accelerator, writes WAV audio,
prints throughput counters, optionally dumps the graph as dot.

Examples:
  python -m tpusdr.apps.receive --mod wbfm --input synth --rf-rate 2e6 \
      --duration 2 --audio out.wav
  python -m tpusdr.apps.receive --mod nbfm --input capture.iq \
      --format int8 --rf-rate 20e6 --offset 145.45e6-145e6 --audio out.wav
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tpusdr.graph.dot import to_dot
from tpusdr.graph.runner import StreamRunner
from tpusdr.io.sinks import AacFileSink, NullSink, WavSink
from tpusdr.io.sources import FileIqSource, SocketIqSource, SyntheticIqSource
from tpusdr.models import receiver
from tpusdr.utils import runtime
from tpusdr.utils.logging import get_logger, set_log_level

log = get_logger("apps.receive")


def _parse_float(s: str) -> float:
    return float(eval(s, {"__builtins__": {}}, {}))  # allows "145.45e6-145e6"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpusdr RF->audio receiver")
    ap.add_argument("--mod", choices=["wbfm", "nbfm", "am"], default="wbfm")
    ap.add_argument(
        "--input",
        default="synth",
        help="'synth', an IQ file path, or host:port for a TCP IQ stream",
    )
    ap.add_argument("--format", default="cf32", choices=["int8", "int16", "cf32"])
    ap.add_argument("--rf-rate", type=_parse_float, default=2e6)
    ap.add_argument("--offset", type=_parse_float, default=0.0,
                    help="channel center minus capture center, Hz")
    ap.add_argument("--audio-rate", type=_parse_float, default=48000.0)
    ap.add_argument(
        "--audio",
        default=None,
        help="output audio path (.wav native; .aac/.m4a/.ts via ffmpeg)",
    )
    ap.add_argument("--duration", type=float, default=2.0,
                    help="seconds of RF to process (file/synth)")
    ap.add_argument("--tick", type=int, default=1 << 20,
                    help="streaming block size target, samples (1 MiB parity)")
    ap.add_argument("--dot", default=None, help="write graph dot file")
    ap.add_argument(
        "--dump-if",
        default=None,
        help="also dump the pre-demod IF stream (complex64 raw) to this "
        "path — audio + raw IF in one pass (multi-sink fan-out, the "
        "SteppingDriver.cpp:309-362 role)",
    )
    ap.add_argument(
        "--checkpoint", default=None,
        help="save stream state here after the run (resume with --resume)",
    )
    ap.add_argument(
        "--resume", default=None,
        help="restore stream state from a checkpoint before the run",
    )
    ap.add_argument("--no-deemphasis", action="store_true")
    ap.add_argument(
        "--channel-width", type=_parse_float, default=None,
        help="override channel width, Hz (145.45 digital app parity: "
        "custom channelWidth, 145.45_digital_signal_to_audio.cpp:399-404)",
    )
    ap.add_argument(
        "--deviation", type=_parse_float, default=None,
        help="override FM deviation, Hz (fskDeviationIfFm parity)",
    )
    ap.add_argument(
        "--native",
        action="store_true",
        help="file ingest through the native C++ ring + deinterleave "
        "library (read-ahead thread off the GIL; io/native.py)",
    )
    ap.add_argument(
        "--platform",
        default=None,
        help="force a jax platform (e.g. 'cpu'); default: JAX's own choice",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.verbose:
        set_log_level("debug")
    runtime.start(args.platform)

    fs = args.rf_rate
    # with --native the int->float IQ conversion happens on the host in C
    # (deinterleave_to_planes), so the device chain takes pair input.
    chain_format = "cf32" if args.native else args.format
    if args.mod == "am":
        chain, spec = receiver.am_receiver(
            fs, args.offset, args.audio_rate, input_format=chain_format
        )
    else:
        chain, spec = receiver.fm_receiver(
            fs,
            args.offset,
            receiver.WBFM if args.mod == "wbfm" else receiver.NBFM,
            args.audio_rate,
            channel_width=args.channel_width,
            deviation=args.deviation,
            deemphasis_tau=None if args.no_deemphasis else receiver.TAU_US,
            input_format=chain_format,
        )

    tick = max(1, args.tick // chain.granule) * chain.granule
    n_blocks = max(1, int(args.duration * fs / tick))

    if args.dot:
        with open(args.dot, "w") as f:
            f.write(to_dot(chain, f"{args.mod}_receiver"))
        log.info("wrote %s", args.dot)

    if args.input == "synth":
        if args.mod == "am":
            def make(t):
                carrier = 1.0 + 0.5 * np.sin(2 * np.pi * 700.0 * t)
                return (0.5 * carrier * np.exp(2j * np.pi * args.offset * t)).astype(
                    np.complex64
                )

            src = SyntheticIqSource(tick, fs, make, args.format, n_blocks)
        else:
            dev = args.deviation or (
                receiver.WBFM_DEVIATION
                if args.mod == "wbfm"
                else receiver.NBFM_DEVIATION
            )
            src = SyntheticIqSource.fm(
                tick, fs, 1000.0, dev, args.offset, args.format, n_blocks
            )
    elif ":" in args.input and not args.input.endswith((".iq", ".bin", ".dat", ".raw")):
        host, port = args.input.rsplit(":", 1)
        src = SocketIqSource(host, int(port), tick, args.format)
        if args.duration <= 0:
            n_blocks = None  # stream until the socket closes
    elif args.native:
        from tpusdr.io.native import NativeFileStream, deinterleave_to_planes
        from tpusdr.ops import cplx

        stream = NativeFileStream(args.input, tick, args.format)

        def _pairs():
            for raw in stream:
                scalars = raw.view(np.float32) if raw.dtype == np.complex64 else raw
                re, im = deinterleave_to_planes(scalars)
                yield cplx.Complex(re, im)

        src = _pairs()
    else:
        src = FileIqSource(args.input, tick, args.format, max_blocks=n_blocks)

    # sink by extension (AacFileWriter chooses the muxer the same way,
    # AacFileWriter.cpp:93-101): .wav native, anything else via ffmpeg.
    if not args.audio:
        sink = NullSink()
    elif args.audio.endswith(".wav"):
        sink = WavSink(args.audio, spec.audio_rate)
    else:
        sink = AacFileSink(args.audio, spec.audio_rate)

    block = chain
    if args.dump_if:
        from tpusdr.graph.graph import tapped
        from tpusdr.io.sinks import RawFileSink

        names = [n for n, _ in chain.blocks]
        if_tap = names[names.index("demod") - 1]
        block = tapped(chain, [if_tap])
        sink = [sink, RawFileSink(args.dump_if, np.complex64)]
        log.info("dumping IF (tap %r) to %s", if_tap, args.dump_if)

    runner = StreamRunner(block)
    state = None
    if args.resume:
        from tpusdr.graph.checkpoint import load_state

        state = load_state(args.resume, block.init_state())
        log.info("resumed stream state from %s", args.resume)
    state, stats = runner.run(iter(src), sink, state=state, max_blocks=n_blocks)
    if args.checkpoint:
        from tpusdr.graph.checkpoint import save_state

        save_state(args.checkpoint, state)
        log.info("stream state checkpointed to %s", args.checkpoint)
    for s in sink if isinstance(sink, list) else [sink]:
        s.close()

    print(
        f"{args.mod}: {stats.samples_in/1e6:.2f} M RF samples -> "
        f"{stats.samples_out/1e3:.1f} k audio samples in {stats.wall_seconds:.2f}s "
        f"({stats.msps_in:.2f} Msps)"
    )
    if args.audio:
        print(f"audio written to {args.audio} @ {spec.audio_rate:.0f} Hz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
