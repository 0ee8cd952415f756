"""145.45 MHz digital-signal -> audio app.

Parity app for /root/reference/src/applications/
145.45_digital_signal_to_audio.cpp:451-600: an NBFM digital-voice channel
at 145.45 MHz in a 1 Msps capture centered at 145 MHz is demodulated,
band-isolated (975-1950 Hz), pitch-shifted down 800 Hz, low-passed, and
written as compressed audio (.ts/.aac via ffmpeg) or WAV.  Like the
reference app, the pipeline graph is exported as dot and logged at startup
(:575-587).

Examples:
  python -m tpusdr.apps.digital --input capture.iq --format int8 \
      --audio out.ts
  python -m tpusdr.apps.digital --input synth --duration 5 --audio out.wav
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tpusdr.graph.dot import to_dot
from tpusdr.graph.runner import StreamRunner
from tpusdr.io.sinks import AacFileSink, NullSink, WavSink
from tpusdr.io.sources import FileIqSource, SyntheticIqSource
from tpusdr.models import receiver
from tpusdr.utils import runtime
from tpusdr.utils.logging import get_logger, set_log_level


log = get_logger("apps.digital")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="145.45 digital signal -> audio")
    ap.add_argument("--input", default="synth", help="'synth' or an IQ file path")
    ap.add_argument("--format", default="cf32", choices=["int8", "int16", "cf32"])
    ap.add_argument("--rf-rate", type=float, default=1e6)
    ap.add_argument("--center", type=float, default=145e6, help="capture center, Hz")
    ap.add_argument("--channel", type=float, default=145.45e6, help="channel, Hz")
    ap.add_argument("--rf-decim", type=int, default=12)
    ap.add_argument("--audio-decim", type=int, default=10)
    ap.add_argument("--channel-width", type=float, default=receiver.NBFM_CHANNEL_WIDTH)
    ap.add_argument("--deviation", type=float, default=receiver.NBFM_DEVIATION)
    ap.add_argument("--pitch-shift", type=float, default=-800.0)
    ap.add_argument("--audio", default=None, help=".wav native; .ts/.aac via ffmpeg")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--tick", type=int, default=1 << 20)
    ap.add_argument("--dot", default=None, help="ALSO write the dot graph here")
    ap.add_argument("--platform", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.verbose:
        set_log_level("debug")
    runtime.start(args.platform)

    chain, spec = receiver.digital_receiver(
        rf_sample_rate=args.rf_rate,
        tuned_frequency=args.center,
        channel_frequency=args.channel,
        rf_decimation=args.rf_decim,
        audio_decimation=args.audio_decim,
        channel_width=args.channel_width,
        deviation=args.deviation,
        pitch_shift=args.pitch_shift,
        input_format=args.format,
    )

    # dot export on startup (reference logs it unconditionally, :575-587)
    dot = to_dot(chain, "digital_signal_to_audio")
    log.info("pipeline graph:\n%s", dot)
    if args.dot:
        with open(args.dot, "w") as f:
            f.write(dot)

    tick = max(1, args.tick // chain.granule) * chain.granule
    n_blocks = max(1, int(args.duration * args.rf_rate / tick))
    offset = args.channel - args.center

    if args.input == "synth":
        # 1.3 kHz tone FSK-style at the channel offset (inside the 975-1950
        # band so it survives the band-pass; the pitch shift moves it to
        # 500 Hz in the output audio).
        src = SyntheticIqSource.fm(
            tick, args.rf_rate, 1300.0, args.deviation, offset, args.format, n_blocks
        )
    else:
        src = FileIqSource(args.input, tick, args.format, max_blocks=n_blocks)

    if not args.audio:
        sink = NullSink()
    elif args.audio.endswith(".wav"):
        sink = WavSink(args.audio, spec.audio_rate)
    else:
        sink = AacFileSink(args.audio, spec.audio_rate)

    runner = StreamRunner(chain)
    state, stats = runner.run(iter(src), sink, max_blocks=n_blocks)
    sink.close()

    print(
        f"digital: {stats.samples_in / 1e6:.2f} M RF samples -> "
        f"{stats.samples_out / 1e3:.1f} k audio samples in "
        f"{stats.wall_seconds:.2f}s ({stats.msps_in:.2f} Msps)"
    )
    if args.audio:
        print(f"audio written to {args.audio} @ {spec.audio_rate:.0f} Hz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
