"""Single-channel RF -> PCM receiver builders.

Re-design of the reference's RfToPcmAudioFactory
(reference src/filters/factories/RfToPcmAudioFactory.cpp:130-317):
the same logical chain —

    [iq convert] -> freq shift -> RF lowpass FIR (decimate) ->
    quad demod (FM discriminator | AM envelope) ->
    [de-emphasis] -> audio lowpass / resample -> PCM

— but with the cosine+multiply pair fused into one NCO op, a *rational*
audio resampler instead of integer-only decimation, and FM de-emphasis
(the reference ships the tau constants, fm.h:20-21, but no filter).

Band constants mirror include/gpusdrpipeline/fm.h and am.h:
NBFM 15 kHz / 5 kHz dev; WBFM 200 kHz / 75 kHz dev; AM 10 kHz bandwidth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

from tpusdr.graph.blocks import (
    CosineMix,
    DcBlock,
    Deemphasis,
    Fir,
    FreqShift,
    FreqShiftFir,
    IqToComplex,
    QuadAmDemod,
    QuadFmDemod,
    Resampler,
)
from tpusdr.graph.chain import Chain
from tpusdr.ops import demod, design
from tpusdr.utils.logging import get_logger

log = get_logger("models")

# Band/deviation constants (fm.h:20-27, am.h:20).
TAU_EU = 50e-6
TAU_US = 75e-6
NBFM_CHANNEL_WIDTH = 15e3
WBFM_CHANNEL_WIDTH = 200e3
NBFM_DEVIATION = 5e3
WBFM_DEVIATION = 75e3
AM_BANDWIDTH = 10e3


@dataclass(frozen=True)
class ReceiverSpec:
    """Resolved rates/design of a receiver chain (for logging/tests)."""

    rf_sample_rate: float
    channel_width: float
    rf_decimation: int
    quad_rate: float
    audio_rate: float
    rf_taps: int  # total taps across RF decimation stages
    resampler: tuple[int, int]
    quad_gain: float
    rf_stages: tuple[tuple[int, int], ...] = ()  # (taps, decim) per stage


NBFM = "nbfm"
WBFM = "wbfm"
AM = "am"


def _rf_decimation(rf_rate: float, channel_width: float, min_oversample: float = 2.0):
    """Largest integer decimation keeping quad rate >= min_oversample * cw
    (the role of rfLowPassDecimation selection in the reference apps)."""
    d = max(1, int(rf_rate // (min_oversample * channel_width)))
    return d


def _rational(from_rate: float, to_rate: float, limit: int = 1000) -> tuple[int, int]:
    fr = Fraction(to_rate / from_rate).limit_denominator(limit)
    return fr.numerator, fr.denominator


def _shift_and_fir_stages(
    rf_sample_rate: float,
    freq_offset: float,
    rf_stages,
    fir_mode: str,
    fold_shift: bool,
) -> list[tuple[str, object]]:
    """Front-end blocks: frequency shift + RF decimation cascade.

    With ``fold_shift`` (default), the shift is folded into stage 1's tap
    matrix (FreqShiftFir): the full-rate NCO + multiply pass over device
    memory vanishes and the rotation runs post-decimation.  Falls back to the explicit
    FreqShift block when there is no shift or folding is disabled.
    """
    blocks: list[tuple[str, object]] = []
    t1, d1 = rf_stages[0]
    single = len(rf_stages) == 1
    if freq_offset and fold_shift:
        name = "shiftfir" if single else "shiftfir1"
        blocks.append(
            (name, FreqShiftFir(rf_sample_rate, -freq_offset, t1, d1, mode=fir_mode))
        )
        rest = rf_stages[1:]
        start = 2
    else:
        if freq_offset:
            blocks.append(("shift", FreqShift(rf_sample_rate, -freq_offset)))
        rest = rf_stages
        start = 1
        if single:
            blocks.append(("rf_fir", Fir(t1, d1, "FloatComplex", fir_mode)))
            return blocks
    for i, (t, d) in enumerate(rest, start):
        blocks.append((f"rf_fir{i}", Fir(t, d, "FloatComplex", fir_mode)))
    return blocks


def fm_receiver(
    rf_sample_rate: float,
    freq_offset: float = 0.0,
    variant: str = WBFM,
    audio_rate: float = 48000.0,
    channel_width: float | None = None,
    deviation: float | None = None,
    deemphasis_tau: float | None = TAU_US,
    input_format: str = "cf32",
    db_attenuation: float = -60.0,
    fir_mode: str = "auto",
    use_fused: bool = False,
    multistage: bool = True,
    fold_shift: bool = True,
) -> tuple[Chain, ReceiverSpec]:
    """Build a WBFM/NBFM receiver chain.

    ``freq_offset`` is the channel center relative to the capture center
    (the reference's tunedFrequency - channelFrequency oscillator,
    RfToPcmAudioFactory.cpp:224-226, sign folded into the NCO).

    ``use_fused=True`` replaces shift -> FIR cascade -> demod with one
    FusedFmDemod block (graph/blocks.py): a single-stage folded-shift FIR
    and the discriminator.  The default keeps the unfused multi-stage
    cascade, which needs fewer MACs than one big stage; which of the two is
    faster on the GPU is not measured yet.

    ``multistage=True`` splits a large RF decimation into a spec-equivalent
    cascade (design.decimation_stages) — ~2-4x fewer MACs/input at D=50
    than the reference's single Fir stage (Fir.cpp), same band edges and
    stopband floor.
    """
    if channel_width is None:
        channel_width = WBFM_CHANNEL_WIDTH if variant == WBFM else NBFM_CHANNEL_WIDTH
    if deviation is None:
        deviation = WBFM_DEVIATION if variant == WBFM else NBFM_DEVIATION

    d1 = _rf_decimation(rf_sample_rate, channel_width)
    quad_rate = rf_sample_rate / d1

    # RF lowpass: pass the channel, stop at the channel edge (the
    # createLowPassTaps spec, RfToPcmAudioFactory.cpp:151-166 style).
    cutoff = channel_width / 2.0
    transition = channel_width / 2.0
    if multistage and not use_fused:
        rf_stages = design.decimation_stages(
            rf_sample_rate, cutoff, transition, db_attenuation, d1
        )
    else:
        rf_stages = [
            (design.lowpass_taps(rf_sample_rate, cutoff, transition, db_attenuation), d1)
        ]
    rf_taps = rf_stages[0][0]  # single-stage taps for the fused path

    gain = demod.quad_fm_demod_gain(quad_rate, channel_width)

    up, down = _rational(quad_rate, audio_rate)
    actual_audio = quad_rate * up / down

    blocks: list[tuple[str, object]] = []
    if input_format != "cf32":
        blocks.append(("iq", IqToComplex(input_format)))
    if use_fused:
        from tpusdr.graph.blocks import FusedFmDemod

        blocks.append(
            (
                "frontend",
                FusedFmDemod(
                    rf_sample_rate, -freq_offset, rf_taps, d1, gain
                ),
            )
        )
    else:
        blocks.extend(
            _shift_and_fir_stages(
                rf_sample_rate, freq_offset, rf_stages, fir_mode, fold_shift
            )
        )
        blocks.append(("demod", QuadFmDemod(gain=gain)))
    if deemphasis_tau:
        blocks.append(("deemph", Deemphasis(quad_rate, deemphasis_tau)))
    if (up, down) != (1, 1):
        blocks.append(("audio", Resampler(up, down, db_attenuation=db_attenuation)))

    chain = Chain(blocks)
    spec = ReceiverSpec(
        rf_sample_rate=rf_sample_rate,
        channel_width=channel_width,
        rf_decimation=d1,
        quad_rate=quad_rate,
        audio_rate=actual_audio,
        rf_taps=sum(len(t) for t, _ in rf_stages),
        resampler=(up, down),
        quad_gain=gain,
        rf_stages=tuple((len(t), d) for t, d in rf_stages),
    )
    log.info(
        "%s receiver: fs=%.3g, RF stages %s -> quad %.3g, "
        "audio %d/%d -> %.5g Hz",
        variant,
        rf_sample_rate,
        spec.rf_stages,
        quad_rate,
        up,
        down,
        actual_audio,
    )
    return chain, spec


def am_receiver(
    rf_sample_rate: float,
    freq_offset: float = 0.0,
    audio_rate: float = 48000.0,
    bandwidth: float = AM_BANDWIDTH,
    input_format: str = "cf32",
    db_attenuation: float = -60.0,
    fir_mode: str = "auto",
    audio_band: tuple[float, float] | None = None,
    multistage: bool = True,
    fold_shift: bool = True,
) -> tuple[Chain, ReceiverSpec]:
    """AM envelope receiver (the am_test.cpp:435 chain: shift -> lowpass
    decim -> QuadAmDemod -> carrier-bias removal -> audio filtering).

    ``audio_band=(lo, hi)`` adds the band-pass audio shaping stage am_test
    builds with remezGenerateSingleBandPassTaps (am_test.cpp:151-195,
    createBandPassFilter :278-293)."""
    d1 = _rf_decimation(rf_sample_rate, bandwidth, min_oversample=4.0)
    quad_rate = rf_sample_rate / d1
    if multistage:
        rf_stages = design.decimation_stages(
            rf_sample_rate, bandwidth / 2.0, bandwidth / 2.0, db_attenuation, d1
        )
    else:
        rf_stages = [
            (
                design.lowpass_taps(
                    rf_sample_rate, bandwidth / 2.0, bandwidth / 2.0, db_attenuation
                ),
                d1,
            )
        ]
    up, down = _rational(quad_rate, audio_rate)

    blocks: list[tuple[str, object]] = []
    if input_format != "cf32":
        blocks.append(("iq", IqToComplex(input_format)))
    blocks.extend(
        _shift_and_fir_stages(
            rf_sample_rate, freq_offset, rf_stages, fir_mode, fold_shift
        )
    )
    blocks.append(("demod", QuadAmDemod()))
    # Strip the carrier level (the AddConstToVectorLength role in the
    # am_test chain) with a DC blocker — no carrier amplitude needed.
    blocks.append(("dc", DcBlock()))
    if audio_band is not None:
        lo, hi = audio_band
        bp = design.bandpass_taps(
            quad_rate, lo, hi, transition_width=lo, db_attenuation=db_attenuation
        )
        blocks.append(("audio_bp", Fir(bp, 1, "Float", fir_mode)))
    if (up, down) != (1, 1):
        blocks.append(("audio", Resampler(up, down, db_attenuation=db_attenuation)))

    chain = Chain(blocks)
    spec = ReceiverSpec(
        rf_sample_rate=rf_sample_rate,
        channel_width=bandwidth,
        rf_decimation=d1,
        quad_rate=quad_rate,
        audio_rate=quad_rate * up / down,
        rf_taps=sum(len(t) for t, _ in rf_stages),
        resampler=(up, down),
        quad_gain=1.0,
        rf_stages=tuple((len(t), d) for t, d in rf_stages),
    )
    return chain, spec


def digital_receiver(
    rf_sample_rate: float = 1e6,
    tuned_frequency: float = 145e6,
    channel_frequency: float = 145.45e6,
    rf_decimation: int = 12,
    audio_decimation: int = 10,
    channel_width: float = NBFM_CHANNEL_WIDTH,
    deviation: float = NBFM_DEVIATION,
    pitch_shift: float = -800.0,
    audio_band: tuple[float, float] = (975.0, 1950.0),
    db_attenuation: float = -60.0,
    input_format: str = "cf32",
    fir_mode: str = "auto",
    fold_shift: bool = True,
) -> tuple[Chain, ReceiverSpec]:
    """The 145.45 digital-signal app chain, with its own design policy
    (/root/reference/src/applications/145.45_digital_signal_to_audio.cpp):

      * explicit rf/audio decimations (:489-491), not rate-derived;
      * RF lowpass: cutoff cw/2, transition = min(cw/4, fs/2 - cw/2),
        validity gate cw <= 0.95 * fs/2 (:347-357);
      * quad demod gain computed at the *RF* rate with the deviation
        (QuadDemodFactory.h:92 receives rfSampleRate, :423) — the app's
        own convention, 12x hotter than the RfToPcm one;
      * audio lowpass: cutoff/transition at 0.95/0.05 of the output
        Nyquist (:425-426); no de-emphasis (digital voice);
      * audio band-pass 975-1950 Hz (:527-537), real-cosine pitch shift
        by -800 Hz with its channel lowpass (cw 3 kHz, :538-546), and a
        final 2 kHz lowpass (:547-556).
    """
    fs = rf_sample_rate
    max_cut = fs / 2.0 * 0.95
    if channel_width > max_cut:
        raise ValueError(
            f"sample rate {fs} too low for channel width {channel_width}: "
            f"need fs >= {channel_width / 0.95 * 2.0} (.cpp:347-355)"
        )
    cutoff = channel_width / 2.0
    transition = min(channel_width / 4.0, fs / 2.0 - cutoff)
    rf_taps = design.lowpass_taps(fs, cutoff, transition, db_attenuation)

    quad_rate = fs / rf_decimation
    audio_rate = float(int(fs / rf_decimation / audio_decimation))  # size_t parity
    audio_cut = audio_rate / 2.0 * 0.95
    audio_trans = audio_rate / 2.0 * 0.05
    audio_taps = design.lowpass_taps(quad_rate, audio_cut, audio_trans, db_attenuation)

    gain = demod.quad_fm_demod_gain(fs, deviation)
    offset = channel_frequency - tuned_frequency

    blocks: list[tuple[str, object]] = []
    if input_format != "cf32":
        blocks.append(("iq", IqToComplex(input_format)))
    blocks.extend(
        _shift_and_fir_stages(fs, offset, [(rf_taps, rf_decimation)], fir_mode, fold_shift)
    )
    blocks.append(("demod", QuadFmDemod(gain=gain)))
    blocks.append(("audio_lp", Fir(audio_taps, audio_decimation, "Float", fir_mode)))
    lo, hi = audio_band
    bp = design.bandpass_taps(
        audio_rate, lo, hi, transition_width=100.0, db_attenuation=db_attenuation
    )
    blocks.append(("audio_bp", Fir(bp, 1, "Float", fir_mode)))
    if pitch_shift:
        ps_cw = 3000.0
        ps_taps = design.lowpass_taps(
            audio_rate,
            ps_cw / 2.0,
            min(ps_cw / 4.0, audio_rate / 2.0 - ps_cw / 2.0),
            db_attenuation,
        )
        blocks.append(("pitch", CosineMix(audio_rate, pitch_shift)))
        blocks.append(("pitch_lp", Fir(ps_taps, 1, "Float", fir_mode)))
        post = design.lowpass_taps(audio_rate, 2000.0, 100.0, db_attenuation)
        blocks.append(("post_lp", Fir(post, 1, "Float", fir_mode)))

    chain = Chain(blocks)
    spec = ReceiverSpec(
        rf_sample_rate=fs,
        channel_width=channel_width,
        rf_decimation=rf_decimation,
        quad_rate=quad_rate,
        audio_rate=audio_rate,
        rf_taps=len(rf_taps),
        resampler=(1, audio_decimation),
        quad_gain=gain,
        rf_stages=((len(rf_taps), rf_decimation),),
    )
    log.info(
        "digital receiver: fs=%.3g offset=%.3g, RF (%d taps, /%d) -> quad %.3g "
        "-> audio %.5g Hz (bp %s, pitch %+g Hz)",
        fs,
        offset,
        len(rf_taps),
        rf_decimation,
        quad_rate,
        audio_rate,
        audio_band,
        pitch_shift,
    )
    return chain, spec


def rf_to_pcm(
    modulation: str,
    rf_sample_rate: float,
    tuned_frequency: float,
    channel_frequency: float,
    audio_rate: float = 48000.0,
    **kw,
) -> tuple[Chain, ReceiverSpec]:
    """Reference-API parity: IRfToPcmAudioFactory::createRfToPcm
    (FilterFactories.h:159-175) — modulation + tuned/channel frequencies."""
    offset = channel_frequency - tuned_frequency
    m = modulation.lower()
    if m in ("fm", "wbfm"):
        return fm_receiver(rf_sample_rate, offset, WBFM, audio_rate, **kw)
    if m == "nbfm":
        return fm_receiver(
            rf_sample_rate, offset, NBFM, audio_rate, deemphasis_tau=None, **kw
        )
    if m == "am":
        return am_receiver(rf_sample_rate, offset, audio_rate, **kw)
    raise ValueError(f"unknown modulation {modulation!r}")
