"""Concrete Block library — the L3 "filters" of the framework.

Name-for-name coverage of the reference's registered node types
(/root/reference/src/filters/FilterFactories.cpp:132-150: AddConst,
AddConstToVectorLength, Component, Cosine, File, Fir, HackRfSource,
Int8ToFloat, Magnitude, Multiply, QuadDemod) plus this build's additions
(FreqShift, Resampler, Channelizer, Deemphasis, IqToComplex).  Each class
documents the reference filter it replaces.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax.numpy as jnp

from tpusdr.graph.block import Block, SourceBlock
from tpusdr.graph.registry import register_block
from tpusdr.ops import channelizer as chanops
from tpusdr.ops import convert, demod, fir, iir, mix, osc
from tpusdr.ops import resample as resops


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


@register_block("Cosine")
class CosineSource(SourceBlock):
    """Oscillator source (CosineSource.cpp / ComplexCosineSource.cpp).

    ``sample_type`` 'Float' gives cos(theta); 'FloatComplex' gives
    exp(j*theta) — matching the reference's "Cosine" node with its
    sampleType parameter (RfToPcmAudioFactory.cpp:218-227).
    """

    def __init__(
        self,
        sample_rate: float,
        frequency: float,
        sample_type: str = "FloatComplex",
        amplitude: float = 1.0,
        initial_phase: float = 0.0,
    ):
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.inc = osc.freq_to_inc_u32(frequency, sample_rate)
        self.amplitude = amplitude
        self.initial_phase = initial_phase
        self.complex = sample_type in ("FloatComplex", "ComplexFloat", "complex")
        self.out_dtype = jnp.complex64 if self.complex else jnp.float32

    def init_state(self, batch_shape=()):
        return osc.init_phase(self.initial_phase)

    def generate(self, state, n):
        if self.complex:
            y = osc.complex_cosine_block(state, self.inc, n, self.amplitude)
        else:
            y = osc.cosine_block(state, self.inc, n, self.amplitude)
        return osc.advance_phase(state, self.inc, n), y

    def shift_state(self, state, offset_samples):
        # Exact modular phase arithmetic: int32 offsets wrap correctly as
        # two's-complement uint32.
        off = jnp.asarray(offset_samples).astype(jnp.uint32)
        return state + jnp.uint32(self.inc) * off

    def advance_state(self, state, num_samples: int):
        return osc.advance_phase(state, self.inc, num_samples)

    def _params_updated(self, names: frozenset) -> None:
        if names & {"frequency", "sample_rate"}:
            self.inc = osc.freq_to_inc_u32(self.frequency, self.sample_rate)


# ---------------------------------------------------------------------------
# Format conversion
# ---------------------------------------------------------------------------


@register_block("Int8ToFloat")
class Int8ToFloat(Block):
    """int8 -> normalized float (Int8ToFloat.cpp:89-94)."""

    in_dtype = jnp.int8
    out_dtype = jnp.float32

    def __init__(self, scale: float = convert.INT8_SCALE):
        self.scale = scale

    def apply(self, state, x):
        return state, convert.int8_to_float(x, self.scale)


@register_block("Int16ToFloat")
class Int16ToFloat(Block):
    in_dtype = jnp.int16
    out_dtype = jnp.float32

    def __init__(self, scale: float = convert.INT16_SCALE):
        self.scale = scale

    def apply(self, state, x):
        return state, convert.int16_to_float(x, self.scale)


@register_block("IqToComplex")
class IqToComplex(Block):
    """IQ wire format -> complex64.

    Fuses the reference's CudaMemcpy + Int8ToFloat front end
    (nbfm_test.cpp:447-459) into one elementwise map.

    For the integer formats the stream element is one PACKED WORD per
    complex sample — int8 IQ arrives as little-endian int16 words, int16 IQ
    as int32 words (the host views the wire bytes for free: io sources /
    convert.pack_int8_words) — so the rate is 1:1 and the granule 1.  The
    packed-word layout was chosen on the former target, where sub-word int8
    loads were slow; it is unmeasured on the GPU (ROADMAP Queue 1, item 7).
    A raw int8/int16 scalar array is rejected with a pointer at the packing
    helper.

    'float32' remains interleaved scalars (2:1) — f32 pairs have no wider
    word to pack into; cf32 captures enter as pairs via the runner anyway.
    """

    out_dtype = jnp.complex64

    def __init__(self, input_format: str = "int8"):
        self.input_format = input_format
        self.in_dtype = {
            "int8": jnp.int16,  # packed words, one per complex sample
            "int16": jnp.int32,
            "float32": jnp.float32,
        }[input_format]
        self.up, self.down = (1, 2) if input_format == "float32" else (1, 1)

    def apply(self, state, x):
        if self.input_format == "int8":
            if x.dtype == jnp.int8:
                raise TypeError(
                    "IqToComplex('int8') takes packed int16 words (one per "
                    "complex sample); view the wire bytes with "
                    "convert.pack_int8_words (free)"
                )
            return state, convert.int8_words_to_complex(x)
        if self.input_format == "int16":
            if x.dtype == jnp.int16:
                raise TypeError(
                    "IqToComplex('int16') takes packed int32 words; view "
                    "the wire bytes with convert.pack_int16_words"
                )
            return state, convert.int16_words_to_complex(x)
        return state, convert.interleaved_to_complex(x)


# ---------------------------------------------------------------------------
# Filtering / mixing
# ---------------------------------------------------------------------------


@register_block("Fir")
class Fir(Block):
    """Decimating FIR (Fir.cpp + gsdrFirFF/FC/CC/CF).

    ``signal_type``/``tap_type`` mirror the reference's four type combos.
    """

    def __init__(
        self,
        taps: Sequence[float] | np.ndarray,
        decimation: int = 1,
        signal_type: str = "FloatComplex",
        mode: fir.FirMode = "auto",
    ):
        taps = np.asarray(taps)
        self.taps = jnp.asarray(
            taps.astype(np.complex64 if np.iscomplexobj(taps) else np.float32)
        )
        self.decimation = int(decimation)
        self.mode = fir.check_mode(mode)
        self.down = self.decimation
        self.history = fir.history_len(taps.shape[-1])
        cplx = signal_type in ("FloatComplex", "ComplexFloat")
        self.in_dtype = jnp.complex64 if cplx else jnp.float32
        self.out_dtype = (
            jnp.complex64 if (cplx or np.iscomplexobj(taps)) else jnp.float32
        )

    def init_state(self, batch_shape=()):
        dt = "pair" if self.in_dtype == jnp.complex64 else self.in_dtype
        return fir.fir_init_state(self.taps, dt, batch_shape)

    def apply(self, state, x):
        return fir.fir_apply(state, x, self.taps, self.decimation, self.mode)

    def _params_updated(self, names: frozenset) -> None:
        # Fir::setTaps parity (Fir.cpp:124-139).  A tap-count change alters
        # the history length: the streaming state must be re-inited (the
        # reference reallocates its buffer the same way).
        if "taps" in names:
            t = np.asarray(self.taps)
            self.taps = jnp.asarray(
                t.astype(np.complex64 if np.iscomplexobj(t) else np.float32)
            )
            self.history = fir.history_len(t.shape[-1])
        if "decimation" in names:
            # keep the rate ratio derived, so the Chain-level guard SEES a
            # decimation change as the rate change it is and rejects it
            self.decimation = int(self.decimation)
            self.down = self.decimation


@register_block("Multiply")
@register_block("MultiplyCCC")
class Multiply(Block):
    """Elementwise product of two streams (Multiply.cpp:131-158)."""

    n_inputs = 2

    def apply(self, state, a, b):
        return state, mix.multiply(a, b)


@register_block("FreqShift")
class FreqShift(Block):
    """Fused oscillator + multiply frequency translation.

    Replaces the reference's Cosine -> Multiply pair
    (RfToPcmAudioFactory.cpp:218-243) with a single NCO-phased elementwise
    op; ``frequency`` is the shift applied to the spectrum (a component at
    ``-frequency`` moves to DC when frequency = -f_offset).
    """

    def __init__(self, sample_rate: float, frequency: float, initial_phase: float = 0.0):
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.inc = osc.freq_to_inc_u32(frequency, sample_rate)
        self.initial_phase = initial_phase

    def init_state(self, batch_shape=()):
        return mix.freq_shift_init(self.initial_phase)

    def apply(self, state, x):
        return mix.freq_shift_apply(state, x, self.inc)

    def shift_state(self, state, offset_samples):
        off = jnp.asarray(offset_samples).astype(jnp.uint32)
        return state + jnp.uint32(self.inc) * off

    def advance_state(self, state, num_samples: int):
        return osc.advance_phase(state, self.inc, num_samples)

    def _params_updated(self, names: frozenset) -> None:
        # Retuning (the reference's updateParameters use case): new shift
        # frequency takes effect on the next trace; the uint32 phase carry
        # remains valid (phase is continuous across a frequency step).
        if names & {"frequency", "sample_rate"}:
            self.inc = osc.freq_to_inc_u32(self.frequency, self.sample_rate)


@register_block("CosineMix")
class CosineMix(Block):
    """Multiply a real stream by a real cosine — the reference's
    Float-sampleType Cosine -> Multiply idiom, used as an audio pitch
    shifter (145.45_digital_signal_to_audio.cpp:538-546: shift by -800 Hz,
    then low-pass one of the two images).  Real in, real out; the +/-f
    images are both produced, so follow with a lowpass.  Same drift-free
    uint32 NCO phase as FreqShift."""

    in_dtype = jnp.float32
    out_dtype = jnp.float32

    def __init__(self, sample_rate: float, frequency: float, initial_phase: float = 0.0):
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.inc = osc.freq_to_inc_u32(frequency, sample_rate)
        self.initial_phase = float(initial_phase)

    def init_state(self, batch_shape=()):
        return osc.init_phase(self.initial_phase)

    def apply(self, state, x):
        lo = osc.cosine_block(state, self.inc, x.shape[-1])
        return osc.advance_phase(state, self.inc, x.shape[-1]), x * lo

    def shift_state(self, state, offset_samples):
        off = jnp.asarray(offset_samples).astype(jnp.uint32)
        return state + jnp.uint32(self.inc) * off

    def advance_state(self, state, num_samples: int):
        return osc.advance_phase(state, self.inc, num_samples)

    def _params_updated(self, names: frozenset) -> None:
        if names & {"frequency", "sample_rate"}:
            self.inc = osc.freq_to_inc_u32(self.frequency, self.sample_rate)


def _shifted_taps(taps: np.ndarray, inc: int) -> np.ndarray:
    """taps[j] * e^{j theta(T-1-j)}: a frequency shift folded into the taps.

    Angles come from the exact uint32 NCO accumulator, evaluated in float64
    on the host (compile-time constants; they must stay numpy so tracing
    never captures them)."""
    T = len(taps)
    k = (T - 1 - np.arange(T)) * int(inc) % (1 << 32)
    ang = k.astype(np.float64) * (2.0 * np.pi / 2.0**32)
    return (taps * np.exp(1j * ang)).astype(np.complex64)


def _pair_taps(t: np.ndarray):
    from tpusdr.ops import cplx as _cplx

    return _cplx.Complex(jnp.asarray(t.real.copy()), jnp.asarray(t.imag.copy()))


@register_block("FreqShiftFir")
class FreqShiftFir(Block):
    """Frequency shift folded into a decimating FIR (one matmul pass).

    Equivalent to FreqShift(fs, f) -> Fir(taps, D), with the full-rate
    oscillator + multiply eliminated: modulating the (compile-time) taps
    moves the shift into the banded tap matrix,

        y[m] = e^{j theta(mD)} * sum_k (h_rev[k] e^{j k w}) x[mD + k],

    so the only remaining full-rate op is the FIR contraction itself and
    the output rotation runs at the decimated rate (1/D of the work).
    Phase is the same drift-free uint32 NCO as FreqShift (exact across
    blocks and shards).  Precedent for fusing these stages: the
    reference's gsdrFmDemod front end (fm_simpletest.cpp:400-414).
    """

    out_dtype = jnp.complex64

    def __init__(
        self,
        sample_rate: float,
        frequency: float,
        taps,
        decimation: int,
        initial_phase: float = 0.0,
        mode: fir.FirMode = "auto",
    ):
        taps = np.asarray(taps)
        if np.iscomplexobj(taps):
            raise ValueError("FreqShiftFir folds the shift itself; taps must be real")
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.inc = osc.freq_to_inc_u32(frequency, sample_rate)
        self.taps = taps.astype(np.float32)
        self.decimation = int(decimation)
        self.down = self.decimation
        self.mode = fir.check_mode(mode)
        self.initial_phase = float(initial_phase)
        self.history = len(self.taps) - 1

    def init_state(self, batch_shape=()):
        from tpusdr.ops import cplx as _cplx

        T = len(self.taps)
        # phase of the first history sample: T-1 zeros precede the stream.
        back = (int(osc.init_phase(self.initial_phase)) - int(self.inc) * (T - 1)) % (
            1 << 32
        )
        return {
            "tail": _cplx.zeros(tuple(batch_shape) + (T - 1,)),
            "phase": jnp.uint32(back),
        }

    def apply(self, state, x):
        from tpusdr.ops import cplx as _cplx

        xp = _cplx.ensure_pair(x)
        n = x.shape[-1]
        ext = _cplx.concat([state["tail"], xp], axis=-1)
        v = fir.fir_extended(
            ext, _pair_taps(_shifted_taps(self.taps, self.inc)), self.decimation, self.mode
        )
        new_tail = ext[..., ext.shape[-1] - self.history :]
        rot = osc.complex_cosine_block(
            state["phase"],
            np.uint32(int(self.inc) * self.decimation % (1 << 32)),
            v.shape[-1],
        )
        y = v * rot
        new_state = {
            "tail": new_tail,
            "phase": state["phase"] + jnp.uint32(int(self.inc) * n % (1 << 32)),
        }
        return new_state, _cplx.maybe_native(y, x)

    def shift_state(self, state, offset_samples):
        off = jnp.asarray(offset_samples).astype(jnp.uint32)
        return {
            "tail": state["tail"],
            "phase": state["phase"] + jnp.uint32(self.inc) * off,
        }

    def advance_state(self, state, num_samples: int):
        return {
            "tail": state["tail"],
            "phase": state["phase"]
            + jnp.uint32(int(self.inc) * num_samples % (1 << 32)),
        }

    def _params_updated(self, names: frozenset) -> None:
        if names & {"frequency", "sample_rate"}:
            self.inc = osc.freq_to_inc_u32(self.frequency, self.sample_rate)
        if "taps" in names:
            self.taps = np.asarray(self.taps, np.float32)
            self.history = len(self.taps) - 1
        if "decimation" in names:
            self.decimation = int(self.decimation)
            self.down = self.decimation


@register_block("FusedFmDemod")
class FusedFmDemod(Block):
    """Fused shift -> decimating FIR -> FM discriminator (gsdrFmDemod
    precedent, fm_simpletest.cpp:400-414).

    Equivalent to FreqShift(frequency) -> Fir(taps, D) -> QuadFmDemod(gain)
    as one block.  The shift is folded into complex taps (FreqShiftFir
    math), so the filtered stream is y[m] = e^{j(phi0 + m*D*w)} v[m].  The
    discriminator's conjugate product cancels the absolute phase:

        y[m+1] conj(y[m]) = v[m+1] conj(v[m]) * e^{j*D*w}

    leaving one constant rotation at the decimated rate.  So the block
    needs no NCO state at all.  Carry: the last (T-1)+D input samples; each
    tick recomputes the previous tick's last FIR output as the
    discriminator's lookback.
    """

    out_dtype = jnp.float32

    def __init__(
        self,
        sample_rate: float,
        frequency: float,
        taps,
        decimation: int,
        gain: float,
    ):
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.inc = osc.freq_to_inc_u32(frequency, sample_rate)
        self.taps = np.asarray(taps, np.float32)
        self.decimation = int(decimation)
        self.down = self.decimation
        self.gain = float(gain)
        self.history = (len(self.taps) - 1) + self.decimation

    def init_state(self, batch_shape=()):
        from tpusdr.ops import cplx as _cplx

        return {"tail": _cplx.zeros(tuple(batch_shape) + (self.history,))}

    def apply(self, state, x):
        from tpusdr.ops import cplx as _cplx

        ext = _cplx.concat([state["tail"], _cplx.ensure_pair(x)], axis=-1)
        v = fir.fir_extended(
            ext, _pair_taps(_shifted_taps(self.taps, self.inc)), self.decimation
        )
        y = self._discriminate(v[..., 1:], v[..., :-1])
        return {"tail": ext[..., ext.shape[-1] - self.history :]}, y

    def _discriminate(self, v_cur, v_prev):
        """prod = v[k] conj(v[k-1]) de-rotated by the constant folded-
        shift residual e^{j*D*w}, then the atan discriminator."""
        from tpusdr.ops import xmath

        prod = v_cur * v_prev.conj()
        wd = (
            (int(self.inc) * self.decimation) % (1 << 32)
        ) * (2.0 * np.pi / 2.0**32)
        c, s = np.float32(np.cos(wd)), np.float32(np.sin(wd))
        pr = prod.re * c - prod.im * s
        pi = prod.re * s + prod.im * c
        return jnp.float32(self.gain) * xmath.atan2(pi, pr)

    def _params_updated(self, names: frozenset) -> None:
        if names & {"frequency", "sample_rate"}:
            self.inc = osc.freq_to_inc_u32(self.frequency, self.sample_rate)
        if names & {"taps", "decimation"}:
            # carried states sized for the old taps are invalid; the next
            # init_state() builds the right carry (Fir.cpp:124 setTaps
            # parity -- the reference also resets its retained buffer)
            self.taps = np.asarray(self.taps, np.float32)
            self.decimation = int(self.decimation)
            self.down = self.decimation
            self.history = (len(self.taps) - 1) + self.decimation


# ---------------------------------------------------------------------------
# Demodulators & elementwise
# ---------------------------------------------------------------------------


@register_block("QuadFmDemod")
class QuadFmDemod(Block):
    """FM discriminator (QuadFmDemod.cpp:76-113). Carry: 1 complex sample."""

    history = 1
    out_dtype = jnp.float32

    def __init__(self, gain: float | None = None, sample_rate: float | None = None,
                 channel_width: float | None = None):
        if gain is None:
            if sample_rate is None or channel_width is None:
                raise ValueError("need gain or (sample_rate, channel_width)")
            gain = demod.quad_fm_demod_gain(sample_rate, channel_width)
        self.gain = float(gain)

    def init_state(self, batch_shape=()):
        return demod.quad_fm_demod_init(batch_shape)

    def apply(self, state, x):
        return demod.quad_fm_demod_apply(state, x, self.gain)


@register_block("QuadAmDemod")
class QuadAmDemod(Block):
    """AM envelope demod (QuadAmDemod.cpp:81-108). Stateless, 1:1."""

    out_dtype = jnp.float32

    def apply(self, state, x):
        return state, demod.quad_am_demod(x)


def make_quad_demod(modulation: str, **kw) -> Block:
    """Reference "QuadDemod" node dispatching on modulation
    (FilterFactories registry + Modulation.h:23-26)."""
    m = modulation.lower()
    if m in ("fm", "modulation_fm"):
        return QuadFmDemod(**kw)
    if m in ("am", "modulation_am"):
        kw.pop("sample_rate", None)
        kw.pop("channel_width", None)
        return QuadAmDemod()
    raise ValueError(f"unknown modulation {modulation!r}")


register_block("QuadDemod")(make_quad_demod)


@register_block("Magnitude")
class Magnitude(Block):
    """|z| (Magnitude.cpp:91-96)."""

    out_dtype = jnp.float32

    def apply(self, state, x):
        return state, demod.magnitude(x)


@register_block("AddConst")
class AddConst(Block):
    """Scalar add (AddConst.cpp:99)."""

    in_dtype = jnp.float32
    out_dtype = jnp.float32

    def __init__(self, add_value: float = 0.0):
        self.add_value = float(add_value)

    def apply(self, state, x):
        return state, demod.add_const(x, self.add_value)


@register_block("AddConstToVectorLength")
class AddConstToVectorLength(Block):
    """Magnitude-bias of complex samples (AddConstToVectorLength.cpp:97-103)."""

    def __init__(self, add_value_to_magnitude: float = 0.0):
        self.add_value = float(add_value_to_magnitude)

    def apply(self, state, x):
        return state, demod.add_const_to_vector_length(x, self.add_value)


@register_block("DcBlock")
class DcBlock(Block):
    """DC blocker: y[n] = x[n] - x[n-1] + a*y[n-1] (one zero at DC, pole at
    a).  Used after AM envelope detection to strip the carrier level — the
    role AddConstToVectorLength plays in am_test.cpp, without needing to
    know the carrier amplitude."""

    in_dtype = jnp.float32
    out_dtype = jnp.float32
    history = 1
    time_shardable = False  # IIR: unbounded memory, runs post-gather

    def __init__(self, pole: float = 0.999):
        self.pole = float(pole)

    def init_state(self, batch_shape=()):
        return {
            "x1": jnp.zeros(tuple(batch_shape) + (1,), jnp.float32),
            "y1": iir.single_pole_init(batch_shape),
        }

    def apply(self, state, x):
        x_prev = jnp.concatenate([state["x1"], x[..., :-1]], axis=-1)
        diff = x - x_prev
        y1, y = iir.single_pole_apply(state["y1"], diff, self.pole, 1.0)
        new_state = {"x1": x[..., -1:], "y1": y1}
        return new_state, y


@register_block("ReadByteCountMonitor")
@register_block("SampleCountMonitor")
class SampleCountMonitor(Block):
    """Pass-through sample counter (ReadByteCountMonitor.cpp:44-63 — the
    reference's only throughput metric and its run-loop termination
    condition, nbfm_test.cpp:571).  The count lives in the carry so it
    survives checkpoints; host-side totals also exist in RunStats."""

    def init_state(self, batch_shape=()):
        return jnp.zeros((), jnp.int32)

    def apply(self, state, x):
        return state + jnp.int32(x.shape[-1]), x


@register_block("Deemphasis")
class Deemphasis(Block):
    """FM de-emphasis one-pole IIR (time constants from fm.h:20-21).

    Although an IIR has unbounded memory, the initial-state influence
    decays as a^n, so under time sharding a warmup of
    n = ln(1e-7)/ln(a) samples re-creates the carry to below -140 dB —
    ``history`` is sized accordingly and the block stays time-shardable
    (SURVEY.md hard part (a) generalized to IIR stages).  Poles too close
    to 1 (warmup > _MAX_IIR_WARMUP) fall back to the sequential tail.
    """

    in_dtype = jnp.float32
    out_dtype = jnp.float32

    _MAX_IIR_WARMUP = 1 << 15

    def __init__(self, sample_rate: float, tau: float = 75e-6):
        import math as _math

        self.a, self.b = iir.deemphasis_coeffs(tau, sample_rate)
        self.tau = tau
        self.sample_rate = sample_rate
        warmup = int(_math.ceil(_math.log(1e-7) / _math.log(self.a)))
        if warmup <= self._MAX_IIR_WARMUP:
            self.history = warmup
            self.time_shardable = True
        else:
            self.history = 1
            self.time_shardable = False

    def init_state(self, batch_shape=()):
        return iir.single_pole_init(batch_shape)

    def apply(self, state, x):
        return iir.single_pole_apply(state, x, self.a, self.b)

    def _params_updated(self, names: frozenset) -> None:
        if names & {"tau", "sample_rate"}:
            import math as _math

            self.a, self.b = iir.deemphasis_coeffs(self.tau, self.sample_rate)
            warmup = int(_math.ceil(_math.log(1e-7) / _math.log(self.a)))
            self.time_shardable = warmup <= self._MAX_IIR_WARMUP
            self.history = warmup if self.time_shardable else 1


# ---------------------------------------------------------------------------
# Rate conversion
# ---------------------------------------------------------------------------


@register_block("Resampler")
class Resampler(Block):
    """Rational polyphase resampler (capability the reference lacks)."""

    def __init__(
        self,
        up: int,
        down: int,
        taps: np.ndarray | None = None,
        db_attenuation: float = -60.0,
        signal_type: str = "Float",
    ):
        import math as _math

        g = _math.gcd(int(up), int(down))
        self.up, self.down = int(up) // g, int(down) // g
        is_cplx = signal_type in ("FloatComplex", "ComplexFloat")
        self.in_dtype = jnp.complex64 if is_cplx else jnp.float32
        self.out_dtype = self.in_dtype
        if taps is None:
            taps = resops.design_resampler_taps(self.up, self.down, db_attenuation)
        self.taps = np.asarray(taps, np.float32)
        self._plans: dict[int, resops.ResamplerPlan] = {}
        import tpusdr.utils.numerics as _num

        self.history = _num.cdiv(len(self.taps), self.up) - 1

    def _plan(self, n: int) -> resops.ResamplerPlan:
        if n not in self._plans:
            self._plans[n] = resops.make_plan(self.taps, self.up, self.down, n)
        return self._plans[n]

    def init_state(self, batch_shape=()):
        from tpusdr.ops import cplx as _cplx

        shape = tuple(batch_shape) + (self.history,)
        if self.in_dtype == jnp.complex64:
            return _cplx.zeros(shape)
        return jnp.zeros(shape, dtype=self.in_dtype)

    def apply(self, state, x):
        plan = self._plan(x.shape[-1])
        return resops.resample_apply(state, x, plan)

    def _params_updated(self, names: frozenset) -> None:
        if "taps" in names:
            import tpusdr.utils.numerics as _num

            self.taps = np.asarray(self.taps, np.float32)
            self._plans.clear()
            self.history = _num.cdiv(len(self.taps), self.up) - 1


@register_block("Channelizer")
class Channelizer(Block):
    """M-channel maximally-decimated PFB channelizer (ops/channelizer.py).

    Output gains a leading channel axis: (..., N) -> (..., M, N//M); the
    channel axis is the natural mesh-sharding axis (BASELINE.md config 4).
    """

    adds_channel_axis = True

    def __init__(
        self,
        num_channels: int,
        taps: np.ndarray | None = None,
        taps_per_channel: int = 12,
        db_attenuation: float = -60.0,
    ):
        self.num_channels = int(num_channels)
        self.down = self.num_channels
        if taps is None:
            taps = chanops.design_prototype(
                self.num_channels, taps_per_channel, db_attenuation
            )
        self.taps = np.asarray(taps, np.float32)
        self._plans: dict[int, chanops.ChannelizerPlan] = {}
        self.history = len(self.taps) - 1

    def _plan(self, n: int) -> chanops.ChannelizerPlan:
        if n not in self._plans:
            self._plans[n] = chanops.make_plan(self.taps, self.num_channels, n)
        return self._plans[n]

    def init_state(self, batch_shape=()):
        plan_hist = (
            (len(self.taps) + self.num_channels - 1) // self.num_channels
        ) * self.num_channels - 1
        from tpusdr.ops import cplx as _cplx

        return _cplx.zeros(tuple(batch_shape) + (plan_hist,))

    def apply(self, state, x):
        plan = self._plan(x.shape[-1])
        # channel-major output (..., M, F): downstream per-channel blocks
        # see time on the last axis.  Computed natively in that layout, so
        # no transpose follows (ops/channelizer.py channelize_apply).
        return chanops.channelize_apply(state, x, plan, channel_major=True)
