"""Sample-format conversion ops.

Replacement for Int8ToFloat (reference src/filters/Int8ToFloat.cpp:89-94,
gsdrInt8ToNormFloat) plus the int16 and interleaved-IQ variants an SDR
front end needs.  All 1:1 stateless elementwise maps — pure XLA, fused
into whatever consumes them.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

from tpusdr.ops.cplx import Complex

# HackRF-style int8 IQ normalizes by 128 (full-scale -128..127 -> ~[-1, 1)).
INT8_SCALE = 1.0 / 128.0
INT16_SCALE = 1.0 / 32768.0


def int8_to_float(x: jnp.ndarray, scale: float = INT8_SCALE) -> jnp.ndarray:
    return x.astype(jnp.float32) * jnp.float32(scale)


def int16_to_float(x: jnp.ndarray, scale: float = INT16_SCALE) -> jnp.ndarray:
    return x.astype(jnp.float32) * jnp.float32(scale)


def float_to_int16(x: jnp.ndarray) -> jnp.ndarray:
    y = jnp.clip(x, -1.0, 1.0) * 32767.0
    return jnp.round(y).astype(jnp.int16)


def interleaved_to_complex(x: jnp.ndarray) -> Complex:
    """[i0, q0, i1, q1, ...] float (..., 2N) -> Complex pair of length N.

    Deinterleaves with flat stride-2 slices, keeping every intermediate
    flat instead of a 2-wide minor axis (slow on the former target; the
    GPU is unmeasured).  Bit-exact vs the reshape form
    (tests/test_osc_convert.py)."""
    if x.shape[-1] % 2:
        raise ValueError(
            f"interleaved IQ needs an even last axis, got {x.shape[-1]}"
        )
    return Complex(x[..., 0::2], x[..., 1::2])


def complex_to_interleaved(x: Complex) -> jnp.ndarray:
    return jnp.stack([x.re, x.im], axis=-1).reshape(x.re.shape[:-1] + (-1,))


def int8_iq_to_complex(x: jnp.ndarray, scale: float = INT8_SCALE) -> Complex:
    """Interleaved int8 IQ (the HackRF wire format) -> normalized complex
    pair — fuses the reference's CudaMemcpy H2D + Int8ToFloat front end
    (nbfm_test.cpp:447-459) into one elementwise map.

    Deinterleave is done by bitcasting each little-endian (i, q) byte pair
    to one int16 word and splitting it with arithmetic shifts, keeping
    every array flat (..., N) instead of a 2-wide minor axis.  Bit-exact
    vs the reshape form.

    NOTE: this is the correctness fallback for device-resident int8 arrays;
    the production front end uploads packed int16 words (see
    pack_int8_words and ``int8_words_to_complex``).
    """
    w = lax.bitcast_convert_type(x.reshape(x.shape[:-1] + (-1, 2)), jnp.int16)
    return int8_words_to_complex(w, scale)


def int16_iq_to_complex(x: jnp.ndarray, scale: float = INT16_SCALE) -> Complex:
    """Interleaved int16 IQ -> complex pair; same flat-bitcast trick as
    int8_iq_to_complex (int16 pair -> int32 word).  Correctness fallback —
    production uploads packed int32 words (int16_words_to_complex)."""
    w = lax.bitcast_convert_type(x.reshape(x.shape[:-1] + (-1, 2)), jnp.int32)
    return int16_words_to_complex(w, scale)


def int8_words_to_complex(w: jnp.ndarray, scale: float = INT8_SCALE) -> Complex:
    """Packed int8 IQ words -> complex pair: ``w`` is int16, one word per
    complex sample, little-endian (i = low byte, q = high byte) — exactly
    the bytes of the int8 interleaved wire format, viewed as int16 on the
    host for free (numpy .view, pack_int8_words).

    This is the production front end: on the former target sub-word int8
    loads were several times slower than splitting words; on the GPU the
    two are unmeasured (ROADMAP Queue 1, item 7).  Bit-exact vs the int8
    forms (tests/test_osc_convert.py).
    """
    i = jnp.right_shift(jnp.left_shift(w, 8), 8)  # low byte, sign-extended
    q = jnp.right_shift(w, 8)  # high byte (arithmetic shift)
    s = jnp.float32(scale)
    return Complex(i.astype(jnp.float32) * s, q.astype(jnp.float32) * s)


def int16_words_to_complex(w: jnp.ndarray, scale: float = INT16_SCALE) -> Complex:
    """Packed int16 IQ words -> complex pair: ``w`` is int32, one word per
    complex sample, little-endian (i = low half, q = high half); the int16
    sibling of int8_words_to_complex (same sub-word-storage reasoning)."""
    i = jnp.right_shift(jnp.left_shift(w, 16), 16)
    q = jnp.right_shift(w, 16)
    s = jnp.float32(scale)
    return Complex(i.astype(jnp.float32) * s, q.astype(jnp.float32) * s)


def pack_int8_words(raw: np.ndarray) -> np.ndarray:
    """Host-side zero-copy view of interleaved int8 IQ as packed int16
    words (one per complex sample) — the upload dtype for the fast front
    end.  Same bytes on the wire and over PCIe; only the device layout tag
    changes."""
    return np.ascontiguousarray(raw).view(np.int16)


def pack_int16_words(raw: np.ndarray) -> np.ndarray:
    """Host-side zero-copy view of interleaved int16 IQ as packed int32
    words (one per complex sample)."""
    return np.ascontiguousarray(raw).view(np.int32)
