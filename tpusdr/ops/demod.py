"""Quadrature demodulators and elementwise signal ops.

Replacements for the reference's demod/elementwise filters:
  * QuadFmDemod (reference src/filters/QuadFmDemod.cpp:76-113,
    gsdrQuadFmDemod): phase-discriminator FM demod, N+1 inputs -> N outputs
    with a 1-sample carry; gain = Fs / (2*pi*channelWidth)
    (RfToPcmAudioFactory.cpp:124-126).
  * QuadAmDemod (QuadAmDemod.cpp:81-108, gsdrQuadAmDemod): envelope demod,
    1:1.
  * Magnitude (Magnitude.cpp:91-96), AddConst (AddConst.cpp:99),
    AddConstToVectorLength (AddConstToVectorLength.cpp:97-103).

All ops operate on the last axis and broadcast over leading batch axes.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from tpusdr.ops import cplx, xmath


def quad_fm_demod_ext(x_ext, gain: float) -> jnp.ndarray:
    """FM discriminator on an extended block (1 history sample prepended).

    y[n] = gain * arg(x[n+1] * conj(x[n])) — the instantaneous frequency.
    Input (..., N+1) -> output (..., N). Pair-native: the arg() is
    atan2 built from the backend's atan (ops/xmath.py).
    """
    xp = cplx.ensure_pair(x_ext)
    a = xp[..., 1:]
    b = xp[..., :-1].conj()
    prod = a * b
    return (jnp.float32(gain) * xmath.atan2(prod.im, prod.re)).astype(jnp.float32)


def quad_fm_demod_init(batch_shape=()) -> cplx.Complex:
    return cplx.zeros(tuple(batch_shape) + (1,))


def quad_fm_demod_apply(state, x, gain: float):
    """Streaming step: carry is the previous complex sample
    (QuadFmDemod.cpp consumes N and retains 1 — here that retained sample is
    the explicit carry)."""
    sp, xp = cplx.ensure_pair(state), cplx.ensure_pair(x)
    ext = cplx.concat([sp, xp], axis=-1)
    y = quad_fm_demod_ext(ext, gain)
    last = ext[..., ext.shape[-1] - 1 :]
    return (last if cplx.is_pair(state) else cplx.maybe_native(last, state)), y


def quad_fm_demod_gain(sample_rate: float, channel_width: float) -> float:
    """gain = Fs / (2*pi*channelWidth) (RfToPcmAudioFactory.cpp:124-126)."""
    import math

    return sample_rate / (2.0 * math.pi * channel_width)


def quad_am_demod(x) -> jnp.ndarray:
    """AM envelope demod: |x|, 1:1, stateless (QuadAmDemod.cpp:81-108)."""
    if cplx.is_pair(x):
        return x.abs().astype(jnp.float32)
    return jnp.abs(x).astype(jnp.float32)


def magnitude(x) -> jnp.ndarray:
    """|z| of a complex stream (Magnitude.cpp:91-96)."""
    return quad_am_demod(x)


def add_const(x: jnp.ndarray, c: float) -> jnp.ndarray:
    """Scalar add (AddConst.cpp:99, gsdrAddConstFF)."""
    if cplx.is_pair(x):
        return cplx.Complex(x.re + jnp.float32(c), x.im)
    return x + jnp.asarray(c, dtype=x.dtype)


def add_const_to_vector_length(x, c: float):
    """Add a constant to the magnitude of each complex sample while keeping
    its phase (AddConstToVectorLength.cpp:97-103, gsdrAddToMagnitude); used
    to remove/restore an AM carrier bias."""
    xp = cplx.ensure_pair(x)
    mag = xp.abs()
    scale = jnp.where(mag > 0, (mag + c) / jnp.maximum(mag, 1e-30), 0.0)
    out = cplx.Complex(xp.re * scale, xp.im * scale)
    return cplx.maybe_native(out, x)


def dc_block(x: jnp.ndarray) -> jnp.ndarray:
    """Remove the block mean (simple DC removal used after AM envelope)."""
    return x - jnp.mean(x, axis=-1, keepdims=True)
