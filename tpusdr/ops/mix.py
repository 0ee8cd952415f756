"""Stream multiplication and frequency translation.

Replacement for MultiplyCcc (reference src/filters/Multiply.cpp:131-158,
gsdrMultiplyCC) and for the cosine-source + multiply
idiom the reference uses for frequency shifting
(RfToPcmAudioFactory.cpp:218-243: "Cosine" -> "Multiply").

Because the oscillator phase is a closed form of the global sample index
(see ops/osc.py), oscillator + multiply fuse into a single elementwise op —
``freq_shift_apply`` — with a uint32 phase carry. XLA fuses the cos/sin and
the complex multiply into one pass over the block.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpusdr.ops import cplx, osc


def multiply(a, b):
    """Elementwise product of two equal-length streams (MultiplyCcc).
    Accepts real arrays, Complex pairs, or a mix."""
    if cplx.is_pair(a) or cplx.is_pair(b):
        if cplx.is_pair(a) and cplx.is_pair(b):
            return a * b
        if cplx.is_pair(a):
            return a * b  # pair * real broadcasts via Complex.__mul__
        return b * a
    return a * b


def freq_shift_init(initial_radians: float = 0.0) -> jnp.ndarray:
    return osc.init_phase(initial_radians)


def freq_shift_apply(
    phase_u32: jnp.ndarray,
    x,
    inc_u32,
):
    """Multiply block by exp(j*theta[n]) where theta advances by the NCO
    increment per sample. Use ``osc.freq_to_inc_u32(-f, fs)`` to shift a
    component at +f down to baseband.  ``x`` is a Complex pair (or complex64
    on the CPU test path)."""
    n = x.shape[-1]
    lo = osc.complex_cosine_block(phase_u32, inc_u32, n)
    xp = cplx.ensure_pair(x)
    y = cplx.maybe_native(xp * lo, x)
    return osc.advance_phase(phase_u32, inc_u32, n), y
