"""Numerically-controlled oscillators (NCO) for mixing and synthesis.

Replacement for CosineSource / ComplexCosineSource
(reference src/filters/CosineSource.cpp:40-90,
ComplexCosineSource.cpp): the reference carries a float phase ``mPhi`` and
wraps it mod 2*pi each block (CosineSource.cpp:72-84), which drifts over long
streams.  Here phase is a **uint32 fixed-point accumulator** (cycles in units
of 2^-32): the per-block phase update is exact integer arithmetic, so the
oscillator is drift-free and its phase at any global sample index is a closed
form — which is what makes it bit-stable when the time axis is sharded across
devices (each shard computes ``phase0 + offset * inc`` with wrap-around
uint32 multiplication).

Per-sample phases within a block are ``phase_u32 + k * inc_u32 (mod 2^32)``
— an iota-mul-add; the cos/sin evaluation is the only transcendental.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from tpusdr.ops.cplx import Complex

TWO_PI = 2.0 * np.pi
_PHASE_SCALE = np.float32(TWO_PI / 4294967296.0)  # 2*pi / 2^32


def freq_to_inc_u32(frequency: float, sample_rate: float) -> np.uint32:
    """Quantize a frequency to a uint32 phase increment (cycles * 2^32).

    Resolution is sample_rate / 2^32 (e.g. 4.7 mHz at 20 Msps) — far below
    the reference's float32 phase resolution.
    """
    cycles_per_sample = float(frequency) / float(sample_rate)
    inc = int(round((cycles_per_sample % 1.0) * 4294967296.0)) % 4294967296
    return np.uint32(inc)


def phase_angles(phase_u32: jnp.ndarray, inc_u32, num: int) -> jnp.ndarray:
    """Radian phase angles for ``num`` consecutive samples starting at
    ``phase_u32`` (uint32 scalar array). Returns float32 (num,)."""
    k = jnp.arange(num, dtype=jnp.uint32)
    ph = phase_u32 + k * jnp.uint32(inc_u32)  # wraps mod 2^32 exactly
    return ph.astype(jnp.float32) * _PHASE_SCALE


def advance_phase(phase_u32: jnp.ndarray, inc_u32, num: int) -> jnp.ndarray:
    """Exact phase accumulator update for a block of ``num`` samples."""
    step = np.uint32((int(inc_u32) * int(num)) % 4294967296)
    return phase_u32 + step


def cosine_block(phase_u32, inc_u32, num: int, amplitude: float = 1.0) -> jnp.ndarray:
    """Real cosine block (gsdrCosineF analog, CosineSource.cpp:68-80).

    Large blocks use the same angle-addition factorization as
    complex_cosine_block (cos(a+b) = cos a cos b - sin a sin b).
    """
    if num >= _FACTORED_THRESHOLD:
        c = _FACTOR_C
        q = -(-num // c)
        rows = phase_u32 + jnp.arange(q, dtype=jnp.uint32) * jnp.uint32(
            (int(inc_u32) * c) % (1 << 32)
        )
        cols = jnp.arange(c, dtype=jnp.uint32) * jnp.uint32(inc_u32)
        ra = rows.astype(jnp.float32) * _PHASE_SCALE
        ca = cols.astype(jnp.float32) * _PHASE_SCALE
        qr, qi = jnp.cos(ra), jnp.sin(ra)
        cr, ci = jnp.cos(ca), jnp.sin(ca)
        out = (qr[:, None] * cr[None, :] - qi[:, None] * ci[None, :]).reshape(-1)[
            :num
        ]
    else:
        ang = phase_angles(phase_u32, inc_u32, num)
        out = jnp.cos(ang)
    if amplitude != 1.0:
        out = out * jnp.float32(amplitude)
    return out


#: above this block size, build the exponential from an outer product of
#: two ~sqrt(N) tables: 2(N/C + C) transcendentals instead of 2N (cos/sin
#: dominated the WBFM chain's compute on the former target; the GPU is
#: unmeasured).
_FACTORED_THRESHOLD = 8192
_FACTOR_C = 2048


def complex_cosine_block(
    phase_u32, inc_u32, num: int, amplitude: float = 1.0
) -> Complex:
    """Complex exponential block exp(j*theta) (gsdrCosineC analog), as a
    real pair (no complex dtype on the device path).

    A *negative* frequency (inc computed from -f) yields exp(-j*2*pi*f*t),
    the canonical down-conversion oscillator.

    Large blocks use the angle-addition factorization
    exp(j*(phase + (qC+r)*inc)) = exp(j*(phase + qC*inc)) * exp(j*r*inc):
    both factors' angles come from the exact uint32 accumulator, so the
    only extra error is one complex multiply (~1 ulp).
    """
    if num >= _FACTORED_THRESHOLD:
        c = _FACTOR_C
        q = -(-num // c)  # ceil
        # row angles: phase + q*C*inc; col angles: r*inc  (uint32-exact)
        rows = phase_u32 + jnp.arange(q, dtype=jnp.uint32) * jnp.uint32(
            (int(inc_u32) * c) % (1 << 32)
        )
        cols = jnp.arange(c, dtype=jnp.uint32) * jnp.uint32(inc_u32)
        ra = rows.astype(jnp.float32) * _PHASE_SCALE
        ca = cols.astype(jnp.float32) * _PHASE_SCALE
        qr, qi = jnp.cos(ra), jnp.sin(ra)
        cr, ci = jnp.cos(ca), jnp.sin(ca)
        re = (qr[:, None] * cr[None, :] - qi[:, None] * ci[None, :]).reshape(-1)
        im = (qr[:, None] * ci[None, :] + qi[:, None] * cr[None, :]).reshape(-1)
        out = Complex(re[:num], im[:num])
    else:
        ang = phase_angles(phase_u32, inc_u32, num)
        out = Complex(jnp.cos(ang), jnp.sin(ang))
    if amplitude != 1.0:
        out = out * jnp.float32(amplitude)
    return out


def init_phase(initial_radians: float = 0.0) -> jnp.ndarray:
    cycles = (initial_radians / TWO_PI) % 1.0
    return jnp.uint32(int(round(cycles * 4294967296.0)) % 4294967296)
