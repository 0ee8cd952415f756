"""DFT/FFT as matmuls — the framework's spectral engine.

Spectra are computed as *matrix products* (the former target had no FFT
primitive; on the GPU, cuFFT through jnp.fft is the unmeasured alternative,
ROADMAP Queue 3, item 2):

  * n <= 512: one direct DFT matmul — X = x W, 4 real (batch, n)x(n, n)
    matmuls.
  * larger n: Cooley-Tukey four-step split n = n1*n2 (factors chosen near
    sqrt(n)): DFT_n1 along columns -> twiddle -> DFT_n2 along rows ->
    transpose.  Each stage is again a batched matmul; total cost
    O(n*(n1+n2)) MACs.

This is the engine behind the overlap-save FIR path and the channelizer's
cross-branch DFT (ops/channelizer.py).  All data is pair-represented
(ops/cplx.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax.numpy as jnp
from jax import lax

from tpusdr.ops.cplx import Complex

# Largest direct DFT matmul; chosen on the former target, unmeasured on the
# GPU (ROADMAP Queue 1, item 5).
_MAX_DIRECT = 512

#: matmul precision for DFT matrices: HIGHEST is float32-faithful (no TF32
#: step on the GPU).
PRECISION = lax.Precision.HIGHEST


@functools.lru_cache(maxsize=64)
def _dft_mats(n: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """(w_re, w_im) with W[j, k] = exp(sign * 2 pi i j k / n), sign=-1 fwd."""
    j = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    ang = 2.0 * np.pi * (j * k % n) / n
    sign = 1.0 if inverse else -1.0
    return (
        np.cos(ang).astype(np.float32),
        (sign * np.sin(ang)).astype(np.float32),
    )


@functools.lru_cache(maxsize=64)
def _twiddles(n1: int, n2: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of exp(sign * 2 pi i k1 j2 / (n1 n2)), shape (n1, n2)."""
    k1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    ang = 2.0 * np.pi * (k1 * j2) / (n1 * n2)
    sign = 1.0 if inverse else -1.0
    return np.cos(ang).astype(np.float32), (sign * np.sin(ang)).astype(np.float32)


def _best_split(n: int) -> int | None:
    """Factor n = n1 * n2 with both parts as close to sqrt(n) as possible.
    Returns n1, or None if n is prime (no nontrivial factor)."""
    best = None
    for f in range(int(math.isqrt(n)), 1, -1):
        if n % f == 0:
            best = f
            break
    return best


def _matmul_dft_last(x: Complex, n: int, inverse: bool) -> Complex:
    w_re_np, w_im_np = _dft_mats(n, inverse)
    w_re = jnp.asarray(w_re_np)
    w_im = jnp.asarray(w_im_np)
    dot = lambda a, b: jnp.einsum("...j,jk->...k", a, b, precision=PRECISION)
    re = dot(x.re, w_re) - dot(x.im, w_im)
    im = dot(x.re, w_im) + dot(x.im, w_re)
    return Complex(re, im)


def _dft_core(x: Complex, inverse: bool) -> Complex:
    n = x.shape[-1]
    if n <= _MAX_DIRECT:
        return _matmul_dft_last(x, n, inverse)
    n1 = _best_split(n)
    if n1 is None or n1 == 1:
        # Large prime: fall back to one big (slow) direct matmul.
        return _matmul_dft_last(x, n, inverse)
    n2 = n // n1
    batch = x.shape[:-1]
    a = x.reshape(batch + (n1, n2))
    # 1) DFT_n1 along axis -2 (move it last).
    b = _dft_core(
        Complex(jnp.swapaxes(a.re, -1, -2), jnp.swapaxes(a.im, -1, -2)), inverse
    )
    b = Complex(jnp.swapaxes(b.re, -1, -2), jnp.swapaxes(b.im, -1, -2))  # (k1, j2)
    # 2) twiddle
    t_re_np, t_im_np = _twiddles(n1, n2, inverse)
    t = Complex(jnp.asarray(t_re_np), jnp.asarray(t_im_np))
    c = b * t
    # 3) DFT_n2 along axis -1.
    d = _dft_core(c, inverse)  # (k1, k2)
    # 4) output index k = k2*n1 + k1 -> transpose then flatten.
    out = Complex(jnp.swapaxes(d.re, -1, -2), jnp.swapaxes(d.im, -1, -2))
    return out.reshape(batch + (n,))


def dft_mats(n: int, inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(w_re, w_im) DFT matrix constants, W[j, k] = exp(sign*2pi i jk/n) —
    for callers contracting along a non-last axis (e.g. the channel-major
    channelizer's cross-branch DFT, ops/channelizer.py)."""
    return _dft_mats(n, inverse)


def dft(x: Complex) -> Complex:
    """Forward DFT along the last axis (pair in, pair out)."""
    return _dft_core(x, inverse=False)


def idft(x: Complex) -> Complex:
    """Inverse DFT along the last axis, including the 1/n scale."""
    n = x.shape[-1]
    y = _dft_core(x, inverse=True)
    s = jnp.float32(1.0 / n)
    return Complex(y.re * s, y.im * s)


def idft_unscaled(x: Complex) -> Complex:
    """Inverse DFT without the 1/n normalization (for filterbanks that fold
    the scale into the prototype)."""
    return _dft_core(x, inverse=True)


def rdft(x: jnp.ndarray) -> Complex:
    """DFT of a real signal (full spectrum; fine for conv use)."""
    return _dft_core(Complex(x, jnp.zeros_like(x)), inverse=False)
