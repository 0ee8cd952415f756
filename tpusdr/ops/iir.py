"""First-order IIR sections (FM de-emphasis, DC blocker) as parallel scans.

The reference ships the de-emphasis time constants (kTauEu=50us, kTauUs=75us
— reference include/gpusdrpipeline/fm.h:20-21) but never implements the
filter; a WBFM receiver needs it, so this is a capability this build adds.

A first-order recurrence y[n] = a*y[n-1] + b*x[n] is a linear scan; we
evaluate it with ``jax.lax.associative_scan`` over (a, b*x) pairs — O(N log N)
work but fully parallel, versus a sequential per-sample loop.
Carry: 1 output sample.
"""

from __future__ import annotations

import math

import numpy as np

import jax.numpy as jnp
from jax import lax


def single_pole_coeffs(tau_seconds: float, sample_rate: float) -> tuple[float, float]:
    """y[n] = a*y[n-1] + b*x[n] matching an RC de-emphasis network.

    Bilinear-transform discretization of H(s) = 1/(1 + s*tau).
    """
    # Prewarped bilinear transform
    w_c = 1.0 / tau_seconds
    wa = math.tan(w_c / (2.0 * sample_rate))
    b = wa / (1.0 + wa)
    a = (1.0 - wa) / (1.0 + wa)
    # This yields y[n] = a y[n-1] + b (x[n] + x[n-1]); we fold the zero into
    # a pure one-pole approximation for streaming simplicity:
    alpha = 1.0 - math.exp(-1.0 / (tau_seconds * sample_rate))
    return (1.0 - alpha, alpha)


def _first_order_scan(a: float, bx: jnp.ndarray, y0: jnp.ndarray) -> jnp.ndarray:
    """All outputs of y[n] = a*y[n-1] + bx[n], y[-1] = y0, via associative scan.

    The affine maps y -> a*y + c compose associatively:
    (a2, c2) o (a1, c1) = (a1*a2, a2*c1 + c2).
    """
    n = bx.shape[-1]
    a_vec = jnp.full(bx.shape, a, dtype=bx.dtype)

    def combine(l, r):
        al, cl = l
        ar, cr = r
        return al * ar, ar * cl + cr

    a_acc, c_acc = lax.associative_scan(combine, (a_vec, bx), axis=-1)
    return a_acc * y0 + c_acc


def single_pole_init(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.zeros(tuple(batch_shape) + (1,), dtype=dtype)


def _first_order_blocked(
    a: float, bx: jnp.ndarray, y0: jnp.ndarray, block: int
) -> jnp.ndarray:
    """All outputs of y[n] = a*y[n-1] + bx[n] via per-frame matmuls.

    The associative scan is log2(N) full passes over the data (~15 device
    memory round trips for a 32k-sample axis); this form does ONE matmul
    pass:

      frame f (length B), entry state s_f:
        y_f[i] = a^(i+1) * s_f + (L @ u_f)[i],  L[i, j] = a^(i-j) (i >= j)
      s_{f+1} = y_f[B-1]  — a length-N/B recurrence, solved with the
        associative scan at 1/B the traffic.

    L and the power vectors are compile-time constants; the (B, B) x
    (..., F, B) contraction runs in float32 (HIGHEST precision — bf16 or
    TF32 would cap the audio path near -48 dB).  Requires N % block == 0.
    """
    n = bx.shape[-1]
    assert n % block == 0 and block > 1
    f = n // block
    i = np.arange(block)
    lower = np.tril(np.float32(a) ** np.maximum(i[:, None] - i[None, :], 0))
    lower *= np.tril(np.ones((block, block), np.float32))
    l_mat = jnp.asarray(lower)  # (B, B), L[i, j] = a^(i-j) for j <= i
    pow_in = jnp.asarray((np.float32(a) ** (i + 1)))  # a^(i+1), i = 0..B-1
    a_block = float(np.float32(a) ** block)

    u = bx.reshape(bx.shape[:-1] + (f, block))
    v = jnp.einsum(
        "ij,...fj->...fi", l_mat, u, precision=lax.Precision.HIGHEST
    )
    # frame-entry states: s_0 = y0; s_{f+1} = a^B * s_f + v_f[B-1]
    w = v[..., block - 1]  # (..., F)
    s = _first_order_scan(
        jnp.asarray(a_block, bx.dtype), w, y0
    )  # s after each frame = entry state of the NEXT frame
    entry = jnp.concatenate(
        [jnp.broadcast_to(y0, w.shape[:-1] + (1,)), s[..., :-1]], axis=-1
    )
    y = v + entry[..., None] * pow_in
    return y.reshape(bx.shape)


#: last-axis length at or above which the blocked matmul form beat the
#: associative scan on the former target (one matmul pass vs log2(N)
#: passes); unmeasured on the GPU (ROADMAP Queue 3, item 3)
_BLOCKED_MIN_N = 4096
_BLOCK = 256


def single_pole_apply(
    state: jnp.ndarray, x: jnp.ndarray, a: float, b: float
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming one-pole IIR step; carry is the previous output sample.

    Long blocks take the blocked matmul form (_first_order_blocked); short or
    non-divisible blocks fall back to the associative scan.  Both are exact
    solutions of the same recurrence (float32-reassociated)."""
    n = x.shape[-1]
    bx = jnp.asarray(b, x.dtype) * x
    if n >= _BLOCKED_MIN_N:
        # Non-divisible lengths zero-pad up to the block multiple: outputs
        # depend only on the past, so y[..., :n] is exact and the padded
        # tail is discarded.  (Config 4's 32760-frame channels fell through
        # to the associative scan here and cost 2.9 ms/tick composed —
        # 10x the whole rest of the chain; r4 prefix profile.)
        pad = (-n) % _BLOCK
        if pad:
            bxp = jnp.pad(bx, [(0, 0)] * (bx.ndim - 1) + [(0, pad)])
            y = _first_order_blocked(a, bxp, state, _BLOCK)[..., :n]
        else:
            y = _first_order_blocked(a, bx, state, _BLOCK)
    else:
        y = _first_order_scan(jnp.asarray(a, x.dtype), bx, state)
    new_state = lax.slice_in_dim(y, y.shape[-1] - 1, y.shape[-1], axis=-1)
    return new_state, y


def deemphasis_coeffs(tau_seconds: float, sample_rate: float) -> tuple[float, float]:
    return single_pole_coeffs(tau_seconds, sample_rate)
