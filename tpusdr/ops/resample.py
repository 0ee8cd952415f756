"""Rational (polyphase) resampling with streaming state.

The reference downsamples only by integer decimation inside Fir
(/root/reference/src/filters/Fir.cpp) and its apps pick sample rates so the
audio chain divides evenly (RfToPcmAudioFactory.cpp).  Real receivers need
rational ratios (e.g. 250 kHz -> 48 kHz = 24/125); this module provides a
polyphase up-U/down-D resampler — a capability the reference lacks (noted as
hard part (c) in SURVEY.md section 7).

Math (upfirdn semantics): with prototype taps h (designed at the U-upsampled
rate, gain U in the passband),

    y[m] = sum_i h[p_m + i*U] * x[n_m - i],   p_m = (m*D) mod U,
                                              n_m = (m*D) div U.

Because block sizes are static, (p_m, n_m) are compile-time NumPy arrays:
the whole resampler is one static gather + one einsum — no per-sample control
flow, fully parallel.  Streaming invariance requires N*U % D == 0 per
block (the rate planner guarantees it); the carry is the last
ceil(T/U)-1 input samples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from tpusdr.ops import design
from tpusdr.utils.numerics import cdiv


def design_resampler_taps(
    up: int,
    down: int,
    db_attenuation: float = -60.0,
    transition_frac: float = 0.2,
    dtype=np.float32,
) -> np.ndarray:
    """Anti-alias/anti-image prototype for a U/D resampler.

    Cutoff at min(1/(2U), 1/(2D)) of the upsampled rate; passband gain U so
    the output amplitude matches the input.
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return np.array([1.0], dtype=dtype)
    # Closed-form Kaiser design (like scipy.resample_poly): resampler
    # prototypes routinely need thousands of taps, where the Remez exchange
    # is needlessly slow for a plain lowpass.
    fs_up = float(up)  # upsampled rate, with input rate normalized to 1.0
    cutoff = 0.5 * fs_up / max(up, down)
    transition = cutoff * transition_frac
    taps = design.kaiser_lowpass(
        fs_up, cutoff - transition, transition, db_attenuation
    )
    return (np.asarray(taps, np.float64) * up).astype(dtype)


@dataclass(frozen=True)
class ResamplerPlan:
    """Static gather plan for one block size (all host-side NumPy)."""

    up: int
    down: int
    num_taps: int
    taps_per_phase: int  # Pmax = ceil(T / U)
    block_in: int
    block_out: int
    # (block_out, Pmax) per-output tap rows (phase-selected, zero-padded)
    tap_rows: np.ndarray = field(repr=False)
    # the original prototype (for the up == 1 decimating-FIR fast path)
    taps: np.ndarray = field(repr=False, default=None)

    @property
    def history(self) -> int:
        return self.taps_per_phase - 1


def make_plan(taps: np.ndarray, up: int, down: int, block_in: int) -> ResamplerPlan:
    g = math.gcd(up, down)
    up, down = up // g, down // g
    T = len(taps)
    pmax = cdiv(T, up)
    if (block_in * up) % down != 0:
        raise ValueError(
            f"block_in*up ({block_in}*{up}) must be divisible by down ({down}) "
            "for phase-continuous streaming"
        )
    block_out = block_in * up // down

    m = np.arange(block_out, dtype=np.int64)
    p = (m * down) % up

    h_pad = np.zeros(up * pmax, dtype=np.float32)
    h_pad[:T] = np.asarray(taps, np.float32)
    h_poly = h_pad.reshape(pmax, up).T  # (up, pmax): row p = h[p::up]
    rows = h_poly[p]  # (block_out, pmax)

    return ResamplerPlan(
        up=up,
        down=down,
        num_taps=T,
        taps_per_phase=pmax,
        block_in=block_in,
        block_out=block_out,
        tap_rows=rows,
        taps=np.asarray(taps, np.float32),
    )


def resample_init(plan: ResamplerPlan, dtype, batch_shape=()):
    shape = tuple(batch_shape) + (plan.history,)
    if dtype == "pair":
        from tpusdr.ops import cplx

        return cplx.zeros(shape)
    return jnp.zeros(shape, dtype=dtype)


def _resample_real(ext: jnp.ndarray, plan: ResamplerPlan) -> jnp.ndarray:
    """Phase-class decomposition: outputs with m = c + U*t (class c) form a
    regular decimating FIR over the input —

        y[c + U*t] = sum_i h[p_c + i*U] * ext_local[n_c + t*D - i]

    so the whole resampler is U parallel P-tap decimate-by-D FIRs plus an
    interleave: stacked slices + one small einsum, no (block_out, P)
    scattered gather.  Contracts in exact float32 (ops/fir.py EXACT)."""
    U, D, P = plan.up, plan.down, plan.taps_per_phase
    t_count = plan.block_out // U
    h_classes = np.stack(
        [plan.tap_rows[c] for c in range(U)]
    )  # (U, P): taps for class c (rows repeat with period U)

    lc = (P - 1) + t_count * D
    starts = [(c * D) // U for c in range(U)]  # n_c
    # Later classes' slices overrun the buffer by up to D-1 positions that
    # only ever meet zero-padded taps; extend with zeros so shapes agree.
    overrun = max(starts) + lc - ext.shape[-1]
    if overrun > 0:
        ext = jnp.pad(ext, [(0, 0)] * (ext.ndim - 1) + [(0, overrun)])
    xs = jnp.stack(
        [ext[..., s : s + lc] for s in starts], axis=-2
    )  # (..., U, Lc)

    # Polyphase frames over the class axis (same trick as fir._fir_poly,
    # generalized to per-row taps).
    from tpusdr.utils.numerics import cdiv as _cdiv

    pp = _cdiv(P, D)
    h_rev = h_classes[:, ::-1]  # (U, P) reversed
    h_pad = np.zeros((U, pp * D), np.float32)
    h_pad[:, :P] = h_rev
    h_pad = h_pad.reshape(U, pp, D)

    need = (t_count + pp - 1) * D
    pad = need - lc
    if pad > 0:
        xs = jnp.pad(xs, [(0, 0)] * (xs.ndim - 1) + [(0, pad)])
    elif pad < 0:
        xs = xs[..., :need]
    frames = xs.reshape(xs.shape[:-1] + (t_count + pp - 1, D)).astype(jnp.float32)
    # Accumulate the pp shifted slice-reductions instead of stacking them:
    # same rationale as fir._fir_poly (the stack materializes a pp-fold
    # copy; the loop is a fused streaming pass per p).
    from tpusdr.ops.fir import EXACT as prec

    hj = jnp.asarray(h_pad)  # (U, pp, D)
    v = jnp.zeros(frames.shape[:-2] + (t_count,), jnp.float32)
    for p in range(pp):
        w = jax.lax.slice_in_dim(frames, p, p + t_count, axis=-2)  # (..., U, t, D)
        v = v + jnp.einsum("...utd,ud->...ut", w, hj[:, p], precision=prec)
    # interleave classes: m = c + U*t  ->  (..., t, U) -> (..., t*U)
    y = jnp.swapaxes(v, -1, -2).reshape(v.shape[:-2] + (plan.block_out,))
    return y.astype(jnp.float32)


def resample_apply(state, x, plan: ResamplerPlan):
    """One streaming step of the polyphase resampler.

    Equivalent to ``upfirdn(h, [zeros(history), x...], up, down)`` restricted
    to this block's output indices — verified against scipy in tests.
    Accepts real arrays, Complex pairs, or complex64 (CPU tests).

    ``up == 1`` is a pure decimating FIR — upfirdn's y[m] = sum_i h[i] *
    x[m*D - i] is fir_extended's banded-matmul contraction with the same
    T-1 history — so it delegates to ops/fir.  The general resampler's
    frames carry a narrow D-wide minor axis; the banded FIR avoids it.
    """
    from tpusdr.ops import cplx

    if x.shape[-1] != plan.block_in:
        raise ValueError(f"expected block of {plan.block_in}, got {x.shape[-1]}")
    if plan.up == 1 and plan.down > 1:
        if plan.taps is None:
            # Plans built before the `taps` field existed (or constructed
            # by hand instead of via make_plan) stay on the general path:
            # correct but without the banded-matmul form.
            from tpusdr.utils.logging import get_logger

            get_logger("resample").debug(
                "up==1 plan without taps: general (slow) path"
            )
        else:
            from tpusdr.ops import fir as _fir

            return _fir.fir_apply(state, x, jnp.asarray(plan.taps), plan.down)
    hist = plan.history

    if cplx.is_complex(x):
        sp, xp = cplx.ensure_pair(state), cplx.ensure_pair(x)
        ext = cplx.concat([sp, xp], axis=-1)
        y = cplx.Complex(_resample_real(ext.re, plan), _resample_real(ext.im, plan))
        new_state = ext[..., ext.shape[-1] - hist :] if hist > 0 else ext[..., :0]
        if not cplx.is_pair(x):
            y = cplx.maybe_native(y, x)
            new_state = cplx.maybe_native(new_state, x)
        return new_state, y

    ext = jnp.concatenate([state, x], axis=-1)
    y = _resample_real(ext, plan)
    new_state = ext[..., ext.shape[-1] - hist :] if hist > 0 else ext[..., :0]
    return new_state, y
