"""Polyphase filterbank channelizer (M channels, maximally decimated).

The reference has no channelizer: multi-channel reception there is N
independent single-channel graphs sharing one source
(reference src/applications/sdrtest.cpp:331-364 — "embarrassing channel
parallelism").  A PFB channelizer computes all M channels for roughly the
cost of one FIR + one FFT, and its output channel axis is the natural mesh
axis for sharding (BASELINE.md config 4) — so this is both a capability
and a performance win over the reference design.

Math: with prototype lowpass h (length padded to P*M),

    y_k[m] = sum_r e^{+j 2 pi k r / M} * v[m, r]
    v[m,r] = sum_p h[p*M + r] * x[(m-p)*M - r]

so channel k equals (downconvert by k*fs/M -> lowpass h -> decimate M).
``v`` is a static gather + einsum; the DFT across branches is one ifft along
the channel axis (length M — ideally a power of two for the four-step DFT).

Streaming carry: the last P*M - 1 input samples.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from tpusdr.ops import cplx, design
from tpusdr.ops import fft as mmfft
from tpusdr.utils.numerics import cdiv


def design_prototype(
    num_channels: int,
    taps_per_channel: int = 12,
    db_attenuation: float = -60.0,
    dtype=np.float32,
) -> np.ndarray:
    """Prototype lowpass for an M-channel PFB: cutoff at half the channel
    spacing, length taps_per_channel * M."""
    m = num_channels
    num_taps = taps_per_channel * m
    # Normalized rates: input fs = 1.0, channel width 1/M.
    cutoff = 0.5 / m
    transition = 0.8 * cutoff
    h = design.kaiser_lowpass(
        1.0, cutoff - transition / 2, transition, db_attenuation, num_taps=num_taps
    )
    return np.asarray(h, dtype)


@dataclass(frozen=True)
class ChannelizerPlan:
    num_channels: int
    taps_per_phase: int  # P
    block_in: int
    frames_out: int  # block_in / M
    h_poly: np.ndarray = field(repr=False)  # (P, M): h[p*M + r]

    @property
    def history(self) -> int:
        return self.taps_per_phase * self.num_channels - 1


def make_plan(taps: np.ndarray, num_channels: int, block_in: int) -> ChannelizerPlan:
    m = num_channels
    t = len(taps)
    p = cdiv(t, m)
    if block_in % m != 0:
        raise ValueError(f"block_in {block_in} not divisible by channels {m}")
    f = block_in // m
    h_pad = np.zeros(p * m, np.float32)
    h_pad[:t] = np.asarray(taps, np.float32)
    h_poly = h_pad.reshape(p, m)
    return ChannelizerPlan(
        num_channels=m,
        taps_per_phase=p,
        block_in=block_in,
        frames_out=f,
        h_poly=h_poly,
    )


def channelize_init(plan: ChannelizerPlan, dtype="pair", batch_shape=()):
    shape = tuple(batch_shape) + (plan.history,)
    if dtype == "pair":
        return cplx.zeros(shape)
    return jnp.zeros(shape, dtype=dtype)


def _branch_filter(ext_r: jnp.ndarray, plan: ChannelizerPlan) -> jnp.ndarray:
    """Gather-free polyphase branch filtering.

    With H = P*M-1 history, v[m, r] = sum_p h[p*M+r] * ext[H + (m-p)*M - r].
    Reshaping ext to (F+P, M) frames and flipping the lane axis gives
    Z[k, r] = ext[k*M + M-1-r], so v[m, r] = sum_p h_poly[p, r] *
    Z[m+P-1-p, r] — P shifted slices and one multiply-add each, instead of
    a (F, P, M) scattered gather (same math)."""
    m = plan.num_channels
    p_taps = plan.taps_per_phase
    f = plan.frames_out
    need = (f + p_taps) * m
    pad = need - ext_r.shape[-1]
    if pad > 0:  # one trailing zero: k=F+P-1 frames only feed m >= F
        ext_r = jnp.pad(ext_r, [(0, 0)] * (ext_r.ndim - 1) + [(0, pad)])
    z = ext_r[..., :need].reshape(ext_r.shape[:-1] + (f + p_taps, m))[..., ::-1]
    h = jnp.asarray(plan.h_poly)  # (P, M)
    acc = None
    for p in range(p_taps):
        sl = jax.lax.slice_in_dim(z, p_taps - 1 - p, p_taps - 1 - p + f, axis=-2)
        term = sl * h[p]
        acc = term if acc is None else acc + term
    return acc


def _frames_cm(ext_r: jnp.ndarray, plan: ChannelizerPlan) -> jnp.ndarray:
    """(..., L) -> (..., M, F+P) channel-major frames Zt[r', k] =
    ext[k*M + r'] — a reshape + one transpose, with NO lane flip (the flip
    is folded into the constants, see channelize_apply channel_major)."""
    m, p_taps, f = plan.num_channels, plan.taps_per_phase, plan.frames_out
    need = (f + p_taps) * m
    pad = need - ext_r.shape[-1]
    if pad > 0:
        ext_r = jnp.pad(ext_r, [(0, 0)] * (ext_r.ndim - 1) + [(0, pad)])
    z = ext_r[..., :need].reshape(ext_r.shape[:-1] + (f + p_taps, m))
    return jnp.swapaxes(z, -1, -2)


def _branch_filter_cm(zt: jnp.ndarray, h_cm: jnp.ndarray, plan) -> jnp.ndarray:
    """Per-branch FIR along the LANE (time/frame) axis.

    zt: (..., M, F+P); h_cm[p, r'] = h_poly[p, M-1-r'] (flip pre-folded).
    v'[r', k] = sum_p h_cm[p, r'] * zt[r', k + P-1-p]: P shifted lane
    slices, each a rank-matched (M, 1)-broadcast multiply-add — the long
    frame axis is the minor one instead of the M-wide channel axis.
    """
    p_taps, f = plan.taps_per_phase, plan.frames_out
    acc = None
    for p in range(p_taps):
        sl = jax.lax.slice_in_dim(zt, p_taps - 1 - p, p_taps - 1 - p + f, axis=-1)
        term = sl * h_cm[p][:, None]
        acc = term if acc is None else acc + term
    return acc


def channelize_apply(state, x, plan: ChannelizerPlan, channel_major: bool = False):
    """One streaming step.

    Input (..., block_in) Complex pair (or complex64 for CPU tests);
    output (..., F, M) where out[..., f, k] is sample f of channel k
    (channel k centered at +k*fs/M, interpreted mod M).  The cross-branch
    DFT runs as a matmul (ops/fft.py) — no FFT HLO.

    ``channel_major=True`` returns (..., M, F) computed natively in that
    layout: frames transposed once on entry, branch FIR along lanes, DFT as
    a (M, M) x (M, F) contraction — both the lane flip and the branch
    reversal are folded into the compile-time tap/DFT constants.  Same math
    (float32-reassociated); avoids every narrow-minor-axis intermediate of
    the row-major form.
    """
    if x.shape[-1] != plan.block_in:
        raise ValueError(f"expected block of {plan.block_in}, got {x.shape[-1]}")
    sp, xp = cplx.ensure_pair(state), cplx.ensure_pair(x)
    ext = cplx.concat([sp, xp], axis=-1)
    if channel_major:
        m = plan.num_channels
        # fold the lane flip (r = M-1-r') into taps and DFT matrix
        h_cm = jnp.asarray(plan.h_poly[:, ::-1])
        e_re, e_im = mmfft.dft_mats(m, inverse=True)
        e_re = jnp.asarray(e_re[:, ::-1])
        e_im = jnp.asarray(e_im[:, ::-1])
        zt = cplx.Complex(_frames_cm(ext.re, plan), _frames_cm(ext.im, plan))
        vr = _branch_filter_cm(zt.re, h_cm, plan)
        vi = _branch_filter_cm(zt.im, h_cm, plan)
        dot = lambda w, a: jnp.einsum(
            "kr,...rf->...kf", w, a, precision=mmfft.PRECISION
        )
        y = cplx.Complex(
            dot(e_re, vr) - dot(e_im, vi), dot(e_re, vi) + dot(e_im, vr)
        )
    else:
        v = cplx.Complex(_branch_filter(ext.re, plan), _branch_filter(ext.im, plan))
        y = mmfft.idft_unscaled(v)  # ifft * M: the M cancels the 1/M scale
    hist = plan.history
    new_state = ext[..., ext.shape[-1] - hist :]
    if not cplx.is_pair(x):
        y = cplx.maybe_native(y, x)
        new_state = cplx.maybe_native(new_state, x)
    return new_state, y
