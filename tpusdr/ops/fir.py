"""Decimating FIR filtering: the framework's hottest op.

Replacement for the reference's Fir filter + external gsdr CUDA kernels
(gsdrFirFF/FC/CC/CF — reference src/filters/Fir.cpp:220-268).  Streaming
semantics mirror Fir.cpp exactly:

  * with A available input samples, T taps and decimation D, the number of
    outputs is (A - (T-1)) // D            (Fir.cpp:141-187)
  * producing M outputs consumes M*D input samples and retains the last
    T-1 samples as history                 (Fir.cpp:271-276)

The retained history is not a relocatable device buffer
(RelocatableResizableBuffer.cpp:79-103) but an explicit carry array of
``T-1`` samples, which doubles as the overlap-save halo under time-block
sharding (SURVEY.md section 5, "long-context analog").

Execution paths, selectable per call site (``mode``):
  * 'mxu'   — banded matmul (the default): c consecutive outputs share one
              row of input window, so the decimating FIR
              y[r*c+j] = sum_k h_rev[k] x[r*c*D + j*D + k]
              is a dense (rows, K) x (K, c) contraction against a
              compile-time-constant banded tap matrix.  The signal is read
              about once (window overlap (T-D)/(c*D)); the MACs run as a
              matrix product.
  * 'conv'  — jax.lax.conv_general_dilated with window stride D.
  * 'poly'  — polyphase frames + accumulated slice-einsum
              (y[m] = sum_p X[m+p] . H[p] over (frames, D) blocks).
  * 'fft'   — segmented overlap-save convolution on the matmul-DFT for
              long taps (the reference has no FFT path at all).

All paths operate on the last axis and broadcast over leading batch axes
(used by the polyphase channelizer and multi-channel demod banks).  The
banded matmul contracts at ``FIR_PRECISION`` unless a call passes its own
``precision``; 'poly' and 'conv', which are not matmul-bound, contract at
HIGHEST (exact float32, no TF32 step on the GPU).

Complex data / real taps (the dominant SDR case, gsdrFirFC) is computed as a
2-channel real problem; complex taps use the 3-multiply split.
"""

from __future__ import annotations

import functools
from typing import Literal

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from tpusdr.ops import cplx
from tpusdr.ops import fft as mmfft
from tpusdr.utils.numerics import cdiv, next_pow2, round_up

FirMode = Literal["auto", "mxu", "conv", "poly", "fft"]
FIR_MODES: tuple[str, ...] = ("auto", "mxu", "conv", "poly", "fft")

# Minimum output count for the banded-matmul path to pay for its tile
# padding; tiny blocks stay on the fused elementwise paths.  Chosen on the
# former target and unmeasured on the GPU (ROADMAP Queue 1, item 4).
_MXU_MIN_OUTPUTS = 16

#: Contraction precision of the banded-matmul path.  On the GPU a float32
#: dot at DEFAULT or HIGH runs in TF32 (10 mantissa bits), whose error is
#: relative to the whole capture's power, so a channel far below the
#: capture's strongest signal can miss the -60 dB bar.  Measured in
#: chip_smoke.py's interferer case (wanted FM channel 40 dB below a carrier
#: in the same capture) on an H100 (700 W) at the 20 Msps WBFM RF stage:
#: DEFAULT/HIGH -53 dB; BF16_BF16_F32_X3 (three bf16 passes) -88 dB at
#: 0.64x HIGHEST's time; HIGHEST -124 dB (PERF.md).  The bf16x3 preset
#: would keep the 10 dB margin, but XLA's CPU backend rejects it on small
#: dots it fuses (tests/test_graph_chain.py flat-vs-scan), so the default
#: stays exact float32 until a bf16 split that every backend lowers is
#: measured (ROADMAP Queue 3, item 3).
FIR_PRECISION = lax.Precision.HIGHEST

#: Precision of the 'poly' and 'conv' paths and of the rational resampler's
#: class FIRs: exact float32 whatever FIR_PRECISION says.  Their
#: contractions are matrix-vector shaped, which backends lower elementwise.
EXACT = lax.Precision.HIGHEST


def check_mode(mode: str) -> str:
    """Validate a FIR execution path name (raises on unknown modes)."""
    if mode not in FIR_MODES:
        raise ValueError(f"unknown FIR mode {mode!r} (choose from {FIR_MODES})")
    return mode


def num_outputs(available: int, num_taps: int, decimation: int) -> int:
    """Output count for a given number of available samples (Fir.cpp:180-187)."""
    if available < num_taps:
        return 0
    return (available - (num_taps - 1)) // decimation


def history_len(num_taps: int) -> int:
    """Samples of history a streaming FIR must retain (Fir.cpp:274-276)."""
    return num_taps - 1


# ---------------------------------------------------------------------------
# Core: filter an extended block (history already prepended)
# ---------------------------------------------------------------------------


def fir_extended(
    x_ext,
    taps,
    decimation: int = 1,
    mode: FirMode = "auto",
    precision=None,
):
    """Valid-mode convolution of ``x_ext`` with ``taps``, decimated by D.

    ``x_ext`` has shape (..., L) with L = (T-1) + M*D for integer M >= 0;
    returns (..., M) where y[..., m] = sum_j taps[j] * x_ext[..., m*D+T-1-j].

    Complex data may be a cplx.Complex pair (device path) or a complex64
    array (CPU test convenience); the return matches the input
    representation.  All device math is real float32.

    ``precision`` overrides ``FIR_PRECISION`` for this call's banded
    matmul (a ``lax.Precision`` or ``lax.DotAlgorithmPreset``).
    """
    T = np.shape(taps)[-1] if not isinstance(taps, cplx.Complex) else taps.shape[-1]
    D = int(decimation)
    L = x_ext.shape[-1]
    M = num_outputs(L, T, D)

    pair_in = cplx.is_pair(x_ext) or cplx.is_pair(taps)
    cplx_x = cplx.is_complex(x_ext)
    cplx_h = cplx.is_complex(taps)

    if M <= 0:
        empty_shape = x_ext.shape[:-1] + (0,)
        if cplx_x or cplx_h:
            out = cplx.zeros(empty_shape)
            return out if pair_in else cplx.maybe_native(out, x_ext)
        return jnp.zeros(empty_shape, dtype=jnp.float32)

    # Trim any unusable tail so every path sees exactly (T-1) + M*D samples.
    usable = (T - 1) + M * D
    x_ext = x_ext[..., :usable]

    check_mode(mode)
    prec = FIR_PRECISION if precision is None else precision
    if mode == "auto":
        # The banded matmul was the fastest path at every production shape
        # on the former target; tiny blocks stay on the elementwise paths
        # where tile padding dominates.  Unmeasured on the GPU.
        if M >= _MXU_MIN_OUTPUTS:
            mode = "mxu"
        else:
            mode = "poly" if D > 1 else "conv"

    if mode == "fft":
        return _fir_fft_dispatch(x_ext, taps, D, M, pair_in)

    impl = functools.partial(
        {"poly": _fir_poly, "conv": _fir_conv, "mxu": _fir_mxu}[mode],
        precision=prec if mode == "mxu" else EXACT,
    )

    if not cplx_x and not cplx_h:  # FF
        return impl(jnp.asarray(x_ext), jnp.asarray(taps), D, M)

    proto = x_ext if cplx_x else taps
    xp = cplx.ensure_pair(x_ext) if cplx_x else None
    hp = (
        cplx.ensure_pair(taps if cplx.is_pair(taps) else jnp.asarray(taps))
        if cplx_h
        else None
    )

    if cplx_x and not cplx_h:  # FC: filter I and Q as two real channels
        h = jnp.asarray(taps)
        stacked = jnp.stack([xp.re, xp.im], axis=0)
        y = impl(stacked, h, D, M)
        out = cplx.Complex(y[0], y[1])
    elif cplx_x and cplx_h:  # CC
        if mode == "mxu":
            out = _fir_mxu_cc(xp, hp, D, M, precision=prec)
        else:  # 3-multiply complex convolution
            k1 = impl(xp.re + xp.im, hp.re, D, M)
            k2 = impl(xp.im, hp.re + hp.im, D, M)
            k3 = impl(xp.re, hp.im - hp.re, D, M)
            out = cplx.Complex(k1 - k2, k1 + k3)
    else:  # CF: real input, complex taps -> complex output (gsdrFirCF)
        x = jnp.asarray(x_ext)
        out = cplx.Complex(impl(x, hp.re, D, M), impl(x, hp.im, D, M))
    return out if pair_in else cplx.maybe_native(out, proto)


def _fir_conv(
    x: jnp.ndarray, taps: jnp.ndarray, D: int, M: int, precision=None
) -> jnp.ndarray:
    """lax.conv_general_dilated path (real-only; caller splits complex)."""
    batch_shape = x.shape[:-1]
    lhs = x.reshape((-1, 1, x.shape[-1])).astype(jnp.float32)
    rhs = jnp.flip(taps).reshape((1, 1, -1)).astype(jnp.float32)
    out = lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(D,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=precision,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(batch_shape + (M,))


def _fir_poly(
    x: jnp.ndarray, taps: jnp.ndarray, D: int, M: int, precision=None
) -> jnp.ndarray:
    """Polyphase-frame accumulation path (real-only; caller splits complex).

    taps reversed and zero-padded to P*D; x zero-padded to (M+P-1)*D and
    reshaped into non-overlapping (frame, D) blocks; the decimating FIR is
    then y[m] = sum_p frames[m+p] . H[p] — P shifted slices, each reduced
    over D and accumulated.  The P partial products are accumulated in a
    Python loop rather than stacked + einsummed: XLA can fuse each
    slice-multiply-reduce-add into one pass over the frames, so the
    (P, ..., M, D) intermediate never exists — the stack form would write
    a P-fold copy of the signal to device memory.
    """
    T = taps.shape[-1]
    P = cdiv(T, D)
    h_rev = jnp.flip(taps).astype(jnp.float32)
    h_pad = jnp.zeros((P * D,), jnp.float32).at[:T].set(h_rev).reshape(P, D)

    need = (M + P - 1) * D
    pad = need - x.shape[-1]
    if pad > 0:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    else:
        x = x[..., :need]
    frames = x.reshape(x.shape[:-1] + (M + P - 1, D)).astype(jnp.float32)
    acc = jnp.zeros(x.shape[:-1] + (M,), jnp.float32)
    for p in range(P):
        w = lax.slice_in_dim(frames, p, p + M, axis=-2)
        acc = acc + jnp.einsum("...md,d->...m", w, h_pad[p], precision=precision)
    return acc


def _mxu_tile_width(T: int, D: int, M: int) -> int:
    """Outputs per matmul row-tile.

    c = 128 was sized for the former target's 128x128 matrix unit and is
    unmeasured on the GPU (ROADMAP Queue 1, item 4); for non-decimating
    long filters a wider tile caps the window-overlap duplication
    (K/G = 1 + (T-D)/(c*D)) at ~2x.  Shrink toward M for short blocks so
    the row padding stays bounded.
    """
    c = max(128, round_up(cdiv(T - D, 2 * D), 128))
    if M < c:
        c = round_up(M, 8)
    return c


def _mxu_row_chunks(x: jnp.ndarray, c: int, D: int, T: int, M: int):
    """(..., L) -> the padded (..., rows+q, G) row-chunk view + (q, K).

    Row r of the logical window matrix A[r, i] = x[r*G + i] (width K)
    spans q+1 consecutive row chunks; instead of concatenating them into a
    materialized A (~2x the signal bytes written + read back — the r2-r4
    form), the contraction is split over the band, A @ W = sum_j A_j @ W_j,
    where each A_j is a CONTIGUOUS row-slice VIEW of this reshape that XLA
    feeds to the matmul without a copy."""
    G = c * D
    K = (c - 1) * D + T
    n_rows = cdiv(M, c)
    q = cdiv(T - 1, G)  # extra row-chunks the window tail spans
    pad = (n_rows + q) * G - x.shape[-1]
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)]).astype(jnp.float32)
    return x.reshape(x.shape[:-1] + (n_rows + q, G)), q, K, n_rows


def _mxu_band(taps: jnp.ndarray, c: int, D: int) -> jnp.ndarray:
    """Banded tap matrix W[i, j] = h_rev[i - j*D] (zero outside the band);
    a compile-time constant whenever the taps are."""
    T = taps.shape[-1]
    K = (c - 1) * D + T
    h_rev = jnp.flip(taps).astype(jnp.float32)
    i_idx = np.arange(K)[:, None] - np.arange(c)[None, :] * D
    mask = (i_idx >= 0) & (i_idx < T)
    return jnp.where(
        jnp.asarray(mask),
        h_rev[jnp.asarray(np.clip(i_idx, 0, T - 1))],
        jnp.float32(0.0),
    )


def _mxu_matmul(R, q, K, n_rows, W, c, D, M: int, precision=None) -> jnp.ndarray:
    """Banded contraction over row-chunk part views: y = sum_j A_j @ W_j."""
    G = c * D
    acc = None
    for j in range(q + 1):
        w = min(G, K - j * G)
        if w <= 0:
            break
        a_j = lax.slice_in_dim(R, j, j + n_rows, axis=-2)
        if w < G:
            a_j = a_j[..., :w]
        term = jnp.einsum(
            "...rk,kc->...rc", a_j, W[j * G : j * G + w, :], precision=precision
        )
        acc = term if acc is None else acc + term
    y = acc
    return y.reshape(y.shape[:-2] + (-1,))[..., :M]


def _fir_mxu(
    x: jnp.ndarray, taps: jnp.ndarray, D: int, M: int, precision=None
) -> jnp.ndarray:
    """Banded-matmul path: the decimating FIR as a dense contraction.

    Outputs are tiled c at a time: row r of the window matrix A holds the
    G + T - D input samples (G = c*D) that feed outputs [r*c, (r+1)*c);
    A[r, i] = x[r*G + i].  The banded tap matrix W[i, j] = h_rev[i - j*D]
    (zero outside the band) is a constant folded at compile time, so
    y = A @ W is one (rows, K) x (K, c) matmul — this is the gsdrFirFC hot
    loop (reference src/filters/Fir.cpp:230-268) restated as a matrix
    product.  FLOP overhead vs the polyphase optimum is K/T; read
    duplication is K/G (~1.08 at the WBFM RF stage).
    """
    T = taps.shape[-1]
    c = _mxu_tile_width(T, D, M)
    R, q, K, n_rows = _mxu_row_chunks(x, c, D, T, M)
    return _mxu_matmul(R, q, K, n_rows, _mxu_band(taps, c, D), c, D, M, precision)


def _fir_mxu_cc(
    xp: cplx.Complex, hp: cplx.Complex, D: int, M: int, precision=None
) -> cplx.Complex:
    """Complex data x complex taps as banded matmuls.

    Uses the 4-matmul form over two shared window views rather than the
    3-multiply Karatsuba split, which would build a third window tensor
    (re+im).
    """
    T = hp.shape[-1]
    c = _mxu_tile_width(T, D, M)
    Rr, q, K, n_rows = _mxu_row_chunks(xp.re, c, D, T, M)
    Ri, _, _, _ = _mxu_row_chunks(xp.im, c, D, T, M)
    Wr = _mxu_band(hp.re, c, D)
    Wi = _mxu_band(hp.im, c, D)

    def mm(R, W):
        return _mxu_matmul(R, q, K, n_rows, W, c, D, M, precision)

    return cplx.Complex(
        mm(Rr, Wr) - mm(Ri, Wi),
        mm(Rr, Wi) + mm(Ri, Wr),
    )


def _fft_segment_plan(T: int, D: int, M: int) -> tuple[int, int, int]:
    """(n_fft, hop, n_segments) for overlap-save.

    Fixed-size segments (~8x taps, clamped) bound the transform cost at
    O(n_fft * (n1 + n2)) MACs per hop samples regardless of block length —
    the round-1 whole-block next_pow2(L) transform made a 4M-sample tick
    pay a 4M-point DFT (VERDICT weak #3).  hop is a multiple of D so the
    decimation grid aligns across segment boundaries.
    """
    n_fft = min(max(next_pow2(8 * T), 1024), 1 << 15)
    while n_fft - T + 1 < D:  # hop must be >= D
        n_fft *= 2
    hop = ((n_fft - T + 1) // D) * D
    n_seg = cdiv(M * D, hop)
    return n_fft, hop, n_seg


def _overlapping_segments(x: jnp.ndarray, hop: int, n_fft: int, n_seg: int):
    """(..., L) -> (..., n_seg, n_fft) with A[s, i] = x_padded[s*hop + i]."""
    q = cdiv(n_fft - hop, hop)
    total = (n_seg + q) * hop
    pad = total - x.shape[-1]
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, max(0, pad))])
    R = x.reshape(x.shape[:-1] + (n_seg + q, hop))
    parts = [lax.slice_in_dim(R, j, j + n_seg, axis=-2) for j in range(q + 1)]
    return (jnp.concatenate(parts, axis=-1) if q else parts[0])[..., :n_fft]


def _fir_fft_dispatch(x, taps, D: int, M: int, pair_in: bool):
    """Segmented overlap-save convolution, then decimation.

    Device path (pair inputs): batched matmul-DFT over fixed-size segments
    (ops/fft.py) — no FFT HLO.  CPU complex64 path: native
    jnp.fft over the same segments.  Per segment, circular outputs in
    [T-1, n_fft) are linear; hop of them are kept, so concatenated
    segments reproduce the valid convolution exactly.
    """
    T = np.shape(taps)[-1] if not isinstance(taps, cplx.Complex) else taps.shape[-1]
    n_fft, hop, n_seg = _fft_segment_plan(T, D, M)
    m_per_seg = hop // D

    if pair_in:
        xp = cplx.ensure_pair(x)
        hp = cplx.ensure_pair(taps if isinstance(taps, cplx.Complex) else jnp.asarray(taps))
        hpad = [(0, n_fft - T)]
        H = mmfft.dft(cplx.Complex(jnp.pad(hp.re, hpad), jnp.pad(hp.im, hpad)))
        A = cplx.Complex(
            _overlapping_segments(xp.re, hop, n_fft, n_seg),
            _overlapping_segments(xp.im, hop, n_fft, n_seg),
        )
        y = mmfft.idft(mmfft.dft(A) * H)
        valid = cplx.Complex(
            lax.slice_in_dim(y.re, T - 1, T - 1 + hop, axis=-1),
            lax.slice_in_dim(y.im, T - 1, T - 1 + hop, axis=-1),
        )
        if D > 1:
            valid = valid.reshape(valid.shape[:-1] + (m_per_seg, D))[..., 0]
        out = valid.reshape(valid.shape[:-2] + (n_seg * m_per_seg,))
        return out[..., :M]

    complex_io = jnp.iscomplexobj(x) or jnp.iscomplexobj(taps)
    A = _overlapping_segments(
        x.astype(jnp.complex64 if complex_io else jnp.float32), hop, n_fft, n_seg
    )
    if complex_io:
        X = jnp.fft.fft(A, axis=-1)
        H = jnp.fft.fft(jnp.asarray(taps).astype(jnp.complex64), n=n_fft)
        y = jnp.fft.ifft(X * H, axis=-1)
    else:
        X = jnp.fft.rfft(A, axis=-1)
        H = jnp.fft.rfft(jnp.asarray(taps).astype(jnp.float32), n=n_fft)
        y = jnp.fft.irfft(X * H, n=n_fft, axis=-1)
    valid = lax.slice_in_dim(y, T - 1, T - 1 + hop, axis=-1)
    if D > 1:
        valid = valid.reshape(valid.shape[:-1] + (m_per_seg, D))[..., 0]
    out = valid.reshape(valid.shape[:-2] + (n_seg * m_per_seg,))[..., :M]
    if not complex_io:
        return out.astype(jnp.float32)
    return out.astype(jnp.complex64)


# ---------------------------------------------------------------------------
# Streaming interface
# ---------------------------------------------------------------------------


def fir_init_state(taps, dtype, batch_shape=()):
    """Zero history carry of length T-1 (the cold-start state).

    For complex streams pass dtype='pair' (device path) to get a
    cplx.Complex zero pair; jnp.complex64 gives a native array (CPU tests).
    """
    T = np.shape(taps)[-1] if not isinstance(taps, cplx.Complex) else taps.shape[-1]
    shape = tuple(batch_shape) + (history_len(T),)
    if dtype == "pair":
        return cplx.zeros(shape)
    return jnp.zeros(shape, dtype=dtype)


def _concat_last(state, x):
    if cplx.is_pair(x) or cplx.is_pair(state):
        sp, xp = cplx.ensure_pair(state), cplx.ensure_pair(x)
        return cplx.concat([sp, xp], axis=-1)
    return jnp.concatenate([state, x], axis=-1)


def _tail(ext, n):
    start = ext.shape[-1] - n
    if cplx.is_pair(ext):
        return cplx.Complex(
            lax.slice_in_dim(ext.re, start, ext.shape[-1], axis=-1),
            lax.slice_in_dim(ext.im, start, ext.shape[-1], axis=-1),
        )
    return lax.slice_in_dim(ext, start, ext.shape[-1], axis=-1)


def fir_apply(
    state,
    x,
    taps,
    decimation: int = 1,
    mode: FirMode = "auto",
    precision=None,
):
    """One streaming step: (history, block) -> (history', outputs).

    ``x.shape[-1]`` must be a multiple of ``decimation`` (the static rate
    planner guarantees this), so exactly len(x)/D outputs are produced and
    the retained history stays at T-1 samples — the invariant that makes
    output independent of how the stream is chopped into blocks
    (generalizing tests/FirTests.cpp:96-221).
    """
    D = int(decimation)
    N = x.shape[-1]
    if N % D != 0:
        raise ValueError(f"block length {N} not divisible by decimation {D}")
    ext = _concat_last(state, x)
    y = fir_extended(ext, taps, D, mode, precision)
    T = np.shape(taps)[-1] if not isinstance(taps, cplx.Complex) else taps.shape[-1]
    return _tail(ext, T - 1), y


def fir_full(
    x,
    taps,
    decimation: int = 1,
    mode: FirMode = "auto",
    precision=None,
):
    """Offline whole-signal filter with zero initial history."""
    T = np.shape(taps)[-1] if not isinstance(taps, cplx.Complex) else taps.shape[-1]
    shape = x.shape[:-1] + (history_len(T),)
    state = cplx.zeros(shape) if cplx.is_pair(x) else jnp.zeros(shape, dtype=x.dtype)
    usable = (x.shape[-1] // decimation) * decimation
    _, y = fir_apply(state, x[..., :usable], taps, decimation, mode, precision)
    return y


@functools.partial(jax.jit, static_argnames=("decimation", "mode", "precision"))
def fir_apply_jit(state, x, taps, decimation=1, mode="auto", precision=None):
    return fir_apply(state, x, taps, decimation, mode, precision)
