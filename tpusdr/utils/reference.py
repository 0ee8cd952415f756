"""Float64 NumPy/SciPy references of the receiver's DSP.

Each function computes, in float64 and independently of the device code, the
same streaming math as an op of ``tpusdr.ops`` started from zero state.  The
tests and ``chip_smoke.py`` compare the framework against them; the
BASELINE.md bar is an error at or below -60 dB.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps


def err_db(got, ref) -> float:
    """Error power of ``got`` relative to the power of ``ref``, in dB."""
    got = np.asarray(got, np.complex128 if np.iscomplexobj(got) else np.float64)
    ref = np.asarray(ref)
    e = np.mean(np.abs(got - ref) ** 2)
    s = np.mean(np.abs(ref) ** 2)
    return float(10 * np.log10(max(e, 1e-300) / max(s, 1e-300)))


def nco(n: int, inc: int, phase0: int = 0) -> np.ndarray:
    """exp(2j*pi*theta[k]) of the uint32 NCO: theta[k] = (phase0 + k*inc)
    mod 2^32, in cycles (ops/osc.py's accumulator, evaluated exactly)."""
    k = np.arange(n, dtype=np.uint64)
    cyc = ((np.uint64(phase0) + k * np.uint64(inc)) % np.uint64(1 << 32)).astype(
        np.float64
    ) / 2.0**32
    return np.exp(2j * np.pi * cyc)


def fir_decimate(x: np.ndarray, taps: np.ndarray, decimation: int) -> np.ndarray:
    """Streaming FIR from zero history (Fir.cpp contract): T-1 zeros, then
    valid-mode convolution, every D-th output."""
    taps = np.asarray(taps, np.float64 if not np.iscomplexobj(taps) else np.complex128)
    T = len(taps)
    ext = np.concatenate([np.zeros(T - 1, np.asarray(x).dtype), x])
    # overlap-add FFT convolution: float64 rounding (~-280 dB) at a
    # fraction of the direct method's cost for million-sample captures
    return sps.oaconvolve(ext, taps, mode="valid")[::decimation]


def shift_fir_cascade(x, inc: int, stages) -> np.ndarray:
    """Frequency shift by the uint32 increment ``inc`` (phase 0 at x[0]),
    then the decimating FIR ``stages`` [(taps, D), ...] in turn: the
    receiver's RF front end (FreqShiftFir + Fir blocks)."""
    y = np.asarray(x, np.complex128) * nco(len(x), inc)
    for taps, d in stages:
        y = fir_decimate(y, taps, d)
    return y


def discriminator(v: np.ndarray, gain: float) -> np.ndarray:
    """Quadrature FM discriminator with a zero previous sample:
    gain * arg(v[n] conj(v[n-1]))."""
    v = np.asarray(v, np.complex128)
    prev = np.concatenate([[0.0], v[:-1]])
    p = v * np.conj(prev)
    return gain * np.arctan2(p.imag, p.real)


def one_pole(x: np.ndarray, a: float, b: float) -> np.ndarray:
    """y[n] = a*y[n-1] + b*x[n] from y[-1] = 0 (the de-emphasis IIR)."""
    return sps.lfilter([b], [1.0, -a], np.asarray(x, np.float64), axis=-1)


def resample(x: np.ndarray, taps: np.ndarray, up: int, down: int, n_out: int):
    """Rational polyphase resampler: upfirdn from zero history."""
    return sps.upfirdn(np.asarray(taps, np.float64), np.asarray(x, np.float64),
                       up=up, down=down)[:n_out]


def channelize(z: np.ndarray, taps: np.ndarray, m: int, history: int) -> np.ndarray:
    """Maximally decimated M-channel PFB from ``history`` zeros: (F, M) with
    out[f, k] = sum_j taps[j] x[f*M - j] e^{2j*pi*k*j/M}, i.e. channel k
    shifted to DC, filtered and decimated by M.  Computed as polyphase
    branches plus ``numpy.fft.ifft`` across them."""
    z = np.asarray(z, np.complex128)
    taps = np.asarray(taps, np.float64)
    p = -(-len(taps) // m)
    h = np.zeros(p * m)
    h[: len(taps)] = taps
    padded = np.concatenate([np.zeros(history), z])
    f = len(z) // m
    fi = np.arange(f)[:, None]
    v = np.zeros((f, m), np.complex128)
    r = np.arange(m)[None, :]
    for q in range(p):
        idx = history + (fi - q) * m - r
        ok = idx >= 0
        v += h[q * m + r] * np.where(ok, padded[np.clip(idx, 0, None)], 0.0)
    return m * np.fft.ifft(v, axis=-1)


def interferer_capture(
    n: int, fs: float, wanted_offset: float, carrier_offset: float,
    level_db: float = -40.0, deviation: float = 75e3, audio_hz: float = 1000.0,
    seed: int = 0,
) -> np.ndarray:
    """complex64 capture: a unit carrier at ``carrier_offset`` and an FM
    channel (``audio_hz`` tone) ``level_db`` below it at ``wanted_offset``,
    with seeded random starting phases."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    ph_c, ph_w = rng.uniform(0, 2 * np.pi, 2)
    audio = np.sin(2 * np.pi * audio_hz * t)
    fm = np.exp(1j * (ph_w + 2 * np.pi * wanted_offset * t
                      + 2 * np.pi * deviation * np.cumsum(audio) / fs))
    cw = np.exp(1j * (ph_c + 2 * np.pi * carrier_offset * t))
    return (cw + 10 ** (level_db / 20) * fm).astype(np.complex64)


def tone_fit(x: np.ndarray, fs: float, hz: float, skip: float = 1 / 3):
    """Least-squares fit of a ``hz`` sinusoid to audio ``x`` after dropping
    the first ``skip`` of it (filter transients).  Returns (amplitude,
    SNR in dB of the fit against the residual)."""
    x = np.asarray(x, np.float64)
    x = x[int(len(x) * skip):]
    t = np.arange(len(x)) / fs
    basis = np.stack([np.sin(2 * np.pi * hz * t), np.cos(2 * np.pi * hz * t)], 1)
    c, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ c
    r = x - fit - (x - fit).mean()
    snr = 10 * np.log10(np.mean(fit**2) / max(np.mean(r**2), 1e-300))
    return float(np.hypot(*c)), float(snr)
