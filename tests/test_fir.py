"""FIR tests: all execution paths, all four type combos, streaming
invariance.

Mirrors tests/FirTests.cpp: (a) decimating complex FIR vs hand/oracle values
within 1e-3 (FirTests.cpp:81-94); (b) chopping the stream into arbitrary
block sizes yields identical output — the retained-tail property
(FirTests.cpp:96-221), generalized here to random chunkings (SURVEY.md
section 4).
"""

import numpy as np
import pytest
import scipy.signal as sps

import jax.numpy as jnp

from tpusdr.ops import fir

MODES = ["conv", "poly", "fft"]


def oracle(x, taps, D):
    """Valid-mode convolve then decimate — the Fir.cpp contract."""
    y = np.convolve(x, taps, mode="valid")
    return y[::D]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


class TestFirExtended:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("T,D", [(7, 1), (7, 2), (8, 3), (64, 4), (33, 5)])
    def test_real_real(self, rng, mode, T, D):
        taps = rng.standard_normal(T).astype(np.float32)
        M = 50
        x = rng.standard_normal(T - 1 + M * D).astype(np.float32)
        y = np.asarray(fir.fir_extended(jnp.asarray(x), jnp.asarray(taps), D, mode))
        assert y.shape == (M,)
        np.testing.assert_allclose(y, oracle(x, taps, D), atol=1e-3)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("T,D", [(7, 2), (64, 4)])
    def test_complex_real_taps(self, rng, mode, T, D):
        taps = rng.standard_normal(T).astype(np.float32)
        M = 40
        x = (
            rng.standard_normal(T - 1 + M * D) + 1j * rng.standard_normal(T - 1 + M * D)
        ).astype(np.complex64)
        y = np.asarray(fir.fir_extended(jnp.asarray(x), jnp.asarray(taps), D, mode))
        np.testing.assert_allclose(y, oracle(x, taps, D), atol=1e-3)
        assert y.dtype == np.complex64

    @pytest.mark.parametrize("mode", MODES)
    def test_complex_complex(self, rng, mode):
        T, D, M = 21, 2, 30
        taps = (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(
            np.complex64
        )
        x = (
            rng.standard_normal(T - 1 + M * D) + 1j * rng.standard_normal(T - 1 + M * D)
        ).astype(np.complex64)
        y = np.asarray(fir.fir_extended(jnp.asarray(x), jnp.asarray(taps), D, mode))
        np.testing.assert_allclose(y, oracle(x, taps, D), atol=2e-3)

    @pytest.mark.parametrize("mode", MODES)
    def test_real_complex_taps(self, rng, mode):
        T, D, M = 15, 1, 64
        taps = (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(
            np.complex64
        )
        x = rng.standard_normal(T - 1 + M * D).astype(np.float32)
        y = np.asarray(fir.fir_extended(jnp.asarray(x), jnp.asarray(taps), D, mode))
        np.testing.assert_allclose(y, oracle(x, taps, D), atol=1e-3)

    def test_batched(self, rng):
        T, D, M, B = 9, 3, 20, 4
        taps = rng.standard_normal(T).astype(np.float32)
        x = rng.standard_normal((B, T - 1 + M * D)).astype(np.float32)
        y = np.asarray(fir.fir_extended(jnp.asarray(x), jnp.asarray(taps), D, "poly"))
        assert y.shape == (B, M)
        for b in range(B):
            np.testing.assert_allclose(y[b], oracle(x[b], taps, D), atol=1e-3)

    def test_empty_output(self, rng):
        taps = rng.standard_normal(9).astype(np.float32)
        x = rng.standard_normal(4).astype(np.float32)  # < T: no outputs
        y = fir.fir_extended(jnp.asarray(x), jnp.asarray(taps), 2)
        assert y.shape == (0,)


class TestFirStreaming:
    """The FirTests.cpp:96-221 property, generalized."""

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize(
        "T,D",
        [
            (7, 2),
            # larger shapes re-check the same property at ~10x the compile
            # cost (6 fir_apply traces each, the suite's hot spot) — slow
            pytest.param(31, 4, marks=pytest.mark.slow),
            pytest.param(64, 1, marks=pytest.mark.slow),
        ],
    )
    def test_block_split_invariance(self, rng, mode, T, D):
        taps = jnp.asarray(rng.standard_normal(T).astype(np.float32))
        total = 64 * D
        x = (
            rng.standard_normal(total) + 1j * rng.standard_normal(total)
        ).astype(np.complex64)

        # One big block:
        s = fir.fir_init_state(taps, jnp.complex64)
        _, y_whole = fir.fir_apply(s, jnp.asarray(x), taps, D, mode)

        # Random chunking into D-multiples:
        s = fir.fir_init_state(taps, jnp.complex64)
        pieces = []
        i = 0
        sizes = [4 * D, 1 * D, 17 * D, 10 * D, 32 * D]
        for n in sizes:
            s, y = fir.fir_apply(s, jnp.asarray(x[i : i + n]), taps, D, mode)
            pieces.append(np.asarray(y))
            i += n
        assert i == total
        y_split = np.concatenate(pieces)
        np.testing.assert_allclose(y_split, np.asarray(y_whole), atol=1e-5)

    def test_matches_reference_contract(self, rng):
        """Streaming from zero state == convolving the zero-padded signal:
        output k uses inputs [k*D, k*D + T) of the padded stream."""
        T, D = 11, 2
        taps = rng.standard_normal(T).astype(np.float32)
        x = rng.standard_normal(40 * D).astype(np.float32)
        s = fir.fir_init_state(jnp.asarray(taps), jnp.float32)
        _, y = fir.fir_apply(s, jnp.asarray(x), jnp.asarray(taps), D)
        padded = np.concatenate([np.zeros(T - 1, np.float32), x])
        np.testing.assert_allclose(np.asarray(y), oracle(padded, taps, D), atol=1e-4)

    def test_indivisible_block_rejected(self, rng):
        taps = jnp.asarray(rng.standard_normal(5).astype(np.float32))
        s = fir.fir_init_state(taps, jnp.float32)
        with pytest.raises(ValueError):
            fir.fir_apply(s, jnp.zeros(7), taps, 2)


class TestAgainstScipy:
    def test_long_lowpass_fft_mode(self, rng):
        taps = sps.firwin(255, 0.1).astype(np.float32)
        x = rng.standard_normal(8192).astype(np.float32)
        y = np.asarray(
            fir.fir_full(jnp.asarray(x), jnp.asarray(taps), 1, "fft")
        )
        ref = sps.lfilter(taps, 1.0, x)  # causal filter == conv with zero pad
        np.testing.assert_allclose(y, ref[: len(y)], atol=1e-3)


@pytest.mark.parametrize("mode", ["pallas", "banded", "bogus"])
def test_unknown_modes_raise(mode):
    """Only the XLA paths exist: the former kernel modes are refused at
    construction, for Fir and FreqShiftFir alike."""
    from tpusdr.graph import blocks as B

    taps = sps.firwin(33, 0.2).astype(np.float32)
    with pytest.raises(ValueError, match="unknown FIR mode"):
        B.Fir(taps, 4, mode=mode)
    with pytest.raises(ValueError, match="unknown FIR mode"):
        B.FreqShiftFir(1e6, 1e5, taps, 4, mode=mode)
