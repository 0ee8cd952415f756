"""Demodulator and IIR tests (FM discriminator, AM envelope, de-emphasis)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpusdr.ops import cplx, demod, iir


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def fm_modulate(audio, fs, deviation):
    phase = 2 * np.pi * deviation * np.cumsum(audio) / fs
    return np.exp(1j * phase).astype(np.complex64)


class TestQuadFmDemod:
    def test_recovers_instantaneous_frequency(self):
        fs, deviation = 250e3, 75e3
        t = np.arange(25000) / fs
        audio = 0.5 * np.sin(2 * np.pi * 1000 * t).astype(np.float32)
        iq = fm_modulate(audio, fs, deviation)
        gain = fs / (2 * np.pi * deviation)
        y = np.asarray(demod.quad_fm_demod_ext(cplx.from_numpy(iq), gain))
        # y[n] ~ audio[n+1] (one-sample discriminator delay structure)
        err = y[10:20000] - audio[11:20001]
        assert np.abs(err).max() < 1e-2

    def test_streaming_matches_whole(self, rng):
        iq = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(
            np.complex64
        )
        gain = 1.7
        xp = cplx.from_numpy(iq)
        s = demod.quad_fm_demod_init()
        outs = []
        for i in range(0, 4096, 512):
            s, y = demod.quad_fm_demod_apply(s, xp[..., i : i + 512], gain)
            outs.append(np.asarray(y))
        split = np.concatenate(outs)
        s0 = demod.quad_fm_demod_init()
        _, whole = demod.quad_fm_demod_apply(s0, xp, gain)
        np.testing.assert_allclose(split, np.asarray(whole), atol=1e-6)

    def test_n_in_n_out_with_carry(self):
        """Reference contract: N+1 available -> N outputs, 1 retained
        (QuadFmDemod.cpp:81-107)."""
        x = cplx.from_numpy(np.exp(1j * np.linspace(0, 3, 17)).astype(np.complex64))
        s = demod.quad_fm_demod_init()
        s2, y = demod.quad_fm_demod_apply(s, x, 1.0)
        assert y.shape == (17,)
        np.testing.assert_allclose(
            cplx.to_numpy(s2), cplx.to_numpy(x)[-1:], atol=1e-7
        )


class TestAmAndElementwise:
    def test_envelope(self, rng):
        z = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
            np.complex64
        )
        y = np.asarray(demod.quad_am_demod(cplx.from_numpy(z)))
        np.testing.assert_allclose(y, np.abs(z), atol=1e-5)

    def test_add_const_to_vector_length(self, rng):
        z = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(
            np.complex64
        )
        c = -0.25
        y = cplx.to_numpy(demod.add_const_to_vector_length(cplx.from_numpy(z), c))
        np.testing.assert_allclose(np.abs(y), np.abs(np.abs(z) + c), atol=1e-5)
        # Phase preserved (up to sign flips where magnitude went negative).
        keep = np.abs(z) + c > 0
        np.testing.assert_allclose(
            np.angle(y[keep]), np.angle(z[keep]), atol=1e-5
        )


class TestDeemphasis:
    def test_matches_scipy_lfilter(self, rng):
        import scipy.signal as sps

        fs, tau = 48000.0, 75e-6
        a, b = iir.deemphasis_coeffs(tau, fs)
        x = rng.standard_normal(8192).astype(np.float32)
        s = iir.single_pole_init()
        _, y = iir.single_pole_apply(s, jnp.asarray(x), a, b)
        ref = sps.lfilter([b], [1.0, -a], x)
        np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4)

    def test_streaming_invariance(self, rng):
        a, b = 0.95, 0.05
        x = rng.standard_normal(1024).astype(np.float32)
        s = iir.single_pole_init()
        outs = []
        for i in range(0, 1024, 128):
            s, y = iir.single_pole_apply(s, jnp.asarray(x[i : i + 128]), a, b)
            outs.append(np.asarray(y))
        split = np.concatenate(outs)
        _, whole = iir.single_pole_apply(iir.single_pole_init(), jnp.asarray(x), a, b)
        np.testing.assert_allclose(split, np.asarray(whole), atol=1e-5)

    def test_warmup_history_decays_initial_state(self, rng):
        """The time-sharding contract (blocks.py Deemphasis docstring): a
        pole sized just under the _MAX_IIR_WARMUP cliff still re-creates
        the carry from ``history`` halo samples to below -140 dB — i.e.
        two runs over the same input from adversarially different initial
        states agree after ``history`` samples (VERDICT r1 weak #9)."""
        from tpusdr.graph import blocks as B

        fs = 48000.0
        # warmup = ceil(ln(1e-7)/ln(a)) with a = exp(-1/(tau*fs)), so
        # warmup ~= -ln(1e-7) * tau * fs; aim just under the cliff.
        target = int(B.Deemphasis._MAX_IIR_WARMUP * 0.97)
        tau = target / (-np.log(1e-7)) / fs
        blk = B.Deemphasis(fs, tau)
        assert blk.time_shardable
        assert 0.9 * B.Deemphasis._MAX_IIR_WARMUP < blk.history
        assert blk.history <= B.Deemphasis._MAX_IIR_WARMUP

        w = blk.history
        x = jnp.asarray(rng.standard_normal(w + 2048).astype(np.float32))
        _, y_zero = blk.apply(blk.init_state(), x)
        # a wildly wrong carry: 1000x the signal RMS
        s_bad = jnp.full((1,), 1000.0, jnp.float32)
        _, y_bad = blk.apply(s_bad, x)
        err = np.asarray(y_bad[w:]) - np.asarray(y_zero[w:])
        # The leak is exactly a^(n+1) * delta_carry; -140 dB relative to
        # the injected carry error means an amplitude factor <= 1e-7
        # (ceil() sizing guarantees a^history <= 1e-7; 3x slack for f32).
        leak = np.max(np.abs(err)) / 1000.0
        assert leak < 3e-7, f"initial state leaked at {leak:.2e} of carry error"
        # In the sharded-halo case the carry error is at signal scale, so
        # the same bound puts the output error near -140 dB vs the signal.

    def test_beyond_cliff_not_shardable(self):
        """Poles too slow to warm up fall back to the sequential tail."""
        from tpusdr.graph import blocks as B

        fs = 48000.0
        tau = (B.Deemphasis._MAX_IIR_WARMUP * 4) / (-np.log(1e-7)) / fs
        blk = B.Deemphasis(fs, tau)
        assert not blk.time_shardable
        assert blk.history == 1

    def test_3db_point(self):
        """De-emphasis -3 dB at 1/(2 pi tau)."""
        fs, tau = 480000.0, 75e-6
        a, b = iir.deemphasis_coeffs(tau, fs)
        f3 = 1 / (2 * np.pi * tau)
        w, h = np.abs(
            np.array(
                [
                    (
                        f,
                        abs(
                            b
                            / (1 - a * np.exp(-2j * np.pi * f / fs))
                        ),
                    )
                    for f in [10.0, f3]
                ]
            )
        ).T
        ratio = h[1] / h[0]
        assert abs(ratio - 1 / np.sqrt(2)) < 0.05


class TestBlockedIir:
    """The blocked matmul one-pole form (ops/iir._first_order_blocked) must be
    numerically interchangeable with the associative scan and scipy."""

    def test_blocked_matches_scipy_and_scan(self, rng):
        import scipy.signal as sps

        from tpusdr.ops import iir

        a, b = iir.single_pole_coeffs(75e-6, 320e3)
        x = rng.standard_normal((3, 8192)).astype(np.float32)
        st = iir.single_pole_init((3,))
        # long divisible axis -> blocked path
        assert x.shape[-1] >= iir._BLOCKED_MIN_N and x.shape[-1] % iir._BLOCK == 0
        _, y = iir.single_pole_apply(st, jnp.asarray(x), a, b)
        ref = sps.lfilter([b], [1, -a], x, axis=-1)
        np.testing.assert_allclose(np.asarray(y), ref, atol=2e-5)
        # forced scan path on the same data agrees
        y_scan = iir._first_order_scan(
            jnp.asarray(a, jnp.float32), jnp.float32(b) * jnp.asarray(x), st
        )
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_scan), atol=2e-5)

    def test_blocked_streaming_invariance(self, rng):
        import scipy.signal as sps

        from tpusdr.ops import iir

        a, b = iir.single_pole_coeffs(50e-6, 48e3)
        x = rng.standard_normal(4 * 4096).astype(np.float32)
        st = iir.single_pole_init()
        ys = []
        for c in x.reshape(4, 4096):  # each chunk takes the blocked path
            st, y = iir.single_pole_apply(st, jnp.asarray(c), a, b)
            ys.append(np.asarray(y))
        ref = sps.lfilter([b], [1, -a], x)
        np.testing.assert_allclose(np.concatenate(ys), ref, atol=2e-5)

    def test_blocked_nondivisible_length_padded_path(self, rng):
        """Lengths >= the cliff but NOT a multiple of _BLOCK must still take
        the blocked path via zero padding (config 4's 32760-frame channels
        fell through to the associative scan and cost 10x, r4)."""
        import scipy.signal as sps

        from tpusdr.ops import iir

        a, b = iir.single_pole_coeffs(75e-6, 320e3)
        n = 32760  # 20.48e6 / 64 channels * 0.1024 s tick; % 256 == 248
        assert n >= iir._BLOCKED_MIN_N and n % iir._BLOCK != 0
        x = rng.standard_normal((2, n)).astype(np.float32)
        st = iir.single_pole_init((2,))
        st2, y = iir.single_pole_apply(st, jnp.asarray(x), a, b)
        ref = sps.lfilter([b], [1, -a], x, axis=-1)
        np.testing.assert_allclose(np.asarray(y), ref, atol=2e-5)
        # carry is the true last output, not a padded sample
        np.testing.assert_allclose(
            np.asarray(st2)[:, 0], ref[:, -1], atol=2e-5
        )
