"""Chain / Graph / registry / checkpoint / dot tests.

Covers the reference's L4/L5 behaviors this build re-designs: composite
construction from JSON (FilterDriverFactory.cpp:181-274), single-source-
per-port validation (SteppingDriver.cpp:418-442), rate planning replacing
runtime negotiation, and stream-state checkpointing (absent in reference).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpusdr.graph import blocks as B
from tpusdr.graph.chain import Chain
from tpusdr.graph.checkpoint import load_state, save_state
from tpusdr.graph.dot import to_dot
from tpusdr.graph.graph import Graph, build_graph
from tpusdr.graph.registry import create_block, get_registry
from tpusdr.ops import cplx


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def lp_taps(n=31):
    import scipy.signal as sps

    return sps.firwin(n, 0.4).astype(np.float32)


class TestChain:
    def test_rate_and_granule(self):
        c = Chain(
            [
                ("iq", B.IqToComplex("int8")),
                ("fir", B.Fir(lp_taps(), decimation=4)),
                ("demod", B.QuadFmDemod(gain=1.0)),
                ("audio", B.Resampler(3, 5)),
            ]
        )
        # ratio: 1/1 (packed IQ words) * 1/4 * 1 * 3/5 = 3/20
        assert (c.up, c.down) == (3, 20)
        n = c.granule
        assert n % 4 == 0  # must clear the /4 decimation
        out = c.out_len(n)
        assert out == n * 3 // 20

    def test_apply_matches_manual(self, rng):
        taps = lp_taps()
        c = Chain([("fir", B.Fir(taps, 2)), ("demod", B.QuadFmDemod(gain=2.0))])
        z = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
            np.complex64
        )
        s = c.init_state()
        s, y = c.apply(s, cplx.from_numpy(z))
        assert np.asarray(y).shape == (128,)

    def test_block_split_invariance_full_chain(self, rng):
        """The FirTests streaming property, applied to a whole receiver
        chain: any chunking yields identical samples."""
        taps = lp_taps(17)
        c = Chain(
            [
                ("shift", B.FreqShift(1e6, -100e3)),
                ("fir", B.Fir(taps, 4)),
                ("demod", B.QuadFmDemod(gain=1.5)),
            ]
        )
        z = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)

        s = c.init_state()
        _, whole = c.apply(s, zp)

        s = c.init_state()
        outs = []
        for n in (256, 64, 448, 256):
            i = sum(x.shape[-1] for x in outs) * 4  # consumed so far
        i = 0
        outs = []
        for n in (256, 64, 448, 256):
            s, y = c.apply(s, zp[..., i : i + n])
            outs.append(np.asarray(y))
            i += n
        # Same samples up to float32 reassociation: the banded-matmul FIR's output
        # tile phase depends on the block boundary, so a chunking that is
        # not a tile multiple regroups the (banded, mostly-zero) dot terms.
        # The streaming contract is the reference's 1e-3 (FirTests.cpp:87);
        # we hold 1e-5.  Bit-exactness holds in mode='poly' (test_fir).
        np.testing.assert_allclose(
            np.concatenate(outs), np.asarray(whole), atol=1e-5
        )

    def test_checkpoint_resume(self, rng, tmp_path):
        c = Chain([("fir", B.Fir(lp_taps(), 2)), ("demod", B.QuadFmDemod(gain=1.0))])
        z = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        s = c.init_state()
        s, y1 = c.apply(s, zp[..., :256])
        path = str(tmp_path / "ckpt.npz")
        save_state(path, s)
        restored = load_state(path, c.init_state())
        _, y2a = c.apply(s, zp[..., 256:])
        _, y2b = c.apply(restored, zp[..., 256:])
        np.testing.assert_array_equal(np.asarray(y2a), np.asarray(y2b))


class TestRegistry:
    def test_reference_names_registered(self):
        reg = get_registry()
        # Name parity with FilterFactories.cpp:132-150 (minus CUDA/hw-only).
        for name in [
            "AddConst",
            "AddConstToVectorLength",
            "Cosine",
            "Fir",
            "Int8ToFloat",
            "Magnitude",
            "Multiply",
            "QuadDemod",
        ]:
            assert name in reg, f"{name} missing from registry"

    def test_create_quad_demod_dispatch(self):
        fm = create_block(
            "QuadDemod", {"modulation": "Fm", "sample_rate": 1e6, "channel_width": 1e5}
        )
        am = create_block("QuadDemod", {"modulation": "Am"})
        assert isinstance(fm, B.QuadFmDemod)
        assert isinstance(am, B.QuadAmDemod)


class TestGraph:
    def spec(self):
        return {
            "nodes": {
                "cosineSource": {
                    "type": "Cosine",
                    "sampleType": "FloatComplex",
                    "sampleRate": 1e6,
                    "frequency": -150e3,
                    "commandQueueId": "ignored",
                    "description": "osc",
                },
                "multiplyForFrequencyShift": {"type": "Multiply"},
                "rfLowPassFilter": {
                    "type": "Fir",
                    "taps": [float(t) for t in lp_taps(21)],
                    "decimation": 2,
                },
                "quadDemod": {
                    "type": "QuadDemod",
                    "modulation": "Fm",
                    "sampleRate": 500e3,
                    "fskDeviation": 75e3,
                },
            },
            "connections": [
                {"source": "cosineSource", "sink": "multiplyForFrequencyShift", "sinkPort": 1},
                {"source": "multiplyForFrequencyShift", "sink": "rfLowPassFilter"},
                {"source": "rfLowPassFilter", "sink": "quadDemod"},
            ],
            "inputPorts": [
                {"exposedPort": 0, "mapped": {"node": "multiplyForFrequencyShift", "port": 0}}
            ],
            "outputPort": "quadDemod",
        }

    def test_build_from_reference_style_json(self, rng):
        g = build_graph(self.spec())
        assert (g.up, g.down) == (1, 2)
        z = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(
            np.complex64
        )
        s = g.init_state()
        s, y = g.apply(s, cplx.from_numpy(z))
        assert np.asarray(y).shape == (256,)

    def test_graph_matches_fused_freqshift(self, rng):
        """Cosine->Multiply graph == fused FreqShift chain (same NCO)."""
        g = build_graph(self.spec())
        taps = lp_taps(21)
        c = Chain(
            [
                ("shift", B.FreqShift(1e6, -150e3)),
                ("fir", B.Fir(taps, 2)),
                ("demod", B.QuadFmDemod(gain=500e3 / (2 * np.pi * 75e3))),
            ]
        )
        z = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        _, yg = g.apply(g.init_state(), zp)
        _, yc = c.apply(c.init_state(), zp)
        np.testing.assert_allclose(np.asarray(yg), np.asarray(yc), atol=1e-4)

    def test_double_connect_rejected(self):
        spec = self.spec()
        spec["connections"].append(
            {"source": "rfLowPassFilter", "sink": "quadDemod"}
        )
        with pytest.raises(ValueError, match="already connected"):
            build_graph(spec)

    def test_cycle_rejected(self):
        spec = self.spec()
        spec["connections"].append(
            {"source": "quadDemod", "sink": "rfLowPassFilter"}
        )
        with pytest.raises(ValueError):
            build_graph(spec)

    def test_streaming_invariance(self, rng):
        g = build_graph(self.spec())
        z = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        _, whole = g.apply(g.init_state(), zp)
        s = g.init_state()
        outs = []
        for i in range(0, 1024, 256):
            s, y = g.apply(s, zp[..., i : i + 256])
            outs.append(np.asarray(y))
        # 1e-5: banded-matmul FIR tile-phase reassociation (see TestChain note).
        np.testing.assert_allclose(np.concatenate(outs), np.asarray(whole), atol=1e-5)


class TestDot:
    def test_dot_export(self):
        c = Chain([("fir", B.Fir(lp_taps(), 2)), ("demod", B.QuadFmDemod(gain=1.0))])
        dot = to_dot(c, "rx")
        assert "digraph rx" in dot
        assert "fir" in dot and "demod" in dot
        g = build_graph(TestGraph().spec())
        dot2 = to_dot(g, "component")
        assert "cosineSource" in dot2 and "->" in dot2


class TestRunOfflineFlat:
    """run_offline mode='flat' (one whole-capture apply — the r5 headline
    path) produces the same sample stream as the per-tick scan."""

    def test_flat_equals_scan(self):
        import numpy as np

        from tpusdr.graph.runner import run_offline
        from tpusdr.models import receiver
        from tpusdr.ops import cplx

        rng = np.random.default_rng(11)
        chain, _ = receiver.fm_receiver(2e6, 300e3, receiver.WBFM, 48000.0)
        tick, K = chain.granule, 3
        xs = cplx.Complex(
            rng.standard_normal((K, tick)).astype(np.float32),
            rng.standard_normal((K, tick)).astype(np.float32),
        )
        _, y_scan = run_offline(chain, xs, mode="scan")
        _, y_flat = run_offline(chain, xs, mode="flat")
        np.testing.assert_allclose(
            np.asarray(y_scan).reshape(-1), np.asarray(y_flat), atol=1e-6
        )
        _, y_auto = run_offline(chain, xs, mode="auto")
        assert y_auto.shape == y_flat.shape
