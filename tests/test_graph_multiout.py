"""Multi-output Graph and fan-out tests.

The reference supports fan-out via per-port output copiers
(SteppingDriver.cpp:309-358, BaseSource copier vector); here a node value is
an immutable array, so fan-out is free — multiple consumers and multiple
graph outputs read the same value.
"""

import numpy as np
import pytest
import scipy.signal as sps

from tpusdr.graph import blocks as B
from tpusdr.graph.graph import Graph
from tpusdr.ops import cplx


@pytest.fixture
def rng():
    return np.random.default_rng(77)


class TestFanOut:
    def test_one_source_two_consumers_two_outputs(self, rng):
        taps = sps.firwin(17, 0.3).astype(np.float32)
        g = Graph(
            nodes={
                "fir": B.Fir(taps, 2),
                "fm": B.QuadFmDemod(gain=1.0),
                "mag": B.Magnitude(),
            },
            connections=[("fir", 0, "fm", 0), ("fir", 0, "mag", 0)],
            input_map=[(0, "fir", 0)],
            output=["fm", "mag"],
        )
        z = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(
            np.complex64
        )
        s = g.init_state()
        s, (y_fm, y_mag) = g.apply(s, cplx.from_numpy(z))
        assert np.asarray(y_fm).shape == (256,)
        assert np.asarray(y_mag).shape == (256,)
        # mag consumer sees the same FIR output the demod does
        _, direct = B.Fir(taps, 2).apply(
            B.Fir(taps, 2).init_state(), cplx.from_numpy(z)
        )
        np.testing.assert_allclose(
            np.asarray(y_mag), np.abs(cplx.to_numpy(direct)), atol=1e-5
        )

    def test_streaming_multi_output(self, rng):
        taps = sps.firwin(9, 0.4).astype(np.float32)
        g = Graph(
            nodes={"fir": B.Fir(taps, 1), "fm": B.QuadFmDemod(gain=2.0),
                   "mag": B.Magnitude()},
            connections=[("fir", 0, "fm", 0), ("fir", 0, "mag", 0)],
            input_map=[(0, "fir", 0)],
            output=["fm", "mag"],
        )
        z = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        s = g.init_state()
        parts_fm, parts_mag = [], []
        for i in range(0, 1024, 256):
            s, (a, b) = g.apply(s, zp[..., i : i + 256])
            parts_fm.append(np.asarray(a))
            parts_mag.append(np.asarray(b))
        s0 = g.init_state()
        _, (wa, wb) = g.apply(s0, zp)
        # 1e-5: banded-matmul FIR tile-phase reassociation (see test_graph_chain note).
        np.testing.assert_allclose(np.concatenate(parts_fm), np.asarray(wa), atol=1e-5)
        np.testing.assert_allclose(np.concatenate(parts_mag), np.asarray(wb), atol=1e-5)


class TestMultiSinkRunner:
    """StreamRunner drives a multi-output Graph into one sink per port
    (the reference's multiple-sinks-per-source-port fan-out,
    SteppingDriver.cpp:309-362)."""

    def _tapped_fm(self):
        import scipy.signal as sps

        from tpusdr.graph.chain import Chain
        from tpusdr.graph.graph import tapped

        taps = sps.firwin(17, 0.3).astype(np.float32)
        chain = Chain(
            [
                ("fir", B.Fir(taps, 2)),
                ("demod", B.QuadFmDemod(gain=1.0)),
            ]
        )
        return chain, tapped(chain, ["fir"])

    def test_audio_plus_if_in_one_pass(self, rng):
        from tpusdr.graph.runner import StreamRunner
        from tpusdr.io.sinks import CollectSink

        chain, g = self._tapped_fm()
        n = 512
        blocks = [
            (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
                np.complex64
            )
            for _ in range(3)
        ]
        audio_sink, if_sink = CollectSink(), CollectSink()
        runner = StreamRunner(g, donate_state=False)
        _, stats = runner.run(iter(blocks), [audio_sink, if_sink])

        # single-sink plain-chain run gives the reference audio stream
        ref_sink = CollectSink()
        _, ref_stats = StreamRunner(chain, donate_state=False).run(
            iter(blocks), ref_sink
        )
        np.testing.assert_allclose(
            audio_sink.result(), ref_sink.result(), atol=1e-5
        )
        # the IF tap is the FIR output stream
        fir = B.Fir(
            np.asarray(chain.get_block("fir").taps, np.float32), 2
        )
        s = fir.init_state()
        parts = []
        for b in blocks:
            s, y = fir.apply(s, cplx.from_numpy(b))
            parts.append(cplx.to_numpy(y))
        np.testing.assert_allclose(
            if_sink.result(), np.concatenate(parts), atol=1e-5
        )
        assert stats.samples_out_ports == [
            audio_sink.samples_written,
            if_sink.samples_written,
        ]
        assert stats.samples_out == audio_sink.samples_written

    def test_sink_count_mismatch_raises(self, rng):
        from tpusdr.graph.runner import StreamRunner
        from tpusdr.io.sinks import CollectSink

        _, g = self._tapped_fm()
        z = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
            np.complex64
        )
        with pytest.raises(ValueError, match="outputs but 1 sinks"):
            StreamRunner(g, donate_state=False).run(iter([z]), CollectSink())

    def test_tapped_validates_names(self):
        from tpusdr.graph.graph import tapped

        chain, _ = self._tapped_fm()
        with pytest.raises(KeyError, match="no stage named"):
            tapped(chain, ["nope"])
        with pytest.raises(ValueError, match="already port 0"):
            tapped(chain, ["demod"])

    def test_per_port_postprocess(self, rng):
        from tpusdr.graph.runner import StreamRunner
        from tpusdr.io.sinks import CollectSink

        _, g = self._tapped_fm()
        z = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
            np.complex64
        )
        a, b = CollectSink(), CollectSink()
        StreamRunner(g, donate_state=False).run(
            iter([z]), [a, b], postprocess=[lambda x: 2.0 * x, None]
        )
        a2, b2 = CollectSink(), CollectSink()
        StreamRunner(g, donate_state=False).run(iter([z]), [a2, b2])
        np.testing.assert_allclose(a.result(), 2.0 * a2.result(), atol=1e-6)
        np.testing.assert_allclose(b.result(), b2.result(), atol=1e-6)
