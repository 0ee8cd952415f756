"""Named execution queues (graph/queues.py) — the CommandQueueFactory role
(reference src/commandqueue/CommandQueueFactory.cpp:35-77): queue
identity, device resolution from reference-style JSON, and the merged
single-dispatch runner for N independent pipelines sharing one device."""

import numpy as np
import pytest
import scipy.signal as sps

import jax

from tpusdr.graph import blocks as B
from tpusdr.graph.chain import Chain
from tpusdr.graph.queues import MergedRunner, QueueRegistry, get_queue_registry
from tpusdr.graph.runner import StreamRunner
from tpusdr.ops import cplx


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture
def singleton_registry():
    """Snapshot/restore the process-wide registry so tests that exercise the
    singleton surface don't leak queues across tests."""
    reg = get_queue_registry()
    saved = dict(reg._queues)
    try:
        yield reg
    finally:
        reg._queues = saved


def small_fm_chain():
    return Chain(
        [
            ("shift", B.FreqShift(1e6, -100e3)),
            ("fir", B.Fir(sps.firwin(33, 0.3).astype(np.float32), 4)),
            ("demod", B.QuadFmDemod(gain=1.2)),
        ]
    )


def small_am_chain():
    return Chain(
        [
            ("fir", B.Fir(sps.firwin(17, 0.4).astype(np.float32), 2)),
            ("demod", B.QuadAmDemod()),
            ("dc", B.DcBlock()),
        ]
    )


class TestQueueRegistry:
    def test_create_get_roundtrip(self):
        reg = QueueRegistry()
        q = reg.create("main", {"queueType": "gpu", "device": 0})
        assert reg.get("main") is q
        assert q.device == jax.devices()[0]
        assert "main" in reg.names()

    def test_reference_json_spelling(self):
        """CommandQueueFactory.cpp:49-66 spec: queueType cuda + cudaDevice."""
        reg = QueueRegistry()
        q = reg.create("gpu0", {"queueType": "cuda", "cudaDevice": 0})
        assert q.device == jax.devices()[0]

    def test_recreate_same_spec_is_idempotent(self):
        reg = QueueRegistry()
        q1 = reg.create("q", {"device": 0})
        q2 = reg.create("q", {"device": 0})
        assert q1 is q2

    def test_conflicting_recreate_raises(self):
        if len(jax.devices()) < 2:
            pytest.skip("needs >= 2 devices")
        reg = QueueRegistry()
        reg.create("q", {"device": 0})
        with pytest.raises(ValueError, match="already exists"):
            reg.create("q", {"device": 1})

    def test_out_of_range_device_degrades_to_zero(self):
        """An ordinal outside jax.devices() is NotFound
        (CommandQueueFactory.cpp:72-75): it raises instead of silently
        pinning the pipeline to device 0."""
        reg = QueueRegistry()
        with pytest.raises(ValueError, match="out of range"):
            reg.create("overflow", {"cudaDevice": 10_000})
        assert "overflow" not in reg.names()

    @pytest.mark.parametrize("qtype", ["cuda", "gpu", "cpu", "GPU"])
    def test_platform_spellings_accepted(self, qtype):
        reg = QueueRegistry()
        assert reg.create("q", {"queueType": qtype, "device": 0}).device == (
            jax.devices()[0]
        )

    def test_unknown_queue_raises(self):
        reg = QueueRegistry()
        with pytest.raises(KeyError, match="unknown command queue"):
            reg.get("nope")

    def test_unknown_queue_type_raises(self):
        """CommandQueueFactory.cpp:72-75: unknown queueType is NotFound, not
        a silent fall-through to device 0."""
        reg = QueueRegistry()
        with pytest.raises(ValueError, match="unknown queueType"):
            reg.create("typo", {"queueType": "cudaa"})

    def test_process_singleton(self):
        assert get_queue_registry() is get_queue_registry()


class TestMergedRunner:
    def test_merged_matches_individual(self, rng):
        """Two independent pipelines merged into one dispatch produce the
        same streams as stepping each alone (the multi-stream overlap
        pattern, sdrtest.cpp:331-364, as one XLA program)."""
        fm, am = small_fm_chain(), small_am_chain()
        n = 4096
        z = {
            "fm": (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
                np.complex64
            ),
            "am": (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
                np.complex64
            ),
        }
        xs = {k: cplx.from_numpy(v) for k, v in z.items()}

        merged = MergedRunner({"fm": fm, "am": am}, donate_state=False)
        states = merged.init_state()
        states, ys = merged.step(states, xs)
        states, ys2 = merged.step(states, xs)

        for name, chain in (("fm", fm), ("am", am)):
            s = chain.init_state()
            s, ref1 = chain.apply(s, xs[name])
            s, ref2 = chain.apply(s, xs[name])
            np.testing.assert_allclose(
                np.asarray(ys[name]), np.asarray(ref1), atol=1e-4
            )
            np.testing.assert_allclose(
                np.asarray(ys2[name]), np.asarray(ref2), atol=1e-4
            )

    def test_states_stay_independent(self, rng):
        """Stepping the fleet must not couple member carries: a third step
        of only-one-member input equals that member's solo stream."""
        c1, c2 = small_am_chain(), small_am_chain()
        n = 1024
        za = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64
        )
        zb = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64
        )
        merged = MergedRunner({"a": c1, "b": c2}, donate_state=False)
        states = merged.init_state()
        states, _ = merged.step(
            states, {"a": cplx.from_numpy(za), "b": cplx.from_numpy(zb)}
        )
        states, ys = merged.step(
            states, {"a": cplx.from_numpy(zb), "b": cplx.from_numpy(za)}
        )
        s = c1.init_state()
        s, _ = c1.apply(s, cplx.from_numpy(za))
        s, ref = c1.apply(s, cplx.from_numpy(zb))
        np.testing.assert_allclose(np.asarray(ys["a"]), np.asarray(ref), atol=1e-4)

    def test_empty_fleet_rejected(self):
        with pytest.raises(ValueError, match="at least one"):
            MergedRunner({})

    def test_queue_places_states_and_inputs(self, rng, singleton_registry):
        """A queue-bound fleet actually lands on the queue's device: states
        from init_state() and outputs of step() are committed there, and
        host-side numpy inputs are accepted (step device_puts them)."""
        devs = jax.devices()
        dev = devs[-1]  # non-default when the mesh has > 1 device
        singleton_registry.create("merged-q", {"queueType": "cpu", "device": dev.id})
        merged = MergedRunner(
            {"am": small_am_chain()}, queue="merged-q", donate_state=False
        )
        assert merged.device == dev
        states = merged.init_state()
        for leaf in jax.tree_util.tree_leaves(states):
            assert leaf.devices() == {dev}
        n = 1024
        z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64
        )
        states, ys = merged.step(states, {"am": cplx.from_numpy(z)})
        for leaf in jax.tree_util.tree_leaves((states, ys)):
            assert leaf.devices() == {dev}


class TestStreamRunnerQueue:
    def test_runner_accepts_queue_name(self, rng, singleton_registry):
        singleton_registry.create("test-stream-q", {"device": 0})
        chain = small_am_chain()
        runner = StreamRunner(chain, queue="test-stream-q")
        assert runner.device == jax.devices()[0]

        class ListSink:
            def __init__(self):
                self.chunks = []

            def write(self, x):
                self.chunks.append(x)

        n = 2048
        z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64
        )
        sink = ListSink()
        runner.run(iter([z, z]), sink)
        got = np.concatenate(sink.chunks)
        s = chain.init_state()
        s, r1 = chain.apply(s, cplx.from_numpy(z))
        s, r2 = chain.apply(s, cplx.from_numpy(z))
        ref = np.concatenate([np.asarray(r1), np.asarray(r2)])
        np.testing.assert_allclose(got, ref, atol=1e-4)
