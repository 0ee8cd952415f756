"""Sharding tests on a virtual 8-device CPU mesh.

The BASELINE.md stability bar: demodulated output stable across shardings
(sharded == unsharded).  The windows, NCO phases, and reduction *math* are
identical by construction; XLA's shape-dependent fusion reassociates float32
reductions at the last bit, so "stable" is asserted as error power below
-100 dB (vs the -60 dB design bound).  Strategy per SURVEY.md section 4:
multi-host logic verified on a virtual CPU mesh, no pod required.
"""

import numpy as np
import pytest
import scipy.signal as sps

import jax
import jax.numpy as jnp

from tpusdr.graph import blocks as B
from tpusdr.graph.chain import Chain
from tpusdr.models import multichannel, receiver
from tpusdr.ops import cplx
from tpusdr.parallel.halo import TimeShardedStream
from tpusdr.parallel.mesh import make_mesh


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def lp(n=33):
    return sps.firwin(n, 0.3).astype(np.float32)


def run_unsharded(chain, x_pair, ticks):
    s = chain.init_state()
    outs = []
    n = x_pair.shape[-1] // ticks
    for i in range(ticks):
        s, y = chain.apply(s, x_pair[..., i * n : (i + 1) * n])
        outs.append(np.asarray(y) if not cplx.is_pair(y) else cplx.to_numpy(y))
    return np.concatenate(outs, axis=-1)


def assert_shard_stable(shd, ref, snr_db=-100.0):
    """Sharded vs unsharded: identical math up to float32 reassociation.

    XLA fuses/vectorizes differently for different shard shapes, so the
    last bit can differ; we require the resulting error power to sit below
    ``snr_db`` (default -100 dB — 40 dB beyond the -60 dB design bound).
    """
    shd = np.asarray(shd)
    ref = np.asarray(ref)
    assert shd.shape == ref.shape
    err = np.mean(np.abs(shd - ref) ** 2)
    sig = np.mean(np.abs(ref) ** 2)
    if err == 0:
        return
    snr = 10 * np.log10(err / max(sig, 1e-30))
    assert snr < snr_db, f"sharding error at {snr:.1f} dB (limit {snr_db})"


def run_sharded(chain, x_pair, ticks, mesh):
    tss = TimeShardedStream(chain, mesh)
    carry = tss.init_carry()
    outs = []
    n = x_pair.shape[-1] // ticks
    for i in range(ticks):
        carry, y = tss.step(carry, x_pair[..., i * n : (i + 1) * n])
        outs.append(np.asarray(y) if not cplx.is_pair(y) else cplx.to_numpy(y))
    return np.concatenate(outs, axis=-1)


class TestTimeSharding:
    def test_fir_chain_bit_stable(self, rng):
        mesh = make_mesh(8)
        chain = Chain(
            [
                ("shift", B.FreqShift(1e6, -123e3)),
                ("fir", B.Fir(lp(33), 4)),
                ("demod", B.QuadFmDemod(gain=1.3)),
            ]
        )
        total = 8 * 1024 * 2
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, ticks=2)
        shd = run_sharded(chain, zp, ticks=2, mesh=mesh)
        assert_shard_stable(shd, ref)

    def test_two_and_four_shards_agree(self, rng):
        chain = Chain([("fir", B.Fir(lp(17), 2)), ("demod", B.QuadFmDemod(gain=1.0))])
        total = 4096
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 1)
        for s in (2, 4, 8):
            mesh = make_mesh(s)
            shd = run_sharded(chain, zp, 1, mesh)
            assert_shard_stable(shd, ref)

    def test_wbfm_receiver_sharded(self, rng):
        """Full WBFM chain (with IIR de-emphasis split to the sequential
        tail) sharded across 8 devices == unsharded."""
        mesh = make_mesh(8)
        chain, spec = receiver.fm_receiver(2e6, freq_offset=200e3)
        tick = chain.granule * max(1, (1 << 16) // chain.granule)
        # make tick divisible by shards * granule
        tick = 8 * chain.granule * max(1, tick // (8 * chain.granule))
        total = 2 * tick
        t = np.arange(total) / 2e6
        audio = np.sin(2 * np.pi * 1000 * t)
        ph = 2 * np.pi * 200e3 * t + 2 * np.pi * 75e3 * np.cumsum(audio) / 2e6
        z = np.exp(1j * ph).astype(np.complex64)
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 2)
        shd = run_sharded(chain, zp, 2, mesh)
        assert_shard_stable(shd, ref, snr_db=-80.0)

    def test_channelizer_sharded(self, rng):
        mesh = make_mesh(4)
        chain = Chain([("chan", B.Channelizer(8, taps_per_channel=6))])
        total = 8 * 128 * 4
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 2)
        shd = run_sharded(chain, zp, 2, mesh)
        assert_shard_stable(shd, ref)

    def test_streaming_across_ticks(self, rng):
        """Halo carry across tick boundaries: many small sharded ticks ==
        one unsharded pass."""
        mesh = make_mesh(8)
        chain = Chain([("fir", B.Fir(lp(33), 2))])
        total = 8192 * 2
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 1)
        shd = run_sharded(chain, zp, 4, mesh)
        assert_shard_stable(shd, ref)

    @pytest.mark.slow
    def test_deemphasis_sharded_near_warmup_cliff(self, rng):
        """IIR de-emphasis with a pole sized just under _MAX_IIR_WARMUP:
        the shard halo is the full ~32k-sample warmup, and sharded must
        still match unsharded (VERDICT r1 weak #9 — the boundary case the
        receiver-level test never reaches)."""
        mesh = make_mesh(8)
        fs = 48000.0
        target = int(B.Deemphasis._MAX_IIR_WARMUP * 0.97)
        tau = target / (-np.log(1e-7)) / fs
        blk = B.Deemphasis(fs, tau)
        assert blk.time_shardable and blk.history > 30000
        chain = Chain([("deemph", blk)])
        total = 8 * blk.history  # per-shard == halo: the minimum legal tick
        x = rng.standard_normal(total).astype(np.float32)
        ref = run_unsharded(chain, x, 1)
        shd = run_sharded(chain, x, 1, mesh)
        assert_shard_stable(shd, ref, snr_db=-90.0)

    @pytest.mark.slow
    def test_deemphasis_beyond_cliff_splits_to_tail(self, rng):
        """A pole beyond the cliff is not time-shardable; the chain must
        split it into the sequential tail and still match unsharded."""
        mesh = make_mesh(8)
        fs = 48000.0
        tau = (B.Deemphasis._MAX_IIR_WARMUP * 4) / (-np.log(1e-7)) / fs
        blk = B.Deemphasis(fs, tau)
        assert not blk.time_shardable
        chain = Chain(
            [
                ("fir", B.Fir(lp(33), 2)),
                ("demod", B.QuadFmDemod(gain=1.1)),
                ("deemph", blk),
            ]
        )
        total = 8192 * 2
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 2)
        shd = run_sharded(chain, zp, 2, mesh)
        assert_shard_stable(shd, ref)

    def test_rejects_bad_tick(self, rng):
        mesh = make_mesh(8)
        chain = Chain([("fir", B.Fir(lp(9), 2))])
        tss = TimeShardedStream(chain, mesh)
        with pytest.raises(ValueError, match="divisible"):
            tss.step(tss.init_carry(), cplx.zeros((1000,)))


class TestGraphTimeSharding:
    """Time-sharding a JSON-spec Graph (VERDICT r1 weak #5: the multi-chip
    path must accept the reference-parity config surface, not just Chain)."""

    def _spec(self, fs, with_dc=False):
        taps = sps.firwin(65, 0.2).astype(np.float32)
        nodes = {
            "osc": {
                "type": "Cosine",
                "sampleRate": fs,
                "frequency": -1.2e5,
                "sampleType": "FloatComplex",
            },
            "mix": {"type": "Multiply"},
            "lp": {"type": "Fir", "taps": [float(v) for v in taps], "decimation": 4},
            "dem": {
                "type": "QuadDemod",
                "modulation": "Fm",
                "sampleRate": fs / 4,
                "fskDeviation": 60e3,
            },
        }
        conns = [
            {"source": "osc", "sink": "mix", "sinkPort": 1},
            {"source": "mix", "sink": "lp"},
            {"source": "lp", "sink": "dem"},
        ]
        out = "dem"
        if with_dc:
            nodes["dc"] = {"type": "DcBlock"}
            conns.append({"source": "dem", "sink": "dc"})
            out = "dc"
        return {
            "nodes": nodes,
            "connections": conns,
            "inputPorts": [{"exposedPort": 0, "mapped": {"node": "mix", "port": 0}}],
            "outputPort": out,
        }

    def test_json_graph_sharded(self, rng):
        from tpusdr.graph.graph import build_graph

        g = build_graph(self._spec(1e6))
        mesh = make_mesh(8)
        total = 8 * 2048 * 2
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(g, zp, 2)
        shd = run_sharded(g, zp, 2, mesh)
        assert_shard_stable(shd, ref, snr_db=-80.0)

    def test_graph_nonshardable_tail_split(self, rng):
        """A non-shardable node (DcBlock IIR) must split to the sequential
        tail and still reproduce the unsharded stream."""
        from tpusdr.graph.graph import build_graph

        g = build_graph(self._spec(1e6, with_dc=True))
        head, tail = g.split_shardable()
        assert tail is not None and [n for n, _ in tail.blocks] == ["dc"]
        assert "dc" not in head.nodes and head.outputs == ["dem"]

        mesh = make_mesh(4)
        total = 4 * 4096
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(g, zp, 2)
        shd = run_sharded(g, zp, 2, mesh)
        assert_shard_stable(shd, ref, snr_db=-80.0)

    def test_graph_history_and_ratio(self):
        from tpusdr.graph.graph import build_graph

        g = build_graph(self._spec(1e6))
        # lp: 64 history at input rate; dem: 1 sample at fs/4 -> 4 at input
        assert g.history == 64 + 4
        assert (g.up, g.down) == (1, 4)


class Test2DMesh:
    """(host x chip) meshes: collectives over the flattened axis tuple
    (VERDICT r1 weak #6 / next #8)."""

    def test_time_sharding_2d_matches_1d(self, rng):
        chain = Chain([("fir", B.Fir(lp(33), 4)), ("demod", B.QuadFmDemod(gain=1.0))])
        total = 16384
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 2)
        mesh2d = make_mesh({"host": 2, "chip": 4})
        tss = TimeShardedStream(chain, mesh2d, axis=("host", "chip"))
        carry = tss.init_carry()
        outs = []
        for i in range(2):
            carry, y = tss.step(carry, zp[..., i * 8192 : (i + 1) * 8192])
            outs.append(np.asarray(y))
        assert_shard_stable(np.concatenate(outs, axis=-1), ref)

    def test_channel_bank_2d_uneven_channels(self, rng):
        """10 channels over a 2x4 mesh: padding path + tuple-axis
        all_to_all must match the unsharded bank."""
        from tpusdr.parallel.channels import ChannelShardedBank

        m = 10
        chan = B.Channelizer(m, taps_per_channel=6)
        demod = Chain([("demod", B.QuadFmDemod(gain=1.0))])
        mesh2d = make_mesh({"host": 2, "chip": 4})
        bank = ChannelShardedBank(chan, demod, mesh2d, axis=("host", "chip"))
        assert bank.m_pad == 16 and bank.local_channels == 2

        unsharded = Chain([("chan", chan), ("demod", B.QuadFmDemod(gain=1.0))])
        tick = 8 * bank.chan_chain.granule * 40
        z = (rng.standard_normal(2 * tick) + 1j * rng.standard_normal(2 * tick)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        carry = bank.init_carry()
        s = unsharded.init_state()
        for i in range(2):
            blk = zp[..., i * tick : (i + 1) * tick]
            carry, a = bank.step(carry, blk)
            s, r = unsharded.apply(s, blk)
            assert np.asarray(a).shape == np.asarray(r).shape == (m, tick // m)
            assert_shard_stable(a, r)


def run_sharded_stagewise(chain, x_pair, ticks, mesh):
    tss = TimeShardedStream(chain, mesh, stagewise=True)
    carry = tss.init_carry()
    outs = []
    n = x_pair.shape[-1] // ticks
    for i in range(ticks):
        carry, y = tss.step(carry, x_pair[..., i * n : (i + 1) * n])
        outs.append(np.asarray(y) if not cplx.is_pair(y) else cplx.to_numpy(y))
    return np.concatenate(outs, axis=-1)


class TestStagewiseHalo:
    """Per-stage-rate halos (stagewise=True): each stage exchanges its
    lookback at its OWN rate instead of one chain-wide input-rate halo —
    the redundant-compute fix that makes the 100 MHz scaling story close.
    Must match unsharded exactly like the
    chain-wide halo does."""

    def test_fir_cascade_matches_unsharded(self, rng):
        mesh = make_mesh(8)
        chain = Chain(
            [
                ("fir1", B.Fir(lp(65), 4)),
                ("fir2", B.Fir(lp(17), 2)),
            ]
        )
        total = 8 * 4096
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 2)
        shd = run_sharded_stagewise(chain, zp, 2, mesh)
        assert_shard_stable(shd, ref)

    def test_wbfm_receiver_stagewise(self, rng):
        """Full WBFM chain (shiftfir -> demod -> deemph -> resampler) with
        per-stage halos across 8 devices == unsharded, streamed across
        tick boundaries (the cross-tick per-stage tail carries)."""
        mesh = make_mesh(8)
        chain, spec = receiver.fm_receiver(2e6, freq_offset=200e3)
        tick = 8 * chain.granule * max(1, (1 << 16) // (8 * chain.granule))
        total = 3 * tick
        t = np.arange(total) / 2e6
        audio = np.sin(2 * np.pi * 1000 * t)
        ph = 2 * np.pi * 200e3 * t + 2 * np.pi * 75e3 * np.cumsum(audio) / 2e6
        z = np.exp(1j * ph).astype(np.complex64)
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 3)
        shd = run_sharded_stagewise(chain, zp, 3, mesh)
        assert_shard_stable(shd, ref, snr_db=-80.0)

    def test_stagewise_halo_is_smaller(self):
        """The whole point: per-stage halos never inflate a decimated
        stage's lookback by the upstream rate ratio."""
        mesh = make_mesh(8)
        chain, _ = receiver.fm_receiver(20e6, freq_offset=2.5e6)
        tss = TimeShardedStream(chain, mesh, stagewise=True)
        stage_cost = sum(h for _n, _b, h, _s, _bs in tss._stages)
        # chain-wide halo re-computes ~chain.history input samples per
        # shard (40000 at 20 MHz); stagewise re-computes each stage's own
        # history at its own rate (~1400 sample-equivalents) — the
        # decimation ratio never inflates a downstream stage's lookback
        assert stage_cost < tss.halo / 20

    def test_channelizer_stagewise(self, rng):
        mesh = make_mesh(4)
        chain = Chain(
            [
                ("chan", B.Channelizer(8, taps_per_channel=6)),
                ("fir", B.Fir(lp(17), 1, "FloatComplex")),
            ]
        )
        total = 8 * 128 * 4
        z = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(
            np.complex64
        )
        zp = cplx.from_numpy(z)
        ref = run_unsharded(chain, zp, 2)
        shd = run_sharded_stagewise(chain, zp, 2, mesh)
        assert_shard_stable(shd, ref)
