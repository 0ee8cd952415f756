"""FusedFmDemod (graph/blocks.py): the fused shift -> decimating FIR -> FM
discriminator block against the unfused FreqShift -> Fir -> QuadFmDemod
chain, streaming, under time sharding and across tick sizes.

Tolerance: the fused block folds the shift into complex taps, so its FIR
sums other products than the unfused mix-then-filter; both are float32.
On white-noise input a few outputs sit near the stop-band floor, where the
discriminator's atan2 turns ~1e-6 relative FIR error into up to ~1e-3 of
angle, so outputs agree to 2e-3 (audio quality is held by test_accuracy
and chip_smoke's SNR checks).
"""

import numpy as np
import pytest
import scipy.signal as sps

from tests.test_parallel import assert_shard_stable, run_unsharded
from tpusdr.graph import blocks as B
from tpusdr.graph.chain import Chain
from tpusdr.models import receiver
from tpusdr.ops import cplx
from tpusdr.parallel.halo import TimeShardedStream
from tpusdr.parallel.mesh import make_mesh
from tpusdr.utils.numerics import lcm

ATOL = 2e-3


@pytest.fixture
def rng():
    return np.random.default_rng(9)


def _noise(rng, n):
    return cplx.from_numpy(
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    )


def _unfused(fs, f, taps, d, gain):
    return Chain(
        [
            ("shift", B.FreqShift(fs, f)),
            ("fir", B.Fir(taps, d)),
            ("demod", B.QuadFmDemod(gain=gain)),
        ]
    )


def _run(block, xs, cuts):
    s = block.init_state()
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        s, y = block.apply(s, xs[..., a:b])
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1)


class TestFusedFmBlock:
    def test_streaming_matches_unfused_chain(self, rng):
        """use_fused=True receiver == the unfused receiver, tick by tick."""
        fs = 2e6
        chain_fused, _ = receiver.fm_receiver(
            fs, 300e3, receiver.WBFM, deemphasis_tau=None, use_fused=True
        )
        chain_ref, _ = receiver.fm_receiver(
            fs, 300e3, receiver.WBFM, deemphasis_tau=None, multistage=False
        )
        assert [n for n, _ in chain_fused.blocks][0] == "frontend"
        g = lcm(chain_ref.granule, chain_fused.granule)
        tick = g * max(1, 20000 // g)
        zp = _noise(rng, 3 * tick)
        sf, sr_ = chain_fused.init_state(), chain_ref.init_state()
        for i in range(3):
            blk = zp[..., i * tick : (i + 1) * tick]
            sf, yf = chain_fused.apply(sf, blk)
            sr_, yr = chain_ref.apply(sr_, blk)
            np.testing.assert_allclose(
                np.asarray(yf), np.asarray(yr), atol=ATOL, err_msg=f"tick {i}"
            )

    @pytest.mark.parametrize(
        "T,D,n", [(65, 8, 8192), (89, 5, 5000), (33, 2, 2048)]
    )
    def test_matches_unfused_chain_shapes(self, rng, T, D, n):
        """Block-level equivalence over (taps, decimation) shapes, two ticks
        so the carried (T-1)+D tail is exercised."""
        taps = sps.firwin(T, 0.8 / D).astype(np.float32)
        fused = B.FusedFmDemod(1e6, -150e3, taps, D, gain=1.7)
        assert fused.granule == D and fused.history == T - 1 + D
        ref = _unfused(1e6, -150e3, taps, D, 1.7)
        xs = _noise(rng, 2 * n)
        cuts = [0, n, 2 * n]
        np.testing.assert_allclose(_run(fused, xs, cuts), _run(ref, xs, cuts), atol=ATOL)

    def test_time_shardable(self, rng):
        """Fused front end under time sharding matches unsharded."""
        fs = 1e6
        chain, _ = receiver.fm_receiver(
            fs, 125e3, receiver.WBFM, deemphasis_tau=None, use_fused=True
        )
        tss = TimeShardedStream(chain, make_mesh(4))
        tick = tss.tick_granule * max(1, (tss.halo + 4096) * 4 // tss.tick_granule)
        zp = _noise(rng, tick)
        _, ref = chain.apply(chain.init_state(), zp)
        _, shd = tss.step(tss.init_carry(), zp)
        assert_shard_stable(np.asarray(shd), np.asarray(ref))


class TestFusedEdges:
    def test_mixed_tick_sizes_keep_continuity(self, rng):
        """Ticks of different lengths keep the stream continuous: the
        fused block, fed 48k / 48k+64 / 48k samples, equals the unfused
        chain fed the same cuts."""
        t = sps.firwin(65, 0.1).astype(np.float32)
        fused = B.FusedFmDemod(1e6, -150e3, t, 8, gain=1.7)
        ref = _unfused(1e6, -150e3, t, 8, 1.7)
        n_a, n_b = 48 * 1024, 48 * 1024 + 64
        total = 2 * n_a + n_b
        xs = _noise(rng, total)
        cuts = [0, n_a, n_a + n_b, total]
        y = _run(fused, xs, cuts)
        assert y.shape == (total // 8,)
        np.testing.assert_allclose(y, _run(ref, xs, cuts), atol=ATOL)
        # and the cut points do not matter
        np.testing.assert_allclose(y, _run(fused, xs, [0, total]), atol=1e-5)

    def test_stagewise_sharding_with_fused_chain(self, rng):
        """Per-stage-rate halos over a chain whose front end is the fused
        block (granule D; the cold halo warmup must honor its tail carry)."""
        fs = 1e6
        chain, _ = receiver.fm_receiver(
            fs, 125e3, receiver.WBFM, deemphasis_tau=None, use_fused=True
        )
        tss = TimeShardedStream(chain, make_mesh(4), stagewise=True)
        tick = tss.tick_granule * max(1, (tss.halo + 4096) * 4 // tss.tick_granule)
        zp = _noise(rng, 2 * tick)
        ref = run_unsharded(chain, zp, 2)
        carry = tss.init_carry()
        outs = []
        for i in range(2):
            carry, y = tss.step(carry, zp[..., i * tick : (i + 1) * tick])
            outs.append(np.asarray(y))
        assert_shard_stable(np.concatenate(outs), ref)
