"""Channel-sharded multi-channel receiver (BASELINE.md config 4).

Topology per streaming tick, on a 1-D device mesh (or a flattened
multi-axis mesh, e.g. ('host', 'chip') — pass ``axis`` as a tuple):

  1. the wideband input is **time-sharded**; each device channelizes its
     time slice after an overlap-save halo exchange (one ppermute) —
     channelizer output: (M channels, F_local frames);
  2. one ``lax.all_to_all`` pivots the tick from time-sharded frames to
     **channel-sharded** streams: each device now holds the full tick for
     M/S channels;
  3. the per-channel demod chain runs locally.  Its streaming state
     (discriminator history, resampler tails, de-emphasis IIR) lives
     permanently on the channel's owning device — carried across ticks with
     no further communication, and IIR stages are exact (full time axis is
     local), unlike generic time sharding.

The reference's multi-channel story is N independent graphs on one GPU
(sdrtest.cpp:331-364); this is the same math at pod scale with two
collectives per tick.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpusdr.graph.blocks import Channelizer
from tpusdr.graph.chain import Chain
from tpusdr.ops import cplx
from tpusdr.utils.logging import get_logger
from tpusdr.utils.numerics import round_up

log = get_logger("parallel")


class ChannelShardedBank:
    """Channelizer + per-channel demod chain over a device mesh axis."""

    def __init__(
        self,
        channelizer: Channelizer,
        demod_chain: Chain,
        mesh: Mesh,
        axis: str | tuple[str, ...] = "dev",
    ):
        self.channelizer = channelizer
        self.chan_chain = Chain([("channelizer", channelizer)])
        self.demod_chain = demod_chain
        self.mesh = mesh
        # one or several mesh axes (('host', 'chip') on a 2-D host x device
        # mesh): collectives flatten the tuple into one ring, keeping the
        # all_to_all pivot mostly inside a host.
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        self.axis = axes if len(axes) > 1 else axes[0]
        self.shards = int(np.prod([mesh.shape[a] for a in axes]))
        self.m = channelizer.num_channels
        # channels that don't divide evenly are padded with dead channels;
        # the padding demodulates zeros and is dropped from the output.
        self.m_pad = round_up(self.m, self.shards)
        self.local_channels = self.m_pad // self.shards
        self.halo = round_up(max(self.chan_chain.history, 1), self.chan_chain.granule)
        self.skip = self.halo // self.m  # channelizer frames to drop
        self._step_cache: dict[int, Any] = {}
        log.info(
            "channel bank: %d channels (%d padded) / %d devices (%d local), halo %d",
            self.m,
            self.m_pad,
            self.shards,
            self.local_channels,
            self.halo,
        )

    def init_carry(self):
        return {
            "tail": cplx.zeros((self.halo,)),
            "demod_state": self.demod_chain.init_state((self.m_pad,)),
        }

    def _build_step(self, per_shard: int):
        axis, shards, halo, skip = self.axis, self.shards, self.halo, self.skip
        m, m_pad = self.m, self.m_pad
        chan_chain, demod_chain = self.chan_chain, self.demod_chain

        def fn(carry_tail, demod_state, x):
            idx = lax.axis_index(axis)
            my_tail = jax.tree_util.tree_map(
                lambda a: a[..., a.shape[-1] - halo :], x
            )
            perm = [(i, i + 1) for i in range(shards - 1)]
            left = jax.tree_util.tree_map(
                lambda a: lax.ppermute(a, axis, perm), my_tail
            )
            halo_in = jax.tree_util.tree_map(
                lambda u, v: jnp.where(idx == 0, u, v), carry_tail, left
            )
            ext = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=-1), halo_in, x
            )
            _, y_ext = chan_chain.apply(chan_chain.init_state(), ext)
            # y_ext: (M, skip + F_local); drop halo frames, pad dead channels
            y = jax.tree_util.tree_map(
                lambda a: jnp.pad(a[..., skip:], ((0, m_pad - m), (0, 0))), y_ext
            )
            # pivot: time-sharded frames -> channel-sharded full tick
            y_full = jax.tree_util.tree_map(
                lambda a: lax.all_to_all(
                    a, axis, split_axis=0, concat_axis=1, tiled=True
                ),
                y,
            )
            new_demod_state, audio = demod_chain.apply(demod_state, y_full)
            return new_demod_state, audio

        state_spec = jax.tree_util.tree_map(
            lambda l: P(axis) if np.ndim(l) >= 1 else P(),
            self.demod_chain.init_state((self.m_pad,)),
        )
        in_specs = (
            cplx.Complex(P(), P()),  # replicated halo tail
            state_spec,  # channel-sharded demod state
            cplx.Complex(P(axis), P(axis)),  # time-sharded wideband input
        )
        out_audio_spec = P(axis, None)
        out_specs = (
            state_spec,
            out_audio_spec,
        )
        fn_sm = jax.shard_map(
            fn,
            mesh=self.mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(fn_sm)

    def step(self, carry, x: cplx.Complex):
        """One tick: x is the global wideband input (pair, length divisible
        by shards * channelizer granule).  Returns (carry', audio) with
        audio shaped (num_channels, n_audio) sharded over channels (dead
        padding channels already dropped)."""
        n = x.shape[-1]
        gran = self.shards * self.chan_chain.granule
        if n % gran:
            raise ValueError(f"tick {n} must be divisible by {gran}")
        per_shard = n // self.shards
        if per_shard < self.halo:
            raise ValueError(f"per-shard {per_shard} < halo {self.halo}")
        if per_shard not in self._step_cache:
            self._step_cache[per_shard] = self._build_step(per_shard)
        new_demod_state, audio = self._step_cache[per_shard](
            carry["tail"], carry["demod_state"], x
        )
        new_carry = {
            "tail": jax.tree_util.tree_map(
                lambda a: a[..., a.shape[-1] - self.halo :], x
            ),
            "demod_state": new_demod_state,
        }
        if self.m_pad != self.m:
            audio = jax.tree_util.tree_map(lambda a: a[: self.m], audio)
        return new_carry, audio

    def input_sharding(self):
        return NamedSharding(self.mesh, P(self.axis))
