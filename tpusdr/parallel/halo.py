"""Time-block sharding with overlap-save halo exchange.

The core multi-chip mechanism (BASELINE.md config 5; SURVEY.md section 5
"long-context analog"): a streaming tick of N input samples is split into S
contiguous shards on a mesh axis.  Each shard needs the last H input samples
of its left neighbor to continue every filter in the chain — H is the
chain's total input-rate lookback (sum of each stage's taps-1/demod history,
Chain.history), rounded up to the chain granule so every stage's decimation
grid stays aligned with the unsharded run.

Per tick, inside shard_map:

  1. each shard sends its tail H samples right via ``lax.ppermute``
     (one neighbor hop; shard 0 instead uses the cross-tick carry tail);
  2. the chain runs cold on [halo, shard] — the halo *warms up* every
     finite-memory carry to exactly its streaming value (the overlap-save
     trick: the reference's retained FIR tail, Fir.cpp:274-308, re-created
     from neighbor data instead of carried between calls);
  3. closed-form states (NCO phases) are set exactly via
     ``Chain.shift_state`` with the shard's absolute sample offset — uint32
     modular arithmetic, so the oscillator is bit-identical to the
     unsharded run;
  4. the first H*up/down outputs (the halo's outputs) are discarded.

Sequential-only stages (IIR de-emphasis — unbounded memory) are split off
with ``Chain.split_shardable`` and run on the gathered, decimated output
where they cost nothing.

Sharded output == unsharded output **bit-exactly** (asserted in
tests/test_parallel.py), because every output sample is computed from the
same window by the same reduction order.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpusdr.graph.chain import Chain
from tpusdr.ops import cplx
from tpusdr.utils.logging import get_logger
from tpusdr.utils.numerics import round_up

log = get_logger("parallel")


def _concat(a, b):
    if cplx.is_pair(b):
        return cplx.concat([cplx.ensure_pair(a), b], axis=-1)
    return jnp.concatenate([a, b], axis=-1)


def _tail(x, h):
    return x[..., x.shape[-1] - h :]


def _select(pred, a, b):
    return jax.tree_util.tree_map(lambda u, v: jnp.where(pred, u, v), a, b)


class TimeShardedStream:
    """Run a Chain or (single-input, single-output) Graph with its
    streaming tick sharded across a mesh axis."""

    def __init__(
        self,
        chain,
        mesh: Mesh,
        axis: str | tuple[str, ...] = "dev",
        halo: int | None = None,
        stagewise: bool | str = "auto",
    ):
        """``stagewise``: exchange a separate halo per STAGE, each at that
        stage's own input rate, instead of one chain-wide halo at the
        input rate.  The default 'auto' uses stagewise for Chains and the
        chain-wide form
        for Graphs (no linear stage list to plan over).  A stage's lookback costs its own rate, not the
        input rate: the WBFM de-emphasis warmup is ~500 quad-rate samples,
        which the chain-wide halo inflates by the full RF decimation into
        ~50k input samples of redundant front-end compute per shard per
        tick.  At the 100 MHz design point the chain-wide halo is ~206k
        input samples — at 256 shards of a 1 s tick that is 53% redundant
        compute, vs ~1% stagewise (halo lengths, by arithmetic).  Costs
        one extra ppermute per stateful stage (tiny, latency-bound).
        Requires a Chain (stage list); Graphs use the chain-wide halo."""
        self.full_chain = chain
        self.chain, self.tail_chain = chain.split_shardable()
        if isinstance(self.chain, Chain) and not self.chain.blocks:
            raise ValueError("chain has no time-shardable prefix")
        if stagewise == "auto":
            stagewise = isinstance(self.chain, Chain)
        self.stagewise = bool(stagewise)
        if self.stagewise and not isinstance(self.chain, Chain):
            raise ValueError("stagewise halos need a Chain (per-stage plan)")
        self.mesh = mesh
        # one or several mesh axes (e.g. ('host', 'chip') on a 2-D
        # host x device mesh); collectives treat the tuple as one flattened
        # ring, so the halo ppermute crosses hosts only at host boundaries.
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        self.axis = axes if len(axes) > 1 else axes[0]
        self.shards = int(np.prod([mesh.shape[a] for a in axes]))
        h = halo if halo is not None else self.chain.history
        self.halo = round_up(max(h, 1), self.chain.granule)
        # outputs to drop per shard (the halo's outputs)
        self.skip = self.halo * self.chain.up // self.chain.down
        if self.stagewise:
            # (name, block, h_pad, skip, batch_shape): h_pad is the stage's
            # warmup halo in ITS OWN input samples, rounded to the stage
            # granule so the dropped output count h_pad*up/down is exact.
            self._stages = []
            bshape: tuple[int, ...] = ()
            for name, b in self.chain.blocks:
                g = max(b.granule, 1)
                h_pad = round_up(b.history, g) if b.history > 0 else 0
                self._stages.append(
                    (name, b, h_pad, h_pad * b.up // b.down, bshape)
                )
                if b.adds_channel_axis:
                    bshape = bshape + (b.num_channels,)
        # tick must clear (a) shards * shardable-head granule for the halo
        # alignment and (b) the FULL chain's granule (the sequential tail —
        # e.g. an audio resampler — has its own divisibility needs).
        from tpusdr.utils.numerics import lcm

        self.tick_granule = lcm(self.shards * self.chain.granule, chain.granule)
        self._step_cache: dict[int, Any] = {}
        log.info(
            "time sharding: %d shards on '%s', halo %d samples, skip %d",
            self.shards,
            axis,
            self.halo,
            self.skip,
        )

    # -- carries ------------------------------------------------------------

    def init_carry(self):
        carry = {
            "state": self.chain.init_state(),
            "tail": self._zero_tails() if self.stagewise else self._zero_tail(),
        }
        if self.tail_chain is not None:
            carry["tail_state"] = self.tail_chain.init_state(
                (self.chain.num_channels,) if self.chain.adds_channel_axis else ()
            )
        return carry

    def _zero_tail(self):
        if self.chain.in_dtype == jnp.complex64:
            return cplx.zeros((self.halo,))
        return jnp.zeros((self.halo,), dtype=self.chain.in_dtype)

    def _zero_tails(self):
        """Per-stage zero halos: each stage's tail in its own input
        dtype/rate, with any channel axis added by upstream stages."""
        tails = {}
        for name, b, h_pad, _skip, bshape in self._stages:
            if h_pad == 0:
                continue
            shape = bshape + (h_pad,)
            if b.in_dtype == jnp.complex64:
                tails[name] = cplx.zeros(shape)
            else:
                tails[name] = jnp.zeros(shape, dtype=b.in_dtype)
        return tails

    # -- the sharded step ---------------------------------------------------

    def _build_step(self, per_shard: int):
        chain = self.chain
        halo, skip, axis, shards = self.halo, self.skip, self.axis, self.shards

        def sharded_fn(carry_tail, state, x):
            # runs per-shard under shard_map
            idx = lax.axis_index(axis)
            my_tail = jax.tree_util.tree_map(lambda a: _tail(a, halo), x)
            perm = [(i, i + 1) for i in range(shards - 1)]
            left_tail = jax.tree_util.tree_map(
                lambda a: lax.ppermute(a, axis, perm), my_tail
            )
            halo_in = _select(idx == 0, carry_tail, left_tail)
            ext = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=-1), halo_in, x
            )
            offset = idx.astype(jnp.int32) * per_shard - halo
            local_state = chain.shift_state(state, offset)
            _, y_ext = chain.apply(local_state, ext)
            y = jax.tree_util.tree_map(lambda a: a[..., skip:], y_ext)
            return y

        in_specs = (
            jax.tree_util.tree_map(lambda _: P(), self._zero_tail()),
            jax.tree_util.tree_map(lambda _: P(), self.chain.init_state()),
            jax.tree_util.tree_map(lambda _: P(axis), self._example_x(per_shard)),
        )
        # output: time axis is the last; channelizer inserts a leading
        # channel axis which stays unsharded here.
        ndim_out = 2 if self.chain.adds_channel_axis else 1
        out_spec = P(*([None] * (ndim_out - 1) + [axis]))
        out_specs = jax.tree_util.tree_map(
            lambda _: out_spec, self._example_y(per_shard)
        )

        fn = jax.shard_map(
            sharded_fn,
            mesh=self.mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(fn)

    def _build_step_stagewise(self, per_shard: int):
        """Per-stage-rate halos: each stateful stage ppermutes its OWN
        input tail (at that stage's rate) right, warms up cold, and drops
        the halo's outputs — the chain-wide overlap-save trick applied at
        every rate boundary, so a decimated stage's lookback is never
        re-computed through the full-rate front end."""
        chain = self.chain
        axis, shards = self.axis, self.shards
        stages = self._stages
        # static per-stage per-shard input lengths
        n_k = [per_shard]
        for _, b, _, _, _ in stages[:-1]:
            n_k.append(b.out_len(n_k[-1]))
        for (name, b, h_pad, _s, _bs), n in zip(stages, n_k):
            if h_pad > n:
                raise ValueError(
                    f"stage {name!r}: per-shard input {n} smaller than its "
                    f"halo {h_pad}; use a longer tick or fewer shards"
                )

        def sharded_fn(carry_tails, state, x):
            idx = lax.axis_index(axis)
            perm = [(i, i + 1) for i in range(shards - 1)]
            cur = x
            my_tails = {}
            for (name, b, h_pad, skip, _bs), n in zip(stages, n_k):
                offset = idx.astype(jnp.int32) * n - h_pad
                local_state = b.shift_state(state[name], offset)
                if h_pad == 0:
                    _, cur = b.apply(local_state, cur)
                    continue
                my_tail = jax.tree_util.tree_map(lambda a: _tail(a, h_pad), cur)
                left = jax.tree_util.tree_map(
                    lambda a: lax.ppermute(a, axis, perm), my_tail
                )
                halo_in = _select(idx == 0, carry_tails[name], left)
                ext = jax.tree_util.tree_map(
                    lambda a, c: jnp.concatenate([a, c], axis=-1), halo_in, cur
                )
                _, y_ext = b.apply(local_state, ext)
                cur = jax.tree_util.tree_map(lambda a: a[..., skip:], y_ext)
                my_tails[name] = my_tail
            return cur, my_tails

        tails0 = self._zero_tails()
        in_specs = (
            jax.tree_util.tree_map(lambda _: P(), tails0),
            jax.tree_util.tree_map(lambda _: P(), self.chain.init_state()),
            jax.tree_util.tree_map(lambda _: P(axis), self._example_x(per_shard)),
        )

        def last_axis_spec(leaf):
            return P(*([None] * (leaf.ndim - 1) + [axis]))

        ndim_out = 2 if self.chain.adds_channel_axis else 1
        out_spec_y = P(*([None] * (ndim_out - 1) + [axis]))
        out_specs = (
            jax.tree_util.tree_map(lambda _: out_spec_y, self._example_y(per_shard)),
            jax.tree_util.tree_map(last_axis_spec, tails0),
        )

        fn = jax.shard_map(
            sharded_fn,
            mesh=self.mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(fn)

    def _example_x(self, per_shard: int):
        n = per_shard * self.shards
        if self.chain.in_dtype == jnp.complex64:
            return cplx.zeros((n,))
        return jnp.zeros((n,), self.chain.in_dtype)

    def _example_y(self, per_shard: int):
        out = self.chain.out_len(per_shard) * self.shards
        shape = (
            (self.chain.num_channels, out) if self.chain.adds_channel_axis else (out,)
        )
        if self.chain.out_dtype == jnp.complex64:
            return cplx.zeros(shape)
        return jnp.zeros(shape, self.chain.out_dtype)

    # -- public api ---------------------------------------------------------

    def step(self, carry, x):
        """One sharded streaming tick.

        ``x``: the tick's input (pair or float array, last axis = time),
        globally shaped; shard it with ``self.input_sharding`` for real
        multi-device placement.  Returns (carry', y) with y gathered
        semantics (a sharded global array).
        """
        n = x.shape[-1]
        if n % self.tick_granule:
            raise ValueError(
                f"tick {n} must be divisible by tick_granule = "
                f"{self.tick_granule}"
            )
        per_shard = n // self.shards
        if per_shard < self.halo:
            raise ValueError(
                f"per-shard length {per_shard} smaller than halo {self.halo}"
            )
        if per_shard not in self._step_cache:
            self._step_cache[per_shard] = (
                self._build_step_stagewise(per_shard)
                if self.stagewise
                else self._build_step(per_shard)
            )
        new_carry = dict(carry)
        if self.stagewise:
            y, tails = self._step_cache[per_shard](
                carry["tail"], carry["state"], x
            )
            # next tick's shard-0 halo per stage = the end of this tick's
            # global stage stream = the LAST shard's stage-input tail
            new_carry["tail"] = {
                name: jax.tree_util.tree_map(
                    lambda a, h=h_pad: _tail(a, h), tails[name]
                )
                for name, _b, h_pad, _s, _bs in self._stages
                if h_pad > 0
            }
        else:
            y = self._step_cache[per_shard](carry["tail"], carry["state"], x)
            new_carry["tail"] = jax.tree_util.tree_map(
                lambda a: _tail(a, self.halo), x
            )
        new_carry["state"] = self.chain.advance_state(carry["state"], n)

        if self.tail_chain is not None:
            new_carry["tail_state"], y = self.tail_chain.apply(
                carry["tail_state"], y
            )
        return new_carry, y

    def input_sharding(self):
        spec = P(self.axis)
        return NamedSharding(self.mesh, spec)
