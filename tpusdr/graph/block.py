"""The Block protocol: a pure streaming operator.

This is the framework's answer to the reference's 6-method Node protocol
(reference include/gpusdrpipeline/filters/Filter.h:30-138:
requestBuffer/commitBuffer/getOutputDataSize/readOutput/...).  The
request/commit buffer negotiation exists because CUDA filters mutate shared
device buffers; with pure functions and static shapes the whole contract
reduces to:

  * ``apply(state, *xs) -> (state', y)``  — one streaming step, jit-safe
  * rational rate ratio ``(up, down)``     — out_len = in_len * up / down
  * ``history``                            — input-rate lookback samples
                                             (the FIR taps-1 retention of
                                             Fir.cpp:274-308, lifted into an
                                             explicit carry and reusable as a
                                             shard-boundary halo)
  * ``init_state(batch_shape)``            — the carry pytree

Blocks are stateless Python objects holding static config plus tap arrays;
all mutable stream state lives in the carry pytree, which makes
checkpoint/resume and sharding trivial (SURVEY.md section 5).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import jax.numpy as jnp

Pytree = Any


class Block:
    """Base streaming operator. Subclasses set rate/dtype attributes."""

    #: number of stream inputs (0 for sources, 2 for Multiply, ...)
    n_inputs: int = 1
    #: rational rate ratio in lowest terms: out_len = in_len * up // down
    up: int = 1
    down: int = 1
    #: input-rate samples of lookback required to continue a stream
    history: int = 0
    #: output adds a leading channel axis (polyphase channelizer)
    adds_channel_axis: bool = False
    num_channels: int = 1

    in_dtype = jnp.complex64
    out_dtype = jnp.complex64

    #: False for blocks with unbounded memory (IIR) that a finite halo
    #: cannot re-create — they must run on the unsharded tail of a chain
    time_shardable: bool = True

    def init_state(self, batch_shape: Sequence[int] = ()) -> Pytree:
        return ()

    def apply(self, state: Pytree, *xs: jnp.ndarray) -> tuple[Pytree, jnp.ndarray]:
        raise NotImplementedError

    # -- time-sharding hooks (parallel/halo.py) -----------------------------
    #
    # Most carries are "the last L input samples" and are re-created by the
    # overlap-save halo warmup, so shifting is a no-op.  Closed-form state
    # (NCO phase) overrides these with exact modular arithmetic.

    def shift_state(self, state: Pytree, offset_samples) -> Pytree:
        """State as it would be ``offset_samples`` (traced int32, may be
        negative) later in the stream, for states with closed-form time
        dependence. Default: unchanged (halo warmup re-creates it)."""
        return state

    def advance_state(self, state: Pytree, num_samples: int) -> Pytree:
        """Host-side exact advance of closed-form state by a static sample
        count (used for the cross-tick carry under sharding)."""
        return state

    def update_parameters(self, **params) -> None:
        """Runtime parameter update (the reference's Node::updateParameters
        JSON hook, Filter.h:36).  Sets matching attributes, then lets the
        block recompute anything derived (``_params_updated``).  The next
        *fresh trace* of apply() sees the new values — params are
        compile-time constants by design, so a jitted step function
        built before the update keeps the old ones (StreamRunner.refresh()
        rebuilds its step for exactly this reason)."""
        for k, v in params.items():
            if not hasattr(self, k):
                raise AttributeError(
                    f"{self.__class__.__name__} has no parameter {k!r}"
                )
            setattr(self, k, v)
        self._params_updated(frozenset(params))

    def _params_updated(self, names: frozenset) -> None:
        """Hook: recompute attributes derived from updated parameters
        (NCO increments, IIR coefficients, tap arrays...)."""

    def update_parameters_json(self, payload) -> None:
        """updateParameters(json) parity (Filter.h:36): accept a JSON
        string or dict in the reference's camelCase schema and apply it —
        the runtime counterpart of build_graph's key translation, so a
        JSON-spec-driven app retunes nodes with the vocabulary it built
        them with."""
        import json as _json

        from tpusdr.graph.graph import translate_params

        if isinstance(payload, str):
            payload = _json.loads(payload)
        self.update_parameters(**translate_params(payload))

    # -- static rate arithmetic (replaces SteppingDriver's runtime
    #    min(preferred, available) negotiation, SteppingDriver.cpp:279-287) --

    def out_len(self, in_len: int) -> int:
        if (in_len * self.up) % self.down != 0:
            raise ValueError(
                f"{self.__class__.__name__}: input length {in_len} is not "
                f"compatible with rate {self.up}/{self.down}"
            )
        return in_len * self.up // self.down

    @property
    def granule(self) -> int:
        """Smallest input length quantum this block accepts."""
        return self.down // math.gcd(self.up, self.down)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"{self.__class__.__name__}(up={self.up}, down={self.down}, "
            f"history={self.history})"
        )


class SourceBlock(Block):
    """A stream source: produces ``n`` samples per step (n is static).

    The analog of the reference's infinite sources
    (CosineSource::getOutputDataSize returning SIZE_MAX,
    CosineSource.cpp:56-60): the planner asks a source for exactly the
    length its consumers need.
    """

    n_inputs = 0

    def generate(self, state: Pytree, n: int) -> tuple[Pytree, jnp.ndarray]:
        raise NotImplementedError

    def apply(self, state, *xs):
        raise TypeError("SourceBlock produces via generate(state, n)")
