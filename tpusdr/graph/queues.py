"""Named execution queues — the CommandQueueFactory role.

The reference routes every kernel launch through an ``ICudaCommandQueue``
(a CUDA device + stream) and keeps a process-wide name -> queue registry
built from JSON (/root/reference/src/commandqueue/CommandQueueFactory.cpp:
35-77, ICudaCommandQueue.h:23-29).  Two things that registry buys:

  1. *placement*: JSON pins a pipeline to a device
     (``{"queueType": "cuda", "cudaDevice": 0}``);
  2. *concurrency with ordering*: pipelines sharing a queue serialize;
     pipelines on different queues overlap on one GPU
     (the sdrtest.cpp:331-364 N-independent-graphs pattern).

XLA has no user-visible streams — per device there is one compute stream
and data dependence orders everything — so a literal stream port would be
dead weight.  What this module keeps is queue *identity*, realized the
compiler-native way:

  * ``CommandQueue``: a name resolved to a ``jax.Device``.  The reference
    JSON spelling is accepted (``cudaDevice`` = device ordinal); the native
    spelling is ``{"queueType": "gpu", "device": N}``.
  * ``QueueRegistry``: the process-wide name -> queue map
    (CommandQueueFactory.cpp:35-77 semantics: create-or-validate on
    repeated create, error on spec mismatch).
  * ``MergedRunner``: N *independent* pipelines assigned to one queue are
    merged into ONE jitted step — XLA schedules their disjoint subgraphs
    inside a single dispatch, with one compile + one host round-trip per
    tick for the whole fleet.

Pipelines on *different* queues simply dispatch to their own devices;
JAX's async dispatch overlaps them for free.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Mapping

import jax

from tpusdr.graph.block import Block
from tpusdr.utils.logging import get_logger

log = get_logger("queues")


@dataclass(frozen=True)
class CommandQueue:
    """A named execution context: a device plus merge identity.

    Role parity: ICudaCommandQueue (device + stream); the "stream" half is
    XLA's per-device ordering, so only the device and the name survive.
    """

    name: str
    device: Any  # jax.Device

    @property
    def platform(self) -> str:
        return self.device.platform


#: queueType spellings accepted in a queue spec: the reference's "cuda"
#: (CommandQueueFactory.cpp:49-66), plus the platforms this build runs on.
_KNOWN_QUEUE_TYPES = frozenset({"cuda", "gpu", "cpu"})


def _resolve_device(spec: Mapping[str, Any]):
    """Map a queue spec to a jax.Device.

    Accepts the reference spelling {"queueType": "cuda", "cudaDevice": N}
    (CommandQueueFactory.cpp:49-66: type string + device ordinal) and the
    native {"queueType": "gpu", "device": N}.  An unknown queueType or an
    ordinal outside ``jax.devices()`` raises (the reference returns
    Status_NotFound, CommandQueueFactory.cpp:72-75) rather than silently
    pinning the pipeline to device 0.
    """
    qtype = spec.get("queueType", spec.get("queue_type"))
    if qtype is not None and str(qtype).lower() not in _KNOWN_QUEUE_TYPES:
        raise ValueError(
            f"unknown queueType {qtype!r} "
            f"(accepted: {sorted(_KNOWN_QUEUE_TYPES)})"
        )
    idx = spec.get("device", spec.get("cudaDevice", spec.get("cuda_device", 0)))
    idx = int(idx)
    devices = jax.devices()
    if not 0 <= idx < len(devices):
        raise ValueError(
            f"queue spec device {idx} out of range ({len(devices)} devices)"
        )
    return devices[idx]


class QueueRegistry:
    """Process-wide name -> CommandQueue map (CommandQueueFactory parity).

    ``create`` is create-or-validate: re-creating an existing name with a
    spec that resolves to the same device returns the existing queue;
    a conflicting spec raises (the reference errors on duplicate ids,
    CommandQueueFactory.cpp:41-47).
    """

    def __init__(self) -> None:
        self._queues: dict[str, CommandQueue] = {}
        self._lock = threading.Lock()

    def create(self, name: str, spec: Mapping[str, Any] | None = None) -> CommandQueue:
        device = _resolve_device(spec or {})
        with self._lock:
            existing = self._queues.get(name)
            if existing is not None:
                if existing.device != device:
                    raise ValueError(
                        f"queue {name!r} already exists on {existing.device} "
                        f"(spec resolves to {device})"
                    )
                return existing
            q = CommandQueue(name, device)
            self._queues[name] = q
            log.info("queue %r -> %s", name, device)
            return q

    def get(self, name: str) -> CommandQueue:
        with self._lock:
            try:
                return self._queues[name]
            except KeyError:
                raise KeyError(
                    f"unknown command queue {name!r} "
                    f"(known: {sorted(self._queues)})"
                ) from None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._queues)


_registry = QueueRegistry()


def get_queue_registry() -> QueueRegistry:
    """The process singleton (getFactoriesSingleton role for queues,
    Factories.cpp:194-204)."""
    return _registry


class MergedRunner:
    """Step N independent single-input pipelines as ONE jitted dispatch.

    This build's answer to N pipelines sharing a device via separate CUDA
    streams (sdrtest.cpp:331-364: per-channel FM graphs on one GPU): merge
    their steps into a single XLA program.  The subgraphs share no data, so
    the scheduler interleaves them freely and the states stay independently
    checkpointable.  The fleet pays one compile and one dispatch per tick
    instead of N; what that saves on the GPU is not measured yet.

    ``blocks``: name -> Block (Chain/Graph, single stream input).
    ``step`` takes/returns dicts keyed the same way.
    """

    def __init__(
        self,
        blocks: Mapping[str, Block],
        queue: CommandQueue | str | None = None,
        donate_state: bool = True,
    ):
        if not blocks:
            raise ValueError("MergedRunner needs at least one block")
        self.blocks = dict(blocks)
        if isinstance(queue, str):
            queue = get_queue_registry().get(queue)
        self.queue = queue
        self.device = queue.device if queue is not None else None

        def step(states: dict, xs: dict):
            new_states, ys = {}, {}
            for name, blk in self.blocks.items():
                new_states[name], ys[name] = blk.apply(states[name], xs[name])
            return new_states, ys

        self._step = jax.jit(step, donate_argnums=(0,) if donate_state else ())

    def init_state(self) -> dict:
        states = {name: blk.init_state() for name, blk in self.blocks.items()}
        if self.device is not None:
            states = jax.device_put(states, self.device)
        return states

    def step(self, states: dict, xs: dict) -> tuple[dict, dict]:
        """One merged tick. ``xs``: name -> input block (host or device).

        When the runner was bound to a queue, inputs are device_put onto the
        queue's device (a no-op for arrays already committed there), so the
        queue routing is real on multi-device hosts — mirroring
        StreamRunner.run's placement of its uploads.
        """
        if self.device is not None:
            xs = jax.device_put(xs, self.device)
        return self._step(states, xs)
