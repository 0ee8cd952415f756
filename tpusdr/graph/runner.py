"""StreamRunner — the host-side streaming driver.

Replaces the reference's application run loop + SteppingDriver::doFilter
pull pass (/root/reference/src/applications/nbfm_test.cpp:568-580,
SteppingDriver.cpp:193-245) and the Waiter event ping-pong that pipelines
GPU compute against the CPU consumer (src/filters/Waiter.cpp:34-50):

  * one jitted step per streaming tick, state donated (XLA reuses the
    carry buffers in place — the RelocatableResizableBuffer role);
  * JAX's async dispatch queue plays the CUDA stream: the host enqueues
    device_put + step for tick i+1 while tick i still computes, and only
    blocks when fetching tick i-depth's output for the sink (the Waiter
    ping-pong, depth-N instead of depth-1);
  * an upload thread overlaps the H2D transfer of block i+1 with the
    device compute (and output fetch) of block i — the producer/consumer
    split the reference gets from its USB callback thread + BufferPool
    (HackrfSource.cpp:175-201), applied to the host->device boundary,
    which on upload-bound links (a PCIe host at 100 MHz rates) is the
    pacing resource;
  * samples-in/out counters + wall-clock throughput (the observability the
    reference lacks, SURVEY.md section 5).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np

import jax

from tpusdr.graph.block import Block
from tpusdr.ops import cplx
from tpusdr.utils.logging import get_logger

log = get_logger("runner")


@dataclass
class RunStats:
    blocks: int = 0
    samples_in: int = 0
    samples_out: int = 0
    wall_seconds: float = 0.0
    dropped: int = 0
    #: per-output-port sample counts for multi-output graphs (the reference's
    #: per-port ReadByteCountMonitor role, ReadByteCountMonitor.cpp:44-63);
    #: samples_out stays the first port's count (the run-loop termination
    #: metric, nbfm_test.cpp:571).
    samples_out_ports: list = field(default_factory=list)

    @property
    def msps_in(self) -> float:
        return self.samples_in / max(self.wall_seconds, 1e-12) / 1e6

    @property
    def msps_out(self) -> float:
        return self.samples_out / max(self.wall_seconds, 1e-12) / 1e6


def _to_host(y: Any) -> np.ndarray:
    if cplx.is_pair(y):
        return cplx.to_numpy(y)
    return np.asarray(y)


class StreamRunner:
    """Drive a single-input Block (Chain/Graph) from a host source into a
    host sink."""

    def __init__(
        self,
        block: Block,
        donate_state: bool = True,
        pipeline_depth: int = 2,
        device=None,
        queue=None,
        upload_depth: int = 2,
    ):
        """``queue``: a CommandQueue or registered queue name (graph/queues
        .py — the reference's named ICudaCommandQueue surface); it selects
        the device when ``device`` is not given explicitly.

        ``upload_depth``: how many ticks an upload thread may stage on the
        device ahead of compute (0 disables the thread and uploads
        inline).  Staging overlaps H2D of tick i+1 with compute/fetch of
        tick i; the cap bounds device memory for in-flight inputs."""
        self.block = block
        if queue is not None and device is None:
            from tpusdr.graph.queues import get_queue_registry

            if isinstance(queue, str):
                queue = get_queue_registry().get(queue)
            device = queue.device
        self.queue = queue
        self.device = device
        self.pipeline_depth = pipeline_depth
        self.upload_depth = upload_depth

        self._donate = donate_state
        self._build_step()

    def _build_step(self) -> None:
        block = self.block

        def step(state, x):
            return block.apply(state, x)

        self._step = jax.jit(step, donate_argnums=(0,) if self._donate else ())

    def refresh(self) -> None:
        """Rebuild the jitted step after block.update_parameters: jit caches
        on the function object, not on closed-over block attributes, so a
        parameter change is invisible to the old step.  One recompile on the
        next tick (the reference pays a node-local reconfigure instead,
        Filter.h:36)."""
        self._build_step()

    def update_parameters(self, block_name: str | None = None, **params) -> None:
        """updateParameters + re-jit in one call. With ``block_name``,
        targets a member of a Chain/Graph; otherwise the block itself."""
        if block_name is None:
            self.block.update_parameters(**params)
        else:
            self.block.update_block_parameters(block_name, **params)
        self.refresh()

    def update_parameters_json(self, block_name: str | None, payload) -> None:
        """updateParameters(json) + re-jit: ``payload`` is a JSON string or
        dict in the reference's camelCase schema (Filter.h:36); with
        ``block_name`` it targets a member of a Chain/Graph."""
        if block_name is None:
            self.block.update_parameters_json(payload)
        else:
            self.block.update_block_parameters_json(block_name, payload)
        self.refresh()

    def init_state(self):
        return self.block.init_state()

    def run(
        self,
        source: Iterable[np.ndarray],
        sink,
        state=None,
        max_blocks: int | None = None,
        postprocess: Callable[[np.ndarray], np.ndarray] | None = None,
    ) -> tuple[Any, RunStats]:
        """Stream source -> block -> sink(s). Returns (final_state, stats).

        For a multi-output Graph (tuple-valued ``block.apply``), pass a
        sequence of sinks, one per output port — the reference drives
        multiple sinks per source port with fan-out copies
        (SteppingDriver.cpp:309-362); here each sink just reads its port of
        the tuple.  ``postprocess`` may likewise be a sequence (per port) or
        a single callable applied to every port.
        """
        if state is None:
            state = self.init_state()
        sinks = list(sink) if isinstance(sink, (list, tuple)) else [sink]
        n_ports = len(sinks)
        posts = (
            list(postprocess)
            if isinstance(postprocess, (list, tuple))
            else [postprocess] * n_ports
        )
        if len(posts) != n_ports:
            raise ValueError(f"{len(posts)} postprocessors for {n_ports} sinks")
        stats = RunStats(samples_out_ports=[0] * n_ports)
        pending: deque = deque()

        def drain(y) -> None:
            # a Complex pair is ONE stream (NamedTuple -> tuple instance)
            ys = y if isinstance(y, tuple) and not cplx.is_pair(y) else (y,)
            if len(ys) != n_ports:
                raise ValueError(
                    f"block produced {len(ys)} outputs but {n_ports} sinks given"
                )
            for port, (yp, snk, post) in enumerate(zip(ys, sinks, posts)):
                out = _to_host(yp)
                if post is not None:
                    out = post(out)
                snk.write(out)
                stats.samples_out_ports[port] += out.shape[-1]

        t0 = time.perf_counter()

        def upload(raw):
            if cplx.is_pair(raw):
                # host-side pair (native deinterleave path): upload planes
                return cplx.Complex(
                    jax.device_put(raw.re, self.device),
                    jax.device_put(raw.im, self.device),
                )
            if np.iscomplexobj(raw):
                # The device path is pair-native (ops/cplx.py): split on
                # the host, upload two float planes.
                return cplx.Complex(
                    jax.device_put(np.ascontiguousarray(raw.real), self.device),
                    jax.device_put(np.ascontiguousarray(raw.imag), self.device),
                )
            return jax.device_put(raw, self.device)

        def bounded():
            # check the budget BEFORE pulling: the last pull must not
            # consume (and discard) an extra block from a shared source
            if max_blocks is not None and max_blocks <= 0:
                return
            for i, raw in enumerate(source):
                yield raw
                if max_blocks is not None and i + 1 >= max_blocks:
                    return

        stop = threading.Event()
        if self.upload_depth > 0:
            # Upload thread: read + device_put the NEXT blocks while the
            # main thread runs compute and output fetch on the current one.
            # The queue holds device arrays, so a put that has completed
            # means the transfer is at least enqueued with the runtime;
            # depth bounds in-flight device memory.
            uq: _queue.Queue = _queue.Queue(maxsize=self.upload_depth)
            _END = object()

            def put(item) -> bool:
                # bounded put that gives up when the consumer abandoned
                # the run (sink/step failure) — never leaves the thread
                # blocked holding device buffers
                while not stop.is_set():
                    try:
                        uq.put(item, timeout=0.1)
                        return True
                    except _queue.Full:
                        continue
                return False

            def feeder():
                try:
                    for raw in bounded():
                        if not put((raw.shape[-1], upload(raw))):
                            return
                except BaseException as e:  # propagate into the main loop
                    put((_END, e))
                    return
                put((_END, None))

            th = threading.Thread(target=feeder, daemon=True)
            th.start()

            def staged():
                while True:
                    n, item = uq.get()
                    if n is _END:
                        if item is not None:
                            raise item
                        return
                    yield n, item

            blocks = staged()
        else:
            blocks = ((raw.shape[-1], upload(raw)) for raw in bounded())

        try:
            for n_in, x in blocks:
                state, y = self._step(state, x)
                stats.blocks += 1
                stats.samples_in += n_in
                pending.append(y)
                if len(pending) > self.pipeline_depth:
                    drain(pending.popleft())

            while pending:
                drain(pending.popleft())
        finally:
            stop.set()

        stats.samples_out = stats.samples_out_ports[0]
        stats.wall_seconds = time.perf_counter() - t0
        log.info(
            "stream done: %d blocks, %.2f Msps in, %.2f Msps out",
            stats.blocks,
            stats.msps_in,
            stats.msps_out,
        )
        return state, stats


def run_offline(block: Block, x_blocks, state=None, mode: str = "auto"):
    """Offline block processing of stacked ticks — the maximum-throughput
    path for recorded captures (one device dispatch for the whole capture).

    ``mode``:
      * 'flat' — apply the block ONCE to the flattened capture; the
        decimated tail stages amortize their fixed costs over the full
        capture.  Output is the flat stream (..., total*up/down).
      * 'scan' — lax.scan over the tick axis (the per-tick streaming
        step); output keeps the (K, out) tick axis.
      * 'auto' — 'flat' when the flattened length satisfies the block's
        granule, else 'scan'.  Chunking invariance (tests/
        test_graph_chain.py) makes the sample streams identical.
    """
    import jax.numpy as jnp  # noqa: F401
    from jax import lax

    from tpusdr.ops import cplx as _cplx

    if state is None:
        state = block.init_state()

    def flatten(a):
        return a.reshape((-1,) + a.shape[2:]) if a.ndim >= 2 else a

    if mode == "auto":
        total = x_blocks.shape[0] * x_blocks.shape[1]
        mode = "flat" if total % block.granule == 0 else "scan"
    if mode == "flat":
        flat = jax.tree_util.tree_map(flatten, x_blocks)
        return block.apply(state, flat)

    def step(carry, x):
        new_carry, y = block.apply(carry, x)
        return new_carry, y

    return lax.scan(step, state, x_blocks)
