"""Multi-host sharded IQ ingest.

SURVEY.md section 7 hard part (d): on a multi-host pod there is no shared
file system / single reader — every host must load exactly its shard of
each global streaming tick, and all hosts must agree on block indices.

The scheme: the global tick index is the single source of truth.  Host h of
H hosts, holding local devices for mesh rows [h*D, (h+1)*D), reads byte
range ``tick_index * tick_bytes + local_shard_offset`` from its copy (or
its segment) of the capture, and the per-host arrays are assembled into one
global jax array with ``jax.make_array_from_process_local_data`` — no cross-host
traffic beyond what XLA needs for the compute itself.

Single-process meshes (one host, CPU virtual meshes) take the same code
path with H=1, so the logic is testable without a cluster.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpusdr.ops import cplx
from tpusdr.utils.logging import get_logger

log = get_logger("parallel.ingest")

_DTYPES = {"int8": np.int8, "int16": np.int16, "cf32": np.complex64}


class ShardedFileIngest:
    """Per-host reader of a (replicated or pre-split) IQ capture that
    yields globally-sharded device arrays, tick by tick.

    Args:
      path: the capture file visible to this host. Either the full capture
        (replicated) or this host's contiguous segment (pre-split with
        ``segment_of_host=True``).
      mesh / axis: the device mesh and the time-sharding axis.
      tick_samples: complex samples per global tick (divisible by shards).
      input_format: 'int8' | 'int16' | 'cf32'.
    """

    def __init__(
        self,
        path: str,
        mesh: Mesh,
        tick_samples: int,
        axis: str = "dev",
        input_format: str = "cf32",
        segment_of_host: bool = False,
    ):
        self.mesh = mesh
        self.axis = axis
        self.shards = int(mesh.shape[axis])
        if tick_samples % self.shards:
            raise ValueError(
                f"tick {tick_samples} not divisible by {self.shards} shards"
            )
        self.tick = tick_samples
        self.per_shard = tick_samples // self.shards
        self.format = input_format
        dtype = _DTYPES[input_format]
        self._mm = np.memmap(path, dtype=dtype, mode="r")
        self._scalars_per_sample = 1 if input_format == "cf32" else 2
        self.segment_of_host = segment_of_host

        self.process_index = jax.process_index()
        self.num_processes = jax.process_count()
        if self.shards % self.num_processes:
            raise ValueError(
                f"{self.shards} shards over {self.num_processes} processes"
            )
        self.shards_per_process = self.shards // self.num_processes
        self.sharding = NamedSharding(mesh, P(axis))

    @property
    def num_ticks(self) -> int:
        total = len(self._mm) // self._scalars_per_sample
        if self.segment_of_host:
            total *= self.num_processes
        return total // self.tick

    def _local_block(self, tick_index: int) -> np.ndarray:
        """This process's contiguous scalars for the given global tick."""
        sps_ = self._scalars_per_sample
        local_samples = self.per_shard * self.shards_per_process
        if self.segment_of_host:
            # file holds only this host's stripe, tick-major
            start = tick_index * local_samples * sps_
        else:
            start = (
                tick_index * self.tick + self.process_index * local_samples
            ) * sps_
        raw = np.asarray(self._mm[start : start + local_samples * sps_])
        if self.format == "cf32":
            return raw
        scale = 1.0 / 128.0 if self.format == "int8" else 1.0 / 32768.0
        f = raw.astype(np.float32) * scale
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)

    def ticks(self) -> Iterator[cplx.Complex]:
        """Yield globally-sharded Complex pairs, one per streaming tick."""
        for i in range(self.num_ticks):
            local = self._local_block(i)
            re = jax.make_array_from_process_local_data(
                self.sharding, np.ascontiguousarray(local.real), (self.tick,)
            )
            im = jax.make_array_from_process_local_data(
                self.sharding, np.ascontiguousarray(local.imag), (self.tick,)
            )
            yield cplx.Complex(re, im)
