"""Worker process for the multi-process (multi-host) ingest test.

Launched N times by tests/test_ingest.py::TestMultiProcessIngest with a
shared coordinator port.  Each process owns 2 virtual CPU devices; the
global mesh is 2 x N devices.  Every process reads ONLY its own byte
ranges of the capture (ShardedFileIngest block-index agreement, SURVEY.md
section 7 hard part (d)), runs the time-sharded chain, gathers the audio,
and process 0 checks it against the unsharded single-process result.

argv: coordinator_port process_id num_processes capture_path out_path
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

port, pid, nproc, path, out_path = (
    sys.argv[1],
    int(sys.argv[2]),
    int(sys.argv[3]),
    sys.argv[4],
    sys.argv[5],
)

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
)

import numpy as np  # noqa: E402
import scipy.signal as sps  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tpusdr.graph import blocks as B  # noqa: E402
from tpusdr.graph.chain import Chain  # noqa: E402
from tpusdr.ops import cplx, fir  # noqa: E402
from tpusdr.parallel.halo import TimeShardedStream  # noqa: E402
from tpusdr.parallel.ingest import ShardedFileIngest  # noqa: E402


def main() -> None:
    devs = jax.devices()
    assert len(devs) == 2 * nproc, f"expected {2 * nproc} global devices, {len(devs)}"
    assert jax.process_count() == nproc
    mesh = Mesh(np.array(devs), ("dev",))

    taps = sps.firwin(33, 0.3).astype(np.float32)
    chain = Chain([("fir", B.Fir(taps, 2)), ("demod", B.QuadFmDemod(gain=1.0))])
    tick = 4096

    ing = ShardedFileIngest(path, mesh, tick, input_format="cf32")
    assert ing.num_ticks == 3
    tss = TimeShardedStream(chain, mesh)
    carry = tss.init_carry()
    outs = []
    for x in ing.ticks():
        carry, y = tss.step(carry, x)
        outs.append(multihost_utils.process_allgather(y, tiled=True))
    got = np.concatenate([np.asarray(o) for o in outs], axis=-1)

    if pid == 0:
        z = np.fromfile(path, np.complex64)
        s = chain.init_state()
        ref = []
        for i in range(3):
            s, y = chain.apply(s, cplx.from_numpy(z[i * tick : (i + 1) * tick]))
            ref.append(np.asarray(y))
        ref = np.concatenate(ref, axis=-1)
        err = np.mean((got - ref) ** 2) / max(np.mean(ref**2), 1e-30)
        assert err < 1e-10, f"sharded multi-process != unsharded: {err}"
    with open(out_path, "w") as f:
        f.write("OK")


if __name__ == "__main__":
    main()
