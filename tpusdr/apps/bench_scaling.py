"""Sharded-throughput benchmark harness (BASELINE.md configs 4/5).

Measures samples/s of the time-sharded WBFM chain and the channel-sharded
FM bank across mesh sizes, printing a scaling table with the device beside
every row.  By default it runs on JAX's default devices (the GPUs of the
host); ``--platform cpu`` runs on a virtual CPU mesh instead, which checks
the machinery but measures no device.

  python -m tpusdr.apps.bench_scaling --devices 1,2,4
  python -m tpusdr.apps.bench_scaling --devices 1,2,4,8 --platform cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--mode", choices=["time", "channels"], default="time")
    ap.add_argument(
        "--stagewise",
        action="store_true",
        help="per-stage-rate halos (parallel/halo.py stagewise=True)",
    )
    ap.add_argument("--rf-rate", type=float, default=2e6)
    ap.add_argument("--tick", type=int, default=1 << 19)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument(
        "--platform", default=None, help="force a jax platform (e.g. 'cpu')"
    )
    args = ap.parse_args(argv)

    import os

    if args.platform == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count="
            + args.devices.split(",")[-1]
        ).strip()
    import jax

    from tpusdr.utils import runtime

    device = runtime.start(args.platform)

    from tpusdr.graph import blocks as B
    from tpusdr.graph.chain import Chain
    from tpusdr.models import multichannel, receiver
    from tpusdr.ops import cplx, demod
    from tpusdr.parallel.channels import ChannelShardedBank
    from tpusdr.parallel.halo import TimeShardedStream
    from tpusdr.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    results = []
    for n_dev in [int(d) for d in args.devices.split(",")]:
        mesh = make_mesh(n_dev)
        if args.mode == "time":
            chain, _ = receiver.fm_receiver(args.rf_rate, 200e3, receiver.WBFM)
            tss = TimeShardedStream(chain, mesh, stagewise=args.stagewise)
            g = tss.tick_granule
            tick = max(1, args.tick // g) * g
            z = (
                rng.standard_normal(tick) + 1j * rng.standard_normal(tick)
            ).astype(np.complex64)
            x = jax.device_put(
                cplx.from_numpy(z)
            )
            carry = tss.init_carry()
            carry, y = tss.step(carry, x)
            jax.block_until_ready(y)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                carry, y = tss.step(carry, x)
            jax.block_until_ready(y)
            dt = (time.perf_counter() - t0) / args.iters
        else:
            m = 8 * n_dev
            chanb = B.Channelizer(m, taps_per_channel=8)
            gain = demod.quad_fm_demod_gain(args.rf_rate / m, args.rf_rate / m)
            demod_chain = Chain(
                [("demod", B.QuadFmDemod(gain=gain)), ("audio", B.Resampler(1, 2))]
            )
            bank = ChannelShardedBank(chanb, demod_chain, mesh)
            g = n_dev * bank.chan_chain.granule
            tick = max(bank.halo * n_dev, max(1, args.tick // g) * g)
            tick = ((tick + g - 1) // g) * g
            z = (
                rng.standard_normal(tick) + 1j * rng.standard_normal(tick)
            ).astype(np.complex64)
            x = cplx.from_numpy(z)
            carry = bank.init_carry()
            carry, y = bank.step(carry, x)
            jax.block_until_ready(y)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                carry, y = bank.step(carry, x)
            jax.block_until_ready(y)
            dt = (time.perf_counter() - t0) / args.iters

        msps = tick / dt / 1e6
        results.append({"devices": n_dev, "msps": msps})
        print(
            f"{n_dev} x {device['kind']} ({device['platform']}): "
            f"{msps:9.2f} Msps ({dt*1e3:.2f} ms/tick)"
        )

    base = results[0]["msps"]
    for r in results:
        r["scaling_efficiency"] = r["msps"] / (base * r["devices"])
    print(
        json.dumps(
            {
                "mode": args.mode,
                "stagewise": args.stagewise,
                "device": device,
                "results": results,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
