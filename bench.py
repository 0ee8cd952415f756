"""Benchmark: WBFM receiver chain throughput on one GPU.

BASELINE.md config 3 at the reference's design point: the wideband FM
chain (frequency shift folded into the decimating FIR -> quad FM demod ->
de-emphasis -> resample to 48 kHz) at 20 Msps complex input, the HackRF's
rate (nbfm_test.cpp:415).  ``vs_baseline`` is the multiple of that
real-time rate the card sustains.

Method: lax.scan over ~2M-sample ticks with carried state (the offline
path, run_offline mode='scan').  Per-tick seconds are the Theil-Sen slope
of wall time over scan lengths (utils/profiling.scan_marginal), so fixed
per-call costs cancel; ``spread_pct`` is the IQR of per-round estimates.

Prints ONE JSON line that names the device and the card:
  {"metric": "wbfm_chain_msps_per_chip", "method": "scan_marginal_2m_ticks",
   "value": N, "unit": "Msamples/s", "vs_baseline": N/20, "spread_pct": S,
   "device": {...}, "card": "<name>, <power limit>"}
and fails when JAX's default device is not a GPU.
"""

from __future__ import annotations

import json

import numpy as np


def measure(
    tick_target: int = 1 << 21,
    ks: tuple[int, ...] = (16, 96, 176, 256),
    reps: int = 12,
    n_unique: int = 16,
) -> dict:
    """Time the WBFM chain on the default device; sizes are parameters so
    the CPU tests can rehearse the same code at a tiny size."""
    import jax
    from jax import lax

    from tpusdr.models import receiver
    from tpusdr.ops import cplx
    from tpusdr.utils.profiling import scan_marginal, tile_ticks

    fs = 20.0e6  # the reference's design-point rate
    chain, _ = receiver.fm_receiver(
        rf_sample_rate=fs,
        freq_offset=2.5e6,
        variant=receiver.WBFM,
        audio_rate=48000.0,
    )
    tick = chain.granule * max(1, tick_target // chain.granule)
    rng = np.random.default_rng(0)
    xs = tile_ticks(
        cplx.Complex(
            rng.standard_normal((n_unique, tick)).astype(np.float32),
            rng.standard_normal((n_unique, tick)).astype(np.float32),
        ),
        max(ks),
    )
    state0 = jax.device_put(chain.init_state())

    @jax.jit
    def run_scan(state, xs):
        return lax.scan(chain.apply, state, xs)

    m = scan_marginal(run_scan, state0, xs, ks=ks, reps=reps)
    msps = tick / m["per_tick"] / 1e6
    return {
        "metric": "wbfm_chain_msps_per_chip",
        "method": "scan_marginal_2m_ticks",
        "value": msps,
        "unit": "Msamples/s",
        "vs_baseline": msps / 20.0,
        "spread_pct": 100 * m["spread"],
        "pair_spread_pct": 100 * m["pair_spread"],
        "tick": tick,
    }


def main() -> None:
    from tpusdr.utils import runtime

    runtime.start()
    device = runtime.require_gpu()
    card = runtime.gpu_name_and_power()
    print(json.dumps({**measure(), "device": device, "card": card}))


if __name__ == "__main__":
    main()
