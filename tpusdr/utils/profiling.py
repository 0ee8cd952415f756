"""Profiling and timing utilities.

The reference has no profiling at all (SURVEY.md section 5: "no timers, no
NVTX, no counters").  Here:

  * ``trace(logdir)`` — context manager around ``jax.profiler`` for
    TensorBoard-compatible device traces of any streaming run;
  * ``time_block(block, x, iters)`` — steady-state throughput of one block
    (used by the stage profiler and perf tests);
  * ``profile_chain(chain, x)`` — per-stage breakdown of a Chain.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import jax

from tpusdr.graph.chain import Chain
from tpusdr.ops import cplx
from tpusdr.utils.logging import get_logger

log = get_logger("profiling")


@contextlib.contextmanager
def trace(logdir: str = "/tmp/tpusdr_trace"):
    """Capture a jax.profiler device trace (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", logdir)


def scan_marginal(
    run,
    state0,
    xs,
    ks: tuple[int, ...] = (2, 6, 12),
    reps: int = 5,
    max_spread: float | None = None,
    retries: int = 1,
) -> dict:
    """Marginal per-tick seconds of ``run(state, xs[:k])`` via a Theil-Sen
    fit over ``reps x len(ks)`` (scan length, wall time) points.

    Scanning K ticks inside one jit and taking the slope over scan lengths
    cancels every fixed per-call cost (dispatch, launch, the final sync),
    leaving the per-tick device time.  The arms are visited round-robin
    (k1,k2,...,k1,...) so slow drift (clocks, power) shows up as per-point
    noise rather than per-arm bias, and the slope is the median of ALL
    cross-arm pairwise slopes over the raw points (Theil-Sen — robust to
    ~29% outliers, so a single hiccup cannot move the estimate).
    ``spread`` is the error bar OF THE ESTIMATE: the interquartile range of
    per-round Theil-Sen estimates (each round-robin pass over the arms
    yields one independent estimate) relative to the global median.  The
    raw pairwise-slope IQR (``pair_spread``) is also reported; it is a
    population-scatter statistic and overstates the estimator's
    uncertainty.  Always a number, never a crash.

    Returns ``{'per_tick', 'spread', 'pair_spread', 'times', 'n_points'}``.
    Raises only when the measurement is meaningless (non-positive median
    slope after ``retries`` re-runs) or when the caller opts into a hard
    gate with ``max_spread``.
    """
    assert len(ks) >= 3, "need >= 3 scan lengths for a robust slope"

    def run_once(k: int) -> None:
        s, ys = run(state0, jax.tree.map(lambda a: a[:k], xs))
        jax.block_until_ready(ys)

    def timed(k: int) -> float:
        t0 = time.perf_counter()
        run_once(k)
        return time.perf_counter() - t0

    last_err = None
    for attempt in range(retries + 1):
        # warm every arm first: each k is a distinct traced shape, so the
        # first call per arm pays compilation; after this, timed runs are
        # steady state.
        for k in ks:
            run_once(k)
        points: list[tuple[int, float]] = []
        for _ in range(reps):
            for k in ks:
                points.append((k, timed(k)))
        def theil_sen(pts):
            s = sorted(
                (tb - ta) / (kb - ka)
                for i, (ka, ta) in enumerate(pts)
                for kb, tb in pts[i + 1 :]
                if kb != ka
            )
            return s

        slopes = theil_sen(points)
        med = slopes[len(slopes) // 2]
        if med <= 0:
            last_err = f"non-positive marginal slope {med:.3g}s"
            continue

        def iqr_rel(s):
            n = len(s)
            core = s[n // 4 : n - n // 4] or s
            return (core[-1] - core[0]) / med

        pair_spread = iqr_rel(slopes)
        # one independent estimate per round-robin pass -> estimator spread
        n_arms = len(ks)

        def round_median(r):
            s = theil_sen(points[r * n_arms : (r + 1) * n_arms])
            return s[len(s) // 2]

        round_est = sorted(round_median(r) for r in range(reps))
        spread = iqr_rel(round_est)
        # per-arm median wall times, for the human-readable report
        by_arm: dict[int, list[float]] = {k: [] for k in ks}
        for k, t in points:
            by_arm[k].append(t)
        times = {k: sorted(v)[len(v) // 2] for k, v in by_arm.items()}
        if max_spread is not None and spread > max_spread:
            last_err = f"slope spread {spread:.1%} > {max_spread:.0%} (times={times})"
            continue
        return {
            "per_tick": med,
            "spread": spread,
            "pair_spread": pair_spread,
            "times": times,
            "n_points": len(points),
        }
    raise RuntimeError(f"scan_marginal: unstable measurement: {last_err}")


def tile_ticks(xs_np, k: int):
    """Upload a FEW unique host ticks (leading axis) and tile them to ``k``
    ON DEVICE.  A full-length scan-input stack is gigabytes; making it on
    the host and uploading it would dominate a benchmark's set-up, while
    the tile is one device-memory copy.  Works on any pytree of arrays
    (Complex pairs)."""
    import jax.numpy as jnp

    def tile_one(a_np):
        a = jax.device_put(a_np)
        rep = -(-k // a.shape[0])  # ceil
        reps_shape = (rep,) + (1,) * (a.ndim - 1)
        return jax.jit(lambda v: jnp.tile(v, reps_shape))(a)[:k]

    return jax.tree.map(tile_one, xs_np)


def time_block(block, x, iters: int = 10, warmup: int = 2) -> dict:
    """Steady-state samples/s of one Block on the current default device."""
    state = jax.device_put(block.init_state())
    xd = jax.device_put(x)
    step = jax.jit(block.apply, donate_argnums=(0,))
    y = None
    for _ in range(warmup):
        state, y = step(state, xd)
    jax.block_until_ready(y)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, y = step(state, xd)
    jax.block_until_ready(y)
    dt = (time.perf_counter() - t0) / iters
    n = x.shape[-1]
    return {
        "seconds_per_tick": dt,
        "msps": n / dt / 1e6,
        "tick": n,
    }


def profile_chain(chain: Chain, x, iters: int = 10) -> list[dict]:
    """Per-stage steady-state timing of a Chain (each stage timed alone with
    representative input shapes derived from the rate plan)."""
    results = []
    results.append({"stage": "<whole chain>", **time_block(chain, x, iters)})
    cur = x
    state = chain.init_state()
    for name, b in chain.blocks:
        r = {"stage": name, **time_block(b, cur, iters)}
        results.append(r)
        state_b, cur = b.apply(b.init_state(), cur)
    return results


def format_profile(rows: list[dict]) -> str:
    lines = [f"{'stage':<16} {'Msps':>10} {'ms/tick':>9} {'tick':>10}"]
    for r in rows:
        lines.append(
            f"{r['stage']:<16} {r['msps']:>10.1f} "
            f"{r['seconds_per_tick'] * 1e3:>9.2f} {r['tick']:>10}"
        )
    return "\n".join(lines)
