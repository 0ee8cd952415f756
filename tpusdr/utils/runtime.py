"""Process set-up shared by the entry points: compile cache and device report.

Every entry point (the app CLIs, ``bench.py``, ``bench_configs.py``,
``chip_smoke.py``) calls :func:`start` before its first computation, so
each run names the device it got and reuses compiled programs across
processes.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

from tpusdr.utils.logging import get_logger

log = get_logger("runtime")

#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
#: A fixed path inside the checkout (listed in .gitignore): the directory is
#: part of the cache key, so it never holds a pid, a temp name or a time.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets no other directory.  Otherwise the cache goes to
    ``DEFAULT_CACHE_DIR``.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def device_info() -> dict:
    """The default device as JAX reports it: platform, kind and count."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def gpu_name_and_power() -> str:
    """``name, power.limit`` of each card as nvidia-smi prints them
    ("; "-joined), or a note saying nvidia-smi gave nothing."""
    try:
        r = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=30,
            check=False,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if r.returncode != 0 or not lines:
        return f"nvidia-smi unavailable (rc {r.returncode})"
    return "; ".join(lines)


def require_gpu() -> dict:
    """Fail unless JAX's default device is a GPU; return ``device_info()``.

    Measurement entry points call this: a CPU fallback would print numbers
    that are not device numbers."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {info['platform']} "
            f"({info['kind']}); this entry point measures the GPU only"
        )
    return info


def start(platform: str | None = None) -> dict:
    """Entry-point prologue: optional platform override, compile cache, and
    one log line naming the device the run got."""
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    cache = setup_compile_cache()
    info = device_info()
    log.info(
        "device %s (%s, %d device(s)); compile cache %s",
        jax.devices()[0],
        info["kind"],
        info["count"],
        cache,
    )
    return info
