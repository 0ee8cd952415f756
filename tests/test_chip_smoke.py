"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size, the
refusal to run without a GPU, and the compile-cache helper.

On the card the script runs the same functions at the reference's design
point; here the sizes are cut (short captures, small ticks, short scan
arms), the widths are not.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
from tpusdr.utils import runtime

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "mod,rf_rate,fmt,seconds,tick",
    [
        ("wbfm", 20e6, "int8", 0.06, 200_000),
        ("nbfm", 20e6, "cf32", 0.2, 416_250),
        # AM's DC blocker needs ~0.3 s to settle before the fitted window,
        # and int8 quantisation noise needs the 10 Msps decimation gain
        ("am", 10e6, "int8", 1.2, 250_000),
    ],
)
def test_phase_receiver(tmp_path, mod, rf_rate, fmt, seconds, tick):
    r = chip_smoke.phase_receiver(mod, rf_rate, fmt, seconds, tick, str(tmp_path))
    assert r["ok"], r


def test_phase_bank(tmp_path):
    r = chip_smoke.phase_bank(20.48e6, 64, 0.05, 204_800, str(tmp_path))
    assert r["ok"], r


def test_phase_file(tmp_path):
    r = chip_smoke.phase_file(20e6, 0.06, 200_000, str(tmp_path))
    assert r["ok"], r
    assert r["native_library"]


def test_phase_accuracy():
    r = chip_smoke.phase_accuracy(20e6, 200_000, 16, 16 * 4096, time_iters=1)
    assert r["ok"], r
    assert set(r["fir_ladder"]) == {"DEFAULT", "HIGH", "HIGHEST", "BF16_BF16_F32_X3"}
    assert r["fastest_qualifying"] is not None


def test_phase_bench():
    r = chip_smoke.phase_bench(tick_target=16384, ks=(1, 16, 32), reps=2)
    assert r["ok"], r
    assert len(r["rows"]) == 5


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert "platform=cpu" in out.splitlines()[0]
    assert '"ok": true' not in out


def test_script_alone_fails(tmp_path):
    """Without the repository beside it the script exits non-zero and
    prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _cache_probe(env_dir):
    """Run setup_compile_cache in a fresh process; compile one program."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    code = (
        "import json, jax, jax.numpy as jnp\n"
        "from tpusdr.utils import runtime\n"
        "d = runtime.setup_compile_cache()\n"
        "if d != str(runtime.DEFAULT_CACHE_DIR):\n"
        "    jax.jit(lambda x: x * 3 + 1)(jnp.ones(8)).block_until_ready()\n"
        "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))\n"
    )
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_compile_cache_env_set(tmp_path):
    cache = tmp_path / "cache"
    d, cfg = _cache_probe(cache)
    assert d == cfg == str(cache)
    assert any(cache.iterdir()), "no cache entry written"


def test_compile_cache_env_unset():
    d, cfg = _cache_probe(None)
    assert d == cfg == str(REPO / ".jax_cache") == str(runtime.DEFAULT_CACHE_DIR)


@pytest.mark.gpu
def test_accuracy_on_card(gpu):
    """The accuracy phase at a reduced tick on the card: the interferer
    case at the default FIR precision inside the -60 dB bar."""
    r = chip_smoke.phase_accuracy(20e6, 400_000, 64, 64 * 4096, time_iters=2)
    assert r["ok"], r
