"""Test harness: an 8-device virtual CPU platform by default.

Multi-device sharding logic (halo exchange, channel sharding) is verified
on a virtual CPU mesh per SURVEY.md section 4; the GPU path is exercised by
``chip_smoke.py`` and by the ``gpu``-marked tests.  The platform must be
chosen before jax initializes: CPU unless ``JAX_PLATFORMS`` already names
one (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on a machine
with the card).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Entry points under test turn on the persistent compile cache
# (utils/runtime.py); keep test processes from reading or writing it.
jax.config.update("jax_enable_compilation_cache", False)


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided per test, when
    the fixture runs, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"
        )
    return jax.devices()[0]


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run tests marked slow (also TPUSDR_SLOW=1)",
    )


def pytest_collection_modifyitems(config, items):
    """Default run skips `slow`-marked tests so the suite stays short;
    `--runslow` / TPUSDR_SLOW=1 restores the full suite.  Every slow test
    has a fast sibling covering the same property at a smaller shape."""
    if config.getoption("--runslow") or os.environ.get("TPUSDR_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow; use --runslow or TPUSDR_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
