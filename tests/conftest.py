"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so that multi-device
sharding (`sparsela.parallel`) is exercised without a GPU: pin the CPU
with ``JAX_PLATFORMS=cpu`` (the virtual devices exist only there).

Tests marked ``chip`` need the card and skip elsewhere; the ``gpu``
fixture decides, at run time. Run them on a GPU machine with
``python -m pytest tests -m chip``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sparsela.io import generators  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Default runs skip @pytest.mark.slow; the full suite runs with
    RUN_SLOW=1 or an explicit ``-m slow``."""
    if os.environ.get("RUN_SLOW", "0") not in ("", "0", "false", "no"):
        return
    mexpr = config.getoption("-m", default="") or ""
    if "slow" in mexpr:
        return
    skip = pytest.mark.skip(
        reason="slow; set RUN_SLOW=1 (or -m slow) for the full suite")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Drop JAX's compiled-executable caches at every module boundary,
    bounding the executables one worker accumulates over the suite."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise
    (decided here, at run time, never while modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs the card: run `python -m pytest tests -m chip`"
                    " on a GPU machine")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_spd():
    """Small SPD matrix (CSR, host) for solver tests."""
    return generators.make_laplacian_grid2d(16).to_csr()


@pytest.fixture(scope="session")
def medium_spd():
    return generators.make_laplacian_grid3d(12).to_csr()
