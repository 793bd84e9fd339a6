"""Test configuration: a CPU backend with 8 virtual devices, and the `gpu`
marker.

The reference has no test framework (SURVEY.md §4); this suite formalizes its
four manual practices — golden-model differential testing, adversarial shapes,
cross-implementation agreement, bench-as-test — on the CPU so it runs
anywhere: Pallas kernels execute in interpreter mode (utils/platform.py) and
sharding tests use 8 virtual devices.

Tests marked `gpu` need an NVIDIA GPU: the `gpu` fixture skips them when JAX
has none. On the card they run inside ``python chip_smoke.py`` (one process,
no xdist workers), where the backend is already the GPU.
"""

import jax
import pytest

try:
    # The first JAX touch in a plain pytest run: pin the CPU backend with a
    # virtual mesh. Inside chip_smoke.py the GPU backend is already up and
    # the first update raises, leaving it as it is.
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_platforms", "cpu")
except RuntimeError:
    pass


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (heavyweight model/fuzz/sharding "
             "soaks; the default tier is the pre-commit gate)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; run on the "
                   "card by chip_smoke.py)")
    config.addinivalue_line("markers", "slow: long-running precision sweeps")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow soak — use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")


@pytest.fixture(scope="session")
def mesh8():
    """8-device 1D mesh (virtual CPU devices) for sharding tests."""
    import numpy as np
    from jax.sharding import Mesh

    if jax.device_count() < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    return Mesh(np.array(jax.devices()[:8]), axis_names=("x",))
