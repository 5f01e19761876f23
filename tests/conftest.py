"""Test configuration: force an 8-device virtual CPU platform.

Multi-chip sharding paths are validated on a virtual CPU mesh (the moral
equivalent of multi-node testing without a cluster, SURVEY §4d); single-chip
numerics tests also run on CPU for speed and f32 determinism.  Pallas
kernels run here in interpret mode.

Tests that need the GPU carry ``@pytest.mark.gpu`` and take the ``gpu``
fixture, which skips them when JAX sees no GPU.  Run them on a machine with
a card by keeping JAX off the CPU:

    ART_TEST_GPU=1 python -m pytest tests/ -m gpu

(``python chip_smoke.py`` is the end-to-end check on the card.)
"""

import os

import pytest

# Must be set before jax initializes its backends.
if not os.environ.get("ART_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not os.environ.get("ART_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")
# f32 references everywhere: no dot may run at reduced precision.
jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX sees none")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with ART_TEST_GPU=1 on the card)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def native_lib():
    """The native C++ library, built from native/ if it is not there yet."""
    from another_raytracer.utils import native

    if not native.available():
        native.build()
    assert native.available()
    return native


@pytest.fixture(scope="session")
def _asset_tree(tmp_path_factory):
    from assetgen import write_asset_tree

    return write_asset_tree(tmp_path_factory.mktemp("assets"), seed=7)


@pytest.fixture
def ref_assets(_asset_tree, monkeypatch):
    """Point utils/assets at a seeded stand-in asset tree (tests/assetgen.py)."""
    from another_raytracer.utils import assets

    monkeypatch.setattr(assets, "_CANDIDATES", (str(_asset_tree),))
    return _asset_tree
