"""Test configuration.

Runs everything on CPU with a virtual 8-device mesh so sharding logic is
exercised without accelerator hardware (SURVEY.md §4 implications; the
analog of the reference testing against whatever adapter is present,
tests/common/test_context.rs:11-38). Pallas kernels run in the
interpreter. Tests marked ``gpu`` need a card and skip here; on a GPU
machine ``chip_smoke.py`` runs the kernels compiled.

The platform is also pinned through jax.config in case jax was imported
before this file set the environment.
"""

import os

# An explicit JAX_PLATFORMS (e.g. "cuda" on a GPU machine, to run the
# ``gpu``-marked tests) is kept; the default is the CPU.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips on the CPU; see chip_smoke.py)"
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when JAX has no GPU — decided per test,
    never at import time."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run chip_smoke.py on the card")
