import os

import pytest

# Tests run on a virtual 8-device CPU mesh, so sharding is checked without
# several accelerators.  Where JAX_PLATFORMS is set it chooses instead: the
# card-only tests (marker 'gpu') run on a GPU host with
#     JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided when the test runs,
    never at import or collection)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/")
    return jax.devices()[0]
