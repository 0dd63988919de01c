import os
import sys

# The suite runs on the CPU (chain kernels in Pallas interpret mode) with
# a virtual 8-device mesh for the multi-GPU tests; both must be set
# before JAX starts.  JAX_PLATFORMS=cuda keeps the card for the
# gpu-marked tests (python -m pytest -m gpu tests/test_chain_device.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from mm2_gb_tpu.utils.devcfg import enable_compile_cache  # noqa: E402

enable_compile_cache()

REF_TEST_DIR = "/root/reference/test"


@pytest.fixture(scope="session")
def ref_test_dir():
    if not os.path.isdir(REF_TEST_DIR):
        pytest.skip("reference test data not available")
    return REF_TEST_DIR


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/test_chain_device.py")


def golden_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", name)
