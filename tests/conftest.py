"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

Multi-device sharding is tested on the host platform.  Set
``PYFASTANI_TEST_DEVICES=1`` to leave JAX on the machine's own devices:
``chip_smoke.py`` does, to run the tests marked ``gpu`` on the card.
Tests marked ``gpu`` skip where JAX finds no GPU.
"""

import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if not os.environ.get("PYFASTANI_TEST_DEVICES"):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

# persistent compilation cache: XLA compiles are the dominant test cost
from pyfastani_tpu.utils.jaxconfig import configure as _configure_jax_cache

_configure_jax_cache()

# build the optional native host extension in place when absent (the
# library is not committed); without a C compiler the pure-Python
# fallback serves the same API
from pyfastani_tpu import _native as _native_mod

if not _native_mod.HAVE_NATIVE:
    import importlib

    from pyfastani_tpu._native.build import build as _build_native

    try:
        _build_native()
    except (OSError, subprocess.CalledProcessError):
        pass
    importlib.reload(_native_mod)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on an NVIDIA GPU; skips where JAX finds none"
    )


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU; JAX found none")


@pytest.fixture
def eight_devices():
    """Skip unless JAX has at least 8 devices (the virtual CPU mesh)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
