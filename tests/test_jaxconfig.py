"""Where the persistent compilation cache lands."""

import os
import subprocess
import sys

import pytest

from pyfastani_tpu.utils import jaxconfig

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_precedence(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxconfig.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert jaxconfig.cache_dir() == os.path.join(_CHECKOUT, ".jax_cache")


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_lands_in_cache_dir(from_env, tmp_path):
    """A fresh process compiles one program; its cache entry lands in
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
        env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from pyfastani_tpu.utils.jaxconfig import configure\n"
        "configure()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        f"jax.jit(lambda x: x * {3 + from_env} + 1)(jnp.arange(7)).block_until_ready()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_CHECKOUT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout.split()
    want = str(tmp_path) if from_env else os.path.join(_CHECKOUT, ".jax_cache")
    assert out[-1] == want
    assert any(n.startswith("jit__lambda") for n in os.listdir(want))
