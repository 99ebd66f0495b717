"""JAX runtime configuration shared by every device-facing module.

The persistent compilation cache matters: the chunked winnow and the
sharded query program are compiled once per (shape, params)
configuration, and a cold compile of the query program takes seconds.
`configure` enables it exactly once: in ``JAX_COMPILATION_CACHE_DIR``
when that variable is set (JAX reads it itself, and nothing is set in
code), otherwise in the fixed ``<checkout>/.jax_cache`` (git-ignored).
"""

from __future__ import annotations

import os

_DONE = False


def cache_dir() -> str:
    """Where compiled programs (and the `stats` table cache) persist."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    checkout = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(checkout, ".jax_cache")


def configure() -> None:
    """Enable the persistent compilation cache (idempotent)."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
