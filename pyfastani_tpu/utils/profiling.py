"""Profiling helpers for the device pipeline.

The reference has no in-library tracing (perf is measured by external
wall-clock scripts, ``/root/reference/benches/mapping/bench.py:51-66``);
on the device the equivalent observability is an XLA trace.  `trace` wraps
``jax.profiler`` so any pipeline section can be captured and inspected
with TensorBoard or xprof:

    from pyfastani_tpu.utils.profiling import trace

    with trace("ani-trace"):
        session.query_many(genomes)

Wall-clock timing of a dispatch must end in ``block_until_ready``: JAX
returns before the device finishes.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace of the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Wall-clock a block; append ``(label, seconds)`` to ``sink`` if given."""
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        if sink is not None:
            sink.append((label, dt))
