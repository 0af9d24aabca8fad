"""Per-phase wall-time profiling.

Replaces ``record_time`` (reference ``backend.py:199-212``) and feeds the
running data CSV (``simulation.py:392-419``). For jitted phases the timed
value is made meaningful by blocking on async dispatch
(``jax.block_until_ready``). An optional ``jax.profiler`` trace hook covers
kernel-level timing the reference never had.
"""

from __future__ import annotations

import contextlib
import time
from functools import wraps

import jax


def record_time(function):
    """Decorator storing the method's wall time in ``sim.method_times`` under
    the method name — same mechanism and key naming as the reference so the
    data CSV columns match."""

    @wraps(function)
    def wrap(simulation, *args, **kwargs):
        start = time.perf_counter()
        result = function(simulation, *args, **kwargs)
        if result is not None:
            result = jax.block_until_ready(result)
        end = time.perf_counter()
        simulation.method_times[function.__name__] = end - start
        return result

    return wrap


@contextlib.contextmanager
def record_block(simulation, name: str):
    """Context-manager form for timing inline blocks (the fused jit step)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        simulation.method_times[name] = time.perf_counter() - start


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Optional device profiler trace around a region (view with TensorBoard or
    xprof); no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
