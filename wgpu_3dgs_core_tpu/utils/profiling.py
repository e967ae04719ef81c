"""Tracing and profiling helpers.

The reference's only observability is debug labels on every GPU object
(SURVEY.md §5: label_for_components!, compute pass labels). The JAX
equivalents are jax.profiler traces + named scopes: every labeled construct
here surfaces in a TensorBoard/Perfetto trace the way wgpu labels surface in
GPU debuggers.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from typing import Iterator, Optional

import jax

log = logging.getLogger(__name__)


def named_scope(name: str):
    """Label a region of traced computation (the wgpu debug-label analog)."""
    return jax.named_scope(name)


def annotate(name: Optional[str] = None):
    """Decorator: wrap a function in a named profiler scope."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with jax.named_scope(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", log_dir)


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock a block (blocks on async dispatch only if you do)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
        log.info("%s: %.3f ms", label, dt * 1e3)


def block_and_time(label: str, fn, *args, iters: int = 10, warmup: int = 2,
                   **kwargs) -> float:
    """Steady-state seconds/call of a jitted function (block_until_ready)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.tree.map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
        else x,
        out,
    )
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    jax.tree.map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
        else x,
        out,
    )
    dt = (time.perf_counter() - t0) / iters
    log.info("%s: %.3f ms/iter", label, dt * 1e3)
    return dt
