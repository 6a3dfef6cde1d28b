"""Timing and profiling utilities.

Counterpart of the reference's ``time.h`` (tic/toc, reference:
include/tinyopt/time.h:22-57) plus the device observability the
reference lacks (SURVEY.md §5.1): a ``jax.profiler`` trace context that
captures device timelines viewable in TensorBoard / Perfetto, and a
NaN-debugging toggle standing in for the reference's ASAN build type
(SURVEY.md §5.2).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator


def float_epsilon(dtype) -> float:
    """The reference's FloatEpsilon policy (math.h:297-301): 1e-7 for
    64-bit floats, 1e-4 for narrower — ONE definition shared by the
    Mahalanobis guards, numerical-differentiation default steps, and the
    accept/reject rel_derr zeroing in the optimizer loop."""
    import jax.numpy as jnp
    return 1e-7 if jnp.dtype(dtype).itemsize >= 8 else 1e-4


def tic() -> float:
    """Start time in seconds (reference: time.h:22)."""
    return time.perf_counter()


def toc_ms(t0: float) -> float:
    """Milliseconds since ``t0`` (reference: time.h:30-38)."""
    return (time.perf_counter() - t0) * 1e3


def use_compile_cache(root: str) -> str:
    """Point JAX's persistent compilation cache at ``<root>/.jax_cache``.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here.  The directory is fixed (never temporary or
    per-process) because its path is part of what a later run must find
    again.  Called by the scripts at the repository root; the library
    sets no cache on import.  Returns the directory in use.
    """
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace around a block.

    View with TensorBoard (``tensorboard --logdir <dir>``) or Perfetto.
    The block should end with ``jax.block_until_ready`` on its outputs so
    the device work is inside the trace.
    """
    import jax.profiler

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Raise on NaN production inside jitted code (jax_debug_nans).

    The development-time analogue of the reference's sanitizer build; the
    production path instead *routes* NaNs to
    ``StopReason.SYSTEM_HAS_NAN_OR_INF`` (optimizers/loop.py).
    """
    import jax

    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def block_ms(fn, *args, n: int = 5) -> float:
    """Best-of-n wall-clock milliseconds of ``fn(*args)`` incl. device sync.

    Each rep ends with a forced host read of the first output scalar,
    so the device work is inside the timed region.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    def run():
        out = fn(*args)
        leaf = jax.tree_util.tree_leaves(out)[0]
        # force a concrete transfer of one element
        float(np.asarray(jnp.ravel(jnp.asarray(leaf))[0]))
        return out

    run()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3
