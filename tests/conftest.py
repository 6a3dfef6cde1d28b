"""Test configuration: CPU backend with 8 virtual devices + float64.

Parity tests against the reference run in float64 on CPU (the reference is
double-heavy); mesh/sharding tests use the 8 virtual CPU devices
(SURVEY.md §4: JAX CPU multi-device simulation, since the reference offers
no multi-device pattern to mirror).

The platform is the CPU unless JAX_PLATFORMS names another: tests marked
``gpu`` run on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/`` and skip everywhere else.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "concurrency_optimized_scheduler" not in flags:
    # XLA CPU's concurrency-optimized thunk scheduler has an upstream
    # buffer-reuse RACE (jaxlib 0.9.0): the windowed-reduce programs
    # (ops/schur_obs.py r5) deterministically produced wrong diagonal
    # segments or aborted with "double free or corruption" depending on
    # process history; with the scheduler disabled the same programs
    # are exact (isolated by tests/window_fuzz_worker.py).  CPU-only
    # flag.
    flags = (flags
             + " --xla_cpu_enable_concurrency_optimized_scheduler=false")
os.environ["XLA_FLAGS"] = flags

import jax
import pytest

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _release_jit_code_mappings():
    """Free compiled-executable code mappings after every test module.

    Each XLA:CPU-compiled executable pins ~3 memory maps (code/rodata/
    data) for as long as any jit cache references it.  The full suite
    compiles tens of thousands of executables; without this the process
    crosses the kernel's default vm.max_map_count (65,530) at ~75% of
    the suite and mmap failure surfaces as a SEGFAULT inside XLA
    (diagnosed 2026-08-20: map-count watch hit 64,743 at the crash;
    dmesg showed the refused allocations).  Per-module clearing bounds
    live executables to one module's worth at the cost of recompiling
    cross-module helpers.
    """
    yield
    jax.clear_caches()
    # Module-level compiled-solve caches (sparse._SOLVE_CACHE) hold
    # jit-wrapped solves alive across modules; drop them too so their
    # executables actually unmap.
    import importlib
    importlib.import_module("tinyopt_tpu.sparse")._SOLVE_CACHE.clear()
    # (the package re-exports the optimize FUNCTION, which shadows the
    # module attribute — import_module reaches the module itself)
    importlib.import_module("tinyopt_tpu.optimize")._CACHE.clear()
