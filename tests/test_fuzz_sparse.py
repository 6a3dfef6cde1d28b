"""Property-based fuzzing of the general-sparse Hessian path.

Random sparsity structures (random supports per residual row, random
bandedness, shared columns) through ``sparse_optimize`` must reproduce
the dense path's Hessian, gradient, trajectory, and optimum — the
colored J recovery + static-COO JᵀJ pair assembly (sparse._sparse_plan)
is pure index bookkeeping whose failure modes are silent wrong answers,
exactly what property tests catch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu import manifold as mf
from tinyopt_tpu.ops.coloring import probe_structure
from tinyopt_tpu.sparse import sparse_system


def _random_sparse_program(rng, d, n_res):
    """Random residual with a random (static) sparsity structure."""
    structure = rng.uniform(size=(n_res, d)) < rng.uniform(0.15, 0.6)
    # every row/column must touch something
    for i in range(n_res):
        if not structure[i].any():
            structure[i, rng.integers(0, d)] = True
    for j in range(d):
        if not structure[:, j].any():
            structure[rng.integers(0, n_res), j] = True
    A = jnp.asarray(structure * rng.normal(0, 1.0, (n_res, d)),
                    jnp.float64)
    y = jnp.asarray(rng.uniform(-1, 1, (n_res,)), jnp.float64)
    kind = int(rng.integers(0, 3))

    def residual(x):
        z = A @ x
        if kind == 0:
            return z - y
        if kind == 1:
            return jnp.tanh(z) - y
        return z + 0.1 * z * z - y

    return residual, structure


@pytest.mark.parametrize("seed", range(8))
def test_sparse_matches_dense(seed):
    rng = np.random.default_rng(200 + seed)
    d = int(rng.integers(3, 14))
    n_res = int(rng.integers(d, 2 * d + 6))
    residual, structure = _random_sparse_program(rng, d, n_res)
    x0 = jnp.asarray(rng.uniform(-0.5, 0.5, (d,)), jnp.float64)

    opts = to.Options(max_iters=30, max_consec_failures=0)
    x_sp, out_sp = to.sparse_optimize(x0, residual, opts)
    x_d, out_d = to.optimize(x0, residual, opts)

    # Same assembled system at the optimum…
    np.testing.assert_allclose(np.asarray(out_sp.final_hessian.to_dense()),
                               np.asarray(out_d.final_hessian),
                               rtol=1e-9, atol=1e-9)
    # …and the same trajectory endpoint.
    np.testing.assert_allclose(np.asarray(x_sp), np.asarray(x_d),
                               rtol=1e-6, atol=1e-7)
    assert bool(out_sp.succeeded()) == bool(out_d.succeeded())


@pytest.mark.parametrize("seed", range(4))
def test_detected_structure_is_superset(seed):
    """Build-time probing must detect every true nonzero (a missed entry
    silently corrupts the colored recovery)."""
    rng = np.random.default_rng(300 + seed)
    d = int(rng.integers(3, 12))
    n_res = int(rng.integers(d, 2 * d))
    residual, structure = _random_sparse_program(rng, d, n_res)
    x0 = jnp.asarray(rng.uniform(-0.5, 0.5, (d,)), jnp.float64)
    spec = mf.tangent_spec(x0)
    detected = probe_structure(residual, x0, None, spec, n_res, d)
    assert detected is not None
    missed = structure & ~detected
    assert not missed.any(), f"probe missed {missed.sum()} true nonzeros"


class TestWindowBandFuzz:
    """Randomized layouts × masks for the r5 reduction family: the
    windowed matmul reduce and the BAND-storage reduce must reproduce the
    scatter pass's reduced system exactly (f64), including duplicate
    cameras within a landmark, contract cam-0 masked slots, and
    all-masked rows.

    Runs in a SUBPROCESS: jaxlib's CPU runtime has an upstream heap
    bug ("double free or corruption") when these window-reduce
    programs execute after a shard_map program in the same process
    (deterministic with pytest fd-capture, absent with --capture=no —
    heap-layout sensitive).  The window path is off by default on
    every platform (schur_obs.window_default); isolating the CPU fuzz
    keeps the suite immune.
    Diagnosed r5 — see also _reconstruct_S's scatter-free diagonal
    (a second, distinct XLA CPU miscompile isolated by this fuzz).
    """

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    def test_reduce_parity_random_banded(self, seed):
        import os
        import subprocess
        import sys
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, os.path.join(
                repo, "tests", "window_fuzz_worker.py"), str(seed)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, TINYOPT_WINDOW_REDUCE="1"),
            cwd=repo)
        assert proc.returncode == 0, (
            f"seed {seed} failed:\n{proc.stdout[-2000:]}\n"
            f"{proc.stderr[-2000:]}")
        assert "WINDOW-FUZZ-OK" in proc.stdout
