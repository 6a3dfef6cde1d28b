"""Jacobian structure probing and Curtis–Powell–Reid column coloring.

Most real NLLS Jacobians are column-sparse: a residual row depends on a few
parameters (per-coordinate priors are diagonal; bundle adjustment rows touch
one pose + one landmark).  Curtis–Powell–Reid (1974): columns whose supports
are disjoint can share ONE probe tangent p_c = Σ_{j∈c} e_j, because row i of
J·p_c then equals the single J_ij with i ∈ supp(j), j ∈ c.  The general-sparse
Hessian assembly (``sparse.sparse_optimize``) uses this to build J with one
jvp sweep per color instead of one per tangent dimension.

Structure is detected at solver-BUILD time by probing the dense Jacobian of
the example instance at a few deterministic pseudo-random points (parameters
retracted by random tangents, float data leaves perturbed), then OR-ing the
nonzero patterns.  Value sparsity that is accidental at one point (including
{0,1} masks in the data) is broken by the perturbations.

No reference counterpart (the reference assembles its sparse H from the
user's accumulation function directly).
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

# Detection is best-effort: any failure returns None to the caller.  Set
# TINYOPT_COLORING_DEBUG=1 to re-raise instead.
_DEBUG = bool(os.environ.get("TINYOPT_COLORING_DEBUG"))


def _greedy_color(structure: np.ndarray) -> np.ndarray:
    """Greedy distance-1 coloring of columns under row-support conflicts.

    ``structure``: (n, d) bool.  Columns j, k conflict when some row is in
    both supports.  Processes columns by descending support size (classic
    largest-first ordering keeps color counts near-optimal for the
    block-sparse patterns NLLS produces).
    """
    n, d = structure.shape
    conflict = (structure.T.astype(np.int64) @ structure.astype(np.int64)) > 0
    order = np.argsort(-structure.sum(axis=0), kind="stable")
    colors = np.full(d, -1, dtype=np.int64)
    for j in order:
        used = set(colors[k] for k in np.nonzero(conflict[j])[0]
                   if colors[k] >= 0 and k != j)
        c = 0
        while c in used:
            c += 1
        colors[j] = c
    return colors


def probe_structure(residual_fn, x_example, data_example, spec,
                    n_res: int, dims: int, *, n_probes: int = 3
                    ) -> np.ndarray | None:
    """Probe the (n_res, dims) tangent-Jacobian nonzero STRUCTURE, or
    ``None`` if detection fails (non-finite Jacobian, untraceable fn).

    Evaluates the dense Jacobian of the example instance at a few
    deterministic pseudo-random points (see module docstring) and ORs the
    nonzero patterns; shared by the diag coloring and the general-sparse
    Hessian assembly (``sparse.sparse_optimize``).
    """
    from .. import manifold as mf
    from ..diff.auto import flatten_residuals

    try:
        # Pull the example instance to host memory so the CPU-device probe
        # below never mixes committed devices.
        x_example = jax.tree_util.tree_map(
            lambda a: np.asarray(a), mf.as_pytree(x_example))
        data_example = jax.tree_util.tree_map(
            lambda a: np.asarray(a), data_example)
    except Exception:  # noqa: BLE001 - detection is best-effort
        if _DEBUG:
            raise
        return None

    def tangent_map(delta, x):
        x2 = mf.retract(x, delta, spec)
        out = (residual_fn(x2) if data_example is None
               else residual_fn(x2, _data))
        return flatten_residuals(out)

    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except Exception:  # pragma: no cover - cpu platform always present
        cpu = None

    structure = np.zeros((n_res, dims), dtype=bool)
    try:
        for k in range(n_probes):
            rng = np.random.default_rng(12345 + k)
            if k == 0:
                xk, _data = x_example, data_example
            else:
                delta = jnp.asarray(rng.uniform(-0.5, 0.5, (dims,)),
                                    jnp.result_type(float))
                xk = mf.retract(x_example, delta, spec)
                _data = jax.tree_util.tree_map(
                    lambda a: (a + jnp.asarray(
                        rng.uniform(0.25, 1.0, jnp.shape(a)) *
                        np.where(rng.uniform(size=jnp.shape(a)) < 0.5,
                                 -1.0, 1.0), a.dtype)
                        if jnp.issubdtype(jnp.result_type(a), jnp.floating)
                        else a),
                    data_example)
            jac_fn = jax.jacfwd(lambda dd: tangent_map(dd, xk))
            zero = jnp.zeros((dims,), jnp.result_type(float))
            if cpu is not None:
                with jax.default_device(cpu):
                    J = np.asarray(jax.jit(jac_fn)(zero))
            else:
                J = np.asarray(jac_fn(zero))
            if not np.all(np.isfinite(J)):
                return None
            structure |= J.reshape(n_res, dims) != 0
    except Exception:  # noqa: BLE001 - detection is best-effort
        if _DEBUG:
            raise
        return None
    return structure
