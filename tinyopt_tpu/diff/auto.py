"""Automatic differentiation of residual functions on the tangent space.

JAX replacement of the reference's Ceres-Jet forward-mode autodiff
(reference: include/tinyopt/3rdparty/ceres/jet.h, diff/auto_diff.h:17-140,
diff/optimize_autodiff.h:23-170).  Instead of hand-rolled dual numbers, the
residual function is differentiated with ``jax.jvp`` pushed over the
identity tangent basis (forward mode, one pass per tangent dimension,
vmapped so XLA fuses all passes into batched linear algebra).

The "Accumulation function" contract — build ``grad = JᵀR`` and ``H = JᵀJ``
without the user ever materializing J — is preserved: ``make_nlls_system``
returns ``accumulate(x) -> (H, g, Cost)`` closures for the optimizer loop.
The manifold-aware seeding (Jet tangents seeded through ``PlusEq`` in the
reference, optimize_autodiff.h:36-69) becomes differentiation of
``delta -> residuals(retract(x, delta))`` at ``delta = 0``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp

from .. import manifold as mf
from ..cost import Cost, rss as rss_exact


def value_and_jacfwd(f: Callable, x: jax.Array):
    """Forward-mode value + Jacobian: returns (f(x), J) with J[i, j] = df_i/dx_j.

    One jvp per tangent basis vector, vmapped — the classic JAX idiom
    replacing the reference's Jet<T, N> evaluation (a Jet evaluates all N
    partials in one pass; vmap-of-jvp compiles to the same fused program).
    """
    basis = jnp.eye(x.shape[0], dtype=x.dtype)
    pushfwd = partial(jax.jvp, f, (x,))
    y, jac = jax.vmap(pushfwd, out_axes=(None, -1))((basis,))
    return y, jac


def flatten_residuals(res) -> jax.Array:
    """Flatten a residual pytree into one 1-D vector (row-major per leaf)."""
    leaves = jax.tree_util.tree_leaves(res)
    if not leaves:
        return jnp.zeros((0,))
    flat = [jnp.ravel(jnp.asarray(l)) for l in leaves]
    return flat[0] if len(flat) == 1 else jnp.concatenate(flat)


def residual_jacobian(residual_fn, x, spec: mf.TangentSpec | None = None):
    """(residuals, J) of a residual function at x, on the tangent space.

    The public equivalent of ``diff::CalculateJac`` (diff/auto_diff.h:135).
    J has shape (num_residuals, tangent_dims).
    """
    if spec is None:
        spec = mf.tangent_spec(x)

    def r_of_delta(delta):
        return flatten_residuals(residual_fn(mf.retract(x, delta, spec)))

    delta0 = mf.zero_tangent(x, spec)
    return value_and_jacfwd(r_of_delta, delta0)


def make_nlls_system(residual_fn, x0, spec: mf.TangentSpec,
                     print_J: bool = False):
    """Build (accumulate, evaluate, n_res) closures for the NLLS path.

    accumulate(x) -> (H, g, Cost) with H = JᵀJ, g = JᵀR, cost = ‖r‖²
    (reference: diff/optimize_autodiff.h:149-164).  evaluate(x) computes the
    cost only — no Jacobian work — used by the Rebuild(false) fast path.

    ``print_J=True`` logs the AD Jacobian on every accumulation
    (``options.log.print_J_jet``, reference optimize_autodiff.h:158-161).
    """
    import math
    n_res = int(
        sum(math.prod(l.shape) for l in
            jax.tree_util.tree_leaves(jax.eval_shape(residual_fn, x0))))

    def accumulate(x):
        r, J = residual_jacobian(residual_fn, x, spec)
        r = r.astype(spec.dtype)
        J = J.astype(spec.dtype)
        if print_J:
            jax.debug.print("J:{J}", J=J, ordered=False)
        # JᵀR and JᵀJ with f32 accumulation
        g = J.T @ r
        H = jnp.matmul(J.T, J, preferred_element_type=spec.dtype)
        cost = Cost.make(rss_exact(r), n_res)
        return H, g, cost

    def evaluate(x):
        r = flatten_residuals(residual_fn(x)).astype(spec.dtype)
        return Cost.make(rss_exact(r), n_res)

    return accumulate, evaluate, n_res


def make_cost_system(cost_fn, x0, spec: mf.TangentSpec):
    """Build closures for a scalar-cost (first-order / GD) problem.

    The gradient comes from reverse-mode AD on the tangent space — the right
    choice for scalar outputs (the reference, forward-only, seeds N jets;
    reverse mode is O(1) passes).  Returns (accumulate, evaluate, n_res=1).
    """
    import math
    out_shape = jax.eval_shape(cost_fn, x0)
    if jax.tree_util.tree_leaves(out_shape) and any(
            math.prod(l.shape) != 1 for l in jax.tree_util.tree_leaves(out_shape)):
        raise ValueError(
            "GradientDescent / first-order optimization requires a scalar "
            "cost function (reference: optimize.h:59-72); got non-scalar "
            f"output {out_shape}. Use LM/GN for residual vectors.")

    def c_of_delta(delta, x):
        return jnp.reshape(flatten_residuals(cost_fn(mf.retract(x, delta, spec))), ())

    def accumulate(x):
        delta0 = mf.zero_tangent(x, spec)
        c, g = jax.value_and_grad(lambda d: c_of_delta(d, x))(delta0)
        return None, g.astype(spec.dtype), Cost.make(c, 1)

    def evaluate(x):
        c = jnp.reshape(flatten_residuals(cost_fn(x)), ())
        return Cost.make(c, 1)

    return accumulate, evaluate, 1


def _as_cost(c) -> Cost:
    """Coerce a user acc return (scalar | (scalar, n) | Cost) to Cost."""
    if isinstance(c, Cost):
        return c
    if isinstance(c, (tuple, list)):
        if len(c) == 2:
            return Cost.make(jnp.reshape(jnp.asarray(c[0]), ()), c[1])
        if len(c) == 3:
            return Cost.make(jnp.reshape(jnp.asarray(c[0]), ()), c[1], c[2])
        raise ValueError(f"Cannot interpret cost tuple of length {len(c)}")
    return Cost.make(jnp.reshape(jnp.asarray(c), ()), 1)


def make_acc_system(acc_fn, x0, spec: mf.TangentSpec, first_order: bool,
                    H_is_full: bool = True):
    """Wrap a manual accumulation function.

    ``acc_fn(x) -> (cost_like, grad)`` (first-order) or
    ``acc_fn(x) -> (cost_like, grad, H)`` — the functional version of the
    reference's in-place acc contract ``Cost acc(x, grad&, H&)``
    (reference: optimizers/optimizer.h:114-131, docs/API.md:37-57).
    cost_like may be a scalar, a (cost, num_residuals) pair, or a Cost.

    With ``H_is_full=False`` the acc function may fill only the UPPER
    triangle of a dense H (anything strictly below the diagonal is
    ignored) and the full matrix is recovered by symmetrization — the
    reference's recommended fast path (gn.h:139-145, ref docs/API.md:170).
    """
    def accumulate(x):
        out = acc_fn(x)
        if not isinstance(out, (tuple, list)) or len(out) < 2:
            raise ValueError(
                "Manual acc function must return (cost, grad[, H]); got "
                f"{type(out)}")
        cost = _as_cost(out[0])
        g = jnp.ravel(jnp.asarray(out[1])).astype(spec.dtype)
        if first_order:
            return None, g, cost
        if len(out) < 3:
            raise ValueError(
                "GN/LM require the acc function to also return H "
                "(reference: optimize.h:40-76)")
        H = jnp.asarray(out[2]).astype(spec.dtype)
        if not H_is_full and H.ndim == 2:
            # Symmetrize from the upper triangle (reference gn.h:139-145);
            # the strict lower part of the user's H is ignored.
            H = jnp.triu(H) + jnp.triu(H, 1).T
        return H, g, cost

    def evaluate(x):
        out = acc_fn(x)
        return _as_cost(out[0] if isinstance(out, (tuple, list)) else out)

    return accumulate, evaluate, None
