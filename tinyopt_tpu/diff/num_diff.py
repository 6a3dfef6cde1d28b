"""Numerical differentiation on manifold tangent spaces.

JAX counterpart of the reference's finite-difference layer
(reference: include/tinyopt/diff/num_diff.h:20-311): forward / central /
fast-central differences taken along the tangent basis through the
manifold retraction, so user types with non-Euclidean parametrizations
(SO3/SE3, custom manifolds) are differenced correctly.

Instead of the reference's per-dimension host loop, the perturbed
evaluations are ``vmap``-ed over the tangent basis — XLA compiles all
``dims`` (or ``2·dims``) evaluations into one batched program.

Default step sizes follow the reference's ``FloatEpsilon`` policy
(reference: include/tinyopt/math.h:297-301): 1e-4 for float32, 1e-7 for
float64.
"""

from __future__ import annotations

import enum
from typing import Callable

import jax
import jax.numpy as jnp

from .. import manifold as mf
from ..cost import Cost
from .auto import flatten_residuals


class Method(enum.Enum):
    """Finite-difference scheme (reference: diff/num_diff.h:20-52)."""

    #: (f(x ⊞ h·e) − f(x)) / h — first order, dims+1 evaluations.
    FORWARD = 0
    #: (f(x ⊞ h·e) − f(x ⊞ −h·e)) / 2h — second order, 2·dims evaluations.
    CENTRAL = 1
    #: (f(x⁺) − f(x⁺ ⊞ −2h·e)) / 2h with x⁺ = x ⊞ h·e — the minus point is
    #: reached by a second retraction *from the plus point*, trading
    #: accuracy on curved manifolds for one fewer retraction from x
    #: (reference: num_diff.h:42-51).
    FAST_CENTRAL = 2


# Reference-style aliases
kForward = Method.FORWARD
kCentral = Method.CENTRAL
kFastCentral = Method.FAST_CENTRAL


def default_step(dtype) -> float:
    """FloatEpsilon: 1e-4 (f32 and below) / 1e-7 (f64) (math.h:297-301)."""
    from ..utils import float_epsilon
    return float_epsilon(dtype)


def num_eval(f: Callable, x, method: Method = Method.CENTRAL,
             h: float | None = None, spec: mf.TangentSpec | None = None):
    """(residuals, J) of ``f`` at ``x`` by finite differences.

    ``J[i, j] = d f_i / d delta_j`` on the tangent space, shape
    ``(n_res, dims)``.  Equivalent of ``diff::NumEval``
    (reference: diff/num_diff.h:57-124) with the per-dim loop vmapped.
    """
    if spec is None:
        spec = mf.tangent_spec(x)
    if h is None:
        h = default_step(spec.dtype)
    h = spec.dtype.type(h)

    r0 = flatten_residuals(f(x)).astype(spec.dtype)
    basis = jnp.eye(spec.dims, dtype=spec.dtype)

    def f_at(delta):
        return flatten_residuals(f(mf.retract(x, delta, spec))).astype(spec.dtype)

    if method == Method.FORWARD:
        r_plus = jax.vmap(lambda e: f_at(h * e))(basis)
        J = (r_plus - r0[None, :]) / h
    elif method == Method.CENTRAL:
        r_plus = jax.vmap(lambda e: f_at(h * e))(basis)
        r_minus = jax.vmap(lambda e: f_at(-h * e))(basis)
        J = (r_plus - r_minus) / (2.0 * h)
    elif method == Method.FAST_CENTRAL:
        def pm(e):
            x_plus = mf.retract(x, h * e, spec)
            rp = flatten_residuals(f(x_plus)).astype(spec.dtype)
            rm = flatten_residuals(
                f(mf.retract(x_plus, -2.0 * h * e, spec))).astype(spec.dtype)
            return rp, rm
        r_plus, r_minus = jax.vmap(pm)(basis)
        J = (r_plus - r_minus) / (2.0 * h)
    else:
        raise ValueError(f"Unknown method {method!r}")
    return r0, J.T  # (n_res, dims)


def estimate_num_jac(f: Callable, x, method: Method = Method.CENTRAL,
                     h: float | None = None,
                     spec: mf.TangentSpec | None = None) -> jax.Array:
    """Jacobian only (reference: ``diff::EstimateNumJac``, num_diff.h:131)."""
    return num_eval(f, x, method, h, spec)[1]


def make_num_diff_system(residual_fn: Callable, x0,
                         spec: mf.TangentSpec | None = None,
                         first_order: bool = False,
                         method: Method = Method.CENTRAL,
                         h: float | None = None):
    """Build (accumulate, evaluate, n_res) closures via finite differences.

    The numerical-differentiation analogue of ``make_nlls_system`` —
    the reference's ``CreateNumDiffFunc2`` (grad + H = JᵀJ,
    num_diff.h:284-309) or, with ``first_order=True``,
    ``CreateNumDiffFunc1`` (grad only, num_diff.h:198-221).
    """
    import math
    if spec is None:
        spec = mf.tangent_spec(x0)
    n_res = int(sum(
        math.prod(l.shape) for l in
        jax.tree_util.tree_leaves(jax.eval_shape(residual_fn, x0))))

    def accumulate(x):
        r, J = num_eval(residual_fn, x, method, h, spec)
        g = J.T @ r
        cost = Cost.make(jnp.vdot(r, r), n_res)
        if first_order:
            return None, g, cost
        H = jnp.matmul(J.T, J, preferred_element_type=spec.dtype)
        return H, g, cost

    def evaluate(x):
        r = flatten_residuals(residual_fn(x)).astype(spec.dtype)
        return Cost.make(jnp.vdot(r, r), n_res)

    return accumulate, evaluate, n_res
