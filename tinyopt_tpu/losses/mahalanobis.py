"""Mahalanobis norms and whitening.

Counterpart of the reference's Mahalanobis loss family (reference:
include/tinyopt/losses/mahalanobis.h:18-172).  ``cov_or_var`` is
interpreted by shape, like the reference's scalar/vector/matrix overloads:

  * scalar        — isotropic variance (``maha_*``) or stdev (whitening)
  * 1-D  (d,)     — per-coordinate variances (stdevs for whitening)
  * 2-D  (d, d)   — full covariance matrix

Whitened residuals are the JAX-idiomatic way to use these inside residual
functions: ``r' = W·r`` with ``‖r'‖² = ‖r‖²_Σ``, and AD carries the
whitening into the Jacobian automatically.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _float_eps(dtype) -> float:
    """FloatEpsilon (reference: math.h:297-301)."""
    from ..utils import float_epsilon
    return float_epsilon(dtype)


def _apply_inv_cov(x: jax.Array, cov_or_var) -> jax.Array:
    """Σ⁻¹ x for scalar / variance-vector / full-covariance Σ."""
    c = jnp.asarray(cov_or_var)
    if c.ndim == 0:
        safe = jnp.where(c < _float_eps(x.dtype), x.dtype.type(1.0),
                         c.astype(x.dtype))
        return x / safe
    if c.ndim == 1:
        return x / c.astype(x.dtype)
    return jnp.linalg.solve(c.astype(x.dtype), x)


def maha_squared_norm(x, cov_or_var):
    """Squared Mahalanobis norm ‖x‖²_Σ = xᵀ Σ⁻¹ x (mahalanobis.h:18-86)."""
    x = jnp.ravel(jnp.asarray(x))
    return jnp.vdot(x, _apply_inv_cov(x, cov_or_var))


def maha_squared_norm_with_jac(x, cov_or_var, add_scale: bool = True):
    """(‖x‖²_Σ, J) with J = 2(Σ⁻¹x)ᵀ (or (Σ⁻¹x)ᵀ if not add_scale)."""
    x = jnp.ravel(jnp.asarray(x))
    ix = _apply_inv_cov(x, cov_or_var)
    n2 = jnp.vdot(x, ix)
    J = (2.0 * ix if add_scale else ix)[None, :]
    return n2, J


def maha_norm(x, cov_or_var):
    """Mahalanobis norm ‖x‖_Σ (mahalanobis.h:87-106)."""
    return jnp.sqrt(maha_squared_norm(x, cov_or_var))


def maha_norm_with_jac(x, cov_or_var):
    n2, J = maha_squared_norm_with_jac(x, cov_or_var, add_scale=False)
    n = jnp.sqrt(n2)
    s = jnp.where(n > _float_eps(n.dtype), n, n.dtype.type(1.0))
    return n, J / s


def maha_whitened(res, cov_stdevs):
    """Whitened residuals r' with ‖r'‖ = ‖r‖_Σ (mahalanobis.h:110-156).

    ``cov_stdevs`` is an isotropic stdev (scalar), per-coordinate stdevs
    (1-D), or a full covariance matrix (2-D — whitened via the lower
    Cholesky factor: r' = L⁻¹ r).
    """
    res = jnp.asarray(res)
    c = jnp.asarray(cov_stdevs)
    if c.ndim == 0:
        return res / c.astype(res.dtype)
    if c.ndim == 1:
        return res / c.astype(res.dtype)
    L = jnp.linalg.cholesky(c.astype(res.dtype))
    return jax.scipy.linalg.solve_triangular(L, res, lower=True)


def maha_whitened_with_jac(res, cov_stdevs):
    """(r', J) with J = d r'/d r (the whitening operator itself)."""
    res = jnp.asarray(res)
    c = jnp.asarray(cov_stdevs)
    if c.ndim == 0:
        return res / c, jnp.asarray(1.0 / c)
    if c.ndim == 1:
        return res / c, jnp.diag(1.0 / c.astype(res.dtype))
    L = jnp.linalg.cholesky(c.astype(res.dtype))
    r2 = jax.scipy.linalg.solve_triangular(L, res, lower=True)
    J = jax.scipy.linalg.solve_triangular(
        L, jnp.eye(c.shape[0], dtype=res.dtype), lower=True)
    return r2, J


def maha_whitened_info_u(res, U):
    """Whitening by an upper-triangular information factor: r' = U·r
    (mahalanobis.h:161-172)."""
    res = jnp.asarray(res)
    return jnp.triu(jnp.asarray(U)).astype(res.dtype) @ res


def maha_whitened_info_u_with_jac(res, U):
    Uu = jnp.triu(jnp.asarray(U))
    res = jnp.asarray(res)
    return Uu.astype(res.dtype) @ res, Uu
