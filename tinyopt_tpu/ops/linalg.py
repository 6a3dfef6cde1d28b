"""Dense linear-algebra primitives for the normal-equation solves.

JAX replacement of the reference's Eigen LDLT layer (reference:
include/tinyopt/math.h:232-277).  XLA's Cholesky does not report
factorization failure like Eigen's ``info()`` — it produces NaNs — so PSD
failure detection is a NaN check on the solution, which routes to the same
λ-escalation path as the reference (SURVEY.md §7 hard parts).

All functions are batched-friendly (leading batch dims broadcast) and keep
matmuls in the input dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def damp_diagonal(H: jax.Array, lam) -> jax.Array:
    """Multiplicative LM damping: ``H[i,i] *= (1 + λ)``.

    Matches the reference damping update (reference: solvers/lm.h:107-117);
    since we always keep the *un-damped* H and damp on the fly, the
    incremental ``(1+λ)/(1+λ_prev)`` re-damping trick is unnecessary — the
    math is identical and the O(d²) add fuses into the factorization.

    Deviation for exactly-zero diagonal entries (a parameter with no
    residual coupling at the linearization point): multiplicative damping
    cannot regularize them, but the reference's LDLT tolerates the
    semidefinite system where Cholesky produces NaNs — so those entries
    get absolute (Marquardt λ·1) damping instead, which the λ-escalation
    retry loop then drives to a solvable system.
    """
    d = H.shape[-1]
    eye = jnp.eye(d, dtype=H.dtype)
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    damp = jnp.where(diag == 0, jnp.ones_like(diag), diag)
    return H + lam * (eye * damp[..., None, :])


def solve_psd(H: jax.Array, b: jax.Array, use_cholesky: bool = True):
    """Solve ``H dx = b`` for symmetric positive-definite H.

    Returns ``(dx, ok)`` where ``ok`` is False when the factorization failed
    (non-PSD H → NaNs) or the solution is non-finite.  Equivalent role to
    ``SolveLDLT`` returning nullopt (reference: math.h:232-240).

    With ``use_cholesky=False``, mirrors the reference's unchecked
    ``H.inverse()`` path (reference: solvers/gn.h:150-171) including the
    1-dim guard returning a zero step when H ≤ ε.
    """
    d = H.shape[-1]
    if use_cholesky:
        if d == 1:
            h = H[..., 0, 0]
            ok = (h > 0) & jnp.isfinite(h) & jnp.isfinite(b[..., 0])
            dx = jnp.where(ok[..., None], b / jnp.where(h[..., None] == 0, 1, h[..., None]),
                           jnp.zeros_like(b))
            return dx, ok
        L = jnp.linalg.cholesky(H)
        dx = jax.scipy.linalg.cho_solve((L, True), b)
        ok = jnp.all(jnp.isfinite(dx), axis=-1)
        return dx, ok
    else:
        if d == 1:
            eps = float(jnp.finfo(H.dtype).eps) ** 0.5
            h = H[..., 0, 0]
            good = h > eps
            dx = jnp.where(good[..., None], b / jnp.where(good, h, 1.0)[..., None],
                           jnp.zeros_like(b))
            return dx, jnp.ones_like(good)  # always "success" (gn.h:161-163)
        dx = jnp.linalg.solve(H, b)
        return dx, jnp.ones(H.shape[:-2], bool)


def pcg_core(matvec, dinv: jax.Array, b: jax.Array, iters: int
             ) -> jax.Array:
    """Jacobi-preconditioned CG — the ONE implementation every dispatch
    path runs (the plain XLA solve below and the batched-CG Triton
    kernel both call this), so the iterates are structurally identical
    across paths.

    ``matvec``: (..., d) -> (..., d) applying the (damped) normal matrix;
    ``dinv``: inverse of its diagonal (1 where non-positive) — or a
    CALLABLE applying a general preconditioner M⁻¹ (block-Jacobi for
    the Schur reduced solve); ``b``: the right-hand side.  Runs exactly
    ``iters`` iterations — no data-dependent exit, keeping the program
    static for jit/vmap.

    Curvature guard: a direction with non-positive curvature
    (p·Hp ≤ tiny — null space or indefinite damping corner) FREEZES the
    iterate (α = 0) instead of being clamped into a huge garbage step;
    once p is in the null space it stays there, so x keeps the last valid
    value.
    """
    eps = jnp.finfo(b.dtype).tiny
    prec = dinv if callable(dinv) else (lambda r: r * dinv)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = prec(r0)
    rz0 = jnp.sum(r0 * z0, axis=-1)

    def body(_, carry):
        x, r, p, rz = carry
        Hp = matvec(p)
        denom = jnp.sum(p * Hp, -1)
        pos = denom > eps
        alpha = jnp.where(pos,
                          rz / jnp.where(pos, denom, 1.0),
                          jnp.zeros_like(rz))
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Hp
        z = prec(r)
        rz_new = jnp.sum(r * z, -1)
        p = z + (rz_new / jnp.maximum(rz, eps))[..., None] * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x0, r0, z0, rz0))
    return x


def solve_psd_cg(H: jax.Array, b: jax.Array, iters: int) -> jax.Array:
    """Batched conjugate-gradient solve of ``H dx = b``.

    XLA's batched Cholesky of many small matrices is a sequential
    scalar-heavy kernel, while CG is nothing but batched matvecs.  This
    is the plain reference of the batched Triton kernel
    (ops/pallas_cg.py), and its path wherever the kernel is not chosen.
    For LM the solve may be inexact: a poor step is rejected and λ
    escalates, so fixed-iteration CG composes safely with the outer loop
    (inexact/truncated LM).

    ``H``: (..., d, d), ``b``: (..., d).
    """
    def mv(v):
        return jnp.einsum("...ij,...j->...i", H, v)

    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    dinv = jnp.where(diag > 0, 1.0 / jnp.where(diag > 0, diag, 1.0), 1.0)
    return pcg_core(mv, dinv, b, iters)


def inv_cov(H: jax.Array) -> jax.Array:
    """Covariance = H⁻¹ (reference: math.h:88-189). NaNs if singular."""
    d = H.shape[-1]
    return jnp.linalg.solve(H, jnp.broadcast_to(jnp.eye(d, dtype=H.dtype), H.shape))


def cov_rescale(cost, num_residuals, dims):
    """Overdetermined-covariance rescale factor (reference output.h:80-93):
    ``cost² / (num_residuals − dims)`` when num_residuals > dims, else 1.
    Shared by ``Output.covariance(rescaled=True)`` and ``covariance_at``."""
    c = cost
    n = num_residuals
    return jnp.where(n > dims,
                     c * c / jnp.maximum(n - dims, 1).astype(c.dtype),
                     jnp.ones((), c.dtype))


def max_std_dev(H: jax.Array) -> jax.Array:
    """√(max coefficient of H⁻¹) (reference: solvers/gn.h:177-183)."""
    return jnp.sqrt(jnp.max(inv_cov(H), axis=(-2, -1)))


def refine_psd_solve(H: jax.Array, b: jax.Array, x: jax.Array,
                     rounds: int, use_cholesky: bool = True) -> jax.Array:
    """Mixed-precision iterative refinement of an f32 PSD solve.

    Each round computes the residual ``r = b − H·x`` in float64 (one
    matvec; needs ``jax_enable_x64``, else it silently runs in working
    precision and improves nothing) and
    re-solves for the correction at working precision.  Forward error
    contracts by ~eps·cond(H) per round, so a few rounds recover
    near-f64-quality solutions from an f32 factorization whenever
    cond(H) < 1/eps32.  Non-finite corrections are skipped (x kept).
    """
    for _ in range(max(rounds, 0)):
        r = (b.astype(jnp.float64)
             - H.astype(jnp.float64) @ x.astype(jnp.float64)).astype(
                 H.dtype)
        corr, ok = solve_psd(H, r, use_cholesky=use_cholesky)
        x = x + jnp.where(ok, corr, jnp.zeros_like(corr))
    return x
