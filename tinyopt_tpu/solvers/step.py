"""Step proposal for GN / LM / GD.

The "linear-system layer" of the framework: given the accumulated gradient
``g`` (= JᵀR) and Hessian approximation ``H`` (= JᵀJ), propose a step
``dx``.  Functional counterpart of ``SolverGN::Solve`` / ``SolverGD::Solve``
(reference: include/tinyopt/solvers/gn.h:150-171, gd.h:131-134).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..options import SolverType
from ..ops.block import BlockDiag
from ..ops.linalg import damp_diagonal, solve_psd
from ..ops.pallas_cg import make_cg_solver
from ..ops.sparse_sym import SparseSym


@functools.lru_cache(maxsize=None)
def _cg_solver(iters: int):
    return make_cg_solver(iters)


def dogleg_core(g, lam, dx_gn, ok_gn, gHg, solve_reg):
    """Powell dogleg blend from precomputed pieces. Returns (dx, ok).

    Shared by every Hessian representation: the caller supplies the
    (undamped) Gauss-Newton step ``(dx_gn, ok_gn)``, the curvature along
    the gradient ``gHg = gᵀHg``, and ``solve_reg(λ_eff) -> (dx, ok)``
    solving the λ_eff-damped system — dense Cholesky, batched block
    Cholesky, Jacobi-PCG, GN-CG matvecs, or Schur elimination.  The
    regularized fallback solve runs under ``lax.cond``, so the common
    path (sane GN step) pays ONE solve; under vmap the cond lowers to a
    select and both branches run, which is what the batched path did
    anyway.  See :func:`_dogleg_step` for the geometry and the measured
    design rationale.
    """
    dtype = g.dtype
    lam = lam.astype(dtype)
    dx_gn = jnp.where(ok_gn, dx_gn, jnp.zeros_like(dx_gn))
    gg = jnp.vdot(g, g)
    pos_curv = gHg > 0
    alpha = jnp.where(pos_curv, gg / jnp.where(pos_curv, gHg, 1.0), 0.0)
    dx_sd = (-alpha) * g                        # Cauchy point
    n_gn2 = jnp.vdot(dx_gn, dx_gn)
    n_sd2 = jnp.vdot(dx_sd, dx_sd)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    # GN sanity: a numerically "successful" solve of an (exactly)
    # singular H returns a garbage-huge step — blending toward it
    # proposes escape-velocity steps (observed at Jennrich-Sampson's
    # symmetric minimum: a ‖dx‖ = 47 proposal into overflow territory).
    # A GN step more than κ = 1e3 times the Cauchy step is treated as
    # invalid; the proposal then falls back to the regularized step.
    kappa2 = dtype.type(1e6)
    gn_sane = ok_gn & jnp.where(n_sd2 > 0, n_gn2 <= kappa2 * n_sd2,
                                jnp.ones((), bool))
    # Insane/failed GN (singular or near-singular H: measured GN/Cauchy
    # ratios of 1e7-1e11 near Freudenstein-Roth's and Jennrich-Sampson's
    # minima, cond(H) 1e8-1e16): substitute a LEVENBERG step — a damped
    # step is itself a trust-region step (for every λ there is a Δ making
    # them equal, Nocedal & Wright §4.3), and it regularizes exactly
    # where the raw GN direction is garbage.  TWO-STAGE damping: first
    # the schedule's own λ (gauge-singular problems — BA's 7-dim gauge
    # null space has ZERO gradient component, so the lightly-damped step
    # is an LM-grade step; a λ_eff = 1 floor over-damps those into a
    # permanent crawl: measured rmse 4.4e-3 after 30 dogleg iterations
    # vs noise level 1e-4 in 7 LM iterations on a 6-cam BA), and only
    # when that step is itself κ-insane vs the Cauchy scale (truly
    # singular minima where g DOES excite the null space — Jennrich-
    # Sampson) escalate to λ_eff = max(λ, 1), which restores LM-grade
    # convergence where a pure Cauchy fallback crawls.
    dx_r1, ok_r1 = jax.lax.cond(
        gn_sane,
        lambda _: (jnp.zeros_like(dx_gn), jnp.zeros((), bool)),
        lambda le: solve_reg(le),
        lam)
    n_r1_2 = jnp.vdot(dx_r1, dx_r1)
    r1_sane = ok_r1 & jnp.where(n_sd2 > 0, n_r1_2 <= kappa2 * n_sd2,
                                jnp.ones((), bool))
    dx_r2, ok_r2 = jax.lax.cond(
        gn_sane | r1_sane,
        lambda _: (jnp.zeros_like(dx_gn), jnp.zeros((), bool)),
        lambda le: solve_reg(le),
        jnp.maximum(lam, dtype.type(1.0)))
    dx_reg = jnp.where(r1_sane, dx_r1, dx_r2)
    ok_reg = jnp.where(r1_sane, ok_r1, ok_r2)
    dx_reg = jnp.where(ok_reg, dx_reg, dx_sd)
    n_reg2 = jnp.vdot(dx_reg, dx_reg)
    ref2 = jnp.where(gn_sane, n_gn2,
                     jnp.where(ok_reg, n_reg2,
                               jnp.where(pos_curv & (n_sd2 > 0), n_sd2,
                                         gg)))
    radius = jnp.sqrt(jnp.maximum(ref2, tiny)) / lam
    # Gradient branch, clipped to the boundary — but NEVER extended past
    # the Cauchy point (the quadratic model's optimum along −g; going
    # further is model-unjustified).  0·inf-guarded for ‖g‖ underflow.
    bd_len = jnp.where(pos_curv & (n_sd2 > 0),
                       jnp.minimum(radius, jnp.sqrt(n_sd2)), radius)
    dx_bd = jnp.where(gg > 0,
                      -(bd_len / jnp.sqrt(jnp.maximum(gg, tiny))),
                      0.0) * g
    # regularized fallback, radius-clipped
    reg_scale = jnp.minimum(
        1.0, radius / jnp.sqrt(jnp.maximum(n_reg2, tiny)))
    dx_reg = reg_scale * dx_reg
    # two-segment interpolation: ‖dx_sd + τ (dx_gn − dx_sd)‖ = Δ
    dvec = dx_gn - dx_sd
    a = jnp.maximum(jnp.vdot(dvec, dvec), tiny)
    b = 2.0 * jnp.vdot(dx_sd, dvec)
    c = n_sd2 - radius * radius
    disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
    tau = (-b + jnp.sqrt(disc)) / (2.0 * a)
    dx_mid = dx_sd + jnp.clip(tau, 0.0, 1.0) * dvec
    use_gn = gn_sane & (n_gn2 <= radius * radius)
    use_reg = (~gn_sane) & ok_reg
    use_bd = (~use_gn) & (~use_reg) & ((n_sd2 >= radius * radius)
                                       | (~pos_curv) | (~gn_sane))
    dx = jnp.where(use_gn, dx_gn,
                   jnp.where(use_reg, dx_reg,
                             jnp.where(use_bd, dx_bd, dx_mid)))
    return dx, jnp.all(jnp.isfinite(dx))


def _dogleg_step(H, g, lam, opts):
    """Powell dogleg inside trust radius Δ = 1/λ. Returns (dx, ok).

    Classic construction (Powell 1970; Nocedal & Wright §4.1): the
    Gauss-Newton point when it fits, the gradient direction clipped to
    the boundary when even the Cauchy point doesn't, and the two-segment
    interpolation hitting ‖dx‖ = Δ otherwise.  A failed (non-PSD) GN
    solve degrades to the clipped-gradient branch — a valid trust-region
    step, so the iteration proceeds and the accept/reject loop shrinks Δ
    if it was a bad idea.

    The radius is STEP-LENGTH-RELATIVE: Δ = ref/λ, where ref =
    min(‖dx_GN‖, κ·‖dx_Cauchy‖) with κ = 1e3 (falling back to the Cauchy
    length, then ‖g‖, when the GN solve fails).  λ ≤ 1 therefore always
    admits the full GN step when the GN/Cauchy ratio is sane, and the
    first rejection (λ: 1→2) halves THE FAILED STEP — bending the
    direction toward the gradient immediately.  Two simpler radii were
    measured to fail: an absolute Δ = 1/λ (interior GN acceptances leave
    Δ inflated, a later rejection re-probes the identical full GN step
    for many shrink cycles, and the eventual collapse overshoots to
    ~1e-8, where the first accepted step spuriously fires MIN_DELTA_NORM
    — Wood stalled at cost 7.74), and an uncapped Δ = ‖dx_GN‖/λ (at
    Jennrich-Sampson's symmetric minimum H is exactly singular, the
    numeric GN step is garbage-huge, and the blend proposes a ‖dx‖ = 47
    step that escapes to an overflow region; the κ-cap keys the radius
    to the Cauchy scale whenever GN is disproportionate).

    No reference counterpart (the reference skips trust region,
    tests/optimize_hard.cpp:289-295); the λ machinery this rides is
    lm.h:123-154.

    Dispatches on the Hessian representation: dense arrays (Cholesky),
    :class:`BlockDiag` (batched block Cholesky), :class:`SparseSym`
    (Jacobi-PCG) — all through :func:`dogleg_core`.
    """
    if isinstance(H, BlockDiag):
        dx_gn, ok_gn = H.solve(-g, use_cholesky=opts.hessian.use_ldlt)
        return dogleg_core(
            g, lam, dx_gn, ok_gn, jnp.vdot(g, H.matvec(g)),
            lambda le: H.damp(le).solve(
                -g, use_cholesky=opts.hessian.use_ldlt))
    if isinstance(H, SparseSym):
        iters = opts.hessian.cg_iters
        dx_gn, ok_gn = H.solve(-g, cg_iters=iters)
        return dogleg_core(
            g, lam, dx_gn, ok_gn, jnp.vdot(g, H.matvec(g)),
            lambda le: H.damp(le).solve(-g, cg_iters=iters))
    if opts.hessian.solver == "cg":
        iters = opts.hessian.cg_iters or g.shape[-1]
        cg = _cg_solver(iters)

        def _cg_ok(Hm):
            dx = cg(Hm, -g)
            return dx, jnp.all(jnp.isfinite(dx))

        dx_gn, ok_gn = _cg_ok(H)
        return dogleg_core(
            g, lam, dx_gn, ok_gn, jnp.vdot(g, H @ g),
            lambda le: _cg_ok(damp_diagonal(H, le)))
    dx_gn, ok_gn = solve_psd(H, -g, use_cholesky=opts.hessian.use_ldlt)
    return dogleg_core(
        g, lam, dx_gn, ok_gn, jnp.vdot(g, H @ g),
        lambda le: solve_psd(damp_diagonal(H, le), -g,
                             use_cholesky=opts.hessian.use_ldlt))


def propose_step(H, g, lam, opts):
    """Propose dx for the current (H, g, λ). Returns (dx, ok).

    * GD:     dx = -lr · g, always succeeds.
    * GN/LM:  solve (H ⊕ λ·diag) dx = -g via Cholesky (λ = 0 for GN);
              failure (non-PSD) reported through ``ok`` for λ-escalation.
    * DOGLEG: Powell dogleg within trust radius 1/λ.

    ``H`` may be a dense (d, d) array, a :class:`BlockDiag` (all blocks
    solved with one batched Cholesky), or a :class:`SparseSym`
    (Jacobi-PCG) — every solver type covers all three representations.
    """
    if opts.solver_type == SolverType.GRADIENT_DESCENT:
        dx = -g.dtype.type(opts.gd.lr) * g
        return dx, jnp.ones((), bool)
    if opts.solver_type == SolverType.DOGLEG:
        return _dogleg_step(H, g, lam, opts)
    is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
    if isinstance(H, BlockDiag):
        Hd = H.damp(lam) if is_lm else H
        return Hd.solve(-g, use_cholesky=opts.hessian.use_ldlt)
    if isinstance(H, SparseSym):
        # General sparse normal equations (the reference's SimplicialLDLT
        # path, gn.h:154-156) -> Jacobi-preconditioned CG.
        Hd = H.damp(lam) if is_lm else H
        return Hd.solve(-g, cg_iters=opts.hessian.cg_iters)
    Hd = damp_diagonal(H, lam) if is_lm else H
    # "cg": one batched call under vmap (ops/pallas_cg.make_cg_solver).
    if opts.hessian.solver == "cg":
        iters = opts.hessian.cg_iters or g.shape[-1]
        dx = _cg_solver(iters)(Hd, -g)
        return dx, jnp.all(jnp.isfinite(dx))
    dx, ok = solve_psd(Hd, -g, use_cholesky=opts.hessian.use_ldlt)
    return dx, ok
