"""The outer optimization loop as a single jitted ``lax.while_loop``.

This is the JAX re-design of ``Optimizer_::OptimizeAcc`` / ``Step``
(reference: include/tinyopt/optimizers/optimizer.h:243-534).  The reference
drives a data-dependent accept/reject loop with rollback-by-negation and an
inner solve-retry loop with λ escalation; here the whole control flow is
compiled once by XLA:

  * outer iteration  -> ``lax.while_loop`` body
  * build-vs-evaluate (the ``Rebuild(false)`` skip-re-accumulation
    optimization, lm.h:96-105)           -> ``lax.cond``
  * solve-retry with λ escalation
    (optimizer.h:356-399)                -> inner ``lax.while_loop``
    (re-damp + re-solve only; re-accumulating identical H/g, as the
    reference does, would be pure waste under XLA)
  * rollback ``x ⊞ (−last_dx)``
    (optimizer.h:283-287)                -> single masked ``retract``

Semantics preserved exactly (see tests/test_basic.py for the behavioral
spec): stop-reason codes and their priorities, λ schedule including
compounded bad factors, failure budgets, first-iteration auto-accept,
check_final_cost extra evaluation, and the final un-damped Hessian save.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from .. import manifold as mf
from ..cost import Cost, normalize_cost
from ..options import (FIRST_ORDER_TYPES, LAMBDA_SCHEDULED_TYPES,
                       Options, SolverType, is_stateful_fo)
from ..output import Output
from ..solvers.first_order import fo_init, fo_on_build, fo_propose
from ..solvers.lm import (LMState, lm_init, lm_good_step, lm_bad_step,
                          lm_failed_step, tr_bad_step)
from ..solvers.step import propose_step
from ..stop_reasons import StopReason

_I32 = jnp.int32

_CB_OK: bool | None = None


def _callbacks_supported() -> bool:
    """Whether the default backend supports host callbacks.

    A PJRT backend that rejects host send/recv callbacks would make
    ``jax.debug.print`` iteration logging crash the whole solve.  Probe
    once and degrade to silent (``Output.log_dropped`` records it).
    """
    global _CB_OK
    if _CB_OK is None:
        import warnings
        try:
            # Probe rules:
            # * print a TRACED value — a constant/empty print can be
            #   folded away and "succeed" on a backend that rejects the
            #   actual host send/recv;
            # * force a VALUE read from the same program — a rejection
            #   can be raised asynchronously and would otherwise surface
            #   inside the NEXT dispatched computation.
            def _p(v):
                jax.debug.print("{v}", v=v, ordered=False)
                return v + 1.0
            # ensure_compile_time_eval: the first probe call often happens
            # while TRACING a jitted solve — float() of a nested-jit
            # result would be a ConcretizationTypeError there.
            with jax.ensure_compile_time_eval():
                float(jax.jit(_p)(jnp.zeros(())))
            jax.effects_barrier()
            _CB_OK = True
        except Exception as e:  # noqa: BLE001 - any backend failure = "no"
            warnings.warn(
                "tinyopt_tpu: this JAX backend does not support host "
                "callbacks; per-iteration logging (options.log.enable) is "
                f"disabled. Probe failure: {type(e).__name__}: "
                f"{str(e)[:200]}", RuntimeWarning)
            _CB_OK = False
    return _CB_OK


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class _Carry:
    x: Any                      # parameter pytree (current candidate)
    fo: Any                     # first-order solver state (momentum /
                                # moment estimates / L-BFGS curvature
                                # pairs), () for GD/GN/LM; learns from
                                # every evaluation (parameters move only
                                # on accepted steps, the state is not so
                                # constrained — see solvers/first_order)
    best_x: Any                 # last accepted parameters (exact rollback
                                # target; the reference rolls back by
                                # retracting -last_dx (optimizer.h:283-287),
                                # which is inexact in floating point and can
                                # turn a re-evaluation at the "same" point
                                # into a spurious 1-ulp improvement — a copy
                                # is free in functional JAX, so we keep one)
    H: Any                      # (d, d) un-damped JtJ, or None (first-order)
    g: jax.Array                # (d,) gradient JtR
    lm: LMState                 # damping state (unused for GN/GD)
    best_cost: jax.Array        # last accepted cost (inf before first eval)
    best_num_res: jax.Array     # int32
    best_inliers: jax.Array     # f32
    final_rerr: jax.Array       # last relative error decrease
    last_dx: jax.Array          # (d,)
    has_last_dx: jax.Array      # bool
    last_was_success: jax.Array # bool
    rebuild: jax.Array          # bool: re-accumulate vs evaluate-only
    it: jax.Array               # int32 == num_iters
    num_failures: jax.Array     # int32
    num_consec: jax.Array       # int32
    stop: jax.Array             # int32 StopReason
    errs: jax.Array             # (cap,)
    deltas2: jax.Array          # (cap,)
    succ: jax.Array             # (cap,) bool
    num_hist: jax.Array         # int32


class _RetryState(NamedTuple):
    dx: jax.Array
    ok: jax.Array
    lm: LMState
    num_failures: jax.Array
    num_consec: jax.Array
    give_up: jax.Array


def _solve_with_retries(H, g, lm_state, c, extra_ok, opts,
                        propose=propose_step):
    """Inner retry loop: propose, and on failure escalate λ and retry.

    Mirrors optimizer.h:356-399 with FailedStep = λ escalation (LM) or
    no-op (GN/GD).  ``extra_ok`` folds in build-validity checks (e.g. the
    min-H-diagonal check, lm.h:83-88) that the reference treats as solver
    failures.
    """
    max_tries = opts.max_consec_failures if opts.max_consec_failures > 0 else 255
    # λ escalation applies to LM (damping) and DOGLEG (1/Δ: a failed
    # proposal shrinks the trust radius, the canonical TR response).
    is_lm = opts.solver_type in LAMBDA_SCHEDULED_TYPES

    def cond(s: _RetryState):
        return (~s.ok) & (~s.give_up) & (s.num_consec <= max_tries)

    def body(s: _RetryState):
        dx, ok = propose(H, g, s.lm.lam, opts)
        ok = ok & extra_ok
        nf = s.num_failures + jnp.where(ok, 0, 1).astype(_I32)
        nc = s.num_consec + jnp.where(ok, 0, 1).astype(_I32)
        give_up = (~ok) & (opts.max_consec_failures > 0) & (
            nc >= opts.max_consec_failures)
        if opts.solver_type == SolverType.DOGLEG:
            new_lm = tr_bad_step(s.lm, opts)       # fixed shrink, see lm.py
        elif is_lm:
            new_lm = lm_failed_step(s.lm, opts)
        else:
            new_lm = s.lm
        lm_state2 = jax.tree_util.tree_map(
            lambda a, b: jnp.where((~ok) & (~give_up), a, b), new_lm, s.lm)
        return _RetryState(dx=jnp.where(ok, dx, s.dx), ok=ok, lm=lm_state2,
                           num_failures=nf, num_consec=nc, give_up=give_up)

    init = _RetryState(
        dx=jnp.zeros_like(g), ok=jnp.zeros((), bool), lm=lm_state,
        num_failures=c.num_failures, num_consec=c.num_consec,
        give_up=jnp.zeros((), bool))
    return jax.lax.while_loop(cond, body, init)


def _where_tree(pred, a, b):
    return jax.tree_util.tree_map(lambda u, v: jnp.where(pred, u, v), a, b)


def optimize_from_acc(
    x0,
    accumulate: Callable[[Any], tuple],
    evaluate: Callable[[Any], Cost],
    options: Options,
    spec: mf.TangentSpec | None = None,
    num_diff_used: bool = False,
    propose: Callable = propose_step,
    warm_start: tuple | None = None,
    segment_state: "_Carry | None" = None,
    return_state: bool = False,
):
    """Run the full optimization loop. Pure function: (x0) -> (x_opt, Output).

    ``accumulate(x) -> (H, g, Cost)`` builds the normal equations (H is None
    for first-order solvers); ``evaluate(x) -> Cost`` computes the cost only
    (used after consecutive rejections, mirroring ``Rebuild(false)``).

    ``H`` may be any pytree the ``propose`` function understands: a dense
    (d, d) array, a :class:`~tinyopt_tpu.ops.block.BlockDiag`, or a custom
    representation paired with a custom ``propose(H, g, λ, opts)`` (e.g.
    the matrix-free GN-CG path in ``tinyopt_tpu.sparse``).

    ``warm_start=(g0, H0)`` seeds the normal equations so the first
    iteration evaluates the cost only instead of re-accumulating — the
    reference's ``InitWith`` (optimizer.h:46-55).  ``H0`` is ignored for
    first-order solvers.

    Segmented execution (the host-chunked timeout driver): pass
    ``return_state=True`` to additionally return the final loop carry, and
    ``segment_state=<carry>`` to RESUME from it with full state continuity
    (λ schedule including compounded bad factors, accept/reject state,
    failure budgets, Rebuild(false) flags).  In segment mode
    (``segment_state is not None`` or ``return_state``) the loop runs
    exactly ``options.max_iters`` iterations per call — the +1 rollback
    and check_final_cost allowances are the driver's responsibility.
    Acceptance does not depend on the segment-local iteration index (the
    first-evaluation auto-accept keys on "no finite best cost yet"), so a
    resumed segment behaves identically to the same iterations of one
    uninterrupted loop.

    jit/vmap/shard-friendly: all shapes static, control flow in lax.
    """
    opts = options
    first_order = opts.solver_type in FIRST_ORDER_TYPES
    fo_stateful = is_stateful_fo(opts)
    is_adamw = opts.solver_type == SolverType.ADAMW
    # GoodStep/BadStep λ updates: LM damping, or DOGLEG's inverse trust
    # radius (good step → λ↓ → Δ↑, rejection → λ↑ → Δ↓, lm.h:123-145).
    is_lm = opts.solver_type in LAMBDA_SCHEDULED_TYPES
    # carry_H=False: re-accumulate instead of carrying the (large) H
    # through the while-loop carry (see HessianOptions.carry_system).
    carry_H = (not first_order) and opts.hessian.carry_system
    if (not first_order) and (not carry_H) and opts.hessian.save_last:
        raise ValueError(
            "hessian.carry_system=False cannot save the final Hessian; "
            "set hessian.save_last=False as well")
    if (not carry_H) and (not first_order) and warm_start is not None:
        raise ValueError(
            "warm_start requires hessian.carry_system=True (the seeded "
            "system lives in the loop carry)")

    if spec is None:
        spec = mf.tangent_spec(x0)
    d = spec.dims
    dtype = spec.dtype

    # AdamW's decoupled decay pulls parameters toward the origin — only
    # meaningful when the tangent IS the parameter vector (Euclidean),
    # so reject any registered-manifold leaf exactly (not by a size
    # heuristic: a manifold can have ambient size == tangent dims).
    if is_adamw and opts.adam.weight_decay > 0:
        leaves, _ = mf._leaves(x0)
        if any(mf._is_manifold_leaf(l) for l in leaves):
            raise ValueError(
                "AdamW weight decay requires pure-Euclidean parameters "
                "(decay toward the origin is undefined on a manifold); "
                "use SolverType.ADAM or weight_decay=0")

    def _x_flat(x):
        parts = [jnp.ravel(jnp.asarray(l)).astype(dtype)
                 for l in jax.tree_util.tree_leaves(x)]
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)

    segmented = return_state or (segment_state is not None)
    if segmented:
        # Exactly max_iters iterations per segment; allowances are the
        # driver's job (optimize._optimize_with_timeout).
        max_iters_total = opts.max_iters
    else:
        max_iters_total = opts.max_iters + 1 \
            + (1 if opts.check_final_cost else 0)
    # history capacity: ≤1 entry per outer iteration; 0 disables recording
    cap = max_iters_total if opts.save_history else 0

    # ---- Degenerate problems: nothing to optimize (optimizer.h:63-70) ----
    if d == 0:
        out = _skipped_output(cap, dtype, num_diff_used)
        return (x0, out, None) if return_state else (x0, out)

    big = jnp.asarray(jnp.inf, dtype)

    def init_carry(x0):
        if first_order or not carry_H:
            H0 = None
        else:
            # The H representation is whatever accumulate produces (dense
            # array, BlockDiag, linearization-point pytree, ...).
            H_shape = jax.eval_shape(accumulate, x0)[0]
            H0 = jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype), H_shape)
        g0 = jnp.zeros((d,), dtype)
        if warm_start is not None:
            g0 = jnp.asarray(warm_start[0], dtype)
            if carry_H and len(warm_start) > 1 \
                    and warm_start[1] is not None:
                H0 = jax.tree_util.tree_map(
                    lambda z, w: jnp.asarray(w, z.dtype), H0, warm_start[1])
        return _Carry(
            x=x0, fo=fo_init(opts, x0, spec), best_x=x0, H=H0, g=g0,
            lm=lm_init(opts, dtype),
            best_cost=big, best_num_res=jnp.zeros((), _I32),
            best_inliers=jnp.ones((), jnp.float32),
            final_rerr=jnp.asarray(jnp.inf, dtype),
            last_dx=jnp.zeros((d,), dtype),
            has_last_dx=jnp.zeros((), bool),
            last_was_success=jnp.ones((), bool),
            rebuild=jnp.asarray(warm_start is None),
            it=jnp.zeros((), _I32),
            num_failures=jnp.zeros((), _I32), num_consec=jnp.zeros((), _I32),
            stop=jnp.full((), int(StopReason.NONE), _I32),
            errs=jnp.zeros((cap,), dtype), deltas2=jnp.zeros((cap,), dtype),
            succ=jnp.zeros((cap,), bool), num_hist=jnp.zeros((), _I32),
        )

    def build_branch(x):
        H, g, cost = accumulate(x)
        cost = normalize_cost(cost, opts.cost)
        # Gradient clipping happens at build time, before the solve
        # (reference: solvers/base.h:29-38 via gn.h:129).
        if opts.grad_clipping > 0:
            v = dtype.type(opts.grad_clipping)
            g = jnp.clip(g, -v, v)
        if first_order:
            H = None
        return H, g, cost

    def eval_branch(c: _Carry):
        cost = normalize_cost(evaluate(c.x), opts.cost)
        return c.H, c.g, cost

    def body(c: _Carry) -> _Carry:
        it = c.it
        # --- Build or evaluate-only (lm.h:60-105) ---
        if carry_H or first_order:
            H, g, cost = jax.lax.cond(
                c.rebuild,
                lambda c: build_branch(c.x),
                eval_branch,
                c,
            )
        else:
            # No-carry mode: always re-accumulate at the current point.
            # After a rejection+rollback this re-linearizes at the best
            # point (same system the carry mode re-damps); on rejection-free
            # runs the trajectory is identical to carry mode.  During
            # consecutive-rejection probing it linearizes at the probe
            # instead of reusing the stale Rebuild(false) system — a
            # deliberate deviation (fresher system, no carried H).
            H, g, cost = build_branch(c.x)
        err = cost.cost.astype(dtype)
        n_res = cost.num_residuals

        # --- Build validity (lm.h:83-88): min |H[i,i]| check ---
        if (not first_order) and opts.hessian.check_min_H_diag > 0:
            diag = (H.diagonal() if hasattr(H, "diagonal")
                    else jnp.diagonal(H))
            diag_ok = jnp.all(jnp.abs(diag) >= opts.hessian.check_min_H_diag)
        else:
            diag_ok = jnp.ones((), bool)

        # --- Inner solve-retry loop with λ escalation ---
        if fo_stateful:
            # Stateful first-order proposal: no solve to retry (like GD,
            # the step always "succeeds"; non-finite steps are routed by
            # the NaN checks below exactly as for GD).  Secant-pair /
            # (x_prev, g_prev) bookkeeping applies only on REBUILD
            # iterations — eval-only iterations carry a stale gradient
            # that must not be attributed to the current point.  The
            # proposed state is committed unconditionally (see
            # solvers/first_order module docstring).
            fo_b = _where_tree(c.rebuild,
                               fo_on_build(opts, c.fo, g, c.x, spec),
                               c.fo)
            dx, fo_new = fo_propose(opts, fo_b, g, c.lm,
                                    _x_flat(c.x) if is_adamw else None)
            rs = _RetryState(dx=dx, ok=jnp.ones((), bool), lm=c.lm,
                             num_failures=c.num_failures,
                             num_consec=c.num_consec,
                             give_up=jnp.zeros((), bool))
        else:
            fo_new = c.fo
            rs = _solve_with_retries(H, g, c.lm, c, diag_ok, opts, propose)
        dx, solved = rs.dx, rs.ok
        lm_state = rs.lm

        # --- Early failure routing (optimizer.h:364-409) ---
        # A non-finite gradient means the *system* is broken, not the
        # factorization: the reference reaches the same verdict through its
        # NaN check on |dx|² (optimizer.h:415-425).
        err_bad = (jnp.isnan(err) | jnp.isinf(err)
                   | ~jnp.all(jnp.isfinite(g)))
        no_res = n_res <= 0
        stop_early = jnp.where(
            solved,
            jnp.where(err_bad, int(StopReason.SYSTEM_HAS_NAN_OR_INF),
                      int(StopReason.NONE)),
            jnp.where(no_res, int(StopReason.SKIPPED),
                      jnp.where(err_bad, int(StopReason.SYSTEM_HAS_NAN_OR_INF),
                                int(StopReason.SOLVER_FAILED))),
        ).astype(_I32)
        dx_norm2 = jnp.sum(dx * dx)
        dxn_bad = jnp.isnan(dx_norm2) | jnp.isinf(dx_norm2)
        stop_early = jnp.where(
            (stop_early == 0) & dxn_bad,
            int(StopReason.SYSTEM_HAS_NAN_OR_INF), stop_early).astype(_I32)
        early_fail = stop_early != 0

        # --- Accept / reject (optimizer.h:427-459) ---
        derr = err - c.best_cost
        is_good = derr < 0
        # FloatEpsilon guard (reference: math.h:297-301 — 1e-7 for f64,
        # 1e-4 for f32), matching the reference's rel_derr zeroing exactly.
        from ..utils import float_epsilon
        eps = dtype.type(float_epsilon(dtype))
        rel_derr = jnp.where(
            (c.best_cost > eps) & jnp.isfinite(c.best_cost),
            (c.best_cost - err) / c.best_cost, dtype.type(0))
        # First evaluation is auto-accepted ("we guess it's a good step in
        # the first iteration", optimizer.h:441); keyed on "no finite best
        # cost yet" rather than the iteration index so resumed segments
        # don't re-trigger it.
        first_eval = ~jnp.isfinite(c.best_cost)
        good = is_good | first_eval

        # History (appended only when the step wasn't an early failure)
        if opts.save_history:
            errs = c.errs.at[it].set(jnp.where(early_fail, c.errs[it], err))
            deltas2 = c.deltas2.at[it].set(
                jnp.where(early_fail, c.deltas2[it], dx_norm2))
            succ = c.succ.at[it].set(
                jnp.where(early_fail, c.succ[it], is_good))
            num_hist = jnp.where(early_fail, c.num_hist, it + 1).astype(_I32)
        else:
            errs, deltas2, succ = c.errs, c.deltas2, c.succ
            num_hist = jnp.zeros((), _I32)

        # λ schedule (lm.h:123-145); first iteration is auto-accepted but
        # does NOT trigger GoodStep (optimizer.h:441).  Stateful
        # first-order methods ride the same schedule: the compounding
        # bad_factor halves their step on every consecutive rejection and
        # resets on acceptance (solvers/first_order.fo_propose) — without
        # it a rejected fixed-lr proposal would be re-proposed verbatim
        # forever.
        if is_lm or fo_stateful:
            # DOGLEG ignores the quality heuristic: lm.h's "low-quality
            # good step still raises λ" rule shrinks a trust RADIUS
            # exponentially through slow-progress valleys (observed: Wood
            # stalls at cost 7.7); classic dogleg grows Δ on every
            # accepted step and shrinks only on rejection.
            use_q = (opts.use_step_quality_approx
                     and opts.solver_type != SolverType.DOGLEG)
            quality = rel_derr if use_q else jnp.zeros((), dtype)
            lm_good = lm_good_step(lm_state, quality, opts)
            lm_bad = (tr_bad_step(lm_state, opts)
                      if opts.solver_type == SolverType.DOGLEG
                      else lm_bad_step(lm_state, opts))
            apply_good = (~early_fail) & good & (~first_eval)
            apply_bad = (~early_fail) & (~good)
            lm_state = _where_tree(
                apply_good, lm_good, _where_tree(apply_bad, lm_bad, lm_state))

        accepted = (~early_fail) & good
        rejected = (~early_fail) & (~good)
        # Solve retries already incremented the counters inside ``rs``; a
        # rejected step adds one more, an accepted step resets consec to 0
        # (optimizer.h:441-448).
        num_consec = jnp.where(accepted, 0,
                               rs.num_consec + jnp.where(rejected, 1, 0)
                               ).astype(_I32)
        num_failures = (rs.num_failures + jnp.where(rejected, 1, 0)).astype(_I32)

        best_cost = jnp.where(accepted, err, c.best_cost)
        best_num_res = jnp.where(accepted, n_res, c.best_num_res).astype(_I32)
        best_inliers = jnp.where(accepted, cost.inlier_ratio, c.best_inliers)
        final_rerr = jnp.where(accepted, rel_derr, c.final_rerr)

        # Failure budgets (optimizer.h:450-459) — early return, no dx applied
        budget_stop = jnp.where(
            rejected & (opts.max_consec_failures > 0)
            & (num_consec >= opts.max_consec_failures),
            int(StopReason.MAX_CONSEC_NO_DECR),
            jnp.where(
                rejected & (opts.max_total_failures > 0)
                & (num_failures >= opts.max_total_failures),
                int(StopReason.MAX_NO_DECR), int(StopReason.NONE))).astype(_I32)
        budget_fail = (stop_early == 0) & (budget_stop != 0)

        # --- Stop-criteria cascade (optimizer.h:518-534) ---
        grad_norm2 = jnp.sum(g * g)
        cascade = jnp.zeros((), _I32)

        def set_if(cascade, pred, code):
            return jnp.where((cascade == 0) & pred, code, cascade).astype(_I32)

        if opts.min_error > 0:
            cascade = set_if(cascade, err < opts.min_error,
                             int(StopReason.MIN_ERROR))
        if opts.min_rerr_dec > 0:
            # Floor at a few machine eps: under XLA's excess-precision
            # fusion, (err - best) can be ±1 ulp even for bit-identical
            # operands (observed under vmap on CPU), and a noise-scale
            # "decrease" must not read as convergence.
            noise = dtype.type(8) * jnp.finfo(dtype).eps
            cascade = set_if(
                cascade,
                (rel_derr > noise) & (rel_derr < opts.min_rerr_dec),
                int(StopReason.MIN_REL_ERROR))
        if opts.min_step_norm2 > 0:
            cascade = set_if(cascade, dx_norm2 < opts.min_step_norm2,
                             int(StopReason.MIN_DELTA_NORM))
        if opts.min_grad_norm2 > 0:
            cascade = set_if(cascade, grad_norm2 < opts.min_grad_norm2,
                             int(StopReason.MIN_GRAD_NORM))
        if opts.stop_callback is not None:
            cascade = set_if(cascade,
                             jnp.asarray(opts.stop_callback(err, dx_norm2, grad_norm2)),
                             int(StopReason.USER_STOPPED))
        if opts.stop_callback2 is not None:
            cascade = set_if(cascade, jnp.asarray(opts.stop_callback2(err, dx, g)),
                             int(StopReason.USER_STOPPED))

        stop = jnp.where(stop_early != 0, stop_early,
                         jnp.where(budget_stop != 0, budget_stop, cascade)
                         ).astype(_I32)

        # --- Apply / rollback (optimizer.h:266-299) ---
        returned_dx = (~early_fail) & (~budget_fail)
        success = accepted & returned_dx
        # failure && has_last  -> rollback by -last_dx
        # failure && !has_last && returned_dx -> probe x+dx (consecutive
        #   rejections: evaluate the new λ's step from the last good point)
        fail = ~success
        probe = fail & (~c.has_last_dx) & returned_dx
        # Rollback restores best_x exactly (not x ⊞ (−last_dx)); the probe
        # case (consecutive rejections: try the new λ's step from the last
        # good point) has c.x == best_x already, so one retract covers all.
        x_base = _where_tree(fail & c.has_last_dx, c.best_x, c.x)
        # Terminal success (cascade stop) OR the final iteration: freeze x
        # at the point whose error was just evaluated instead of applying
        # one more UNEVALUATED proposal.  The returned x then always
        # carries an evaluated cost consistent with Output.final_cost —
        # the reference evaluates after applying, so its returned x is
        # likewise always an evaluated point; its check_final_cost
        # (options.h:43) is exactly this final evaluate-and-roll-back,
        # which the accept/reject of the last iteration performs here.
        # (For GN/LM the trailing dx is ~0 at convergence; for
        # first-order solvers a stale-gradient proposal can be large.)
        # Segment mode is exempt: a segment boundary is not a stop, the
        # trailing proposal is evaluated by the next segment, and the
        # segment DRIVER performs the final evaluation host-side.
        is_last = (it + 1) >= max_iters_total      # THIS iter is the final
        next_is_last = (it + 2) >= max_iters_total  # the NEXT one will be
        apply_gate = jnp.zeros((), bool) if segmented else is_last
        applied = jnp.where((success | probe) & (cascade == 0)
                            & ~apply_gate, dx, jnp.zeros_like(dx))
        x_new = mf.retract(x_base, applied, spec)
        best_x_new = _where_tree(success, c.x, c.best_x)
        last_dx = jnp.where(success | probe, dx, c.last_dx)
        has_last = jnp.where(success, True,
                             jnp.where(c.has_last_dx, False, probe))

        # eval_only / rebuild flags (optimizer.h:277-299).  The
        # check_final_cost extra iteration must be EVALUATE-only — its
        # rebuild flag is consumed by the NEXT iteration, so it is set
        # when the next iteration is the final one (setting it on the
        # final iteration itself is dead: the loop cond exits before the
        # flag is read, the check evaluation paid a full accumulation,
        # and in carry mode the saved H/g described the possibly-rejected
        # check point instead of the last build).
        eval_only = jnp.where(
            success,
            opts.check_final_cost & next_is_last,
            ~c.last_was_success)
        rebuild = ~eval_only
        last_was_success = success

        if opts.log.print_failure and _callbacks_supported():
            # Failure dump (reference optimizer.h print_failure block):
            # on a NaN/Inf or solver failure, show the step/gradient the
            # failing iteration produced.  Printed only when the
            # iteration actually failed (cond guards the host callback).
            jax.lax.cond(
                early_fail,
                lambda a: jax.debug.print(
                    "FAILURE #{it} stop:{stop} |dx|²:{d:.3e} |∇|²:{g:.3e} "
                    "ε:{e:.3e} dx:{dx} grad:{gr}",
                    it=a[0], stop=a[1], d=a[2], g=a[3], e=a[4], dx=a[5],
                    gr=a[6], ordered=False),
                lambda a: None,
                (it, stop_early, dx_norm2, jnp.sum(g * g), err, dx, g))

        if opts.log.enable and _callbacks_supported():
            fmt = ("#{it} ok:{g} " + opts.log.e + ":{err:.4e} n:{n} "
                   "d:{derr:+.2e} r:{rel:+.1e} |dx|:{dxn:.2e} "
                   "|grad|:{gn:.2e} 1/lam:{il:.2e}")
            kw = dict(it=it, g=good, err=err, n=n_res,
                      derr=jnp.where(first_eval, 0.0, derr), rel=rel_derr,
                      dxn=jnp.sqrt(dx_norm2), gn=jnp.sqrt(grad_norm2),
                      il=1.0 / jnp.maximum(lm_state.lam, 1e-30))
            if opts.log.print_x:
                fmt += " x:{x}"
                kw["x"] = mf.flatten_values(x_new)
            if opts.log.print_dx:
                fmt += " dx:{dx}"
                kw["dx"] = dx
            if opts.log.print_inliers:
                fmt += " in:{inl:.1%}"
                kw["inl"] = cost.inlier_ratio
            if (opts.log.print_max_stdev and (not first_order)
                    and isinstance(H, jax.Array)):
                from ..ops.linalg import max_std_dev
                fmt += " sigma:{sd:.2e}"
                kw["sd"] = max_std_dev(H)
            if not (opts.log.print_emoji or opts.log.print_t):
                jax.debug.print(fmt, ordered=False, **kw)
            else:
                # Emoji status and the τ clock are host-side decisions:
                # route through jax.debug.callback and format there.
                # τ = host ms since this executable last saw iteration 0
                # (the reference's cumulative duration_ms, optimizer.h:513).
                pe, pt = opts.log.print_emoji, opts.log.print_t
                tfmt = fmt + (" τ:{tau:.2f}" if pt else "")
                tstate = {"t0": None}

                def _emit_line(_first, _good, **kv):
                    import time as _time
                    now = _time.perf_counter()
                    if tstate["t0"] is None or int(kv["it"]) == 0:
                        tstate["t0"] = now
                    if pt:
                        kv["tau"] = (now - tstate["t0"]) * 1e3
                    line = tfmt.format(**kv)
                    if pe:
                        emo = ("ℹ️" if bool(_first)
                               else ("✅" if bool(_good) else "❌"))
                        line = emo + " " + line
                    print(line, flush=True)

                jax.debug.callback(_emit_line, first_eval, good,
                                   ordered=False, **kw)

        return _Carry(
            x=x_new,
            fo=fo_new,
            best_x=best_x_new,
            H=H if (carry_H or first_order) else None, g=g, lm=lm_state,
            best_cost=best_cost, best_num_res=best_num_res,
            best_inliers=best_inliers, final_rerr=final_rerr,
            last_dx=last_dx, has_last_dx=has_last,
            last_was_success=last_was_success, rebuild=rebuild,
            it=(it + 1).astype(_I32),
            num_failures=num_failures, num_consec=num_consec,
            stop=stop, errs=errs, deltas2=deltas2, succ=succ,
            num_hist=num_hist,
        )

    def cond(c: _Carry):
        return (c.stop == int(StopReason.NONE)) & (c.it < max_iters_total)

    if segment_state is not None:
        # Resume: segment-local fields reset, solver/acceptance state kept.
        carry0 = dataclasses.replace(
            segment_state,
            it=jnp.zeros((), _I32),
            stop=jnp.full((), int(StopReason.NONE), _I32),
            errs=jnp.zeros((cap,), dtype),
            deltas2=jnp.zeros((cap,), dtype),
            succ=jnp.zeros((cap,), bool),
            num_hist=jnp.zeros((), _I32),
        )
    else:
        carry0 = init_carry(x0)
    carry = jax.lax.while_loop(cond, body, carry0)

    stop = jnp.where(carry.stop == int(StopReason.NONE),
                     int(StopReason.MAX_ITERS), carry.stop).astype(_I32)

    final_hessian = None
    if (not first_order) and opts.hessian.save_last:
        final_hessian = carry.H

    out = Output(
        final_cost=Cost(cost=carry.best_cost,
                        num_residuals=carry.best_num_res,
                        inlier_ratio=carry.best_inliers),
        final_rerr_dec=carry.final_rerr,
        stop_reason=stop,
        num_iters=carry.it,
        num_failures=carry.num_failures,
        num_consec_failures=carry.num_consec,
        duration_ms=jnp.zeros((), jnp.float32),
        final_grad=carry.g,
        final_hessian=final_hessian,
        final_lambda=carry.lm.lam,
        errs=carry.errs, deltas2=carry.deltas2, successes=carry.succ,
        num_hist=carry.num_hist,
        num_diff_used=num_diff_used,
        log_dropped=bool((opts.log.enable or opts.log.print_failure)
                         and not _callbacks_supported()),
    )
    if return_state:
        return carry.x, out, carry
    return carry.x, out


def _skipped_output(cap, dtype, num_diff_used):
    return Output(
        final_cost=Cost.make(jnp.inf, 0, 1.0),
        final_rerr_dec=jnp.asarray(jnp.inf, dtype),
        stop_reason=jnp.full((), int(StopReason.SKIPPED), _I32),
        num_iters=jnp.zeros((), _I32),
        num_failures=jnp.zeros((), _I32),
        num_consec_failures=jnp.zeros((), _I32),
        duration_ms=jnp.zeros((), jnp.float32),
        final_grad=None, final_hessian=None,
        errs=jnp.zeros((cap,), dtype), deltas2=jnp.zeros((cap,), dtype),
        successes=jnp.zeros((cap,), bool), num_hist=jnp.zeros((), _I32),
        num_diff_used=num_diff_used,
    )
