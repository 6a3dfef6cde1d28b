"""Public API: ``optimize(x, fn, options)``.

Functional counterpart of the reference's free function
``tinyopt::Optimize(x, func, options)`` (reference:
include/tinyopt/optimize.h:17-79): dispatches on what ``fn`` computes —

  * residuals pytree (NLLS)            -> AD path (LM/GN)
  * scalar cost                        -> AD path (GD) or NLLS with 1 residual
  * ``(cost, grad)`` tuple             -> manual first-order acc
  * ``(cost, grad, H)`` tuple          -> manual second-order acc

and returns ``(x_opt, Output)`` instead of mutating ``x`` in place.

The solve itself is a pure jitted function; compiled executables are cached
keyed on (fn, options, mode, input structure/shapes/dtypes) so repeated
solves of same-shaped problems hit the XLA compilation cache — the
shape-specialized analogue of the reference's template instantiation.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import jax
import jax.numpy as jnp

from . import manifold as mf
from .diff.auto import make_acc_system, make_cost_system, make_nlls_system
from .diff.num_diff import Method, make_num_diff_system
from .optimizers.loop import optimize_from_acc, _skipped_output
from .options import FIRST_ORDER_TYPES, Options, SolverType
from .output import Output
from .stop_reasons import StopReason


class _BoundedCache(dict):
    """FIFO-bounded solver cache.

    Keys include the user's residual function object: fresh lambdas never
    hit, so an unbounded dict would retain every compiled solve and its
    closure forever in long-running processes.  Eviction only drops OUR
    reference — jit executables stay alive while the caller holds one.
    """

    MAX = 128

    def __setitem__(self, key, value):
        if len(self) >= self.MAX and key not in self:
            del self[next(iter(self))]
        super().__setitem__(key, value)


_CACHE: dict = _BoundedCache()


def _detect_mode(fn, x, options, dims: int) -> str:
    """Signature dispatch via abstract evaluation (optimize.h:26-76).

    A return of ``(cost_like, grad (dims,)[, H (dims, dims)])`` is a
    manual acc; anything else is residuals (or a scalar cost for GD).  A
    residual pytree that happens to be a tuple is disambiguated by shape:
    the gradient must span the full tangent dimension, H must be square
    over it, and a 2-element acc (no H) only exists for first-order
    solvers (optimize.h:40-76).
    """
    import math

    from .cost import Cost

    out = jax.eval_shape(fn, x)
    first_order = options.solver_type in FIRST_ORDER_TYPES
    if isinstance(out, (tuple, list)) and len(out) in (2, 3):
        first, second = out[0], out[1]
        first_scalar = (hasattr(first, "shape")
                        and math.prod(first.shape) == 1) \
            or isinstance(first, (tuple, list, Cost))
        grad_ok = (hasattr(second, "shape") and second.shape == (dims,))
        if len(out) == 2:
            h_ok = first_order
        else:
            third = out[2]
            h_ok = (hasattr(third, "shape")
                    and third.shape == (dims, dims))
        if first_scalar and grad_ok and h_ok:
            return "acc"
    if first_order:
        # The reference statically rejects non-scalar GD costs
        # (optimize.h:59-72, static_assert optimize_autodiff.h:101-102).
        # A size-1 *array* is ambiguous under auto-detection — a Vec1
        # residual and a boxed scalar cost optimize different objectives —
        # so demand an explicit mode instead of guessing.
        leaves = jax.tree_util.tree_leaves(out)
        if any(getattr(l, "ndim", 0) > 0 for l in leaves):
            if all(math.prod(l.shape) == 1 for l in leaves):
                raise ValueError(
                    "GradientDescent auto-dispatch: the function returns a "
                    f"size-1 array ({out}), which is ambiguous — pass "
                    "mode=\"cost\" (minimize the value) or "
                    "mode=\"residuals\" (minimize its square) explicitly, "
                    "or return a 0-d scalar (reference: optimize.h:59-72)")
        return "cost"
    return "residuals"


def _build_system(fn: Callable, options: Options, mode: str, x_example):
    """Resolve the dispatch mode and build the (acc, ev) closures.

    Returns ``(acc, ev, n_res, spec, num_diff_used, mode)`` — shared by
    :func:`build_solver` and the host-chunked timeout driver.
    """
    x_example = mf.as_pytree(x_example)
    spec = mf.tangent_spec(x_example)
    first_order = options.solver_type in FIRST_ORDER_TYPES

    if mode == "auto":
        mode = _detect_mode(fn, x_example, options, spec.dims)

    num_diff_used = False
    if mode == "residuals":
        if first_order:
            # GD requires a scalar cost (optimize.h:59-72); residual
            # pytrees are accepted and squared like the reference.
            from .diff.auto import flatten_residuals
            acc, ev, n_res = make_cost_system(
                lambda x: jnp.sum(jnp.square(flatten_residuals(fn(x)))),
                x_example, spec)
        else:
            from .optimizers.loop import _callbacks_supported
            acc, ev, n_res = make_nlls_system(
                fn, x_example, spec,
                print_J=(options.log.enable and options.log.print_J_jet
                         and _callbacks_supported()))
            # AD fallback to numerical differentiation when the residual
            # function is not differentiable by JAX (e.g. missing custom
            # JVP rules) — the reference's numdiff fallback setting
            # Output.num_diff_used (reference: optimizer.h:167-182).
            try:
                jax.eval_shape(acc, x_example)
            except Exception:  # noqa: BLE001 - any trace/AD failure
                acc, ev, n_res = make_num_diff_system(fn, x_example, spec)
                num_diff_used = True
    elif mode == "numdiff":
        acc, ev, n_res = make_num_diff_system(
            fn, x_example, spec, first_order=first_order)
        num_diff_used = True
    elif mode == "cost":
        if not first_order:
            raise ValueError(
                "GN/LM cannot optimize a gradient-only/scalar cost function; "
                "provide residuals or an acc returning H "
                "(reference: optimize.h:40-57)")
        acc, ev, n_res = make_cost_system(fn, x_example, spec)
    elif mode == "acc":
        acc, ev, n_res = make_acc_system(
            fn, x_example, spec, first_order,
            H_is_full=options.hessian.H_is_full)
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    return acc, ev, n_res, spec, num_diff_used, mode


def build_solver(fn: Callable, options: Options, mode: str, x_example, *,
                 warm_start=None) -> Callable:
    """Build the pure solve function (x) -> (x_opt, Output) for ``fn``.

    Use this directly to compose with jax transforms, e.g.
    ``jax.vmap(build_solver(f, opts, "residuals", x0))`` for batched
    instances sharded over a mesh.

    ``warm_start=(g0, H0)`` seeds the normal equations (the reference's
    ``InitWith`` warm start, optimizer.h:46-55): the first iteration
    evaluates the cost only and proposes a step from the given system.
    """
    acc, ev, n_res, spec, num_diff_used, mode = _build_system(
        fn, options, mode, x_example)

    def solve(x):
        if n_res == 0:
            cap = (options.max_iters + 1
                   + (1 if options.check_final_cost else 0)
                   ) if options.save_history else 0
            return x, _skipped_output(cap, spec.dtype, num_diff_used)
        return optimize_from_acc(x, acc, ev, options, spec,
                                 num_diff_used=num_diff_used,
                                 warm_start=warm_start)

    return solve


def covariance_at(fn: Callable, x, options: Options | None = None, *,
                  mode: str = "auto", rescaled: bool = False):
    """Posterior covariance H(x)⁻¹ computed post-hoc at ``x``.

    Solve paths that never materialize H — ``save_last=False`` and
    ``matfree_optimize`` — cannot fill ``Output.final_hessian``; this
    builds the un-damped normal equations at the returned ``x`` with one
    accumulate and inverts, using the same rescale formula as
    ``Output.covariance`` (reference output.h:80-93: ×cost²/(n−dims) for
    overdetermined systems when ``rescaled``).  Composable with vmap for
    batched solves::

        x_opt, out = batched_optimize(x0, fn, opts, data_batch=data)
        covs = jax.vmap(lambda xi, di: to.covariance_at(
            lambda x: fn(x, di), xi))(x_opt, data)
    """
    from .ops.linalg import inv_cov

    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError("covariance requires a GN/LM-style Hessian; "
                         "first-order solver types build none")
    x = mf.as_pytree(x)
    acc, ev, n_res, spec, _, mode = _build_system(fn, options, mode, x)
    H, g, cost = acc(x)
    if H is None or not isinstance(H, jnp.ndarray):
        raise ValueError(
            "covariance_at needs a dense Hessian (got "
            f"{type(H).__name__}); for block/sparse systems use the "
            "solver's own covariance (BlockDiag.inv / SparseSym)")
    cov = inv_cov(H)
    if rescaled:
        from .ops.linalg import cov_rescale
        cov = cov * cov_rescale(cost.cost, cost.num_residuals, spec.dims)
    return cov


def _cache_key(fn, options, mode, x, jit=True):
    leaves = jax.tree_util.tree_leaves(x)
    shapes = tuple((jnp.shape(l), jnp.asarray(l).dtype.name) for l in leaves)
    structure = jax.tree_util.tree_structure(x)
    return (fn, options, mode, structure, shapes, jit)


def optimize(x, fn: Callable, options: Options | None = None, *,
             mode: str = "auto", jit: bool = True):
    """Optimize ``x`` to minimize ``fn``. Returns ``(x_opt, Output)``.

    ``fn`` is a residual function, scalar cost, or manual acc function (see
    module docstring).  ``options.max_duration_ms > 0`` runs a host-stepped
    variant with wall-clock timeout (the reference's kTimedOut semantics,
    optimizer.h:302-305); otherwise the whole solve is one XLA program.
    """
    options = options or Options()
    x = mf.as_pytree(x)

    if options.max_duration_ms > 0:
        return _optimize_with_timeout(x, fn, options, mode)

    t0 = time.perf_counter()
    key = _cache_key(fn, options, mode, x, jit)
    solve = _CACHE.get(key)
    if solve is None:
        solve = build_solver(fn, options, mode, x)
        if jit:
            solve = jax.jit(solve)
        _CACHE[key] = solve
    try:
        x_opt, out = solve(x)
        out = jax.block_until_ready(out)
    except (RuntimeError, jax.errors.JaxRuntimeError) as e:
        # Allocation failure -> kOutOfMemory (reference optimizer.h:61-92);
        # XLA surfaces it as RESOURCE_EXHAUSTED at compile/dispatch time.
        msg = str(e)
        if "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg \
                or "out of memory" in msg:
            spec = mf.tangent_spec(x)
            cap = (options.max_iters + 1
                   + (1 if options.check_final_cost else 0)
                   ) if options.save_history else 0
            out = _skipped_output(cap, spec.dtype, False)
            out.stop_reason = jnp.asarray(
                int(StopReason.OUT_OF_MEMORY), jnp.int32)
            out.duration_ms = jnp.float32((time.perf_counter() - t0) * 1e3)
            return x, out
        raise
    out.duration_ms = jnp.float32((time.perf_counter() - t0) * 1e3)
    return x_opt, out


def _segment_pair(fn, options, mode, x_example, iters_per_segment: int):
    """Jitted segment-execution triple shared by the timeout driver and
    ``checkpoint.segment_solver``: ``(start, resume, evaluate, spec,
    num_diff_used, mode, n_res)`` where ``start(x0)`` / ``resume(state)``
    run exactly ``iters_per_segment`` loop iterations with the full carry
    as a runtime input, and ``evaluate(x)`` returns the (normalized) cost
    for the check_final_cost fallback."""
    from .cost import normalize_cost

    seg_opts = options.replace(max_iters=iters_per_segment,
                               max_duration_ms=0.0,
                               check_final_cost=False)
    acc, ev, n_res, spec, num_diff_used, mode = _build_system(
        fn, seg_opts, mode, x_example)
    start = jax.jit(lambda x0: optimize_from_acc(
        x0, acc, ev, seg_opts, spec, num_diff_used=num_diff_used,
        return_state=True))
    resume = jax.jit(lambda st: optimize_from_acc(
        st.x, acc, ev, seg_opts, spec, num_diff_used=num_diff_used,
        segment_state=st, return_state=True))
    evaluate = jax.jit(
        lambda xv: normalize_cost(ev(xv), seg_opts.cost).cost)
    return start, resume, evaluate, spec, num_diff_used, mode, n_res


def _optimize_with_timeout(x, fn, options, mode):
    """Host-chunked solve honoring ``max_duration_ms``.

    Runs the jitted loop one iteration per segment, carrying the COMPLETE
    loop state (λ schedule including compounded bad factors, accept/reject
    state, failure budgets, Rebuild(false) flags) between segments as a
    runtime input — two compiled executables total ("start" and "resume"),
    reused across segments — and checking the wall clock in between,
    mirroring the reference's per-iteration timeout check
    (optimizer.h:302-305).  Semantics match the un-chunked loop exactly on
    the accepted path; the only cost is one device round-trip per
    iteration, acceptable for a safety net.
    """
    import numpy as np

    t0 = time.perf_counter()
    x = mf.as_pytree(x)
    seg_opts = options.replace(max_duration_ms=0.0, max_iters=1,
                               check_final_cost=False)
    key = _cache_key(fn, seg_opts, mode, x)
    pair = _CACHE.get(("timeout", key))
    if pair is None:
        pair = _segment_pair(fn, options, mode, x, 1)
        _CACHE[("timeout", key)] = pair
    start, resume, evaluate, spec, num_diff_used, mode, n_res = pair

    if n_res == 0 or spec.dims == 0:
        cap = (options.max_iters + 1
               + (1 if options.check_final_cost else 0)
               ) if options.save_history else 0
        out = _skipped_output(cap, spec.dtype, num_diff_used)
        out.duration_ms = jnp.float32((time.perf_counter() - t0) * 1e3)
        return x, out

    # The reference grants max_iters + 1 iterations (one rollback slot,
    # optimizer.h:249) + 1 more with check_final_cost.
    budget_iters = options.max_iters + 1 \
        + (1 if options.check_final_cost else 0)
    state = None
    out = None
    hist_e, hist_d, hist_s = [], [], []
    total_iters = 0
    timed_out = False
    while total_iters < budget_iters:
        if state is None:
            _, out, state = start(x)
        else:
            _, out, state = resume(state)
        out = jax.block_until_ready(out)
        total_iters += int(out.num_iters)
        if options.save_history:
            n = int(out.num_hist)
            hist_e += list(np.asarray(out.errs[:n]))
            hist_d += list(np.asarray(out.deltas2[:n]))
            hist_s += list(np.asarray(out.successes[:n]))
        if int(out.stop_reason) not in (int(StopReason.MAX_ITERS),
                                        int(StopReason.NONE)):
            break
        if (time.perf_counter() - t0) * 1e3 > options.max_duration_ms:
            timed_out = True
            break

    x_final = state.x
    # Non-terminal exit (budget exhausted / timed out): segment mode
    # applies every iteration's proposal (continuation needs it), so
    # state.x carries one UNEVALUATED trailing step.  The unchunked loop
    # gates its final apply, which makes its returned x the best accepted
    # point after the last evaluation — state.best_x holds exactly that
    # (the two runs share all evaluations 1..N bit-for-bit), so return it.
    # This is also the check_final_cost fallback (options.h:43): the +1
    # budget iteration evaluated the extra point into best_x if accepted.
    if int(out.stop_reason) in (int(StopReason.MAX_ITERS),
                                int(StopReason.NONE)):
        x_final = state.best_x

    stop = (jnp.asarray(int(StopReason.TIMED_OUT), jnp.int32) if timed_out
            else jnp.where(
                out.stop_reason == int(StopReason.NONE),
                int(StopReason.MAX_ITERS), out.stop_reason).astype(jnp.int32))
    out.stop_reason = stop
    out.num_iters = jnp.asarray(total_iters, jnp.int32)
    out.errs = jnp.asarray(np.asarray(hist_e, dtype=np.asarray(
        out.errs).dtype) if hist_e else np.zeros((0,)))
    out.deltas2 = jnp.asarray(np.asarray(hist_d, dtype=np.asarray(
        out.deltas2).dtype) if hist_d else np.zeros((0,)))
    out.successes = jnp.asarray(np.asarray(hist_s, bool)
                                if hist_s else np.zeros((0,), bool))
    out.num_hist = jnp.asarray(len(hist_e), jnp.int32)
    out.duration_ms = jnp.float32((time.perf_counter() - t0) * 1e3)
    return x_final, out


def multi_start_optimize(x0_batch, fn: Callable,
                         options: Options | None = None, *,
                         mode: str = "auto"):
    """Solve from many start points at once and return the best.

    The batched answer to multi-modal problems (e.g. Himmelblau's four
    minima): all starts run concurrently under ``vmap`` in one compiled
    program, then the lowest-cost successful solve wins.  Returns
    ``(x_best, out_best, outs_all)``.
    """
    options = options or Options()
    x0_batch = mf.as_pytree(x0_batch)
    x_example = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[0], x0_batch)
    solve = jax.jit(jax.vmap(build_solver(fn, options, mode, x_example)))
    xs, outs = solve(x0_batch)
    cost = jnp.where(outs.succeeded(), outs.final_cost.cost, jnp.inf)
    i = jnp.argmin(cost)
    x_best = jax.tree_util.tree_map(lambda a: a[i], xs)
    out_best = jax.tree_util.tree_map(lambda a: a[i], outs)
    return x_best, out_best, outs


# Reference-style alias
Optimize = optimize
