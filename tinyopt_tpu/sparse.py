"""Sparse / large-scale solves: block-diagonal and matrix-free GN-CG.

The reference handles large problems with a general ``SparseMatrix``
Hessian factored by ``SimplicialLDLT`` (reference: solvers/gn.h:63-74,
math.h:266-277, tests/sparse.cpp:19-85) and admits it is "not fast for
large systems yet" (reference README.md:30).  A sequential sparse
factorization is the wrong shape for an accelerator; this module provides
formulations that cover the same problems:

* **Block-diagonal** (``block_optimize``): independent parameter blocks —
  the structure of the reference's sparse tests/benchmarks — solved with
  one *batched* dense Cholesky over the (nb, bs, bs) block array.
* **Matrix-free GN-CG** (``matfree_optimize``): never materializes J or
  JᵀJ.  The Gauss-Newton matvec v ↦ Jᵀ(J v) is two AD passes (one jvp +
  one vjp) through the residual function, and (JᵀJ + λI) dx = −g is solved
  by conjugate gradients.  Damping is additive (λI, Marquardt) rather than
  the reference's multiplicative diag scaling, because diag(JᵀJ) is not
  available without d extra passes.
* **General sparse** (``sparse_optimize``): arbitrary (static) sparsity,
  the direct counterpart of the reference's ``SparseMatrix`` Hessian.
  The Jacobian's nonzero structure is detected at build time (or supplied
  by the caller), Curtis–Powell–Reid column coloring compresses the full
  J recovery into one jvp sweep per color, and H = JᵀJ is assembled in
  coordinate form with static scatter indices — multiplicative diag
  damping and Jacobi-PCG solves then match the reference's LM semantics
  (:mod:`~tinyopt_tpu.ops.sparse_sym`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import manifold as mf
from .cost import Cost, rss as rss_exact
from .diff.auto import flatten_residuals, value_and_jacfwd
from .optimize import _BoundedCache
from .optimizers.loop import optimize_from_acc
from .options import FIRST_ORDER_TYPES, Options, SolverType
from .ops.block import BlockDiag
from .ops.coloring import _greedy_color, probe_structure
from .ops.sparse_sym import SparseSym

#: Compiled-solver cache for the entry points below, mirroring
#: optimize.py's: repeated solves with the same (fn, options, shapes,
#: data objects) reuse the traced+compiled program instead of paying a
#: full re-trace per call (measured: the 15.6k-dim BA solve is ~1 s of
#: device time inside ~8 s of per-call re-tracing without it).  Entries
#: hold strong references to the captured data arrays so the id()-based
#: keys stay valid.
_SOLVE_CACHE: dict = _BoundedCache()
#: Data leaves up to this many elements key the cache by value.
_VALUE_KEY_SIZE = 16


def _solver_cache_key(kind, fn, options, jit, x0, data_leaves, extra=()):
    """Cache key, or None when caching is unsound.

    Captured data participates by OBJECT IDENTITY, which is only safe
    for immutable buffers: a mutable numpy array baked into a cached
    trace would silently go stale if the caller mutates it in place, so
    caching is skipped unless every data leaf is a ``jax.Array``.
    Leaves of at most ``_VALUE_KEY_SIZE`` elements participate by value
    instead, so that an entry point deriving a small array per call
    (``pose_graph_optimize``'s anchor views) still hits.
    """
    if not jit:
        return None
    sigs = []
    for leaf in data_leaves:
        if not isinstance(leaf, jax.Array):
            return None
        if leaf.size <= _VALUE_KEY_SIZE:
            sigs.append((np.asarray(leaf).tobytes(), leaf.shape,
                         str(leaf.dtype)))
        else:
            sigs.append((id(leaf), leaf.shape, str(leaf.dtype)))
    xs = tuple((jnp.shape(l), jnp.asarray(l).dtype.name)
               for l in jax.tree_util.tree_leaves(x0))
    return (kind, fn, options, jax.tree_util.tree_structure(x0), xs,
            tuple(sigs), extra)


def _solver_cache_get(key):
    if key is None:
        return None
    hit = _SOLVE_CACHE.get(key)
    return hit[0] if hit is not None else None


def _solver_cache_put(key, solve, data_leaves):
    if key is not None:
        _SOLVE_CACHE[key] = (solve, tuple(data_leaves))


#: Closed-over-constant budget above which the jitted solve hoists its
#: captured arrays into runtime arguments.  Closure constants are
#: EMBEDDED in the lowered module; at ceiling-scale sparse-obs BA the
#: problem data + host-planned window/band tables reach hundreds of MB,
#: which bloats the module, its compile time and the persistent
#: compile-cache key and entry (the constants are hashed and stored
#: with it).  Hoisting keeps the module small (constants travel once as
#: device buffers) at the cost of one extra host-side trace at build
#: time.
_CONST_HOIST_BYTES = 16 * 1024 * 1024


def _jit_solve(solve, x0, data_leaves, extra_bytes: int = 0):
    """``jax.jit(solve)``, hoisting closed-over array constants into
    explicit runtime arguments when the captured data is large — see
    ``_CONST_HOIST_BYTES``.  Manual closure conversion via
    ``make_jaxpr`` + ``eval_jaxpr`` (NOT ``jax.closure_convert``, which
    hoists only INEXACT-dtype constants — the heavy captures here are
    the int32/int64 plan/gather tables).  Falls back to a plain jit if
    conversion fails (e.g. effects the evaluator rejects)."""
    est = extra_bytes + sum(
        int(np.prod(jnp.shape(l))) * jnp.asarray(l).dtype.itemsize
        for l in data_leaves)
    if est < _CONST_HOIST_BYTES:
        return jax.jit(solve)
    try:
        closed, out_shape = jax.make_jaxpr(solve, return_shape=True)(x0)
        out_tree = jax.tree_util.tree_structure(out_shape)
        consts = tuple(jnp.asarray(c) for c in closed.consts)
        jaxpr = closed.jaxpr

        def _eval(consts_, flat_x):
            return jax.core.eval_jaxpr(jaxpr, consts_, *flat_x)

        jitted = jax.jit(_eval)

        def hoisted(x):
            flat_x = jax.tree_util.tree_leaves(x)
            outs = jitted(consts, flat_x)
            return jax.tree_util.tree_unflatten(out_tree, outs)

        # trace-time sanity: abstract shapes of x must match the jaxpr
        jax.eval_shape(hoisted, x0)
        return hoisted
    except Exception:
        return jax.jit(solve)


# --------------------------------------------------------------------------
# Block-diagonal path
# --------------------------------------------------------------------------

def block_nlls_system(block_fn: Callable, x0: jax.Array, data=None):
    """(accumulate, evaluate, n_res) for independent parameter blocks.

    ``x0`` has shape (nb, bs); ``block_fn(x_block[, data_block])`` returns
    the residuals of one block.  H is assembled as a :class:`BlockDiag`
    and solved blockwise — the full (nb·bs)² matrix never exists.
    """
    nb, bs = x0.shape
    dtype = x0.dtype

    if data is None:
        fn = lambda xb, _: block_fn(xb)
        data_axis = None
        data_arg = jnp.zeros((nb,), dtype)
    else:
        fn = block_fn
        data_axis = 0
        data_arg = data

    r_shape = jax.eval_shape(
        lambda xb, db: flatten_residuals(fn(xb, db)),
        jax.ShapeDtypeStruct((bs,), dtype),
        jax.tree_util.tree_map(lambda a: a[0], data_arg))
    n_res = nb * math.prod(r_shape.shape)

    def one(xb, db):
        r, J = value_and_jacfwd(
            lambda v: flatten_residuals(fn(v, db)).astype(dtype), xb)
        return (jnp.matmul(J.T, J, preferred_element_type=dtype),
                J.T @ r, rss_exact(r))

    def accumulate(x):
        Hs, gs, cs = jax.vmap(one)(x, data_arg)
        return BlockDiag(Hs), gs.reshape(-1), Cost.make(jnp.sum(cs), n_res)

    def evaluate(x):
        def c_one(xb, db):
            r = flatten_residuals(fn(xb, db)).astype(dtype)
            return rss_exact(r)
        return Cost.make(jnp.sum(jax.vmap(c_one)(x, data_arg)), n_res)

    return accumulate, evaluate, n_res


def block_optimize(x0: jax.Array, block_fn: Callable,
                   options: Options | None = None, *, data=None,
                   jit: bool = True):
    """Solve an NLLS problem with independent (block-diagonal) parameter
    blocks.  Returns ``(x_opt, Output)``; ``Output.final_hessian`` is a
    :class:`BlockDiag` and ``Output.covariance()`` is blockwise."""
    options = options or Options()
    x0 = jnp.asarray(x0)
    key = _solver_cache_key("block", block_fn, options, jit, x0,
                            jax.tree_util.tree_leaves(data))
    solve = _solver_cache_get(key)
    if solve is None:
        spec = mf.tangent_spec(x0)
        acc, ev, n_res = block_nlls_system(block_fn, x0, data)

        def solve(x):
            return optimize_from_acc(x, acc, ev, options, spec)

        if jit:
            solve = jax.jit(solve)
        _solver_cache_put(key, solve, jax.tree_util.tree_leaves(data))
    return solve(x0)


# --------------------------------------------------------------------------
# Matrix-free GN-CG path
# --------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LinPoint:
    """Hessian representation for the matrix-free path: the linearization
    point itself.  The GN matvec is re-derived from it on demand, so the
    ``Rebuild(false)`` semantics (H frozen at the last full build while
    probing) carry over exactly — the carried LinPoint only changes on a
    rebuild."""

    x: Any


def matfree_system(residual_fn: Callable, x0, spec: mf.TangentSpec,
                   cg_iters: int, cg_tol: float,
                   precond_probes: int = 0):
    """(accumulate, evaluate, n_res, propose) closures for GN-CG.

    accumulate computes the gradient with ONE reverse-mode pass (the
    reference's forward-mode Jets need `dims` passes — reverse mode is the
    right tool when J itself is never needed).

    ``precond_probes`` > 0 enables a HUTCHINSON-estimated Jacobi
    preconditioner: diag(JᵀJ) ≈ mean over P Rademacher probes v of
    (JᵀJ v) ⊙ v (exact in expectation; P extra matvec pairs per
    propose).  The estimate also drives the reference's MULTIPLICATIVE
    per-dimension damping ``H + λ·diag`` in place of the isotropic
    Rayleigh fallback.  WHERE IT HELPS (measured): badly scaled,
    loosely coupled systems — a 6-decade diagonal-scale spread goes
    from stalled (cost 29 at the 30-iteration budget) to converged in
    4 LM iterations.  WHERE IT DOES NOT: strongly coupled Hessians —
    on a small BA instance the estimator's off-diagonal variance gives
    ~80% median relative diag error and ~24% negative entries at P=8
    (measured), and the misscaled M⁻¹ WORSENS convergence; use the
    Schur paths for BA.  Default off.
    """
    n_res = int(sum(
        math.prod(l.shape) for l in
        jax.tree_util.tree_leaves(jax.eval_shape(residual_fn, x0))))

    def r_of_delta(delta, x):
        return flatten_residuals(
            residual_fn(mf.retract(x, delta, spec))).astype(spec.dtype)

    def accumulate(x):
        delta0 = mf.zero_tangent(x, spec)
        r, vjp_fn = jax.vjp(lambda d: r_of_delta(d, x), delta0)
        g = vjp_fn(r)[0]
        return LinPoint(x), g, Cost.make(rss_exact(r), n_res)

    def evaluate(x):
        r = flatten_residuals(residual_fn(x)).astype(spec.dtype)
        return Cost.make(rss_exact(r), n_res)

    def propose(H: LinPoint, g, lam, opts):
        delta0 = mf.zero_tangent(H.x, spec)
        _, jvp_fn = jax.linearize(lambda d: r_of_delta(d, H.x), delta0)
        _, vjp_fn = jax.vjp(lambda d: r_of_delta(d, H.x), delta0)

        if precond_probes > 0:
            # Hutchinson diagonal estimate (deterministic probes — the
            # same Rademacher vectors every call, which keeps the
            # compiled solve cacheable and the estimator unbiased)
            vs = jnp.where(
                jax.random.bernoulli(
                    jax.random.PRNGKey(0),
                    shape=(precond_probes, spec.dims)),
                jnp.ones((), g.dtype), -jnp.ones((), g.dtype))
            d_est = jnp.mean(
                jax.vmap(lambda v: vjp_fn(jvp_fn(v))[0] * v)(vs),
                axis=0)
            floor = jnp.maximum(jnp.max(d_est), 1.0) \
                * jnp.finfo(g.dtype).eps
            diag_h = jnp.maximum(d_est, floor)
            dinv = 1.0 / diag_h
        else:
            diag_h = dinv = None

        def cg_solve(add_lam):
            if diag_h is not None:
                # multiplicative per-dimension damping (lm.h:107-117
                # semantics on the estimated diagonal) + Jacobi M⁻¹
                def matvec(v):
                    return vjp_fn(jvp_fn(v))[0] + add_lam * diag_h * v

                dx, _ = jax.scipy.sparse.linalg.cg(
                    matvec, -g, maxiter=cg_iters, tol=cg_tol,
                    M=lambda v: v * dinv)
                return dx, jnp.all(jnp.isfinite(dx))

            def matvec(v):
                return vjp_fn(jvp_fn(v))[0] + add_lam * v

            dx, _ = jax.scipy.sparse.linalg.cg(
                matvec, -g, maxiter=cg_iters, tol=cg_tol)
            return dx, jnp.all(jnp.isfinite(dx))

        # Scale-aware additive damping: λ · (gᵀ JᵀJ g / gᵀg) · I.  The
        # Rayleigh quotient along g estimates the curvature magnitude
        # (one extra matvec), standing in for the reference's
        # multiplicative diag(JᵀJ) scaling which is unavailable
        # without materializing the diagonal.  (Unused — and DCE'd —
        # for GN, where the damping is zero.)
        g2 = jnp.vdot(g, g)
        Jg = jvp_fn(g)
        gHg = jnp.vdot(Jg, Jg)
        ray = jnp.maximum(
            jnp.where(g2 > 0, gHg / jnp.where(g2 > 0, g2, 1.0),
                      jnp.ones((), g.dtype)),
            jnp.finfo(g.dtype).tiny)

        if opts.solver_type == SolverType.DOGLEG:
            # Dogleg over the CG machinery (the matrix-free trust
            # region): GN point from an undamped CG solve, curvature
            # gᵀHg = ‖Jg‖² exactly, and the regularized fallback
            # re-solves with additive λ_eff·ray damping — lazily, under
            # lax.cond (solvers/step.dogleg_core).
            from .solvers.step import dogleg_core
            dx_gn, ok_gn = cg_solve(jnp.zeros((), g.dtype))
            # Fallback damping mirrors the LM branch below: with an
            # estimated diag(H) the matvec already scales the damping
            # multiplicatively per-dimension, so the Rayleigh scale
            # would double-count curvature.
            if diag_h is not None:
                fallback = cg_solve
            else:
                fallback = lambda le: cg_solve(le * ray)
            return dogleg_core(g, lam, dx_gn, ok_gn, gHg, fallback)

        if opts.solver_type == SolverType.LEVENBERG_MARQUARDT:
            add_lam = lam if diag_h is not None else lam * ray
        else:
            add_lam = jnp.zeros_like(lam)
        return cg_solve(add_lam)

    return accumulate, evaluate, n_res, propose


# --------------------------------------------------------------------------
# General sparse path (colored J recovery -> COO JtJ)
# --------------------------------------------------------------------------

def _sparse_plan(structure):
    """Static (numpy, build-time) plan for colored J recovery and COO JᵀJ
    assembly from a (n_res, dims) boolean structure.

    Returns ``(probes, e_rows, e_colors, e_cols, pair_e1, pair_e2,
    pair_out, h_rows, h_cols, n_colors)``:

    * ``probes``: (C, dims) CPR probe tangents (one per color);
      ``J p_c`` recovers every column of color ``c`` at once because
      their row supports are disjoint (Curtis–Powell–Reid 1974).
    * J entry ``e`` lives at ``(e_rows[e], e_cols[e])`` and is read from
      the compressed product as ``(J p)[e_colors[e], e_rows[e]]``.
    * H = JᵀJ entry ``pair_out[p]`` accumulates
      ``J_vals[pair_e1[p]] * J_vals[pair_e2[p]]`` — all ordered pairs of
      J entries sharing a row (both triangles, matching
      :class:`~tinyopt_tpu.ops.sparse_sym.SparseSym`'s storage).
    """
    n_res, dims = structure.shape
    colors = _greedy_color(structure)
    n_colors = int(colors.max()) + 1 if dims else 1

    probes = np.zeros((n_colors, dims))
    probes[colors, np.arange(dims)] = 1.0

    e_rows, e_cols = np.nonzero(structure)       # row-major (sorted by row)
    e_colors = colors[e_cols]
    nnz = e_rows.size

    counts = np.bincount(e_rows, minlength=n_res)        # J entries per row
    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    c_per_entry = counts[e_rows]                 # row population per entry
    pair_e1 = np.repeat(np.arange(nnz), c_per_entry)
    block_starts = np.repeat(starts[e_rows], c_per_entry)
    run_starts = np.repeat(np.cumsum(c_per_entry) - c_per_entry, c_per_entry)
    pair_e2 = block_starts + (np.arange(pair_e1.size) - run_starts)

    keys = e_cols[pair_e1].astype(np.int64) * dims + e_cols[pair_e2]
    uniq, pair_out = np.unique(keys, return_inverse=True)
    h_rows = (uniq // dims).astype(np.int32)
    h_cols = (uniq % dims).astype(np.int32)
    return (probes, e_rows, e_colors, e_cols, pair_e1, pair_e2,
            pair_out, h_rows, h_cols, n_colors)


def sparse_system(residual_fn: Callable, x0, spec: mf.TangentSpec,
                  structure: "np.ndarray"):
    """(accumulate, evaluate, n_res) closures assembling H = JᵀJ as a
    :class:`~tinyopt_tpu.ops.sparse_sym.SparseSym` from colored jvp sweeps.

    One ``jax.linearize`` per build shares the primal chain across all C
    probe sweeps; J is recovered only at its nonzeros, H at its static
    COO pattern, and g = Jᵀr by a scatter over the same entries — nothing
    dense in ``dims`` is ever materialized.
    """
    n_res, dims = structure.shape
    (probes_np, e_rows, e_colors, e_cols, pair_e1, pair_e2,
     pair_out, h_rows, h_cols, _) = _sparse_plan(np.asarray(structure, bool))

    dtype = spec.dtype
    probes = jnp.asarray(probes_np, dtype)
    e_rows_j = jnp.asarray(e_rows, jnp.int32)
    e_colors_j = jnp.asarray(e_colors, jnp.int32)
    e_cols_j = jnp.asarray(e_cols, jnp.int32)
    pair_e1_j = jnp.asarray(pair_e1, jnp.int32)
    pair_e2_j = jnp.asarray(pair_e2, jnp.int32)
    pair_out_j = jnp.asarray(pair_out, jnp.int32)
    nse = int(h_rows.size)

    def r_of_delta(delta, x):
        return flatten_residuals(
            residual_fn(mf.retract(x, delta, spec))).astype(dtype)

    def accumulate(x):
        delta0 = mf.zero_tangent(x, spec)
        r, jvp_fn = jax.linearize(lambda d: r_of_delta(d, x), delta0)
        compressed = jax.vmap(jvp_fn)(probes)            # (C, n_res)
        j_vals = compressed[e_colors_j, e_rows_j]        # (nnzJ,)
        h_vals = (jnp.zeros((nse,), dtype)
                  .at[pair_out_j].add(j_vals[pair_e1_j] * j_vals[pair_e2_j]))
        H = SparseSym.from_pattern(h_rows, h_cols, h_vals, dims)
        g = (jnp.zeros((dims,), dtype)
             .at[e_cols_j].add(j_vals * r[e_rows_j]))
        return H, g, Cost.make(rss_exact(r), n_res)

    def evaluate(x):
        r = flatten_residuals(residual_fn(x)).astype(dtype)
        return Cost.make(rss_exact(r), n_res)

    return accumulate, evaluate, n_res


def sparse_optimize(x0, residual_fn: Callable,
                    options: Options | None = None, *,
                    structure: "np.ndarray | None" = None,
                    jit: bool = True):
    """LM/GN with a general sparse JᵀJ Hessian (static sparsity pattern).

    The JAX counterpart of the reference's ``SparseMatrix`` Hessian
    + ``SimplicialLDLT`` solve (reference: solvers/gn.h:63-74,
    math.h:266-277, tests/sparse.cpp:19-85): the Jacobian's nonzero
    structure is probed at build time (or passed as ``structure``, a
    (n_res, dims) boolean array over the TANGENT dimensions), H = JᵀJ is
    assembled in coordinate form with multiplicative diag damping
    (lm.h:107-117 semantics via :meth:`SparseSym.damp`), and the damped
    system is solved by Jacobi-PCG (``options.hessian.cg_iters``; 0 means
    ``dims`` iterations).  ``Output.final_hessian`` is a
    :class:`~tinyopt_tpu.ops.sparse_sym.SparseSym` and
    ``Output.covariance()`` works (densifying, as any sparse inverse must).

    Structure probing evaluates the Jacobian at a few perturbed points and
    ORs the nonzero patterns (see :mod:`~tinyopt_tpu.ops.coloring`); pass
    ``structure`` explicitly for residuals whose sparsity the probe could
    misdetect (value-dependent branches).
    """
    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError(
            "sparse_optimize is a Gauss-Newton/LM method; use to.optimize "
            "with a first-order solver type for gradient-only solves")
    x0 = mf.as_pytree(x0)
    spec = mf.tangent_spec(x0)
    n_res = int(sum(
        math.prod(l.shape) for l in
        jax.tree_util.tree_leaves(jax.eval_shape(residual_fn, x0))))
    if structure is None:
        structure = probe_structure(residual_fn, x0, None, spec,
                                    n_res, spec.dims)
        if structure is None:
            raise ValueError(
                "could not detect the Jacobian's sparsity structure "
                "(non-finite or untraceable residuals); pass structure= "
                "explicitly or use to.optimize / matfree_optimize")
    else:
        structure = np.asarray(structure, bool)
        if structure.shape != (n_res, spec.dims):
            raise ValueError(
                f"structure shape {structure.shape} != "
                f"(n_res={n_res}, dims={spec.dims})")
    # Probing above runs per call (it depends on x0's VALUES); only the
    # trace/compile of the solve is cached, keyed on the probed pattern.
    key = _solver_cache_key(
        "sparse", residual_fn, options, jit, x0, (),
        extra=(structure.shape, structure.tobytes()))
    solve = _solver_cache_get(key)
    if solve is None:
        acc, ev, n_res = sparse_system(residual_fn, x0, spec, structure)

        def solve(x):
            return optimize_from_acc(x, acc, ev, options, spec)

        if jit:
            solve = jax.jit(solve)
        _solver_cache_put(key, solve, ())
    return solve(x0)


def matfree_optimize(x0, residual_fn: Callable,
                     options: Options | None = None, *,
                     cg_iters: int = 0, cg_tol: float = 1e-10,
                     precond_probes: int = 0, jit: bool = True):
    """Matrix-free Gauss-Newton/LM with conjugate-gradient inner solves.

    Neither J nor JᵀJ is ever materialized — suitable for very large
    tangent dimensions.  ``cg_iters=0`` defaults to the tangent dimension
    (exact CG in exact arithmetic).  ``Output.final_hessian`` is None.
    ``precond_probes`` > 0 adds a Hutchinson-estimated Jacobi
    preconditioner + multiplicative per-dimension damping (P extra
    matvec pairs per propose; see :func:`matfree_system`) — worth it on
    badly scaled problems where plain CG stalls.
    """
    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError(
            "matfree_optimize is a Gauss-Newton/LM method; use "
            "to.optimize with a first-order solver type for gradient-only "
            "solves")
    x0 = mf.as_pytree(x0)
    spec = mf.tangent_spec(x0)
    if cg_iters <= 0:
        cg_iters = spec.dims
    key = _solver_cache_key("matfree", residual_fn, options, jit, x0, (),
                            extra=(cg_iters, cg_tol, precond_probes))
    solve = _solver_cache_get(key)
    if solve is None:
        opts = options.replace(
            hessian=dataclasses.replace(options.hessian, save_last=False))
        acc, ev, n_res, propose = matfree_system(
            residual_fn, x0, spec, cg_iters, cg_tol, precond_probes)

        def solve(x):
            return optimize_from_acc(x, acc, ev, opts, spec,
                                     propose=propose)

        if jit:
            solve = jax.jit(solve)
        _solver_cache_put(key, solve, ())
    return solve(x0)


def schur_optimize(x0: tuple, pair_fn: Callable, data, mask,
                   options: Options | None = None, *, jit: bool = True):
    """Bipartite NLLS via Schur-complement elimination (bundle adjustment).

    ``x0 = (a0, b0)``: two batched parameter families — e.g. cameras (a
    batched SE3) and landmarks ((n_b, 3)) — where every residual couples
    exactly one element of each.  ``pair_fn(a_i, b_j, data_ij) -> (m,)``
    evaluates one observation; ``data`` leaves are (n_a, n_b, ...) and
    ``mask`` is (n_a, n_b) with 1 for observed pairs.

    Eliminates the B family per LM iteration (batched (db x db) Cholesky
    inverses) and solves only the (n_a·da)² reduced camera system — the
    structure every production BA solver exploits and the regime the
    reference concedes (README.md:30).  See :mod:`tinyopt_tpu.ops.schur`.
    ``Output.final_hessian`` is a :class:`~tinyopt_tpu.ops.schur.SchurSystem`
    when ``hessian.save_last`` is on; ``Output.covariance()`` inverts it
    by block (Schur) inversion — one reduced-system inverse plus batched
    (db×db) inverses.  ``Cost.num_residuals`` counts OBSERVED pairs only
    (``m · count_nonzero(mask)``).
    """
    from .ops.schur import schur_system

    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError(
            "schur_optimize is a Gauss-Newton/LM method; use to.optimize "
            "with a first-order solver type for gradient-only solves")
    if not (isinstance(x0, tuple) and len(x0) == 2):
        raise ValueError("schur_optimize needs x0 = (a0, b0)")
    x0 = (mf.as_pytree(x0[0]), mf.as_pytree(x0[1]))
    mask = jnp.asarray(mask)
    data_leaves = jax.tree_util.tree_leaves((data, mask))
    key = _solver_cache_key("schur", pair_fn, options, jit, x0,
                            data_leaves)
    solve = _solver_cache_get(key)
    if solve is None:
        spec = mf.tangent_spec(x0)
        acc, ev, n_res, propose = schur_system(pair_fn, x0[0], x0[1],
                                               data, mask, spec)

        def solve(x):
            return optimize_from_acc(x, acc, ev, options, spec,
                                     propose=propose)

        if jit:
            solve = jax.jit(solve)
        _solver_cache_put(key, solve, data_leaves)
    return solve(x0)


def schur_sparse_optimize(x0: tuple, pair_fn: Callable, obs, cam_idx,
                          mask, options: Options | None = None, *,
                          jit: bool = True):
    """Sparse-observation bundle adjustment (point-major padded layout).

    The memory-scalable form of :func:`schur_optimize` for SPARSE
    visibility: instead of a dense (n_a, n_b) grid, pass exactly the
    observations —

      * ``obs`` — pytree, leaves (n_b, K, ...): per-landmark data for up
        to ``K`` observations,
      * ``cam_idx`` — (n_b, K) int32: the camera of each slot,
      * ``mask`` — (n_b, K): 1 for real slots (padded slots contribute
        exactly zero residual and Jacobian).

    Memory is O(n_obs) instead of O(n_a · n_b) — thousands of cameras
    where the grid path caps at hundreds.  Same Schur elimination per LM
    iteration (batched landmark-block inverses + one reduced camera
    solve, assembled by ``segment_sum`` scatters — ops/schur_obs.py);
    LM/GN/DogLeg.  ``ops.schur_obs.grid_to_obs`` converts grid-form data.
    ``Cost.num_residuals`` counts real slots only.
    """
    from .ops.schur_obs import (camera_sort_perm, schur_obs_bucket_system,
                                schur_obs_system)

    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError(
            "schur_sparse_optimize is a Gauss-Newton/LM method; use "
            "to.optimize with a first-order solver type for gradient-only "
            "solves")
    if not (isinstance(x0, tuple) and len(x0) == 2):
        raise ValueError("schur_sparse_optimize needs x0 = (a0, b0)")
    x0 = (mf.as_pytree(x0[0]), mf.as_pytree(x0[1]))
    cam_idx = jnp.asarray(cam_idx, jnp.int32)
    mask = jnp.asarray(mask)
    data_leaves = jax.tree_util.tree_leaves((obs, cam_idx, mask))
    key = _solver_cache_key("schur_obs", pair_fn, options, jit, x0,
                            data_leaves)
    solve = _solver_cache_get(key)
    if solve is None:
        spec = mf.tangent_spec(x0)
        # Internal camera-locality sort: when the
        # caller's landmark order defeats the windowed matmul reduction but
        # a primary-camera sort admits it, route through the bucket
        # machinery as ONE sorted slab (x stays in the caller's order;
        # steps are un-permuted by a static gather).  Host decision from
        # concrete indices; traced builds keep the natural order.
        perm = None
        if options.hessian.schur_sort == "auto":
            try:
                import numpy as np
                n_a = jnp.shape(
                    jax.tree_util.tree_leaves(x0[0])[0])[0]
                perm = camera_sort_perm(np.asarray(cam_idx),
                                        np.asarray(mask), int(n_a),
                                        int(cam_idx.shape[1]))
            except Exception:
                perm = None
        if perm is not None:
            permj = jnp.asarray(perm, jnp.int32)
            slab = (jax.tree_util.tree_map(
                        lambda l: jnp.asarray(l)[permj], obs),
                    cam_idx[permj], mask[permj], perm)
            acc, ev, n_res, propose = schur_obs_bucket_system(
                pair_fn, x0[0], x0[1], [slab], spec)
        else:
            acc, ev, n_res, propose = schur_obs_system(
                pair_fn, x0[0], x0[1], obs, cam_idx, mask, spec)

        def solve(x):
            return optimize_from_acc(x, acc, ev, options, spec,
                                     propose=propose)

        if jit:
            solve = _jit_solve(solve, x0, data_leaves)
        _solver_cache_put(key, solve, data_leaves)
    return solve(x0)


def schur_sparse_optimize_buckets(x0: tuple, pair_fn: Callable, slabs,
                                  options: Options | None = None, *,
                                  jit: bool = True):
    """Sparse-observation BA over a K-BUCKETED point-major layout.

    For HEAVY-TAILED visibility (published BAL: mean ~6 obs/landmark,
    max in the hundreds) a single (n_b, K_max) padded slab inflates
    memory 10-50×; ``slabs`` instead groups landmarks by observation
    count — each entry ``(obs, cam_idx, mask, ids)`` is a padded slab
    with its own K cap plus the static original-landmark indices of its
    rows (``ops.schur_obs.bucket_obs`` builds them from a padded
    layout; ``models.bal.load_bal(layout="bucketed")`` from a BAL
    file).  Same elimination algebra as :func:`schur_sparse_optimize`
    (the reduced camera system sums over buckets; steps are
    un-permuted by one static gather), so trajectories match the
    single-slab layout up to summation order.  ``x0`` keeps the
    ORIGINAL landmark order.  LM/GN/DogLeg.
    """
    from .ops.schur_obs import schur_obs_bucket_system

    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError(
            "schur_sparse_optimize_buckets is a Gauss-Newton/LM method; "
            "use to.optimize with a first-order solver type for "
            "gradient-only solves")
    if not (isinstance(x0, tuple) and len(x0) == 2):
        raise ValueError("schur_sparse_optimize_buckets needs "
                         "x0 = (a0, b0)")
    x0 = (mf.as_pytree(x0[0]), mf.as_pytree(x0[1]))
    slabs = [(obs, jnp.asarray(ci, jnp.int32), jnp.asarray(mk), ids)
             for obs, ci, mk, ids in slabs]
    data_leaves = jax.tree_util.tree_leaves(
        [(obs, ci, mk) for obs, ci, mk, _ in slabs])
    key = _solver_cache_key(
        "schur_obs_buckets", pair_fn, options, jit, x0, data_leaves,
        extra=tuple(np.asarray(ids).tobytes() for *_, ids in slabs))
    solve = _solver_cache_get(key)
    if solve is None:
        spec = mf.tangent_spec(x0)
        acc, ev, n_res, propose = schur_obs_bucket_system(
            pair_fn, x0[0], x0[1], slabs, spec)

        def solve(x):
            return optimize_from_acc(x, acc, ev, options, spec,
                                     propose=propose)

        if jit:
            solve = _jit_solve(solve, x0, data_leaves)
        _solver_cache_put(key, solve, data_leaves)
    return solve(x0)


def schur_sparse_covariance_buckets(x, pair_fn: Callable, slabs, *,
                                    rescaled: bool = False,
                                    chunk: int = 1024,
                                    jit: bool = True):
    """Posterior marginal covariance blocks of a K-BUCKETED solution —
    the covariance companion of :func:`schur_sparse_optimize_buckets`,
    with :func:`schur_sparse_covariance` semantics (camera marginals =
    S⁻¹ diag blocks with S summed over buckets; landmark blocks
    chunked per bucket; ``rescaled`` per output.h:80-93).  Returns
    ``(cov_a, cov_b)`` with ``cov_b`` in the original landmark order.
    """
    from .ops.schur_obs import (obs_marginals_buckets,
                                schur_obs_bucket_system)

    if not (isinstance(x, tuple) and len(x) == 2):
        raise ValueError("schur_sparse_covariance_buckets needs "
                         "x = (a, b)")
    x = (mf.as_pytree(x[0]), mf.as_pytree(x[1]))
    slabs = [(obs, jnp.asarray(ci, jnp.int32), jnp.asarray(mk), ids)
             for obs, ci, mk, ids in slabs]
    ids_list = [ids for *_, ids in slabs]
    data_leaves = jax.tree_util.tree_leaves(
        [(obs, ci, mk) for obs, ci, mk, _ in slabs])
    key = _solver_cache_key(
        "schur_obs_buckets_cov", pair_fn, None, jit, x, data_leaves,
        extra=(rescaled, chunk) + tuple(
            np.asarray(ids).tobytes() for ids in ids_list))
    compute = _solver_cache_get(key)
    if compute is None:
        spec = mf.tangent_spec(x)
        acc, _, _, _ = schur_obs_bucket_system(pair_fn, x[0], x[1],
                                               slabs, spec, chunk)

        def compute(xv):
            H, _, cost = acc(xv)
            cov_a, cov_b = obs_marginals_buckets(H, ids_list, chunk)
            if rescaled:
                from .ops.linalg import cov_rescale
                f = cov_rescale(cost.cost, cost.num_residuals, spec.dims)
                cov_a, cov_b = cov_a * f, cov_b * f
            return cov_a, cov_b

        if jit:
            compute = jax.jit(compute)
        _solver_cache_put(key, compute, data_leaves)
    return compute(x)


def schur_sparse_covariance(x, pair_fn: Callable, obs, cam_idx, mask,
                            *, rescaled: bool = False,
                            chunk: int = 1024, jit: bool = True):
    """Posterior marginal covariance blocks of a sparse-obs BA solution.

    The covariance companion of :func:`schur_sparse_optimize` — call at
    the solution ``x = (a, b)`` with the same observation layout.
    Returns ``(cov_a (n_a, da, da), cov_b (n_b, db, db))``: per-camera
    and per-landmark marginal covariance blocks of H(x)⁻¹
    (element-major tangent layout per block).  Computed from the
    factored reduced camera system — S⁻¹ IS the camera marginal
    covariance (marginalizing landmarks is the Schur complement) and the
    landmark blocks follow as C⁻¹ + C⁻¹EᵀS⁻¹EC⁻¹ — one (n_a·da)²
    inverse plus chunked per-point algebra; the (dims)² dense H⁻¹ the
    reference computes (math.h:88-189, output.h:80-93) is never formed
    (156k² ≈ 97 GB at the 1000-camera flagship scale; these marginals
    are ~4 MB).  ``rescaled=True`` applies the reference's
    overdetermined rescale ``cost²/(n_res − dims)`` (output.h:80-93),
    identical to ``Output.covariance(rescaled=True)``.  NaNs if H is
    singular (gauge not fixed) — ops/linalg.inv_cov's contract.
    """
    from .ops.schur_obs import (banded_cov_plan, camera_sort_perm,
                                obs_marginals, obs_marginals_banded,
                                schur_obs_system)

    if not (isinstance(x, tuple) and len(x) == 2):
        raise ValueError("schur_sparse_covariance needs x = (a, b)")
    x = (mf.as_pytree(x[0]), mf.as_pytree(x[1]))
    cam_idx = jnp.asarray(cam_idx, jnp.int32)
    mask = jnp.asarray(mask)
    # Banded covariance at scale (r5): covariance is a pure function of
    # the solution, so an internal landmark permutation is free — sort
    # for camera locality when it enables the banded selected-inverse
    # path (neither the (n_a, n_a) S grid nor the dense S⁻¹ exists).
    iperm = None
    n_a_ = int(jnp.shape(jax.tree_util.tree_leaves(x[0])[0])[0])
    da_ = mf.tangent_spec(
        jax.tree_util.tree_map(lambda l: l[0], x[0])).dims
    cov_band = banded_cov_plan(cam_idx, mask, n_a_, da_, chunk)
    if cov_band is None:
        try:
            import numpy as np
            perm = camera_sort_perm(np.asarray(cam_idx),
                                    np.asarray(mask), n_a_,
                                    int(cam_idx.shape[1]), chunk)
        except Exception:
            perm = None
        if perm is not None:
            import numpy as np
            permj = jnp.asarray(perm, jnp.int32)
            obs = jax.tree_util.tree_map(
                lambda l: jnp.asarray(l)[permj], obs)
            cam_idx, mask = cam_idx[permj], mask[permj]
            x = (x[0], jax.tree_util.tree_map(
                lambda l: l[permj], x[1]))
            iperm = jnp.asarray(np.argsort(perm), jnp.int32)
            cov_band = banded_cov_plan(cam_idx, mask, n_a_, da_,
                                       chunk)
    data_leaves = jax.tree_util.tree_leaves((obs, cam_idx, mask))
    key = _solver_cache_key("schur_obs_cov", pair_fn, None, jit, x,
                            data_leaves, extra=(rescaled, chunk))
    compute = _solver_cache_get(key)
    if compute is None:
        spec = mf.tangent_spec(x)
        acc, _, _, _ = schur_obs_system(pair_fn, x[0], x[1], obs,
                                        cam_idx, mask, spec, chunk)

        def compute(xv):
            H, _, cost = acc(xv)
            if cov_band is not None:
                band_g, bw, bplan = cov_band
                cov_a, cov_b = obs_marginals_banded(H, band_g, bw,
                                                    bplan, chunk)
            else:
                cov_a, cov_b = obs_marginals(H, chunk)
            if rescaled:
                from .ops.linalg import cov_rescale
                f = cov_rescale(cost.cost, cost.num_residuals, spec.dims)
                cov_a, cov_b = cov_a * f, cov_b * f
            if iperm is not None:
                cov_b = cov_b[iperm]     # back to caller landmark order
            return cov_a, cov_b

        if jit:
            compute = jax.jit(compute)
        _solver_cache_put(key, compute, data_leaves)
    return compute(x)
