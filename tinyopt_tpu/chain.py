"""Chain-structured NLLS: the direct pose-graph / odometry solver.

``chain_optimize`` solves graphs of N parameter blocks (e.g. a batched
SE3 trajectory) connected by binary measurements.  Edges between
CONSECUTIVE blocks (j == i+1 — the odometry backbone) assemble a
block-tridiagonal Gauss-Newton Hessian, factored exactly by one-scan
block Cholesky; every other edge (loop closures) enters as columns of a
low-rank factor U handled by the Woodbury identity — so the per-
iteration solve is O(N·d³ + N·d²·m + m³) with m = Σ loop residual dims,
independent of the chain's O(N²) condition number (see ops/tridiag.py).

This covers the regime between ``to.optimize`` (dense H — hundreds of
dims) and ``sparse_optimize`` (general pattern, but Jacobi-PCG needs
O(N) iterations on a chain): pose graphs with thousands of poses and
tens-to-hundreds of loop closures solve exactly per iteration.  The
reference's sparse path delegates this to Eigen's SimplicialLDLT
(reference: solvers/gn.h:63-74, math.h:266-277, tests/sparse.cpp:19-85);
this is the accelerator equivalent for chain+loops structure.

Requirements: m ≪ N·d (many loop closures → use ``sparse_optimize`` /
``matfree_optimize``); the gauge must be fixed (anchor unary residual)
or LM damping relied on for the GN-singular directions.
Covariance: :func:`chain_marginals` (per-pose (d, d) marginal blocks by
the Takahashi selected-inverse recursion off the same block-tridiagonal
factor, with the Woodbury rank-m downdate — O(N·d³), never densifies;
ops/tridiag.tridiag_woodbury_marginals), or ``Output.covariance()`` /
``ChainSystem.inv()`` for the full dense H⁻¹ at small N.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import manifold as mf
from .cost import Cost, rss as rss_exact
from .diff.auto import flatten_residuals
from .optimizers.loop import optimize_from_acc
from .options import FIRST_ORDER_TYPES, Options, SolverType
from .ops.tridiag import (tridiag_woodbury_marginals,
                          tridiag_woodbury_solve)
from .sparse import (_solver_cache_get, _solver_cache_key,
                     _solver_cache_put)


class ChainSystem(NamedTuple):
    """Pluggable Hessian carrier for the loop: T = tridiag(D, B) plus
    the loop-closure factor U (H = T + U·Uᵀ); ``diag`` is the FULL
    Hessian diagonal (incl. U's contribution) for multiplicative LM
    damping (lm.h:107-117 semantics via the same rule as
    ops/schur._damp_blocks)."""

    D: jax.Array      #: (N, d, d) diagonal blocks of T
    B: jax.Array      #: (N-1, d, d) sub-diagonal blocks (T[i+1, i])
    U: jax.Array      #: (N, d, m) loop-closure factor
    diag: jax.Array   #: (N, d) full diag(H)

    def matvec(self, v: jax.Array) -> jax.Array:
        """H·v for a flat element-major tangent v (N·d,).

        HIGHEST precision: DEFAULT lets a GPU round f32 dot_general
        operands to TF32 (10-bit mantissa), and the chain's O(N²)
        conditioning amplifies that rounding (the tridiag solves that
        consume this system are pinned the same way)."""
        N, d, _ = self.D.shape
        v2 = v.reshape(N, d)
        with jax.default_matmul_precision("highest"):
            o = jnp.einsum("nab,nb->na", self.D, v2)
            if N > 1:
                o = o.at[1:].add(
                    jnp.einsum("nab,nb->na", self.B, v2[:-1]))
                o = o.at[:-1].add(
                    jnp.einsum("nba,nb->na", self.B, v2[1:]))
            if self.U.shape[-1]:
                w = jnp.einsum("ndm,nd->m", self.U, v2)
                o = o + jnp.einsum("ndm,m->nd", self.U, w)
        return o.reshape(-1)

    @property
    def dims(self) -> int:
        N, d, _ = self.D.shape
        return N * d

    @property
    def shape(self):
        return (self.dims, self.dims)

    @property
    def dtype(self):
        return self.D.dtype

    def marginals(self) -> jax.Array:
        """Per-pose marginal covariance blocks (N, d, d): the diagonal
        blocks of H⁻¹ by the Takahashi selected-inverse recursion off
        the block-tridiagonal factor, Woodbury-downdated for the loop
        closures (ops/tridiag.tridiag_woodbury_marginals) — O(N·d³ +
        N·d²·m), never densifies.  Blocks are element-major per pose.
        NaNs if H is singular (gauge not fixed; inv_cov contract)."""
        marg, ok = tridiag_woodbury_marginals(self.D, self.B, self.U)
        return jnp.where(ok, marg, jnp.nan)

    def to_dense(self) -> jax.Array:
        """Assemble the full (N·d)² H (testing / small-N covariance)."""
        eye = jnp.eye(self.dims, dtype=self.dtype)
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(eye)

    def inv(self):
        """Full dense H⁻¹ (``Output.covariance`` contract — small N
        only: densifies).  At scale use :meth:`marginals` /
        :func:`chain_marginals`."""
        from .ops.linalg import inv_cov
        from .ops.schur import _SchurCov
        return _SchurCov(inv_cov(self.to_dense()))


#: Tridiagonal solve for ``method="auto"`` on each platform.  The CPU
#: takes the sequential ``scan`` (fewest flops).  On an H100 the N-step
#: scan of tiny ops is latency-bound: 11.6-11.8 s per 5000-pose solve
#: against 0.13-0.22 s for log-depth cyclic reduction (both met the
#: cost criterion).
_CHAIN_METHOD = {"cpu": "scan", "gpu": "cr"}


def default_chain_method(platform: str) -> str:
    """Tridiagonal solve for ``method="auto"`` on ``platform``."""
    return _CHAIN_METHOD[platform]


def chain_system(x0, edge_fn: Callable, edges: np.ndarray, edge_data,
                 unary_fn: Callable | None, unary_nodes, unary_data,
                 spec: mf.TangentSpec, method: str = "auto"):
    """Build (accumulate, evaluate, n_res, propose) for a chain graph.

    ``edge_fn(x_i, x_j, data_e) -> (me,)`` one binary measurement;
    ``edges`` STATIC (E, 2) ints; ``unary_fn(x_n, data_n) -> (mu,)``
    over static ``unary_nodes`` fixes the gauge (e.g. the pose-0
    anchor).  Edges with j == i+1 form the tridiagonal backbone; all
    others become Woodbury columns.
    """
    leaves = jax.tree_util.tree_leaves(mf.as_pytree(x0))
    N = int(jnp.shape(leaves[0])[0])
    x_ex = jax.tree_util.tree_map(lambda l: l[0], mf.as_pytree(x0))
    spec_e = mf.tangent_spec(x_ex)
    d = spec_e.dims
    dtype = spec.dtype

    edges = np.asarray(edges)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be (E, 2) ints, got {edges.shape}")
    if np.any(edges[:, 0] == edges[:, 1]):
        raise ValueError("self-edges (i == j) are not binary "
                         "measurements; use unary_fn for priors")
    E = edges.shape[0]
    chain_sel = np.where(edges[:, 1] == edges[:, 0] + 1)[0]
    loop_sel = np.where(edges[:, 1] != edges[:, 0] + 1)[0]
    Lc = int(loop_sel.size)

    e_data_ex = jax.tree_util.tree_map(lambda l: l[0], edge_data)
    me = int(sum(math.prod(l.shape) for l in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda a, b, dd: flatten_residuals(
            edge_fn(a, b, dd)), x_ex, x_ex, e_data_ex))))
    mu = 0
    if unary_fn is not None:
        unary_nodes = np.asarray(unary_nodes, np.int32).ravel()
        u_data_ex = jax.tree_util.tree_map(lambda l: l[0], unary_data)
        mu = int(sum(math.prod(l.shape)
                     for l in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda a, dd: flatten_residuals(
                unary_fn(a, dd)), x_ex, u_data_ex))))
    n_res = E * me + (len(unary_nodes) * mu if unary_fn is not None
                      else 0)

    ei = jnp.asarray(edges[:, 0], jnp.int32)
    ej = jnp.asarray(edges[:, 1], jnp.int32)
    em2gl = mf.element_perm(mf.as_pytree(x0), N)
    gl2em = None
    if em2gl is not None:
        gl2em = np.empty_like(em2gl)
        gl2em[em2gl] = np.arange(em2gl.size)

    def edge_linearize(x):
        """(r, Ji, Jj) for every edge: one joint-2d-tangent jacfwd per
        edge under vmap (shares the primal chain across both blocks)."""
        x_i = jax.tree_util.tree_map(lambda l: l[ei], x)
        x_j = jax.tree_util.tree_map(lambda l: l[ej], x)

        def one(a, b, dd):
            def r_of(t):
                return flatten_residuals(edge_fn(
                    mf.retract(a, t[:d], spec_e),
                    mf.retract(b, t[d:], spec_e), dd)).astype(dtype)

            z = jnp.zeros((2 * d,), dtype)
            return r_of(z), jax.jacfwd(r_of)(z)

        r, J = jax.vmap(one)(x_i, x_j, edge_data)
        return r, J[..., :d], J[..., d:]

    def unary_linearize(x):
        x_n = jax.tree_util.tree_map(lambda l: l[unary_nodes], x)

        def one(a, dd):
            def r_of(t):
                return flatten_residuals(unary_fn(
                    mf.retract(a, t, spec_e), dd)).astype(dtype)

            z = jnp.zeros((d,), dtype)
            return r_of(z), jax.jacfwd(r_of)(z)

        return jax.vmap(one)(x_n, unary_data)

    def accumulate(x):
        # HIGHEST precision on every assembly contraction: DEFAULT lets
        # a GPU round f32 dot_general operands to TF32, and the
        # resulting Hessian/gradient error can stall an f32 pose-graph
        # run (same failure mode as the Schur paths; ops/tridiag.py
        # pins its solves, but consumed D/B/U/g must be exact too).
        x = mf.as_pytree(x)
        r, Ji, Jj = edge_linearize(x)
        rss = rss_exact(r)
        with jax.default_matmul_precision("highest"):
            # gradient: every edge endpoint (loops incl. — g is exact)
            g_contrib = jnp.concatenate([
                jnp.einsum("ema,em->ea", Ji, r),
                jnp.einsum("ema,em->ea", Jj, r)])
            g = jax.ops.segment_sum(
                g_contrib, jnp.concatenate([ei, ej]), num_segments=N)
            # tridiagonal backbone: chain edges only
            Jic, Jjc = Ji[chain_sel], Jj[chain_sel]
            cci = ei[chain_sel]
            D = jax.ops.segment_sum(
                jnp.concatenate([jnp.einsum("ema,emb->eab", Jic, Jic),
                                 jnp.einsum("ema,emb->eab", Jjc, Jjc)]),
                jnp.concatenate([cci, cci + 1]), num_segments=N)
            B = jax.ops.segment_sum(
                jnp.einsum("ema,emb->eab", Jjc, Jic), cci,
                num_segments=max(N - 1, 1))[:N - 1]
            if unary_fn is not None:
                ru, Ju = unary_linearize(x)
                rss = rss + rss_exact(ru)
                g = g.at[unary_nodes].add(
                    jnp.einsum("nma,nm->na", Ju, ru))
                D = D.at[unary_nodes].add(
                    jnp.einsum("nma,nmb->nab", Ju, Ju))
            # loop closures: Woodbury cols (each edge owns its me cols)
            U4 = jnp.zeros((N, d, Lc, me), dtype)
            if Lc:
                li, lj = ei[loop_sel], ej[loop_sel]
                ar = jnp.arange(Lc)
                U4 = U4.at[li, :, ar, :].add(
                    jnp.transpose(Ji[loop_sel], (0, 2, 1)))
                U4 = U4.at[lj, :, ar, :].add(
                    jnp.transpose(Jj[loop_sel], (0, 2, 1)))
            U = U4.reshape(N, d, Lc * me)
            diag = (jnp.diagonal(D, axis1=-2, axis2=-1)
                    + jnp.einsum("ndm,ndm->nd", U, U))
        g_flat = g.reshape(-1)
        if em2gl is not None:
            g_flat = g_flat[em2gl]
        return (ChainSystem(D, B, U, diag), g_flat,
                Cost.make(rss, n_res))

    def evaluate(x):
        x = mf.as_pytree(x)
        x_i = jax.tree_util.tree_map(lambda l: l[ei], x)
        x_j = jax.tree_util.tree_map(lambda l: l[ej], x)
        r = jax.vmap(lambda a, b, dd: flatten_residuals(
            edge_fn(a, b, dd)).astype(dtype))(x_i, x_j, edge_data)
        rss = rss_exact(r)
        if unary_fn is not None:
            x_n = jax.tree_util.tree_map(lambda l: l[unary_nodes], x)
            ru = jax.vmap(lambda a, dd: flatten_residuals(
                unary_fn(a, dd)).astype(dtype))(x_n, unary_data)
            rss = rss + rss_exact(ru)
        return Cost.make(rss, n_res)

    eye = jnp.eye(d, dtype=dtype)

    def damped(H: ChainSystem, lam):
        add = jnp.where(H.diag == 0, lam, H.diag * lam)
        return H.D + eye * add[..., None, :]

    if method == "auto":
        method = default_chain_method(jax.default_backend())
    if method not in ("scan", "cr"):
        raise ValueError(f"method must be auto|scan|cr, got {method!r}")

    def solve_at(H: ChainSystem, g, lam_or_none):
        Dd = H.D if lam_or_none is None else damped(H, lam_or_none)
        g2 = (g if gl2em is None else g[gl2em]).reshape(-1, d)
        dx2, ok = tridiag_woodbury_solve(Dd, H.B, H.U, -g2,
                                         method=method)
        dx = dx2.reshape(-1)
        if em2gl is not None:
            dx = dx[em2gl]
        return dx, ok

    def propose(H: ChainSystem, g, lam, opts):
        if opts.solver_type == SolverType.DOGLEG:
            from .solvers.step import dogleg_core  # local: avoid cycle

            dx_gn, ok_gn = solve_at(H, g, None)
            g_em = g if gl2em is None else g[gl2em]
            gHg = jnp.vdot(g_em, H.matvec(g_em))
            return dogleg_core(g, lam, dx_gn, ok_gn, gHg,
                               lambda le: solve_at(H, g, le))
        is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
        return solve_at(H, g, lam if is_lm else None)

    return accumulate, evaluate, n_res, propose


def chain_optimize(x0, edge_fn: Callable, edges, edge_data=None,
                   options: Options | None = None, *,
                   unary_fn: Callable | None = None, unary_nodes=None,
                   unary_data=None, method: str = "auto",
                   jit: bool = True):
    """Solve a chain-structured NLLS graph (pose graph / odometry SLAM).

    ``x0``: leading-axis batched parameter pytree of N blocks (e.g. a
    batched SE3 trajectory).  ``edge_fn(x_i, x_j, data_e) -> (me,)``
    evaluates one binary measurement for the STATIC (E, 2) ``edges``
    index array (``edge_data`` leaves have leading axis E).  Edges with
    j == i+1 form the block-tridiagonal odometry backbone (exact
    one-scan Cholesky); all other edges are loop closures folded in by
    the Woodbury identity.  ``unary_fn(x_n, data_n)`` over
    ``unary_nodes`` adds priors (fix the gauge by anchoring a pose).
    Returns ``(x_opt, Output)``; LM / GN / DogLeg.
    """
    options = options or Options()
    if options.solver_type in FIRST_ORDER_TYPES:
        raise ValueError(
            "chain_optimize is a Gauss-Newton/LM method; use to.optimize "
            "with a first-order solver type for gradient-only solves")
    x0 = mf.as_pytree(x0)
    edges = np.asarray(edges)
    data_leaves = jax.tree_util.tree_leaves((edge_data, unary_data))
    key = _solver_cache_key(
        "chain", edge_fn, options, jit, x0, data_leaves,
        extra=(edges.tobytes(), unary_fn, method,
               None if unary_nodes is None
               else np.asarray(unary_nodes).tobytes()))
    solve = _solver_cache_get(key)
    if solve is None:
        spec = mf.tangent_spec(x0)
        acc, ev, n_res, propose = chain_system(
            x0, edge_fn, edges, edge_data, unary_fn, unary_nodes,
            unary_data, spec, method=method)

        def solve(x):
            return optimize_from_acc(x, acc, ev, options, spec,
                                     propose=propose)

        if jit:
            solve = jax.jit(solve)
        _solver_cache_put(key, solve, data_leaves)
    return solve(x0)


def chain_marginals(x, edge_fn: Callable, edges, edge_data=None, *,
                    unary_fn: Callable | None = None, unary_nodes=None,
                    unary_data=None, rescaled: bool = False,
                    jit: bool = True):
    """Per-pose posterior marginal covariance of a chain-graph solution.

    The covariance companion of :func:`chain_optimize` — call at the
    solution ``x`` with the same graph.  Returns ``marg (N, d, d)``:
    the diagonal blocks of H(x)⁻¹ (element-major tangent layout per
    pose) by the Takahashi selected-inverse recursion off the
    block-tridiagonal factor with the Woodbury loop-closure downdate
    (ops/tridiag.py) — O(N·d³ + N·d²·m), so a 5000-pose graph's
    marginals cost one extra factorization instead of the (N·d)² dense
    inverse the reference's covariance takes (math.h:88-189).
    ``rescaled=True`` applies the reference's overdetermined rescale
    ``cost²/(n_res − dims)`` (output.h:80-93), identical to
    ``Output.covariance(rescaled=True)``.  NaNs if H is singular (gauge
    not fixed).
    """
    x = mf.as_pytree(x)
    edges = np.asarray(edges)
    data_leaves = jax.tree_util.tree_leaves((edge_data, unary_data))
    key = _solver_cache_key(
        "chain_cov", edge_fn, None, jit, x, data_leaves,
        extra=(edges.tobytes(), unary_fn, rescaled,
               None if unary_nodes is None
               else np.asarray(unary_nodes).tobytes()))
    compute = _solver_cache_get(key)
    if compute is None:
        spec = mf.tangent_spec(x)
        acc, _, n_res, _ = chain_system(
            x, edge_fn, edges, edge_data, unary_fn, unary_nodes,
            unary_data, spec)

        def compute(xv):
            H, _, cost = acc(xv)
            marg = H.marginals()
            if rescaled:
                from .ops.linalg import cov_rescale
                marg = marg * cov_rescale(
                    cost.cost, cost.num_residuals, spec.dims)
            return marg

        if jit:
            compute = jax.jit(compute)
        _solver_cache_put(key, compute, data_leaves)
    return compute(x)
