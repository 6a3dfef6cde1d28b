"""Schur-complement normal equations for bipartite NLLS (bundle adjustment).

The canonical structure of BA/SfM/calibration problems: two parameter
families A (cameras) and B (landmarks) where every residual block couples
exactly ONE element of each.  The normal equations then have the arrow
shape

    [ Ba  E ] [dx_a]   [-g_a]
    [ Eᵀ  C ] [dx_b] = [-g_b]

with Ba block-diagonal over A-elements, C block-diagonal over B-elements
(3x3 for landmarks), and E the bipartite coupling.  Eliminating B gives
the reduced camera system

    S dx_a = -g_a + E C⁻¹ g_b,      S = Ba − E C⁻¹ Eᵀ
    dx_b   = C⁻¹ (−g_b − Eᵀ dx_a)

— the structure every production BA solver exploits (Brown 1958; Triggs
et al. 1999), and the regime the reference concedes ("not fast for large
systems yet", /root/reference/README.md:30).

Formulation: observations live in a DENSE (n_a, n_b) grid with
a visibility mask (zero rows contribute zero residual AND zero Jacobian),
so every stage is a batched einsum — per-pair Jacobians by
vmapped forward-mode AD, the block products (Ba, C, E, g), the batched
3x3 (db x db) Cholesky inverse of C, the S assembly, and one dense
Cholesky of the (n_a·da)² reduced system.  J and the full H never exist;
the largest intermediate is E at (n_a, n_b, da, db).

Plugs into the standard loop via ``optimize_from_acc(propose=...)``:
``accumulate`` returns the :class:`SchurSystem` as the pluggable H, and
``propose`` performs damping + elimination + back-substitution
(multiplicative (1+λ)·diag damping on Ba and C — reference lm.h:107-117
semantics; absolute λ on structurally-zero diagonals like
ops/linalg.damp_diagonal).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from .. import manifold as mf
from ..cost import Cost, rss as rss_exact
from ..diff.auto import flatten_residuals
from ..options import SolverType
from .linalg import inv_cov, solve_psd



def _esum(spec, *ops, **kw):
    """einsum pinned to HIGHEST multiply precision (see
    ops/schur_obs._esum: at DEFAULT a GPU may round f32 multiplies to
    TF32, corrupting the assembled blocks; the assembly contractions are
    bandwidth-bound so the exact multiply is ~free)."""
    kw.setdefault("precision", jax.lax.Precision.HIGHEST)
    return jnp.einsum(spec, *ops, **kw)

class SchurSystem(NamedTuple):
    """Arrow-shaped normal equations (the pluggable H of the loop).

    All public vector interfaces (``matvec``, ``to_dense``, ``inv`` and
    the g/dx of the owning system's accumulate/propose) use the LOOP'S
    global leaf-major tangent layout; the internal block algebra is
    element-major.  ``em2gl``/``gl2em`` (None for single-leaf element
    pytrees, where the layouts coincide) adapt between the two — see
    :func:`tinyopt_tpu.manifold.element_perm`.
    """

    Ba: jax.Array   #: (n_a, da, da) A-side diagonal blocks
    C: jax.Array    #: (n_b, db, db) B-side diagonal blocks
    E: jax.Array    #: (n_a, n_b, da, db) coupling blocks
    em2gl: Any = None  #: element-major → global layout index (or None)
    gl2em: Any = None  #: global → element-major layout index (or None)

    @property
    def dims(self) -> int:
        n_a, da, _ = self.Ba.shape
        n_b, db, _ = self.C.shape
        return n_a * da + n_b * db

    @property
    def shape(self):
        d = self.dims
        return (d, d)

    @property
    def dtype(self):
        return self.Ba.dtype

    def _to_gl(self, v: jax.Array) -> jax.Array:
        return v if self.em2gl is None else v[self.em2gl]

    def _to_em(self, v: jax.Array) -> jax.Array:
        return v if self.gl2em is None else v[self.gl2em]

    def to_dense(self) -> jax.Array:
        """Assemble the full arrow-shaped H (for covariance / testing),
        in the loop's global tangent layout."""
        n_a, da, _ = self.Ba.shape
        n_b, db, _ = self.C.shape
        ia, ib = jnp.arange(n_a), jnp.arange(n_b)
        A = (jnp.zeros((n_a, da, n_a, da), self.dtype)
             .at[ia, :, ia, :].set(self.Ba).reshape(n_a * da, n_a * da))
        Cf = (jnp.zeros((n_b, db, n_b, db), self.dtype)
              .at[ib, :, ib, :].set(self.C).reshape(n_b * db, n_b * db))
        Ef = self.E.transpose(0, 2, 1, 3).reshape(n_a * da, n_b * db)
        H = jnp.block([[A, Ef], [Ef.T, Cf]])
        if self.em2gl is not None:
            H = H[self.em2gl][:, self.em2gl]
        return H

    def matvec(self, v: jax.Array) -> jax.Array:
        """H·v without assembling H (arrow-block products); ``v`` and the
        result are in the loop's global tangent layout."""
        n_a, da, _ = self.Ba.shape
        n_b, db, _ = self.C.shape
        v = self._to_em(v)
        v_a = v[:n_a * da].reshape(n_a, da)
        v_b = v[n_a * da:].reshape(n_b, db)
        o_a = (_esum("iab,ib->ia", self.Ba, v_a)
               + _esum("ijab,jb->ia", self.E, v_b))
        o_b = (_esum("jab,jb->ja", self.C, v_b)
               + _esum("ijab,ia->jb", self.E, v_a))
        return self._to_gl(
            jnp.concatenate([o_a.reshape(-1), o_b.reshape(-1)]))

    def inv(self) -> "_SchurCov":
        """Posterior covariance H⁻¹ by block inversion (Schur complement):
        cov_aa = S⁻¹, cov_ab = −S⁻¹EC⁻¹, cov_bb = C⁻¹ + C⁻¹EᵀS⁻¹EC⁻¹ —
        one (n_a·da)² inverse plus batched (db×db) inverses, never a dense
        solve of the full (dims)² system.  NaNs if singular (covariance
        contract of ops/linalg.inv_cov)."""
        n_a, da, _ = self.Ba.shape
        n_b, db, _ = self.C.shape
        dtype = self.dtype
        Cinv = jnp.linalg.inv(self.C)                     # (n_b, db, db)
        EC = _esum("ijab,jbc->ijac", self.E, Cinv,
                        preferred_element_type=dtype)
        S_red = _esum("ijac,kjdc->ikad", EC, self.E,
                           preferred_element_type=dtype)
        ia = jnp.arange(n_a)
        S = ((-S_red).at[ia, ia].add(self.Ba)
             .transpose(0, 2, 1, 3).reshape(n_a * da, n_a * da))
        Sinv = inv_cov(S)                                 # (n_a·da)²
        ECf = EC.transpose(0, 2, 1, 3).reshape(n_a * da, n_b * db)
        cov_ab = -(Sinv @ ECf)
        ib = jnp.arange(n_b)
        Cinv_f = (jnp.zeros((n_b, db, n_b, db), dtype)
                  .at[ib, :, ib, :].set(Cinv).reshape(n_b * db, n_b * db))
        cov_bb = Cinv_f + ECf.T @ Sinv @ ECf
        cov = jnp.block([[Sinv, cov_ab], [cov_ab.T, cov_bb]])
        if self.em2gl is not None:
            cov = cov[self.em2gl][:, self.em2gl]
        return _SchurCov(cov)


class _SchurCov(NamedTuple):
    """Dense covariance wrapper (``Output.covariance`` calls
    ``final_hessian.inv().to_dense()`` on structured Hessians)."""

    dense: jax.Array

    def to_dense(self) -> jax.Array:
        return self.dense


def bipartite_perms(a0, b0, n_a: int, n_b: int, da: int, db: int):
    """Full-tangent (em2gl, gl2em) index arrays for a bipartite system.

    Element-major layout = [cam 0's da dims, cam 1's, …, landmark 0's db
    dims, …]; global layout = ``mf.tangent_spec((a0, b0))``'s leaf-major
    concatenation.  Returns ``(None, None)`` when they coincide (both
    sides single-leaf — the common case, zero overhead)."""
    import numpy as np

    p_a = mf.element_perm(a0, n_a)
    p_b = mf.element_perm(b0, n_b)
    if p_a is None and p_b is None:
        return None, None
    ia = p_a if p_a is not None else np.arange(n_a * da)
    ib = p_b if p_b is not None else np.arange(n_b * db)
    em2gl = np.concatenate([ia, n_a * da + ib])
    return jnp.asarray(em2gl), jnp.asarray(np.argsort(em2gl))


def _damp_blocks(M: jax.Array, lam) -> jax.Array:
    """Multiplicative (1+λ) diagonal damping per block; absolute λ on
    exactly-zero diagonal entries (ops/linalg.damp_diagonal semantics)."""
    d = M.shape[-1]
    eye = jnp.eye(d, dtype=M.dtype)
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    add = jnp.where(diag == 0, lam, diag * lam)
    return M + eye * add[..., None, :]  # broadcast add on diagonal


def linearize_grid(pair_fn: Callable, a, b, data, mask,
                   spec_a: mf.TangentSpec, spec_b: mf.TangentSpec, dtype):
    """Masked (r, Ja, Jb) of EVERY A-element against the given B-elements.

    ``a``/``b`` are leading-axis pytrees of elements; ``data``/``mask``
    carry the (n_a, n_b_cols, ...) observation grid for exactly the B
    columns passed in — callers may pass the full grid (schur_system) or
    one device's landmark shard (parallel.schur).  Shapes:
    r (n_a, n_b, m), Ja (n_a, n_b, m, da), Jb (n_a, n_b, m, db).

    AD is batched for vectorization: the da A-tangent sweeps each
    differentiate the whole (n_b, m) residual row at once, and the db
    B-tangent sweeps run under one vmap over the B axis — n_b·m wide XLA
    ops instead of n_a·n_b tiny per-pair traces (measured meaningfully
    faster at BA scale than per-pair ``jacfwd`` on the (da+db) product
    tangent).
    """
    da, db = spec_a.dims, spec_b.dims

    def pair_r(a_i, b_j, d_ij):
        return flatten_residuals(pair_fn(a_i, b_j, d_ij)).astype(dtype)

    def cam_lin(a_i, d_i, m_i):
        def row(a_r):
            return jax.vmap(
                lambda b_j, d_ij, m_ij: pair_r(a_r, b_j, d_ij) * m_ij)(
                    b, d_i, m_i)                          # (n_b, m)

        def row_of_da(delta_a):
            return row(mf.retract(a_i, delta_a, spec_a))

        za = jnp.zeros((da,), dtype)
        r = row_of_da(za)
        Ja = jax.jacfwd(row_of_da)(za)                    # (n_b, m, da)

        a_r0 = mf.retract(a_i, za, spec_a)

        def one_b(b_j, d_ij, m_ij):
            def r_of_db(delta_b):
                return pair_r(a_r0, mf.retract(b_j, delta_b, spec_b),
                              d_ij) * m_ij
            return jax.jacfwd(r_of_db)(jnp.zeros((db,), dtype))

        Jb = jax.vmap(one_b)(b, d_i, m_i)                 # (n_b, m, db)
        return r, Ja, Jb

    return jax.vmap(cam_lin)(a, data, mask)


def blocks_from(r, Ja, Jb, dtype):
    """Arrow-system blocks from the grid linearization.

    Returns ``(Ba, C, E, g_a, g_b, rss)``; when (r, Ja, Jb) cover only a
    landmark shard, ``Ba``/``g_a``/``rss`` are cross-shard PARTIALS (sum
    over landmarks — psum to complete) while ``C``/``E``/``g_b`` are the
    shard's own complete blocks.
    """
    Ba = _esum("ijra,ijrb->iab", Ja, Ja,
                    preferred_element_type=dtype)
    C = _esum("ijra,ijrb->jab", Jb, Jb,
                   preferred_element_type=dtype)
    E = _esum("ijra,ijrb->ijab", Ja, Jb,
                   preferred_element_type=dtype)
    g_a = _esum("ijra,ijr->ia", Ja, r)
    g_b = _esum("ijrb,ijr->jb", Jb, r)
    return Ba, C, E, g_a, g_b, rss_exact(r)


def schur_eliminate(E, Bd, Cd, g_a, g_b, use_cholesky=True,
                    reduce_fn=None, refine: int = 0,
                    cg_iters: int = 0):
    """Schur elimination + back-substitution of the (damped) arrow system
    [Bd, E; Eᵀ, Cd] dx = −g.  Returns ``(dx_a, dx_b, ok)``.

    ``reduce_fn`` completes cross-landmark partial sums (identity when E
    spans all landmarks; ``lax.psum`` over the mesh axis when it is one
    device's shard — parallel.schur).  ``ok`` covers the reduced solve
    and dx_a; the caller folds in dx_b finiteness (locally or globally).
    ``refine`` = hessian.schur_refine mixed-precision rounds on the
    reduced solve (ops/linalg.refine_psd_solve).
    """
    red = reduce_fn if reduce_fn is not None else (lambda t: t)
    n_a, da = g_a.shape
    db = g_b.shape[-1]

    # Batched inverse of the damped B-side blocks (db x db, PSD).
    # Closed-form adjugate at db<=3 (pure exact-f32 elementwise math;
    # XLA's batched Cholesky is a sequential kernel), Cholesky
    # fallback above: a non-PSD block yields NaNs either way -> ok
    # False -> the loop's λ-escalation (optimizer.h:356-399 route).
    from .schur_obs import spd_inv_blocks
    Cinv = spd_inv_blocks(Cd)

    EC = _esum("ijab,jbc->ijac", E, Cinv,
                    preferred_element_type=g_a.dtype)
    S_red = red(_esum("ijac,kjdc->ikad", EC, E,
                           preferred_element_type=g_a.dtype))
    idx = jnp.arange(n_a)
    # scatter-free diagonal add (ops/schur_obs._reconstruct_S docstring:
    # the fancy double-index diagonal scatter miscompiles on XLA CPU)
    S_blocks = -S_red + jnp.eye(n_a, dtype=S_red.dtype)[:, :, None, None] \
        * Bd.reshape(n_a, 1, *Bd.shape[1:])
    S = S_blocks.transpose(0, 2, 1, 3).reshape(n_a * da, n_a * da)
    rhs = (-g_a + red(_esum("ijac,jc->ia", EC, g_b))).reshape(-1)
    if cg_iters > 0:
        # hessian.schur_cg_iters: block-Jacobi PCG reduced solve
        # (inexact LM — ops/schur_obs.assemble_reduced rationale)
        from .linalg import pcg_core
        from .schur_obs import spd_inv_blocks as _inv
        Minv = _inv(S_blocks[idx, idx])

        def prec(r):
            return _esum("iab,ib->ia", Minv,
                         r.reshape(n_a, da)).reshape(-1)

        with jax.default_matmul_precision("highest"):
            dx_a = pcg_core(lambda p: S @ p, prec, rhs, cg_iters)
        ok = jnp.all(jnp.isfinite(dx_a))
    else:
        dx_a, ok = solve_psd(S, rhs, use_cholesky=use_cholesky)
        if refine > 0:
            from .linalg import refine_psd_solve
            dx_a = refine_psd_solve(S, rhs, dx_a, refine,
                                    use_cholesky=use_cholesky)
    dx_a = dx_a.reshape(n_a, da)
    dx_b = _esum(
        "jbc,jc->jb", Cinv,
        -g_b - _esum("ijab,ia->jb", E, dx_a))
    ok = ok & jnp.all(jnp.isfinite(dx_a))
    return dx_a, dx_b, ok


def schur_system(pair_fn: Callable, a0, b0, data, mask,
                 spec: mf.TangentSpec):
    """Build (accumulate, evaluate, n_res, propose) for a bipartite NLLS.

    ``pair_fn(a_i, b_j, data_ij) -> (m,) residuals`` evaluates one
    (A-element, B-element) observation; ``mask`` is (n_a, n_b) with 1 for
    observed pairs (masked pairs contribute zero residual and zero
    Jacobian — heterogeneous visibility with static shapes).  ``spec``
    must be ``mf.tangent_spec((a0, b0))`` — the loop's tangent layout is
    [A-tangents row-major; B-tangents row-major] (pytree order of the
    2-tuple).
    """
    a_leaves = jax.tree_util.tree_leaves(mf.as_pytree(a0))
    n_a = jnp.shape(a_leaves[0])[0]
    b_leaves = jax.tree_util.tree_leaves(mf.as_pytree(b0))
    n_b = jnp.shape(b_leaves[0])[0]
    a_ex = jax.tree_util.tree_map(lambda l: l[0], mf.as_pytree(a0))
    b_ex = jax.tree_util.tree_map(lambda l: l[0], mf.as_pytree(b0))
    spec_a = mf.tangent_spec(a_ex)
    spec_b = mf.tangent_spec(b_ex)
    da, db = spec_a.dims, spec_b.dims
    dtype = spec.dtype

    d_ex = jax.tree_util.tree_map(lambda l: l[0, 0], data)
    m = int(sum(math.prod(l.shape) for l in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda a, b, d: flatten_residuals(pair_fn(a, b, d)),
                       a_ex, b_ex, d_ex))))
    # Residual COUNT = observed pairs only (masked grid slots contribute
    # exactly-zero residuals but are NOT measurements): Cost.num_residuals
    # feeds inlier accounting, cost normalization, and the rescaled
    # covariance's (n − dims) divisor.
    n_res = jnp.count_nonzero(mask).astype(jnp.int32) * m

    def split(x):
        return x[0], x[1]

    def pair_r(a_i, b_j, d_ij):
        return flatten_residuals(pair_fn(a_i, b_j, d_ij)).astype(dtype)

    def grid(f, a, b):
        over_b = jax.vmap(f, in_axes=(None, 0, 0, 0))
        return jax.vmap(over_b, in_axes=(0, None, 0, 0))(a, b, data, mask)

    em2gl, gl2em = bipartite_perms(mf.as_pytree(a0), mf.as_pytree(b0),
                                   n_a, n_b, da, db)

    def accumulate(x):
        a, b = split(x)
        r, Ja, Jb = linearize_grid(pair_fn, mf.as_pytree(a),
                                   mf.as_pytree(b), data, mask,
                                   spec_a, spec_b, dtype)
        Ba, C, E, g_a, g_b, rss = blocks_from(r, Ja, Jb, dtype)
        g = jnp.concatenate([g_a.reshape(-1), g_b.reshape(-1)])
        if em2gl is not None:
            g = g[em2gl]
        return SchurSystem(Ba, C, E, em2gl, gl2em), g, Cost.make(rss, n_res)

    def evaluate(x):
        a, b = split(x)

        def one(a_i, b_j, d_ij, m_ij):
            return pair_r(a_i, b_j, d_ij) * m_ij

        r = grid(one, mf.as_pytree(a), mf.as_pytree(b))
        return Cost.make(rss_exact(r), n_res)

    def eliminate(H: SchurSystem, Bd, Cd, g, use_cholesky=True,
                  refine=0, cg_iters=0):
        """Schur elimination + back-substitution of the (damped) arrow
        system [Bd, E; Eᵀ, Cd] dx = −g. (dx, ok); g/dx in the loop's
        global layout, algebra element-major."""
        if gl2em is not None:
            g = g[gl2em]
        g_a = g[:n_a * da].reshape(n_a, da)
        g_b = g[n_a * da:].reshape(n_b, db)
        dx_a, dx_b, ok = schur_eliminate(H.E, Bd, Cd, g_a, g_b,
                                         use_cholesky=use_cholesky,
                                         refine=refine,
                                         cg_iters=cg_iters)
        dx = jnp.concatenate([dx_a.reshape(-1), dx_b.reshape(-1)])
        if em2gl is not None:
            dx = dx[em2gl]
        ok = ok & jnp.all(jnp.isfinite(dx_b))
        return dx, ok

    def propose(H: SchurSystem, g, lam, opts):
        """Damped Schur elimination per solver type. (dx, ok)."""
        use_chol = opts.hessian.use_ldlt
        refine = opts.hessian.schur_refine
        cg_it = opts.hessian.schur_cg_iters
        if opts.solver_type == SolverType.DOGLEG:
            # Dogleg over the elimination: GN point from the undamped
            # arrow solve, exact curvature via the block matvec, and the
            # regularized fallback re-eliminates with λ_eff block damping
            # (lazily, under lax.cond — solvers/step.dogleg_core).
            from ..solvers.step import dogleg_core  # local: avoid cycle

            dx_gn, ok_gn = eliminate(H, H.Ba, H.C, g, use_chol,
                                     refine, cg_it)
            return dogleg_core(
                g, lam, dx_gn, ok_gn, jnp.vdot(g, H.matvec(g)),
                lambda le: eliminate(H, _damp_blocks(H.Ba, le),
                                     _damp_blocks(H.C, le), g, use_chol,
                                     refine, cg_it))
        is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
        Bd = _damp_blocks(H.Ba, lam) if is_lm else H.Ba
        Cd = _damp_blocks(H.C, lam) if is_lm else H.C
        return eliminate(H, Bd, Cd, g, use_chol, refine, cg_it)

    return accumulate, evaluate, n_res, propose
