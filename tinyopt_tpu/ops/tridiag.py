"""Block-tridiagonal Cholesky + Woodbury low-rank correction.

The direct solver for CHAIN-structured normal equations — the pose-graph
/ odometry backbone of SLAM: N parameter blocks where consecutive blocks
are coupled by measurements (block-tridiagonal H₀) plus a handful of
loop-closure measurements that couple distant blocks (a rank-m update
U·Uᵀ with m = Σ loop residual dims ≪ N·d).

Design notes
------------
* The factorization is ONE ``lax.scan`` over the N blocks — the block
  recurrence is inherently sequential (each step's Cholesky depends on
  the previous factor), but every step is a fixed bundle of tiny (d×d)
  ops, so the whole factor+solve compiles to a single fused loop with no
  dynamic shapes.  Solves batch over right-hand sides: the k columns of
  ``b`` ride through the triangular solves as one (d, k) matmul per
  step, which is how the Woodbury correction gets T⁻¹U for all m
  columns in the SAME two sweeps that solve T⁻¹g.
* Exactness replaces iteration: a chain of N poses has condition number
  growing like O(N²), which is exactly where Jacobi-PCG (the general
  sparse path, ops/sparse_sym.py) needs O(N) iterations — the direct
  factorization is conditioning-independent and costs O(N·d³) once.
* Failure (non-PD after damping) surfaces as NaN from ``cholesky`` and
  is reported through ``ok`` for the loop's λ-escalation, mirroring the
  dense path's contract (solvers/step.propose_step; reference
  math.h:232-240 returns nullopt on LDLT failure).

The reference has no counterpart — its sparse path hands the whole
pattern to Eigen's SimplicialLDLT (reference: solvers/gn.h:63-74,
math.h:266-277); this module is the accelerator replacement for the
chain+loops regime (see tinyopt_tpu/chain.py for the optimizer entry).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular


def block_tridiag_factor(D: jax.Array, B: jax.Array):
    """Block Cholesky ``H₀ = L Lᵀ`` of the symmetric block-tridiagonal
    matrix with diagonal blocks ``D`` (N, d, d) and sub-diagonal blocks
    ``B`` (N-1, d, d) (``H₀[i+1, i] = B[i]``).

    Returns ``(L, M, ok)``: ``L`` (N, d, d) lower-triangular diagonal
    factor blocks, ``M`` (N-1, d, d) sub-diagonal factor blocks, and
    ``ok`` scalar bool (False when any pivot block was not PD — the
    factor then contains NaNs and must not be used).
    """
    N, d, _ = D.shape

    def step(L_prev, inp):
        D_i, B_im1 = inp
        # M_i L_prevᵀ = B_im1  ⇒  L_prev M_iᵀ = B_im1ᵀ
        Mt = solve_triangular(L_prev, B_im1.T, lower=True)
        M_i = Mt.T
        L_i = jnp.linalg.cholesky(D_i - M_i @ M_i.T)
        return L_i, (L_i, M_i)

    # HIGHEST matmul precision throughout: at DEFAULT a GPU may round
    # dot_general operands to TF32, and the chain's O(N²) conditioning
    # amplifies the rounding into factorization failure.
    with jax.default_matmul_precision("highest"):
        L0 = jnp.linalg.cholesky(D[0])
        if N == 1:
            L = L0[None]
            M = jnp.zeros((0, d, d), D.dtype)
        else:
            _, (L_rest, M) = jax.lax.scan(step, L0, (D[1:], B))
            L = jnp.concatenate([L0[None], L_rest])
    ok = jnp.all(jnp.isfinite(L))
    return L, M, ok


def block_tridiag_solve(L: jax.Array, M: jax.Array, b: jax.Array
                        ) -> jax.Array:
    """Solve ``H₀ x = b`` from the factor ``(L, M)``.

    ``b`` is (N, d) or (N, d, k) — k right-hand sides are solved
    together (each scan step's triangular solve is one (d, k) matmul).
    """
    squeeze = b.ndim == 2
    if squeeze:
        b = b[..., None]
    N = L.shape[0]

    with jax.default_matmul_precision("highest"):
        # forward: L y = b
        y0 = solve_triangular(L[0], b[0], lower=True)
        if N > 1:
            def fwd(y_prev, inp):
                L_i, M_im1, b_i = inp
                y_i = solve_triangular(L_i, b_i - M_im1 @ y_prev,
                                       lower=True)
                return y_i, y_i

            _, y_rest = jax.lax.scan(fwd, y0, (L[1:], M, b[1:]))
            y = jnp.concatenate([y0[None], y_rest])
        else:
            y = y0[None]

        # backward: Lᵀ x = y
        xN = solve_triangular(L[N - 1].T, y[N - 1], lower=False)
        if N > 1:
            def bwd(x_next, inp):
                L_i, M_i, y_i = inp
                x_i = solve_triangular(L_i.T, y_i - M_i.T @ x_next,
                                       lower=False)
                return x_i, x_i

            _, x_rest = jax.lax.scan(bwd, xN, (L[:-1], M, y[:-1]),
                                     reverse=True)
            x = jnp.concatenate([x_rest, xN[None]])
        else:
            x = xN[None]
    return x[..., 0] if squeeze else x


def block_tridiag_selected_inverse(L: jax.Array, M: jax.Array
                                   ) -> jax.Array:
    """Diagonal blocks of ``(L Lᵀ)⁻¹`` from the block-bidiagonal factor
    — the Takahashi selected-inverse recursion.

    For Σ = (L Lᵀ)⁻¹ with L from :func:`block_tridiag_factor`, the
    identity Σ L = L⁻ᵀ restricted to the factor's sparsity gives a
    reverse recursion touching only the diagonal blocks (with
    ``A_i = M_i L_i⁻¹``):

        Σ_NN  = L_N⁻ᵀ L_N⁻¹
        Σ_ii  = L_i⁻ᵀ L_i⁻¹ + A_iᵀ Σ_{i+1,i+1} A_i

    — one reverse ``lax.scan`` of tiny (d, d) ops, O(N·d³) total, so the
    pose marginals of an N-pose graph cost the same as one extra
    factorization instead of the O(N²·d²) dense inverse (the reference's
    covariance densifies: math.h:88-189).  Returns Σ_ii (N, d, d).
    HIGHEST precision throughout (chain conditioning amplifies the TF32
    rounding a GPU may apply at DEFAULT — :func:`block_tridiag_factor`).
    """
    N, d, _ = L.shape
    eye = jnp.eye(d, dtype=L.dtype)
    with jax.default_matmul_precision("highest"):
        def inv_lower(Li):
            return solve_triangular(Li, eye, lower=True)

        Linv_last = inv_lower(L[N - 1])
        Sig_last = Linv_last.T @ Linv_last
        if N == 1:
            return Sig_last[None]

        def step(Sig_next, inp):
            L_i, M_i = inp
            Li_inv = inv_lower(L_i)
            A = M_i @ Li_inv
            Sig_ii = Li_inv.T @ Li_inv + A.T @ Sig_next @ A
            return Sig_ii, Sig_ii

        _, Sig_rest = jax.lax.scan(step, Sig_last, (L[:-1], M),
                                   reverse=True)
        return jnp.concatenate([Sig_rest, Sig_last[None]])


def block_tridiag_selected_inverse_sub(L: jax.Array, M: jax.Array):
    """Diagonal AND sub-diagonal blocks of ``(L Lᵀ)⁻¹`` — the extended
    Takahashi recursion.

    Beyond :func:`block_tridiag_selected_inverse`'s diagonal blocks, the
    same reverse sweep yields the sub-diagonal of the inverse for free:
    with ``A_i = M_i L_i⁻¹``,

        Σ_{i+1,i} = −Σ_{i+1,i+1} A_i

    (the inverse's entries on the factor's sparsity pattern).  Returns
    ``(Σ_ii (N, d, d), Σ_{i+1,i} (N−1, d, d))`` — exactly the entries a
    BANDED system's marginal algebra needs, since any two indices within
    bandwidth lie in the same or adjacent super-blocks.  O(N·d³),
    HIGHEST precision (module docstring).
    """
    N, d, _ = L.shape
    eye = jnp.eye(d, dtype=L.dtype)
    with jax.default_matmul_precision("highest"):
        def inv_lower(Li):
            return solve_triangular(Li, eye, lower=True)

        Linv_last = inv_lower(L[N - 1])
        Sig_last = Linv_last.T @ Linv_last
        if N == 1:
            return Sig_last[None], jnp.zeros((0, d, d), L.dtype)

        def step(Sig_next, inp):
            L_i, M_i = inp
            Li_inv = inv_lower(L_i)
            A = M_i @ Li_inv
            Sig_sub = -Sig_next @ A                  # Σ_{i+1, i}
            Sig_ii = Li_inv.T @ Li_inv + A.T @ Sig_next @ A
            return Sig_ii, (Sig_ii, Sig_sub)

        _, (Sig_rest, Sub) = jax.lax.scan(step, Sig_last, (L[:-1], M),
                                          reverse=True)
        Sig = jnp.concatenate([Sig_rest, Sig_last[None]])
        return Sig, Sub


def tridiag_woodbury_marginals(D: jax.Array, B: jax.Array,
                               U: jax.Array):
    """Per-block marginal covariance of ``H = T + U Uᵀ``: the diagonal
    (d, d) blocks of H⁻¹.

    Takahashi selected inverse of the tridiagonal part plus the Woodbury
    rank-m downdate restricted to the diagonal blocks:

        H⁻¹ = T⁻¹ − Z W⁻¹ Zᵀ,  Z = T⁻¹U,  W = I_m + Uᵀ Z
        marg_i = Σ_ii − Z_i W⁻¹ Z_iᵀ

    — the T⁻¹U solve and (m, m) capacitance Cholesky are the SAME
    objects the solver builds (:func:`tridiag_woodbury_solve`), so loop
    closures cost one extra batched (d, m) correction.  Returns
    ``(marg (N, d, d), ok)``.  O(N·(d³ + d²·m) + m³); never densifies.
    """
    N, d, m = U.shape
    L, M, ok = block_tridiag_factor(D, B)
    Sig = block_tridiag_selected_inverse(L, M)
    if m == 0:
        ok = ok & jnp.all(jnp.isfinite(Sig))
        return Sig, ok
    Z = block_tridiag_solve(L, M, U)                     # (N, d, m)
    with jax.default_matmul_precision("highest"):
        W = jnp.eye(m, dtype=U.dtype) + jnp.einsum("ndm,ndp->mp", U, Z)
        Lw = jnp.linalg.cholesky(W)
        WinvZt = jax.vmap(lambda Zi: cho_solve((Lw, True), Zi.T))(Z)
        Sig = Sig - jnp.einsum("ndm,nme->nde", Z, WinvZt)
    ok = ok & jnp.all(jnp.isfinite(Lw)) & jnp.all(jnp.isfinite(Sig))
    return Sig, ok


def spd_inv_gj(A: jax.Array, unroll_max: int = 48) -> jax.Array:
    """Explicit batched SPD inverse by Gauss-Jordan elimination — an
    alternative to ``vmap(cholesky)+cho_solve`` on many small blocks.

    XLA's batched small Cholesky + triangular solves are sequential
    per-element kernels with per-level launch overhead; an UNROLLED
    Gauss-Jordan on the augmented system ``(A | I)`` is d steps of pure
    elementwise broadcast arithmetic over the (batch, d, 2d) slab — XLA
    fuses the chain, and the inverses then ride ordinary einsums.  Pivoting-free GJ is backward-stable on
    SPD inputs (same leading-minor pivots as Cholesky), and a block is
    declared non-PD exactly when Cholesky would fail: some pivot ≤ 0 —
    those blocks are NaN-poisoned to keep the λ-escalation contract
    (reference math.h:232-240 returns nullopt on LDLT failure).

    ``A`` (batch, d, d); unrolls for d ≤ ``unroll_max``, else runs a
    ``fori_loop`` with dynamic slices (large d: graph size over fusion).
    """
    nb, d, _ = A.shape
    M = jnp.concatenate(
        [A, jnp.broadcast_to(jnp.eye(d, dtype=A.dtype), A.shape)],
        axis=-1)
    minpiv = jnp.full((nb,), jnp.inf, A.dtype)

    if d <= unroll_max:
        for j in range(d):
            piv = M[:, j, j]
            minpiv = jnp.minimum(minpiv, piv)
            row = M[:, j, :] / piv[:, None]
            M = M - M[:, :, j:j + 1] * row[:, None, :]
            M = M.at[:, j, :].set(row)
    else:
        def body(j, state):
            M, minpiv = state
            piv = jax.lax.dynamic_slice(M, (0, j, j), (nb, 1, 1))
            minpiv = jnp.minimum(minpiv, piv[:, 0, 0])
            row = jax.lax.dynamic_slice(
                M, (0, j, 0), (nb, 1, 2 * d)) / piv
            col = jax.lax.dynamic_slice(M, (0, 0, j), (nb, d, 1))
            M = M - col * row
            M = jax.lax.dynamic_update_slice(M, row, (0, j, 0))
            return M, minpiv

        M, minpiv = jax.lax.fori_loop(0, d, body, (M, minpiv))
    inv = M[:, :, d:]
    nan = jnp.asarray(jnp.nan, A.dtype)
    return jnp.where((minpiv > 0)[:, None, None], inv, nan)


def block_tridiag_cr_solve(D: jax.Array, B: jax.Array, b: jax.Array
                           ) -> jax.Array:
    """Solve the SPD block-tridiagonal system by block CYCLIC REDUCTION
    — the log-depth parallel alternative to the sequential scan.

    Each level eliminates all ODD blocks at once (one batched (d×d)
    Cholesky + a handful of batched matmuls over N/2 blocks) and
    recurses on the even half: ⌈log₂N⌉ sequential stages instead of N
    scan steps.  On an accelerator the scan is LATENCY-bound (~N ×
    tiny-op chain); CR does ~2× the flops but in ~13 batched stages at
    N = 5000 (chain.default_chain_method records the GPU timing).  For SPD systems CR is the
    Cholesky of a nested-dissection reordering — numerically stable.
    ``b`` is (N, d) or (N, d, k).  Non-PD pivots surface as NaNs in the
    result (check finiteness for the λ-escalation contract).

    The whole reduction runs at HIGHEST matmul precision: at DEFAULT a
    GPU may round dot_general operands to TF32, and a chain's
    conditioning (O(N²)) amplifies the rounding into outright divergence
    (the same failure mode as the Schur-BA assembly, ops/schur_obs._esum).
    """
    squeeze = b.ndim == 2
    if squeeze:
        b = b[..., None]
    with jax.default_matmul_precision("highest"):
        x = _cr_solve(D, B, b)
    return x[..., 0] if squeeze else x


def _cr_use_cholesky() -> bool:
    """CR level math selector (trace-time).  DEFAULT: backward-stable
    vmap(cholesky)+cho_solve.  TINYOPT_CR_SWEEP_INV=1 opts into the
    explicit spd_inv_gj sweep inverse instead (benchmarks/
    repro_flagship_conv.py): the explicit inverse loses ~half a digit
    per solve on the ill-conditioned reduced camera system, and on the
    1000-camera corridor the LM trajectory missed the rmse criterion
    within the 12-iteration budget where cho_solve met it.
    (TINYOPT_CR_CHOLESKY=1 is accepted as a no-op for compatibility
    with the A/B harness.)"""
    import os
    return not os.environ.get("TINYOPT_CR_SWEEP_INV")


def _cr_solve(D, B, b):
    N, d, _ = D.shape
    use_chol = _cr_use_cholesky()
    if N == 1:
        if use_chol:
            L0 = jnp.linalg.cholesky(D[0])
            return cho_solve((L0, True), b[0])[None]
        return (spd_inv_gj(D[:1])[0] @ b[0])[None]
    if N == 2:
        # base case (an even pad would recurse 2→3→2 forever): Schur-
        # eliminate block 1 into block 0
        if use_chol:
            L1 = jnp.linalg.cholesky(D[1])
            Y = cho_solve((L1, True), B[0])       # D₁⁻¹ B₀
            yb = cho_solve((L1, True), b[1])
            L0 = jnp.linalg.cholesky(D[0] - B[0].T @ Y)
            x0 = cho_solve((L0, True), b[0] - B[0].T @ yb)
            x1 = yb - Y @ x0
            return jnp.stack([x0, x1])
        i1 = spd_inv_gj(D[1:2])[0]
        Y = i1 @ B[0]                             # D₁⁻¹ B₀
        yb = i1 @ b[1]
        i0 = spd_inv_gj((D[0] - B[0].T @ Y)[None])[0]
        x0 = i0 @ (b[0] - B[0].T @ yb)
        x1 = yb - Y @ x0
        return jnp.stack([x0, x1])
    n0 = N
    if N % 2 == 0:
        # decoupled identity pad → odd size, so every odd block has
        # both even neighbors (trimmed off the returned solution)
        D = jnp.concatenate([D, jnp.eye(d, dtype=D.dtype)[None]])
        B = jnp.concatenate([B, jnp.zeros((1, d, d), D.dtype)])
        b = jnp.concatenate([b, jnp.zeros((1,) + b.shape[1:], b.dtype)])
        N += 1
    Do, bo = D[1::2], b[1::2]                  # odd blocks (Mo = N//2)
    Bl = B[0::2]                               # B[2k]   = H[2k+1, 2k]
    Br = B[1::2]                               # B[2k+1] = H[2k+2, 2k+1]
    if use_chol:
        # r4 level math (A/B reference): backward-stable cho_solve per
        # odd block instead of the explicit inverse.
        Lo = jnp.linalg.cholesky(Do)
        sol = jax.vmap(lambda L_, M_: cho_solve((L_, True), M_))
        Yl = sol(Lo, Bl)                                 # D⁻¹ Bl
        Zr = sol(Lo, jnp.swapaxes(Br, -1, -2))           # D⁻¹ Brᵀ
        Yb = sol(Lo, bo)                                 # D⁻¹ b_odd
    else:
        # Explicit sweep inverses (spd_inv_gj) instead of batched
        # Cholesky+cho_solve: the level's whole elimination becomes
        # fused elementwise chains + three einsums.
        Dinv = spd_inv_gj(Do)
        Yl = jnp.einsum("kab,kbc->kac", Dinv, Bl)        # D⁻¹ Bl
        Zr = jnp.einsum("kab,kcb->kac", Dinv, Br)        # D⁻¹ Brᵀ
        Yb = jnp.einsum("kab,kbr->kar", Dinv, bo)        # D⁻¹ b_odd
    De = D[0::2]
    be = b[0::2]
    De = De.at[1:].add(-jnp.einsum("kab,kbc->kac", Br, Zr))
    De = De.at[:-1].add(-jnp.einsum("kba,kbc->kac", Bl, Yl))
    be = be.at[1:].add(-jnp.einsum("kab,kbr->kar", Br, Yb))
    be = be.at[:-1].add(-jnp.einsum("kba,kbr->kar", Bl, Yb))
    Be = -jnp.einsum("kab,kbc->kac", Br, Yl)
    x_even = _cr_solve(De, Be, be)
    x_odd = (Yb - jnp.einsum("kab,kbr->kar", Yl, x_even[:-1])
             - jnp.einsum("kab,kbr->kar", Zr, x_even[1:]))
    x = jnp.zeros((N,) + x_even.shape[1:], x_even.dtype)
    x = x.at[0::2].set(x_even).at[1::2].set(x_odd)
    return x[:n0]


def tridiag_woodbury_solve(D: jax.Array, B: jax.Array, U: jax.Array,
                           b: jax.Array, method: str = "scan"):
    """Solve ``(T + U Uᵀ) x = b`` with T block-tridiagonal ``(D, B)``
    and ``U`` (N, d, m) a tall low-rank factor (loop closures).

    Woodbury: x = z_b − Z_U (I_m + Uᵀ Z_U)⁻¹ Uᵀ z_b with
    ``[z_b, Z_U] = T⁻¹ [b, U]`` — ONE tridiagonal solve with 1+m
    right-hand sides, then an (m, m) dense Cholesky.  Returns
    ``(x (N, d), ok)``; requires m ≪ N·d to beat a general solver.
    ``method``: "scan" (sequential factor+solve — lowest flops, right
    for CPU) or "cr" (log-depth cyclic reduction — right for a GPU,
    where the scan is latency-bound).  The small capacitance solve runs
    at HIGHEST precision — it is the only place the N-long chains of the
    two sweeps get mixed, and at DEFAULT a GPU may round its
    dot_generals to TF32.
    """
    N, d, m = U.shape
    rhs = jnp.concatenate([b[..., None], U], axis=-1)     # (N, d, 1+m)
    if method == "cr":
        Z = block_tridiag_cr_solve(D, B, rhs)
        ok = jnp.all(jnp.isfinite(Z))
    else:
        L, M, ok = block_tridiag_factor(D, B)
        Z = block_tridiag_solve(L, M, rhs)
    z_b, Z_U = Z[..., 0], Z[..., 1:]
    if m == 0:
        return z_b, ok & jnp.all(jnp.isfinite(z_b))
    with jax.default_matmul_precision("highest"):
        W = jnp.eye(m, dtype=U.dtype) + jnp.einsum(
            "ndm,ndp->mp", U, Z_U)
        Lw = jnp.linalg.cholesky(W)
        c = cho_solve((Lw, True), jnp.einsum("ndm,nd->m", U, z_b))
        x = z_b - jnp.einsum("ndm,m->nd", Z_U, c)
    ok = ok & jnp.all(jnp.isfinite(Lw)) & jnp.all(jnp.isfinite(x))
    return x, ok
