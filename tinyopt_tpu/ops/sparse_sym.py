"""General sparse symmetric Hessian (static coordinate pattern).

The JAX counterpart of the reference's *general* ``SparseMatrix``
Hessian (reference: include/tinyopt/types.h:36-38, solvers/gn.h:63-74)
factored by ``SimplicialLDLT`` (math.h:266-277).  A sequential sparse
factorization is hostile to wide SIMD; instead the pattern is fixed at trace
time (NLLS sparsity is structural, not value-dependent) and the damped
normal equations are solved with Jacobi-preconditioned conjugate
gradients, whose matvec is one gather + multiply + scatter-add — a shape
XLA maps well to an accelerator.

Matches the reference's semantics:

* multiplicative diagonal damping ``H(i,i) *= 1 + λ`` (lm.h:107-117),
  expressed functionally by :meth:`SparseSym.damp`;
* sparse covariance recovery with a diagonal-shift retry on numerical
  failure (math.h:115-137), in :meth:`SparseSym.inv`.

The pattern is stored as i32 coordinate arrays *in the pytree data* (XLA
gathers do not need static indices), so a ``SparseSym`` threads through
``lax.while_loop`` carries, ``vmap``, and ``Output.final_hessian`` like
any other array.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


class _DenseCov:
    """Duck-typed ``.to_dense()`` wrapper returned by :meth:`SparseSym.inv`
    (a sparse matrix's inverse is dense)."""

    def __init__(self, a):
        self._a = a

    def to_dense(self):
        return self._a


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SparseSym:
    """Symmetric sparse matrix in coordinate form (both triangles stored,
    so the CG matvec is a single scatter-add with no symmetrization pass).
    """

    vals: jax.Array     #: (nse,) values
    rows: jax.Array     #: (nse,) i32 row indices
    cols: jax.Array     #: (nse,) i32 column indices
    is_diag: jax.Array  #: (nse,) value-dtype mask: 1.0 where row == col
    dim: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_pattern(rows: np.ndarray, cols: np.ndarray, vals, dim: int
                     ) -> "SparseSym":
        rows = jnp.asarray(rows, jnp.int32)
        cols = jnp.asarray(cols, jnp.int32)
        vals = jnp.asarray(vals)
        return SparseSym(vals=vals, rows=rows, cols=cols,
                         is_diag=(rows == cols).astype(vals.dtype), dim=dim)

    @property
    def shape(self):
        return (self.dim, self.dim)

    @property
    def dtype(self):
        return self.vals.dtype

    def to_dense(self) -> jax.Array:
        return (jnp.zeros((self.dim, self.dim), self.vals.dtype)
                .at[self.rows, self.cols].add(self.vals))

    def diagonal(self) -> jax.Array:
        return (jnp.zeros((self.dim,), self.vals.dtype)
                .at[self.rows].add(self.vals * self.is_diag))

    def damp(self, lam) -> "SparseSym":
        """Multiplicative diagonal damping ``H(i,i) *= 1 + λ``
        (reference lm.h:107-117), with the framework's absolute-λ
        fallback for exactly-zero diagonal entries so λ-escalation
        drives the system solvable (ops/linalg.damp_diagonal and the
        fused kernel implement the same contract)."""
        lam = jnp.asarray(lam, self.vals.dtype)
        zero_diag = self.is_diag * (self.vals == 0).astype(self.vals.dtype)
        return dataclasses.replace(
            self, vals=self.vals * (1.0 + self.is_diag * lam)
            + zero_diag * lam)

    def matvec(self, v: jax.Array) -> jax.Array:
        return (jnp.zeros((self.dim,), v.dtype)
                .at[self.rows].add(self.vals * v[self.cols]))

    def solve(self, b: jax.Array, *, cg_iters: int = 0, cg_tol: float = 0.0):
        """Solve ``H dx = b`` by Jacobi-preconditioned CG.

        Returns ``(dx, ok)`` like ``ops.linalg.solve_psd``; ``ok`` is False
        when the iterate went non-finite (indefinite / singular system),
        which routes the optimizer to its λ-escalation path exactly like
        the reference's failed LDLT (gn.h:150-171).
        """
        iters = cg_iters or self.dim
        diag = self.diagonal()
        safe = jnp.where(diag > 0, diag, jnp.ones((), diag.dtype))
        precond = lambda v: v / safe
        dx, _ = jax.scipy.sparse.linalg.cg(
            self.matvec, b, M=precond, maxiter=iters, tol=cg_tol)
        return dx, jnp.all(jnp.isfinite(dx))

    def inv(self) -> _DenseCov:
        """Covariance = H⁻¹ (dense), with the reference's diagonal-shift
        retry on numerical failure (math.h:115-137).  The retry solve runs
        only when the first came back non-finite (``lax.cond``), so the
        common path pays one O(d³) solve like the dense covariance."""
        A = self.to_dense()
        eye = jnp.eye(self.dim, dtype=A.dtype)
        cov = jnp.linalg.solve(A, eye)
        shift = jnp.asarray(4.0 * jnp.finfo(A.dtype).eps, A.dtype) * (
            1.0 + jnp.max(jnp.abs(jnp.diagonal(A))))
        return _DenseCov(jax.lax.cond(
            jnp.all(jnp.isfinite(cov)),
            lambda c: c,
            lambda _: jnp.linalg.solve(A + shift * eye, eye),
            cov))
