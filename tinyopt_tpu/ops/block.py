"""Block-diagonal Hessian representation.

The JAX counterpart of the reference's sparse-Hessian path
(reference: include/tinyopt/solvers/gn.h:63-74, math.h:266-277 — general
``SparseMatrix`` + ``SimplicialLDLT``): on an accelerator, unstructured
sparse factorizations are hostile to wide SIMD, but the sparsity that actually
occurs in NLLS normal equations is *block* structure (independent
parameter blocks — e.g. the diagonal problem of benchmarks/sparse.cpp, or
per-landmark blocks in bundle adjustment).  A batched dense Cholesky over
the blocks is exactly what the hardware wants: one fused kernel over a
(nb, bs, bs) array instead of a sequential sparse factorization.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .linalg import damp_diagonal, solve_psd


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockDiag:
    """Block-diagonal matrix: ``nb`` dense ``bs × bs`` blocks."""

    blocks: jax.Array  #: (nb, bs, bs)

    @property
    def nb(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs(self) -> int:
        return self.blocks.shape[-1]

    @property
    def shape(self):
        n = self.nb * self.bs
        return (n, n)

    def to_dense(self) -> jax.Array:
        n = self.nb * self.bs
        dense = jnp.zeros((n, n), self.blocks.dtype)
        idx = jnp.arange(self.nb)
        for i in range(self.bs):
            for j in range(self.bs):
                dense = dense.at[idx * self.bs + i, idx * self.bs + j].set(
                    self.blocks[:, i, j])
        return dense

    def diagonal(self) -> jax.Array:
        return jnp.diagonal(self.blocks, axis1=-2, axis2=-1).reshape(-1)

    def damp(self, lam) -> "BlockDiag":
        return BlockDiag(damp_diagonal(self.blocks, lam))

    def solve(self, b: jax.Array, use_cholesky: bool = True):
        """Solve ``H dx = b``; returns (dx, ok) like ``solve_psd``."""
        bb = b.reshape(self.nb, self.bs)
        dx, ok = solve_psd(self.blocks, bb, use_cholesky=use_cholesky)
        return dx.reshape(-1), jnp.all(ok)

    def inv(self) -> "BlockDiag":
        """Blockwise inverse — the sparse covariance (math.h:115-137)."""
        return BlockDiag(jnp.linalg.inv(self.blocks))

    def matvec(self, v: jax.Array) -> jax.Array:
        vv = v.reshape(self.nb, self.bs)
        return jnp.einsum("nij,nj->ni", self.blocks, vv).reshape(-1)
