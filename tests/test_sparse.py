"""Sparse-path tests: block-diagonal Hessians and matrix-free GN-CG.

Mirror of the reference tests/sparse.cpp:19-85 (diagonal problem with a
sparse Hessian, AD into sparse H) re-expressed in the batched JAX
formulations, plus equivalence checks against the dense path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu.ops.block import BlockDiag
from tinyopt_tpu.models.problems import sparse_diag_residual


class TestBlockDiag:
    def test_to_dense_and_matvec(self):
        rng = np.random.default_rng(0)
        blocks = jnp.asarray(rng.uniform(-1, 1, (3, 2, 2)))
        B = BlockDiag(blocks)
        dense = np.asarray(B.to_dense())
        assert dense.shape == (6, 6)
        v = jnp.asarray(rng.uniform(-1, 1, 6))
        np.testing.assert_allclose(np.asarray(B.matvec(v)), dense @ np.asarray(v),
                                   atol=1e-12)

    def test_solve_matches_dense(self):
        rng = np.random.default_rng(1)
        A = jnp.asarray(rng.uniform(-1, 1, (4, 3, 3)))
        blocks = jnp.einsum("nij,nkj->nik", A, A) + 3 * jnp.eye(3)
        B = BlockDiag(blocks)
        b = jnp.asarray(rng.uniform(-1, 1, 12))
        dx, ok = B.solve(b)
        assert bool(ok)
        np.testing.assert_allclose(
            np.asarray(dx), np.linalg.solve(np.asarray(B.to_dense()),
                                            np.asarray(b)), atol=1e-10)

    def test_inv_is_blockwise(self):
        blocks = jnp.stack([2.0 * jnp.eye(2), 4.0 * jnp.eye(2)])
        C = BlockDiag(blocks).inv()
        np.testing.assert_allclose(np.asarray(C.blocks[0]), np.eye(2) / 2)
        np.testing.assert_allclose(np.asarray(C.blocks[1]), np.eye(2) / 4)


class TestBlockOptimize:
    @pytest.mark.parametrize("dims", [10, 100])
    def test_diag_problem(self, dims):
        """The reference's sparse diagonal problem (tests/sparse.cpp:19-61,
        benchmarks/sparse.cpp:52-61): r_i = x_i² − i, block size 1."""
        targets = jnp.arange(1.0, dims + 1.0).reshape(dims, 1)
        # Far start: needs unlimited λ escalation (as the reference's own
        # hard tests configure, optimize_hard.cpp:52).
        x, out = to.block_optimize(
            jnp.ones((dims, 1)),
            lambda xb, t: xb * xb - t,
            data=targets,
            options=to.Options(max_consec_failures=0, max_iters=100))
        assert bool(out.succeeded())
        np.testing.assert_allclose(
            np.asarray(x).ravel(),
            np.sqrt(np.arange(1.0, dims + 1.0)), atol=1e-6)

    def test_matches_dense_path(self):
        """Block solve == dense solve on the same (block-structured)
        problem (sparse-vs-dense agreement, tests/sparse.cpp:65-85)."""
        targets = jnp.arange(1.0, 9.0).reshape(8, 1)
        x_blk, out_blk = to.block_optimize(
            jnp.ones((8, 1)), lambda xb, t: xb * xb - t, data=targets)
        x_dense, out_dense = to.optimize(
            jnp.ones(8), sparse_diag_residual)
        np.testing.assert_allclose(np.asarray(x_blk).ravel(),
                                   np.asarray(x_dense), atol=1e-8)
        assert float(out_blk.final_cost.cost) == pytest.approx(
            float(out_dense.final_cost.cost), abs=1e-10)

    def test_blockdiag_rescaled_covariance(self):
        """rescaled=True must work for BlockDiag final Hessians."""
        targets = jnp.arange(1.0, 5.0).reshape(4, 1)
        x, out = to.block_optimize(jnp.ones((4, 1)),
                                   lambda xb, t: xb * xb - t, data=targets)
        C = out.covariance(rescaled=True)
        assert C.shape == (4, 4)
        assert bool(jnp.all(jnp.isfinite(C)))

    def test_matfree_rejects_gradient_descent(self):
        with pytest.raises(ValueError):
            to.matfree_optimize(jnp.ones(3), lambda x: x,
                                to.Options(solver_type=to.GradientDescent))

    def test_block_hessian_saved_and_covariance(self):
        targets = jnp.arange(1.0, 5.0).reshape(4, 1)
        x, out = to.block_optimize(jnp.ones((4, 1)),
                                   lambda xb, t: xb * xb - t, data=targets)
        assert isinstance(out.final_hessian, BlockDiag)
        C = out.covariance()
        # J = diag(2x) → cov = diag(1/(4x²)) = diag(1/(4i))
        np.testing.assert_allclose(
            np.diag(np.asarray(C)),
            1.0 / (4.0 * np.arange(1.0, 5.0)), rtol=1e-5)

    def test_multidim_blocks(self):
        """bs=3 blocks: each block fits a small quadratic independently."""
        nb, bs = 6, 3
        rng = np.random.default_rng(2)
        targets = jnp.asarray(rng.uniform(-1, 1, (nb, bs)))
        x, out = to.block_optimize(jnp.zeros((nb, bs)),
                                   lambda xb, t: xb - t, data=targets)
        assert bool(out.converged())
        np.testing.assert_allclose(np.asarray(x), np.asarray(targets),
                                   atol=1e-8)


class TestSparseOptimize:
    """General-sparse Hessian path (reference tests/sparse.cpp:19-85:
    SparseMatrix H + SimplicialLDLT → SparseSym COO + Jacobi-PCG)."""

    def test_diag_problem_detected_structure(self):
        """r_i = x_i² − i with auto-detected (diagonal) sparsity
        (reference tests/sparse.cpp:19-61)."""
        dims = 20
        x, out = to.sparse_optimize(
            jnp.ones(dims), sparse_diag_residual,
            to.Options(max_iters=100, max_consec_failures=0))
        assert bool(out.succeeded())
        np.testing.assert_allclose(
            np.asarray(x), np.sqrt(np.arange(1.0, dims + 1.0)), atol=1e-8)
        from tinyopt_tpu.ops.sparse_sym import SparseSym
        H = out.final_hessian
        assert isinstance(H, SparseSym)
        # diagonal residuals -> exactly d stored entries
        assert H.vals.shape == (dims,)

    def test_coupled_matches_dense(self):
        """Chain problem (tridiagonal H): same optimum, same final cost,
        same H as the dense path (sparse-vs-dense agreement,
        tests/sparse.cpp:65-85)."""
        def chain(x):
            return jnp.concatenate(
                [3.0 * (x[1:] - x[:-1] * x[:-1]),
                 jnp.atleast_1d(x[0] - 0.7)])
        x_sp, out_sp = to.sparse_optimize(jnp.full(6, 0.5), chain)
        x_d, out_d = to.optimize(jnp.full(6, 0.5), chain)
        assert bool(out_sp.converged())
        np.testing.assert_allclose(np.asarray(x_sp), np.asarray(x_d),
                                   atol=1e-8)
        np.testing.assert_allclose(
            np.asarray(out_sp.final_hessian.to_dense()),
            np.asarray(out_d.final_hessian), atol=1e-8)

    def test_explicit_structure(self):
        """Caller-supplied structure bypasses probing."""
        dims = 6
        structure = np.eye(dims, dtype=bool)
        x, out = to.sparse_optimize(
            jnp.ones(dims), sparse_diag_residual,
            to.Options(max_iters=100, max_consec_failures=0),
            structure=structure)
        assert bool(out.succeeded())
        np.testing.assert_allclose(
            np.asarray(x), np.sqrt(np.arange(1.0, dims + 1.0)), atol=1e-8)

    def test_structure_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="structure shape"):
            to.sparse_optimize(jnp.ones(4), sparse_diag_residual,
                               structure=np.eye(3, dtype=bool))

    def test_rejects_gradient_descent(self):
        with pytest.raises(ValueError, match="Gauss-Newton"):
            to.sparse_optimize(jnp.ones(3), sparse_diag_residual,
                               to.Options(solver_type=to.GradientDescent))

    def test_covariance(self):
        """Sparse covariance recovery (reference math.h:115-137 /
        tests/sparse.cpp InvCov usage): cov = H⁻¹ densified."""
        dims = 5
        x, out = to.sparse_optimize(
            jnp.ones(dims), sparse_diag_residual,
            to.Options(max_iters=100, max_consec_failures=0))
        C = out.covariance()
        np.testing.assert_allclose(
            np.diag(np.asarray(C)),
            1.0 / (4.0 * np.arange(1.0, dims + 1.0)), rtol=1e-5)

    def test_manifold_params(self):
        """Sparse path through a manifold retraction (SO3 prior)."""
        from tinyopt_tpu.manifolds import SO3
        prior_inv = SO3.exp(jnp.asarray([0.3, -0.2, 0.1]))
        R, out = to.sparse_optimize(
            SO3.identity(jnp.float64), lambda R: (prior_inv @ R).log())
        assert float(jnp.linalg.norm((R @ prior_inv).log())) < 1e-7

    def test_damping_is_multiplicative(self):
        """SparseSym.damp scales the diagonal by (1+λ), the reference's
        LM damping (lm.h:107-117)."""
        from tinyopt_tpu.ops.sparse_sym import SparseSym
        H = SparseSym.from_pattern(
            np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1]),
            jnp.asarray([2.0, 0.5, 0.5, 3.0]), 2)
        Hd = H.damp(0.1)
        np.testing.assert_allclose(
            np.asarray(Hd.to_dense()),
            [[2.2, 0.5], [0.5, 3.3]], atol=1e-12)

    def test_no_carry_no_save_config(self):
        """carry_system=False + save_last=False is a valid throughput
        configuration for the sparse path (regression: save_last was
        force-overridden to True, making this combination raise)."""
        x, out = to.sparse_optimize(
            jnp.ones(5), sparse_diag_residual,
            to.Options(max_iters=100, max_consec_failures=0,
                       hessian=to.HessianOptions(carry_system=False,
                                                 save_last=False)))
        assert bool(out.succeeded())
        assert out.final_hessian is None
        np.testing.assert_allclose(
            np.asarray(x), np.sqrt(np.arange(1.0, 6.0)), atol=1e-8)

    def test_vmap_batched_sparse(self):
        """The sparse system composes with vmap: batched general-sparse
        solves (no reference counterpart)."""
        from tinyopt_tpu import manifold as mf
        from tinyopt_tpu.ops.coloring import probe_structure
        from tinyopt_tpu.sparse import sparse_system
        from tinyopt_tpu.optimizers.loop import optimize_from_acc

        def chain(x):
            return jnp.concatenate([3.0 * (x[1:] - x[:-1] * x[:-1]),
                                    jnp.atleast_1d(x[0] - 0.7)])

        d = 6
        x_ex = jnp.full(d, 0.5)
        spec = mf.tangent_spec(x_ex)
        structure = probe_structure(chain, x_ex, None, spec, d, d)
        acc, ev, _ = sparse_system(chain, x_ex, spec, structure)
        opts = to.Options(max_consec_failures=0, max_iters=60)
        solve = jax.jit(jax.vmap(
            lambda x: optimize_from_acc(x, acc, ev, opts, spec)))
        rng = np.random.default_rng(0)
        x0b = jnp.asarray(rng.uniform(0.3, 0.8, (8, d)))
        xb, outb = solve(x0b)
        assert float(np.asarray(outb.converged()).mean()) == 1.0
        for i in range(2):
            xd, _ = to.optimize(x0b[i], chain, opts)
            np.testing.assert_allclose(np.asarray(xb[i]), np.asarray(xd),
                                       atol=1e-6)

    def test_sparsesym_solve_matches_dense(self):
        rng = np.random.default_rng(7)
        A = rng.uniform(-1, 1, (6, 6))
        dense = A @ A.T + 6 * np.eye(6)
        rows, cols = np.nonzero(np.ones((6, 6), bool))
        from tinyopt_tpu.ops.sparse_sym import SparseSym
        H = SparseSym.from_pattern(rows, cols,
                                   jnp.asarray(dense[rows, cols]), 6)
        b = jnp.asarray(rng.uniform(-1, 1, 6))
        dx, ok = H.solve(b)
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(dx),
                                   np.linalg.solve(dense, np.asarray(b)),
                                   atol=1e-8)


class TestMatfreeOptimize:
    def test_matches_dense_lm(self):
        """GN-CG reaches the same optimum as dense LM on Rosenbrock."""
        from tinyopt_tpu.models.problems import rosenbrock_residuals
        # Scalar (λ·ray·I) damping steers less precisely through the
        # Rosenbrock valley than per-coordinate diag damping, so give the
        # budget the reference's hard suite uses.
        x_mf, out_mf = to.matfree_optimize(
            jnp.array([-1.2, 1.0]), rosenbrock_residuals,
            to.Options(max_iters=150, max_consec_failures=0))
        assert bool(out_mf.succeeded())
        np.testing.assert_allclose(np.asarray(x_mf), [1.0, 1.0], atol=1e-4)
        assert out_mf.final_hessian is None

    def test_large_dim_diag(self):
        """1000-dim diagonal problem, never materializing the 1000² H
        (the regime the reference says it is slow in, README.md:30)."""
        dims = 1000
        x, out = to.matfree_optimize(
            jnp.ones(dims), sparse_diag_residual,
            to.Options(max_iters=100, max_consec_failures=0), cg_iters=50)
        assert bool(out.succeeded())
        np.testing.assert_allclose(
            np.asarray(x), np.sqrt(np.arange(1.0, dims + 1.0)), atol=1e-4)

    def test_manifold_params(self):
        """Matrix-free on a manifold (SE3 pose prior)."""
        from tinyopt_tpu.manifolds import SE3
        prior_inv = SE3.exp(jnp.asarray(np.linspace(-0.4, 0.4, 6)))
        pose, out = to.matfree_optimize(
            SE3.identity(jnp.float64),
            lambda x: (prior_inv @ x).log())
        assert float(jnp.linalg.norm((pose @ prior_inv).log())) < 1e-5


class TestSolverCache:
    """Repeated solves reuse the compiled program (sparse._SOLVE_CACHE):
    the 15.6k-dim BA measured ~1 s of device time inside ~8 s of per-call
    re-tracing before caching.  Identity-keyed on the captured data, so
    only immutable jax arrays participate."""

    def _problem(self):
        def pair_fn(a_i, b_j, d_ij):
            return jnp.stack([a_i[0] + b_j[0] - d_ij,
                              0.3 * a_i[0], 0.3 * b_j[0]])
        rng = np.random.default_rng(7)
        d = jnp.asarray(rng.normal(size=(3, 4)))
        mask = jnp.ones((3, 4))
        x0 = (jnp.zeros((3, 1)), jnp.zeros((4, 1)))
        return pair_fn, d, mask, x0

    def test_schur_repeat_hits_cache_and_matches(self):
        from tinyopt_tpu.sparse import _SOLVE_CACHE
        pair_fn, d, mask, x0 = self._problem()
        o = to.Options(max_iters=20)
        _SOLVE_CACHE.clear()
        x1, out1 = to.schur_optimize(x0, pair_fn, d, mask, o)
        assert len(_SOLVE_CACHE) == 1
        x2, out2 = to.schur_optimize(x0, pair_fn, d, mask, o)
        assert len(_SOLVE_CACHE) == 1          # second call reused it
        np.testing.assert_array_equal(np.asarray(x1[0]), np.asarray(x2[0]))
        assert int(out1.num_iters) == int(out2.num_iters)

    def test_mutable_numpy_data_skips_cache(self):
        """numpy data could be mutated in place after the trace baked its
        values; such calls must not cache (stale-constant hazard)."""
        from tinyopt_tpu.sparse import _SOLVE_CACHE
        pair_fn, d, mask, x0 = self._problem()
        _SOLVE_CACHE.clear()
        d_np = np.array(d)                    # mutable (copied) buffer
        x1, _ = to.schur_optimize(x0, pair_fn, d_np, mask,
                                  to.Options(max_iters=20))
        assert len(_SOLVE_CACHE) == 0
        # in-place mutation is picked up by the (re-traced) next call
        d_np *= 2.0
        x2, _ = to.schur_optimize(x0, pair_fn, d_np, mask,
                                  to.Options(max_iters=20))
        assert not np.allclose(np.asarray(x1[0]), np.asarray(x2[0]))

    def test_fresh_data_objects_do_not_false_hit(self):
        from tinyopt_tpu.sparse import _SOLVE_CACHE
        pair_fn, d, mask, x0 = self._problem()
        _SOLVE_CACHE.clear()
        x1, _ = to.schur_optimize(x0, pair_fn, d, mask,
                                  to.Options(max_iters=20))
        d2 = d * 2.0                           # new object, same shape
        x2, _ = to.schur_optimize(x0, pair_fn, d2, mask,
                                  to.Options(max_iters=20))
        assert len(_SOLVE_CACHE) == 2
        assert not np.allclose(np.asarray(x1[0]), np.asarray(x2[0]))

    def test_block_and_matfree_and_sparse_cache(self):
        from tinyopt_tpu.sparse import _SOLVE_CACHE
        _SOLVE_CACHE.clear()
        fn = lambda xb: xb - jnp.arange(3.0)
        x0 = jnp.ones((4, 3))
        to.block_optimize(x0, fn)
        to.block_optimize(x0, fn)
        assert len(_SOLVE_CACHE) == 1
        rfn = lambda x: x ** 2 - jnp.arange(1.0, 9.0)
        to.matfree_optimize(jnp.ones(8), rfn)
        to.matfree_optimize(jnp.ones(8), rfn)
        assert len(_SOLVE_CACHE) == 2
        to.sparse_optimize(jnp.ones(8), rfn)
        to.sparse_optimize(jnp.ones(8), rfn)
        assert len(_SOLVE_CACHE) == 3


class TestMatfreePrecond:
    """Hutchinson-Jacobi preconditioning for the matrix-free path
    (sparse.matfree_system precond_probes): must rescue badly scaled
    loosely coupled systems and leave the default path untouched."""

    def test_ill_scaled_diagonal_rescued(self):
        rng = np.random.default_rng(0)
        d = 200
        scales = jnp.asarray(10.0 ** rng.uniform(-3, 3, d))
        tgt = jnp.asarray(rng.normal(size=d))
        fn = lambda x: scales * (x - tgt)
        o = to.Options(max_iters=30, max_consec_failures=0)
        x1, o1 = to.matfree_optimize(jnp.zeros(d), fn, o, cg_iters=30)
        x2, o2 = to.matfree_optimize(jnp.zeros(d), fn, o, cg_iters=30,
                                     precond_probes=8)
        # plain CG stalls at this budget; preconditioned converges
        assert float(o2.final_cost.cost) < 1e-12
        assert int(o2.num_iters) < 10
        assert float(o2.final_cost.cost) < 1e-6 * float(o1.final_cost.cost)

    def test_off_path_unchanged(self):
        fn = lambda x: x - jnp.arange(20.0)
        o = to.Options(max_consec_failures=0)
        x1, o1 = to.matfree_optimize(jnp.ones(20), fn, o)
        x2, o2 = to.matfree_optimize(jnp.ones(20) * 1.0, fn, o,
                                     precond_probes=0)
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2))
        assert bool(o1.converged()) and bool(o2.converged())
