"""Chain solver: block-tridiagonal Cholesky + Woodbury loop closures.

Covers ops/tridiag.py (factor/solve parity vs dense at machine
precision, multi-rhs, failure detection) and chain.py /
models.pose_graph.pose_graph_optimize (trajectory parity with the
dense path, scale convergence, GN / DogLeg, λ-escalation contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu.chain import chain_optimize
from tinyopt_tpu.models.pose_graph import (make_pose_graph,
                                           pose_graph_optimize,
                                           pose_graph_residuals)
from tinyopt_tpu.ops.tridiag import (block_tridiag_cr_solve,
                                     block_tridiag_factor,
                                     block_tridiag_solve,
                                     tridiag_woodbury_solve)


def _random_block_tridiag(rng, N, d, pd_shift=3.0):
    D = rng.normal(size=(N, d, d))
    D = np.einsum("nab,ncb->nac", D, D) + pd_shift * np.eye(d)
    B = 0.3 * rng.normal(size=(max(N - 1, 0), d, d))
    H = np.zeros((N * d, N * d))
    for i in range(N):
        H[i * d:(i + 1) * d, i * d:(i + 1) * d] = D[i]
    for i in range(N - 1):
        H[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = B[i]
        H[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d] = B[i].T
    return jnp.asarray(D), jnp.asarray(B), H


class TestBlockTridiag:
    def test_factor_solve_matches_dense(self):
        rng = np.random.default_rng(0)
        for N, d in [(1, 3), (2, 4), (9, 6)]:
            D, B, H = _random_block_tridiag(rng, N, d)
            b = rng.normal(size=(N, d))
            L, M, ok = block_tridiag_factor(D, B)
            assert bool(ok)
            x = block_tridiag_solve(L, M, jnp.asarray(b))
            xref = np.linalg.solve(H, b.reshape(-1)).reshape(N, d)
            np.testing.assert_allclose(np.asarray(x), xref,
                                       rtol=1e-11, atol=1e-11)

    def test_multi_rhs(self):
        rng = np.random.default_rng(1)
        N, d, k = 7, 5, 4
        D, B, H = _random_block_tridiag(rng, N, d)
        bk = rng.normal(size=(N, d, k))
        L, M, ok = block_tridiag_factor(D, B)
        xk = block_tridiag_solve(L, M, jnp.asarray(bk))
        xkref = np.linalg.solve(H, bk.reshape(N * d, k)).reshape(N, d, k)
        np.testing.assert_allclose(np.asarray(xk), xkref,
                                   rtol=1e-11, atol=1e-11)

    def test_woodbury_matches_dense(self):
        rng = np.random.default_rng(2)
        N, d, m = 8, 4, 7
        D, B, H = _random_block_tridiag(rng, N, d)
        U = 0.5 * rng.normal(size=(N, d, m))
        b = rng.normal(size=(N, d))
        Hw = H + U.reshape(N * d, m) @ U.reshape(N * d, m).T
        x, ok = tridiag_woodbury_solve(D, B, jnp.asarray(U),
                                       jnp.asarray(b))
        assert bool(ok)
        xref = np.linalg.solve(Hw, b.reshape(-1)).reshape(N, d)
        np.testing.assert_allclose(np.asarray(x), xref,
                                   rtol=1e-10, atol=1e-10)

    def test_rank_zero_update(self):
        rng = np.random.default_rng(3)
        N, d = 5, 3
        D, B, H = _random_block_tridiag(rng, N, d)
        b = rng.normal(size=(N, d))
        x, ok = tridiag_woodbury_solve(D, B, jnp.zeros((N, d, 0)),
                                       jnp.asarray(b))
        assert bool(ok)
        np.testing.assert_allclose(
            np.asarray(x), np.linalg.solve(H, b.reshape(-1)).reshape(N, d),
            rtol=1e-11, atol=1e-11)

    def test_non_pd_detected(self):
        rng = np.random.default_rng(4)
        N, d = 6, 3
        D, B, _ = _random_block_tridiag(rng, N, d)
        D = D.at[2].set(-jnp.eye(d))
        _, _, ok = block_tridiag_factor(D, B)
        assert not bool(ok)

    def test_cyclic_reduction_matches_dense(self):
        """The log-depth CR solve (the GPU backend of the chain solver,
        where the N-step scan is latency-bound) is exact for every size
        parity/padding case."""
        rng = np.random.default_rng(5)
        for N in (1, 2, 3, 4, 5, 8, 16, 33, 100):
            d = 4
            D, B, H = _random_block_tridiag(rng, N, d)
            b = rng.normal(size=(N, d, 3))
            x = block_tridiag_cr_solve(D, B, jnp.asarray(b))
            assert x.shape == (N, d, 3)
            xref = np.linalg.solve(H, b.reshape(N * d, 3)).reshape(
                N, d, 3)
            np.testing.assert_allclose(np.asarray(x), xref,
                                       rtol=1e-10, atol=1e-10)

    def test_cr_woodbury_and_failure(self):
        rng = np.random.default_rng(6)
        N, d, m = 12, 3, 5
        D, B, H = _random_block_tridiag(rng, N, d)
        U = 0.5 * rng.normal(size=(N, d, m))
        b = rng.normal(size=(N, d))
        Hw = H + U.reshape(N * d, m) @ U.reshape(N * d, m).T
        x, ok = tridiag_woodbury_solve(D, B, jnp.asarray(U),
                                       jnp.asarray(b), method="cr")
        assert bool(ok)
        np.testing.assert_allclose(
            np.asarray(x),
            np.linalg.solve(Hw, b.reshape(-1)).reshape(N, d),
            rtol=1e-10, atol=1e-10)
        Dbad = D.at[5].set(-jnp.eye(d))
        _, okb = tridiag_woodbury_solve(Dbad, B, jnp.asarray(U),
                                        jnp.asarray(b), method="cr")
        assert not bool(okb)


class TestChainOptimize:
    def test_trajectory_parity_with_dense(self):
        """The Woodbury chain solve is ALGEBRAICALLY the dense normal
        equations: trajectory (iterations, stop reason, x) must match
        to.optimize at f64 roundoff."""
        data, x0, _ = make_pose_graph(n_poses=14, extra_loops=5,
                                      noise=1e-3, init_noise=0.1, seed=2)
        xd, outd = to.optimize(x0, lambda p: pose_graph_residuals(p, data))
        xc, outc = pose_graph_optimize(x0, data)
        assert int(outc.num_iters) == int(outd.num_iters)
        assert int(outc.stop_reason) == int(outd.stop_reason)
        np.testing.assert_allclose(float(outc.final_cost),
                                   float(outd.final_cost), rtol=1e-10)
        diff = jax.vmap(lambda a, b: (a.inverse() @ b).log())(xd, xc)
        assert float(jnp.max(jnp.abs(diff))) < 1e-9

    def test_no_loops_pure_chain(self):
        data, x0, _ = make_pose_graph(n_poses=10, extra_loops=0,
                                      noise=0.0, init_noise=0.05, seed=0)
        x, out = pose_graph_optimize(x0, data)
        assert bool(out.converged)
        # stops at min_error (1e-12); the noise-free optimum is exact
        assert float(out.final_cost) < 1e-11

    def test_scale_convergence_chi2(self):
        """500 poses, 30 loops, σ=1e-3: converges to the DOF-predicted
        chi² level (residuals ≈ dims + anchor ⇒ E[cost] ≈ DOF·σ²)."""
        n, loops, sig = 500, 30, 1e-3
        data, x0, true = make_pose_graph(
            n_poses=n, extra_loops=loops, noise=sig, init_noise=0.05,
            seed=3)
        x, out = pose_graph_optimize(x0, data)
        assert bool(out.converged), int(out.stop_reason)
        n_res = 6 * int(data.edges.shape[0]) + 6
        dof = n_res - 6 * n
        assert float(out.final_cost) < 3.0 * max(dof, 1) * sig ** 2
        # and strictly better than the initial guess by orders
        assert float(out.final_cost) < 1e-3 * float(
            to.cost.rss(pose_graph_residuals(x0, data)))

    def test_gn_and_dogleg(self):
        data, x0, _ = make_pose_graph(n_poses=12, extra_loops=4,
                                      noise=1e-3, init_noise=0.05, seed=5)
        for st in (to.SolverType.GAUSS_NEWTON, to.SolverType.DOGLEG):
            x, out = pose_graph_optimize(
                x0, data, to.Options(solver_type=st))
            assert bool(out.converged), (st, int(out.stop_reason))
            assert float(out.final_cost) < 1e-3

    def test_first_order_rejected(self):
        data, x0, _ = make_pose_graph(n_poses=6, seed=0)
        with pytest.raises(ValueError):
            pose_graph_optimize(
                x0, data, to.Options(solver_type=to.SolverType.ADAM))

    def test_euclidean_blocks_and_edge_validation(self):
        """chain_optimize on plain (N, d) Euclidean blocks: spring chain
        with one long-range loop; compare against the dense solver."""
        rng = np.random.default_rng(7)
        N, d = 20, 2
        target = jnp.asarray(rng.normal(size=(N - 1, d)))

        def edge_fn(a, b, t):
            return (b - a) - t

        def anchor(a, _):
            return a

        edges = np.stack([np.arange(N - 1), np.arange(1, N)], 1)
        edges = np.concatenate([edges, [[0, N - 1]]])
        loop_t = jnp.asarray(rng.normal(size=(1, d)))
        e_data = jnp.concatenate([target, loop_t])
        x0 = jnp.zeros((N, d))
        x, out = chain_optimize(
            x0, edge_fn, edges, e_data,
            unary_fn=anchor, unary_nodes=[0],
            unary_data=jnp.zeros((1, d)))
        assert bool(out.converged)

        def full_res(x):
            r = jax.vmap(edge_fn)(x[edges[:, 0]], x[edges[:, 1]], e_data)
            return jnp.concatenate([r.reshape(-1), x[0]])

        xd, outd = to.optimize(x0, full_res)
        np.testing.assert_allclose(np.asarray(x), np.asarray(xd),
                                   rtol=1e-9, atol=1e-9)

        with pytest.raises(ValueError):
            chain_optimize(x0, edge_fn, np.asarray([[2, 2]]),
                           e_data[:1])

    def test_vmap_batched_instances(self):
        """The whole chain solve composes with vmap (the loop carries
        the ChainSystem pytree)."""
        rng = np.random.default_rng(9)
        N, d, Bb = 8, 2, 3
        targets = jnp.asarray(rng.normal(size=(Bb, N - 1, d)))
        edges = np.stack([np.arange(N - 1), np.arange(1, N)], 1)

        def edge_fn(a, b, t):
            return (b - a) - t

        def solve_one(tgt):
            x, out = chain_optimize(
                jnp.zeros((N, d)), edge_fn, edges, tgt,
                unary_fn=lambda a, _: a, unary_nodes=[0],
                unary_data=jnp.zeros((1, d)), jit=False)
            return x, out.final_cost

        xs, costs = jax.vmap(solve_one)(targets)
        expect = jnp.concatenate(
            [jnp.zeros((Bb, 1, d)), jnp.cumsum(targets, axis=1)], axis=1)
        # min_error=1e-12 stops at cost ~1e-12 ⇒ per-coordinate ~1e-6
        np.testing.assert_allclose(np.asarray(xs), np.asarray(expect),
                                   atol=1e-6)


class TestSpdInvGJ:
    """spd_inv_gj (r5): the unrolled Gauss-Jordan sweep inverse —
    exact inverse on SPD inputs, NaN-poisoned exactly when Cholesky
    would fail (some leading principal minor <= 0).  It is the OPT-IN
    (TINYOPT_CR_SWEEP_INV=1) CR level math, not the default: on the
    ill-conditioned flagship reduced system the explicit inverse costs
    ~half a digit per solve vs cho_solve and stalls the LM trajectory
    (ops/tridiag._cr_use_cholesky)."""

    @pytest.mark.parametrize("d", [1, 3, 6, 42, 60])
    def test_inverse_both_paths(self, d):
        # d <= 48 unrolls; d=60 takes the fori_loop path
        from tinyopt_tpu.ops.tridiag import spd_inv_gj
        rng = np.random.default_rng(d)
        A = rng.normal(size=(5, d, d))
        A = A @ A.transpose(0, 2, 1) + d * np.eye(d)
        inv = np.asarray(spd_inv_gj(jnp.asarray(A)))
        np.testing.assert_allclose(inv @ A,
                                   np.broadcast_to(np.eye(d), A.shape),
                                   atol=1e-8)

    def test_non_pd_poisoned(self):
        from tinyopt_tpu.ops.tridiag import spd_inv_gj
        bad = np.stack([-np.eye(4),                       # negative
                        np.eye(4) - 2.0 * np.ones((4, 4)),  # indefinite
                        np.eye(4)])                        # fine
        out = np.asarray(spd_inv_gj(jnp.asarray(bad)))
        assert np.all(np.isnan(out[0]))
        assert np.all(np.isnan(out[1]))
        np.testing.assert_allclose(out[2], np.eye(4), atol=1e-12)

    @pytest.mark.parametrize("level_math", ["cholesky", "sweep_inv"])
    def test_cr_matches_scan_factorization(self, level_math,
                                           monkeypatch):
        """block_tridiag_cr_solve == the sequential scan factor+solve
        on the same SPD system, under BOTH level maths (default
        cho_solve and the TINYOPT_CR_SWEEP_INV=1 explicit inverse)."""
        from tinyopt_tpu.ops.tridiag import (block_tridiag_cr_solve,
                                             block_tridiag_factor,
                                             block_tridiag_solve)
        if level_math == "sweep_inv":
            monkeypatch.setenv("TINYOPT_CR_SWEEP_INV", "1")
        else:
            monkeypatch.delenv("TINYOPT_CR_SWEEP_INV", raising=False)
        rng = np.random.default_rng(0)
        N, d, k = 37, 5, 2
        D = rng.normal(size=(N, d, d))
        D = D @ D.transpose(0, 2, 1) + 4 * d * np.eye(d)
        B = 0.3 * rng.normal(size=(N - 1, d, d))
        b = rng.normal(size=(N, d, k))
        x_cr = np.asarray(block_tridiag_cr_solve(
            jnp.asarray(D), jnp.asarray(B), jnp.asarray(b)))
        L, M, ok = block_tridiag_factor(jnp.asarray(D), jnp.asarray(B))
        assert bool(ok)
        x_sc = np.asarray(block_tridiag_solve(L, M, jnp.asarray(b)))
        np.testing.assert_allclose(x_cr, x_sc, rtol=1e-9, atol=1e-12)
