"""Pose-graph optimization (SLAM backend model)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu import manifold as mf
from tinyopt_tpu.manifolds import SE3
from tinyopt_tpu.models.pose_graph import (make_pose_graph,
                                           pose_graph_residuals)


def _pose_errors(poses: SE3, true_poses: SE3):
    def one(q, t, qt, tt):
        from tinyopt_tpu.manifolds import SO3
        X = SE3(SO3(q), t)
        T = SE3(SO3(qt), tt)
        return jnp.linalg.norm((T.inverse() @ X).log())
    return jax.vmap(one)(poses.rotation.wxyz, poses.translation,
                         true_poses.rotation.wxyz, true_poses.translation)


class TestPoseGraph:
    def test_noise_free_recovery(self):
        data, x0, true_poses = make_pose_graph(n_poses=10, extra_loops=3)
        assert mf.tangent_spec(x0).dims == 60
        err0 = float(jnp.max(_pose_errors(x0, true_poses)))
        x, out = to.optimize(x0, lambda p: pose_graph_residuals(p, data),
                             to.Options(max_iters=100,
                                        max_consec_failures=0))
        assert bool(out.succeeded())
        err = float(jnp.max(_pose_errors(x, true_poses)))
        # x is the evaluated point whose cost passed min_error (1e-12);
        # parameter error at that cost level is ~sqrt(min_error) — the
        # loop no longer applies a free unevaluated trailing step.
        assert err < 1e-6 and err < err0 * 1e-4

    def test_noisy_measurements_converge(self):
        data, x0, true_poses = make_pose_graph(n_poses=14, extra_loops=5,
                                               noise=1e-2, seed=4)
        x, out = to.optimize(x0, lambda p: pose_graph_residuals(p, data),
                             to.Options(max_iters=150,
                                        max_consec_failures=0))
        assert bool(out.succeeded())
        # ML estimate: pose errors on the order of the measurement noise
        assert float(jnp.max(_pose_errors(x, true_poses))) < 0.1

    def test_matfree_backend(self):
        """Larger graph through GN-CG (tangent 180-dim)."""
        data, x0, true_poses = make_pose_graph(n_poses=30, extra_loops=8,
                                               seed=6)
        x, out = to.matfree_optimize(
            x0, lambda p: pose_graph_residuals(p, data),
            to.Options(max_iters=100, max_consec_failures=0),
            cg_iters=120)
        assert bool(out.succeeded())
        assert float(jnp.max(_pose_errors(x, true_poses))) < 1e-5


    def test_repeat_calls_reuse_compiled_solve(self):
        """pose_graph_optimize derives its (1, ·) anchor views per call;
        small data leaves key the solve cache by value, so a second call
        (and a call with an equal-valued copy of the data) reuses the
        compiled solve instead of recompiling."""
        from tinyopt_tpu import sparse
        from tinyopt_tpu.models.pose_graph import pose_graph_optimize

        data, x0, _ = make_pose_graph(n_poses=8, extra_loops=2,
                                      noise=1e-3, seed=6)
        opts = to.Options(max_consec_failures=0)
        sparse._SOLVE_CACHE.clear()
        x1, _ = pose_graph_optimize(x0, data, opts)
        assert len(sparse._SOLVE_CACHE) == 1
        x2, _ = pose_graph_optimize(x0, data, opts)
        assert len(sparse._SOLVE_CACHE) == 1
        np.testing.assert_array_equal(np.asarray(x1.translation),
                                      np.asarray(x2.translation))
        # a different anchor VALUE must not hit the same entry
        moved = data._replace(anchor_t=data.anchor_t + 1.0)
        pose_graph_optimize(x0, moved, opts)
        assert len(sparse._SOLVE_CACHE) == 2


class TestPoseGraphMarginals:
    def test_matches_dense_inverse(self):
        """SE3 pose marginals (Takahashi + Woodbury on the manifold
        tangent system) == diag blocks of the dense H⁻¹."""
        from tinyopt_tpu.chain import chain_system
        from tinyopt_tpu.models.pose_graph import (
            _anchor_fn, make_pose_graph, pose_graph_edge_fn,
            pose_graph_marginals, pose_graph_optimize)
        from tinyopt_tpu.ops.linalg import inv_cov
        from tinyopt_tpu import manifold as mf

        data, x0, _ = make_pose_graph(n_poses=10, extra_loops=3,
                                      noise=5e-3, seed=2)
        x, out = pose_graph_optimize(
            x0, data, to.Options(max_consec_failures=0))
        assert bool(out.succeeded())
        marg = pose_graph_marginals(x, data)

        spec = mf.tangent_spec(x)
        acc, *_ = chain_system(
            x, pose_graph_edge_fn, np.asarray(data.edges),
            (data.meas_q, data.meas_t), _anchor_fn, np.asarray([0]),
            (data.anchor_q[None], data.anchor_t[None]), spec)
        H, _, _ = jax.jit(acc)(x)
        dense = inv_cov(H.to_dense())
        d = 6
        for i in range(10):
            np.testing.assert_allclose(
                np.asarray(marg)[i],
                np.asarray(dense)[i * d:(i + 1) * d, i * d:(i + 1) * d],
                rtol=1e-7, atol=1e-10)
