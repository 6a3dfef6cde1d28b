"""Mini bundle adjustment: joint pose+landmark refinement.

The flagship large-problem model (models/bundle_adjustment.py) — mixed
batched-SE3 + Euclidean parameter blocks through the dense and
matrix-free backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu import manifold as mf
from tinyopt_tpu.models.bundle_adjustment import (
    BAData, ba_residuals, make_ba_problem, reprojection_rmse)


class TestBatchedManifoldLeaves:
    def test_batched_se3_tangent_dims(self):
        from tinyopt_tpu.manifolds import SE3
        poses = SE3.exp(jnp.zeros((5, 6)))
        assert mf.tangent_spec(poses).dims == 30

    def test_batched_retract_roundtrip(self):
        from tinyopt_tpu.manifolds import SE3
        rng = np.random.default_rng(0)
        poses = SE3.exp(jnp.asarray(rng.uniform(-0.5, 0.5, (3, 6))))
        delta = jnp.asarray(rng.uniform(-0.1, 0.1, 18))
        moved = mf.retract(poses, delta)
        back = mf.local(poses, moved)
        np.testing.assert_allclose(np.asarray(back), np.asarray(delta),
                                   atol=1e-10)


class TestBundleAdjustment:
    def test_dense_solve_recovers_geometry(self):
        data, x0, x_true = make_ba_problem(n_cams=4, n_pts=16)
        spec = mf.tangent_spec(x0)
        assert spec.dims == 4 * 6 + 16 * 3

        rmse0 = float(reprojection_rmse(x0, data))
        x, out = to.optimize(x0, lambda p: ba_residuals(p, data),
                             to.Options(max_iters=100,
                                        max_consec_failures=0))
        assert bool(out.succeeded())
        rmse = float(reprojection_rmse(x, data))
        # see test_pose_graph: x is the evaluated min_error point, without
        # the formerly-applied unevaluated trailing step.
        assert rmse < 1e-6 and rmse < rmse0 * 1e-4

    def test_partial_visibility(self):
        data, x0, x_true = make_ba_problem(n_cams=5, n_pts=24,
                                           visibility=0.8, seed=3)
        x, out = to.optimize(x0, lambda p: ba_residuals(p, data),
                             to.Options(max_iters=100,
                                        max_consec_failures=0))
        assert float(reprojection_rmse(x, data)) < 1e-7

    def test_matfree_backend_on_larger_problem(self):
        """120-dim+ tangent through GN-CG without materializing H."""
        data, x0, x_true = make_ba_problem(n_cams=6, n_pts=40, seed=5)
        spec = mf.tangent_spec(x0)
        assert spec.dims == 6 * 6 + 40 * 3  # 156
        x, out = to.matfree_optimize(
            x0, lambda p: ba_residuals(p, data),
            to.Options(max_iters=100, max_consec_failures=0),
            cg_iters=80)
        assert bool(out.succeeded())
        assert float(reprojection_rmse(x, data)) < 1e-6

    def test_noisy_observations_converge_to_ml_estimate(self):
        data, x0, x_true = make_ba_problem(n_cams=4, n_pts=16, noise=1e-3,
                                           seed=7)
        x, out = to.optimize(x0, lambda p: ba_residuals(p, data),
                             to.Options(max_iters=150,
                                        max_consec_failures=0))
        # ML estimate: residual RMSE on the order of the injected noise
        assert float(reprojection_rmse(x, data)) == pytest.approx(
            1e-3, rel=0.5)


class TestLargeScaleMatfree:
    def test_thousand_dim_ba_converges(self):
        """16 cams × 300 landmarks (996 tangent dims) through the
        matrix-free GN-CG path — the regime the reference admits being
        slow in (README.md:30); neither J (9600×996) nor H (996²) is
        ever materialized (run_benchmarks.bench_ba runs the same code
        at 100 cams × 5000 landmarks)."""
        data, x0, _ = make_ba_problem(n_cams=16, n_pts=300, noise=1e-3,
                                      seed=0)
        x, out = to.matfree_optimize(
            x0, lambda p: ba_residuals(p, data),
            to.Options(max_iters=25, max_consec_failures=0), cg_iters=50)
        assert bool(out.succeeded())
        assert float(reprojection_rmse(x, data)) < 2e-3  # ~noise level
