"""Schur-complement elimination for bipartite NLLS (ops/schur.py).

The structure every production BA solver exploits and the regime the
reference concedes (/root/reference/README.md:30 "not fast for large
systems yet"); VERDICT r1 #9.  Spec: the Schur solve is algebraically
EXACT elimination — per-iteration steps, trajectories and Outputs must
match the dense solver on the same problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu as to
from tinyopt_tpu import manifold as mf
from tinyopt_tpu.manifolds import SE3
from tinyopt_tpu.models.bundle_adjustment import (BAData, ba_residuals,
                                                  make_ba_problem, project,
                                                  reprojection_rmse)
from tinyopt_tpu.ops.schur import schur_system


def pair_fn(pose, point, obs):
    return project(pose, point[None, :])[0] - obs


def _dense_equiv(data):
    return lambda p: ba_residuals(p, data)


class TestExactElimination:
    def test_propose_matches_dense_solve(self):
        """One damped Schur step == the dense (H + λ·diag) step on the
        identical normal equations (elimination is exact algebra)."""
        data, x0, _ = make_ba_problem(n_cams=3, n_pts=10)
        x_t = (x0["poses"], x0["points"])
        spec = mf.tangent_spec(x_t)
        acc, ev, n_res, propose = schur_system(
            pair_fn, x_t[0], x_t[1], data.observations, data.mask, spec)
        H, g, cost = acc(x_t)

        from tinyopt_tpu.diff.auto import make_nlls_system
        # dense system over the SAME tangent layout
        acc_d, _, _ = make_nlls_system(
            lambda x: ba_residuals({"poses": x[0], "points": x[1]}, data),
            x_t, spec)
        Hd, gd, cost_d = acc_d(x_t)
        np.testing.assert_allclose(np.asarray(g), np.asarray(gd),
                                   rtol=1e-9, atol=1e-12)
        assert float(cost.cost) == pytest.approx(float(cost_d.cost),
                                                 rel=1e-12)

        from tinyopt_tpu.solvers.step import propose_step
        opts = to.Options()
        for lam in (1e-4, 1e-1, 10.0):
            dx_s, ok_s = propose(H, g, jnp.asarray(lam), opts)
            dx_d, ok_d = propose_step(Hd, gd, jnp.asarray(lam), opts)
            assert bool(ok_s) and bool(ok_d)
            np.testing.assert_allclose(np.asarray(dx_s), np.asarray(dx_d),
                                       rtol=1e-7, atol=1e-10)

    def test_full_solve_matches_dense(self):
        data, x0, _ = make_ba_problem(n_cams=4, n_pts=12)
        opts = to.Options(max_iters=30, max_consec_failures=0)
        x_s, out_s = to.schur_optimize((x0["poses"], x0["points"]), pair_fn,
                                       data.observations, data.mask, opts)
        x_d, out_d = to.optimize(x0, _dense_equiv(data), opts)
        assert int(out_s.num_iters) == int(out_d.num_iters)
        assert int(out_s.stop_reason) == int(out_d.stop_reason)
        assert float(out_s.final_cost.cost) == pytest.approx(
            float(out_d.final_cost.cost), rel=1e-6, abs=1e-18)
        np.testing.assert_allclose(np.asarray(x_s[1]),
                                   np.asarray(x_d["points"]),
                                   rtol=1e-5, atol=1e-7)


class TestSchurSystemAlgebra:
    def _random_system(self, seed=0, n_a=3, da=2, n_b=5, db=3, coupling=0.1):
        from tinyopt_tpu.ops.schur import SchurSystem
        rng = np.random.default_rng(seed)
        def spd(n, d):
            A = rng.normal(size=(n, d, d))
            return jnp.asarray(A @ A.transpose(0, 2, 1) + 3.0 * np.eye(d))
        E = jnp.asarray(coupling * rng.normal(size=(n_a, n_b, da, db)))
        return SchurSystem(spd(n_a, da), spd(n_b, db), E)

    def test_to_dense_and_matvec(self):
        H = self._random_system()
        Hd = np.asarray(H.to_dense())
        assert Hd.shape == H.shape
        np.testing.assert_allclose(Hd, Hd.T, atol=1e-12)
        v = np.random.default_rng(1).normal(size=(H.dims,))
        np.testing.assert_allclose(np.asarray(H.matvec(jnp.asarray(v))),
                                   Hd @ v, rtol=1e-10, atol=1e-12)

    def test_block_inverse_matches_dense(self):
        """inv() (Schur block inversion) == dense inverse of to_dense()."""
        H = self._random_system(seed=2)
        cov = np.asarray(H.inv().to_dense())
        np.testing.assert_allclose(cov @ np.asarray(H.to_dense()),
                                   np.eye(H.dims), atol=1e-8)


def _anchored_pair_fn(a_i, b_j, d_ij):
    """Bipartite residual with per-pair priors — H is nonsingular (no
    gauge freedom), so the posterior covariance exists."""
    return jnp.stack([a_i[0] + b_j[0] - d_ij,
                      0.3 * a_i[0], 0.3 * b_j[0]])


class TestCovarianceAndCounts:
    def _solve(self):
        rng = np.random.default_rng(5)
        n_a, n_b = 3, 4
        a_true = rng.normal(size=(n_a, 1))
        b_true = rng.normal(size=(n_b, 1))
        d = jnp.asarray(a_true[:, None, 0] + b_true[None, :, 0]
                        + 1e-2 * rng.normal(size=(n_a, n_b)))
        mask = jnp.asarray(rng.random((n_a, n_b)) < 0.75, jnp.float64)
        x0 = (jnp.zeros((n_a, 1)), jnp.zeros((n_b, 1)))
        x, out = to.schur_optimize(x0, _anchored_pair_fn, d, mask,
                                   to.Options(max_iters=30))
        return x, out, mask

    def test_num_residuals_counts_observed_pairs_only(self):
        """Masked grid slots are not measurements: Cost.num_residuals =
        (#observed pairs)·m, not n_a·n_b·m."""
        x, out, mask = self._solve()
        assert int(out.final_cost.num_residuals) == int(
            jnp.count_nonzero(mask)) * 3

    def test_output_covariance_matches_dense_inverse(self):
        """Output.covariance() on the saved SchurSystem == inverse of the
        densified arrow H (default save_last path)."""
        x, out, mask = self._solve()
        assert bool(out.converged())
        H = out.final_hessian
        cov = np.asarray(out.covariance())
        assert np.all(np.isfinite(cov))
        np.testing.assert_allclose(
            cov, np.linalg.inv(np.asarray(H.to_dense())),
            rtol=1e-7, atol=1e-10)
        # rescaled variant applies the reference's cost²/(n−dims) factor
        # with n = OBSERVED count (output.h:80-93)
        cov_r = np.asarray(out.covariance(rescaled=True))
        n = int(out.final_cost.num_residuals)
        c = float(out.final_cost.cost)
        np.testing.assert_allclose(
            cov_r, cov * (c * c / (n - H.dims)), rtol=1e-7)


class TestBA:
    def test_partial_visibility(self):
        data, x0, x_true = make_ba_problem(n_cams=5, n_pts=24,
                                           visibility=0.7, seed=3)
        x, out = to.schur_optimize((x0["poses"], x0["points"]), pair_fn,
                                   data.observations, data.mask,
                                   to.Options(max_iters=50,
                                              max_consec_failures=0))
        assert bool(out.converged())
        rmse = reprojection_rmse({"poses": x[0], "points": x[1]}, data)
        assert float(rmse) < 1e-8

    def test_larger_problem_converges(self):
        """10 cams x 200 landmarks (660 tangent dims): the reduced camera
        system is only 60x60."""
        data, x0, _ = make_ba_problem(n_cams=10, n_pts=200, noise=1e-3,
                                      seed=7)
        x, out = to.schur_optimize(
            (x0["poses"], x0["points"]), pair_fn,
            data.observations, data.mask,
            to.Options(max_iters=40, max_consec_failures=0,
                       min_error=0.0))
        assert bool(out.succeeded())
        rmse = reprojection_rmse({"poses": x[0], "points": x[1]}, data)
        assert float(rmse) < 2e-3        # at the observation-noise level

    def test_gn_mode_matches_dense(self):
        """Undamped GN on a gauge-singular BA fails on BOTH paths with
        the same classification (the Schur solve must not mask a
        singular reduced system)."""
        data, x0, _ = make_ba_problem(n_cams=3, n_pts=10)
        opts = to.Options(solver_type=to.GaussNewton, max_iters=20)
        x_s, out_s = to.schur_optimize((x0["poses"], x0["points"]), pair_fn,
                                       data.observations, data.mask, opts)
        x_d, out_d = to.optimize(x0, _dense_equiv(data), opts)
        assert int(out_s.stop_reason) == int(out_d.stop_reason)
        assert int(out_s.stop_reason) == int(to.StopReason.SOLVER_FAILED)

    def test_validation(self):
        data, x0, _ = make_ba_problem(n_cams=3, n_pts=8)
        with pytest.raises(ValueError, match=r"\(a0, b0\)"):
            to.schur_optimize(x0, pair_fn, data.observations, data.mask)
        with pytest.raises(ValueError, match="first-order"):
            to.schur_optimize((x0["poses"], x0["points"]), pair_fn,
                              data.observations, data.mask,
                              to.Options(solver_type=to.Adam))


class TestRobustSchur:
    """Robust M-estimation composes with the Schur path: a whitened
    pair_fn (losses.robust_whiten) carries the robustification into the
    per-pair Jacobians by AD — the production outlier-contaminated BA
    pattern.  Measured landscape on this instance (43/378 observed pairs
    corrupted by ~0.5-magnitude gross offsets, noise 1e-3):

      plain LM                    clean-inlier rmse 7.2e-2  (dragged off)
      Huber th=5e-3 (one stage)   1.25e-2 — its own global optimum (the
                                  oracle point has HIGHER Huber cost:
                                  0.3237 vs 0.3190, and re-solving FROM
                                  the oracle point returns here), i.e.
                                  the linear tail's estimator bias
      GNC Geman-McClure anneal    8.35e-4 == oracle (outliers masked)
    """

    def _contaminated(self):
        noise = 1e-3
        data, x0, x_true = make_ba_problem(n_cams=6, n_pts=64,
                                           noise=noise, seed=13)
        rng = np.random.default_rng(99)
        out_grid = (rng.uniform(size=data.mask.shape) < 0.15)
        gross = rng.uniform(0.3, 0.7, data.observations.shape) * \
            rng.choice([-1.0, 1.0], data.observations.shape)
        obs_bad = jnp.where(jnp.asarray(out_grid)[:, :, None]
                            * data.mask[:, :, None] > 0,
                            data.observations + jnp.asarray(gross),
                            data.observations)
        clean_mask = data.mask * (1.0 - jnp.asarray(
            out_grid.astype(float)))
        from tinyopt_tpu.models.bundle_adjustment import BAData
        clean_data = BAData(data.observations, clean_mask)

        def clean_rmse(x):
            r = ba_residuals({"poses": x[0], "points": x[1]}, clean_data)
            n = jnp.maximum(jnp.sum(clean_mask) * 2.0, 1.0)
            return float(jnp.sqrt(jnp.sum(r * r) / n))

        return data, obs_bad, clean_mask, clean_rmse, \
            (x0["poses"], x0["points"])

    def test_gnc_geman_mcclure_reaches_oracle(self):
        """Annealed (graduated non-convexity) Geman-McClure whitening
        recovers the outlier-free geometry exactly: final clean-inlier
        rmse matches the oracle solve (corrupted pairs masked away)."""
        from tinyopt_tpu.losses.robust_norms import (geman_mcclure,
                                                     gnc_anneal,
                                                     gnc_schedule,
                                                     robust_whiten)
        data, obs_bad, clean_mask, clean_rmse, xt = self._contaminated()
        o = to.Options(max_iters=60, max_consec_failures=0, min_error=0.0)

        x_orc, _ = to.schur_optimize(xt, pair_fn, obs_bad, clean_mask, o)
        oracle = clean_rmse(x_orc)

        def stage(x, th2):
            def rp(pose, point, obs):
                return robust_whiten(pair_fn(pose, point, obs),
                                     geman_mcclure, th2)
            return to.schur_optimize(x, rp, obs_bad, data.mask, o)

        sched = gnc_schedule(0.5, 5e-3, steps=5)
        assert sched[0] == 0.5 and abs(sched[-1] - 5e-3) < 1e-12
        x, out = gnc_anneal(stage, xt, sched)
        assert bool(out.succeeded())
        got = clean_rmse(x)
        assert got < 1.05 * oracle, (got, oracle)

    def test_gnc_anneal_owns_caching(self):
        """The 3-arg gnc_anneal API builds the per-threshold whitened
        fns itself and memoizes them across calls: a SECOND anneal call
        adds no new entries to the solve cache (i.e. compiles nothing
        new) and reproduces the first call's result (VERDICT r4 #6)."""
        from tinyopt_tpu import sparse as sp
        from tinyopt_tpu.losses.robust_norms import (geman_mcclure,
                                                     gnc_anneal,
                                                     gnc_schedule)
        data, obs_bad, clean_mask, clean_rmse, xt = self._contaminated()
        o = to.Options(max_iters=20, max_consec_failures=0, min_error=0.0)

        def stage(x, th2, rp):
            return to.schur_optimize(x, rp, obs_bad, data.mask, o)

        sched = gnc_schedule(0.5, 5e-3, steps=3)
        x1, out1 = gnc_anneal(stage, xt, sched, residual_fn=pair_fn,
                              robust_fn=geman_mcclure)
        n_cached = len(sp._SOLVE_CACHE)
        x2, out2 = gnc_anneal(stage, xt, sched, residual_fn=pair_fn,
                              robust_fn=geman_mcclure)
        assert len(sp._SOLVE_CACHE) == n_cached
        for l1, l2 in zip(jax.tree_util.tree_leaves(x1),
                          jax.tree_util.tree_leaves(x2)):
            assert jnp.allclose(l1, l2)
        assert bool(out2.succeeded())

    def test_single_stage_huber_beats_plain(self):
        """One-stage Huber lands at its own (tail-biased) optimum —
        far better than plain LM, far worse than GNC (docstring table)."""
        from tinyopt_tpu.losses.robust_norms import huber, robust_whiten
        data, obs_bad, clean_mask, clean_rmse, xt = self._contaminated()
        o = to.Options(max_iters=60, max_consec_failures=0, min_error=0.0)
        x_plain, _ = to.schur_optimize(xt, pair_fn, obs_bad, data.mask, o)

        th2 = (5e-3) ** 2

        def rp(pose, point, obs):
            return robust_whiten(pair_fn(pose, point, obs), huber, th2)

        x_rob, out = to.schur_optimize(xt, rp, obs_bad, data.mask, o)
        assert bool(out.succeeded())
        e_plain, e_rob = clean_rmse(x_plain), clean_rmse(x_rob)
        assert e_rob < 2e-2, e_rob
        assert e_plain > 4 * e_rob, (e_plain, e_rob)


class TestSchurSparseObs:
    """Point-major sparse-observation Schur (ops/schur_obs.py): the
    memory-scalable form — O(n_obs) instead of the grid's O(n_a·n_b).
    Same algebra, so the grid and obs layouts of one instance must
    produce identical trajectories."""

    def _instance(self):
        data, x0, _ = make_ba_problem(n_cams=6, n_pts=40, noise=1e-4,
                                      seed=5, visibility=0.5)
        return data, x0

    @pytest.mark.parametrize("solver", [to.LevenbergMarquardt, to.DogLeg])
    def test_matches_grid_layout(self, solver):
        from tinyopt_tpu.ops.schur_obs import grid_to_obs
        data, x0 = self._instance()
        xt = (x0["poses"], x0["points"])
        o = to.Options(max_iters=10, max_consec_failures=0,
                       solver_type=solver,
                       hessian=to.HessianOptions(save_last=False))
        x_g, out_g = to.schur_optimize(xt, pair_fn, data.observations,
                                       data.mask, o)
        obs, cam_idx, smask = grid_to_obs(data.observations, data.mask)
        x_s, out_s = to.schur_sparse_optimize(xt, pair_fn, obs, cam_idx,
                                              smask, o)
        np.testing.assert_allclose(np.asarray(x_s[1]), np.asarray(x_g[1]),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(x_s[0].translation),
                                   np.asarray(x_g[0].translation),
                                   rtol=1e-7, atol=1e-9)
        assert int(out_s.num_iters) == int(out_g.num_iters)
        assert int(out_s.stop_reason) == int(out_g.stop_reason)
        assert int(out_s.final_cost.num_residuals) == int(
            out_g.final_cost.num_residuals)

    def test_corridor_rig_converges(self):
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, reprojection_rmse_sparse)
        (obs, cam_idx, mask), x0, _ = make_ba_problem_sparse(
            n_cams=50, n_pts=500, k_obs=6, noise=1e-4, seed=3)
        o = to.Options(max_iters=15, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False))
        (p, l), out = to.schur_sparse_optimize(
            (x0["poses"], x0["points"]), pair_fn, obs, cam_idx, mask, o)
        assert bool(out.succeeded())
        rmse = float(reprojection_rmse_sparse(
            {"poses": p, "points": l}, obs, cam_idx, mask))
        assert rmse < 1.2e-4, rmse

    def test_grid_to_obs_k_too_small_raises(self):
        from tinyopt_tpu.ops.schur_obs import grid_to_obs
        data, _ = self._instance()
        dense_count = int(np.asarray(data.mask).astype(bool)
                          .sum(axis=0).max())
        with pytest.raises(ValueError, match="densest"):
            grid_to_obs(data.observations, data.mask, K=dense_count - 1)

    def test_matvec_matches_dense_assembly(self):
        """SchurObsSystem.matvec (gather + segment_sum arrow products)
        == the dense H of the equivalent grid system."""
        from tinyopt_tpu.ops.schur import schur_system
        from tinyopt_tpu.ops.schur_obs import grid_to_obs, schur_obs_system
        from tinyopt_tpu import manifold as mf
        data, x0 = self._instance()
        xt = (x0["poses"], x0["points"])
        spec = mf.tangent_spec(xt)
        acc_g, *_ = schur_system(pair_fn, xt[0], xt[1],
                                 data.observations, data.mask, spec)
        obs, cam_idx, smask = grid_to_obs(data.observations, data.mask)
        acc_s, *_ = schur_obs_system(pair_fn, xt[0], xt[1], obs, cam_idx,
                                     smask, spec)
        Hg, gg_, _ = jax.jit(acc_g)(xt)
        Hs, gs_, _ = jax.jit(acc_s)(xt)
        np.testing.assert_allclose(np.asarray(gs_), np.asarray(gg_),
                                   rtol=1e-9, atol=1e-12)
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.normal(size=(spec.dims,)))
        np.testing.assert_allclose(np.asarray(Hs.matvec(v)),
                                   np.asarray(Hg.matvec(v)),
                                   rtol=1e-9, atol=1e-12)


class TestSchurRefine:
    """hessian.schur_refine (options.py:150): mixed-precision iterative
    refinement of the reduced camera solve (ops/linalg.refine_psd_solve,
    consumed by ops/schur_obs.assemble_reduced on both the single-device
    and mesh-sharded sparse-obs paths)."""

    def test_refine_recovers_stored_f32_solution(self):
        """On a cond~1e6 reduced system, the plain f32 factorization's
        forward error is ~1e-3; two f64-residual refinement rounds
        recover the stored system's exact solution to ~1e-7."""
        from tinyopt_tpu.ops.schur_obs import assemble_reduced
        rng = np.random.default_rng(0)
        n = 64
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        S64 = (Q * np.logspace(-6, 0, n)) @ Q.T   # cond 1e6
        b64 = rng.normal(size=n)
        S32 = jnp.asarray(S64, jnp.float32)
        b32 = jnp.asarray(b64, jnp.float32)
        # exact solution of the STORED f32 system, computed in f64
        x_store = np.linalg.solve(np.asarray(S32, np.float64),
                                  np.asarray(b32, np.float64))
        # assemble_reduced with da=1: S = diag(0) − scatter(−S),
        # rhs = −0 + b.
        S_f = (-S32).reshape(n * n, 1)
        Bd = jnp.zeros((n, 1, 1), jnp.float32)
        g_a = jnp.zeros((n, 1), jnp.float32)
        rhs_acc = b32.reshape(n, 1)

        def err(refine):
            dx, ok = assemble_reduced(S_f, rhs_acc, Bd, g_a, True, refine)
            assert bool(ok)
            return float(np.abs(np.asarray(dx, np.float64).ravel()
                                - x_store).max() / np.abs(x_store).max())

        e0, e2 = err(0), err(2)
        assert e0 > 1e-4, e0          # measurably wrong without refine
        assert e2 < 1e-6, e2          # near-f64 recovery with 2 rounds
        assert e2 < e0 / 100.0, (e0, e2)

    def _corridor_f32(self):
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse)
        (obs, cam_idx, mask), x0, _ = make_ba_problem_sparse(
            n_cams=40, n_pts=200, k_obs=4, noise=1e-4, seed=3)
        cast = lambda t: jax.tree_util.tree_map(
            lambda l: l.astype(jnp.float32)
            if jnp.issubdtype(l.dtype, jnp.floating) else l, t)
        return (cast(obs), cam_idx, mask.astype(jnp.float32),
                (cast(x0["poses"]), jnp.asarray(x0["points"], jnp.float32)))

    def test_refine_zero_trajectory_unchanged(self):
        """refine=0 (the default) is bit-identical to an explicitly
        constructed refine=0 Options; refine=2 converges on the same
        instance (the option flows through the sparse-obs propose)."""
        obs, cam_idx, mask, xt = self._corridor_f32()

        def solve(refine):
            o = to.Options(max_iters=10, max_consec_failures=0,
                           hessian=to.HessianOptions(
                               save_last=False, schur_refine=refine)
                           ).for_dtype(jnp.float32)
            return to.schur_sparse_optimize(xt, pair_fn, obs, cam_idx,
                                            mask, o)
        (p0, l0), out0 = solve(0)
        o_def = to.Options(max_iters=10, max_consec_failures=0,
                           hessian=to.HessianOptions(save_last=False)
                           ).for_dtype(jnp.float32)
        (pd, ld), outd = to.schur_sparse_optimize(xt, pair_fn, obs,
                                                  cam_idx, mask, o_def)
        np.testing.assert_array_equal(np.asarray(l0), np.asarray(ld))
        np.testing.assert_array_equal(np.asarray(p0.translation),
                                      np.asarray(pd.translation))
        assert int(out0.num_iters) == int(outd.num_iters)

        (p2, l2), out2 = solve(2)
        assert bool(out2.succeeded()), int(out2.stop_reason)
        from tinyopt_tpu.models.bundle_adjustment import (
            reprojection_rmse_sparse)
        rmse2 = float(reprojection_rmse_sparse(
            {"poses": p2, "points": l2}, obs, cam_idx, mask))
        assert rmse2 < 1.5e-4, rmse2   # noise-level solution


class TestSpdInvBlocks:
    """Closed-form batched SPD block inverse (ops/schur_obs.spd_inv_blocks):
    must match the Cholesky inverse on PD blocks and preserve the non-PD
    -> NaN failure contract the λ-escalation depends on."""

    @pytest.mark.parametrize("db", [1, 2, 3, 4])
    def test_matches_inverse_and_nan_contract(self, db):
        from tinyopt_tpu.ops.schur_obs import spd_inv_blocks
        rng = np.random.default_rng(db)
        A = rng.normal(size=(32, db, db))
        C = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(db)
        Ci = np.asarray(spd_inv_blocks(jnp.asarray(C)))
        np.testing.assert_allclose(Ci, np.linalg.inv(C),
                                   rtol=1e-9, atol=1e-11)
        # non-PD: indefinite and negative-definite blocks -> NaN
        bad = np.asarray([-np.eye(db),
                          np.eye(db) - 2 * np.ones((db, db))])
        out = np.asarray(spd_inv_blocks(jnp.asarray(bad)))
        assert np.all(np.isnan(out[0]))
        if db > 1:
            assert np.any(np.isnan(out[1]))


class TestBandedReduced:
    """Block-banded reduced camera solve (hessian.schur_banded="auto"):
    corridor-style rigs detected from the static co-observation
    structure and solved by chain CR instead of the dense Cholesky —
    exact algebra, so trajectories must match the dense path."""

    def test_detection(self):
        from tinyopt_tpu.ops.schur_obs import (detect_camera_bandwidth,
                                               pick_band_group)
        cam = np.asarray([[0, 1, 2], [3, 4, 5], [7, 9, 8]])
        mask = np.ones((3, 3))
        assert detect_camera_bandwidth(cam, mask) == 2
        mask2 = np.asarray([[1, 1, 1], [1, 1, 1], [1, 0, 0]])
        assert detect_camera_bandwidth(cam, mask2) == 2
        # masked slots with pad-0 cams must not inflate the span
        cam3 = np.asarray([[50, 0, 0]])
        assert detect_camera_bandwidth(cam3,
                                       np.asarray([[1, 0, 0]])) == 0
        assert pick_band_group(5, 60, 6) == 5
        assert pick_band_group(100, 120, 6) is None     # block too big
        assert pick_band_group(5, 20, 6) is None        # too few groups

    def test_gate_boundaries_exact(self):
        """pick_band_group at the exact gate edges (VERDICT r4 #8):
        max_block and min_groups both inclusive-boundary semantics."""
        from tinyopt_tpu.ops.schur_obs import pick_band_group
        # block-size gate: g*da <= 384
        assert pick_band_group(64, 512, 6) == 64        # 384 == 384: in
        assert pick_band_group(65, 520, 6) is None      # 390 > 384: out
        # group-count gate: n_a // g >= 8
        assert pick_band_group(7, 56, 6) == 7           # 8 groups: in
        assert pick_band_group(7, 55, 6) is None        # 7 groups: out
        # degenerate bandwidths
        assert pick_band_group(0, 64, 6) == 1           # diag -> g=1
        assert pick_band_group(1, 7, 6) is None

    @pytest.mark.parametrize("solver", [to.LevenbergMarquardt, to.DogLeg])
    def test_matches_dense_path(self, solver):
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=60, n_pts=600, k_obs=6, noise=1e-4, seed=3)

        def pf(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        xt = (x0["poses"], x0["points"])
        o_off = to.Options(max_iters=10, max_consec_failures=0,
                           solver_type=solver,
                           hessian=to.HessianOptions(
                               save_last=False, schur_banded="off"))
        o_on = to.Options(max_iters=10, max_consec_failures=0,
                          solver_type=solver,
                          hessian=to.HessianOptions(save_last=False))
        (p1, l1), out1 = to.schur_sparse_optimize(xt, pf, obs, ci, mk,
                                                  o_off)
        (p2, l2), out2 = to.schur_sparse_optimize(xt, pf, obs, ci, mk,
                                                  o_on)
        np.testing.assert_allclose(np.asarray(l2), np.asarray(l1),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(p2.translation),
                                   np.asarray(p1.translation),
                                   rtol=1e-8, atol=1e-10)
        assert int(out2.num_iters) == int(out1.num_iters)

    def test_banded_with_refine(self):
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, reprojection_rmse_sparse, project)
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=60, n_pts=600, k_obs=6, noise=1e-4, seed=3)

        def pf(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        o = to.Options(max_iters=12, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False,
                                                 schur_refine=2))
        (p, l), out = to.schur_sparse_optimize(
            (x0["poses"], x0["points"]), pf, obs, ci, mk, o)
        assert bool(out.succeeded())
        rmse = float(reprojection_rmse_sparse(
            {"poses": p, "points": l}, obs, ci, mk))
        assert rmse < 1.2e-4, rmse


class TestBandedGate:
    """Adversarial structures for schur_banded="auto" (VERDICT r4 #8):
    bandwidths just under/over the gate and unordered rigs must select
    the right reduced-solve path, with f64 trajectory parity between
    "auto" and the forced-dense "off" in every case — no silent
    wrong-path selection."""

    def _instance(self, n_cams=60, n_pts=400, k_obs=4, seed=5):
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse)
        (obs, ci, mk), x0, x_true = make_ba_problem_sparse(
            n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=1e-4,
            seed=seed)
        return (obs, np.array(ci), np.array(mk)), x0, x_true

    @staticmethod
    def _reproject_row(x_true, ci_row, pt_idx, noise, seed):
        """Recompute one landmark's observations for edited cam slots."""
        from tinyopt_tpu.manifolds import SE3, SO3
        from tinyopt_tpu.models.bundle_adjustment import project
        poses, pt = x_true["poses"], x_true["points"][pt_idx]
        row = jax.vmap(lambda c: project(
            SE3(SO3(poses.rotation.wxyz[c]), poses.translation[c]),
            pt[None, :])[0])(jnp.asarray(ci_row, jnp.int32))
        rng = np.random.default_rng(seed)
        return row + jnp.asarray(rng.normal(size=row.shape) * noise,
                                 row.dtype)

    def _force_bandwidth(self, inst, bw, seed=11):
        """Edit landmark 0's slots to span exactly [0, bw]."""
        (obs, ci, mk), x0, x_true = inst
        ci = ci.copy()
        ci[0] = [0, bw, 1, 2][: ci.shape[1]]
        obs = jnp.asarray(obs).at[0].set(
            self._reproject_row(x_true, ci[0], 0, 1e-4, seed))
        return (obs, jnp.asarray(ci, np.int32), jnp.asarray(mk)), x0

    def _solve_pair(self, data, x0, max_iters=8):
        from tinyopt_tpu.models.bundle_adjustment import project

        def pf(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        obs, ci, mk = data
        xt = (x0["poses"], x0["points"])
        outs = []
        for banded in ("auto", "off"):
            o = to.Options(max_iters=max_iters, max_consec_failures=0,
                           hessian=to.HessianOptions(
                               save_last=False, schur_banded=banded))
            outs.append(to.schur_sparse_optimize(xt, pf, obs, ci, mk, o))
        (xa, oa), (xd, od) = outs
        # exact algebra either path; tolerance = f64 rounding noise
        # amplified over the 8-iteration trajectory
        np.testing.assert_allclose(np.asarray(xa[1]), np.asarray(xd[1]),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(xa[0].translation),
                                   np.asarray(xd[0].translation),
                                   rtol=1e-7, atol=1e-9)
        assert int(oa.num_iters) == int(od.num_iters)
        assert int(oa.stop_reason) == int(od.stop_reason)
        assert bool(oa.succeeded())

    def _gate_of(self, data, n_cams, da=6):
        from tinyopt_tpu.ops.schur_obs import (detect_camera_bandwidth,
                                               pick_band_group)
        _, ci, mk = data
        return pick_band_group(
            detect_camera_bandwidth(np.asarray(ci), np.asarray(mk)),
            n_cams, da)

    def test_bandwidth_just_under_gate_uses_banded(self):
        """bw=7 on 60 cams: exactly min_groups=8 groups -> banded path
        active, trajectory must equal the dense path."""
        inst = self._instance()
        data, x0 = self._force_bandwidth(inst, 7)
        assert self._gate_of(data, 60) == 7
        self._solve_pair(data, x0)

    def test_bandwidth_just_over_gate_falls_back_dense(self):
        """bw=8 on 60 cams: 7 groups < min_groups -> gate must refuse
        (a banded solve here would still be exact, but the gate's
        contract is dense); solve stays correct."""
        inst = self._instance()
        data, x0 = self._force_bandwidth(inst, 8)
        assert self._gate_of(data, 60) is None
        self._solve_pair(data, x0)

    def test_unordered_rig_falls_back_dense(self):
        """Randomly relabeled cameras: bw ~ n_cams, banded grouping
        would be WRONG algebra -> gate must refuse; solve correct."""
        from tinyopt_tpu.manifolds import SE3, SO3
        (obs, ci, mk), x0, _ = self._instance()
        rng = np.random.default_rng(3)
        perm = rng.permutation(60)          # old label -> new label
        inv = np.argsort(perm)
        ci2 = perm[ci]
        poses = x0["poses"]
        x0p = {"poses": SE3(SO3(poses.rotation.wxyz[inv]),
                            poses.translation[inv]),
               "points": x0["points"]}
        data = (jnp.asarray(obs), jnp.asarray(ci2, np.int32),
                jnp.asarray(mk))
        gate = self._gate_of(data, 60)
        assert gate is None, gate
        self._solve_pair(data, x0p)


class TestWindowReduceAndSort:
    """The windowed matmul segment reduction (ops/schur_obs.py) and the
    internal camera-locality landmark sort behind it: exact same algebra
    as the gather/scatter reduces, so f64 trajectories must match; the
    sort must activate exactly when the natural order defeats the
    window plan but the sorted order admits it."""

    def test_plan_prefers_natural_when_local(self, monkeypatch):
        monkeypatch.setenv("TINYOPT_WINDOW_REDUCE", "1")
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse)
        from tinyopt_tpu.ops.schur_obs import camera_sort_perm
        (_, ci, mk), _, _ = make_ba_problem_sparse(
            n_cams=300, n_pts=4096, k_obs=6, noise=1e-4, seed=3)
        # ~1500 distinct pair segments per chunk: natural order plans
        assert camera_sort_perm(np.asarray(ci), np.asarray(mk),
                                300, 6) is None

    def test_window_disabled_off_mxu_by_default(self):
        """The window reduce is off by default (schur_obs.window_default):
        the sort must not activate without the override."""
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse)
        from tinyopt_tpu.ops.schur_obs import camera_sort_perm
        (_, ci, mk), _, _ = make_ba_problem_sparse(
            n_cams=300, n_pts=4096, k_obs=6, noise=1e-4, seed=3)
        assert camera_sort_perm(np.asarray(ci), np.asarray(mk),
                                300, 6) is None

    def test_sort_activates_and_matches(self, monkeypatch):
        """300 cams x 8192 pts, K=8: ~10.8k distinct pair segments
        defeat the natural window plan; the primary-camera sort brings
        per-chunk windows under budget.  Sorted (auto) trajectory ==
        forced-natural (off) trajectory."""
        monkeypatch.setenv("TINYOPT_WINDOW_REDUCE", "1")
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        from tinyopt_tpu.ops.schur_obs import camera_sort_perm
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=300, n_pts=8192, k_obs=8, noise=1e-4, seed=5)
        perm = camera_sort_perm(np.asarray(ci), np.asarray(mk), 300, 8)
        assert perm is not None, "sort should activate at this shape"

        def pf(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        xt = (x0["poses"], x0["points"])
        outs = []
        for hs in ("auto", "off"):
            o = to.Options(max_iters=4, max_consec_failures=0,
                           hessian=to.HessianOptions(save_last=False,
                                                     schur_sort=hs))
            outs.append(to.schur_sparse_optimize(xt, pf, obs, ci, mk, o))
        (xa, oa), (xn, on) = outs
        assert int(oa.num_iters) == int(on.num_iters)
        assert int(oa.stop_reason) == int(on.stop_reason)
        np.testing.assert_allclose(np.asarray(xa[1]), np.asarray(xn[1]),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(xa[0].translation),
                                   np.asarray(xn[0].translation),
                                   rtol=1e-7, atol=1e-9)

    def test_window_reduce_matches_scatter(self):
        """make_reduce_pass_window == make_reduce_pass (scatter) on the
        same system blocks (pure reduction parity, f64)."""
        from tinyopt_tpu import manifold as mft
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        from tinyopt_tpu.ops.schur_obs import (
            _pick_chunk, make_obs_kernels, make_reduce_pass,
            make_reduce_pass_window, plan_window_reduce)
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=24, n_pts=128, k_obs=4, noise=1e-3, seed=9)

        def pf(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        a0 = mft.as_pytree(x0["poses"])
        spec_a = mft.tangent_spec(
            jax.tree_util.tree_map(lambda l: l[0], a0))
        spec_b = mft.tangent_spec(x0["points"][0])
        CH = _pick_chunk(128, 32)
        acc_slab, _, _, _ = make_obs_kernels(
            pf, a0, spec_a, spec_b, jnp.float64, 24, 4, CH)
        mkf = jnp.asarray(mk, jnp.float64)
        Ba, g_a, E_f, C_f, g_b, _ = jax.jit(
            lambda b: acc_slab(a0, b, obs, ci, mkf))(x0["points"])
        import os
        os.environ["TINYOPT_WINDOW_REDUCE"] = "1"
        try:
            plan = plan_window_reduce(np.asarray(ci), 24, 4, CH)
        finally:
            del os.environ["TINYOPT_WINDOW_REDUCE"]
        assert plan is not None
        rp_w = make_reduce_pass_window(24, 4, 6, 3, jnp.float64, CH,
                                       plan)
        rp_s = make_reduce_pass(24, 4, 6, 3, jnp.float64, CH)
        S_w, rhs_w, Ci_w = jax.jit(
            lambda: rp_w(E_f, C_f, ci, g_b))()
        S_s, rhs_s, Ci_s = jax.jit(
            lambda: rp_s(E_f, C_f, ci, g_b))()
        np.testing.assert_allclose(np.asarray(S_w), np.asarray(S_s),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(rhs_w), np.asarray(rhs_s),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(Ci_w), np.asarray(Ci_s),
                                   rtol=1e-9, atol=1e-12)

    def test_band_storage_matches_dense(self, monkeypatch):
        """With the window reduce forced on, the banded path reduces
        straight into BAND storage (the (n_a, n_a) S grid never
        exists); trajectory must equal the dense-assembled path."""
        monkeypatch.setenv("TINYOPT_WINDOW_REDUCE", "1")
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=60, n_pts=600, k_obs=6, noise=1e-4, seed=3)

        def pf(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        xt = (x0["poses"], x0["points"])
        outs = []
        for banded in ("auto", "off"):
            o = to.Options(max_iters=8, max_consec_failures=0,
                           hessian=to.HessianOptions(
                               save_last=False, schur_banded=banded,
                               schur_refine=2))
            outs.append(to.schur_sparse_optimize(xt, pf, obs, ci, mk,
                                                 o))
        (xa, oa), (xd, od) = outs
        assert int(oa.num_iters) == int(od.num_iters)
        np.testing.assert_allclose(np.asarray(xa[1]), np.asarray(xd[1]),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(xa[0].translation),
                                   np.asarray(xd[0].translation),
                                   rtol=1e-7, atol=1e-9)
        assert bool(oa.succeeded())

    def test_band_storage_through_buckets(self, monkeypatch):
        """Bucketed entry with band storage (heavy-tail corridor,
        window forced): == the same solve with banded off."""
        monkeypatch.setenv("TINYOPT_WINDOW_REDUCE", "1")
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        from tinyopt_tpu.ops.schur_obs import bucket_obs
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=60, n_pts=400, k_obs=6, noise=1e-4, seed=8)
        m = np.array(mk)
        m[:300, 3:] = 0.0                 # heavy tail -> >= 2 buckets
        ci = jnp.asarray(np.where(m > 0, np.asarray(ci), 0))
        mk = jnp.asarray(m)

        def pf(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        slabs = bucket_obs(obs, ci, mk, min_bucket=8)
        assert len(slabs) >= 2
        xt = (x0["poses"], x0["points"])
        outs = []
        for banded in ("auto", "off"):
            o = to.Options(max_iters=8, max_consec_failures=0,
                           hessian=to.HessianOptions(
                               save_last=False, schur_banded=banded))
            outs.append(to.schur_sparse_optimize_buckets(xt, pf, slabs,
                                                         o))
        (xa, oa), (xd, od) = outs
        assert int(oa.num_iters) == int(od.num_iters)
        np.testing.assert_allclose(np.asarray(xa[1]), np.asarray(xd[1]),
                                   rtol=1e-7, atol=1e-9)
        assert bool(oa.succeeded())

    def test_masked_slot_cam0_contract(self, monkeypatch):
        """Masked slots carry cam_idx 0 per the public contract; their
        spurious (0, c) pairs must neither crash the banded planner nor
        corrupt the reduction (window forced; parity vs banded off)."""
        monkeypatch.setenv("TINYOPT_WINDOW_REDUCE", "1")
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=60, n_pts=400, k_obs=4, noise=1e-4, seed=4)
        m = np.array(mk)
        rng = np.random.default_rng(0)
        m[rng.random(m.shape) < 0.25] = 0.0
        m[:, 0] = 1.0
        # the CONTRACT: masked slots carry camera 0
        ci = jnp.asarray(np.where(m > 0, np.asarray(ci), 0))
        mk = jnp.asarray(m)

        def pf(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        xt = (x0["poses"], x0["points"])
        outs = []
        for banded in ("auto", "off"):
            o = to.Options(max_iters=6, max_consec_failures=0,
                           hessian=to.HessianOptions(
                               save_last=False, schur_banded=banded))
            outs.append(to.schur_sparse_optimize(xt, pf, obs, ci, mk,
                                                 o))
        (xa, oa), (xd, od) = outs
        assert int(oa.num_iters) == int(od.num_iters)
        np.testing.assert_allclose(np.asarray(xa[1]), np.asarray(xd[1]),
                                   rtol=1e-7, atol=1e-9)
        assert bool(oa.succeeded())
