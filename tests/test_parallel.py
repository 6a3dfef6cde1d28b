"""Scale-out layer tests on the 8-virtual-device CPU mesh.

SURVEY.md §4: the reference offers no multi-device pattern to mirror — the
mesh/psum layer is a new capability validated with
``xla_force_host_platform_device_count`` simulation (conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import tinyopt_tpu as to
from tinyopt_tpu.parallel import (batched_optimize, local_mesh, make_mesh,
                                  masked_residuals, pad_instances,
                                  sharded_optimize)


class TestMesh:
    def test_make_mesh_2d(self):
        mesh = make_mesh(batch=4, block=2)
        assert mesh.shape == {"batch": 4, "block": 2}

    def test_local_mesh(self):
        mesh = local_mesh("x")
        assert mesh.shape["x"] == len(jax.devices())

    def test_bad_factorization_raises(self):
        with pytest.raises(ValueError):
            make_mesh(batch=3, block=3)


class TestBatchedSharded:
    def test_batched_optimize_on_mesh(self):
        """Instances sharded over all 8 devices solve identically to
        unsharded."""
        mesh = local_mesh("batch")
        B = 16
        targets = jnp.linspace(1.0, 2.0, B)[:, None]
        x0 = jnp.zeros((B, 1))
        x, out = batched_optimize(
            x0, lambda x, t: x - t, data_batch=targets, mesh=mesh)
        np.testing.assert_allclose(np.asarray(x), np.asarray(targets),
                                   atol=1e-8)
        assert bool(jnp.all(out.converged()))

    def test_sharded_block_psum_matches_dense(self):
        """psum-reduced block accumulation == single-device dense solve."""
        mesh = local_mesh("block")
        nblocks, m = 16, 4
        rng = np.random.default_rng(0)
        obs = jnp.asarray(rng.uniform(-1, 1, (nblocks, m, 3)))

        def block_fn(x, block_obs):
            return (block_obs - x[None, :]).reshape(-1)

        x_sh, out_sh = sharded_optimize(jnp.zeros(3), block_fn, obs,
                                        to.Options(), mesh=mesh,
                                        axis="block")
        # Dense single-program equivalent
        x_d, out_d = to.optimize(jnp.zeros(3),
                                 lambda x: (obs - x[None, None, :]).reshape(-1))
        np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_d),
                                   atol=1e-8)
        assert float(out_sh.final_cost.cost) == pytest.approx(
            float(out_d.final_cost.cost), rel=1e-6)
        # The mean is the optimum
        np.testing.assert_allclose(np.asarray(x_sh),
                                   np.asarray(obs.reshape(-1, 3).mean(0)),
                                   atol=1e-6)


class TestPadding:
    def test_pad_instances_shapes_and_mask(self):
        data = [{"obs": jnp.ones((n, 2))} for n in (3, 5, 2)]
        stacked, mask = pad_instances(data)
        assert stacked["obs"].shape == (3, 5, 2)
        np.testing.assert_array_equal(
            np.asarray(mask),
            [[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 1, 0, 0, 0]])

    def test_heterogeneous_batch_solves_correctly(self):
        """Circle-style fits with different observation counts: padded
        rows contribute zero residual AND zero Jacobian."""
        rng = np.random.default_rng(3)
        counts = [6, 9, 4, 11]
        targets = [jnp.asarray(rng.uniform(-1, 1, 2)) for _ in counts]
        data = [{"obs": t[None, :].repeat(n, 0)
                 + 0.0 * jnp.asarray(rng.normal(size=(n, 2)))}
                for t, n in zip(targets, counts)]
        stacked, mask = pad_instances(data)

        def fn(x, inst):
            obs, m = inst
            return masked_residuals(obs - x[None, :], m).reshape(-1)

        x0 = jnp.zeros((len(counts), 2))
        x, out = batched_optimize(x0, fn,
                                  data_batch=(stacked["obs"], mask))
        for i, t in enumerate(targets):
            np.testing.assert_allclose(np.asarray(x[i]), np.asarray(t),
                                       atol=1e-6)

    def test_padding_does_not_bias_cost(self):
        """Padded instance's final cost equals its unpadded solve's cost."""
        obs_small = jnp.asarray([[1.0, 2.0], [1.2, 1.8], [0.8, 2.2]])
        x_ref, out_ref = to.optimize(
            jnp.zeros(2), lambda x: (obs_small - x[None, :]).reshape(-1))

        data, mask = pad_instances([{"o": obs_small},
                                    {"o": jnp.ones((7, 2))}])

        def fn(x, inst):
            o, m = inst
            return masked_residuals(o - x[None, :], m).reshape(-1)

        x, out = batched_optimize(jnp.zeros((2, 2)), fn,
                                  data_batch=(data["o"], mask))
        assert float(out.final_cost.cost[0]) == pytest.approx(
            float(out_ref.final_cost.cost), abs=1e-10)
        np.testing.assert_allclose(np.asarray(x[0]), np.asarray(x_ref),
                                   atol=1e-8)


class TestShardedSchur:
    """Landmark-sharded Schur BA (parallel/schur.py) vs the single-device
    schur_optimize: same trajectory up to psum summation order."""

    def _problem(self, n_a=5, n_b=16, seed=7):
        def pair_fn(a_i, b_j, d_ij):
            return jnp.stack([a_i[0] + b_j[0] - d_ij,
                              0.3 * a_i[0], 0.3 * b_j[0]])
        rng = np.random.default_rng(seed)
        d = jnp.asarray(rng.normal(size=(n_a, n_b)))
        mask = jnp.asarray((rng.uniform(size=(n_a, n_b)) > 0.3)
                           .astype(float))
        x0 = (jnp.zeros((n_a, 1)), jnp.zeros((n_b, 1)))
        return pair_fn, d, mask, x0

    @pytest.mark.parametrize("solver", [to.LevenbergMarquardt, to.DogLeg,
                                        to.GaussNewton])
    def test_matches_unsharded(self, solver):
        from tinyopt_tpu.parallel import sharded_schur_optimize
        pair_fn, d, mask, x0 = self._problem()
        o = to.Options(max_iters=15, solver_type=solver,
                       max_consec_failures=0)
        x_ref, out_ref = to.schur_optimize(x0, pair_fn, d, mask, o)
        mesh = local_mesh("block")
        x_sh, out_sh = sharded_schur_optimize(x0, pair_fn, d, mask, o,
                                              mesh=mesh)
        np.testing.assert_allclose(np.asarray(x_sh[0]), np.asarray(x_ref[0]),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(x_sh[1]), np.asarray(x_ref[1]),
                                   rtol=1e-9, atol=1e-11)
        assert int(out_sh.num_iters) == int(out_ref.num_iters)
        assert int(out_sh.stop_reason) == int(out_ref.stop_reason)
        assert float(out_sh.final_cost.cost) == pytest.approx(
            float(out_ref.final_cost.cost), rel=1e-9, abs=1e-12)
        assert int(out_sh.final_cost.num_residuals) == int(
            out_ref.final_cost.num_residuals)

    def test_mask_padding_matches_smaller_problem(self):
        """The documented scaling contract: pad the landmark axis with
        mask=0 columns to reach divisibility — padded columns change
        nothing (zero residual AND zero Jacobian)."""
        from tinyopt_tpu.parallel import sharded_schur_optimize
        pair_fn, d, mask, x0 = self._problem(n_b=16)
        # solve a 13-landmark problem by masking the last 3 columns
        mask13 = mask.at[:, 13:].set(0.0)
        o = to.Options(max_iters=15)
        x_ref, out_ref = to.schur_optimize(
            (x0[0], x0[1][:13]), pair_fn, d[:, :13], mask13[:, :13], o)
        mesh = local_mesh("block")
        x_sh, out_sh = sharded_schur_optimize(x0, pair_fn, d, mask13, o,
                                              mesh=mesh)
        np.testing.assert_allclose(np.asarray(x_sh[0]),
                                   np.asarray(x_ref[0]),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(x_sh[1][:13]),
                                   np.asarray(x_ref[1]),
                                   rtol=1e-9, atol=1e-11)
        assert int(out_sh.final_cost.num_residuals) == int(
            out_ref.final_cost.num_residuals)

    def test_indivisible_landmarks_raise(self):
        from tinyopt_tpu.parallel import sharded_schur_optimize
        pair_fn, d, mask, x0 = self._problem(n_b=15)
        with pytest.raises(ValueError, match="divisible"):
            sharded_schur_optimize(x0, pair_fn, d, mask,
                                   to.Options(), mesh=local_mesh("block"))

    def test_se3_ba_matches_unsharded(self):
        """The real BA shape: SE(3) cameras x 3-d landmarks."""
        from tinyopt_tpu.models.bundle_adjustment import (make_ba_problem,
                                                          project)
        from tinyopt_tpu.parallel import sharded_schur_optimize

        data, x0, _ = make_ba_problem(n_cams=4, n_pts=16, noise=1e-4,
                                      seed=5, dtype=jnp.float64)

        def pair_fn(pose, point, obs):
            return project(pose, point[None, :])[0] - obs

        o = to.Options(max_iters=8, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False))
        xt = (x0["poses"], x0["points"])
        x_ref, out_ref = to.schur_optimize(xt, pair_fn, data.observations,
                                           data.mask, o)
        x_sh, out_sh = sharded_schur_optimize(
            xt, pair_fn, data.observations, data.mask, o,
            mesh=local_mesh("block"))
        np.testing.assert_allclose(
            np.asarray(x_sh[1]), np.asarray(x_ref[1]), rtol=1e-7, atol=1e-9)
        assert int(out_sh.num_iters) == int(out_ref.num_iters)
        assert float(out_sh.final_cost.cost) == pytest.approx(
            float(out_ref.final_cost.cost), rel=1e-8)


class TestShardedSchurObs:
    """Landmark-sharded sparse-observation Schur (parallel/schur_obs.py)
    vs single-device schur_sparse_optimize: the same slab kernels
    (ops/schur_obs.make_obs_kernels) composed over the mesh, so the
    trajectory must match up to psum summation order (f64: exact)."""

    def _problem(self, n_a=5, n_b=16, seed=7):
        from tinyopt_tpu.ops.schur_obs import grid_to_obs

        def pair_fn(a_i, b_j, d_ij):
            return jnp.stack([a_i[0] + b_j[0] - d_ij,
                              0.3 * a_i[0], 0.3 * b_j[0]])
        rng = np.random.default_rng(seed)
        d = jnp.asarray(rng.normal(size=(n_a, n_b)))
        mask = jnp.asarray((rng.uniform(size=(n_a, n_b)) > 0.3)
                           .astype(float))
        obs, cam_idx, smask = grid_to_obs(d, mask)
        x0 = (jnp.zeros((n_a, 1)), jnp.zeros((n_b, 1)))
        return pair_fn, obs, cam_idx, smask, x0

    def test_sharded_sort_routes_and_matches(self, monkeypatch):
        """Natural order defeats the window plan at this shape; the
        sharded entry must route through the sorted single-slab bucket
        path and reproduce the natural-order trajectory (f64)."""
        monkeypatch.setenv("TINYOPT_WINDOW_REDUCE", "1")
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        from tinyopt_tpu.ops.schur_obs import camera_sort_perm
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=400, n_pts=8192, k_obs=8, noise=1e-4, seed=2)
        assert camera_sort_perm(np.asarray(ci), np.asarray(mk), 400, 8,
                                512) is not None

        def pfs(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        xt = (x0["poses"], x0["points"])
        outs = []
        for hs in ("auto", "off"):
            o = to.Options(max_iters=2, max_consec_failures=0,
                           hessian=to.HessianOptions(save_last=False,
                                                     schur_sort=hs))
            outs.append(sharded_schur_sparse_optimize(
                xt, pfs, obs, ci, mk, o, mesh=local_mesh("block")))
        (xa, oa), (xn, on) = outs
        assert int(oa.num_iters) == int(on.num_iters)
        np.testing.assert_allclose(np.asarray(xa[1]), np.asarray(xn[1]),
                                   rtol=1e-7, atol=1e-9)

    def test_band_storage_sharded_matches(self, monkeypatch):
        """Corridor rig + window forced: the sharded eliminate reduces
        into per-device BAND partials, psums the band, and solves by CR
        from band storage — f64 trajectory == single-device."""
        monkeypatch.setenv("TINYOPT_WINDOW_REDUCE", "1")
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=60, n_pts=64, k_obs=4, noise=1e-4, seed=6)

        def pfb(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        # the band machinery must actually plan for this rig
        from tinyopt_tpu.ops.schur_obs import (
            _pick_chunk, detect_camera_bandwidth,
            plan_window_reduce_banded_multi)
        bw = detect_camera_bandwidth(np.asarray(ci), np.asarray(mk))
        cam_np = np.asarray(ci)
        slabs = [cam_np[d * 8:(d + 1) * 8] for d in range(8)]
        assert plan_window_reduce_banded_multi(
            slabs, 60, 4, _pick_chunk(8, 1024), bw) is not None

        xt = (x0["poses"], x0["points"])
        o = to.Options(max_iters=8, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False,
                                                 schur_refine=1))
        x_ref, out_ref = to.schur_sparse_optimize(xt, pfb, obs, ci,
                                                  mk, o)
        x_sh, out_sh = sharded_schur_sparse_optimize(
            xt, pfb, obs, ci, mk, o, mesh=local_mesh("block"))
        assert int(out_sh.num_iters) == int(out_ref.num_iters)
        assert int(out_sh.stop_reason) == int(out_ref.stop_reason)
        np.testing.assert_allclose(np.asarray(x_sh[1]),
                                   np.asarray(x_ref[1]),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(x_sh[0].translation),
            np.asarray(x_ref[0].translation), rtol=1e-7, atol=1e-9)

    def test_windowed_sharded_reduce_matches(self, monkeypatch):
        """With the window reduce forced on, the sharded eliminate
        uses per-device window tables + onehot matmul sums; the f64
        trajectory must still equal the single-device solve."""
        monkeypatch.setenv("TINYOPT_WINDOW_REDUCE", "1")
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize

        # fresh fn object: the solve cache must not serve the planned-
        # path program built by the other tests
        def pair_fn2(a_i, b_j, d_ij):
            return jnp.stack([a_i[0] + b_j[0] - d_ij,
                              0.3 * a_i[0], 0.3 * b_j[0]])

        _, obs, cam_idx, smask, x0 = self._problem()
        o = to.Options(max_iters=15, max_consec_failures=0)
        x_ref, out_ref = to.schur_sparse_optimize(x0, pair_fn2, obs,
                                                  cam_idx, smask, o)
        x_sh, out_sh = sharded_schur_sparse_optimize(
            x0, pair_fn2, obs, cam_idx, smask, o,
            mesh=local_mesh("block"))
        np.testing.assert_allclose(np.asarray(x_sh[1]),
                                   np.asarray(x_ref[1]),
                                   rtol=1e-9, atol=1e-11)
        assert int(out_sh.num_iters) == int(out_ref.num_iters)
        assert int(out_sh.stop_reason) == int(out_ref.stop_reason)

    @pytest.mark.parametrize("solver", [to.LevenbergMarquardt, to.DogLeg,
                                        to.GaussNewton])
    def test_matches_unsharded(self, solver):
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize
        pair_fn, obs, cam_idx, smask, x0 = self._problem()
        o = to.Options(max_iters=15, solver_type=solver,
                       max_consec_failures=0)
        x_ref, out_ref = to.schur_sparse_optimize(x0, pair_fn, obs,
                                                  cam_idx, smask, o)
        x_sh, out_sh = sharded_schur_sparse_optimize(
            x0, pair_fn, obs, cam_idx, smask, o, mesh=local_mesh("block"))
        np.testing.assert_allclose(np.asarray(x_sh[0]),
                                   np.asarray(x_ref[0]),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(x_sh[1]),
                                   np.asarray(x_ref[1]),
                                   rtol=1e-9, atol=1e-11)
        assert int(out_sh.num_iters) == int(out_ref.num_iters)
        assert int(out_sh.stop_reason) == int(out_ref.stop_reason)
        assert float(out_sh.final_cost.cost) == pytest.approx(
            float(out_ref.final_cost.cost), rel=1e-9, abs=1e-12)
        assert int(out_sh.final_cost.num_residuals) == int(
            out_ref.final_cost.num_residuals)

    def test_scatter_fallback_matches_planned(self, monkeypatch):
        """The sharded path's planned gather reduce (addressable cams)
        and its scatter fallback (multi-process / over-budget) must be
        the same algebra: force the fallback via a zero staging budget
        and compare solves."""
        import tinyopt_tpu.parallel.schur_obs as pso
        pair_fn, obs, cam_idx, smask, x0 = self._problem(seed=9)
        o = to.Options(max_iters=10, max_consec_failures=0)
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize
        x_pl, out_pl = sharded_schur_sparse_optimize(
            x0, pair_fn, obs, cam_idx, smask, o,
            mesh=local_mesh("block"))
        monkeypatch.setattr(pso, "_PLANNED_STAGING_LIMIT", 0)
        o2 = to.Options(max_iters=10, max_consec_failures=0,
                        save_history=False)   # distinct cache key
        x_sc, out_sc = sharded_schur_sparse_optimize(
            x0, pair_fn, obs, cam_idx, smask, o2,
            mesh=local_mesh("block"))
        np.testing.assert_allclose(np.asarray(x_sc[1]),
                                   np.asarray(x_pl[1]),
                                   rtol=1e-9, atol=1e-11)
        assert int(out_sc.num_iters) == int(out_pl.num_iters)

    def test_se3_corridor_matches_unsharded(self):
        """Real manifold BA (SE3 poses + R³ landmarks) on the corridor
        rig: sharded == single-device, f64."""
        from tinyopt_tpu.models.bundle_adjustment import (
            make_ba_problem_sparse, project)
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize

        def pair_fn(pose, point, obs):
            return project(pose, point[None, :])[0] - obs

        (obs, cam_idx, mask), x0, _ = make_ba_problem_sparse(
            n_cams=10, n_pts=48, k_obs=4, noise=1e-4, seed=3)
        xt = (x0["poses"], x0["points"])
        o = to.Options(max_iters=10, max_consec_failures=0,
                       hessian=to.HessianOptions(save_last=False))
        x_ref, out_ref = to.schur_sparse_optimize(xt, pair_fn, obs,
                                                  cam_idx, mask, o)
        x_sh, out_sh = sharded_schur_sparse_optimize(
            xt, pair_fn, obs, cam_idx, mask, o, mesh=local_mesh("block"))
        np.testing.assert_allclose(np.asarray(x_sh[1]),
                                   np.asarray(x_ref[1]),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(x_sh[0].translation),
                                   np.asarray(x_ref[0].translation),
                                   rtol=1e-7, atol=1e-9)
        assert int(out_sh.num_iters) == int(out_ref.num_iters)
        assert int(out_sh.stop_reason) == int(out_ref.stop_reason)

    def test_mask_padding_matches_smaller_problem(self):
        """The documented scaling contract: pad the landmark axis with
        mask=0 points (cam_idx 0, zero obs) to reach divisibility —
        padded points change nothing and stay at their initial value."""
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize
        pair_fn, obs, cam_idx, smask, x0 = self._problem(n_b=13)
        o = to.Options(max_iters=15, max_consec_failures=0)
        x_ref, out_ref = to.schur_sparse_optimize(x0, pair_fn, obs,
                                                  cam_idx, smask, o)
        pad = 3   # 13 -> 16, divisible by 8
        obs_p = jnp.concatenate([obs, jnp.zeros((pad,) + obs.shape[1:],
                                                obs.dtype)])
        cam_p = jnp.concatenate(
            [cam_idx, jnp.zeros((pad, cam_idx.shape[1]), cam_idx.dtype)])
        mask_p = jnp.concatenate(
            [smask, jnp.zeros((pad, smask.shape[1]), smask.dtype)])
        x0_p = (x0[0], jnp.concatenate(
            [x0[1], jnp.full((pad, 1), 0.7)]))
        x_sh, out_sh = sharded_schur_sparse_optimize(
            x0_p, pair_fn, obs_p, cam_p, mask_p, o,
            mesh=local_mesh("block"))
        np.testing.assert_allclose(np.asarray(x_sh[0]),
                                   np.asarray(x_ref[0]),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(x_sh[1][:13]),
                                   np.asarray(x_ref[1]),
                                   rtol=1e-9, atol=1e-11)
        # padded landmarks: zero gradient, zero step — stay at x0
        np.testing.assert_array_equal(np.asarray(x_sh[1][13:]),
                                      np.full((3, 1), 0.7))
        assert int(out_sh.final_cost.num_residuals) == int(
            out_ref.final_cost.num_residuals)

    def test_refine_flows_through_sharded_propose(self):
        """hessian.schur_refine reaches the sharded eliminate: refine=2
        runs under shard_map and refine=0 matches the single-device
        trajectory bit-compatibly (f64)."""
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize
        pair_fn, obs, cam_idx, smask, x0 = self._problem()
        o2 = to.Options(max_iters=15, max_consec_failures=0,
                        hessian=to.HessianOptions(schur_refine=2))
        x_sh, out_sh = sharded_schur_sparse_optimize(
            x0, pair_fn, obs, cam_idx, smask, o2,
            mesh=local_mesh("block"))
        assert bool(out_sh.succeeded()), int(out_sh.stop_reason)
        x_ref, out_ref = to.schur_sparse_optimize(x0, pair_fn, obs,
                                                  cam_idx, smask, o2)
        np.testing.assert_allclose(np.asarray(x_sh[1]),
                                   np.asarray(x_ref[1]),
                                   rtol=1e-9, atol=1e-11)
        assert int(out_sh.num_iters) == int(out_ref.num_iters)

    def test_indivisible_landmarks_raise(self):
        from tinyopt_tpu.parallel import sharded_schur_sparse_optimize
        pair_fn, obs, cam_idx, smask, x0 = self._problem(n_b=15)
        with pytest.raises(ValueError, match="divisible"):
            sharded_schur_sparse_optimize(x0, pair_fn, obs, cam_idx,
                                          smask, mesh=local_mesh("block"))
