"""Full benchmark sweep, mirroring the reference suite.

Reference: benchmarks/dense.cpp (sqrt2 float/double; fixed Vec3/6/12 and
dynamic VecX {3,6,12,33,50} whitened-prior fits), benchmarks/sparse.cpp
(diag problem {10,100,1000}), run under Catch2 with the analysis script
producing a per-problem table (benchmarks/scripts/analysis.py).

Ours reports three regimes per problem:
  * native   — the C++ micro-runtime on the host CPU, µs per single solve
               (the reference's own regime; timed inside the shared
               library)
  * dev-1    — one solve on the accelerator (dominated by dispatch; shown
               for honesty)
  * dev-10k  — 10,000 concurrent instances on the accelerator, µs per
               solve

Usage: python benchmarks/run_benchmarks.py [--batch 10000] [--dtype float32]

``--dtype`` sets the dtype of the large-problem benchmarks (BA, pose
graph, robust BAL); f32 by default.  Scaling-efficiency axes live in a
separate script — it must control the device count before jax
initializes: ``python benchmarks/exp_scaling.py`` (CPU virtual mesh).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


REFERENCE_US = {  # BASELINE.md (tinyopt, 1-thread CPU, max 10 LM iters)
    "sqrt2": 0.79,
    "prior3": 1.49, "prior6": 2.47, "prior12": 5.15,
    "prior33": 25.68, "prior50": 56.26,
}

# Float rows: the reference publishes only sqrt2-float (0.91 µs,
# BASELINE.md row 0; docs/benchmark-ceres-table.png); its float prior
# suite exists but has no published numbers (densef.cpp:24-50) — our f32
# prior rows are reported without a "vs ref" column.
REFERENCE_US_F32 = {"sqrt2f": 0.91}


def _native_ref_options():
    """The reference benchmark options (benchmarks/options.h:10-27) —
    the configuration REFERENCE_US was measured with, and the same one
    bench_device uses, so all columns are apples-to-apples."""
    from tinyopt_tpu import native
    return native.make_options(
        "lm", max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
        min_step_norm2=1e-16, max_consec_failures=3)


def bench_native(dims_list):
    from tinyopt_tpu import native
    opts = _native_ref_options()
    rows = {}
    rows["sqrt2"] = native.bench_sqrt2_us(1.0, reps=100_000, options=opts)
    rng = np.random.default_rng(1)
    for d in dims_list:
        y = rng.uniform(-1, 1, d)
        std = rng.uniform(0.1, 1.1, d)
        x0 = rng.uniform(-1, 1, d)
        us, x = native.bench_prior_us(y, 1.0 / std, x0, reps=20_000,
                                      options=opts)
        assert np.allclose(x, y, atol=1e-5)
        rows[f"prior{d}"] = us
    return rows


def bench_native_f32(dims_list):
    """f32 native rows (reference float suite densef.cpp:24-50; only
    sqrt2-float has a published number, 0.91 µs)."""
    from tinyopt_tpu import native
    opts = native.make_options(
        "lm", dtype=np.float32, max_iters=10, min_error=0.0,
        min_rerr_dec=1e-9, min_step_norm2=1e-10, max_consec_failures=3)
    rows = {}
    rows["sqrt2f"] = native.bench_sqrt2_us_f32(1.0, reps=100_000,
                                               options=opts)
    rng = np.random.default_rng(1)
    for d in dims_list:
        y = rng.uniform(-1, 1, d)
        std = rng.uniform(0.1, 1.1, d)
        x0 = rng.uniform(-1, 1, d)
        us, x = native.bench_prior_us_f32(y, 1.0 / std, x0, reps=20_000,
                                          options=opts)
        assert np.allclose(x, y.astype(np.float32), atol=1e-3)
        rows[f"prior{d}f"] = us
    return rows


def bench_device(dims_list, batch, single: bool = False):
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.problems import make_prior_batch, prior_residual
    from tinyopt_tpu.parallel.batched import batched_solver

    opts = to.Options(max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
                      min_step_norm2=1e-16, max_consec_failures=3,
                      hessian=to.HessianOptions(save_last=False, solver="cg",
                                                cg_iters=8,
                                                carry_system=False))
    rows1, rowsN = {}, {}

    def _time_batched(solve, x0, data):
        jax.block_until_ready(solve(x0, data))
        prng = np.random.default_rng(time.time_ns())
        ts = []
        for _ in range(3):
            x0i = x0 + jnp.asarray(
                prng.uniform(1e-7, 1e-6, x0.shape), x0.dtype)
            float(x0i.sum())
            t0 = time.perf_counter()
            _, out_i = solve(x0i, data)
            float(out_i.final_cost.cost.sum())
            ts.append(time.perf_counter() - t0)
        return min(ts) / batch * 1e6

    for d in dims_list:
        data, x0 = make_prior_batch(batch, d, dtype=jnp.float32, seed=1)
        x_ex = jax.tree_util.tree_map(lambda a: a[0], x0)
        d_ex = jax.tree_util.tree_map(lambda a: a[0], data)
        prng = np.random.default_rng(time.time_ns())
        solve_n = jax.jit(batched_solver(prior_residual, opts, "residuals",
                                         x_ex, d_ex))
        rowsN[f"prior{d}"] = _time_batched(solve_n, x0, data)

        if single:
            solve_1 = jax.jit(to.build_solver(
                lambda x: prior_residual(x, d_ex), opts, "residuals", x_ex))
            r1 = solve_1(x_ex)
            float(r1[1].final_cost.cost)
            ts = []
            for _ in range(10):
                x1i = x_ex + jnp.asarray(
                    prng.uniform(1e-7, 1e-6, x_ex.shape), x_ex.dtype)
                float(x1i.sum())
                t0 = time.perf_counter()
                _, o1 = solve_1(x1i)
                float(o1.final_cost.cost)
                ts.append(time.perf_counter() - t0)
            rows1[f"prior{d}"] = min(ts) * 1e6
    return rows1, rowsN


def bench_sparse(batch: int, dims_list=(10, 100, 1000)):
    """Reference benchmarks/sparse.cpp:23-61: r = 10x − 2 with a sparse
    (diagonal) Hessian, dims {10,100,1000}.  The reference has no published
    numbers for these rows (BASELINE.md); ours are µs per solve, batched.

    Two formulations of the same problem:
      * block    — `block_optimize` structure (bs=1 blocks), vmapped over
                   `batch` instances
      * coo      — `sparse_optimize` general-sparse path (auto-detected
                   diagonal COO pattern + Jacobi-PCG), vmapped likewise
    """
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu import manifold as mf
    from tinyopt_tpu.optimizers.loop import optimize_from_acc
    from tinyopt_tpu.ops.coloring import probe_structure
    from tinyopt_tpu.sparse import block_nlls_system, sparse_system

    opts = to.Options(max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
                      min_step_norm2=1e-16, max_consec_failures=3,
                      save_history=False,
                      hessian=to.HessianOptions(save_last=False,
                                                carry_system=False))

    def _time(solve, x0):
        jax.block_until_ready(solve(x0))
        prng = np.random.default_rng(time.time_ns())
        ts = []
        for _ in range(3):
            x0i = x0 + jnp.asarray(prng.uniform(1e-7, 1e-6, x0.shape),
                                   x0.dtype)
            float(x0i.sum())
            t0 = time.perf_counter()
            _, out_i = solve(x0i)
            float(out_i.final_cost.cost.sum())
            ts.append(time.perf_counter() - t0)
        return min(ts) / batch * 1e6

    rows_blk, rows_coo = {}, {}
    prng = np.random.default_rng(5)
    for d in dims_list:
        x0b = jnp.asarray(prng.uniform(-1, 1, (batch, d, 1)), jnp.float32)
        blk_fn = lambda xb: 10.0 * xb - 2.0
        x_ex = x0b[0]
        spec_b = mf.tangent_spec(x_ex)
        acc_b, ev_b, _ = block_nlls_system(blk_fn, x_ex)
        solve_b = jax.jit(jax.vmap(
            lambda x: optimize_from_acc(x, acc_b, ev_b, opts, spec_b)))
        rows_blk[f"sparse{d}"] = _time(solve_b, x0b)

        res_fn = lambda x: 10.0 * x - 2.0
        x_ex2 = x0b[0, :, 0]
        spec_s = mf.tangent_spec(x_ex2)
        structure = probe_structure(res_fn, x_ex2, None, spec_s, d, d)
        acc_s, ev_s, _ = sparse_system(res_fn, x_ex2, spec_s, structure)
        cg_opts = opts.replace(hessian=to.HessianOptions(
            save_last=False, carry_system=False, cg_iters=8))
        solve_s = jax.jit(jax.vmap(
            lambda x: optimize_from_acc(x, acc_s, ev_s, cg_opts, spec_s)))
        rows_coo[f"sparse{d}"] = _time(solve_s, x0b[:, :, 0])
    return rows_blk, rows_coo


def bench_se3(batch: int):
    """Flagship model: batched SE(3) pose refinement solves/s."""
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.se3_refinement import (make_se3_refinement,
                                                   se3_residual)
    from tinyopt_tpu.parallel.batched import batched_solver

    data, x0, _ = make_se3_refinement(batch, n_points=16, dtype=jnp.float32,
                                      seed=3)
    opts = to.Options(max_iters=10, max_consec_failures=3,
                      hessian=to.HessianOptions(save_last=False,
                                                carry_system=False))
    x_ex = jax.tree_util.tree_map(lambda a: a[0], x0)
    d_ex = jax.tree_util.tree_map(lambda a: a[0], data)
    solve = jax.jit(batched_solver(se3_residual, opts, "residuals",
                                   x_ex, d_ex))
    _, out = solve(x0, data)
    conv = float(jnp.mean(out.converged()))
    prng = np.random.default_rng(time.time_ns())
    ts = []
    for _ in range(3):
        w = jnp.asarray(prng.uniform(1e-7, 1e-6, (batch, 6)), jnp.float32)
        from tinyopt_tpu.manifolds import SE3
        x0i = jax.vmap(lambda p, d: SE3(p.rotation, p.translation + d[:3]))(
            x0, w)
        float(x0i.translation.sum())
        t0 = time.perf_counter()
        _, out_i = solve(x0i, data)
        float(out_i.final_cost.cost.sum())
        ts.append(time.perf_counter() - t0)
    return batch / min(ts), conv


def bench_ba(n_cams: int = 100, n_pts: int = 5000, noise: float = 1e-3,
             seed: int = 11, max_iters: int = 12, dtype="float32"):
    """Large-scale BA (VERDICT r1 #9: the regime the reference concedes,
    README.md:30): fixed seed/criteria, two backends.

      * matfree — GN-CG, J/H never materialized (the r1 narrative result)
      * schur   — Schur-complement camera elimination (ops/schur.py)

    Success criterion: reprojection RMSE <= 1.2x the observation noise.
    Returns {backend: (wall_s, rmse, converged)}.
    """
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.bundle_adjustment import (
        make_ba_problem, ba_residuals, project, reprojection_rmse)

    dtype = jnp.dtype(dtype)
    data, x0, _ = make_ba_problem(n_cams=n_cams, n_pts=n_pts, noise=noise,
                                  seed=seed, dtype=dtype)
    opts = to.Options(max_iters=max_iters, max_consec_failures=0,
                      min_error=0.0,
                      hessian=to.HessianOptions(save_last=False))
    if dtype == jnp.float32:
        opts = opts.for_dtype(dtype)
    rows = {}

    # The entry points cache the compiled solve across calls (sparse.
    # _SOLVE_CACHE; the residual fns below are therefore hoisted out of
    # the run closures), so the timed second call measures EXECUTION
    # wall only.  The warm call starts from perturbed points.
    def _perturb(x):
        return dict(x, points=x["points"] + jnp.asarray(1e-3, dtype))

    def _timed(run):
        x, out = run(_perturb(x0))         # trace + compile + warm
        jax.block_until_ready(jax.tree_util.tree_leaves(x))
        t0 = time.perf_counter()
        x, out = run(x0)
        rmse = float(reprojection_rmse(
            {"poses": x[0], "points": x[1]} if isinstance(x, tuple) else x,
            data))                          # forced read = completion
        wall = time.perf_counter() - t0
        return wall, rmse, rmse <= 1.2 * max(noise, 1e-9)

    res_fn = lambda p: ba_residuals(p, data)

    def run_matfree(xx):
        return to.matfree_optimize(xx, res_fn, opts, cg_iters=48)

    def pair_fn(pose, point, obs):
        return project(pose, point[None, :])[0] - obs

    def run_schur(xx):
        return to.schur_optimize((xx["poses"], xx["points"]), pair_fn,
                                 data.observations, data.mask, opts)

    rows["matfree"] = _timed(run_matfree)
    rows["schur"] = _timed(run_schur)
    return rows


def bench_ba_sparse(n_cams: int = 1000, n_pts: int = 50_000,
                    k_obs: int = 8, noise: float = 1e-3, seed: int = 7,
                    max_iters: int = 12, schur_cg: int = 0,
                    dtype="float32"):
    """Sparse-visibility BA at a scale the dense grid CANNOT represent:
    1000 cameras x 50k landmarks = 156,000 tangent dims, 400k
    observations (a dense grid would need a 50M-slot E tensor ~ 3.6 TB;
    the point-major layout holds ~60 MB).  Criterion: reprojection RMSE
    <= 1.2x the observation noise.  Returns (wall_s, rmse, converged).
    """
    import jax
    # x64 enables the f64 residual of the mixed-precision refinement on
    # the reduced camera solve (hessian.schur_refine); every other array
    # stays f32.
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.bundle_adjustment import (
        make_ba_problem_sparse, reprojection_rmse_sparse, project)

    dtype = jnp.dtype(dtype)
    (obs, cam_idx, mask), x0, _ = make_ba_problem_sparse(
        n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=noise, seed=seed,
        dtype=dtype)
    opts = to.Options(max_iters=max_iters, max_consec_failures=0,
                      min_error=0.0,
                      hessian=to.HessianOptions(
                          save_last=False,
                          schur_refine=0 if schur_cg else 2,
                          schur_cg_iters=schur_cg))
    if dtype == jnp.float32:
        opts = opts.for_dtype(dtype)

    def pair_fn(pose, point, ob):
        return project(pose, point[None, :])[0] - ob

    def run(pts0):
        return to.schur_sparse_optimize(
            (x0["poses"], pts0), pair_fn, obs, cam_idx, mask, opts)

    # warm with perturbed landmarks, then best-of-2 timed runs from
    # differently-perturbed starts.
    x, out = run(x0["points"] + jnp.asarray(1e-3, dtype))
    jax.block_until_ready(jax.tree_util.tree_leaves(x))
    wall = float("inf")
    rng = np.random.default_rng(0)
    for rep in range(2):
        pts0 = x0["points"] + jnp.asarray(
            rng.normal(0.0, 1e-6, x0["points"].shape), dtype)
        t0 = time.perf_counter()
        x, out = run(pts0)
        rmse = float(reprojection_rmse_sparse(
            {"poses": x[0], "points": x[1]}, obs, cam_idx, mask))
        wall = min(wall, time.perf_counter() - t0)
    iters = int(out.num_iters)
    # Peak-memory evidence for the flat-layout claim (the dense grid's E
    # alone would be n_cams·n_pts·6·3 f32 ≈ 3.6 TB; memory_stats is
    # absent on CPU).
    stats = jax.local_devices()[0].memory_stats() or {}
    peak_gb = stats.get("peak_bytes_in_use", 0) / 2**30
    return wall, rmse, rmse <= 1.2 * max(noise, 1e-9), iters, peak_gb


def bench_pose_graph(n_poses: int = 5000, extra_loops: int = 100,
                     noise: float = 1e-3, seed: int = 4, dtype="float32"):
    """Large-scale pose-graph SLAM via the chain direct solver
    (chain.py: block-tridiagonal one-scan Cholesky + Woodbury loop
    closures — O(N·d³ + N·d²·m) per iteration, exact, conditioning-
    independent).  Success: converged AND final cost ≤ 3× the
    DOF-predicted chi² level (residual count ≈ tangent dims on a chain,
    so E[cost] ≈ DOF·σ²).  Returns (wall_s, cost, chi2_level, iters,
    converged).
    """
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.pose_graph import (make_pose_graph,
                                               pose_graph_optimize)

    dtype = jnp.dtype(dtype)
    data, x0, _ = make_pose_graph(
        n_poses=n_poses, extra_loops=extra_loops, noise=noise,
        init_noise=0.05, seed=seed, dtype=dtype)
    opts = to.Options(hessian=to.HessianOptions(save_last=False))
    if dtype == jnp.float32:
        opts = opts.for_dtype(dtype)

    def run(x):
        return pose_graph_optimize(x, data, opts)

    # warm with a perturbed start
    from tinyopt_tpu.manifolds import SE3
    x_w = jax.vmap(lambda p, k: SE3(p.rotation, p.translation
                                    + jnp.asarray(1e-5, dtype)))(
        x0, jnp.arange(n_poses))
    _, out_w = run(x_w)
    jax.block_until_ready(out_w.final_cost.cost)
    t0 = time.perf_counter()
    x, out = run(x0)
    cost = float(out.final_cost)            # forced read = completion
    wall = time.perf_counter() - t0
    n_res = 6 * int(data.edges.shape[0]) + 6
    dof = max(n_res - 6 * n_poses, 1)
    chi2 = dof * noise ** 2
    # success = reached the chi² floor without failure: MAX_ITERS is a
    # success stop (reference semantics) — the f32 for_dtype step/rerr
    # floors rarely fire exactly at the statistical floor, so the cost
    # criterion is the meaningful gate here.
    ok = bool(out.succeeded()) and cost <= 3.0 * chi2
    return wall, cost, chi2, int(out.num_iters), ok


def bench_bal_robust(n_cams: int = 300, n_pts: int = 20_000,
                     k_obs: int = 6, noise: float = 0.5,
                     outlier_frac: float = 0.10, seed: int = 5,
                     dtype="float32"):
    """Robust large-scale BAL: the full production recipe in ONE command
    (VERDICT r3 task #8) — 9-parameter BAL cameras (angle-axis+t+f+k1+k2
    semantics via the {pose, intr} pytree), 10% gross outliers,
    Geman-McClure GRADUATED NON-CONVEXITY ladder through the sparse-obs
    Schur solver with ``hessian.schur_refine`` mixed-precision reduced
    solves; gauge handled as in all BA paths here: LM damping spans the
    7-dim similarity null space and camera-0/point-0 anchor the start
    (make_bal_problem).  Metric: REPROJECTION RMSE IN PIXELS (the
    BAL-native number) on clean slots of determined landmarks.
    Returns (wall_s, rmse_px_robust, rmse_px_plain, ok).
    """
    import jax
    jax.config.update("jax_enable_x64", True)   # refine's f64 residual
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.losses import (geman_mcclure, gnc_anneal,
                                    gnc_schedule)
    from tinyopt_tpu.models.bal import (bal_residual, bal_rmse,
                                        make_bal_problem)

    dtype = jnp.dtype(dtype)
    (obs, cam_idx, mask), x0, _, bad = make_bal_problem(
        n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=noise,
        outlier_frac=outlier_frac, seed=seed, dtype=dtype)
    (obs_c, _, _), _, _, _ = make_bal_problem(
        n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=noise,
        outlier_frac=0.0, seed=seed, dtype=dtype)
    opts = to.Options(max_iters=15, max_consec_failures=0,
                      min_error=0.0,
                      hessian=to.HessianOptions(save_last=False,
                                                schur_refine=2))
    if dtype == jnp.float32:
        opts = opts.for_dtype(dtype)

    # gnc_anneal owns the per-threshold whitened-fn construction and
    # memoizes it across calls (r5): the naive public-API call IS the
    # fast path (a caller-side fresh closure per stage measured 327 s
    # vs the ~21 s compiled-path wall below).
    sched = gnc_schedule(50.0, 2.0, steps=5)

    def stage(x, th2, rp):
        return to.schur_sparse_optimize(x, rp, obs, cam_idx,
                                        mask, opts)

    # clean-slot metric on determined landmarks (<2 clean rays is
    # legitimately unrecoverable under a saturating loss)
    bad_np = np.asarray(bad)
    det = (bad_np.shape[1] - bad_np.sum(1)) >= 2
    good = jnp.asarray((~bad_np) & det[:, None], dtype)

    def clean_rmse(x):
        return float(bal_rmse(x[0], x[1], obs_c, cam_idx,
                              jnp.asarray(mask) * good))

    # (squared-threshold ladder 50 -> 2 ≈ 7 -> 1.4 px: measured best on
    # this model family — a near-quadratic 50 px coarse stage lets the
    # gross outliers bias the basin before saturation kicks in)
    # warm with a perturbed start
    x_w = (x0[0], x0[1] + jnp.asarray(1e-5, dtype))
    xw, _ = gnc_anneal(stage, x_w, sched,
                       residual_fn=bal_residual, robust_fn=geman_mcclure)
    jax.block_until_ready(xw[1])
    t0 = time.perf_counter()
    x_gnc, out = gnc_anneal(stage, x0, sched,
                            residual_fn=bal_residual, robust_fn=geman_mcclure)
    r_gnc = clean_rmse(x_gnc)               # forced read = completion
    wall = time.perf_counter() - t0
    x_plain, _ = to.schur_sparse_optimize(x0, bal_residual, obs,
                                          cam_idx, mask, opts)
    r_plain = clean_rmse(x_plain)
    ok = r_gnc <= 1.3 * noise and r_plain > 2.0 * r_gnc
    return wall, r_gnc, r_plain, ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("only", nargs="?", default=None,
                    choices=["bench_ba", "bench_ba_sparse",
                             "bench_pose_graph", "bench_bal_robust"],
                    help="run a single benchmark instead of the full sweep")
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--skip-device", action="store_true",
                    help="native (host CPU) rows only")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"],
                    help="dtype of the BA / pose-graph / BAL benchmarks")
    ap.add_argument("--single", action="store_true",
                    help="also time single solves on the accelerator")
    ap.add_argument("--dims", type=int, nargs="*",
                    default=[3, 6, 12, 33, 50])
    args = ap.parse_args()
    from tinyopt_tpu.utils import use_compile_cache
    use_compile_cache(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    if args.only == "bench_ba":
        ba = bench_ba(dtype=args.dtype)
        print("BA 100 cams x 5000 landmarks (15,600 tangent dims, "
              "seed=11, noise=1e-3, criterion RMSE<=1.2e-3):")
        for k, (wall, rmse, ok) in ba.items():
            print(f"  {k:<8} {wall:7.2f} s  rmse={rmse:.2e}  "
                  f"{'converged' if ok else 'NOT CONVERGED'}")
        return
    if args.only == "bench_bal_robust":
        wall, r_gnc, r_plain, ok = bench_bal_robust(dtype=args.dtype)
        print("Robust BAL 300 cams x 20,000 landmarks, 9-param cameras, "
              "120k obs, 0.5 px noise + 10% gross outliers "
              "(GNC Geman-McClure ladder 50->2 px + schur_refine=2; "
              "criterion: clean-slot rmse <= 1.3x noise AND plain L2 "
              ">= 2x worse):")
        print(f"  gnc      {wall:7.2f} s  rmse={r_gnc:.3f} px  "
              f"(plain L2: {r_plain:.3f} px)  "
              f"{'OK' if ok else 'FAILED'}")
        return
    if args.only == "bench_pose_graph":
        wall, cost, chi2, iters, ok = bench_pose_graph(dtype=args.dtype)
        print("Pose-graph SLAM 5000 poses + 100 loop closures (30,000 "
              "tangent dims; chain direct solver, criterion cost <= "
              "3x DOF-chi2):")
        print(f"  chain    {wall:7.2f} s  cost={cost:.2e}  "
              f"chi2={chi2:.2e}  iters={iters}  "
              f"{'converged' if ok else 'NOT CONVERGED'}")
        return
    if args.only == "bench_ba_sparse":
        wall, rmse, ok, iters, peak_gb = bench_ba_sparse(dtype=args.dtype)
        print("Sparse-visibility BA 1000 cams x 50,000 landmarks "
              "(156,000 tangent dims, 400k observations, K=8, "
              "criterion RMSE<=1.2e-3):")
        mem = (f"peak_mem={peak_gb:.2f} GiB" if peak_gb > 0
               else "peak_mem=n/a (no memory_stats on this backend)")
        print(f"  schur_sparse {wall:7.2f} s  rmse={rmse:.2e}  "
              f"iters={iters}  {mem}  "
              f"{'converged' if ok else 'NOT CONVERGED'}")
        return

    dims = args.dims
    nat = bench_native(dims)
    if args.skip_device:
        dev1, devN = {}, {}
    else:
        dev1, devN = bench_device(dims, args.batch, args.single)

    print(f"{'problem':<10} {'ref µs':>8} {'native µs':>10} {'vs ref':>7} "
          f"{'dev-1 µs':>9} {'dev-10k µs':>11} {'vs ref':>7}")
    for k in ["sqrt2"] + [f"prior{d}" for d in dims]:
        ref = REFERENCE_US.get(k, float("nan"))
        n = nat.get(k, float("nan"))
        t1 = dev1.get(k, float("nan"))
        tn = devN.get(k, float("nan"))
        print(f"{k:<10} {ref:>8.2f} {n:>10.2f} {ref/n:>6.2f}x "
              f"{t1:>9.0f} {tn:>11.2f} {ref/tn:>6.2f}x")

    natf = bench_native_f32(dims)
    print(f"\n{'float32':<10} {'ref µs':>8} {'native µs':>10} {'vs ref':>7}"
          "   (reference publishes only sqrt2-float; densef.cpp rows "
          "unpublished)")
    for k in ["sqrt2f"] + [f"prior{d}f" for d in dims]:
        ref = REFERENCE_US_F32.get(k, float("nan"))
        n = natf.get(k, float("nan"))
        vs = f"{ref/n:>6.2f}x" if ref == ref else "      -"
        print(f"{k:<10} {ref:>8.2f} {n:>10.2f} {vs}")

    if not args.skip_device:
        blk, coo = bench_sparse(args.batch)
        print(f"\n{'sparse (r=10x-2)':<18} {'block µs':>9} {'coo-pcg µs':>11}"
              "   (reference rows unpublished; batched per-solve)")
        for k in sorted(blk, key=lambda s: int(s[6:])):
            print(f"{k:<18} {blk[k]:>9.2f} {coo[k]:>11.2f}")

        sps, conv = bench_se3(args.batch)
        print(f"\nse3_refinement: {sps:,.0f} solves/s "
              f"(batch={args.batch}, 16 pts, conv={conv:.2f}) — flagship "
              "model, no reference counterpart")

        ba = bench_ba(dtype=args.dtype)
        print("\nBA 100 cams x 5000 landmarks (15,600 tangent dims, "
              "seed=11, noise=1e-3, criterion RMSE<=1.2e-3):")
        for k, (wall, rmse, ok) in ba.items():
            print(f"  {k:<8} {wall:7.2f} s  rmse={rmse:.2e}  "
                  f"{'converged' if ok else 'NOT CONVERGED'}")

        wall, cost, chi2, iters, ok = bench_pose_graph(dtype=args.dtype)
        print("\nPose-graph SLAM 5000 poses + 100 loop closures (30,000 "
              "tangent dims; chain direct solver):")
        print(f"  chain    {wall:7.2f} s  cost={cost:.2e}  "
              f"chi2={chi2:.2e}  iters={iters}  "
              f"{'converged' if ok else 'NOT CONVERGED'}")


if __name__ == "__main__":
    main()
