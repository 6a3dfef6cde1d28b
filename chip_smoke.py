"""Run the solvers' main paths once on a GPU and check every result.

A check of the batched-CG Triton kernel (``cg_kernel``: at 10k × 50 in
f32, against the XLA CG and a float64 solve), then one phase per
deployment the ROADMAP names, each through the public entry points at
full size, in f32, with its own correctness criterion checked in the same
run:

  1. ``prior50``  — ``parallel.batched_solver`` on 10,000 whitened
     50-dim priors (LM, ``solver="cg"``); reference: the closed-form
     optimum x = y.
  2. ``se3``      — batched SE(3) refinement, 10,000 instances × 16
     points; reference: the generator's ground-truth poses.
  3. ``pose_graph`` — ``pose_graph_optimize``, 5000 poses + 100 loop
     closures; criterion: succeeded and cost ≤ 3 × the χ² DOF level.
  4. ``ba_sparse`` — ``schur_sparse_optimize`` on the 1000-camera ×
     50k-point corridor (K = 8, ``schur_refine=2``, x64 on for the
     refinement's f64 residual); criterion: rmse ≤ 1.2 × noise.

The BA phase runs last because it turns x64 on for the rest of the
process.  Each phase prints one line: compile seconds (for the entry
points that jit internally: first call minus a steady call, so it
includes tracing and host-side planning), steady-state wall, LM
iterations, the criterion's value and limit, and the process's
``peak_bytes_in_use`` so far.

``--cards 4`` runs only the multi-card phases, each against the same
problem on one card: (a) ``batched_optimize`` of 40,000 prior-50
instances over a 4-card batch mesh, instance by instance; (b)
``sharded_schur_sparse_optimize`` of the corridor BA over 4 cards.

Usage: ``python chip_smoke.py [--cards 4]``.  Exits non-zero without a
GPU, or if any phase fails its criterion.  The last line is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def require_gpu(platform: str) -> None:
    """Refuse any platform but a GPU: no phase runs anywhere else."""
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found platform {platform!r}")


def card_line() -> str:
    """Card name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _peak_bytes() -> int:
    import jax
    return int((jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", 0))


def _report(phase: str, ok: bool, **fields) -> None:
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"phase={phase} {parts} peak_bytes_in_use={_peak_bytes()} "
          f"ok={ok}", flush=True)


def _steady(fn, reps: int = 5) -> float:
    """Median wall seconds of ``fn()``, whose result is waited for."""
    import jax
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _aot(fn, *args):
    """(compiled fn, compile seconds) for ``jax.jit(fn)`` at ``args``."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def prior_options():
    """bench.py's options: the reference benchmark's stop criteria
    (benchmarks/options.h:10-27) with the batched CG solve."""
    import tinyopt_tpu as to
    return to.Options(
        max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
        min_step_norm2=1e-16, max_consec_failures=3, save_history=False,
        hessian=to.HessianOptions(save_last=False, solver="cg",
                                  cg_iters=8, carry_system=False))


def cg_kernel_check(batch: int = 10_000, d: int = 50, iters: int = 8):
    """The batched-CG Triton kernel against its plain references.

    Returns ``(same-iterations rel. error, exact-solve rel. error,
    kernel seconds, XLA seconds)``.  Same iteration count: against
    ``solve_psd_cg`` under HIGHEST precision (true f32 products) on
    LM-like systems JᵀJ + 1e-3·I; the iterates differ only by f32
    summation order.  Exact solve: ``d`` iterations on well-conditioned
    systems (cond ≈ 5) against float64 ``np.linalg.solve``.  Errors are
    max over instances of max|Δx| / max|x|.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tinyopt_tpu.ops.linalg import solve_psd_cg
    from tinyopt_tpu.ops.pallas_cg import batched_cg_triton

    def rel(x, ref):
        x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
        return float(np.max(np.abs(x - ref).max(1)
                            / np.maximum(np.abs(ref).max(1), 1e-30)))

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    with jax.default_matmul_precision("highest"):
        J = jax.random.normal(k1, (batch, d + 4, d), jnp.float32) \
            * jax.random.uniform(k2, (batch, 1, d), jnp.float32, 0.1, 10.0)
        eye = jnp.eye(d, dtype=jnp.float32)
        H = jnp.einsum("bki,bkj->bij", J, J) + 1e-3 * eye
        A = jax.random.normal(k3, (batch, d, d), jnp.float32)
        H2 = A @ jnp.swapaxes(A, 1, 2) / d + eye
    b = jax.random.normal(k1, (batch, d), jnp.float32)
    kernel = jax.jit(batched_cg_triton, static_argnums=2)
    xla = jax.jit(solve_psd_cg, static_argnums=2)
    with jax.default_matmul_precision("highest"):
        x_ref = xla(H, b, iters)
    same = rel(kernel(H, b, iters), x_ref)
    x64 = np.linalg.solve(np.asarray(H2, np.float64),
                          np.asarray(b, np.float64)[..., None])[..., 0]
    exact = rel(kernel(H2, b, d), x64)
    t_k = _steady(lambda: kernel(H, b, iters), reps=20)
    t_x = _steady(lambda: xla(H, b, iters), reps=20)
    return same, exact, t_k, t_x


def phase_cg_kernel(batch: int = 10_000, d: int = 50) -> bool:
    same, exact, t_k, t_x = cg_kernel_check(batch, d)
    # 1e-4: the kernel and XLA run the same iterations in f32 and differ
    # by summation order, a few ulps amplified by cond(H) over 8 steps
    ok = same <= 1e-4 and exact <= 1e-4
    _report("cg_kernel", ok, batch=batch, d=d,
            rel_err_vs_xla_cg=f"{same:.3e}",
            rel_err_vs_f64_solve=f"{exact:.3e}", kernel_s=f"{t_k:.6f}",
            xla_s=f"{t_x:.6f}", limit="rel<=1e-4")
    return ok


def phase_prior(batch: int = 10_000, dims: int = 50) -> bool:
    import jax
    import jax.numpy as jnp
    from tinyopt_tpu.models.problems import make_prior_batch, prior_residual
    from tinyopt_tpu.parallel import batched_solver

    data, x0 = make_prior_batch(batch, dims, dtype=jnp.float32, seed=1)
    ex = jax.tree_util.tree_map(lambda a: a[0], (x0, data))
    solve, compile_s = _aot(
        batched_solver(prior_residual, prior_options(), "residuals", *ex),
        x0, data)
    x, out = solve(x0, data)
    wall = _steady(lambda: solve(x0, data))
    conv = float(jnp.mean(out.converged()))
    err = float(jnp.max(jnp.abs(x - data.y)))
    ok = conv >= 0.99 and err <= 1e-4
    _report("prior50", ok, batch=batch, compile_s=f"{compile_s:.3f}",
            wall_s=f"{wall:.6f}", solves_per_s=f"{batch / wall:.1f}",
            mean_iters=f"{float(jnp.mean(out.num_iters)):.3f}",
            converged=f"{conv:.4f}", max_abs_x_minus_y=f"{err:.3e}",
            limit="conv>=0.99,err<=1e-4")
    return ok


def phase_se3(batch: int = 10_000, n_points: int = 16) -> bool:
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.se3_refinement import (make_se3_refinement,
                                                   se3_residual)
    from tinyopt_tpu.parallel import batched_solver

    # run_benchmarks.bench_se3's problem and options (noise 1e-3)
    data, x0, true = make_se3_refinement(batch, n_points=n_points,
                                         dtype=jnp.float32, seed=3)
    opts = to.Options(max_iters=10, max_consec_failures=3,
                      hessian=to.HessianOptions(save_last=False,
                                                carry_system=False))
    ex = jax.tree_util.tree_map(lambda a: a[0], (x0, data))
    solve, compile_s = _aot(
        batched_solver(se3_residual, opts, "residuals", *ex), x0, data)
    x, out = solve(x0, data)
    wall = _steady(lambda: solve(x0, data))
    # tangent distance to the ground truth; 1e-2 is ten times the
    # observation noise (the estimate's own error is ~noise/√K)
    err = float(jnp.max(jnp.abs(
        jax.vmap(lambda a, b: (a.inverse() @ b).log())(true, x))))
    conv = float(jnp.mean(out.converged()))
    ok = conv >= 0.99 and err <= 1e-2
    _report("se3", ok, batch=batch, compile_s=f"{compile_s:.3f}",
            wall_s=f"{wall:.6f}", solves_per_s=f"{batch / wall:.1f}",
            mean_iters=f"{float(jnp.mean(out.num_iters)):.3f}",
            converged=f"{conv:.4f}", max_tangent_err=f"{err:.3e}",
            limit="conv>=0.99,err<=1e-2")
    return ok


def _timed_entry(run, x_warm, x0, reps: int = 3):
    """(first-call seconds, median steady seconds, result) of an entry
    point that jits and caches internally; the first call starts
    elsewhere."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(run(x_warm))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(x0))
        ts.append(time.perf_counter() - t0)
    return first, sorted(ts)[reps // 2], res


def pose_graph_problem(n_poses: int = 5000, extra_loops: int = 100,
                       noise: float = 1e-3):
    import jax.numpy as jnp
    from tinyopt_tpu.models.pose_graph import make_pose_graph
    data, x0, _ = make_pose_graph(n_poses=n_poses, extra_loops=extra_loops,
                                  noise=noise, init_noise=0.05, seed=4,
                                  dtype=jnp.float32)
    n_res = 6 * int(data.edges.shape[0]) + 6
    chi2 = max(n_res - 6 * n_poses, 1) * noise ** 2
    return data, x0, chi2


def phase_pose_graph(n_poses: int = 5000, extra_loops: int = 100,
                     method: str = "auto") -> bool:
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.manifolds import SE3
    from tinyopt_tpu.models.pose_graph import pose_graph_optimize

    data, x0, chi2 = pose_graph_problem(n_poses, extra_loops)
    opts = to.Options(hessian=to.HessianOptions(save_last=False)
                      ).for_dtype(jnp.float32)
    x_warm = jax.vmap(lambda p: SE3(p.rotation, p.translation + 1e-5))(x0)
    first, wall, (_, out) = _timed_entry(
        lambda x: pose_graph_optimize(x, data, opts, method=method),
        x_warm, x0)
    cost = float(out.final_cost)
    ok = bool(out.succeeded()) and cost <= 3.0 * chi2
    _report("pose_graph", ok, n_poses=n_poses, method=method,
            compile_s=f"{first - wall:.3f}", wall_s=f"{wall:.6f}",
            iters=int(out.num_iters), cost=f"{cost:.4e}",
            limit=f"cost<={3.0 * chi2:.4e}")
    return ok


def ba_problem(n_cams: int = 1000, n_pts: int = 50_000, k_obs: int = 8,
               noise: float = 1e-3):
    """run_benchmarks.bench_ba_sparse's corridor problem and options."""
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.bundle_adjustment import make_ba_problem_sparse
    (obs, cam_idx, mask), x0, _ = make_ba_problem_sparse(
        n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=noise, seed=7,
        dtype=jnp.float32)
    opts = to.Options(max_iters=12, max_consec_failures=0, min_error=0.0,
                      hessian=to.HessianOptions(save_last=False,
                                                schur_refine=2)
                      ).for_dtype(jnp.float32)
    return (obs, cam_idx, mask), x0, opts


def ba_pair_fn(pose, point, ob):
    from tinyopt_tpu.models.bundle_adjustment import project
    return project(pose, point[None, :])[0] - ob


def ba_rmse(x, obs, cam_idx, mask) -> float:
    from tinyopt_tpu.models.bundle_adjustment import reprojection_rmse_sparse
    return float(reprojection_rmse_sparse(
        {"poses": x[0], "points": x[1]}, obs, cam_idx, mask))


def phase_ba_sparse(n_cams: int = 1000, n_pts: int = 50_000,
                    noise: float = 1e-3) -> bool:
    import jax
    import tinyopt_tpu as to

    jax.config.update("jax_enable_x64", True)
    (obs, cam_idx, mask), x0, opts = ba_problem(n_cams, n_pts, noise=noise)
    first, wall, (x, out) = _timed_entry(
        lambda pts: to.schur_sparse_optimize(
            (x0["poses"], pts), ba_pair_fn, obs, cam_idx, mask, opts),
        x0["points"] + 1e-3, x0["points"])
    rmse = ba_rmse(x, obs, cam_idx, mask)
    ok = rmse <= 1.2 * noise
    _report("ba_sparse", ok, n_cams=n_cams, n_pts=n_pts,
            compile_s=f"{first - wall:.3f}", wall_s=f"{wall:.6f}",
            iters=int(out.num_iters), rmse=f"{rmse:.4e}",
            limit=f"rmse<={1.2 * noise:.4e}")
    return ok


def _max_rel(x, ref) -> float:
    import numpy as np
    return float(np.max(np.abs(x - ref) / np.maximum(np.abs(ref), 1e-30)))


def _twice(fn):
    """("first,second" call seconds, second result) of ``fn()``."""
    import jax
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn())
        walls.append(f"{time.perf_counter() - t0:.4f}")
    return ",".join(walls), res


def _device_count(tree) -> int:
    import jax
    return min(len(leaf.sharding.device_set)
               for leaf in jax.tree_util.tree_leaves(tree))


def phase_batched_mesh(batch: int = 40_000, dims: int = 50,
                       cards: int = 4) -> bool:
    import jax.numpy as jnp
    import numpy as np
    from tinyopt_tpu.models.problems import make_prior_batch, prior_residual
    from tinyopt_tpu.parallel import batched_optimize, make_mesh

    data, x0 = make_prior_batch(batch, dims, dtype=jnp.float32, seed=1)
    opts = prior_options()
    mesh = make_mesh(batch=cards, block=1)

    def run(mesh_or_none):
        return batched_optimize(x0, prior_residual, opts, data_batch=data,
                                mode="residuals", mesh=mesh_or_none)

    t_one, (x1, out1) = _twice(lambda: run(None))
    t_mesh, (x4, out4) = _twice(lambda: run(mesh))
    n_dev = _device_count((x4, out4.final_cost.cost))
    same_stop = bool(np.array_equal(np.asarray(out1.stop_reason),
                                    np.asarray(out4.stop_reason)))
    c1 = np.asarray(out1.final_cost.cost)
    c4 = np.asarray(out4.final_cost.cost)
    cost_ok = bool(np.allclose(c4, c1, rtol=1e-5, atol=0.0))
    ok = n_dev == cards and same_stop and cost_ok
    _report("batched_mesh", ok, batch=batch, cards=n_dev,
            one_card_s=t_one, mesh_s=t_mesh, stop_reasons_equal=same_stop,
            max_cost_rel_diff=f"{_max_rel(c4, c1):.3e}",
            limit="stop_reasons_equal,cost_rtol<=1e-5")
    return ok


def phase_ba_sharded(n_cams: int = 1000, n_pts: int = 50_000,
                     noise: float = 1e-3, cards: int = 4) -> bool:
    import jax
    import tinyopt_tpu as to
    from tinyopt_tpu.parallel import make_mesh, sharded_schur_sparse_optimize

    jax.config.update("jax_enable_x64", True)
    (obs, cam_idx, mask), x0, opts = ba_problem(n_cams, n_pts, noise=noise)
    x0 = (x0["poses"], x0["points"])
    t_one, (x1, out1) = _twice(lambda: to.schur_sparse_optimize(
        x0, ba_pair_fn, obs, cam_idx, mask, opts))
    mesh = make_mesh(batch=1, block=cards)
    t_mesh, (x4, out4) = _twice(lambda: sharded_schur_sparse_optimize(
        x0, ba_pair_fn, obs, cam_idx, mask, opts, mesh=mesh))
    r1 = ba_rmse(x1, obs, cam_idx, mask)
    r4 = ba_rmse(x4, obs, cam_idx, mask)
    n_dev = _device_count(x4[1])
    c1, c4 = float(out1.final_cost.cost), float(out4.final_cost.cost)
    rel = abs(c4 - c1) / max(abs(c1), 1e-30)
    ok = (n_dev == cards and r1 <= 1.2 * noise and r4 <= 1.2 * noise
          and rel <= 1e-2)
    _report("ba_sharded", ok, n_cams=n_cams, n_pts=n_pts, cards=n_dev,
            one_card_s=t_one, mesh_s=t_mesh, rmse_one_card=f"{r1:.4e}",
            rmse_mesh=f"{r4:.4e}", cost_rel_diff=f"{rel:.3e}",
            limit=f"rmse<={1.2 * noise:.4e},cost_rtol<=1e-2")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: only the multi-card phases")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    import tinyopt_tpu  # noqa: F401 - fail here, before any output
    from tinyopt_tpu.utils import use_compile_cache

    dev = jax.devices()[0]
    require_gpu(dev.platform)
    if len(jax.devices()) < args.cards:
        raise SystemExit(f"chip_smoke: --cards {args.cards} needs "
                         f"{args.cards} GPUs, found {len(jax.devices())}")
    use_compile_cache(ROOT)
    print(f"card: {card_line()}", flush=True)

    if args.cards == 4:
        phases = [phase_batched_mesh, phase_ba_sharded]
    else:
        phases = [phase_cg_kernel, phase_prior, phase_se3, phase_pose_graph,
                  phase_ba_sparse]
    failed = [p.__name__ for p in phases if not p()]
    if failed:
        raise SystemExit(f"chip_smoke: failed {failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
