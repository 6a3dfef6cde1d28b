"""CPU f32 probe of the r5-path convergence question (runs anywhere).

If the windowed/band-storage path converges measurably worse than the
planned path in f32 on CPU too, the regression is numerical (summation
order / refine semantics), not an artifact of one device — and it can
be bisected locally.  f64 rows give the trajectory floor.

Window programs on CPU need the thunk-scheduler race flag (CLAUDE.md
r5); set before jax import.
"""

import os
import sys

os.environ.setdefault(
    "XLA_FLAGS",
    "--xla_cpu_enable_concurrency_optimized_scheduler=false")

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(n_cams=200, n_pts=10_000, k_obs=8, max_iters=12):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import tinyopt_tpu as to
    from tinyopt_tpu.models.bundle_adjustment import (
        make_ba_problem_sparse, project, reprojection_rmse_sparse)

    def pf(pose, point, ob):
        return project(pose, point[None, :])[0] - ob

    for dtype in (jnp.float32, jnp.float64):
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=1e-3,
            seed=7, dtype=dtype)
        for name, win, banded, sort in (
                ("window+band", "1", "auto", "auto"),
                ("window_dense", "1", "off", "auto"),
                ("planned", "0", "auto", "off"),
                ("planned_dense", "0", "off", "off")):
            os.environ["TINYOPT_WINDOW_REDUCE"] = win
            o = to.Options(max_iters=max_iters, max_consec_failures=0,
                           min_error=0.0,
                           hessian=to.HessianOptions(
                               save_last=False, schur_refine=2,
                               schur_banded=banded, schur_sort=sort))
            if dtype == jnp.float32:
                o = o.for_dtype(dtype)
            x, out = to.schur_sparse_optimize(
                (x0["poses"], x0["points"]), pf, obs, ci, mk, o)
            rmse = float(reprojection_rmse_sparse(
                {"poses": x[0], "points": x[1]}, obs, ci, mk))
            print(f"{jnp.dtype(dtype).name} {name:14s} rmse={rmse:.4e} "
                  f"iters={int(out.num_iters)} "
                  f"stop={int(out.stop_reason)}", flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    run(*args)
