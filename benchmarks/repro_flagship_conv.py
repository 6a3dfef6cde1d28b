"""Flagship-convergence isolation sweep (r5).

Runs the 1000-camera corridor BA (f32, max_iters=12) under each
combination of the windowed reduce, the internal camera-locality sort
and the band-storage reduced system, to isolate which ingredient moves
the trajectory.  One config per subprocess, so environment switches
and compile caches do not leak between configs.

Usage:
    python benchmarks/repro_flagship_conv.py            # full sweep
    python benchmarks/repro_flagship_conv.py one <name> # one cell
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONFIGS = {
    # name: (TINYOPT_WINDOW_REDUCE env, schur_banded, schur_sort,
    #        extra env dict)
    "default":        (None, "auto", "auto", None),
    "sort_off":       (None, "auto", "off", None),
    "banded_off":     (None, "off", "auto", None),
    "window_off":     ("0", "auto", "auto", None),
    "all_off":        ("0", "off", "off", None),
    # CR level math A/B (r4 cho_solve vs r5 explicit sweep inverse)
    "default_crchol": (None, "auto", "auto",
                       {"TINYOPT_CR_CHOLESKY": "1"}),
    "window_off_crchol": ("0", "auto", "auto",
                          {"TINYOPT_CR_CHOLESKY": "1"}),
}


def run_one(name: str):
    env_win, banded, sort, extra = CONFIGS[name]
    if extra:
        os.environ.update(extra)
    if env_win is not None:
        os.environ["TINYOPT_WINDOW_REDUCE"] = env_win
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.bundle_adjustment import (
        make_ba_problem_sparse, project, reprojection_rmse_sparse)

    dtype = jnp.float32
    (obs, ci, mk), x0, _ = make_ba_problem_sparse(
        n_cams=1000, n_pts=50_000, k_obs=8, noise=1e-3, seed=7,
        dtype=dtype)

    def pf(pose, point, ob):
        return project(pose, point[None, :])[0] - ob

    o = to.Options(max_iters=12, max_consec_failures=0, min_error=0.0,
                   hessian=to.HessianOptions(
                       save_last=False, schur_refine=2,
                       schur_banded=banded, schur_sort=sort))
    if dtype == jnp.float32:
        o = o.for_dtype(dtype)
    x, out = to.schur_sparse_optimize(
        (x0["poses"], x0["points"]), pf, obs, ci, mk, o)
    rmse = float(reprojection_rmse_sparse(
        {"poses": x[0], "points": x[1]}, obs, ci, mk))
    print(f"RESULT {name}: rmse={rmse:.3e} iters={int(out.num_iters)} "
          f"stop={int(out.stop_reason)}", flush=True)


def main():
    for name in CONFIGS:
        print(f"--- {name}", flush=True)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "one", name],
            capture_output=True, text=True, timeout=1500)
        for ln in r.stdout.splitlines():
            if ln.startswith("RESULT"):
                print(ln, flush=True)
        if r.returncode != 0:
            tail = "\n".join((r.stdout + r.stderr).splitlines()[-4:])
            print(f"RESULT {name}: CRASHED rc={r.returncode}\n{tail}",
                  flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "one":
        run_one(sys.argv[2])
    else:
        main()
