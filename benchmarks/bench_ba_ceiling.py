"""One-device memory-ceiling BA: the largest corridor instance that fits
one device, converging to its noise criterion.

What sets the ceiling:
  * landmark-side state is O(n_obs): E (n_b, K·da·db) f32 dominates —
    at 500k landmarks × K=8: 288 MB; obs/C/Cinv/buffers ~200 MB more;
  * the reduced camera system uses BAND storage
    (ops/schur_obs.banded_reduced_solve_band): n_a·(bw+1) da² blocks
    (~20 MB at 10k cameras) instead of the flat (n_a², da²) grid
    (14.4 GB at 10k);
  * transients are O(chunk · K² · da²), independent of n_b.

Default config: 10,000 cameras × 500,000 landmarks × K=8 = 4M
observations, 1.56M tangent dims.  Criterion: reprojection RMSE ≤
1.2 × noise.  Reports ms/iter (marginal-protocol), RMSE, and a peak-
memory account.

Usage: python benchmarks/bench_ba_ceiling.py [n_cams n_pts k_obs]
(f32; set BA_DTYPE=float64 for f64)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(n_cams=10_000, n_pts=500_000, k_obs=8, max_iters=13,
         cg: int = 0, damp_floor: float = 0.0):
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.bundle_adjustment import (
        make_ba_problem_sparse, project, reprojection_rmse_sparse)

    noise = 1e-3
    dtype = jnp.dtype(os.environ.get("BA_DTYPE", "float32"))
    t0 = time.perf_counter()
    (obs, ci, mk), x0, _ = make_ba_problem_sparse(
        n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=noise, seed=7,
        dtype=dtype)
    print(f"instance built in {time.perf_counter() - t0:.1f}s "
          f"({n_cams} cams x {n_pts} pts x K={k_obs} = "
          f"{n_pts * k_obs / 1e6:.1f}M obs, "
          f"{(n_cams * 6 + n_pts * 3) / 1e6:.2f}M tangent dims)")

    def pf(pose, point, ob):
        return project(pose, point[None, :])[0] - ob

    # path introspection: which assembly the entry will pick
    from tinyopt_tpu.ops.schur_obs import (_pick_chunk, camera_sort_perm,
                                           detect_camera_bandwidth,
                                           pick_band_group,
                                           plan_window_reduce_banded)
    bw = detect_camera_bandwidth(np.asarray(ci), np.asarray(mk))
    bg = pick_band_group(bw, n_cams, 6)
    perm = camera_sort_perm(np.asarray(ci), np.asarray(mk), n_cams,
                            k_obs)
    cam_probe = np.asarray(ci) if perm is None else np.asarray(ci)[perm]
    CHp = _pick_chunk(-(-n_pts // 1024) * 1024, 1024)
    bplan = None if bg is None else plan_window_reduce_banded(
        np.concatenate([cam_probe, np.zeros(
            ((-(-n_pts // 1024) * 1024) - n_pts, k_obs), np.int64)]),
        n_cams, k_obs, CHp, bw)
    print(f"path: bw={bw} band_group={bg} "
          f"sort={'active' if perm is not None else 'natural'} "
          f"band_storage={'ACTIVE (no n_a^2 grid)' if bplan is not None else 'flat'}")

    # Long corridors condition like O(n_cams²): at 4000+ cameras the
    # f32 banded CR factor can hit a non-PD pivot once λ anneals small
    # (stop=-3, measured).  Two conditioning escapes, both CLI-exposed:
    # ``cg`` switches the reduced solve to block-Jacobi PCG (inexact
    # steps, never factors), ``damp_floor`` raises the λ clamp so the
    # reduced system stays away from its null space.
    lm = to.LMOptions(damping_range=(damp_floor, 1e9)) if damp_floor \
        else to.LMOptions()
    o = to.Options(max_iters=max_iters, max_consec_failures=0,
                   min_error=0.0, lm=lm,
                   hessian=to.HessianOptions(
                       save_last=False,
                       schur_refine=0 if cg else 2,
                       schur_cg_iters=cg))
    if dtype == jnp.float32:
        o = o.for_dtype(dtype)

    t0 = time.perf_counter()
    x, out = to.schur_sparse_optimize(
        (x0["poses"], x0["points"]), pf, obs, ci, mk, o)
    rmse = float(reprojection_rmse_sparse(
        {"poses": x[0], "points": x[1]}, obs, ci, mk))
    wall = time.perf_counter() - t0
    it = int(out.num_iters)
    print(f"converged: rmse={rmse:.3e} (criterion {1.2 * noise:.1e}) "
          f"in {it} iters, wall {wall:.1f}s (incl. compile) "
          f"stop={int(out.stop_reason)}")

    # marginal ms/iter: max_iters sweep (min_error=0 pins the count)
    walls = {}
    for mi in (3, max_iters):
        o_i = o.replace(max_iters=mi)
        x0p = (x0["poses"], x0["points"]
               + jnp.asarray(np.random.default_rng(1).uniform(
                   1e-7, 2e-7, x0["points"].shape), dtype))
        jax.block_until_ready(to.schur_sparse_optimize(
            (x0p[0], x0p[1]), pf, obs, ci, mk, o_i)[0][1])
        x0q = (x0["poses"], x0["points"]
               + jnp.asarray(np.random.default_rng(2).uniform(
                   1e-7, 2e-7, x0["points"].shape), dtype))
        t0 = time.perf_counter()
        xq, oq = to.schur_sparse_optimize(
            (x0q[0], x0q[1]), pf, obs, ci, mk, o_i)
        float(jnp.sum(xq[1][:8]))
        walls[mi] = time.perf_counter() - t0
    ms_iter = (walls[max_iters] - walls[3]) / (max_iters - 3) * 1e3
    print(f"marginal {ms_iter:.1f} ms/iter [marginal] "
          f"({max_iters}-vs-3 max_iters sweep)")

    # memory account (f32 bytes)
    bs = jnp.dtype(dtype).itemsize
    acc = {
        "obs": n_pts * k_obs * 2 * bs,
        "E": n_pts * k_obs * 6 * 3 * bs,
        "C+Cinv": 2 * n_pts * 9 * bs,
        "g/dx/x": 3 * (n_cams * 6 + n_pts * 3) * bs,
        "S band (bw~7)": n_cams * 8 * 36 * bs,
        "flat S would be": n_cams * n_cams * 36 * bs,
    }
    for k, v in acc.items():
        print(f"  mem {k:16s} {v / 2**30:8.2f} GiB")
    ok = rmse <= 1.2 * noise
    print(f"RESULT ok={ok} rmse={rmse:.3e} ms_iter={ms_iter:.1f}")
    return ok


if __name__ == "__main__":
    # n_cams n_pts k_obs [max_iters] [cg] [damp_floor]
    argv = sys.argv[1:]
    args = [int(a) for a in argv[:5]]
    kw = {"damp_floor": float(argv[5])} if len(argv) > 5 else {}
    main(*args, **kw)
