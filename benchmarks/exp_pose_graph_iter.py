"""Per-iteration device time of the pose-graph chain solver (marginal).

A same-process marginal: time the solve at max_iters=15 and max_iters=5
(both compiled and warmed, fresh perturbed starts per rep, forced scalar
reads) and divide the difference by 10, so dispatch and fixed overheads
cancel.

Usage: python benchmarks/exp_pose_graph_iter.py [n_poses extra_loops reps]
(f32; set BA_DTYPE=float64 for f64)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(n_poses=5000, extra_loops=100, reps=3):
    import jax
    import jax.numpy as jnp
    import tinyopt_tpu as to
    from tinyopt_tpu.models.pose_graph import (make_pose_graph,
                                               pose_graph_optimize)

    dtype = jnp.dtype(os.environ.get("BA_DTYPE", "float32"))
    data, x0, _ = make_pose_graph(
        n_poses=n_poses, extra_loops=extra_loops, noise=1e-3,
        init_noise=0.05, seed=4, dtype=dtype)

    def opts(iters):
        o = to.Options(max_iters=iters, min_error=0.0,
                       min_step_norm2=0.0, min_grad_norm2=0.0,
                       min_rerr_dec=0.0,
                       hessian=to.HessianOptions(save_last=False))
        return o

    from tinyopt_tpu.manifolds import SE3

    def perturbed(s):
        return jax.vmap(lambda p: SE3(p.rotation, p.translation
                                      + jnp.asarray(s, dtype)))(x0)

    walls = {}
    for iters in (5, 15):
        o = opts(iters)

        def run(x):
            _, out = pose_graph_optimize(x, data, o)
            return float(out.final_cost)    # forced read

        run(perturbed(1e-6))                # compile + warm
        best = float("inf")
        for r in range(reps):
            x = perturbed(1e-6 * (r + 2))   # fresh inputs per rep
            t0 = time.perf_counter()
            run(x)
            best = min(best, time.perf_counter() - t0)
        walls[iters] = best
    per_iter = (walls[15] - walls[5]) / 10.0
    print(f"# pose-graph {n_poses} poses + {extra_loops} loops "
          f"(m={6*extra_loops} Woodbury cols), backend="
          f"{jax.default_backend()}, min of {reps} reps")
    print(f"wall(5 iters)={walls[5]:.2f}s wall(15 iters)={walls[15]:.2f}s"
          f" -> {per_iter*1e3:.0f} ms/LM-iteration (marginal)")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
