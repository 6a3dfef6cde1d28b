"""Batched 50-dim NLLS solves per second on one GPU.

Mirrors the reference's hardest published dense benchmark — the 50-dim
whitened Gaussian prior, 56.26 µs per LM solve single-threaded CPU
(BASELINE.md row 9, reference benchmarks/dense.cpp:83-114, options
benchmarks/options.h:10-27) — at serving scale: REPS batches of 10k
independent instances solved inside ONE dispatched XLA program (a
``lax.fori_loop`` around the vmapped LM solve with ``solver="cg"``), with
fresh instances generated on the device per repetition.  Each
repetition's starts depend on the previous repetition's cost, so none
can be elided or reordered.

Prints the card line (name, power limit) and then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"} where value = full
LM solves per second and vs_baseline is the speedup over the reference's
1/56.26µs = 17,775 solves/s.  Exits non-zero without a GPU.  The
benchmark's full definition (cells, spans, bounds) is still to come.
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
from jax import lax


REF_SOLVE_US = 56.26          # BASELINE.md: dense VecX Prior-50, per solve
BATCH = 10_000
DIMS = 50
REPS = 256                    # solve-batches per dispatched program


def main():
    import chip_smoke
    import tinyopt_tpu as to
    from tinyopt_tpu.models.problems import PriorProblem, prior_residual
    from tinyopt_tpu.parallel.batched import batched_solver
    from tinyopt_tpu.utils import use_compile_cache

    dev = jax.devices()[0]
    chip_smoke.require_gpu(dev.platform)
    use_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    print(f"card: {chip_smoke.card_line()}", flush=True)

    # Reference benchmark options (benchmarks/options.h:10-27) with the
    # batched CG solve (ops/pallas_cg.py).
    opts = to.Options(
        max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
        min_step_norm2=1e-16, max_consec_failures=3,
        save_history=False,
        hessian=to.HessianOptions(save_last=False, solver="cg",
                                  cg_iters=8, carry_system=False),
    )

    def gen(key):
        # Same instance distribution as models/problems.make_prior_batch,
        # generated on-device (reference benchmarks/dense.cpp:85-95).
        k0, k1, k2 = jax.random.split(key, 3)
        y = jax.random.uniform(k0, (BATCH, DIMS), jnp.float32, -1, 1)
        std = jax.random.uniform(k1, (BATCH, DIMS), jnp.float32, 0.1, 1.1)
        x0 = jax.random.uniform(k2, (BATCH, DIMS), jnp.float32, -1, 1)
        return PriorProblem(y=y, inv_std=1.0 / std), x0

    data_ex, x0_ex = gen(jax.random.PRNGKey(0))
    x_ex = jax.tree_util.tree_map(lambda a: a[0], x0_ex)
    d_ex = jax.tree_util.tree_map(lambda a: a[0], data_ex)
    solve = batched_solver(prior_residual, opts, "residuals", x_ex, d_ex)

    @jax.jit
    def bench(seed):
        key = jax.random.PRNGKey(seed)

        def body(i, carry):
            cost_sum, conv_sum, iters_sum = carry
            data, x0 = gen(jax.random.fold_in(key, i))
            # Fold the carry into the starts: a true serial dependency, so
            # XLA cannot elide or reorder repetitions.
            x0 = x0 + jnp.float32(1e-30) * cost_sum
            _, out = solve(x0, data)
            return (cost_sum + out.final_cost.cost.sum(),
                    conv_sum + out.converged().sum(),
                    iters_sum + out.num_iters.sum())

        z = jnp.float32(0.0)
        return lax.fori_loop(0, REPS, body, (z, z, z))

    jax.block_until_ready(bench(0))               # compile + warm up

    times = []
    for rep in range(5):
        t0 = time.perf_counter()
        cost_sum, conv_sum, iters_sum = jax.block_until_ready(bench(rep + 1))
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    n_solves = REPS * BATCH
    conv = float(conv_sum) / n_solves
    mean_iters = float(iters_sum) / n_solves
    solves_per_s = n_solves / dt
    print(json.dumps({
        "metric": "batched_prior50_lm_solves_per_s",
        "value": round(solves_per_s, 1),
        "unit": f"solves/s (reps={REPS} x batch={BATCH}, dims={DIMS}, f32, "
                f"conv={conv:.2f}, mean_iters={mean_iters:.1f}, "
                f"median wall={dt*1e3:.1f}ms of 5, one dispatch)",
        "vs_baseline": round(solves_per_s * REF_SOLVE_US / 1e6, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
