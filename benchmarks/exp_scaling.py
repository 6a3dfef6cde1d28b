"""Weak-scaling measurement of the two scale-out axes (BASELINE.md:38-41).

Weak scaling of both parallel axes on a virtual-device mesh (CPU):

  * **Virtual-device mesh (CPU)** — weak scaling of both parallel axes
     over ``xla_force_host_platform_device_count`` devices:
       * dp:    batched instances sharded over the mesh (zero cross-device
                communication; the scaling limit is pure runtime overhead),
       * block: residual blocks of ONE problem with psum-reduced (JtJ, JtR)
                normal equations (one collective per iteration).
     Per-device throughput at n devices vs 1 device.  CAVEAT: virtual
     devices share host cores — on a host with fewer idle cores than
     devices the raw efficiency measures core contention, not framework
     serialization.  The core-adjusted column divides by the ideal
     core-limited ceiling min(1, cores/n) and is the framework-attributable
     number.

Real cards: ``python chip_smoke.py --cards 4`` runs the dp and the
landmark-sharded BA paths on four GPUs against one.

Usage:
  python benchmarks/exp_scaling.py            # CPU virtual-mesh axes
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DIMS = 12
ITERS = 8          # all stop criteria disabled -> exactly ITERS per solve


def _ensure_cpu_devices(n: int) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


def _fixed_iter_options():
    """Deterministic work: every instance runs exactly ITERS iterations."""
    import tinyopt_tpu as to
    return to.Options(
        max_iters=ITERS, min_error=0.0, min_rerr_dec=0.0,
        min_step_norm2=0.0, min_grad_norm2=0.0, max_consec_failures=3,
        save_history=False,
        hessian=to.HessianOptions(save_last=False, solver="cg", cg_iters=8,
                                  carry_system=False))


def _time_min(fn, reps: int = 7) -> float:
    import jax
    jax.block_until_ready(fn())          # warm-up / compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def measure_dp(n_list=(1, 2, 4, 8), per_dev: int = 4096,
               reps: int = 7) -> dict:
    """Weak scaling of the batched-instance (dp) axis on the local mesh.

    Returns {n: iterations_per_second_total}.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from tinyopt_tpu.models.problems import make_prior_batch, prior_residual
    from tinyopt_tpu.parallel.batched import batched_solver

    opts = _fixed_iter_options()
    devs = jax.devices()
    out = {}
    for n in n_list:
        if n > len(devs):
            continue
        B = per_dev * n
        data, x0 = make_prior_batch(B, DIMS, dtype=jnp.float32, seed=1)
        mesh = Mesh(np.asarray(devs[:n]), ("batch",))
        sh = NamedSharding(mesh, P("batch"))
        x0 = jax.device_put(x0, sh)
        data = jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), data)
        x_ex = jax.tree_util.tree_map(lambda a: a[0], x0)
        d_ex = jax.tree_util.tree_map(lambda a: a[0], data)
        solve = jax.jit(batched_solver(prior_residual, opts, "residuals",
                                       x_ex, d_ex))
        wall = _time_min(lambda: solve(x0, data), reps)
        out[n] = B * ITERS / wall
    return out


def measure_block(n_list=(1, 2, 4, 8), per_dev_blocks: int = 256,
                  block_m: int = 64, reps: int = 7) -> dict:
    """Weak scaling of the residual-block (psum) axis.

    One problem; blocks grow with the mesh (per-device block count fixed),
    so per-device accumulate work is constant and the psum is the only
    cross-device cost.  Returns {n: block_iterations_per_second_total}
    (block-iterations = n_blocks x ITERS).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import tinyopt_tpu as to
    from tinyopt_tpu.parallel.sharded import make_block_system
    from tinyopt_tpu.optimizers.loop import optimize_from_acc
    from tinyopt_tpu import manifold as mf

    opts = _fixed_iter_options()
    devs = jax.devices()
    rng = np.random.default_rng(0)
    x0 = jnp.zeros((DIMS,), jnp.float32)
    spec = mf.tangent_spec(x0)
    out = {}
    for n in n_list:
        if n > len(devs):
            continue
        n_blocks = per_dev_blocks * n
        obs = jnp.asarray(rng.uniform(-1, 1, (n_blocks, block_m, DIMS)),
                          jnp.float32)

        def block_fn(x, block_obs):
            return (block_obs - x[None, :]).reshape(-1)

        mesh = Mesh(np.asarray(devs[:n]), ("block",))
        from jax.sharding import NamedSharding, PartitionSpec as P
        obs = jax.device_put(obs, NamedSharding(mesh, P("block")))
        acc, ev, _ = make_block_system(block_fn, obs, x0, mesh, "block",
                                       spec)
        solve = jax.jit(
            lambda x: optimize_from_acc(x, acc, ev, opts, spec))
        wall = _time_min(lambda: solve(x0), reps)
        out[n] = n_blocks * ITERS / wall
    return out


def measure_schur(n_list=(1, 2, 4, 8), per_dev_landmarks: int = 512,
                  n_cams: int = 12, reps: int = 5) -> dict:
    """Weak scaling of the landmark-sharded Schur BA axis.

    One BA problem; landmarks grow with the mesh (per-device count fixed),
    so per-device linearize/eliminate work is constant and the two psums
    + KB-scale all_gathers are the only cross-device cost.  Returns
    {n: landmark_iterations_per_second_total}.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tinyopt_tpu.models.bundle_adjustment import make_ba_problem, project
    from tinyopt_tpu.parallel.schur import sharded_schur_optimize

    opts = _fixed_iter_options()
    # the Schur path materializes no dense H; carry the system as usual
    import dataclasses
    opts = opts.replace(hessian=dataclasses.replace(
        opts.hessian, carry_system=True))
    devs = jax.devices()
    out = {}
    for n in n_list:
        if n > len(devs):
            continue
        n_pts = per_dev_landmarks * n
        data, x0, _ = make_ba_problem(n_cams=n_cams, n_pts=n_pts,
                                      noise=1e-3, seed=3, dtype=jnp.float32)

        def pair_fn(pose, point, obs):
            return project(pose, point[None, :])[0] - obs

        mesh = Mesh(np.asarray(devs[:n]), ("block",))
        xt = (x0["poses"], x0["points"])

        def run():
            x, o = sharded_schur_optimize(
                xt, pair_fn, data.observations, data.mask, opts,
                mesh=mesh, axis="block")
            return x[1]

        wall = _time_min(run, reps)
        out[n] = n_pts * ITERS / wall
    return out


def measure_schur_obs(n_list=(1, 2, 4, 8), per_dev_landmarks: int = 1024,
                      n_cams: int = 12, k_obs: int = 4,
                      reps: int = 5) -> dict:
    """Weak scaling of the landmark-sharded SPARSE-OBSERVATION Schur BA
    axis (parallel/schur_obs.py — the point-major production layout).

    One corridor BA problem; landmarks grow with the mesh (per-device
    count fixed) so per-device slab-kernel work is constant; the single
    camera-partial psum, the reduced-system psum and the KB-scale
    all_gathers are the only cross-device cost.  Returns
    {n: landmark_iterations_per_second_total}.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tinyopt_tpu.models.bundle_adjustment import (
        make_ba_problem_sparse, project)
    from tinyopt_tpu.parallel.schur_obs import sharded_schur_sparse_optimize

    opts = _fixed_iter_options()
    import dataclasses
    opts = opts.replace(hessian=dataclasses.replace(
        opts.hessian, carry_system=True))
    devs = jax.devices()
    out = {}
    for n in n_list:
        if n > len(devs):
            continue
        n_pts = per_dev_landmarks * n
        (obs, cam_idx, mask), x0, _ = make_ba_problem_sparse(
            n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=1e-3, seed=3,
            dtype=jnp.float32)

        def pair_fn(pose, point, ob):
            return project(pose, point[None, :])[0] - ob

        mesh = Mesh(np.asarray(devs[:n]), ("block",))
        xt = (x0["poses"], x0["points"])

        def run():
            x, o = sharded_schur_sparse_optimize(
                xt, pair_fn, obs, cam_idx, mask, opts,
                mesh=mesh, axis="block", chunk=per_dev_landmarks)
            return x[1]

        wall = _time_min(run, reps)
        out[n] = n_pts * ITERS / wall
    return out


def _report(axis: str, thpt: dict, cores: int) -> list:
    rows = []
    base = thpt.get(1)
    for n, t in sorted(thpt.items()):
        per_dev = t / n
        eff = per_dev / (base if base else per_dev)
        ceiling = min(1.0, cores / n)
        rows.append({"axis": axis, "n_devices": n,
                     "total_iters_per_s": round(t),
                     "per_device_iters_per_s": round(per_dev),
                     "efficiency": round(eff, 3),
                     "core_adjusted_efficiency": round(eff / ceiling, 3),
                     "host_cores": cores})
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--per-dev", type=int, default=4096)
    args = ap.parse_args()

    _ensure_cpu_devices(args.devices)
    cores = os.cpu_count() or 1
    for row in _report("dp", measure_dp(per_dev=args.per_dev), cores):
        print(json.dumps(row))
    for row in _report("block", measure_block(), cores):
        print(json.dumps(row))
    for row in _report("schur", measure_schur(), cores):
        print(json.dumps(row))
    for row in _report("schur_obs", measure_schur_obs(), cores):
        print(json.dumps(row))
    # PARITY.md protocol rows (r4): schur_obs n=2 efficiency vs slab
    # size (the replicated-reduced-solve amortization claim, VERDICT
    # #6a) and dp n=2 as min/median of 5 trials (VERDICT #6b).
    for per_dev in (1024, 4096, 8192):
        t = measure_schur_obs(n_list=(1, 2), per_dev_landmarks=per_dev,
                              reps=3)
        print(json.dumps({"axis": "schur_obs_slab",
                          "per_dev_landmarks": per_dev,
                          "n2_efficiency": round(t[2] / 2 / t[1], 3)}))
    effs = sorted(
        (lambda t: t[2] / 2 / t[1])(
            measure_dp(n_list=(1, 2), per_dev=args.per_dev, reps=7))
        for _ in range(5))
    print(json.dumps({"axis": "dp_n2_trials", "min": round(effs[0], 3),
                      "median": round(effs[2], 3),
                      "max": round(effs[-1], 3)}))


if __name__ == "__main__":
    main()
