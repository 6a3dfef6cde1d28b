"""Batched solving — run: python examples/batched_solving.py

Solves 10,000 independent 50-dimensional nonlinear least-squares problems
in ONE program: the whole LM loop is vmapped, every instance with its own
λ schedule and stop reason, and with ``hessian.solver="cg"`` the damped
solves of all instances run as one batched CG call (a Triton kernel on a
GPU, ops/pallas_cg.py).  Pass ``--mesh`` to shard the batch over all
local devices (data parallelism over instances; on CPU this uses 8
simulated devices).

The reference C++ library solves these one at a time at ~56 µs each
(reference: benchmarks/dense.cpp:83-114).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


if os.environ.get("TINYOPT_CPU"):
    import jax
    jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--dims", type=int, default=50)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the batch over all local devices")
    args = ap.parse_args()

    import jax

    if args.cpu or args.mesh:
        # 8 simulated devices for the --mesh demo on CPU
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    import tinyopt_tpu as to
    from tinyopt_tpu.models.problems import make_prior_batch, prior_residual
    from tinyopt_tpu.parallel.batched import batched_optimize
    from tinyopt_tpu.parallel.mesh import make_mesh

    print(f"backend: {jax.default_backend()}, devices: {len(jax.devices())}")

    data, x0 = make_prior_batch(args.batch, args.dims,
                                dtype=jnp.float32, seed=0)
    opts = to.Options(
        max_iters=10, save_history=False,
        hessian=to.HessianOptions(solver="cg", cg_iters=8,
                                  save_last=False, carry_system=False))

    mesh = make_mesh(batch=len(jax.devices())) if args.mesh else None
    t0 = time.perf_counter()
    x_opt, out = batched_optimize(x0, prior_residual, opts,
                                  data_batch=data, mode="residuals",
                                  mesh=mesh)
    out = jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    conv = int(out.converged().sum())
    print(f"{conv}/{args.batch} converged, "
          f"mean iters {float(out.num_iters.mean()):.1f}, "
          f"max |x - y| {float(jnp.abs(x_opt - data.y).max()):.1e}")
    print(f"first call (incl. compile): {dt:.2f}s; see bench.py for "
          "steady-state timing")


if __name__ == "__main__":
    main()
