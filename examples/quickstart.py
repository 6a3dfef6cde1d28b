"""tinyopt_tpu quickstart — run: python examples/quickstart.py

A tour of the public surface on small problems (CPU-friendly; the same
code scales to batched/sharded accelerator execution unchanged).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# CPU: this tour's many distinct tiny solves are dominated by compile
# and dispatch, which an accelerator does not speed up.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import tinyopt_tpu as to


def main():
    # --- 1. The easy way: what's the square root of 2? ---
    x, out = to.optimize(jnp.asarray(1.0), lambda x: x * x - 2.0)
    print(f"sqrt(2) ≈ {float(x):.12f}   {out}")

    # --- 2. Circle fit with robust outlier rejection ---
    from tinyopt_tpu.losses import robust_norms
    from tinyopt_tpu.models.problems import make_circle

    residuals, x0 = make_circle(n=16, noise=1e-3)

    def robust_res(p):
        r = residuals(p)
        return jax.vmap(lambda ri: robust_norms.robust_whiten(
            ri[None], robust_norms.huber, 25.0)[0])(r)

    circ, out = to.optimize(x0, robust_res,
                            to.Options(lm=to.LMOptions(damping_init=1e1)))
    print(f"circle: center=({float(circ[0]):.3f}, {float(circ[1]):.3f}) "
          f"r={abs(float(circ[2])):.3f}   {out}")

    # --- 3. SE(3) pose refinement on the manifold ---
    from tinyopt_tpu.manifolds import SE3

    prior_inv = SE3.exp(jnp.asarray([0.1, -0.2, 0.3, 0.05, 0.1, -0.05]))
    pose, out = to.optimize(SE3.identity(jnp.float64),
                            lambda T: (prior_inv @ T).log())
    print(f"pose error: {float(jnp.linalg.norm((pose @ prior_inv).log())):.2e}"
          f"   {out}")

    # --- 4. Batched: 512 solves in one compiled program ---
    starts = jnp.linspace(0.5, 4.0, 512)
    # max_consec_failures=0: far starts need unlimited λ escalation
    solve = to.build_solver(lambda x: x * x - 2.0,
                            to.Options(max_consec_failures=0),
                            "residuals", starts[0])
    xs, outs = jax.jit(jax.vmap(solve))(starts)
    print(f"batched: {int(outs.converged().sum())}/512 converged, "
          f"max err {float(jnp.max(jnp.abs(xs - np.sqrt(2)))):.1e}")

    # --- 5. Covariance of a whitened prior ---
    cov = jnp.array([[2.0, 0.3], [0.3, 1.5]])
    y = jnp.array([1.0, -2.0])
    x, out = to.optimize(jnp.zeros(2),
                         lambda p: to.losses.maha_whitened(p - y, cov))
    print(f"posterior covariance ≈ prior covariance: "
          f"{np.allclose(np.asarray(out.covariance()), np.asarray(cov), atol=1e-6)}")

    # --- 6. Differentiable solve (bilevel) ---
    solve = to.implicit_solver(lambda x, th: x * x - th,
                               x_example=jnp.ones(1))
    g = jax.grad(lambda th: solve(th, jnp.ones(1))[0])(jnp.asarray([4.0]))
    print(f"d sqrt(th)/dth at th=4: {float(g[0]):.4f} (analytic 0.25)")

    # --- 7. Native µs-scale host solve ---
    from tinyopt_tpu import native
    us = native.bench_sqrt2_us(1.0, reps=10_000)
    print(f"native sqrt2 solve: {us:.2f} µs "
          f"(reference C++ library: 0.79 µs)")


if __name__ == "__main__":
    main()
