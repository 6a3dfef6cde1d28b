"""Robust curve fitting with M-estimators: the reference's flagship loss
use case (reference losses/robust_norms.h, README robust-norms feature),
batched.

Fits y = a·exp(b·t) to data with 25% gross outliers, three ways:

  1. plain least squares              — dragged off by the outliers
  2. Huber-whitened residuals        — outliers down-weighted
  3. Geman-McClure-whitened          — outliers effectively rejected

`robust_whiten` turns any M-estimator ρ into residual whitening
r ↦ √ρ(‖r‖²)·r̂ so the SAME LM solver minimizes Σρ(‖rᵢ‖²) — exactly how
the reference composes `*Loss` norms with NLLS (robust_norms.h:60-63).

Run: python examples/robust_curve_fit.py  (CPU or GPU)
"""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("TINYOPT_CPU"):
    # CI smoke lane: run on the CPU even where an accelerator exists
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import tinyopt_tpu as to
from tinyopt_tpu.losses.robust_norms import (geman_mcclure, huber,
                                              robust_whiten)


def make_data(n=60, outlier_frac=0.25, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.0, n)
    y = 1.7 * np.exp(0.8 * t) + rng.normal(0, 0.05, n)
    n_out = int(outlier_frac * n)
    idx = rng.choice(n, n_out, replace=False)
    y[idx] += rng.uniform(3.0, 12.0, n_out) * np.where(
        rng.uniform(size=n_out) < 0.5, -1.0, 1.0)
    return jnp.asarray(t), jnp.asarray(y)


def main():
    t, y = make_data()
    x0 = jnp.asarray([1.0, 0.5])       # (a, b)

    def residuals(x):
        return x[0] * jnp.exp(x[1] * t) - y

    def huber_res(x):
        # Per-residual Huber whitening, threshold² 0.09 (inlier noise scale)
        return jax.vmap(
            lambda r: robust_whiten(r[None], huber, 0.09))(residuals(x))

    def gm_res(x):
        return jax.vmap(
            lambda r: robust_whiten(r[None], geman_mcclure, 0.09))(
                residuals(x))

    opts = to.Options(max_iters=100, max_consec_failures=0)

    def report(name, x, out):
        print(f"{name:>14}: a={float(x[0]):7.4f} b={float(x[1]):7.4f} "
              f"(true 1.7, 0.8)  iters={int(out.num_iters)} "
              f"{out.stop_reason_description()}")

    x_ls, out = to.optimize(x0, residuals, opts)
    report("least-squares", x_ls, out)

    x_h, out = to.optimize(x0, huber_res, opts)
    report("huber", x_h, out)

    # Graduated non-convexity: Geman-McClure is strongly non-convex, so
    # start it from the (convex-ish) Huber solution — from a cold start
    # its early LM steps can push b into exp() overflow (inf residual →
    # NaN cost → SYSTEM_HAS_NAN_OR_INF stop, the reference's
    # optimizer.h:404-409 semantics), especially in f32.
    x_gm, out = to.optimize(x_h, gm_res, opts)
    report("geman-mcclure", x_gm, out)


if __name__ == "__main__":
    main()
