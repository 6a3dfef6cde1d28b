"""Canonical optimization problems.

The model zoo of this framework: every problem the reference exercises in
its tests and benchmarks, as batchable JAX residual functions —

  * sqrt2 scalar NLLS            (reference: tests/sqrt2.cpp)
  * circle fit                   (tests/circle.cpp)
  * Gaussian prior (whitened)    (benchmarks/dense.cpp:53-114 — the
                                  headline benchmark suite, dims 2..50)
  * sparse diagonal problem      (benchmarks/sparse.cpp:52-61)
  * easy suite: Rosenbrock, Plateau, Powell-singular
                                 (tests/optimize_easy.cpp)
  * hard suite: Beale, Himmelblau, Jennrich-Sampson
                                 (tests/optimize_hard.cpp)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def sqrt2_residual(x):
    return x * x - 2.0


def make_circle(n=10, r=2.0, center=(2.0, 7.0), noise=1e-5, seed=0):
    rng = np.random.default_rng(seed)
    ang = np.arange(n) * 2 * np.pi / (n - 1)
    obs = np.asarray(center)[None, :] + r * np.stack(
        [np.cos(ang), np.sin(ang)], -1)
    obs = obs + noise * rng.uniform(-1, 1, obs.shape)
    obs = jnp.asarray(obs)

    def residuals(x):
        delta = obs - x[:2][None, :]
        return jnp.sum(delta * delta, axis=-1) - x[2] * x[2]

    return residuals, jnp.array([0.0, 0.0, 1.0])


class PriorProblem(NamedTuple):
    """Whitened Gaussian prior: r = (x − y)/σ (benchmarks/dense.cpp:55-56)."""
    y: jax.Array
    inv_std: jax.Array

    def residuals(self, x):
        return (x - self.y) * self.inv_std


def make_prior_batch(batch: int, dims: int, dtype=jnp.float32, seed=0):
    """Batched Gaussian-prior instances + random starts (the bench suite)."""
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    y = jax.random.uniform(k0, (batch, dims), dtype, -1, 1)
    std = jax.random.uniform(k1, (batch, dims), dtype, 0.1, 1.1)
    x0 = jax.random.uniform(k2, (batch, dims), dtype, -1, 1)
    data = PriorProblem(y=y, inv_std=1.0 / std)
    return data, x0


def prior_residual(x, data: PriorProblem):
    return data.residuals(x)


def sparse_diag_residual(x):
    """Independent per-coordinate problem (benchmarks/sparse.cpp): block-
    diagonal JᵀJ.  r_i = x_i² − i."""
    targets = jnp.arange(1, x.shape[0] + 1, dtype=jnp.int32).astype(x.dtype)
    return x * x - targets


# ---- Easy suite (tests/optimize_easy.cpp) ----

def rosenbrock_residuals(p, a=1.0, b=100.0):
    """As NLLS residuals: [a−x, √b(y−x²)]."""
    return jnp.stack([a - p[0], jnp.sqrt(b) * (p[1] - p[0] * p[0])])


def rosenbrock_cost(p, a=1.0, b=100.0):
    return (a - p[0]) ** 2 + b * (p[1] - p[0] ** 2) ** 2


def plateau_cost(p, eps=1e-2):
    """Flat plateau with a shallow quadratic well."""
    return jnp.sum(jnp.tanh(p * p) + eps * p * p)


def powell_singular_residuals(p):
    """Powell's singular function (4 params, singular Hessian at 0)."""
    x1, x2, x3, x4 = p
    return jnp.stack([
        x1 + 10.0 * x2,
        jnp.sqrt(5.0) * (x3 - x4),
        (x2 - 2.0 * x3) ** 2,
        jnp.sqrt(10.0) * (x1 - x4) ** 2,
    ])


def easom_cost(p):
    """Easom: 1 − cos(x)cos(y)e^{−((x−π)²+(y−π)²)}, global min at (π, π)
    on a near-flat plateau (tests/optimize_easy.cpp:90-143)."""
    pi = jnp.pi
    dx = p[0] - pi
    dy = p[1] - pi
    return 1.0 - jnp.cos(p[0]) * jnp.cos(p[1]) * jnp.exp(-(dx * dx + dy * dy))


# ---- Hard suite (tests/optimize_hard.cpp) ----

def beale_residuals(p):
    x, y = p
    return jnp.stack([
        1.5 - x + x * y,
        2.25 - x + x * y * y,
        2.625 - x + x * y ** 3,
    ])


def himmelblau_residuals(p):
    x, y = p
    return jnp.stack([x * x + y - 11.0, x + y * y - 7.0])


def jennrich_sampson_residuals(p, m: int = 10):
    x1, x2 = p
    i = jnp.arange(1, m + 1, dtype=jnp.int32).astype(p.dtype)
    return 2.0 + 2.0 * i - (jnp.exp(i * x1) + jnp.exp(i * x2))


def wood_residuals(p):
    """Wood's function as 6 residuals, min at (1,1,1,1)
    (tests/optimize_hard.cpp:112-144)."""
    x1, x2, x3, x4 = p
    s10 = jnp.sqrt(10.0)
    return jnp.stack([
        10.0 * (x2 - x1 * x1),
        1.0 - x1,
        jnp.sqrt(90.0) * (x4 - x3 * x3),
        1.0 - x3,
        s10 * (x2 + x4 - 2.0),
        (x2 - x4) / s10,
    ])


def freudenstein_roth_residuals(p):
    """Freudenstein-Roth, global min at (5, 4)
    (tests/optimize_hard.cpp:155-214)."""
    x1, x2 = p
    return jnp.stack([
        x1 - 13.0 + ((5.0 - x2) * x2 - 2.0) * x2,
        x1 - 29.0 + ((x2 + 1.0) * x2 - 14.0) * x2,
    ])
