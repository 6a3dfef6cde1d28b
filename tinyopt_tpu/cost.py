"""Cost value + metadata.

Mirrors the reference ``tinyopt::Cost`` struct (reference:
include/tinyopt/cost.h:18-99): a scalar cost, the number of residuals it was
accumulated from, and an inlier ratio (meaningful when robust norms are
used).  Here it is a JAX pytree dataclass so it can live inside jitted
loops; ``num_residuals`` is a traced int32 so batched problems can carry
per-instance counts.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def rss(r) -> jax.Array:
    """Σ r² — elementwise square + sum for f32, vdot otherwise.

    For FLOAT32, never jnp.vdot(r, r): vdot lowers to dot_general, and
    at DEFAULT precision a GPU may round f32 dot_general OPERANDS to TF32
    (10-bit mantissa, ~1e-3 relative error per element).  The
    optimizer's accept/reject compares candidate costs whose difference
    near convergence is far smaller, so a rounded cost makes LM
    mis-classify good steps and stall.  square+sum stays elementwise in
    full f32 with f32 accumulation.

    For FLOAT64 the rounding does not apply (f64 dots take a separate
    exact path), so vdot is kept — switching the reduction order there
    changes eps-level cost differences enough to alter razor-edge f64
    trajectories (it regressed the Jennrich-Sampson singular-endgame
    dogleg spec from the 124.362 optimum to a 124.79 stall).
    """
    r = jnp.ravel(r)
    if r.dtype == jnp.float32:
        return jnp.sum(jnp.square(r))
    return jnp.vdot(r, r)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Cost:
    cost: jax.Array                 #: scalar cost value
    num_residuals: jax.Array        #: number of residuals (int32)
    inlier_ratio: jax.Array         #: ratio of inlier residuals in [0, 1]
    #: user-extensible log suffix (reference cost.h:96 ``log_str``);
    #: static (a Python string cannot be traced), so it must be the same
    #: for every instance of a jitted solve
    log_str: str = dataclasses.field(default="",
                                     metadata=dict(static=True))

    @staticmethod
    def make(cost, num_residuals=1, inlier_ratio=1.0,
             log_str: str = "") -> "Cost":
        return Cost(
            cost=jnp.asarray(cost),
            num_residuals=jnp.asarray(num_residuals, jnp.int32),
            inlier_ratio=jnp.asarray(inlier_ratio, jnp.float32),
            log_str=log_str,
        )

    @staticmethod
    def from_residuals(residuals, inlier_ratio=1.0) -> "Cost":
        """Cost = squared L2/Frobenius norm of the residuals (cost.h:28-31)."""
        r = jnp.ravel(residuals)
        return Cost.make(rss(r), r.size, inlier_ratio)

    def __add__(self, other: "Cost") -> "Cost":
        """Accumulate two partial costs, merging inlier counts
        (reference: cost.h:51-64)."""
        n = self.num_residuals + other.num_residuals
        inl = (self.num_inliers() + other.num_inliers()).astype(jnp.float32)
        ratio = jnp.where(n > 0, inl / jnp.maximum(n, 1).astype(jnp.float32),
                          jnp.float32(1.0))
        # log_str merge with a separator, skipping empties (cost.h:55)
        sep = " " if (self.log_str and other.log_str) else ""
        return Cost(cost=self.cost + other.cost, num_residuals=n,
                    inlier_ratio=ratio,
                    log_str=self.log_str + sep + other.log_str)

    def is_valid(self):
        """n > 0 and cost below the float max sentinel (cost.h:83)."""
        return (self.num_residuals > 0) & (self.cost < jnp.finfo(self.cost.dtype).max)

    def num_inliers(self):
        return (self.num_residuals * self.inlier_ratio).astype(jnp.int32)

    def num_outliers(self):
        return (self.num_residuals * (1.0 - self.inlier_ratio)).astype(jnp.int32)

    def __float__(self):
        return float(self.cost)

    def to_string(self, label: str = "ε", print_inliers: bool = False) -> str:
        n = int(self.num_residuals)
        s = f"{label}:{float(self.cost):.4e}, n:{n}"
        if n > 1:
            s += f", √{label}/n:{float(jnp.sqrt(self.cost / n)):.2e}"
        if print_inliers:
            s += f", in:{float(self.inlier_ratio) * 100:.2f}% ({int(self.num_inliers())})"
        if self.log_str:
            s += " " + self.log_str
        return s


def normalize_cost(cost: Cost, opts) -> Cost:
    """Apply the cost-scaling options (reference: solvers/base.h:41-45).

    Order matches the reference: optional sqrt (if not use_squared_norm),
    then ×0.5, then ÷n.
    """
    c = cost.cost
    if not opts.use_squared_norm:
        c = jnp.sqrt(c)
    if opts.downscale_by_2:
        c = 0.5 * c
    if opts.normalize:
        n = jnp.maximum(cost.num_residuals, 1).astype(c.dtype)
        c = c / n
    return dataclasses.replace(cost, cost=c)
