"""Registering a custom manifold parameter type.

The reference supports user parameter types through ``params_trait``
specializations (reference traits.h:103-147, tests/userdef_params.cpp);
here the same extension point is a pytree-registered class plus a
``Manifold(dims, retract, local)`` entry.  This example optimizes over
the UNIT CIRCLE S¹ — a 1-dim manifold stored as a 2-vector — fitting a
direction to noisy bearing measurements.  A Euclidean 2-vector would
drift off the circle; the manifold retraction keeps ‖x‖ = 1 exactly at
every iterate.

Run: python examples/custom_manifold.py  (CPU or GPU)
"""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("TINYOPT_CPU"):
    # CI smoke lane: run on the CPU even where an accelerator exists
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np

import tinyopt_tpu as to


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class UnitVector2:
    """A point on S¹ stored as a normalized 2-vector."""

    xy: jax.Array       #: (2,), ‖xy‖ = 1

    @staticmethod
    def from_angle(theta):
        theta = jnp.asarray(theta)
        return UnitVector2(jnp.stack([jnp.cos(theta), jnp.sin(theta)]))

    def angle(self):
        return jnp.arctan2(self.xy[1], self.xy[0])


def _retract(u: UnitVector2, delta: jax.Array) -> UnitVector2:
    """u ⊞ δ: rotate by the 1-dim tangent angle δ (exact exp map)."""
    c, s = jnp.cos(delta[0]), jnp.sin(delta[0])
    x, y = u.xy[0], u.xy[1]
    return UnitVector2(jnp.stack([c * x - s * y, s * x + c * y]))


def _local(u: UnitVector2, v: UnitVector2) -> jax.Array:
    """v ⊟ u: signed angle from u to v."""
    cross = u.xy[0] * v.xy[1] - u.xy[1] * v.xy[0]
    dot = jnp.dot(u.xy, v.xy)
    return jnp.arctan2(cross, dot)[None]


to.register_manifold(UnitVector2,
                     to.Manifold(dims=lambda u: 1, retract=_retract,
                                 local=_local))


def main():
    rng = np.random.default_rng(0)
    true_theta = 2.1
    bearings = true_theta + 0.05 * rng.normal(size=40)
    dirs = jnp.asarray(np.stack([np.cos(bearings), np.sin(bearings)], -1))

    def residuals(u: UnitVector2):
        # full direction difference (sign-unambiguous, unlike the pure
        # perpendicular component which cannot tell u from -u)
        return (dirs - u.xy[None, :]).reshape(-1)

    u0 = UnitVector2.from_angle(0.0)
    u, out = to.optimize(u0, residuals)
    print(f"estimated angle: {float(u.angle()):.4f}  (true {true_theta})")
    print(f"‖x‖ stayed on the circle: {float(jnp.linalg.norm(u.xy)):.12f}")
    print(out.stop_reason_description(), f"iters={int(out.num_iters)}")


if __name__ == "__main__":
    main()
