"""SO(3) rotation manifold (unit quaternion), JAX pytree + registered manifold.

The JAX equivalent of the reference's Sophus/Lie++ trait
integrations (reference: include/tinyopt/3rdparty/traits/sophus.h:14-43):
tangent dimension 3, retraction ``R ⊞ δ = R · exp(δ)`` (right-multiply),
with AD-friendly, Taylor-guarded exp/log maps.

Quaternions are stored wxyz.  All ops are batched-friendly (leading dims
broadcast), jit/vmap-safe, with no data-dependent control flow.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..manifold import Manifold, register_manifold

def _small(theta2):
    """Small-angle guard threshold, dtype-aware (f32-safe: no underflow)."""
    eps = jnp.finfo(theta2.dtype).eps
    return theta2 < eps ** 0.5


def _qmul(a, b):
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _exp_quat(w):
    """so(3) -> unit quaternion, NaN-safe under AD at θ=0.

    Uses the where-guard idiom: the singular branch never sees θ=0 (its
    operand is replaced by 1), and small angles take a Taylor series whose
    derivative is exact at 0 — both the value AND the jvp are finite, which
    is what the LM linearization at δ=0 differentiates through.
    """
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    small = _small(theta2)
    theta = jnp.sqrt(jnp.where(small, 1.0, theta2))
    half = 0.5 * theta
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    qw = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([qw, k * w], axis=-1)


def _log_quat(q):
    """Unit quaternion -> so(3) tangent (angle-axis), NaN-safe under AD."""
    qw = q[..., :1]
    qv = q[..., 1:]
    n2 = jnp.sum(qv * qv, axis=-1, keepdims=True)
    small = _small(n2)
    n = jnp.sqrt(jnp.where(small, 1.0, n2))
    angle = 2.0 * jnp.arctan2(n, jnp.abs(qw))
    # angle/n ≈ 2/|qw| · (1 − n²/(3qw²)) for small n (the overall sign(qw)
    # factor below handles the quaternion double cover)
    aqw = jnp.maximum(jnp.abs(qw), 1e-3)
    scale = jnp.where(small,
                      2.0 / aqw * (1.0 - n2 / (3.0 * aqw * aqw)),
                      angle / n)
    sign = jnp.where(qw < 0, -1.0, 1.0)
    return sign * scale * qv


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SO3:
    wxyz: jax.Array  #: (..., 4) unit quaternion, scalar-first

    @staticmethod
    def identity(dtype=jnp.float32, batch=()):
        q = jnp.zeros(batch + (4,), dtype).at[..., 0].set(1.0)
        return SO3(q)

    @staticmethod
    def exp(w) -> "SO3":
        return SO3(_exp_quat(jnp.asarray(w)))

    @staticmethod
    def from_matrix(R) -> "SO3":
        """Rotation matrix -> quaternion (Shepperd's method, branchless).

        The largest of the four quaternion components anchors the
        reconstruction (its candidate trace is positive and well away from
        zero), and the remaining components come from off-diagonal sums /
        differences divided by it — correct for ALL rotations including
        180° (where naive sign fix-ups from the antisymmetric part fail:
        those differences vanish at qw = 0).
        """
        R = jnp.asarray(R)
        m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
        m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
        m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
        t0 = 1.0 + m00 + m11 + m22
        t1 = 1.0 + m00 - m11 - m22
        t2 = 1.0 - m00 + m11 - m22
        t3 = 1.0 - m00 - m11 + m22
        ts = jnp.stack([t0, t1, t2, t3], axis=-1)

        def cand(t, a, b, c):
            s = jnp.sqrt(jnp.maximum(t, 1e-30))
            inv = 0.5 / s
            return s * 0.5, a * inv, b * inv, c * inv

        w0, x0, y0, z0 = cand(t0, m21 - m12, m02 - m20, m10 - m01)
        x1, w1, y1, z1 = cand(t1, m21 - m12, m01 + m10, m02 + m20)
        y2, w2, x2, z2 = cand(t2, m02 - m20, m01 + m10, m12 + m21)
        z3, w3, x3, y3 = cand(t3, m10 - m01, m02 + m20, m12 + m21)
        qs = jnp.stack([
            jnp.stack([w0, x0, y0, z0], axis=-1),
            jnp.stack([w1, x1, y1, z1], axis=-1),
            jnp.stack([w2, x2, y2, z2], axis=-1),
            jnp.stack([w3, x3, y3, z3], axis=-1),
        ], axis=-2)                                   # (..., 4 cases, 4)
        k = jnp.argmax(ts, axis=-1)
        q = jnp.take_along_axis(qs, k[..., None, None].repeat(4, -1),
                                axis=-2)[..., 0, :]
        return SO3(q / jnp.linalg.norm(q, axis=-1, keepdims=True))

    def log(self):
        return _log_quat(self.wxyz)

    def matrix(self):
        w, x, y, z = jnp.moveaxis(self.wxyz, -1, 0)
        row0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                          2 * (x * z + w * y)], axis=-1)
        row1 = jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                          2 * (y * z - w * x)], axis=-1)
        row2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                          1 - 2 * (x * x + y * y)], axis=-1)
        return jnp.stack([row0, row1, row2], axis=-2)

    def apply(self, p):
        """Rotate points p (..., 3)."""
        qv = self.wxyz[..., 1:]
        qw = self.wxyz[..., :1]
        t = 2.0 * jnp.cross(qv, p)
        return p + qw * t + jnp.cross(qv, t)

    def inverse(self) -> "SO3":
        return SO3(self.wxyz * jnp.asarray([1.0, -1.0, -1.0, -1.0],
                                           self.wxyz.dtype))

    def __matmul__(self, other):
        if isinstance(other, SO3):
            return SO3(_qmul(self.wxyz, other.wxyz))
        return self.apply(other)

    def normalized(self) -> "SO3":
        return SO3(self.wxyz / jnp.linalg.norm(self.wxyz, axis=-1,
                                               keepdims=True))


def _so3_dims(x: SO3) -> int:
    """3 per rotation; leading batch axes multiply (a batched SO3 leaf is
    a valid parameter block, e.g. all camera rotations at once)."""
    import numpy as _np
    return 3 * int(_np.prod(x.wxyz.shape[:-1], dtype=int))


def _so3_retract(x: SO3, delta):
    d = delta.reshape(x.wxyz.shape[:-1] + (3,)).astype(x.wxyz.dtype)
    return SO3(_qmul(x.wxyz, _exp_quat(d)))


def _so3_local(x: SO3, y: SO3):
    return _log_quat(_qmul(x.inverse().wxyz, y.wxyz)).reshape(-1)


register_manifold(SO3, Manifold(
    dims=_so3_dims,
    retract=_so3_retract,
    local=_so3_local,
))
