"""Iterative Closest Point (ICP) — point-cloud registration, batched.

The reference's manifold tests stop at pose priors (tests/sophus.cpp);
ICP is the model family those building blocks exist for: align a source
cloud to a destination cloud with UNKNOWN correspondences by alternating

  1. correspondence search: nearest destination point for every
     (currently-transformed) source point — computed as one dense
     (N, M) squared-distance matrix whose cross term is a single
     matmul (brute force IS the accelerator's spatial query:
     tree-based neighbor search does not vectorize at all);
  2. pose refinement: damped Gauss-Newton/LM on the SE(3) tangent for
     the point-to-point residuals of the matched pairs, with optional
     per-point Huber whitening for outlier/partial-overlap robustness.

The WHOLE alternation is one jitted ``lax.fori_loop`` whose body embeds
the full inner LM solve (optimizers/loop.py) — ICP compiles to a single
XLA program, and ``jax.vmap(icp)`` registers thousands of cloud pairs
concurrently.  No reference counterpart (SURVEY.md §2.3 regime).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import manifold as mf
from ..diff.auto import make_nlls_system
from ..losses.robust_norms import huber, robust_whiten
from ..manifolds import SE3, SO3
from ..optimizers.loop import optimize_from_acc
from ..options import Options


def nearest_neighbors(src: jax.Array, dst: jax.Array) -> jax.Array:
    """Index of the nearest ``dst`` point for every ``src`` point.

    ‖s − d‖² = ‖s‖² − 2·s·d + ‖d‖²; the (N, M) cross term is one
    matmul and the row argmin vectorizes.
    """
    acc_t = jnp.promote_types(src.dtype, jnp.float32)
    cross = jnp.matmul(src, dst.T, preferred_element_type=acc_t)
    d2 = (jnp.sum(src * src, axis=-1)[:, None]
          - 2.0 * cross + jnp.sum(dst * dst, axis=-1)[None, :])
    return jnp.argmin(d2, axis=-1)


def _transform(pose: SE3, pts: jax.Array) -> jax.Array:
    return pose.rotation.apply(pts) + pose.translation[..., None, :]


def icp_residual(pose: SE3, src: jax.Array, matched_dst: jax.Array,
                 robust_th: float | None = None) -> jax.Array:
    """Point-to-point residuals T·sᵢ − dᵢ, optionally Huber-whitened per
    point (threshold ``robust_th`` on the point distance)."""
    r = _transform(pose, src) - matched_dst          # (N, 3)
    if robust_th is not None:
        r = jax.vmap(lambda ri: robust_whiten(ri, huber,
                                              robust_th * robust_th))(r)
    return r.reshape(-1)


def icp(src: jax.Array, dst: jax.Array, pose0: SE3 | None = None,
        options: Options | None = None, *, n_outer: int = 10,
        robust_th: float | None = None):
    """Register ``src`` (N, 3) onto ``dst`` (M, 3).  Returns
    ``(pose, Output)`` where ``pose`` maps source into destination frame
    and ``Output`` is the final inner solve's report.

    Jit/vmap-compatible: wrap in ``jax.vmap`` for batched registration
    (the correspondence matmul batches to (B, N, M)).

    ICP is non-convex: a far initial pose can land in a correspondence
    local minimum (most random 0.3-scale poses register to <0.01 from
    identity; the rest need a better start).
    Use :func:`icp_multi_start` or a global initializer when the prior
    pose is weak.
    """
    options = options or Options(max_iters=8, max_consec_failures=0)
    if pose0 is None:
        pose0 = SE3.identity(jnp.result_type(src.dtype, jnp.float32))
    spec = mf.tangent_spec(pose0)

    def inner_solve(pose, matched):
        res = partial(icp_residual, src=src, matched_dst=matched,
                      robust_th=robust_th)
        acc, ev, _ = make_nlls_system(lambda p: res(p), pose, spec)
        return optimize_from_acc(pose, acc, ev, options, spec)

    def outer_body(i, pose):
        idx = nearest_neighbors(_transform(pose, src), dst)
        pose_new, _ = inner_solve(pose, dst[idx])
        return pose_new

    pose = jax.lax.fori_loop(0, max(n_outer - 1, 0), outer_body, pose0)
    idx = nearest_neighbors(_transform(pose, src), dst)
    return inner_solve(pose, dst[idx])


def icp_multi_start(src: jax.Array, dst: jax.Array, n_starts: int = 8,
                    options: Options | None = None, *, n_outer: int = 10,
                    robust_th: float | None = None, spread: float = 0.5,
                    seed: int = 0):
    """ICP from ``n_starts`` rotated initial poses, keeping the lowest
    final cost — the standard escape from correspondence local minima
    when no pose prior exists.  All starts run concurrently under one
    vmapped XLA program (to.multi_start_optimize's pattern applied to
    the alternation).  Returns ``(pose, Output)`` of the winner."""
    dtype = jnp.result_type(src.dtype, jnp.float32)
    key = jax.random.PRNGKey(seed)
    w = spread * jax.random.normal(key, (n_starts - 1, 6), dtype)
    w = jnp.concatenate([jnp.zeros((1, 6), dtype), w])   # identity first

    def one(wi):
        return icp(src, dst, SE3.exp(wi), options, n_outer=n_outer,
                   robust_th=robust_th)

    poses, outs = jax.vmap(one)(w)
    best = jnp.argmin(outs.final_cost.cost)
    pose = jax.tree_util.tree_map(lambda a: a[best], poses)
    out = jax.tree_util.tree_map(lambda a: a[best], outs)
    return pose, out


class ICPProblem(NamedTuple):
    src: jax.Array       #: (..., N, 3)
    dst: jax.Array       #: (..., M, 3)
    true_pose: SE3


def make_icp_problem(batch: int | None = None, n_src: int = 128,
                     n_dst: int = 160, noise: float = 1e-3,
                     outlier_frac: float = 0.0, pose_scale: float = 0.3,
                     dtype=jnp.float32, seed: int = 0) -> ICPProblem:
    """Synthetic registration instances: ``dst`` is a transformed superset
    of ``src`` with noise and optional gross outliers (partial overlap:
    ``n_dst > n_src`` adds unmatched structure)."""
    shape = () if batch is None else (batch,)
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    dst = jax.random.uniform(ks[0], shape + (n_dst, 3), dtype, -1, 1)
    w = pose_scale * jax.random.uniform(ks[1], shape + (6,), dtype, -1, 1)
    true_pose = SE3.exp(w)
    # src = T⁻¹ · (first n_src dst points) + noise, so T·src ≈ dst[:n_src]
    inv = true_pose.inverse()
    sub = dst[..., :n_src, :]
    if batch is None:
        src = inv.rotation.apply(sub) + inv.translation[None, :]
    else:
        src = (SO3(inv.rotation.wxyz[:, None, :]).apply(sub)
               + inv.translation[:, None, :])
    src = src + noise * jax.random.normal(ks[2], src.shape, dtype)
    if outlier_frac > 0:
        n_out = int(outlier_frac * n_src)
        out_pts = jax.random.uniform(ks[3], shape + (n_out, 3), dtype,
                                     -4, 4)
        src = jnp.concatenate([src[..., n_out:, :], out_pts], axis=-2)
    return ICPProblem(src=src, dst=dst, true_pose=true_pose)
