"""Mini bundle adjustment: joint camera-pose + landmark refinement.

The canonical large NLLS problem of the reference's domain (visual SLAM /
SfM; the reference's roadmap targets exactly this space with its sparse
solvers, reference README.md:165-167).  Formulation:

* parameters are a pytree ``{"poses": SE3 (n_cams batched), "points":
  (n_pts, 3)}`` — mixed manifold + Euclidean blocks handled by the
  manifold layer (tangent = 6·n_cams + 3·n_pts);
* observations are a DENSE (n_cams, n_pts, 2) tensor with a visibility
  mask (masked rows contribute zero residual and zero Jacobian) — the
  static-shape, matmul-friendly layout, in place of the reference-style
  sparse observation lists;
* the full solve runs through any backend: dense H for small problems,
  ``matfree_optimize`` (GN-CG) for large ones.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..manifolds import SE3, SO3


class BAData(NamedTuple):
    observations: jax.Array  #: (n_cams, n_pts, 2) pixel obs (normalized)
    mask: jax.Array          #: (n_cams, n_pts) 1.0 = visible


def project(pose: SE3, points: jax.Array) -> jax.Array:
    """Normalized pinhole projection of world points into one camera.

    ``pose`` maps world → camera; points (n, 3) → (n, 2) = (x/z, y/z).
    """
    pc = pose.rotation.apply(points) + pose.translation[None, :]
    z = jnp.maximum(pc[..., 2:3], 1e-6)
    return pc[..., :2] / z


def ba_residuals(params, data: BAData) -> jax.Array:
    """Masked reprojection residuals, flattened."""
    poses: SE3 = params["poses"]          # batched (n_cams,)
    points = params["points"]             # (n_pts, 3)

    def one_cam(q, t, obs_c, mask_c):
        pred = project(SE3(SO3(q), t), points)
        return (pred - obs_c) * mask_c[:, None]

    res = jax.vmap(one_cam)(poses.rotation.wxyz, poses.translation,
                            data.observations, data.mask)
    return res.reshape(-1)


def make_ba_problem(n_cams: int = 4, n_pts: int = 24, noise: float = 0.0,
                    visibility: float = 1.0, pose_noise: float = 0.05,
                    point_noise: float = 0.05, dtype=jnp.float64,
                    seed: int = 0):
    """Synthetic BA instance: cameras on a ring looking at a point cloud.

    Returns ``(data, x0, x_true)``.  The first camera's pose and the first
    point are NOT perturbed in ``x0`` (gauge anchoring: the global
    similarity gauge is fixed by trusting them — their columns still
    participate, mirroring the standard prior-anchored formulation).
    """
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n_pts, 3))
    pts[:, 2] += 4.0                       # cloud in front of the cameras

    poses_q, poses_t = [], []
    # Ring spacing: 0.25 rad between neighbors for small rigs (the
    # original geometry), capped to a ±0.75 rad total arc for large ones —
    # otherwise 100+ cameras wrap full turns and look away from the cloud
    # (points behind a camera project to clamped-z garbage).
    spacing = min(0.25, 1.5 / max(n_cams - 1, 1))
    for i in range(n_cams):
        ang = spacing * (i - (n_cams - 1) / 2)
        R = SO3.exp(jnp.asarray([0.0, ang, 0.0], dtype))
        c = jnp.asarray([2.0 * np.sin(ang), 0.0, 4.0 - 4.0 * np.cos(ang)],
                        dtype)
        # world->cam: x_c = R^T (x_w - c)
        Rwc = R.inverse()
        poses_q.append(Rwc.wxyz)
        poses_t.append(-Rwc.apply(c))
    true_poses = SE3(SO3(jnp.stack(poses_q)), jnp.stack(poses_t))
    true_points = jnp.asarray(pts, dtype)

    def one_cam(q, t):
        return project(SE3(SO3(q), t), true_points)

    obs = jax.vmap(one_cam)(true_poses.rotation.wxyz, true_poses.translation)
    obs = obs + noise * jnp.asarray(rng.normal(size=obs.shape), dtype)

    # Cheirality mask: only points comfortably in FRONT of a camera are
    # observed (a real SfM pipeline never keeps the rest; a near-zero
    # depth would also make the normalized projection ill-conditioned).
    def depth_cam(q, t):
        pc = SO3(q).apply(true_points) + t[None, :]
        return pc[:, 2]
    z = jax.vmap(depth_cam)(true_poses.rotation.wxyz,
                            true_poses.translation)
    mask = jnp.asarray(
        rng.uniform(size=(n_cams, n_pts)) < visibility, dtype)
    # margin > max plausible depth shift under the x0 perturbations
    mask = mask * (z > 1.0).astype(dtype)

    # Perturbed initial guess, anchored at camera 0 and point 0.
    dw = pose_noise * rng.normal(size=(n_cams, 6))
    dw[0] = 0.0
    x0_poses = jax.vmap(lambda p_q, p_t, w: SE3(SO3(p_q), p_t)
                        @ SE3.exp(jnp.asarray(w, dtype)))(
        true_poses.rotation.wxyz, true_poses.translation, jnp.asarray(dw))
    dp = point_noise * rng.normal(size=(n_pts, 3))
    dp[0] = 0.0
    x0_points = true_points + jnp.asarray(dp, dtype)

    data = BAData(obs, mask)
    x0 = {"poses": x0_poses, "points": x0_points}
    x_true = {"poses": true_poses, "points": true_points}
    return data, x0, x_true


def reprojection_rmse(params, data: BAData) -> jax.Array:
    r = ba_residuals(params, data)
    n = jnp.maximum(jnp.sum(data.mask) * 2.0, 1.0)
    return jnp.sqrt(jnp.sum(r * r) / n)


def make_ba_problem_sparse(n_cams: int = 200, n_pts: int = 2000,
                           k_obs: int = 8, noise: float = 0.0,
                           pose_noise: float = 0.02,
                           point_noise: float = 0.02,
                           dtype=jnp.float64, seed: int = 0):
    """Sparse-visibility BA in the point-major layout (ops/schur_obs.py).

    A corridor rig: cameras along a straight rail looking forward (+z),
    landmarks scattered in front of the rail, each observed by its
    ``k_obs`` nearest cameras — the visibility pattern of a real SLAM
    trajectory, O(n_pts · k_obs) observations instead of the dense
    grid's O(n_cams · n_pts).

    Returns ``((obs, cam_idx, mask), x0, x_true)`` with
    obs (n_pts, k_obs, 2), cam_idx (n_pts, k_obs) int32,
    mask (n_pts, k_obs) all-ones, and
    x0/x_true = {"poses": SE3 batch, "points": (n_pts, 3)}.
    """
    rng = np.random.default_rng(seed)
    rail = 0.5 * np.arange(n_cams)                     # camera x positions
    # landmarks spread along the rail, in front of it
    px = rng.uniform(rail[0], rail[-1] if n_cams > 1 else 1.0, n_pts)
    py = rng.uniform(-1.0, 1.0, n_pts)
    pz = rng.uniform(3.0, 5.0, n_pts)
    true_points = jnp.asarray(np.stack([px, py, pz], 1), dtype)

    # identity rotations, camera centers on the rail: x_c = x_w - c
    qs = np.zeros((n_cams, 4)); qs[:, 0] = 1.0
    ts = np.stack([-rail, np.zeros(n_cams), np.zeros(n_cams)], 1)
    true_poses = SE3(SO3(jnp.asarray(qs, dtype)), jnp.asarray(ts, dtype))

    # each landmark: k_obs cameras nearest in x
    nearest = np.clip(np.searchsorted(rail, px), 0, n_cams - 1)
    lo = np.clip(nearest - k_obs // 2, 0, max(n_cams - k_obs, 0))
    cam_idx = (lo[:, None] + np.arange(k_obs)[None, :]).astype(np.int32)

    def slot_project(q, t, pt):
        return project(SE3(SO3(q), t), pt[None, :])[0]

    obs = jax.vmap(lambda pt, cams: jax.vmap(
        lambda c: slot_project(true_poses.rotation.wxyz[c],
                               true_poses.translation[c], pt))(cams))(
        true_points, jnp.asarray(cam_idx))
    obs = obs + noise * jnp.asarray(rng.normal(size=obs.shape), dtype)
    mask = jnp.ones((n_pts, k_obs), dtype)

    # Perturbed start, camera 0 / point 0 anchored (gauge, as in
    # make_ba_problem).  LEFT-multiplicative perturbation: T' = exp(w)∘T
    # perturbs in the CAMERA frame, where the lever arm is the scene
    # depth (~4) — a right perturbation's lever arm is the camera's
    # distance to the world origin (hundreds of units down the rail),
    # which throws landmarks behind the camera.
    dw = pose_noise * rng.normal(size=(n_cams, 6))
    dw[0] = 0.0
    x0_poses = jax.vmap(lambda q, t, w: SE3.exp(jnp.asarray(w, dtype))
                        @ SE3(SO3(q), t))(
        true_poses.rotation.wxyz, true_poses.translation, jnp.asarray(dw))
    dp = point_noise * rng.normal(size=(n_pts, 3))
    dp[0] = 0.0
    x0_points = true_points + jnp.asarray(dp, dtype)

    x0 = {"poses": x0_poses, "points": x0_points}
    x_true = {"poses": true_poses, "points": true_points}
    return (obs, jnp.asarray(cam_idx), mask), x0, x_true


def reprojection_rmse_sparse(params, obs, cam_idx, mask) -> jax.Array:
    """Reprojection RMSE in the point-major layout."""
    poses, pts = params["poses"], params["points"]

    def point(pt, d_j, cams, m_j):
        def slot(c, d_k, m_k):
            return (project(SE3(SO3(poses.rotation.wxyz[c]),
                                poses.translation[c]), pt[None, :])[0]
                    - d_k) * m_k
        return jax.vmap(slot)(cams, d_j, m_j)

    r = jax.vmap(point)(pts, obs, cam_idx, mask)
    n = jnp.maximum(jnp.sum(mask) * 2.0, 1.0)
    return jnp.sqrt(jnp.sum(r * r) / n)
