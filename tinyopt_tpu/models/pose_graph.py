"""Pose-graph optimization (SLAM backend).

The second canonical large-NLLS family of the reference's domain (with
bundle adjustment): N poses on SE(3) linked by noisy relative-pose
measurements; residual of edge (i, j) with measurement Ẑᵢⱼ:

    r_ij = log(Ẑᵢⱼ⁻¹ · Xᵢ⁻¹ · Xⱼ)      ∈ ℝ⁶

Formulation: the edge list is a DENSE static (E, 2) index
array; per-edge residuals are gathered + vmapped (static shapes, batched
Lie ops), and the pose block is one batched-SE3 leaf.  Gauge freedom is
fixed by a prior residual on pose 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..manifolds import SE3, SO3


class PoseGraphData(NamedTuple):
    edges: jax.Array       #: (E, 2) int32 — (i, j) vertex indices
    meas_q: jax.Array      #: (E, 4) measured relative rotation (wxyz)
    meas_t: jax.Array      #: (E, 3) measured relative translation
    anchor_q: jax.Array    #: (4,) prior pose-0 rotation
    anchor_t: jax.Array    #: (3,) prior pose-0 translation


def _rel(poses: SE3, i, j) -> SE3:
    """Xᵢ⁻¹ · Xⱼ for gathered vertex indices."""
    qi = poses.rotation.wxyz[i]
    ti = poses.translation[i]
    qj = poses.rotation.wxyz[j]
    tj = poses.translation[j]
    Xi = SE3(SO3(qi), ti)
    Xj = SE3(SO3(qj), tj)
    return Xi.inverse() @ Xj


def pose_graph_residuals(poses: SE3, data: PoseGraphData) -> jax.Array:
    """Stacked edge residuals + the gauge-anchoring prior on pose 0."""
    def edge_res(e, q, t):
        rel = _rel(poses, e[0], e[1])
        meas_inv = SE3(SO3(q), t).inverse()
        return (meas_inv @ rel).log()

    r_edges = jax.vmap(edge_res)(data.edges, data.meas_q, data.meas_t)

    anchor = SE3(SO3(data.anchor_q), data.anchor_t)
    x0 = SE3(SO3(poses.rotation.wxyz[0]), poses.translation[0])
    r_anchor = (anchor.inverse() @ x0).log()
    return jnp.concatenate([r_edges.reshape(-1), r_anchor])


def make_pose_graph(n_poses: int = 12, extra_loops: int = 4,
                    noise: float = 0.0, init_noise: float = 0.1,
                    dtype=jnp.float64, seed: int = 0):
    """Synthetic pose graph: a chain (odometry) plus random loop closures.

    Returns ``(data, x0 poses, true poses)``.  Fully vectorized (one
    ``lax.scan`` for the chain, one vmap for the measurements) so
    thousand-pose benchmark graphs build in milliseconds.
    """
    rng = np.random.default_rng(seed)
    # Ground-truth trajectory: random smooth chain, composed by scan
    deltas = 0.4 * rng.uniform(-1, 1, (n_poses - 1, 6))
    ident = SE3.identity(dtype)

    def chain_step(carry, dlt):
        q, t = carry
        nxt = SE3(SO3(q), t) @ SE3.exp(dlt)
        out = (nxt.rotation.wxyz, nxt.translation)
        return out, out

    _, (qs, ts) = jax.lax.scan(
        chain_step, (ident.rotation.wxyz, ident.translation),
        jnp.asarray(deltas, dtype))
    true_poses = SE3(
        SO3(jnp.concatenate([ident.rotation.wxyz[None], qs])),
        jnp.concatenate([ident.translation[None], ts]))

    edges = [(k, k + 1) for k in range(n_poses - 1)]
    for _ in range(extra_loops):
        i, j = sorted(rng.choice(n_poses, size=2, replace=False))
        if j - i > 1:
            edges.append((int(i), int(j)))
    edges = np.asarray(edges, np.int32)

    dq = noise * rng.normal(size=(edges.shape[0], 6))

    def edge_meas(e, w):
        rel = _rel(true_poses, e[0], e[1])
        noisy = rel @ SE3.exp(jnp.asarray(w, dtype))
        return noisy.rotation.wxyz, noisy.translation

    meas_q, meas_t = jax.vmap(edge_meas)(jnp.asarray(edges),
                                         jnp.asarray(dq, dtype))

    data = PoseGraphData(
        edges=jnp.asarray(edges),
        meas_q=meas_q, meas_t=meas_t,
        anchor_q=true_poses.rotation.wxyz[0],
        anchor_t=true_poses.translation[0])

    # Perturbed initial guess (anchor kept exact)
    dw = init_noise * rng.normal(size=(n_poses, 6))
    dw[0] = 0.0
    x0 = jax.vmap(lambda q, t, w: SE3(SO3(q), t) @ SE3.exp(
        jnp.asarray(w, dtype)))(true_poses.rotation.wxyz,
                                true_poses.translation, jnp.asarray(dw))
    return data, x0, true_poses


def pose_graph_edge_fn(x_i: SE3, x_j: SE3, data_e) -> jax.Array:
    """One relative-pose residual log(Ẑᵢⱼ⁻¹ · Xᵢ⁻¹ · Xⱼ) for
    :func:`tinyopt_tpu.chain.chain_optimize` (``data_e = (q, t)``)."""
    q, t = data_e
    return (SE3(SO3(q), t).inverse() @ (x_i.inverse() @ x_j)).log()


def pose_graph_optimize(x0: SE3, data: PoseGraphData, options=None,
                        **kw):
    """Direct large-scale pose-graph solve via the chain solver.

    Odometry edges (j == i+1) form the block-tridiagonal backbone
    (exact one-scan Cholesky); loop closures enter through the Woodbury
    low-rank correction — per-iteration cost O(N·d³ + N·d²·m + m³),
    conditioning-independent, no dense H.  See
    :func:`tinyopt_tpu.chain.chain_optimize`.
    """
    from ..chain import chain_optimize

    # module-level anchor: a fresh closure per call would miss the
    # compiled-solve cache (sparse._SOLVE_CACHE keys on the function)
    return chain_optimize(
        x0, pose_graph_edge_fn, np.asarray(data.edges),
        (data.meas_q, data.meas_t), options,
        unary_fn=_anchor_fn, unary_nodes=np.asarray([0]),
        unary_data=(data.anchor_q[None], data.anchor_t[None]), **kw)


def _anchor_fn(x_n: SE3, dd):
    q, t = dd
    return (SE3(SO3(q), t).inverse() @ x_n).log()


def pose_graph_marginals(x: SE3, data: PoseGraphData,
                         rescaled: bool = False):
    """Per-pose (6, 6) posterior marginal covariance blocks at the
    solution — the Takahashi selected-inverse recursion off the chain
    solver's block-tridiagonal factor with the Woodbury loop-closure
    downdate (:func:`tinyopt_tpu.chain.chain_marginals`); O(N·d³),
    never densifies H.  Tangent order is the SE3 element-major layout.
    """
    from ..chain import chain_marginals

    return chain_marginals(
        x, pose_graph_edge_fn, np.asarray(data.edges),
        (data.meas_q, data.meas_t), unary_fn=_anchor_fn,
        unary_nodes=np.asarray([0]),
        unary_data=(data.anchor_q[None], data.anchor_t[None]),
        rescaled=rescaled)
