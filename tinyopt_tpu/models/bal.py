"""Bundle Adjustment in the Large (BAL) camera model + problem loader.

The canonical large-scale BA benchmark (Agarwal, Snavely, Seitz,
Szeliski, "Bundle Adjustment in the Large", ECCV 2010;
grail.cs.washington.edu/projects/bal) — the dataset family the
point-major layout of ops/schur_obs.py is built for, and the regime the
reference concedes outright ("not fast for large systems yet",
/root/reference/README.md:30).

Camera model (the BAL convention, 9 parameters):

* ``R`` — world→camera rotation (the file stores a Rodrigues
  angle-axis vector; in-memory we keep an :class:`~tinyopt_tpu
  .manifolds.SO3` quaternion — the batched form whose
  retraction already runs inside the fused kernels),
* ``t`` — translation, ``P = R·X + t``,
* ``f, k1, k2`` — focal length and two radial-distortion coefficients:
  ``p = -(P.x, P.y)/P.z`` (BAL cameras look down −z, hence the minus),
  ``r(p) = 1 + k1·‖p‖² + k2·‖p‖⁴``, ``p' = f·r(p)·p``.

Per-camera parameters are the pytree ``{"pose": SE3, "intr": (3,)}`` —
tangent dims 6 + 3 = 9, exactly the BAL parameterization, handled by
the generic manifold layer (schur_obs accepts any per-camera pytree).

:func:`load_bal` reads the published text format straight into the
point-major padded layout (obs (n_pts, K, 2), cam_idx, mask);
:func:`write_bal` emits it (round-trip tested).  :func:`make_bal_problem`
generates synthetic instances in the same convention, with optional
gross outliers for robust/GNC validation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..manifolds import SE3, SO3


def bal_project(camera, point: jax.Array) -> jax.Array:
    """Project one world point through one BAL camera → (2,) pixels.

    ``camera`` = {"pose": SE3 (world→cam), "intr": (f, k1, k2)}.
    """
    pose: SE3 = camera["pose"]
    f, k1, k2 = (camera["intr"][0], camera["intr"][1], camera["intr"][2])
    P = pose.rotation.apply(point[None, :])[0] + pose.translation
    # BAL looks down −z: z is negative for points in front of the camera.
    z = P[2]
    z = jnp.where(jnp.abs(z) < 1e-8, jnp.where(z < 0, -1e-8, 1e-8), z)
    p = -P[:2] / z
    n2 = p[0] * p[0] + p[1] * p[1]
    r = 1.0 + k1 * n2 + k2 * n2 * n2
    return f * r * p


def bal_residual(camera, point: jax.Array, obs: jax.Array) -> jax.Array:
    """Reprojection residual — the ``pair_fn`` for the Schur BA paths."""
    return bal_project(camera, point) - obs


def _axis_angle_to_wxyz(aa: np.ndarray) -> np.ndarray:
    """Rodrigues vectors (n, 3) → quaternions (n, 4) wxyz (host-side)."""
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    half = 0.5 * theta
    # sinc form is exact at theta→0
    small = theta < 1e-12
    k = np.where(small, 0.5, np.sin(half) / np.where(small, 1.0, theta))
    return np.concatenate([np.cos(half), k * aa], axis=1)


def _wxyz_to_axis_angle(q: np.ndarray) -> np.ndarray:
    """Quaternions (n, 4) wxyz → Rodrigues vectors (n, 3) (host-side)."""
    q = q * np.sign(q[:, :1] + (q[:, :1] == 0))    # w >= 0 branch
    w = np.clip(q[:, :1], -1.0, 1.0)
    v = q[:, 1:]
    vn = np.linalg.norm(v, axis=1, keepdims=True)
    theta = 2.0 * np.arctan2(vn, w)
    small = vn < 1e-12
    return np.where(small, 2.0 * v, theta * v / np.where(small, 1.0, vn))


def cameras_from_bal(params9: np.ndarray, dtype=jnp.float64):
    """(n_cams, 9) BAL rows [aa(3), t(3), f, k1, k2] → batched pytree."""
    params9 = np.asarray(params9, np.float64)
    q = _axis_angle_to_wxyz(params9[:, :3])
    return {
        "pose": SE3(SO3(jnp.asarray(q, dtype)),
                    jnp.asarray(params9[:, 3:6], dtype)),
        "intr": jnp.asarray(params9[:, 6:9], dtype),
    }


def cameras_to_bal(cameras) -> np.ndarray:
    """Batched camera pytree → (n_cams, 9) BAL parameter rows."""
    q = np.asarray(cameras["pose"].rotation.wxyz, np.float64)
    t = np.asarray(cameras["pose"].translation, np.float64)
    intr = np.asarray(cameras["intr"], np.float64)
    return np.concatenate([_wxyz_to_axis_angle(q), t, intr], axis=1)


def _to_point_major(cam_i: np.ndarray, pt_i: np.ndarray,
                    xy: np.ndarray, n_pts: int, K: int | None, dtype):
    """Observation triplets → point-major padded (obs, cam_idx, mask)."""
    order = np.argsort(pt_i, kind="stable")
    cam_i, pt_i, xy = cam_i[order], pt_i[order], xy[order]
    counts = np.bincount(pt_i, minlength=n_pts)
    kmax = int(counts.max()) if len(counts) else 0
    if K is None:
        K = kmax
    elif kmax > K:
        raise ValueError(
            f"K={K} < densest landmark's {kmax} observations")
    slot = np.arange(len(pt_i)) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])[pt_i]
    cam_idx = np.zeros((n_pts, K), np.int32)
    mask = np.zeros((n_pts, K), np.float64)
    obs = np.zeros((n_pts, K, 2), np.float64)
    cam_idx[pt_i, slot] = cam_i
    mask[pt_i, slot] = 1.0
    obs[pt_i, slot] = xy
    return (jnp.asarray(obs, dtype), jnp.asarray(cam_idx),
            jnp.asarray(mask, dtype))


def load_bal(path: str, dtype=jnp.float64, K: int | None = None,
             layout: str = "padded", bucket_growth: float = 2.0,
             min_bucket: int = 256):
    """Read a BAL problem file into the point-major layout.

    Format (grail.cs.washington.edu/projects/bal): a header
    ``n_cams n_pts n_obs``, then ``n_obs`` lines ``cam_idx pt_idx x y``,
    then ``9·n_cams`` camera parameters (one number per line: angle-axis
    rotation, translation, f, k1, k2) and ``3·n_pts`` point coordinates.
    ``.bz2`` paths (the published files' compression) are decompressed
    transparently; parsing is one vectorized numpy pass (~tens of MB/s
    — the published files are 100 MB-1 GB).

    ``layout="padded"`` returns ``((obs, cam_idx, mask), x0)`` for
    :func:`tinyopt_tpu.schur_sparse_optimize` — one slab padded to
    ``K`` (default: the densest landmark's count; raises if capped
    below it).  Published BAL visibility is heavy-tailed (mean ~6
    obs/landmark, max in the hundreds), which inflates the single slab
    10-50×: ``layout="bucketed"`` instead returns ``(slabs, x0)`` for
    :func:`tinyopt_tpu.schur_sparse_optimize_buckets` — landmarks
    grouped by observation count into a few padded slabs with caps
    growing by ``bucket_growth`` (total slots ~growth× the observation
    count, independent of the densest landmark).

    ``x0 = (cameras, points)`` in the file's original ordering for
    both layouts.
    """
    cam_i, pt_i, xy, params9, pts = _parse_bal(path)
    n_pts = pts.shape[0]
    x0 = (cameras_from_bal(params9, dtype), jnp.asarray(pts, dtype))
    if layout == "padded":
        return _to_point_major(cam_i, pt_i, xy, n_pts, K, dtype), x0
    if layout != "bucketed":
        raise ValueError(f"layout must be padded|bucketed, got {layout!r}")
    # bucket DIRECTLY from the observation triplets — the dense
    # (n_pts, K_max) intermediate would itself be the 10-50× blow-up
    # (venice-scale: ~GBs of host padding) this layout avoids.
    from ..ops.schur_obs import bucket_caps
    counts = np.bincount(pt_i, minlength=n_pts)
    cap_of, used = bucket_caps(counts, bucket_growth, min_bucket)
    slabs = []
    cap_of_rows = cap_of[pt_i]
    for cap in used:
        ids = np.nonzero(cap_of == cap)[0]
        sel = cap_of_rows == cap
        pt_b = np.searchsorted(ids, pt_i[sel])
        slab = _to_point_major(cam_i[sel], pt_b, xy[sel], len(ids),
                               cap, dtype)
        slabs.append(slab + (ids,))
    return slabs, x0


def _parse_bal(path: str):
    """Parse a BAL text file → (cam_i, pt_i, xy, params9, pts) numpy.

    One ``np.fromstring(..., sep=" ")`` call parses the whole token
    stream at C speed (~100 MB/s) — the published files are 100 MB–1 GB
    and a Python token loop needs minutes on them.  All BAL tokens are
    plain decimals, and the observation indices
    round-trip exactly through float64 (< 2⁵³).
    """
    if str(path).endswith(".bz2"):
        import bz2
        opener = bz2.open
    else:
        opener = open
    with opener(path, "rt") as fh:
        text = fh.read()
    import warnings
    try:
        with warnings.catch_warnings():
            # np.fromstring's BINARY mode is deprecated; text mode (sep
            # set) is not, but some numpy versions warn on any use.
            warnings.simplefilter("ignore", DeprecationWarning)
            vals = np.fromstring(text, dtype=np.float64, sep=" ")
    except Exception:
        # fromstring may be removed in a future numpy: parse the token
        # stream via str.split (also C-speed; higher transient memory).
        vals = np.array(text.split(), dtype=np.float64)
    del text
    n_cams, n_pts, n_obs = (int(vals[0]), int(vals[1]), int(vals[2]))
    expect = 3 + 4 * n_obs + 9 * n_cams + 3 * n_pts
    if vals.size != expect:
        raise ValueError(
            f"malformed BAL file: header says {n_cams} cams / {n_pts} "
            f"pts / {n_obs} obs = {expect} tokens, found {vals.size}")
    tri = vals[3:3 + 4 * n_obs].reshape(n_obs, 4)
    cam_i = tri[:, 0].astype(np.int64)
    pt_i = tri[:, 1].astype(np.int64)
    xy = np.ascontiguousarray(tri[:, 2:4])
    off = 3 + 4 * n_obs
    params9 = vals[off:off + 9 * n_cams].reshape(n_cams, 9)
    pts = vals[off + 9 * n_cams:].reshape(n_pts, 3)
    return cam_i, pt_i, xy, params9, pts


def write_bal(path: str, cameras, points, obs, cam_idx, mask) -> None:
    """Emit a point-major problem as a BAL-format text file."""
    cam_idx = np.asarray(cam_idx)
    mask_np = np.asarray(mask)
    obs_np = np.asarray(obs, np.float64)
    pts = np.asarray(points, np.float64)
    rows = []
    for j in range(cam_idx.shape[0]):
        for k in range(cam_idx.shape[1]):
            if mask_np[j, k]:
                rows.append((cam_idx[j, k], j, obs_np[j, k, 0],
                             obs_np[j, k, 1]))
    params9 = cameras_to_bal(cameras)
    with open(path, "w") as fh:
        fh.write(f"{params9.shape[0]} {pts.shape[0]} {len(rows)}\n")
        for c, j, x, y in rows:
            fh.write(f"{int(c)} {int(j)} {float(x)!r} {float(y)!r}\n")
        for v in params9.reshape(-1):
            fh.write(f"{float(v)!r}\n")
        for v in pts.reshape(-1):
            fh.write(f"{float(v)!r}\n")


def make_bal_problem(n_cams: int = 12, n_pts: int = 120, k_obs: int = 4,
                     noise: float = 0.0, outlier_frac: float = 0.0,
                     pose_noise: float = 0.005, point_noise: float = 0.01,
                     intr_noise: float = 0.0, dtype=jnp.float64,
                     seed: int = 0):
    """Synthetic BAL-convention instance (corridor rig, −z viewing).

    Cameras sit on a rail along +x looking down −z at a landmark slab;
    intrinsics vary per camera (f ~ 500±50 px, mild k1/k2) so the
    distortion parameters are genuinely observable.  ``outlier_frac``
    replaces that fraction of observations with gross uniform garbage
    (for robust/GNC validation; drawn from a DEDICATED rng so the
    ``outlier_frac=0`` instance at the same seed is the exact clean
    counterpart).  Returns
    ``((obs, cam_idx, mask), x0, x_true, outliers)`` with
    x0/x_true = (cameras pytree, points (n_pts, 3)) and ``outliers``
    the (n_pts, k_obs) bool slot-corruption mask (all False when
    outlier_frac=0).  Note a landmark with fewer than 2 clean slots is
    genuinely underdetermined — a saturating robust loss lets it escape
    to infinity at bounded cost, so recovery metrics should exclude
    such landmarks (and corrupted slots).
    """
    rng = np.random.default_rng(seed)
    rail = 0.5 * np.arange(n_cams)
    px = rng.uniform(rail[0], rail[-1] if n_cams > 1 else 1.0, n_pts)
    py = rng.uniform(-1.0, 1.0, n_pts)
    pz = rng.uniform(-5.0, -3.0, n_pts)          # in FRONT = −z in BAL
    true_points = np.stack([px, py, pz], 1)

    aa = np.zeros((n_cams, 3))                   # identity rotations
    t = np.stack([-rail, np.zeros(n_cams), np.zeros(n_cams)], 1)
    f = 500.0 + 50.0 * rng.standard_normal(n_cams)
    k1 = 1e-2 * rng.standard_normal(n_cams)
    k2 = 1e-3 * rng.standard_normal(n_cams)
    params9 = np.concatenate([aa, t, f[:, None], k1[:, None],
                              k2[:, None]], axis=1)
    true_cams = cameras_from_bal(params9, dtype)
    true_pts_j = jnp.asarray(true_points, dtype)

    nearest = np.clip(np.searchsorted(rail, px), 0, n_cams - 1)
    lo = np.clip(nearest - k_obs // 2, 0, max(n_cams - k_obs, 0))
    cam_idx = (lo[:, None] + np.arange(k_obs)[None, :]).astype(np.int32)

    def slot(c, pt):
        cam = jax.tree_util.tree_map(lambda l: l[c], true_cams)
        return bal_project(cam, pt)

    obs = jax.vmap(lambda pt, cams: jax.vmap(
        lambda c: slot(c, pt))(cams))(true_pts_j, jnp.asarray(cam_idx))
    obs = np.array(obs, np.float64)
    obs += noise * rng.standard_normal(obs.shape)
    bad = np.zeros(obs.shape[:2], bool)
    if outlier_frac > 0.0:
        rng_o = np.random.default_rng(seed + 10_007)
        bad = rng_o.uniform(size=obs.shape[:2]) < outlier_frac
        scale = np.abs(obs).max()
        obs = np.where(bad[..., None],
                       rng_o.uniform(-2 * scale, 2 * scale, obs.shape),
                       obs)
    mask = jnp.ones((n_pts, k_obs), dtype)

    # perturbed start, camera 0 / point 0 anchored (gauge)
    dw = pose_noise * rng.standard_normal((n_cams, 6))
    dw[0] = 0.0
    x0_pose = jax.vmap(lambda q, tt, w: SE3.exp(jnp.asarray(w, dtype))
                       @ SE3(SO3(q), tt))(
        true_cams["pose"].rotation.wxyz, true_cams["pose"].translation,
        jnp.asarray(dw))
    di = np.zeros((n_cams, 3))
    if intr_noise:
        di = intr_noise * rng.standard_normal((n_cams, 3)) \
            * np.array([100.0, 0.02, 0.002])
        di[0] = 0.0
    dp = point_noise * rng.standard_normal((n_pts, 3))
    dp[0] = 0.0
    x0 = ({"pose": x0_pose,
           "intr": true_cams["intr"] + jnp.asarray(di, dtype)},
          true_pts_j + jnp.asarray(dp, dtype))
    x_true = (true_cams, true_pts_j)
    return ((jnp.asarray(obs, dtype), jnp.asarray(cam_idx), mask),
            x0, x_true, jnp.asarray(bad))


def bal_rmse(cameras, points, obs, cam_idx, mask) -> jax.Array:
    """Reprojection RMSE (pixels) in the point-major layout."""
    def point(pt, d_j, cams, m_j):
        def one(c, d_k, m_k):
            cam = jax.tree_util.tree_map(lambda l: l[c], cameras)
            return (bal_project(cam, pt) - d_k) * m_k
        return jax.vmap(one)(cams, d_j, m_j)

    r = jax.vmap(point)(points, obs, cam_idx, mask)
    n = jnp.maximum(jnp.sum(mask) * 2.0, 1.0)
    return jnp.sqrt(jnp.sum(r * r) / n)
