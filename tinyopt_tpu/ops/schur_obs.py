"""Sparse-observation Schur elimination (point-major padded layout).

The dense-grid Schur path (ops/schur.py) stores every (camera, landmark)
pair: E is (n_a, n_b, da, db) and the linearization grids are
O(n_a · n_b · m) — perfect for dense visibility, but a few hundred
cameras is its memory ceiling.  Real SfM visibility is SPARSE: each
landmark is seen by a handful of cameras.  This module stores exactly
the observations, in the point-major padded layout every production BA
solver uses (Agarwal et al., "Bundle Adjustment in the Large"):

  * ``obs``      — pytree, leaves (n_b, K, ...): per-landmark data for
                   up to K observations (padded),
  * ``cam_idx``  — (n_b, K) int32: which camera made each observation,
  * ``mask``     — (n_b, K): 1 for real slots (padded slots contribute
                   exactly zero residual AND Jacobian).

Memory is O(n_obs) = O(n_b · K) instead of O(n_a · n_b).

Layout discipline (the part that makes this scale): a tensor whose
trailing dims are small blocks is expensive to lay out and to stream
(tiled layouts pad the trailing dims), and the naive per-point
camera-pair block tensor (n_b, K, K, 6, 6) is O(n_b · K²) on its own.
Therefore:

  * persistent per-point state is stored FLAT with one big trailing dim
    — E as (n_b, K·da·db), C as (n_b, db²);
  * all expanded small-block algebra (linearize sweeps, C⁻¹, EC, the
    (K·K, da, da) pair blocks) runs CHUNKED over points inside a
    ``lax.fori_loop``: transients are O(chunk), independent of n_b;
  * the reduced camera system assembles through a host-PLANNED
    segment reduction: the chunk loop writes its camera-pair blocks to
    flat row buffers with contiguous updates, and static gather plans
    (camera topology is fixed per solver instance) sum each segment
    with dense tree reduces instead of scatter-adds; the per-chunk
    scatter pass remains as the fallback for traced index layouts
    (multi-process shards) and over-budget stagings.

The chunked per-point passes are factored as SLAB KERNELS
(:func:`make_obs_kernels`): pure functions over any point-major slab
whose length is a chunk multiple.  ``schur_obs_system`` composes them
with identity reductions (one device holds all points);
``parallel.schur_obs`` composes the same kernels over a landmark-sharded
mesh, completing the camera-side partial sums with ``psum``.

Same loop contract as ops/schur.py: ``accumulate`` returns a
:class:`SchurObsSystem` as the pluggable H, ``propose`` eliminates with
multiplicative (1+λ) block damping; LM/GN/DogLeg via the shared
dogleg_core.  The reference concedes this regime entirely ("not fast
for large systems yet", /root/reference/README.md:30).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from .. import manifold as mf
from ..cost import Cost, rss as rss_exact
from ..diff.auto import flatten_residuals
from ..options import SolverType
from .linalg import inv_cov, refine_psd_solve, solve_psd
from .schur import _damp_blocks, bipartite_perms



def _esum(spec, a, b, preferred_element_type=None, **_):
    """Exact small-contraction einsum, evaluated as broadcast multiply +
    sum instead of dot_general.

    Why: at DEFAULT precision a GPU may round f32 dot_general operands
    to TF32, and reduced-precision assembly corrupts the S/E/C blocks
    enough to stall large-BA convergence.  These block contractions
    (over m residuals or db=3 landmark dims) are too short for matrix
    units anyway: broadcast-multiply + sum fuses into one exact f32
    loop.  XLA fuses the multiply into the reduce, so the product space
    is never materialized beyond the operand tiles.
    """
    ins, out = spec.split("->")
    sa, sb = ins.split(",")
    axes = []
    for c in out + sa + sb:
        if c not in axes:
            axes.append(c)

    def align(x, labels):
        order = [c for c in axes if c in labels]
        perm = [labels.index(c) for c in order]
        xt = jnp.transpose(x, perm)
        shape, k = [], 0
        for c in axes:
            if c in labels:
                shape.append(xt.shape[k])
                k += 1
            else:
                shape.append(1)
        return xt.reshape(shape)

    prod = align(a, sa) * align(b, sb)
    res = jnp.sum(prod, axis=tuple(
        i for i, c in enumerate(axes) if c not in out))
    if preferred_element_type is not None:
        res = res.astype(preferred_element_type)
    return res


def spd_inv_blocks(C: jax.Array) -> jax.Array:
    """Batched SPD inverse of (n, db, db) blocks, failure-detecting.

    db ≤ 3: CLOSED-FORM adjugate inverse — pure elementwise math
    (exact f32, no dot_generals to round), with positive-
    definiteness checked via Sylvester's leading principal minors so a
    non-PD block still surfaces as NaN (the λ-escalation contract that
    ``cholesky`` provides for free).  XLA's batched small Cholesky is a
    ~per-element sequential kernel — on the 50k-landmark corridor, the
    adjugate form is the
    difference between the C⁻¹ sweep dominating pass A and vanishing
    into it.  db > 3 falls back to Cholesky.
    """
    db = C.shape[-1]
    nan = jnp.asarray(jnp.nan, C.dtype)
    if db == 1:
        a = C[..., 0, 0]
        return jnp.where(a > 0, 1.0 / jnp.where(a > 0, a, 1.0),
                         nan)[..., None, None]
    if db == 2:
        a, b, d = C[..., 0, 0], C[..., 0, 1], C[..., 1, 1]
        det = a * d - b * b
        pd = (a > 0) & (det > 0)
        inv_det = 1.0 / jnp.where(pd, det, 1.0)
        Ci = (jnp.stack([d, -b, -b, a], -1)
              .reshape(C.shape) * inv_det[..., None, None])
        return jnp.where(pd[..., None, None], Ci, nan)
    if db == 3:
        a, b, c = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
        d, e, f = C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]
        A = d * f - e * e                   # cofactors (symmetric)
        B = c * e - b * f
        Cc = b * e - c * d
        D = a * f - c * c
        E = b * c - a * e
        F = a * d - b * b
        det = a * A + b * B + c * Cc
        pd = (a > 0) & (F > 0) & (det > 0)  # leading principal minors
        inv_det = 1.0 / jnp.where(pd, det, 1.0)
        Ci = (jnp.stack([A, B, Cc, B, D, E, Cc, E, F], -1)
              .reshape(C.shape) * inv_det[..., None, None])
        return jnp.where(pd[..., None, None], Ci, nan)
    eye = jnp.eye(db, dtype=C.dtype)
    with jax.default_matmul_precision("highest"):
        chol = jnp.linalg.cholesky(C)
        return jax.vmap(lambda L: jax.scipy.linalg.cho_solve(
            (L, True), eye))(chol)


class SchurObsSystem(NamedTuple):
    """Arrow system in sparse-observation form (pluggable H).

    Per-point blocks are stored FLAT (see module docstring): ``C`` is
    (n_b, db²) row-major, ``E`` is (n_b, K·da·db) with slot-major
    (k, a, b) order.  ``n_a``/``da``/``db`` are recoverable from Ba; K
    from cam_idx.
    """

    Ba: jax.Array       #: (n_a, da, da) camera diagonal blocks
    C: jax.Array        #: (n_b, db*db) landmark diagonal blocks, flat
    E: jax.Array        #: (n_b, K*da*db) couplings, flat
    cam_idx: jax.Array  #: (n_b, K) int32 camera of each observation
    #: element-major → loop-global tangent index maps (None when the
    #: layouts coincide — single-leaf element pytrees; see
    #: ops/schur.bipartite_perms / manifold.element_perm)
    em2gl: Any = None
    gl2em: Any = None

    def _dims(self):
        n_a, da, _ = self.Ba.shape
        n_b = self.C.shape[0]
        K = self.cam_idx.shape[1]
        db = int(round(math.isqrt(self.C.shape[1])))
        return n_a, da, n_b, db, K

    @property
    def dims(self) -> int:
        n_a, da, n_b, db, _ = self._dims()
        return n_a * da + n_b * db

    @property
    def shape(self):
        d = self.dims
        return (d, d)

    @property
    def dtype(self):
        return self.Ba.dtype

    def matvec(self, v: jax.Array) -> jax.Array:
        """H·v from the sparse blocks (one gather + one segment_sum).

        ``v``/result in the loop's global tangent layout.  Expands E per
        call — transient (n_b, K, da, db); used once per dogleg propose,
        not in inner loops.
        """
        n_a, da, n_b, db, K = self._dims()
        if self.gl2em is not None:
            v = v[self.gl2em]
        v_a = v[:n_a * da].reshape(n_a, da)
        v_b = v[n_a * da:].reshape(n_b, db)
        E4 = self.E.reshape(n_b, K, da, db)
        C3 = self.C.reshape(n_b, db, db)
        o_a = _esum("iab,ib->ia", self.Ba, v_a)
        Evb = _esum("jkab,jb->jka", E4, v_b)         # (n_b, K, da)
        o_a = o_a + jax.ops.segment_sum(
            Evb.reshape(n_b * K, da), self.cam_idx.reshape(-1),
            num_segments=n_a)
        va_g = v_a[self.cam_idx]                          # (n_b, K, da)
        o_b = (_esum("jab,jb->ja", C3, v_b)
               + _esum("jkab,jka->jb", E4, va_g))
        out = jnp.concatenate([o_a.reshape(-1), o_b.reshape(-1)])
        return out if self.em2gl is None else out[self.em2gl]

    def to_dense(self) -> jax.Array:
        """Assemble the full arrow H (testing / covariance at small n)."""
        d = self.dims
        eye = jnp.eye(d, dtype=self.dtype)
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(eye)

    def marginals(self, chunk: int = 1024):
        """Scale path: per-camera/per-landmark marginal covariance blocks
        (see :func:`obs_marginals`) — never densifies H."""
        return obs_marginals(self, chunk)

    def inv(self):
        """Full dense H⁻¹ (``Output.covariance`` contract — small n
        only: densifies).  At scale use :meth:`marginals` /
        ``schur_sparse_covariance``."""
        from .schur import _SchurCov
        return _SchurCov(inv_cov(self.to_dense()))


def _damp_flat(M_flat: jax.Array, db: int, lam) -> jax.Array:
    """_damp_blocks on (n, db²) row-major flat blocks."""
    diag_pos = jnp.arange(db) * (db + 1)
    diag = M_flat[:, diag_pos]
    add = jnp.where(diag == 0, lam, diag * lam)
    return M_flat.at[:, diag_pos].add(add)


def obs_linearize(pair_fn: Callable, a, b, obs, cam_idx, mask,
                  spec_a: mf.TangentSpec, spec_b: mf.TangentSpec, dtype):
    """Masked (r, Ja, Jb) per observation slot.

    Shapes: r (n_b, K, m), Ja (n_b, K, m, da), Jb (n_b, K, m, db).
    Camera parameters are gathered per slot (ONE XLA gather of the
    camera pytree rows); tangent sweeps run under vmap over all
    n_b · K slots at once.  Call on CHUNKS of points at scale.
    """
    da, db = spec_a.dims, spec_b.dims

    def pair_r(a_i, b_j, d_ij):
        return flatten_residuals(pair_fn(a_i, b_j, d_ij)).astype(dtype)

    def slot(a_k, b_j, d_k, m_k):
        za = jnp.zeros((da,), dtype)

        def r_of_da(delta_a):
            return pair_r(mf.retract(a_k, delta_a, spec_a), b_j, d_k) * m_k

        r = r_of_da(za)
        Ja = jax.jacfwd(r_of_da)(za)                     # (m, da)
        a_r0 = mf.retract(a_k, za, spec_a)

        def r_of_db(delta_b):
            return pair_r(a_r0, mf.retract(b_j, delta_b, spec_b),
                          d_k) * m_k

        Jb = jax.jacfwd(r_of_db)(jnp.zeros((db,), dtype))  # (m, db)
        return r, Ja, Jb

    def point(b_j, d_j, cam_j, m_j):
        a_g = jax.tree_util.tree_map(lambda l: l[cam_j], a)  # (K, ...)
        return jax.vmap(slot, in_axes=(0, None, 0, 0))(a_g, b_j, d_j, m_j)

    return jax.vmap(point)(b, obs, cam_idx, mask)


def _pick_chunk(n_bp: int, requested: int) -> int:
    """Largest divisor of n_bp that is <= requested (n_bp is padded to a
    multiple of the requested chunk at build time, so this is exact)."""
    ch = min(requested, n_bp)
    while n_bp % ch:
        ch -= 1
    return ch


#: Staging-buffer budget for the planned reduce (bytes of the persistent
#: camera-pair row buffer); above it make_obs_kernels falls back to the
#: chunk-transient scatter pass.  Flagship (50k pts, K=8, da=6): 200 MB.
_PLANNED_STAGING_LIMIT = 512 * 2 ** 20


def _pair_block_chunk(E_c, Cd_c, g_b_c, ks, ls, eye, dtype):
    """Shared per-chunk elimination algebra of pass A — ONE copy for
    both reduce variants (scatter and planned), so the zero-block
    substitution, the exact C⁻¹ and the precision discipline cannot
    diverge between them.

    Returns ``(Cinv_c, blocks_tri (CH, P_tri, da, da), blocks_diag
    (CH, K, da, da), rhs_rows (CH, K, da))``.  Padded points carry
    all-zero Cd blocks; Cholesky(0)/adjugate(0) is NaN, which would
    poison the reduction — substitute identity for exactly-zero blocks
    (their E rows are zero, contributions exact zeros either way).
    """
    zero_blk = jnp.all(Cd_c == 0, axis=(-2, -1), keepdims=True)
    Cd_c = jnp.where(zero_blk, eye[None], Cd_c)
    # exact elementwise C⁻¹ (adjugate at db<=3) with the NaN non-PD
    # contract — see spd_inv_blocks
    Cinv_c = spd_inv_blocks(Cd_c)
    EC_c = _esum("jkab,jbc->jkac", E_c, Cinv_c,
                 preferred_element_type=dtype)
    # strict-lower slot pairs only (mirrors are transposes)
    blocks_tri = _esum("jpac,jpbc->jpab", EC_c[:, ks], E_c[:, ls],
                       preferred_element_type=dtype)
    # k == l diagonal slot pairs
    blocks_diag = _esum("jkac,jkbc->jkab", EC_c, E_c,
                        preferred_element_type=dtype)
    rhs_rows = _esum("jkac,jc->jka", EC_c, g_b_c)
    return Cinv_c, blocks_tri, blocks_diag, rhs_rows


def make_reduce_pass(n_a: int, K: int, da: int, db: int, dtype,
                     CH: int):
    """Factory for pass A of the elimination — standalone so the
    covariance path (:func:`obs_marginals`, parallel/schur_obs.py's
    sharded covariance) can rebuild S without a ``pair_fn``.

    Returns ``reduce_pass(E_p, Cd_p, cam_p, g_b_p) -> (S_f, rhs_acc,
    Cinv_f)`` — the reduced-camera-system partials E C⁻¹ Eᵀ (flat
    (n_a², da²) scatter target) and E C⁻¹ g_b, stashing C⁻¹ per point.
    Every expanded tensor is O(CH · K² · da²).

    Scatter cost grows with the row count, so the camera-pair scatter
    exploits S's symmetry: only the K(K-1)/2
    strict-lower slot pairs are computed and scattered (mirror blocks
    are their transposes), the k==l pairs go to a per-camera diagonal
    accumulator via one segment_sum, and the full S is reconstructed
    densely at the end — S(i,i') = X(i,i') + X(i',i)ᵀ + diag.  1.78x
    fewer scatter rows AND 1.78x fewer block flops, exact algebra.
    """
    eye = jnp.eye(db, dtype=dtype)

    def _sl(arr, c):
        return jax.lax.dynamic_slice_in_dim(arr, c * CH, CH, 0)

    def _upd(arr, val, c):
        return jax.lax.dynamic_update_slice_in_dim(arr, val, c * CH, 0)

    # Static strict-lower slot-pair lists for the symmetry-halved scatter
    # (k > l); diagonal slot pairs (k == l) accumulate separately.
    _ks = jnp.asarray([k for k in range(K) for l in range(k)], jnp.int32)
    _ls = jnp.asarray([l for k in range(K) for l in range(k)], jnp.int32)
    P_tri = int(_ks.shape[0])           # K(K-1)/2

    def reduce_pass(E_p, Cd_p, cam_p, g_b_p):
        n_p = cam_p.shape[0]

        def bodyA(c, carry):
            S_f, S_diag, rhs, Cinv_f = carry
            E_c = _sl(E_p, c).reshape(CH, K, da, db)
            Cd_c = _sl(Cd_p, c).reshape(CH, db, db)
            cam_c = _sl(cam_p, c)
            g_b_c = _sl(g_b_p, c)
            Cinv_c, blocks_tri, blocks_diag, rhs_rows = \
                _pair_block_chunk(E_c, Cd_c, g_b_c, _ks, _ls, eye, dtype)
            ids_tri = (jnp.take(cam_c, _ks, axis=1) * n_a
                       + jnp.take(cam_c, _ls, axis=1)).reshape(-1)
            S_f = S_f.at[ids_tri].add(
                blocks_tri.reshape(CH * P_tri, da * da))
            # k == l diagonal slot pairs: per-camera accumulator
            S_diag = S_diag + jax.ops.segment_sum(
                blocks_diag.reshape(CH * K, da * da),
                cam_c.reshape(-1), num_segments=n_a)
            rhs = rhs.at[cam_c.reshape(-1)].add(
                rhs_rows.reshape(CH * K, da))
            Cinv_f = _upd(Cinv_f, Cinv_c.reshape(CH, db * db), c)
            return S_f, S_diag, rhs, Cinv_f

        initA = (jnp.zeros((n_a * n_a, da * da), dtype),
                 jnp.zeros((n_a, da * da), dtype),
                 jnp.zeros((n_a, da), dtype),
                 jnp.zeros((n_p, db * db), dtype))
        S_f, S_diag, rhs, Cinv_f = jax.lax.fori_loop(
            0, n_p // CH, bodyA, initA)
        # Dense reconstruction via the shared scatter-free form
        # (_reconstruct_S; fancy diagonal scatter-add miscompiles on
        # the CPU backend — see its docstring)
        return _reconstruct_S(S_f, S_diag, n_a, da), rhs, Cinv_f

    return reduce_pass


def _class_gather_table(order, starts, counts, sel, cap, n_rows,
                        n_seg_c=None):
    """(n_seg_c, cap) gather table for one segment-length class: real
    segments' row indices front-padded with the zero-sentinel n_rows;
    rows beyond len(sel) (cross-device padding) are all-sentinel."""
    import numpy as np

    n_seg_c = len(sel) if n_seg_c is None else n_seg_c
    g = np.full((n_seg_c, cap), n_rows, np.int64)
    if len(sel):
        offs = np.arange(cap)[None, :]
        idx = starts[sel][:, None] + offs
        valid = offs < counts[sel][:, None]
        g[:len(sel)] = np.where(
            valid, order[np.minimum(idx, n_rows - 1)], n_rows)
    return g


def make_planned_segment_reduce(ids, n_out: int, growth: float = 1.35,
                                min_class: int = 8):
    """Host-side plan for a (nearly) scatter-free segment reduction.

    Scatter-adds of arbitrary rows cost more per row than gathers, and
    the reduce_pass scatter dominated the corridor BA iteration.
    When the segment ids are STATIC (camera topology is fixed per
    solver instance), the reduction can be planned on the host:

    * rows of each segment are gathered into padded (n_seg, L) layouts
      (segment-length classes growing by ``growth``, which bounds the
      padded gather-row overhead — the gather IS the dominant cost, so
      the default growth is tight);
    * each class is summed by a dense XLA tree reduce along the padded
      axis (exact f32 — no running-cumsum cancellation);
    * the (n_out, w) target is densified EITHER by one static gather
      with a zero sentinel (dense outputs) OR, when the real segments
      are sparse in the output (n_seg ≪ n_out — the camera-PAIR
      system, 28k of 1M rows), by one scatter-SET of the uid-sorted
      segment rows — sorted+unique scatter-set measured 74 ns/row,
      35× cheaper than gathering the mostly-zero dense output.

    Returns ``reduce(rows (n_rows, w)) -> (n_out, w)`` summing
    ``rows[i]`` into output row ``ids[i]``.
    """
    import numpy as np

    ids = np.asarray(ids, np.int64).ravel()
    n_rows = ids.size
    if n_rows == 0:
        # degenerate plan (K=1 layouts have no strict-lower slot pairs)
        def reduce_empty(rows: jax.Array) -> jax.Array:
            return jnp.zeros((n_out, rows.shape[-1]), rows.dtype)

        return reduce_empty
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    uids, starts, counts = np.unique(sorted_ids, return_index=True,
                                     return_counts=True)
    cap_of, used = bucket_caps(counts, growth, min_class)
    n_seg = uids.size

    gathers = []
    concat_uids = []
    for cap in used:
        sel = np.nonzero(cap_of == cap)[0]
        gathers.append(jnp.asarray(_class_gather_table(
            order, starts, counts, sel, cap, n_rows), jnp.int32))
        concat_uids.append(uids[sel])
    concat_uids = np.concatenate(concat_uids) if concat_uids else \
        np.zeros(0, np.int64)

    densify_scatter = n_seg * 2 < n_out
    if densify_scatter:
        seg_perm = jnp.asarray(np.argsort(concat_uids), jnp.int32)
        uids_sorted = jnp.asarray(np.sort(concat_uids), jnp.int32)
    else:
        out_map = np.full(n_out, -1, np.int64)
        out_map[concat_uids] = np.arange(n_seg)
        zero_slot = n_seg
        out_map[out_map < 0] = zero_slot
        out_map = jnp.asarray(out_map, jnp.int32)

    def reduce(rows: jax.Array) -> jax.Array:
        w = rows.shape[-1]
        rows1 = jnp.concatenate(
            [rows, jnp.zeros((1, w), rows.dtype)])
        parts = [jnp.sum(rows1[g], axis=1) for g in gathers]
        if densify_scatter:
            seg = jnp.concatenate(parts)[seg_perm]
            return jnp.zeros((n_out, w), rows.dtype).at[uids_sorted] \
                .set(seg, unique_indices=True, indices_are_sorted=True)
        parts.append(jnp.zeros((1, w), rows.dtype))
        return jnp.concatenate(parts)[out_map]

    return reduce


def make_planned_segment_reduce_multi(ids_list, n_out: int,
                                      growth: float = 1.35,
                                      min_class: int = 8):
    """Per-DEVICE plans for the planned segment reduction, with COMMON
    table shapes so one SPMD program serves every mesh shard.

    ``ids_list`` — one static id array per device (its slab's rows).
    Class caps are chosen from the UNION of all devices' segment
    lengths; within each class, the per-device segment count is padded
    to the max across devices (padded segments gather only the zero
    sentinel and scatter to a trash row).  Returns ``(tables,
    apply)`` where ``tables`` is a pytree of STACKED (n_dev, ...)
    int32 arrays (shard it ``P(axis)`` and index ``[0]`` inside
    ``shard_map``) and ``apply(rows, tables_slice) -> (n_out, w)``
    performs the device's reduction from traced tables.
    """
    import numpy as np

    n_dev = len(ids_list)
    ids_list = [np.asarray(i, np.int64).ravel() for i in ids_list]
    n_rows = ids_list[0].size
    assert all(i.size == n_rows for i in ids_list), \
        "per-device row counts must match (same slab shapes)"
    if n_rows == 0:
        tables = {"g": (jnp.zeros((n_dev, 0, 1), jnp.int32),),
                  "out": (jnp.zeros((n_dev, 0), jnp.int32),)}

        def apply_empty(rows, tables_slice):
            return jnp.zeros((n_out, rows.shape[-1]), rows.dtype)

        return tables, apply_empty

    per_dev = []
    all_counts = []
    for ids in ids_list:
        order = np.argsort(ids, kind="stable")
        uids, starts, counts = np.unique(ids[order], return_index=True,
                                         return_counts=True)
        per_dev.append((order, uids, starts, counts))
        all_counts.append(counts)
    _, caps = bucket_caps(np.concatenate(all_counts), growth,
                          min_class)
    # per-device class membership (cap assignment hoisted out of the
    # class loop); common per-class capacity = max over devices
    dev_cap_of = [_assign_caps(counts, caps)[0]
                  for *_, counts in per_dev]
    g_tabs, out_tabs = [], []
    for cap in caps:
        sel_d = [np.nonzero(c_of == cap)[0] for c_of in dev_cap_of]
        n_seg_c = max((len(sl) for sl in sel_d), default=0)
        if n_seg_c == 0:
            continue
        g_dev, o_dev = [], []
        for (order, uids, starts, counts), sel in zip(per_dev, sel_d):
            o = np.full((n_seg_c,), n_out, np.int64)      # trash row
            o[:len(sel)] = uids[sel]
            g_dev.append(_class_gather_table(
                order, starts, counts, sel, cap, n_rows, n_seg_c))
            o_dev.append(o)
        g_tabs.append(jnp.asarray(np.stack(g_dev), jnp.int32))
        out_tabs.append(jnp.asarray(np.stack(o_dev), jnp.int32))

    tables = {"g": tuple(g_tabs), "out": tuple(out_tabs)}

    def apply(rows: jax.Array, tables_slice) -> jax.Array:
        w = rows.shape[-1]
        rows1 = jnp.concatenate([rows, jnp.zeros((1, w), rows.dtype)])
        parts = [jnp.sum(rows1[g], axis=1)
                 for g in tables_slice["g"]]
        if not parts:
            return jnp.zeros((n_out, w), rows.dtype)
        seg = jnp.concatenate(parts)
        ids = jnp.concatenate(tables_slice["out"])
        out = jnp.zeros((n_out + 1, w), rows.dtype).at[ids].set(seg)
        return out[:n_out]

    return tables, apply


def _assign_caps(counts, caps):
    """Smallest sufficient cap per segment from a FIXED cap list."""
    import numpy as np

    counts = np.asarray(counts)
    cap_of = np.full(counts.shape, caps[-1], np.int64)
    for cap in reversed(caps):
        cap_of[counts <= cap] = cap
    cap_of[counts == 0] = caps[0]
    return cap_of, caps


def make_reduce_pass_planned(n_a: int, K: int, da: int, db: int, dtype,
                             CH: int, cam_idx_np):
    """Pass A with PLANNED (scatter-free) reductions — same contract as
    :func:`make_reduce_pass`, requiring the static padded camera index
    array ``cam_idx_np`` (n_p, K) at build time.

    The chunk loop computes the same C⁻¹ / EC / camera-pair blocks but
    writes them to flat global row buffers with contiguous
    ``dynamic_update_slice`` (no scatter); the (n_a², da²) reduced-
    system assembly, the per-camera diagonal and the rhs then run
    through :func:`make_planned_segment_reduce` — gathers and dense
    tree sums only (benchmarks/exp_ba_stages.py times the stages).
    """
    import numpy as np

    cam_np = np.asarray(cam_idx_np, np.int64)
    n_p = cam_np.shape[0]
    assert n_p % CH == 0

    _ks = np.asarray([k for k in range(K) for l in range(k)], np.int64)
    _ls = np.asarray([l for k in range(K) for l in range(k)], np.int64)
    ids_tri = (cam_np[:, _ks] * n_a + cam_np[:, _ls]).ravel()
    ids_slot = cam_np.ravel()
    reduce_tri = make_planned_segment_reduce(ids_tri, n_a * n_a)
    reduce_slot = make_planned_segment_reduce(ids_slot, n_a)

    def reduce_pass(E_p, Cd_p, cam_p, g_b_p):
        tri_rows, diag_rows, rhs_buf, Cinv_f = _planned_row_buffers(
            E_p, Cd_p, g_b_p, K, da, db, dtype, CH)
        S_f = reduce_tri(tri_rows)
        S_diag = reduce_slot(diag_rows)
        rhs = reduce_slot(rhs_buf)
        return (_reconstruct_S(S_f, S_diag, n_a, da), rhs, Cinv_f)

    return reduce_pass


def _planned_row_buffers(E_p, Cd_p, g_b_p, K, da, db, dtype, CH):
    """Chunk loop of the planned pass A: compute the per-chunk pair
    blocks (shared `_pair_block_chunk` algebra) and write them to flat
    global row buffers with contiguous ``dynamic_update_slice`` (no
    scatter).  Returns (tri_rows, diag_rows, rhs_rows, Cinv_f)."""
    eye = jnp.eye(db, dtype=dtype)
    n_p = Cd_p.shape[0]
    ks_j = jnp.asarray([k for k in range(K) for l in range(k)],
                       jnp.int32)
    ls_j = jnp.asarray([l for k in range(K) for l in range(k)],
                       jnp.int32)
    P_tri = int(ks_j.shape[0])

    def _sl(arr, c):
        return jax.lax.dynamic_slice_in_dim(arr, c * CH, CH, 0)

    def _updr(arr, val, c, stride):
        return jax.lax.dynamic_update_slice_in_dim(
            arr, val, c * CH * stride, 0)

    def bodyA(c, carry):
        tri_rows, diag_rows, rhs_buf, Cinv_f = carry
        E_c = _sl(E_p, c).reshape(CH, K, da, db)
        Cd_c = _sl(Cd_p, c).reshape(CH, db, db)
        g_b_c = _sl(g_b_p, c)
        Cinv_c, blocks_tri, blocks_diag, rhs_rows = \
            _pair_block_chunk(E_c, Cd_c, g_b_c, ks_j, ls_j, eye, dtype)
        tri_rows = _updr(
            tri_rows, blocks_tri.reshape(CH * P_tri, da * da), c,
            P_tri)
        diag_rows = _updr(
            diag_rows, blocks_diag.reshape(CH * K, da * da), c, K)
        rhs_buf = _updr(rhs_buf, rhs_rows.reshape(CH * K, da), c, K)
        Cinv_f = jax.lax.dynamic_update_slice_in_dim(
            Cinv_f, Cinv_c.reshape(CH, db * db), c * CH, 0)
        return tri_rows, diag_rows, rhs_buf, Cinv_f

    init = (jnp.zeros((n_p * P_tri, da * da), dtype),
            jnp.zeros((n_p * K, da * da), dtype),
            jnp.zeros((n_p * K, da), dtype),
            jnp.zeros((n_p, db * db), dtype))
    return jax.lax.fori_loop(0, n_p // CH, bodyA, init)


#: Per-chunk distinct-segment budget for the windowed matmul reduce
#: (lanes of the per-chunk onehot): above it the onehot matmuls stop
#: paying vs the 29 ns/row planned gathers.
_WINDOW_BUDGET = 2048


#: Whether each platform runs the windowed reduce by default.  The
#: window trades gather rows for onehot matmuls: on the CPU that is
#: pure extra flops, and on an H100 the planned gather reduce was faster
#: on the 1000-camera corridor BA (0.13-0.21 s against 0.24 s per solve;
#: both met the rmse criterion).
_WINDOW_DEFAULT = {"cpu": False, "gpu": False}


def window_default(platform: str) -> bool:
    """Whether ``platform`` runs the windowed reduce by default."""
    return _WINDOW_DEFAULT[platform]


def _window_enabled() -> bool:
    """The windowed reduce's switch: :func:`window_default` for the
    current backend, or TINYOPT_WINDOW_REDUCE=1/0 to force it on/off
    (tests, experiments)."""
    import os
    v = os.environ.get("TINYOPT_WINDOW_REDUCE")
    if v is not None:
        return v not in ("0", "off", "")
    return window_default(jax.default_backend())


def plan_window_reduce(cam_idx_np, n_a: int, K: int, CH: int,
                       budget: int = _WINDOW_BUDGET, mask_np=None):
    """Host plan for the per-chunk WINDOWED matmul reduction, or None.

    The planned gather reduce pays a gather on every camera-pair row.
    When each chunk of points touches few distinct segments
    (camera-LOCAL layouts: corridor rigs, or any rig after the internal
    landmark sort), the segment sums can run as matmuls instead:
    the chunk's rows are multiplied by a 0/1 onehot built on the fly
    from a static local-id table, giving per-chunk (W, da²) partial
    windows; one small final planned reduce over n_chunks·W window rows
    completes the sum.  No global row buffer exists at all (the planned
    path stages n_p·P_tri rows — 200 MB at the flagship).

    Returns ``(loc_tri, seg_tri, W_tri, loc_slot, seg_slot, W_slot)``
    tables (numpy) or None when some chunk exceeds ``budget`` distinct
    pair segments.
    """
    import numpy as np

    cam = np.asarray(cam_idx_np, np.int64)
    n_p = cam.shape[0]
    assert n_p % CH == 0
    n_chunks = n_p // CH
    ks = np.asarray([k for k in range(K) for l in range(k)], np.int64)
    ls = np.asarray([l for k in range(K) for l in range(k)], np.int64)
    ids_tri = (cam[:, ks] * n_a + cam[:, ls]).reshape(n_p, -1)
    if mask_np is not None:
        # masked-slot pairs contribute exact zeros (their E rows are
        # zero) — collapse their ids to segment 0 so spurious (0, c)
        # pairs cannot inflate the windows
        mk = np.asarray(mask_np) != 0
        if mk.shape[0] < n_p:       # caller passed the unpadded mask
            mk = np.concatenate(
                [mk, np.zeros((n_p - mk.shape[0], K), bool)])
        real = (mk[:, ks] & mk[:, ls]).reshape(n_p, -1)
        ids_tri = np.where(real, ids_tri, 0)
    P_tri = ids_tri.shape[1]

    # pass 1: window sizes (cheap bail-out before building tables)
    W_tri = W_slot = 0
    for c in range(n_chunks):
        W_tri = max(W_tri, np.unique(
            ids_tri[c * CH:(c + 1) * CH]).size)
        if W_tri > budget:
            return None
        W_slot = max(W_slot, np.unique(
            cam[c * CH:(c + 1) * CH]).size)

    def _pad(w):
        return max(128, -(-w // 128) * 128)

    W_tri, W_slot = _pad(W_tri), _pad(W_slot)
    loc_tri = np.zeros((n_chunks, CH * P_tri), np.int32)
    seg_tri = np.zeros((n_chunks, W_tri), np.int64)
    loc_slot = np.zeros((n_chunks, CH * K), np.int32)
    seg_slot = np.zeros((n_chunks, W_slot), np.int64)
    for c in range(n_chunks):
        seg, inv = np.unique(ids_tri[c * CH:(c + 1) * CH].ravel(),
                             return_inverse=True)
        loc_tri[c] = inv
        seg_tri[c, :seg.size] = seg
        seg2, inv2 = np.unique(cam[c * CH:(c + 1) * CH].ravel(),
                               return_inverse=True)
        loc_slot[c] = inv2
        seg_slot[c, :seg2.size] = seg2
    return loc_tri, seg_tri, W_tri, loc_slot, seg_slot, W_slot


def plan_window_reduce_multi(cam_list, n_a: int, K: int, CH: int,
                             budget: int = _WINDOW_BUDGET,
                             mask_list=None):
    """Per-DEVICE window plans with COMMON shapes (sharded pass A), or
    None.  ``cam_list`` — one padded (n_lp, K) host array per device;
    all slabs must have the same shape.  Returns ``(loc_tri (n_dev,
    n_chunks, CH·P_tri), seg_tri (n_dev, n_chunks, W_tri), W_tri,
    loc_slot, seg_slot, W_slot)``; window widths are the max over all
    devices' chunks so one SPMD program serves every shard.
    """
    import numpy as np

    if not _window_enabled():
        return None
    raws = []
    W_tri = W_slot = 0
    for d_i, cam in enumerate(cam_list):
        cam = np.asarray(cam, np.int64)
        n_p = cam.shape[0]
        assert n_p % CH == 0
        ks = np.asarray([k for k in range(K) for l in range(k)],
                        np.int64)
        ls = np.asarray([l for k in range(K) for l in range(k)],
                        np.int64)
        ids_tri = (cam[:, ks] * n_a + cam[:, ls]).reshape(n_p, -1)
        if mask_list is not None:
            mk = np.asarray(mask_list[d_i]) != 0
            if mk.shape[0] < n_p:
                mk = np.concatenate(
                    [mk, np.zeros((n_p - mk.shape[0], K), bool)])
            real = (mk[:, ks] & mk[:, ls]).reshape(n_p, -1)
            ids_tri = np.where(real, ids_tri, 0)
        dev = []
        for c in range(n_p // CH):
            sl = slice(c * CH, (c + 1) * CH)
            seg, inv = np.unique(ids_tri[sl].ravel(),
                                 return_inverse=True)
            W_tri = max(W_tri, seg.size)
            if W_tri > budget:
                return None
            seg2, inv2 = np.unique(cam[sl].ravel(),
                                   return_inverse=True)
            W_slot = max(W_slot, seg2.size)
            dev.append((inv, seg, inv2, seg2))
        raws.append(dev)

    def _pad(w):
        return max(128, -(-w // 128) * 128)

    W_tri, W_slot = _pad(W_tri), _pad(W_slot)
    n_dev = len(raws)
    n_chunks = len(raws[0])
    P_tri = K * (K - 1) // 2
    loc_tri = np.zeros((n_dev, n_chunks, CH * P_tri), np.int32)
    seg_tri = np.zeros((n_dev, n_chunks, W_tri), np.int64)
    loc_slot = np.zeros((n_dev, n_chunks, CH * K), np.int32)
    seg_slot = np.zeros((n_dev, n_chunks, W_slot), np.int64)
    for d, dev in enumerate(raws):
        for c, (inv, seg, inv2, seg2) in enumerate(dev):
            loc_tri[d, c] = inv
            seg_tri[d, c, :seg.size] = seg
            loc_slot[d, c] = inv2
            seg_slot[d, c, :seg2.size] = seg2
    return loc_tri, seg_tri, W_tri, loc_slot, seg_slot, W_slot


def plan_window_reduce_banded(cam_idx_np, n_a: int, K: int, CH: int,
                              bw: int, budget: int = _WINDOW_BUDGET,
                              mask_np=None):
    """Host plan for the windowed reduction into BAND storage, or None.

    Like :func:`plan_window_reduce` but the camera-pair targets live in
    the band space ``hi·(bw+1) + (hi−lo)`` (n_a·(bw+1) ids instead of
    n_a²) with per-row orientation weights: a pair block computed as
    X(c1, c2) contributes to band entry (hi, hi−lo) as the block
    (c1 > c2), its transpose (c1 < c2), or block+blockᵀ (c1 == c2 —
    the diagonal X+Xᵀ sum).  Per-chunk row sets MERGE the tri pairs and
    the k==l diagonal slot blocks (both target the band), so one onehot
    matmul per chunk covers the whole reduced system; the rhs keeps its
    own (n_a-id) slot windows.

    Returns ``(loc_band (n_chunks, CH·(P_tri+K)), seg_band, W_band,
    w1, w2 (n_chunks, CH·P_tri) uint8, loc_slot, seg_slot, W_slot)``.
    """
    import numpy as np

    if not _window_enabled():
        return None
    cam = np.asarray(cam_idx_np, np.int64)
    n_p = cam.shape[0]
    assert n_p % CH == 0
    n_chunks = n_p // CH
    ks = np.asarray([k for k in range(K) for l in range(k)], np.int64)
    ls = np.asarray([l for k in range(K) for l in range(k)], np.int64)
    c1 = cam[:, ks]
    c2 = cam[:, ls]
    # Only REAL-slot pairs carry information: the masked-slot contract
    # (cam 0 on masked/padded slots) otherwise creates spurious (0, c)
    # pairs whose spans exceed the detected bandwidth (bw is computed
    # mask-aware).  Their blocks are exact zeros (masked E rows are
    # zero), so they collapse to band id 0 with BOTH weights zero.
    if mask_np is not None:
        mk = np.asarray(mask_np) != 0
        if mk.shape[0] < n_p:
            mk = np.concatenate(
                [mk, np.zeros((n_p - mk.shape[0], K), bool)])
        real = mk[:, ks] & mk[:, ls]
    else:
        real = np.ones_like(c1, bool)
    hi = np.maximum(c1, c2)
    lo = np.minimum(c1, c2)
    if int(np.where(real, hi - lo, 0).max(initial=0)) > bw:
        raise ValueError(
            "real camera-pair span exceeds the detected bandwidth — "
            "pass the mask used for detect_camera_bandwidth")
    bw1 = bw + 1
    ids_tri = np.where(real, hi * bw1 + (hi - lo), 0)         .reshape(n_p, -1)                               # (n_p, P_tri)
    ids_diag = cam * bw1                                # (n_p, K)
    P_tri = ids_tri.shape[1]
    w1 = (real & (c1 >= c2)).astype(np.uint8).reshape(n_p, -1)
    w2 = (real & (c1 <= c2)).astype(np.uint8).reshape(n_p, -1)

    R_band = CH * (P_tri + K)
    W_band = W_slot = 0
    for c in range(n_chunks):
        sl = slice(c * CH, (c + 1) * CH)
        u = np.unique(np.concatenate(
            [ids_tri[sl].ravel(), ids_diag[sl].ravel()]))
        W_band = max(W_band, u.size)
        if W_band > budget:
            return None
        W_slot = max(W_slot, np.unique(cam[sl]).size)

    def _pad(w):
        return max(128, -(-w // 128) * 128)

    W_band, W_slot = _pad(W_band), _pad(W_slot)
    loc_band = np.zeros((n_chunks, R_band), np.int32)
    seg_band = np.zeros((n_chunks, W_band), np.int64)
    loc_slot = np.zeros((n_chunks, CH * K), np.int32)
    seg_slot = np.zeros((n_chunks, W_slot), np.int64)
    w1_t = np.zeros((n_chunks, CH * P_tri), np.uint8)
    w2_t = np.zeros((n_chunks, CH * P_tri), np.uint8)
    for c in range(n_chunks):
        sl = slice(c * CH, (c + 1) * CH)
        all_ids = np.concatenate(
            [ids_tri[sl].ravel(), ids_diag[sl].ravel()])
        seg, inv = np.unique(all_ids, return_inverse=True)
        loc_band[c] = inv
        seg_band[c, :seg.size] = seg
        seg2, inv2 = np.unique(cam[sl].ravel(), return_inverse=True)
        loc_slot[c] = inv2
        seg_slot[c, :seg2.size] = seg2
        w1_t[c] = w1[sl].ravel()
        w2_t[c] = w2[sl].ravel()
    return (loc_band, seg_band, W_band, w1_t, w2_t,
            loc_slot, seg_slot, W_slot, bw)


def plan_window_reduce_banded_multi(cam_list, n_a: int, K: int,
                                    CH: int, bw: int,
                                    budget: int = _WINDOW_BUDGET,
                                    mask_list=None):
    """Per-DEVICE banded window plans with COMMON shapes, or None.
    Same contract as :func:`plan_window_reduce_multi` for the BAND
    target space; every device's slab must plan or the whole thing
    falls back (one SPMD program serves every shard)."""
    import numpy as np

    plans = []
    for d_i, cam in enumerate(cam_list):
        p = plan_window_reduce_banded(
            cam, n_a, K, CH, bw, budget,
            None if mask_list is None else mask_list[d_i])
        if p is None:
            return None
        plans.append(p)
    W_band = max(p[2] for p in plans)
    W_slot = max(p[7] for p in plans)

    def _pad_seg(seg, W):
        out = np.zeros((seg.shape[0], W), np.int64)
        out[:, :seg.shape[1]] = seg
        return out

    return (np.stack([p[0] for p in plans]),
            np.stack([_pad_seg(p[1], W_band) for p in plans]), W_band,
            np.stack([p[3] for p in plans]),
            np.stack([p[4] for p in plans]),
            np.stack([p[5] for p in plans]),
            np.stack([_pad_seg(p[6], W_slot) for p in plans]), W_slot,
            bw)


def make_banded_window_chunk_loop(n_a: int, K: int, da: int, db: int,
                                  dtype, CH: int, W_band: int,
                                  W_slot: int):
    """The BANDED windowed pass-A chunk loop with loc/orientation
    tables as ARGUMENTS (sharded callers ship per-device tables):
    ``loop(E_p, Cd_p, g_b_p, loc_band (n_chunks, CH·(P_tri+K)),
    loc_slot (n_chunks, CH·K), w1, w2 (n_chunks, CH·P_tri)) ->
    (part_band (n_chunks·W_band, da²), part_rhs, Cinv_f)``.
    """
    P_tri = K * (K - 1) // 2
    eye = jnp.eye(db, dtype=dtype)
    ks_j = jnp.asarray([k for k in range(K) for l in range(k)],
                       jnp.int32)
    ls_j = jnp.asarray([l for k in range(K) for l in range(k)],
                       jnp.int32)

    def chunk_loop(E_p, Cd_p, g_b_p, loc_band_t, loc_slot_t, w1_j,
                   w2_j):
        n_p = Cd_p.shape[0]
        n_chunks = n_p // CH

        def _sl(arr, c):
            return jax.lax.dynamic_slice_in_dim(arr, c * CH, CH, 0)

        def bodyA(c, carry):
            part_band, part_rhs, Cinv_f = carry
            E_c = _sl(E_p, c).reshape(CH, K, da, db)
            Cd_c = _sl(Cd_p, c).reshape(CH, db, db)
            g_b_c = _sl(g_b_p, c)
            Cinv_c, blocks_tri, blocks_diag, rhs_rows = \
                _pair_block_chunk(E_c, Cd_c, g_b_c, ks_j, ls_j, eye,
                                  dtype)
            bt = blocks_tri.reshape(CH * P_tri, da, da)
            w1c = jax.lax.dynamic_slice_in_dim(
                w1_j, c, 1, 0)[0].astype(dtype)[:, None]
            w2c = jax.lax.dynamic_slice_in_dim(
                w2_j, c, 1, 0)[0].astype(dtype)[:, None]
            oriented = (w1c * bt.reshape(-1, da * da)
                        + w2c * jnp.swapaxes(bt, -1, -2)
                        .reshape(-1, da * da))
            rows = jnp.concatenate(
                [oriented, blocks_diag.reshape(CH * K, da * da)])
            lb = jax.lax.dynamic_slice_in_dim(loc_band_t, c, 1, 0)[0]
            lsl = jax.lax.dynamic_slice_in_dim(loc_slot_t, c, 1, 0)[0]
            w_band = _onehot_sum(lb, rows, W_band)
            w_rhs = _onehot_sum(lsl, rhs_rows.reshape(-1, da), W_slot)
            part_band = jax.lax.dynamic_update_slice_in_dim(
                part_band, w_band, c * W_band, 0)
            part_rhs = jax.lax.dynamic_update_slice_in_dim(
                part_rhs, w_rhs, c * W_slot, 0)
            Cinv_f = jax.lax.dynamic_update_slice_in_dim(
                Cinv_f, Cinv_c.reshape(CH, db * db), c * CH, 0)
            return part_band, part_rhs, Cinv_f

        init = (jnp.zeros((n_chunks * W_band, da * da), dtype),
                jnp.zeros((n_chunks * W_slot, da), dtype),
                jnp.zeros((n_p, db * db), dtype))
        return jax.lax.fori_loop(0, n_chunks, bodyA, init)

    return chunk_loop


def make_reduce_pass_window_banded(n_a: int, K: int, da: int, db: int,
                                   dtype, CH: int, plan):
    """Pass A reducing straight into BAND storage (windowed matmul sums).

    Returns a reduce with the signature of the other passes but whose
    first output is ``S_low`` flat (n_a·(bw+1), da²) band entries
    (:func:`band_to_tridiag` semantics) instead of the (n_a², da²)
    dense-flat S — the (n_a, n_a) grid never exists, which is what
    lifts the camera-count memory ceiling (14.4 GB at 10k cameras).
    """
    (loc_band, seg_band, W_band, w1_t, w2_t,
     loc_slot, seg_slot, W_slot, bw) = plan
    bw1 = bw + 1
    fin_band = make_planned_segment_reduce(seg_band.ravel(),
                                           n_a * bw1)
    fin_slot = make_planned_segment_reduce(seg_slot.ravel(), n_a)
    loc_band_t = jnp.asarray(loc_band)
    loc_slot_t = jnp.asarray(loc_slot)
    w1_j = jnp.asarray(w1_t)
    w2_j = jnp.asarray(w2_t)
    chunk_loop = make_banded_window_chunk_loop(n_a, K, da, db, dtype,
                                               CH, W_band, W_slot)

    def reduce_pass(E_p, Cd_p, cam_p, g_b_p):
        part_band, part_rhs, Cinv_f = chunk_loop(
            E_p, Cd_p, g_b_p, loc_band_t, loc_slot_t, w1_j, w2_j)
        # barrier: see make_reduce_pass_window (XLA CPU scatter-fusion
        # miscompilation across the fori boundary)
        part_band, part_rhs = jax.lax.optimization_barrier(
            (part_band, part_rhs))
        S_low = fin_band(part_band)
        rhs = fin_slot(part_rhs)
        return S_low, rhs, Cinv_f

    return reduce_pass


def camera_sort_perm(cam_idx_np, mask_np, n_a: int, K: int,
                     chunk: int = 1024):
    """Static landmark permutation that makes chunks camera-local, or
    None when sorting is unnecessary (the natural order already admits a
    window plan) or unhelpful (even sorted, chunks touch too many
    distinct camera pairs).

    Landmark order is semantically arbitrary in the point-major layout;
    sorting by primary (minimum masked) camera makes each chunk of
    points touch a small camera window, which is what lets the reduced-
    system assembly run as matmuls (:func:`plan_window_reduce`) instead
    of a gather per row.  The permutation is applied
    through the bucket machinery (one sorted slab), so the public
    contract — x in the caller's landmark order — is unchanged.
    """
    import numpy as np

    if not _window_enabled():
        return None
    cam = np.asarray(cam_idx_np, np.int64)
    mk = np.asarray(mask_np) != 0
    n_b = cam.shape[0]
    step = min(chunk, max(n_b, 1))
    n_bp = int(-(-n_b // step) * step)
    CH = _pick_chunk(n_bp, chunk)

    def _padded(c):
        padn = n_bp - c.shape[0]
        if padn:
            c = np.concatenate([c, np.zeros((padn, K), np.int64)])
        return c

    def _padded_mk(m):
        padn = n_bp - m.shape[0]
        if padn:
            m = np.concatenate([m, np.zeros((padn, K), bool)])
        return m

    if plan_window_reduce(_padded(cam), n_a, K, CH,
                          mask_np=_padded_mk(mk)) is not None:
        return None
    primary = np.where(mk, cam, np.iinfo(np.int64).max).min(axis=1)
    primary = np.where(mk.any(axis=1), primary, 0)
    perm = np.argsort(primary, kind="stable")
    if plan_window_reduce(_padded(cam[perm]), n_a, K, CH,
                          mask_np=_padded_mk(mk[perm])) is None:
        return None
    return perm


def make_window_chunk_loop(n_a: int, K: int, da: int, db: int, dtype,
                           CH: int, W_tri: int, W_slot: int):
    """The windowed pass-A chunk loop with the local-id tables as
    ARGUMENTS (so sharded callers can ship per-device tables):
    ``loop(E_p, Cd_p, g_b_p, loc_tri (n_chunks, CH·P_tri), loc_slot
    (n_chunks, CH·K)) -> (part_tri (n_chunks·W_tri, da²), part_diag,
    part_rhs, Cinv_f)``.

    Precision: the onehot matmuls run at HIGHEST (at DEFAULT a GPU may
    round the f32 block operand to TF32);
    one operand is exactly 0/1, so HIGHEST here costs only the small
    (W, rows)·(rows, da²) products.  Padded window rows accumulate
    exact zeros into segment 0 of the final reduce.
    """
    eye = jnp.eye(db, dtype=dtype)
    ks_j = jnp.asarray([k for k in range(K) for l in range(k)],
                       jnp.int32)
    ls_j = jnp.asarray([l for k in range(K) for l in range(k)],
                       jnp.int32)

    def chunk_loop(E_p, Cd_p, g_b_p, loc_tri_t, loc_slot_t):
        n_p = Cd_p.shape[0]
        n_chunks = n_p // CH

        def _sl(arr, c):
            return jax.lax.dynamic_slice_in_dim(arr, c * CH, CH, 0)

        def bodyA(c, carry):
            part_tri, part_diag, part_rhs, Cinv_f = carry
            E_c = _sl(E_p, c).reshape(CH, K, da, db)
            Cd_c = _sl(Cd_p, c).reshape(CH, db, db)
            g_b_c = _sl(g_b_p, c)
            Cinv_c, blocks_tri, blocks_diag, rhs_rows = \
                _pair_block_chunk(E_c, Cd_c, g_b_c, ks_j, ls_j, eye,
                                  dtype)
            lt = jax.lax.dynamic_slice_in_dim(loc_tri_t, c, 1, 0)[0]
            lsl = jax.lax.dynamic_slice_in_dim(loc_slot_t, c, 1, 0)[0]
            w_tri = _onehot_sum(lt, blocks_tri.reshape(-1, da * da),
                                W_tri)
            w_diag = _onehot_sum(lsl, blocks_diag.reshape(-1, da * da),
                                 W_slot)
            w_rhs = _onehot_sum(lsl, rhs_rows.reshape(-1, da), W_slot)
            part_tri = jax.lax.dynamic_update_slice_in_dim(
                part_tri, w_tri, c * W_tri, 0)
            part_diag = jax.lax.dynamic_update_slice_in_dim(
                part_diag, w_diag, c * W_slot, 0)
            part_rhs = jax.lax.dynamic_update_slice_in_dim(
                part_rhs, w_rhs, c * W_slot, 0)
            Cinv_f = jax.lax.dynamic_update_slice_in_dim(
                Cinv_f, Cinv_c.reshape(CH, db * db), c * CH, 0)
            return part_tri, part_diag, part_rhs, Cinv_f

        init = (jnp.zeros((n_chunks * W_tri, da * da), dtype),
                jnp.zeros((n_chunks * W_slot, da * da), dtype),
                jnp.zeros((n_chunks * W_slot, da), dtype),
                jnp.zeros((n_p, db * db), dtype))
        return jax.lax.fori_loop(0, n_chunks, bodyA, init)

    return chunk_loop


def _onehot_sum(loc_row, rows, W):
    oh = (loc_row[None, :] == jax.lax.broadcasted_iota(
        jnp.int32, (W, 1), 0)).astype(rows.dtype)
    return jax.lax.dot(oh, rows, precision=jax.lax.Precision.HIGHEST)


def make_reduce_pass_window(n_a: int, K: int, da: int, db: int, dtype,
                            CH: int, plan):
    """Pass A with per-chunk WINDOWED matmul reductions — same contract as
    :func:`make_reduce_pass_planned`; ``plan`` from
    :func:`plan_window_reduce` (see :func:`make_window_chunk_loop` for
    the precision contract).
    """
    loc_tri, seg_tri, W_tri, loc_slot, seg_slot, W_slot = plan
    fin_tri = make_planned_segment_reduce(seg_tri.ravel(), n_a * n_a)
    fin_slot = make_planned_segment_reduce(seg_slot.ravel(), n_a)
    loc_tri_t = jnp.asarray(loc_tri)
    loc_slot_t = jnp.asarray(loc_slot)
    chunk_loop = make_window_chunk_loop(n_a, K, da, db, dtype, CH,
                                        W_tri, W_slot)

    def reduce_pass(E_p, Cd_p, cam_p, g_b_p):
        part_tri, part_diag, part_rhs, Cinv_f = chunk_loop(
            E_p, Cd_p, g_b_p, loc_tri_t, loc_slot_t)
        # Fusing the final scatter-set reduces with the fori-loop
        # producers miscompiles on the XLA CPU backend (wrong diagonal
        # segments; fuzz seeds 1/2, jax 0.9.0) — the barrier
        # materializes the (small) partials and keeps the reduces in
        # their own computation.
        part_tri, part_diag, part_rhs = jax.lax.optimization_barrier(
            (part_tri, part_diag, part_rhs))
        S_f = fin_tri(part_tri)
        S_diag = fin_slot(part_diag)
        rhs = fin_slot(part_rhs)
        return (_reconstruct_S(S_f, S_diag, n_a, da), rhs, Cinv_f)

    return reduce_pass


def _reconstruct_S(S_f, S_diag, n_a, da):
    """S(i,i') = X(i,i') + X(i',i)ᵀ + δ(i,i')·diag, flat (n_a², da²).

    The diagonal placement is a scatter-free eye-broadcast rather than
    ``X.at[idx, idx].add``: the fancy double-index diagonal scatter-add
    MISCOMPILES on the XLA CPU backend when fused into the windowed-
    reduce graph (jit-vs-eager divergence, isolated by
    tests/test_fuzz_sparse.py TestWindowBandFuzz; jax 0.9.0) — the
    broadcast form is algebraically identical and fusion-safe.
    """
    X = S_f.reshape(n_a, n_a, da, da)
    X = X + X.transpose(1, 0, 3, 2)
    eye = jnp.eye(n_a, dtype=S_f.dtype)[:, :, None, None]
    X = X + eye * S_diag.reshape(n_a, 1, da, da)
    return X.reshape(n_a * n_a, da * da)


def detect_camera_bandwidth(cam_idx_np, mask_np) -> int:
    """Max camera-index span co-observing any landmark (host-side).

    The reduced camera system S couples cameras i, i' only when some
    landmark sees both, so ``bw = max_j (max cam(j) − min cam(j))``
    bounds S's block bandwidth.  Masked slots are excluded (their cam
    index is a pad 0).  Corridor / rail / sequential-SLAM rigs have
    bw ≪ n_cams; unordered SfM sets typically do not.
    """
    import numpy as np

    cam = np.asarray(cam_idx_np, np.int64)
    mk = np.asarray(mask_np) != 0
    big = np.where(mk, cam, np.iinfo(np.int64).max)
    small = np.where(mk, cam, np.iinfo(np.int64).min)
    lo = big.min(axis=1)
    hi = small.max(axis=1)
    span = np.where(mk.any(axis=1), hi - lo, 0)
    return int(span.max()) if span.size else 0


def pick_band_group(bw_cams: int, n_a: int, da: int,
                    max_block: int = 384, min_groups: int = 8
                    ) -> int | None:
    """Group size (cameras) for the block-banded reduced solve, or None
    when the structure does not pay: groups of ``g ≥ bw`` cameras make
    S block-TRIDIAGONAL over ⌈n_a/g⌉ groups (any co-observing pair
    lands in the same or adjacent group), solvable by the chain
    machinery in O(n_a·(g·da)²) instead of the dense (n_a·da)³/3 —
    1900× fewer flops at the 1000-camera corridor flagship.  Gated to
    blocks ≤ ``max_block`` tangent dims and ≥ ``min_groups`` groups
    (below that the dense Cholesky is comparable)."""
    g = max(bw_cams, 1)
    if g * da > max_block:
        return None
    if n_a // g < min_groups:
        return None
    return g


def banded_reduced_solve(S_blocks, rhs, band_group: int, refine: int = 0):
    """Solve the block-BANDED reduced camera system by log-depth block
    cyclic reduction (ops/tridiag.py) instead of a dense Cholesky.

    ``S_blocks`` (n_a, n_a, da, da) with bandwidth < ``band_group``
    camera blocks; cameras group into consecutive ``band_group``-sized
    super-blocks → an exactly block-tridiagonal SPD system (identity
    padding completes the last group).  ``refine`` rounds of
    f64-residual iterative refinement re-solve through the same CR
    (each CR pass is O(n_a·(g·da)²) — cheap enough to repeat).
    Returns ``(dx (n_s,), ok)``.
    """
    from .tridiag import block_tridiag_cr_solve

    n_a, _, da, _ = S_blocks.shape
    g = band_group
    Ng = -(-n_a // g)
    pad = Ng * g - n_a
    d_blk = g * da
    dtype = S_blocks.dtype

    Sd = S_blocks.transpose(0, 2, 1, 3).reshape(n_a * da, n_a * da)
    n_s = n_a * da
    if pad:
        Sp = jnp.zeros((Ng * d_blk, Ng * d_blk), dtype)
        Sp = Sp.at[:n_s, :n_s].set(Sd)
        idx = jnp.arange(n_s, Ng * d_blk)
        Sp = Sp.at[idx, idx].set(1.0)     # decoupled identity pad
        rhs_p = jnp.concatenate(
            [rhs, jnp.zeros((Ng * d_blk - n_s,), dtype)])
    else:
        Sp, rhs_p = Sd, rhs
    S4 = Sp.reshape(Ng, d_blk, Ng, d_blk)
    ig = jnp.arange(Ng)
    D = S4[ig, :, ig, :]                              # (Ng, d, d)
    B = S4[ig[1:], :, ig[:-1], :] if Ng > 1 \
        else jnp.zeros((0, d_blk, d_blk), dtype)
    x = _tridiag_cr_refine(D, B, rhs_p.reshape(Ng, d_blk), refine,
                           dtype)
    dx = x.reshape(-1)[:n_s]
    return dx, jnp.all(jnp.isfinite(dx))


def _tridiag_cr_refine(D, B, b2, refine: int, dtype):
    """CR solve of the (D, B) block-tridiagonal system with f64-residual
    iterative refinement through the BANDED matvec (shared by the dense-
    and band-storage assembly paths)."""
    from .tridiag import block_tridiag_cr_solve

    Ng = D.shape[0]
    x = block_tridiag_cr_solve(D, B, b2)
    if refine > 0:
        D64 = D.astype(jnp.float64)
        B64 = B.astype(jnp.float64)
        b64 = b2.astype(jnp.float64)
        for _ in range(refine):
            x64 = x.astype(jnp.float64)
            Sx = jnp.einsum("nab,nb->na", D64, x64)
            if Ng > 1:
                Sx = Sx.at[1:].add(
                    jnp.einsum("nab,nb->na", B64, x64[:-1]))
                Sx = Sx.at[:-1].add(
                    jnp.einsum("nba,nb->na", B64, x64[1:]))
            r = (b64 - Sx).astype(dtype)
            corr = block_tridiag_cr_solve(D, B, r)
            good = jnp.all(jnp.isfinite(corr))
            x = x + jnp.where(good, corr, jnp.zeros_like(corr))
    return x


def band_to_tridiag(S_low, Bd, band_group: int):
    """Assemble the (D, B) super-block tridiagonals of the reduced
    camera system DIRECTLY from band storage — never materializing the
    (n_a, n_a) dense S (the memory ceiling of the flat path: 14.4 GB at
    10k cameras vs ~20 MB here).

    ``S_low`` (n_a, bw+1, da, da): band entry (i, o) holds the summed
    camera-pair coupling X(i, i−o) + X(i−o, i)ᵀ for o ≥ 1 and the full
    diagonal sum X(i,i)+X(i,i)ᵀ+Σ_k E C⁻¹ Eᵀ at o = 0, so
    S(i, j≤i) = δ_ij·Bd_i − S_low[i, i−j].  Static numpy index maps
    gather band entries into super-block positions; out-of-band
    positions read a sentinel zero row.
    """
    import numpy as np

    n_a, bw1, da, _ = S_low.shape
    g = band_group
    Ng = -(-n_a // g)
    d_blk = g * da
    dtype = S_low.dtype
    flatz = jnp.concatenate(
        [S_low.reshape(n_a * bw1, da, da),
         jnp.zeros((1, da, da), dtype)])
    sent = n_a * bw1

    def gather_blocks(i_of, o_of):
        """(n, g, g) maps of (camera row i, band offset o) → stacked
        (n, d_blk, d_blk); invalid (i<0, i>=n_a, o<0, o>bw) → zero."""
        i_of, o_of = np.broadcast_arrays(i_of, o_of)
        n = i_of.shape[0]
        ok = ((i_of >= 0) & (i_of < n_a) & (o_of >= 0) & (o_of < bw1))
        idx = np.where(ok, i_of * bw1 + o_of, sent)
        blk = jnp.take(flatz, jnp.asarray(idx.reshape(-1)), axis=0)
        return (blk.reshape(n, g, g, da, da)
                .transpose(0, 1, 3, 2, 4)
                .reshape(n, d_blk, d_blk))

    G = np.arange(Ng)[:, None, None]
    p = np.arange(g)[None, :, None]
    q = np.arange(g)[None, None, :]
    # D strictly-lower: i = G*g+p, j = G*g+q, o = p−q ≥ 1
    L = gather_blocks(np.broadcast_to(G * g + p, (Ng, g, g)),
                      np.broadcast_to(np.where(p > q, p - q, -1),
                                      (Ng, g, g)))
    D = -(L + jnp.swapaxes(L, -1, -2))
    # D diagonal: Bd − S_low[:, 0], identity pad past n_a
    d0 = Bd - S_low[:, 0]
    padn = Ng * g - n_a
    if padn:
        eye = jnp.broadcast_to(jnp.eye(da, dtype=dtype),
                               (padn, da, da))
        d0 = jnp.concatenate([d0, eye])
    d0 = d0.reshape(Ng, g, da, da)
    for pp in range(g):
        D = D.at[:, pp * da:(pp + 1) * da,
                 pp * da:(pp + 1) * da].add(d0[:, pp])
    if Ng > 1:
        # B[G] couples group G+1 rows to group G cols:
        # i = (G+1)*g+p, j = G*g+q, o = g+p−q ∈ [1, 2g−1]
        Gb = np.arange(Ng - 1)[:, None, None]
        B = -gather_blocks(
            np.broadcast_to((Gb + 1) * g + p, (Ng - 1, g, g)),
            np.broadcast_to(g + p - q, (Ng - 1, g, g)))
    else:
        B = jnp.zeros((0, d_blk, d_blk), dtype)
    return D, B


def banded_reduced_solve_band(S_low, Bd, rhs, band_group: int,
                              refine: int = 0):
    """Banded reduced camera solve FROM BAND STORAGE (no dense S).

    Same semantics as :func:`banded_reduced_solve` (CR + f64 banded
    refine), with S given as ``S_low`` (n_a, bw+1, da, da) band entries
    (see :func:`band_to_tridiag`).  Returns ``(dx (n_s,), ok)``.
    """
    n_a, _, da, _ = S_low.shape
    g = band_group
    Ng = -(-n_a // g)
    d_blk = g * da
    n_s = n_a * da
    dtype = S_low.dtype
    with jax.default_matmul_precision("highest"):
        D, B = band_to_tridiag(S_low, Bd, g)
        rhs_p = rhs.reshape(-1)
        if Ng * d_blk != n_s:
            rhs_p = jnp.concatenate(
                [rhs_p, jnp.zeros((Ng * d_blk - n_s,), dtype)])
        x = _tridiag_cr_refine(D, B, rhs_p.reshape(Ng, d_blk), refine,
                               dtype)
    dx = x.reshape(-1)[:n_s]
    return dx, jnp.all(jnp.isfinite(dx))


def camera_marginals_from_S(S_f, Ba):
    """Per-camera marginal covariance from the completed pass-A sums.

    ``S = diag(Ba) − scatter(S_f)`` is the UNDAMPED reduced camera
    system at the solution; its inverse is exactly the camera block of
    H⁻¹ (marginalizing landmarks IS the Schur complement), so the
    camera marginals are S⁻¹'s diagonal da×da blocks — no full-H solve
    (reference: math.h:88-189 inverts dense H; output.h:80-93).
    Returns ``(cov_a (n_a, da, da), Sinv (n_a·da, n_a·da))`` — Sinv is
    reused by the landmark-marginal pass.  NaNs if S is singular
    (gauge not fixed), matching ops/linalg.inv_cov's contract.
    """
    n_a, da, _ = Ba.shape
    idx = jnp.arange(n_a)
    S_blocks = -S_f.reshape(n_a, n_a, da, da) \
        + jnp.eye(n_a, dtype=S_f.dtype)[:, :, None, None] \
        * Ba.reshape(n_a, 1, da, da)
    S = S_blocks.transpose(0, 2, 1, 3).reshape(n_a * da, n_a * da)
    # HIGHEST: the assembled S is ill-conditioned at BA scale and at
    # DEFAULT a GPU may round the solve's dot_generals to TF32
    # (assemble_reduced rationale).
    with jax.default_matmul_precision("highest"):
        Sinv = inv_cov(S)
    cov_a = Sinv.reshape(n_a, da, n_a, da)[idx, :, idx, :]
    return cov_a, Sinv


def make_landmark_marginal_pass(n_a: int, K: int, da: int, db: int,
                                dtype, CH: int):
    """Factory for the landmark-marginal pass.

    Returns ``pass(E_p, Cinv_p, cam_p, Sinv) -> cov_b (n_p, db, db)``
    computing the diagonal landmark blocks of H⁻¹,

        cov_b(j) = C_j⁻¹ + Σ_{k,l} W_jkᵀ · Sinv[cam_jk, cam_jl] · W_jl,
        W_jk = E_jk C_j⁻¹            (cov_bb = C⁻¹ + C⁻¹EᵀS⁻¹EC⁻¹),

    chunked over points: every expanded tensor is O(CH · K² · da²) —
    the Sinv block gather is the largest transient (CH·K²·da²).  Padded
    points (zero E, identity C⁻¹) come out as identity blocks; callers
    trim them.
    """
    def _sl(arr, c):
        return jax.lax.dynamic_slice_in_dim(arr, c * CH, CH, 0)

    def _upd(arr, val, c):
        return jax.lax.dynamic_update_slice_in_dim(arr, val, c * CH, 0)

    def marginal_pass(E_p, Cinv_p, cam_p, Sinv):
        n_p = cam_p.shape[0]
        Sinv4 = Sinv.reshape(n_a, da, n_a, da).transpose(0, 2, 1, 3)

        def body(c, cov_f):
            E_c = _sl(E_p, c).reshape(CH, K, da, db)
            Cinv_c = _sl(Cinv_p, c).reshape(CH, db, db)
            cam_c = _sl(cam_p, c)
            W = _esum("jkab,jbc->jkac", E_c, Cinv_c,
                      preferred_element_type=dtype)      # (CH, K, da, db)
            Sb = Sinv4[cam_c[:, :, None], cam_c[:, None, :]]
            Mv = _esum("jklab,jlbd->jkad", Sb, W,
                       preferred_element_type=dtype)     # Σ_l Sb·W_l
            corr = _esum("jkab,jkac->jbc", W, Mv,
                         preferred_element_type=dtype)
            return _upd(cov_f, (Cinv_c + corr).reshape(CH, db * db), c)

        cov_f = jax.lax.fori_loop(
            0, n_p // CH, body, jnp.zeros((n_p, db * db), dtype))
        return cov_f.reshape(n_p, db, db)

    return marginal_pass


def banded_cov_plan(cam_idx, mask, n_a: int, da: int,
                    chunk: int = 1024):
    """(band_group, bw, bplan) enabling the banded covariance route
    (:func:`obs_marginals_banded`), or None when the structure/plan
    does not admit it (concrete indices required; window gate applies).
    """
    import numpy as np

    try:
        if not getattr(cam_idx, "is_fully_addressable", True):
            return None
        cam = np.asarray(cam_idx, np.int64)
        mk = np.asarray(mask)
    except Exception:
        return None
    bw = detect_camera_bandwidth(cam, mk)
    g = pick_band_group(bw, n_a, da)
    if g is None:
        return None
    n_b, K = cam.shape
    step = min(chunk, max(n_b, 1))
    n_bp = int(-(-n_b // step) * step)
    CH = _pick_chunk(n_bp, chunk)
    if n_bp != n_b:
        cam = np.concatenate(
            [cam, np.zeros((n_bp - n_b, K), np.int64)])
        mk = np.concatenate(
            [mk, np.zeros((n_bp - n_b, K), mk.dtype)])
    bplan = plan_window_reduce_banded(cam, n_a, K, CH, bw, mask_np=mk)
    if bplan is None:
        return None
    return g, bw, bplan


def make_landmark_marginal_pass_banded(n_a: int, K: int, da: int,
                                       db: int, dtype, CH: int,
                                       band_group: int):
    """Landmark-marginal pass reading S⁻¹ from its BANDED selected
    inverse instead of the dense (n_a·da)² matrix.

    Any two cameras co-observing a landmark are within the bandwidth,
    hence in the same or ADJACENT super-blocks — so the dense pass's
    ``Sinv[cam_k, cam_l]`` gather becomes three masked gathers from the
    selected inverse's diagonal and sub-diagonal super-blocks
    (:func:`tinyopt_tpu.ops.tridiag.block_tridiag_selected_inverse_sub`).
    ``pass(E_p, Cinv_p, cam_p, Sig_diag (Ng, d_blk, d_blk), Sig_sub
    (Ng−1, d_blk, d_blk)) -> cov_b (n_p, db, db)``.
    """
    g = band_group

    def _sl(arr, c):
        return jax.lax.dynamic_slice_in_dim(arr, c * CH, CH, 0)

    def _upd(arr, val, c):
        return jax.lax.dynamic_update_slice_in_dim(arr, val, c * CH, 0)

    def marginal_pass(E_p, Cinv_p, cam_p, Sig_diag, Sig_sub):
        n_p = cam_p.shape[0]
        Ng = Sig_diag.shape[0]
        # (Ng, g, g, da, da) flat sub-block tables + a zero sentinel
        def _blocks(S):
            n = S.shape[0]
            return jnp.concatenate([
                S.reshape(n, g, da, g, da).transpose(0, 1, 3, 2, 4)
                .reshape(n * g * g, da, da),
                jnp.zeros((1, da, da), S.dtype)])

        diag_b = _blocks(Sig_diag)
        sub_b = _blocks(Sig_sub) if Sig_sub.shape[0] else \
            jnp.zeros((1, da, da), Sig_diag.dtype)
        n_diag = Ng * g * g
        n_sub = max(Sig_sub.shape[0], 0) * g * g

        def body(c, cov_f):
            E_c = _sl(E_p, c).reshape(CH, K, da, db)
            Cinv_c = _sl(Cinv_p, c).reshape(CH, db, db)
            cam_c = _sl(cam_p, c)
            G = cam_c // g
            p = cam_c % g
            Gk, Gl = G[:, :, None], G[:, None, :]
            pk, pl = p[:, :, None], p[:, None, :]
            same = Gk == Gl
            up = Gk == Gl + 1            # Σ_{Gk, Gl} = Sub[Gl]
            down = Gl == Gk + 1          # transpose of Sub[Gk]
            idx_same = jnp.where(same, Gk * g * g + pk * g + pl,
                                 n_diag)
            idx_up = jnp.where(up, Gl * g * g + pk * g + pl, n_sub)
            idx_dn = jnp.where(down, Gk * g * g + pl * g + pk, n_sub)
            Sb = (diag_b[idx_same]
                  + sub_b[jnp.minimum(idx_up, n_sub)]
                  + jnp.swapaxes(sub_b[jnp.minimum(idx_dn, n_sub)],
                                 -1, -2))          # (CH, K, K, da, da)
            W = _esum("jkab,jbc->jkac", E_c, Cinv_c,
                      preferred_element_type=dtype)
            Mv = _esum("jklab,jlbd->jkad", Sb, W,
                       preferred_element_type=dtype)
            corr = _esum("jkab,jkac->jbc", W, Mv,
                         preferred_element_type=dtype)
            return _upd(cov_f, (Cinv_c + corr).reshape(CH, db * db), c)

        cov_f = jax.lax.fori_loop(
            0, n_p // CH, body, jnp.zeros((n_p, db * db), dtype))
        return cov_f.reshape(n_p, db, db)

    return marginal_pass


def obs_marginals_banded(H: "SchurObsSystem", band_group: int, bw: int,
                         bplan, chunk: int = 1024):
    """:func:`obs_marginals` through BAND storage — covariance at the
    10k-camera ceiling: the reduced system reduces into n_a·(bw+1) band
    entries, its selected inverse (diag + sub-diagonal super-blocks)
    costs O(Ng·d_blk³), and neither the (n_a, n_a) S grid nor the dense
    (n_a·da)² S⁻¹ ever exists.  Exact algebra — f64 parity with the
    dense path is pinned in tests.
    """
    n_a, da, n_b, db, K = H._dims()
    dtype = H.dtype
    g = band_group
    step = min(chunk, max(n_b, 1))
    n_bp = int(-(-n_b // step) * step)
    pad = n_bp - n_b
    CH = _pick_chunk(n_bp, chunk)

    def _pad_rows(arr):
        if not pad:
            return arr
        return jnp.concatenate(
            [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])

    E_p = _pad_rows(H.E)
    C_p = _pad_rows(H.C)
    cam_p = _pad_rows(H.cam_idx)
    reduce_band = make_reduce_pass_window_banded(n_a, K, da, db, dtype,
                                                 CH, bplan)
    S_low, _, Cinv_p = reduce_band(E_p, C_p, cam_p,
                                   jnp.zeros((n_bp, db), dtype))
    from .tridiag import (block_tridiag_factor,
                          block_tridiag_selected_inverse_sub)
    with jax.default_matmul_precision("highest"):
        D, B = band_to_tridiag(S_low.reshape(n_a, bw + 1, da, da),
                               H.Ba, g)
        L, M, _ = block_tridiag_factor(D, B)
        Sig_diag, Sig_sub = block_tridiag_selected_inverse_sub(L, M)
    # per-camera marginals: the diagonal da-blocks of Sig_diag
    Ng = Sig_diag.shape[0]
    diag_flat = Sig_diag.reshape(Ng, g, da, g, da) \
        .transpose(0, 1, 3, 2, 4).reshape(Ng * g * g, da, da)
    cams = jnp.arange(n_a)
    cov_a = diag_flat[(cams // g) * g * g + (cams % g) * (g + 1)]
    marginal_pass = make_landmark_marginal_pass_banded(
        n_a, K, da, db, dtype, CH, g)
    cov_b = marginal_pass(E_p, Cinv_p, cam_p, Sig_diag, Sig_sub)[:n_b]
    dead = jnp.all(H.C == 0, axis=1)
    cov_b = jnp.where(dead[:, None, None], jnp.nan, cov_b)
    return cov_a, cov_b


def obs_marginals(H: "SchurObsSystem", chunk: int = 1024):
    """Posterior marginal covariance blocks of a sparse-obs BA solution.

    ``H`` must be the UNDAMPED system accumulated at the solution (what
    ``accumulate`` returns / ``Output.final_hessian`` carries).  Returns
    ``(cov_a (n_a, da, da), cov_b (n_b, db, db))`` — per-camera and
    per-landmark marginal covariance blocks of H⁻¹, computed from the
    factored reduced system: one (n_a·da)² inverse plus chunked
    per-point algebra, never a (dims)² dense solve (the full H⁻¹ of the
    1000-cam flagship would be 156k² ≈ 97 GB; these marginals are
    ~4 MB).  Block layout is element-major per camera/landmark.
    Rescaling (output.h:80-93) is applied by the
    ``schur_sparse_covariance`` entry, not here.
    """
    n_a, da, n_b, db, K = H._dims()
    dtype = H.dtype
    step = min(chunk, max(n_b, 1))
    n_bp = int(-(-n_b // step) * step)
    pad = n_bp - n_b
    CH = _pick_chunk(n_bp, chunk)

    def _pad_rows(arr):
        if not pad:
            return arr
        return jnp.concatenate(
            [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])

    E_p = _pad_rows(H.E)
    C_p = _pad_rows(H.C)
    cam_p = _pad_rows(H.cam_idx)
    reduce_pass = make_reduce_pass(n_a, K, da, db, dtype, CH)
    S_f, _, Cinv_p = reduce_pass(E_p, C_p, cam_p,
                                 jnp.zeros((n_bp, db), dtype))
    cov_a, Sinv = camera_marginals_from_S(S_f, H.Ba)
    marginal_pass = make_landmark_marginal_pass(n_a, K, da, db, dtype, CH)
    cov_b = marginal_pass(E_p, Cinv_p, cam_p, Sinv)[:n_b]
    # a landmark with no (unmasked) observations has a singular H row —
    # NaN per the inv_cov contract, not the identity block the
    # reduce_pass zero-C substitution would leak
    dead = jnp.all(H.C == 0, axis=1)
    cov_b = jnp.where(dead[:, None, None], jnp.nan, cov_b)
    return cov_a, cov_b


def obs_marginals_buckets(H: "SchurObsBuckets", ids_list,
                          chunk: int = 1024):
    """Posterior marginal covariance blocks of a K-BUCKETED solution.

    Same algebra as :func:`obs_marginals` with the reduced camera
    system summed over buckets; ``ids_list`` gives each bucket's
    original landmark indices (the ``ids`` of the slabs the system was
    built from).  Returns ``(cov_a (n_a, da, da), cov_b (n_b, db, db))``
    with ``cov_b`` in the ORIGINAL landmark order.
    """
    import numpy as np

    n_a, da, _ = H.Ba.shape
    db = int(round(math.isqrt(H.C[0].shape[1])))
    dtype = H.Ba.dtype
    ids_all = np.concatenate([np.asarray(i, np.int64) for i in ids_list])
    inv_order = jnp.asarray(np.argsort(ids_all), jnp.int32)

    S_f = jnp.zeros((n_a * n_a, da * da), dtype)
    stash = []
    for C_g, E_g, cam_g in zip(H.C, H.E, H.cam_idx):
        n_g, Kg = cam_g.shape
        step = min(chunk, max(n_g, 1))
        n_gp = int(-(-n_g // step) * step)
        pad = n_gp - n_g
        CH = _pick_chunk(n_gp, chunk)

        def _pad_rows(arr, pad=pad):
            if not pad:
                return arr
            return jnp.concatenate(
                [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])

        E_p, C_p, cam_p = (_pad_rows(E_g), _pad_rows(C_g),
                           _pad_rows(cam_g))
        reduce_pass = make_reduce_pass(n_a, Kg, da, db, dtype, CH)
        S_g, _, Cinv_p = reduce_pass(E_p, C_p, cam_p,
                                     jnp.zeros((n_gp, db), dtype))
        S_f = S_f + S_g
        stash.append((E_p, Cinv_p, cam_p, Kg, CH, n_g))

    cov_a, Sinv = camera_marginals_from_S(S_f, H.Ba)
    cov_rows = []
    for (E_p, Cinv_p, cam_p, Kg, CH, n_g), C_g in zip(stash, H.C):
        mp = make_landmark_marginal_pass(n_a, Kg, da, db, dtype, CH)
        rows = mp(E_p, Cinv_p, cam_p, Sinv)[:n_g]
        dead = jnp.all(C_g == 0, axis=1)     # inv_cov NaN contract
        cov_rows.append(jnp.where(dead[:, None, None], jnp.nan, rows))
    cov_b = jnp.concatenate(cov_rows)[inv_order]
    return cov_a, cov_b


def make_obs_kernels(pair_fn: Callable, a_template, spec_a, spec_b,
                     dtype, n_a: int, K: int, CH: int,
                     cam_idx_np=None, mask_np=None):
    """Chunked slab kernels over a point-major slab (length = CH multiple).

    ``cam_idx_np``: the PADDED (n_p, K) camera indices as a concrete
    host array — when given, ``reduce_pass`` uses the PLANNED
    scatter-free reduction (:func:`make_reduce_pass_planned`; the
    camera topology is static per solver instance, measured 2.4× on
    the flagship reduce stage); when None, the chunked-scatter
    ``reduce_pass`` is used.  The SHARDED path builds its own
    per-device plans (make_planned_segment_reduce_multi) and passes
    them as sharded arguments, falling back to the scatter pass for
    multi-process global arrays.

    Every function operates on a SLAB — the point-major padded arrays of
    however many landmarks one device holds (all of them on one device;
    a landmark shard under ``shard_map``).  Padded points must carry
    mask 0 / cam_idx 0 / zero obs, which makes their every contribution
    exactly zero; zero C blocks are substituted by identity before the
    Cholesky so they cannot poison the scatters with NaNs.

    Camera-side outputs (``Ba``/``g_a``/``rss`` of ``accumulate_slab``;
    ``S_f``/``rhs_acc`` of ``reduce_pass``) are cross-slab PARTIALS —
    sums over the slab's points — so multi-slab callers complete them
    with a reduction (``psum``); landmark-side outputs are the slab's
    own complete rows.
    """
    da, db = spec_a.dims, spec_b.dims
    eye = jnp.eye(db, dtype=dtype)

    def _sl(arr, c):
        return jax.lax.dynamic_slice_in_dim(arr, c * CH, CH, 0)

    def _upd(arr, val, c):
        return jax.lax.dynamic_update_slice_in_dim(arr, val, c * CH, 0)

    def accumulate_slab(a, b_p, obs_p, cam_p, mask_p):
        """(Ba, g_a, E_f, C_f, g_b, rss) over the slab (camera side =
        partials)."""
        n_p = cam_p.shape[0]

        def body(c, carry):
            Ba, g_a, E_f, C_f, g_b, rss = carry
            b_c = jax.tree_util.tree_map(lambda l: _sl(l, c), b_p)
            obs_c = jax.tree_util.tree_map(lambda l: _sl(l, c), obs_p)
            cam_c = _sl(cam_p, c)
            m_c = _sl(mask_p, c)
            r, Ja, Jb = obs_linearize(pair_fn, a, b_c, obs_c, cam_c, m_c,
                                      spec_a, spec_b, dtype)
            Ba = Ba + jax.ops.segment_sum(
                _esum("jkra,jkrb->jkab", Ja, Ja,
                           preferred_element_type=dtype).reshape(
                               CH * K, da, da),
                cam_c.reshape(-1), num_segments=n_a)
            g_a = g_a + jax.ops.segment_sum(
                _esum("jkra,jkr->jka", Ja, r).reshape(CH * K, da),
                cam_c.reshape(-1), num_segments=n_a)
            E_f = _upd(E_f, _esum(
                "jkra,jkrb->jkab", Ja, Jb,
                preferred_element_type=dtype).reshape(CH, K * da * db), c)
            C_f = _upd(C_f, _esum(
                "jkra,jkrb->jab", Jb, Jb,
                preferred_element_type=dtype).reshape(CH, db * db), c)
            g_b = _upd(g_b, _esum("jkrb,jkr->jb", Jb, r), c)
            return Ba, g_a, E_f, C_f, g_b, rss + rss_exact(r)

        init = (jnp.zeros((n_a, da, da), dtype),
                jnp.zeros((n_a, da), dtype),
                jnp.zeros((n_p, K * da * db), dtype),
                jnp.zeros((n_p, db * db), dtype),
                jnp.zeros((n_p, db), dtype),
                jnp.zeros((), dtype))
        return jax.lax.fori_loop(0, n_p // CH, body, init)

    def evaluate_slab(a, b_p, obs_p, cam_p, mask_p):
        """Σ‖r‖² over the slab (a cross-slab partial)."""
        n_p = cam_p.shape[0]

        def pair_r(a_i, b_j, d_ij):
            return flatten_residuals(pair_fn(a_i, b_j, d_ij)).astype(dtype)

        def body(c, rss):
            b_c = jax.tree_util.tree_map(lambda l: _sl(l, c), b_p)
            obs_c = jax.tree_util.tree_map(lambda l: _sl(l, c), obs_p)
            cam_c = _sl(cam_p, c)
            m_c = _sl(mask_p, c)

            def point(b_j, d_j, cam_j, m_j):
                a_g = jax.tree_util.tree_map(lambda l: l[cam_j], a)
                return jax.vmap(
                    lambda a_k, d_k, m_k: pair_r(a_k, b_j, d_k) * m_k)(
                        a_g, d_j, m_j)

            r = jax.vmap(point)(b_c, obs_c, cam_c, m_c)
            return rss + rss_exact(r)

        return jax.lax.fori_loop(0, n_p // CH, body, jnp.zeros((), dtype))

    # Reduce-pass selection, fastest first (all static host decisions):
    #  1. WINDOWED matmul reduce — when every chunk touches few distinct
    #     camera-pair segments (camera-local layouts), the segment sums
    #     run as matmuls and no global row buffer exists; on by default
    #     on no platform (window_default);
    #  2. PLANNED gather reduce — stages all camera-pair rows
    #     (n_p·K(K-1)/2, da²) persistently (~200 MB at 50k landmarks)
    #     and gathers them; budget-gated (heavy-tail buckets with caps
    #     in the hundreds would blow device memory);
    #  3. chunk-transient scatter pass — the always-works fallback
    #     (traced index layouts, multi-process shards).
    window_plan = None
    if cam_idx_np is not None and _window_enabled():
        window_plan = plan_window_reduce(cam_idx_np, n_a, K, CH,
                                         mask_np=mask_np)
    if cam_idx_np is not None and window_plan is None:
        import numpy as _np
        staged = (int(_np.shape(cam_idx_np)[0]) * (K * (K - 1) // 2)
                  * da * da * jnp.dtype(dtype).itemsize)
        if staged > _PLANNED_STAGING_LIMIT:
            cam_idx_np = None
    if window_plan is not None:
        reduce_pass = make_reduce_pass_window(n_a, K, da, db, dtype,
                                              CH, window_plan)
    elif cam_idx_np is None:
        reduce_pass = make_reduce_pass(n_a, K, da, db, dtype, CH)
    else:
        reduce_pass = make_reduce_pass_planned(n_a, K, da, db, dtype,
                                               CH, cam_idx_np)

    def backsub_pass(E_p, Cinv_f, cam_p, g_b_p, dx_a):
        """Pass C: landmark back-substitution dx_b = C⁻¹(−g_b − Eᵀ dx_a)."""
        n_p = cam_p.shape[0]

        def bodyC(c, dx_b_f):
            E_c = _sl(E_p, c).reshape(CH, K, da, db)
            Cinv_c = _sl(Cinv_f, c).reshape(CH, db, db)
            cam_c = _sl(cam_p, c)
            dxa_g = dx_a[cam_c]                          # (CH, K, da)
            t = -_sl(g_b_p, c) - _esum("jkab,jka->jb", E_c, dxa_g)
            return _upd(dx_b_f, _esum("jbc,jc->jb", Cinv_c, t), c)

        return jax.lax.fori_loop(
            0, n_p // CH, bodyC, jnp.zeros((n_p, db), dtype))

    return accumulate_slab, evaluate_slab, reduce_pass, backsub_pass


def assemble_reduced(S_f, rhs_acc, Bd, g_a, use_cholesky=True,
                     refine: int = 0, cg_iters: int = 0,
                     band_group=None):
    """Solve the reduced camera system from the completed pass-A sums.

    ``S = diag(Bd) − scatter(S_f)``, ``rhs = −g_a + rhs_acc``; ``refine``
    = hessian.schur_refine mixed-precision rounds (ops/linalg
    .refine_psd_solve).  ``cg_iters`` > 0 = hessian.schur_cg_iters:
    block-Jacobi PCG instead of the dense Cholesky (inexact LM: a PCG
    matvec is one bandwidth-bound pass over S where the factorization
    is O((n_a·da)³); ``refine`` is ignored there).  Returns
    ``(dx_a (n_a, da), ok)``.
    """
    n_a, da = g_a.shape
    S_red = S_f.reshape(n_a, n_a, da, da)
    idx = jnp.arange(n_a)
    # scatter-free diagonal add (see _reconstruct_S docstring)
    S_blocks = -S_red + jnp.eye(n_a, dtype=S_f.dtype)[:, :, None, None] \
        * Bd.reshape(n_a, 1, da, da)
    S = S_blocks.transpose(0, 2, 1, 3).reshape(n_a * da, n_a * da)
    rhs = (-g_a + rhs_acc).reshape(-1)
    # HIGHEST-precision solves: at DEFAULT a GPU may round the
    # Cholesky's internal dot_generals (and the CG matvecs) to TF32,
    # and at corridor-BA conditioning (cond(S) ~ 1e6 at 1000 cameras)
    # a TF32 solve error (eps ~1e-3) exceeds the step itself —
    # schur_refine cannot rescue it either, because refinement only
    # contracts when eps_solve·cond(S) < 1.
    with jax.default_matmul_precision("highest"):
        if band_group is not None and cg_iters == 0:
            # block-banded structure (hessian.schur_banded): chain-
            # machinery CR solve, O(n_a*(g*da)^2) instead of the dense
            # (n_a*da)^3/3 factorization
            dx_a, ok = banded_reduced_solve(S_blocks, rhs, band_group,
                                            refine)
            return dx_a.reshape(n_a, da), ok
        if cg_iters > 0:
            from .linalg import pcg_core
            Minv = spd_inv_blocks(S_blocks[idx, idx])

            def prec(r):
                return _esum("iab,ib->ia", Minv,
                             r.reshape(n_a, da)).reshape(-1)

            dx_a = pcg_core(lambda p: S @ p, prec, rhs, cg_iters)
            ok = jnp.all(jnp.isfinite(dx_a))
            return dx_a.reshape(n_a, da), ok
        dx_a, ok = solve_psd(S, rhs, use_cholesky=use_cholesky)
        if refine > 0:
            # hessian.schur_refine: f64-residual iterative refinement of
            # the f32 reduced solve (ops/linalg.refine_psd_solve).
            dx_a = refine_psd_solve(S, rhs, dx_a, refine,
                                    use_cholesky=use_cholesky)
    return dx_a.reshape(n_a, da), ok


def schur_obs_system(pair_fn: Callable, a0, b0, obs, cam_idx, mask,
                     spec: mf.TangentSpec, chunk: int = 1024):
    """Build (accumulate, evaluate, n_res, propose) for sparse-obs BA.

    Contract mirrors ops/schur.schur_system with the point-major layout
    documented in the module docstring; ``spec`` must be
    ``mf.tangent_spec((a0, b0))``.  ``chunk`` bounds every expanded
    transient to O(chunk · K² · da²); the point axis is padded to a
    chunk multiple internally (padded points: mask 0, camera 0 — exact
    zero contributions everywhere).
    """
    a0 = mf.as_pytree(a0)
    b0 = mf.as_pytree(b0)
    n_a = jnp.shape(jax.tree_util.tree_leaves(a0)[0])[0]
    n_b = jnp.shape(jax.tree_util.tree_leaves(b0)[0])[0]
    a_ex = jax.tree_util.tree_map(lambda l: l[0], a0)
    b_ex = jax.tree_util.tree_map(lambda l: l[0], b0)
    spec_a = mf.tangent_spec(a_ex)
    spec_b = mf.tangent_spec(b_ex)
    da, db = spec_a.dims, spec_b.dims
    dtype = spec.dtype
    cam_idx = jnp.asarray(cam_idx, jnp.int32)
    # Mask rides as a residual multiplier — cast to the solve dtype so a
    # float64 mask cannot silently promote an f32 solve under x64.
    mask = jnp.asarray(mask, dtype)
    K = cam_idx.shape[1]

    # Pad the point axis of the DATA to a chunk multiple (build-time,
    # once).  b itself stays n_b; accumulate pads its copy per call.
    n_bp = int(-(-n_b // min(chunk, max(n_b, 1))) * min(chunk, max(n_b, 1)))
    pad = n_bp - n_b
    if pad:
        obs = jax.tree_util.tree_map(
            lambda l: jnp.concatenate(
                [jnp.asarray(l),
                 jnp.zeros((pad,) + jnp.shape(l)[1:],
                           jnp.result_type(l))]), obs)
        cam_idx_p = jnp.concatenate(
            [cam_idx, jnp.zeros((pad, K), jnp.int32)])
        mask_p = jnp.concatenate([mask, jnp.zeros((pad, K), mask.dtype)])
    else:
        cam_idx_p, mask_p = cam_idx, mask
    CH = _pick_chunk(n_bp, chunk)

    d_ex = jax.tree_util.tree_map(lambda l: l[0, 0], obs)
    m = int(sum(math.prod(l.shape) for l in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda a, b, d: flatten_residuals(pair_fn(a, b, d)),
                       a_ex, b_ex, d_ex))))
    # Observed-slot residual count (ops/schur.py semantics).
    n_res = jnp.count_nonzero(mask).astype(jnp.int32) * m

    import numpy as np
    # The planned reduce and banded detection need CONCRETE indices at
    # build time; when the builder runs under jit/vmap (traced cam_idx)
    # fall back to the chunk-transient scatter pass with band_g=None,
    # like the sharded builder (parallel/schur_obs.py).
    try:
        cam_idx_host = np.asarray(cam_idx_p)
        mask_host = np.asarray(mask_p)
    except Exception:
        cam_idx_host = mask_host = None
    acc_slab, eval_slab, reduce_pass, backsub_pass = make_obs_kernels(
        pair_fn, a0, spec_a, spec_b, dtype, n_a, K, CH,
        cam_idx_np=cam_idx_host, mask_np=mask_host)
    # static banded-structure detection (hessian.schur_banded="auto")
    bw_det = None if cam_idx_host is None else \
        detect_camera_bandwidth(cam_idx_host, mask_host)
    band_g = None if bw_det is None else pick_band_group(bw_det, n_a,
                                                         da)
    # Band-STORAGE reduce (r5): when the banded solve applies and the
    # windowed plan fits, pass A reduces straight into (n_a·(bw+1))
    # band entries and the (n_a, n_a) S grid never exists — the
    # camera-count memory ceiling moves from ~6k (14.4 GB flat S at
    # 10k cams) to landmark-side storage.
    reduce_band = None
    if band_g is not None and cam_idx_host is not None:
        bplan = plan_window_reduce_banded(cam_idx_host, n_a, K, CH,
                                          bw_det, mask_np=mask_host)
        if bplan is not None:
            reduce_band = make_reduce_pass_window_banded(
                n_a, K, da, db, dtype, CH, bplan)
    em2gl, gl2em = bipartite_perms(a0, b0, n_a, n_b, da, db)

    def split(x):
        return mf.as_pytree(x[0]), mf.as_pytree(x[1])

    def _pad_b(b):
        if not pad:
            return b
        return jax.tree_util.tree_map(
            lambda l: jnp.concatenate(
                [l, jnp.broadcast_to(l[:1], (pad,) + l.shape[1:])]), b)

    def accumulate(x):
        a, b = split(x)
        Ba, g_a, E_f, C_f, g_b, rss = acc_slab(
            a, _pad_b(b), obs, cam_idx_p, mask_p)
        g = jnp.concatenate([g_a.reshape(-1), g_b[:n_b].reshape(-1)])
        if em2gl is not None:
            g = g[em2gl]
        cost = Cost.make(rss, n_res)
        return (SchurObsSystem(Ba, C_f[:n_b], E_f[:n_b], cam_idx,
                               em2gl, gl2em), g, cost)

    def evaluate(x):
        a, b = split(x)
        rss = eval_slab(a, _pad_b(b), obs, cam_idx_p, mask_p)
        return Cost.make(rss, n_res)

    def _pad_rows(arr):
        if not pad:
            return arr
        return jnp.concatenate(
            [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])

    def eliminate(H: SchurObsSystem, Bd, Cd_flat, g, use_cholesky=True,
                  refine: int = 0, cg_iters: int = 0,
                  band_group=None):
        """Chunked Schur elimination + back-substitution. (dx, ok).

        Pass A accumulates the reduced system S (flat (n_a², da²)
        scatter target) and its rhs while stashing C⁻¹; pass B solves S;
        pass C back-substitutes the landmarks.  Every expanded tensor is
        O(CH · K² · da²).  g/dx in the loop's global layout.
        """
        if gl2em is not None:
            g = g[gl2em]
        g_a = g[:n_a * da].reshape(n_a, da)
        g_b = _pad_rows(g[n_a * da:].reshape(n_b, db))
        E_p = _pad_rows(H.E)
        Cd_p = _pad_rows(Cd_flat)

        if (band_group is not None and cg_iters == 0
                and reduce_band is not None):
            # band storage: S never materializes as (n_a, n_a)
            S_low, rhs_acc, Cinv_f = reduce_band(E_p, Cd_p, cam_idx_p,
                                                 g_b)
            dx_a, ok = banded_reduced_solve_band(
                S_low.reshape(n_a, bw_det + 1, da, da), Bd,
                -g_a + rhs_acc, band_group, refine)
            dx_a = dx_a.reshape(n_a, da)
        else:
            S_f, rhs_acc, Cinv_f = reduce_pass(E_p, Cd_p, cam_idx_p,
                                               g_b)
            dx_a, ok = assemble_reduced(S_f, rhs_acc, Bd, g_a,
                                        use_cholesky, refine, cg_iters,
                                        band_group)
        dx_b = backsub_pass(E_p, Cinv_f, cam_idx_p, g_b, dx_a)[:n_b]
        dx = jnp.concatenate([dx_a.reshape(-1), dx_b.reshape(-1)])
        ok = ok & jnp.all(jnp.isfinite(dx))
        if em2gl is not None:
            dx = dx[em2gl]
        return dx, ok

    def propose(H: SchurObsSystem, g, lam, opts):
        use_chol = opts.hessian.use_ldlt
        refine = opts.hessian.schur_refine
        cg_it = opts.hessian.schur_cg_iters
        band = band_g if opts.hessian.schur_banded == "auto" else None
        if opts.solver_type == SolverType.DOGLEG:
            from ..solvers.step import dogleg_core  # local: avoid cycle

            dx_gn, ok_gn = eliminate(H, H.Ba, H.C, g, use_chol, refine,
                                     cg_it, band)
            return dogleg_core(
                g, lam, dx_gn, ok_gn, jnp.vdot(g, H.matvec(g)),
                lambda le: eliminate(H, _damp_blocks(H.Ba, le),
                                     _damp_flat(H.C, db, le), g,
                                     use_chol, refine, cg_it, band))
        is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
        Bd = _damp_blocks(H.Ba, lam) if is_lm else H.Ba
        Cd = _damp_flat(H.C, db, lam) if is_lm else H.C
        return eliminate(H, Bd, Cd, g, use_chol, refine, cg_it, band)

    return accumulate, evaluate, n_res, propose


class SchurObsBuckets(NamedTuple):
    """Pluggable H for the K-BUCKETED point-major layout.

    Published BAL visibility is heavy-tailed (mean ~6 obs/landmark, max
    in the hundreds): one (n_b, K_max) padded slab inflates memory
    10-50×.  Landmarks are instead grouped into a few buckets by
    observation count, each bucket its own padded slab with its own
    K_g cap — padding waste is bounded by the bucket growth factor
    (~2×), and every slab runs through the SAME chunked kernels.  The
    static landmark-id maps and per-bucket kernels live in the system
    builder's closure (``schur_obs_bucket_system``), not here: the loop
    carries only arrays.

    Per-bucket leaves are tuples (one entry per bucket), each in the
    single-slab flat layout of :class:`SchurObsSystem`.
    """

    Ba: jax.Array            #: (n_a, da, da) camera diagonal blocks
    C: tuple                 #: per-bucket (n_g, db²) landmark blocks
    E: tuple                 #: per-bucket (n_g, K_g·da·db) couplings
    cam_idx: tuple           #: per-bucket (n_g, K_g) int32


def schur_obs_bucket_system(pair_fn: Callable, a0, b0, slabs,
                            spec: mf.TangentSpec, chunk: int = 1024):
    """Build (accumulate, evaluate, n_res, propose) for K-bucketed
    sparse-obs BA.

    ``slabs`` — list of ``(obs, cam_idx, mask, ids)``: per-bucket
    point-major arrays (leaves (n_g, K_g, ...)) plus the STATIC
    original-landmark indices ``ids`` (n_g,) of the bucket's rows.
    Every landmark must appear in exactly one bucket.  ``x`` stays in
    the ORIGINAL landmark order throughout (the loop's tangent layout is
    unchanged); buckets slice it by static gather and the
    back-substituted steps are un-permuted by one static gather —
    no scatters are added.  Same elimination algebra as
    ``schur_obs_system`` (the reduced camera system just sums over
    buckets), so trajectories match the single-slab layout of the same
    problem up to summation order.
    """
    a0 = mf.as_pytree(a0)
    b0 = mf.as_pytree(b0)
    n_a = jnp.shape(jax.tree_util.tree_leaves(a0)[0])[0]
    n_b = jnp.shape(jax.tree_util.tree_leaves(b0)[0])[0]
    a_ex = jax.tree_util.tree_map(lambda l: l[0], a0)
    b_ex = jax.tree_util.tree_map(lambda l: l[0], b0)
    spec_a = mf.tangent_spec(a_ex)
    spec_b = mf.tangent_spec(b_ex)
    da, db = spec_a.dims, spec_b.dims
    dtype = spec.dtype

    import numpy as np

    ids_all = np.concatenate([np.asarray(s[3], np.int64)
                              for s in slabs])
    if (ids_all.size != n_b
            or np.any(np.sort(ids_all) != np.arange(n_b))):
        raise ValueError(
            "bucket ids must partition the landmark axis: every "
            f"landmark index 0..{n_b - 1} exactly once "
            f"(got {ids_all.size} ids)")
    # static permutations: bucket-concat order <-> original order
    inv_order = jnp.asarray(np.argsort(ids_all), jnp.int32)

    buckets = []
    n_res_total = 0
    m_dims = None
    for obs, cam_idx, mask, ids in slabs:
        cam_idx = jnp.asarray(cam_idx, jnp.int32)
        mask = jnp.asarray(mask, dtype)
        ids = jnp.asarray(np.asarray(ids), jnp.int32)
        n_g, K = cam_idx.shape
        step = min(chunk, max(n_g, 1))
        n_gp = int(-(-n_g // step) * step)
        pad = n_gp - n_g
        CH = _pick_chunk(n_gp, chunk)
        if pad:
            obs = jax.tree_util.tree_map(
                lambda l: jnp.concatenate(
                    [jnp.asarray(l),
                     jnp.zeros((pad,) + jnp.shape(l)[1:],
                               jnp.result_type(l))]), obs)
            cam_p = jnp.concatenate(
                [cam_idx, jnp.zeros((pad, K), jnp.int32)])
            mask_p = jnp.concatenate(
                [mask, jnp.zeros((pad, K), mask.dtype)])
        else:
            obs = jax.tree_util.tree_map(jnp.asarray, obs)
            cam_p, mask_p = cam_idx, mask
        d_ex = jax.tree_util.tree_map(lambda l: l[0, 0], obs)
        m = int(sum(math.prod(l.shape)
                    for l in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda a, b, d: flatten_residuals(
                pair_fn(a, b, d)), a_ex, b_ex, d_ex))))
        if m_dims is None:
            m_dims = m
        kernels = make_obs_kernels(pair_fn, a0, spec_a, spec_b, dtype,
                                   n_a, K, CH,
                                   cam_idx_np=np.asarray(cam_p),
                                   mask_np=np.asarray(mask_p))
        n_res_total = n_res_total + (
            jnp.count_nonzero(mask).astype(jnp.int32) * m)
        buckets.append(dict(obs=obs, cam=cam_p, mask=mask_p, ids=ids,
                            n_g=n_g, pad=pad, K=K, CH=CH,
                            kernels=kernels))
    n_res = n_res_total
    # banded reduced solve (hessian.schur_banded): bandwidth over the
    # UNION of all buckets' co-observation structure
    bw = max((detect_camera_bandwidth(np.asarray(bk["cam"]),
                                      np.asarray(bk["mask"]))
              for bk in buckets), default=0)
    band_g = pick_band_group(bw, n_a, da)
    # Band-storage reduces (r5): per-bucket windowed reduction straight
    # into the GLOBAL (n_a·(bw+1)) band space; the cross-bucket sum is
    # a cheap band-array add, and the (n_a, n_a) flat S never exists.
    # Active only when EVERY bucket's plan fits (else all flat).
    if band_g is not None:
        for bk in buckets:
            bplan = plan_window_reduce_banded(
                np.asarray(bk["cam"]), n_a, bk["K"], bk["CH"], bw,
                mask_np=np.asarray(bk["mask"]))
            bk["reduce_band"] = None if bplan is None else \
                make_reduce_pass_window_banded(
                    n_a, bk["K"], da, db, dtype, bk["CH"], bplan)
        band_storage = all(bk["reduce_band"] is not None
                           for bk in buckets)
    else:
        band_storage = False
    em2gl, gl2em = bipartite_perms(a0, b0, n_a, n_b, da, db)

    def split(x):
        return mf.as_pytree(x[0]), mf.as_pytree(x[1])

    def _slab_b(b, bk):
        b_g = jax.tree_util.tree_map(lambda l: l[bk["ids"]], b)
        if not bk["pad"]:
            return b_g
        return jax.tree_util.tree_map(
            lambda l: jnp.concatenate(
                [l, jnp.broadcast_to(l[:1],
                                     (bk["pad"],) + l.shape[1:])]), b_g)

    def accumulate(x):
        a, b = split(x)
        Ba = jnp.zeros((n_a, da, da), dtype)
        g_a = jnp.zeros((n_a, da), dtype)
        rss = jnp.zeros((), dtype)
        C_t, E_t, gb_rows = [], [], []
        for bk in buckets:
            acc_slab = bk["kernels"][0]
            Ba_g, ga_g, E_f, C_f, g_b, rss_g = acc_slab(
                a, _slab_b(b, bk), bk["obs"], bk["cam"], bk["mask"])
            Ba, g_a, rss = Ba + Ba_g, g_a + ga_g, rss + rss_g
            C_t.append(C_f[:bk["n_g"]])
            E_t.append(E_f[:bk["n_g"]])
            gb_rows.append(g_b[:bk["n_g"]])
        g_b_all = jnp.concatenate(gb_rows)[inv_order]
        g = jnp.concatenate([g_a.reshape(-1), g_b_all.reshape(-1)])
        if em2gl is not None:
            g = g[em2gl]
        H = SchurObsBuckets(Ba, tuple(C_t), tuple(E_t),
                            tuple(bk["cam"][:bk["n_g"]]
                                  for bk in buckets))
        return H, g, Cost.make(rss, n_res)

    def evaluate(x):
        a, b = split(x)
        rss = jnp.zeros((), dtype)
        for bk in buckets:
            eval_slab = bk["kernels"][1]
            rss = rss + eval_slab(a, _slab_b(b, bk), bk["obs"],
                                  bk["cam"], bk["mask"])
        return Cost.make(rss, n_res)

    def _pad_rows(arr, pad):
        if not pad:
            return arr
        return jnp.concatenate(
            [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])

    def _matvec(H: SchurObsBuckets, v):
        """H·v (element-major bucket algebra; loop-global in/out)."""
        if gl2em is not None:
            v = v[gl2em]
        v_a = v[:n_a * da].reshape(n_a, da)
        v_b = v[n_a * da:].reshape(n_b, db)
        o_a = _esum("iab,ib->ia", H.Ba, v_a)
        ob_rows = []
        for bk, E_g, C_g in zip(buckets, H.E, H.C):
            K = bk["K"]
            n_g = bk["n_g"]
            E4 = E_g.reshape(n_g, K, da, db)
            C3 = C_g.reshape(n_g, db, db)
            cam = bk["cam"][:n_g]
            v_b_g = v_b[bk["ids"]]
            Evb = _esum("jkab,jb->jka", E4, v_b_g)
            o_a = o_a + jax.ops.segment_sum(
                Evb.reshape(n_g * K, da), cam.reshape(-1),
                num_segments=n_a)
            va_g = v_a[cam]
            ob_rows.append(_esum("jab,jb->ja", C3, v_b_g)
                           + _esum("jkab,jka->jb", E4, va_g))
        o_b = jnp.concatenate(ob_rows)[inv_order]
        out = jnp.concatenate([o_a.reshape(-1), o_b.reshape(-1)])
        return out if em2gl is None else out[em2gl]

    def eliminate(H: SchurObsBuckets, Bd, Cd_t, g, use_cholesky=True,
                  refine: int = 0, cg_iters: int = 0, band=None):
        if gl2em is not None:
            g = g[gl2em]
        g_a = g[:n_a * da].reshape(n_a, da)
        g_b = g[n_a * da:].reshape(n_b, db)
        use_band_storage = (band_storage and band is not None
                            and cg_iters == 0)
        S_f = jnp.zeros(
            (n_a * (bw + 1), da * da) if use_band_storage
            else (n_a * n_a, da * da), dtype)
        rhs = jnp.zeros((n_a, da), dtype)
        stash = []
        for bk, E_g, Cd_g in zip(buckets, H.E, Cd_t):
            reduce_pass = bk["reduce_band"] if use_band_storage \
                else bk["kernels"][2]
            pad = bk["pad"]
            g_b_p = _pad_rows(g_b[bk["ids"]], pad)
            E_p = _pad_rows(E_g, pad)
            Cd_p = _pad_rows(Cd_g, pad)
            S_g, rhs_g, Cinv_p = reduce_pass(E_p, Cd_p, bk["cam"], g_b_p)
            S_f, rhs = S_f + S_g, rhs + rhs_g
            stash.append((E_p, Cinv_p, g_b_p))
        if use_band_storage:
            dx_a, ok = banded_reduced_solve_band(
                S_f.reshape(n_a, bw + 1, da, da), Bd, -g_a + rhs,
                band, refine)
            dx_a = dx_a.reshape(n_a, da)
        else:
            dx_a, ok = assemble_reduced(S_f, rhs, Bd, g_a, use_cholesky,
                                        refine, cg_iters, band)
        dxb_rows = []
        for bk, (E_p, Cinv_p, g_b_p) in zip(buckets, stash):
            backsub = bk["kernels"][3]
            dxb_rows.append(
                backsub(E_p, Cinv_p, bk["cam"], g_b_p,
                        dx_a)[:bk["n_g"]])
        dx_b = jnp.concatenate(dxb_rows)[inv_order]
        dx = jnp.concatenate([dx_a.reshape(-1), dx_b.reshape(-1)])
        ok = ok & jnp.all(jnp.isfinite(dx))
        if em2gl is not None:
            dx = dx[em2gl]
        return dx, ok

    def propose(H: SchurObsBuckets, g, lam, opts):
        use_chol = opts.hessian.use_ldlt
        refine = opts.hessian.schur_refine
        cg_it = opts.hessian.schur_cg_iters
        band = band_g if opts.hessian.schur_banded == "auto" else None
        if opts.solver_type == SolverType.DOGLEG:
            from ..solvers.step import dogleg_core  # local: avoid cycle

            dx_gn, ok_gn = eliminate(H, H.Ba, H.C, g, use_chol, refine,
                                     cg_it, band)
            return dogleg_core(
                g, lam, dx_gn, ok_gn, jnp.vdot(g, _matvec(H, g)),
                lambda le: eliminate(
                    H, _damp_blocks(H.Ba, le),
                    tuple(_damp_flat(Cg, db, le) for Cg in H.C), g,
                    use_chol, refine, cg_it, band))
        is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
        Bd = _damp_blocks(H.Ba, lam) if is_lm else H.Ba
        Cd_t = (tuple(_damp_flat(Cg, db, lam) for Cg in H.C)
                if is_lm else H.C)
        return eliminate(H, Bd, Cd_t, g, use_chol, refine, cg_it, band)

    return accumulate, evaluate, n_res, propose


def bucket_caps(counts, growth: float = 2.0, min_bucket: int = 256,
                max_blowup: float = 2.0):
    """Assign each landmark a K-bucket cap from its observation count.

    Caps grow geometrically by ``growth`` from the smallest count to the
    densest; buckets holding fewer than ``min_bucket`` points are merged
    into the next larger cap (fewer compiled kernels), the final largest
    bucket absorbing a trailing small one downward instead.  Returns
    ``(cap_of (n_b,) int, used_caps list)`` — host-side numpy.

    Merging is STAGING-BOUNDED (r5): on thin-tail + huge-outlier count
    distributions (e.g. the window finishing reduce, where every pad
    lane lands in segment 0) the unconditional small-class merge used
    to CASCADE — thousands of 1-row segments inherited the outlier's
    multi-thousand cap, staging 50k rows into 78M padded slots (a 40 GB
    gather that killed the 4000-camera ceiling compile).  Each merge
    now spends from a budget of ``(max_blowup − 1) × Σ unmerged caps``;
    merges that would exceed it keep their own class (an extra gather
    kernel, which is cheap — the padding was the hazard).
    """
    import numpy as np

    counts = np.asarray(counts)
    caps = []
    c = max(int(counts.min()), 1)
    kmax = max(int(counts.max()), 1)
    while c < kmax:
        caps.append(c)
        c = max(int(math.ceil(c * growth)), c + 1)
    caps.append(kmax)
    cap_of, _ = _assign_caps(counts, caps)
    used = [c0 for c0 in caps if np.any(cap_of == c0)]
    budget = int((max_blowup - 1.0) * int(cap_of.sum()))
    for i, c0 in enumerate(used[:-1]):
        sel = cap_of == c0
        n_sel = int(sel.sum())
        if 0 < n_sel < min_bucket:
            cost = (used[i + 1] - c0) * n_sel
            if cost <= budget:
                budget -= cost
                cap_of[sel] = used[i + 1]
    used = [c0 for c0 in caps if np.any(cap_of == c0)]
    # a small LARGEST bucket cannot merge upward; pull the next class up
    # into it instead (a merge DOWN would truncate members whose count
    # exceeds the smaller cap — data loss, not just padding)
    if len(used) > 1 and (cap_of == used[-1]).sum() < min_bucket:
        n2 = int((cap_of == used[-2]).sum())
        cost = (used[-1] - used[-2]) * n2
        if cost <= budget:
            budget -= cost
            cap_of[cap_of == used[-2]] = used[-1]
            used = used[:-2] + used[-1:]
    return cap_of, used


def bucket_obs(obs, cam_idx, mask, growth: float = 2.0,
               min_bucket: int = 256):
    """Split a padded point-major layout into K-buckets (host-side).

    Groups landmarks by observation count into caps growing by
    ``growth`` (powers of the factor), merging buckets smaller than
    ``min_bucket`` points into the next larger cap.  Returns ``slabs``
    = list of ``(obs_g, cam_idx_g, mask_g, ids_g)`` for
    :func:`schur_obs_bucket_system` — total padded slots are bounded by
    ~``growth``× the observation count instead of the single-slab
    ``n_b · K_max``.
    """
    import numpy as np

    cam_np = np.asarray(cam_idx)
    mask_np = np.asarray(mask)
    counts = mask_np.astype(bool).sum(axis=1)
    cap_of, used = bucket_caps(counts, growth, min_bucket)

    # primary (minimum masked) camera per landmark: each bucket's
    # members are ordered by it so chunks are camera-LOCAL — what lets
    # the windowed matmul reduction plan (landmark order within a
    # bucket is arbitrary, this only changes summation order)
    big = np.where(mask_np.astype(bool), cam_np,
                   np.iinfo(np.int64).max)
    primary = np.where(mask_np.astype(bool).any(1), big.min(axis=1), 0)

    slabs = []
    for cap in used:
        ids = np.nonzero(cap_of == cap)[0]
        ids = ids[np.argsort(primary[ids], kind="stable")]
        sel_rows = mask_np[ids].astype(bool)
        # compact each row's real slots to the front, cap columns
        order = np.argsort(~sel_rows, axis=1, kind="stable")
        gat = np.take_along_axis
        cam_g = gat(cam_np[ids], order, 1)[:, :cap]
        mask_g = gat(mask_np[ids], order, 1)[:, :cap]
        cam_g = np.where(mask_g.astype(bool), cam_g, 0).astype(np.int32)
        def _gather_leaf(l):
            arr = np.asarray(l)[ids]
            idx = order.reshape(order.shape + (1,) * (arr.ndim - 2))
            g = gat(arr, idx, 1)[:, :cap]
            mk = mask_g.astype(bool).reshape(
                mask_g.shape + (1,) * (arr.ndim - 2))
            return jnp.asarray(np.where(mk, g, 0))

        obs_g = jax.tree_util.tree_map(_gather_leaf, obs)
        slabs.append((obs_g, jnp.asarray(cam_g),
                      jnp.asarray(mask_g), ids))
    return slabs


def grid_to_obs(data, mask, K: int | None = None):
    """Convert a dense (n_a, n_b) observation grid to the point-major
    padded layout.  Returns ``(obs, cam_idx, slot_mask)``.

    ``K`` defaults to the densest landmark's observation count.  Host-
    side (numpy) utility — layouts are built once, outside jit.
    """
    import numpy as np

    mask_np = np.asarray(mask)
    n_a, n_b = mask_np.shape
    counts = mask_np.astype(bool).sum(axis=0)
    K = int(counts.max()) if K is None else int(K)
    if int(counts.max()) > K:
        raise ValueError(
            f"K={K} < densest landmark's {int(counts.max())} observations")
    cam_idx = np.zeros((n_b, K), np.int32)
    slot_mask = np.zeros((n_b, K), np.asarray(mask).dtype)
    sel = np.zeros((n_b, K), np.int64)      # flat (cam, pt) gather index
    for j in range(n_b):
        cams = np.nonzero(mask_np[:, j])[0]
        cam_idx[j, :len(cams)] = cams
        slot_mask[j, :len(cams)] = 1
        sel[j, :len(cams)] = cams * n_b + j
    obs = jax.tree_util.tree_map(
        lambda l: jnp.asarray(np.asarray(l).reshape(
            (n_a * n_b,) + np.asarray(l).shape[2:])[sel.reshape(-1)]
            .reshape((n_b, K) + np.asarray(l).shape[2:])), data)
    return obs, jnp.asarray(cam_idx), jnp.asarray(slot_mask)
