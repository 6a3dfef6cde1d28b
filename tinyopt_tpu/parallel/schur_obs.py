"""Mesh-sharded sparse-observation Schur bundle adjustment.

Composes the two scale stories of this framework: the memory-scalable
point-major observation layout (ops/schur_obs.py — O(n_obs) state, the
"Bundle Adjustment in the Large" layout) sharded over a device mesh on
the LANDMARK axis (parallel/schur.py's decomposition).  Where the
dense-grid sharded path carries O(n_a · n_b) per mesh, this one carries
O(n_obs) split across devices — the regime that justifies a mesh in the
first place (a 1000-cam × 50k-landmark grid E is ≈3.6 TB; its 400k
observations are ~80 MB/device on 8 devices).

Decomposition (identical algebra to the single-device path, so the
trajectory matches up to psum summation order):

* each device holds a contiguous slab of landmarks — its rows of
  obs/cam_idx/mask and of the C/E/g_b state; the chunked slab kernels
  (ops/schur_obs.make_obs_kernels) run unchanged on the local slab;
* camera-side partials (Ba, g_a, rss) and the reduced-camera-system
  partials (the flat (n_a², da²) E C⁻¹ Eᵀ scatter target and E C⁻¹ g_b)
  are completed with ONE ``psum`` each over the mesh axis (ICI) — the
  only cross-landmark coupling the algebra has;
* the (n_a·da)² reduced solve runs replicated (tiny next to the
  landmark work; ``hessian.schur_refine`` applies there), and the local
  landmark back-substitutions are ``all_gather``-ed so the loop carry
  (x, g, dx) stays fully replicated — accept/reject control flow never
  diverges across the mesh.

No reference counterpart: the reference is single-threaded and concedes
large systems ("not fast for large systems yet",
/root/reference/README.md:30).  Scaling contract: n_b must be divisible
by the mesh axis size — pad with mask=0 points (cam_idx 0, zero obs):
padded points contribute exactly zero residual AND Jacobian.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import manifold as mf
from ..cost import Cost
from ..diff.auto import flatten_residuals
from ..optimizers.loop import optimize_from_acc
from ..options import Options, SolverType
from ..ops.schur import _damp_blocks, bipartite_perms
from ..ops.schur_obs import (_PLANNED_STAGING_LIMIT, SchurObsSystem,
                             _damp_flat, _esum, _pick_chunk,
                             _planned_row_buffers, _reconstruct_S,
                             assemble_reduced, camera_marginals_from_S,
                             detect_camera_bandwidth,
                             make_landmark_marginal_pass,
                             make_obs_kernels,
                             make_planned_segment_reduce_multi,
                             make_banded_window_chunk_loop,
                             make_window_chunk_loop,
                             banded_reduced_solve_band,
                             pick_band_group,
                             plan_window_reduce_banded_multi,
                             plan_window_reduce_multi)
from .sharded import _shard_map



def make_sharded_schur_obs_system(pair_fn: Callable, a0, b0, obs,
                                  cam_idx, mask, mesh: Mesh, axis: str,
                                  spec: mf.TangentSpec,
                                  chunk: int = 1024):
    """Build landmark-sharded (accumulate, evaluate, n_res, make_propose).

    Same contract as ops/schur_obs.schur_obs_system; ``obs``/``cam_idx``/
    ``mask`` leaves are (n_b, K, ...) point-major arrays sharded (or
    shardable) on the leading landmark axis.
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
    # Residual-multiplier mask follows the solve dtype (a float64 mask
    # must not promote an f32 solve); sharding is preserved by the cast.
    if jnp.result_type(mask) != dtype:
        mask = jnp.asarray(mask).astype(dtype)
    K = jnp.shape(cam_idx)[1]

    axis_size = mesh.shape[axis]
    if n_b % axis_size != 0:
        raise ValueError(
            f"n_b={n_b} not divisible by mesh axis '{axis}'={axis_size}; "
            "pad the landmark axis with mask=0 points (padded points "
            "contribute zero residual and zero Jacobian)")
    nb_loc = n_b // axis_size

    # Per-device slab padding to a chunk multiple (traced, zero-filled —
    # exactly-zero contributions, like the single-device build padding).
    step = min(chunk, max(nb_loc, 1))
    n_lp = int(-(-nb_loc // step) * step)
    pad = n_lp - nb_loc
    CH = _pick_chunk(n_lp, chunk)

    d_ex = jax.tree_util.tree_map(lambda l: l[0, 0], obs)
    m = int(sum(math.prod(l.shape) for l in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda a, b, d: flatten_residuals(pair_fn(a, b, d)),
                       a_ex, b_ex, d_ex))))
    # Observed-slot residual count, from the global mask BEFORE sharding.
    n_res = jnp.count_nonzero(mask).astype(jnp.int32) * m

    acc_slab, eval_slab, reduce_pass, backsub_pass = make_obs_kernels(
        pair_fn, a0, spec_a, spec_b, dtype, n_a, K, CH)

    # (the single-device entry additionally has the windowed
    # matmul reduce, band STORAGE and the camera-locality sort — see
    # ops/schur_obs.py.  The sharded path keeps the planned gathers +
    # one psum: per-device window tables are a straightforward
    # extension via make_planned_segment_reduce_multi but are not
    # measurable on the virtual CPU mesh, so they wait for real
    # multi-chip hardware.)
    # PLANNED sharded reduction (r4): when every device's slab indices
    # are host-visible (single-process meshes — the common case), build
    # per-device gather plans with COMMON table shapes and ship them as
    # P(axis)-sharded arguments; the per-iteration camera-pair scatter
    # (~150 ns/row) becomes gathers + dense sums + one small
    # scatter-set, exactly like the single-device path.  Multi-process
    # global arrays (shards not addressable) and over-budget stagings
    # fall back to the chunk-transient scatter pass.
    import numpy as _np
    tables = tables_spec = None
    tri_apply = slot_apply = None
    staged = n_lp * (K * (K - 1) // 2) * da * da \
        * jnp.dtype(dtype).itemsize
    # Banded-structure detection is independent of the planned staging
    # buffers: fetch the host copy whenever the shards are addressable,
    # so hessian.schur_banded="auto" stays active even when the planned
    # reduce is over budget and falls back to the scatter pass.
    cam_host = None
    try:
        if getattr(cam_idx, "is_fully_addressable", True):
            cam_host = _np.asarray(cam_idx, _np.int64)
    except Exception:
        cam_host = None
    band_g = None
    bw_det = None
    cam_d_list = None
    if cam_host is not None:
        # banded reduced solve (hessian.schur_banded): structure from
        # the GLOBAL co-observation pattern
        bw_det = detect_camera_bandwidth(cam_host, _np.asarray(mask))
        band_g = pick_band_group(bw_det, n_a, da)
        cam_d_list = []
        mask_d_list = []
        mask_host = _np.asarray(mask)
        for d in range(axis_size):
            cam_d = cam_host[d * nb_loc:(d + 1) * nb_loc]
            mk_d = mask_host[d * nb_loc:(d + 1) * nb_loc] != 0
            if pad:
                cam_d = _np.concatenate(
                    [cam_d, _np.zeros((pad, K), _np.int64)])
                mk_d = _np.concatenate(
                    [mk_d, _np.zeros((pad, K), bool)])
            cam_d_list.append(cam_d)
            mask_d_list.append(mk_d)
    # WINDOWED sharded reduce (r5): per-device window tables with
    # common shapes — the per-chunk onehot matmuls of the single-device
    # path, completed by per-device multi-plan final reduces and the
    # same ONE psum.  Preferred over the planned gathers when it plans
    # (gated by schur_obs.window_default inside plan_window_reduce_multi).
    win_loop = None
    fin_tri_apply = fin_slot_apply = None
    if cam_d_list is not None:
        wplan = plan_window_reduce_multi(cam_d_list, n_a, K, CH,
                                         mask_list=mask_d_list)
        if wplan is not None:
            (loc_tri, seg_tri, W_tri, loc_slot, seg_slot,
             W_slot) = wplan
            fin_tri_tabs, fin_tri_apply =                 make_planned_segment_reduce_multi(
                    [seg_tri[d].ravel() for d in range(axis_size)],
                    n_a * n_a)
            fin_slot_tabs, fin_slot_apply =                 make_planned_segment_reduce_multi(
                    [seg_slot[d].ravel() for d in range(axis_size)],
                    n_a)
            win_loop = make_window_chunk_loop(n_a, K, da, db, dtype,
                                              CH, W_tri, W_slot)
            sh = NamedSharding(mesh, P(axis))
            tables = jax.tree_util.tree_map(
                lambda l: jax.device_put(jnp.asarray(l), sh),
                (jnp.asarray(loc_tri), jnp.asarray(loc_slot),
                 fin_tri_tabs, fin_slot_tabs))
            tables_spec = jax.tree_util.tree_map(lambda _: P(axis),
                                                 tables)
    # BAND-storage sharded reduce (r5): per-device banded window plans;
    # the per-device S_low band partials are completed with one psum and
    # the replicated solve assembles the CR tridiagonals from the band —
    # the (n_a, n_a) flat S never exists on ANY device.
    band_loop = None
    fin_band_apply = fin_bslot_apply = None
    band_tables = band_tables_spec = None
    if cam_d_list is not None and band_g is not None:
        bwplan = plan_window_reduce_banded_multi(
            cam_d_list, n_a, K, CH, bw_det, mask_list=mask_d_list)
        if bwplan is not None:
            (loc_b, seg_b, W_b, w1_t, w2_t, loc_s2, seg_s2, W_s2,
             _) = bwplan
            fin_band_tabs, fin_band_apply = \
                make_planned_segment_reduce_multi(
                    [seg_b[d].ravel() for d in range(axis_size)],
                    n_a * (bw_det + 1))
            fin_bslot_tabs, fin_bslot_apply = \
                make_planned_segment_reduce_multi(
                    [seg_s2[d].ravel() for d in range(axis_size)],
                    n_a)
            band_loop = make_banded_window_chunk_loop(
                n_a, K, da, db, dtype, CH, W_b, W_s2)
            sh = NamedSharding(mesh, P(axis))
            band_tables = jax.tree_util.tree_map(
                lambda l: jax.device_put(jnp.asarray(l), sh),
                (jnp.asarray(loc_b), jnp.asarray(loc_s2),
                 jnp.asarray(w1_t), jnp.asarray(w2_t),
                 fin_band_tabs, fin_bslot_tabs))
            band_tables_spec = jax.tree_util.tree_map(
                lambda _: P(axis), band_tables)
    if (win_loop is None and cam_d_list is not None
            and staged <= _PLANNED_STAGING_LIMIT):
        ks = _np.asarray([k for k in range(K) for l in range(k)])
        ls = _np.asarray([l for k in range(K) for l in range(k)])
        ids_tri_list = [(c[:, ks] * n_a + c[:, ls]).ravel()
                        for c in cam_d_list]
        ids_slot_list = [c.ravel() for c in cam_d_list]
        tri_tables, tri_apply = make_planned_segment_reduce_multi(
            ids_tri_list, n_a * n_a)
        slot_tables, slot_apply = make_planned_segment_reduce_multi(
            ids_slot_list, n_a)
        sh = NamedSharding(mesh, P(axis))
        tables = jax.tree_util.tree_map(
            lambda l: jax.device_put(l, sh), (tri_tables, slot_tables))
        tables_spec = jax.tree_util.tree_map(lambda _: P(axis), tables)

    # Loop-global <-> element-major tangent adapters (multi-leaf element
    # pytrees only; None = identity, ops/schur.bipartite_perms).
    em2gl, gl2em = bipartite_perms(a0, b0, n_a, n_b, da, db)

    def _to_gl(v):
        return v if em2gl is None else v[em2gl]

    def _to_em(v):
        return v if gl2em is None else v[gl2em]

    x_spec = jax.tree_util.tree_map(lambda _: P(), (a0, b0))
    obs_spec = jax.tree_util.tree_map(lambda _: P(axis), obs)
    # SchurObsSystem leaves: Ba replicated; C/E/cam_idx landmark-sharded;
    # the layout index maps (if any) replicated.
    H_spec = SchurObsSystem(Ba=P(), C=P(axis), E=P(axis), cam_idx=P(axis),
                            em2gl=None if em2gl is None else P(),
                            gl2em=None if gl2em is None else P())

    def _local_b(b):
        """This device's landmark rows of the replicated b pytree."""
        j = jax.lax.axis_index(axis)
        return jax.tree_util.tree_map(
            lambda l: jax.lax.dynamic_slice_in_dim(l, j * nb_loc, nb_loc, 0),
            b)

    def _local_gb(g):
        g_b = g[n_a * da:].reshape(n_b, db)
        j = jax.lax.axis_index(axis)
        return jax.lax.dynamic_slice_in_dim(g_b, j * nb_loc, nb_loc, 0)

    def _gather_b(v_loc):
        """(nb_loc, k) local rows -> (n_b, k) replicated."""
        return jax.lax.all_gather(v_loc, axis, axis=0, tiled=True)

    def _pad_rows(arr):
        if not pad:
            return arr
        return jnp.concatenate(
            [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])

    def _pad_b_rows(b):
        if not pad:
            return b
        # Broadcast the first row (manifold leaves cannot be zero-padded:
        # a zero quaternion breaks retraction; mask 0 zeroes the math).
        return jax.tree_util.tree_map(
            lambda l: jnp.concatenate(
                [l, jnp.broadcast_to(l[:1], (pad,) + l.shape[1:])]), b)

    @partial(_shard_map, mesh=mesh,
             in_specs=(x_spec, obs_spec, P(axis), P(axis)),
             out_specs=(H_spec, P(), P()))
    def _accumulate_sm(x, obs_l, cam_l, mask_l):
        a = mf.as_pytree(x[0])
        b_loc = _local_b(mf.as_pytree(x[1]))
        Ba_p, ga_p, E_f, C_f, g_b, rss_p = acc_slab(
            a, _pad_b_rows(b_loc),
            jax.tree_util.tree_map(_pad_rows, obs_l),
            _pad_rows(cam_l), _pad_rows(mask_l))
        # one fused all-reduce for the camera-side partials
        # (parallel/sharded.py rationale)
        Ba, g_a, rss = jax.lax.psum((Ba_p, ga_p, rss_p), axis)
        g = _to_gl(jnp.concatenate(
            [g_a.reshape(-1), _gather_b(g_b[:nb_loc]).reshape(-1)]))
        return (SchurObsSystem(Ba, C_f[:nb_loc], E_f[:nb_loc], cam_l,
                               em2gl, gl2em), g, rss)

    @partial(_shard_map, mesh=mesh,
             in_specs=(x_spec, obs_spec, P(axis), P(axis)), out_specs=P())
    def _evaluate_sm(x, obs_l, cam_l, mask_l):
        a = mf.as_pytree(x[0])
        b_loc = _local_b(mf.as_pytree(x[1]))
        rss = eval_slab(a, _pad_b_rows(b_loc),
                        jax.tree_util.tree_map(_pad_rows, obs_l),
                        _pad_rows(cam_l), _pad_rows(mask_l))
        return jax.lax.psum(rss, axis)

    def _eliminate_local(E_l, cam_l, Bd, Cd_l, g, use_chol, refine=0,
                         cg_iters=0, tbls=None, band=None, kind=None):
        """Sharded elimination: (dx replicated, ok replicated); g/dx in
        the loop's global layout, algebra element-major.  ``kind`` is a
        build-time static: "band" interprets ``tbls`` as the banded
        window tables (band-storage reduce + banded solve); otherwise
        window/planned/scatter, keyed by which machinery exists."""
        g = _to_em(g)
        g_a = g[:n_a * da].reshape(n_a, da)
        g_b_p = _pad_rows(_local_gb(g))
        E_p = _pad_rows(E_l)
        Cd_p = _pad_rows(Cd_l)
        cam_p = _pad_rows(cam_l)
        if kind == "band":
            tb0 = jax.tree_util.tree_map(lambda l: l[0], tbls)
            (loc_b_sl, loc_s_sl, w1_sl, w2_sl, fb_sl, fs_sl) = tb0
            part_band, part_rhs, Cinv_f = band_loop(
                E_p, Cd_p, g_b_p, loc_b_sl, loc_s_sl, w1_sl, w2_sl)
            # barrier: ops/schur_obs.make_reduce_pass_window rationale
            part_band, part_rhs = jax.lax.optimization_barrier(
                (part_band, part_rhs))
            S_low = fin_band_apply(part_band, fb_sl)
            rhs_acc = fin_bslot_apply(part_rhs, fs_sl)
            S_low, rhs_acc = jax.lax.psum((S_low, rhs_acc), axis)
            dx_a, ok = banded_reduced_solve_band(
                S_low.reshape(n_a, bw_det + 1, da, da), Bd,
                -g_a + rhs_acc, band, refine)
            dx_a = dx_a.reshape(n_a, da)
            ok = ok & jnp.all(jnp.isfinite(dx_a))
            dx_b_l = backsub_pass(E_p, Cinv_f, cam_p, g_b_p,
                                  dx_a)[:nb_loc]
            bad_b = jax.lax.psum(
                jnp.any(~jnp.isfinite(dx_b_l)).astype(jnp.int32), axis)
            ok = ok & (bad_b == 0)
            dx = _to_gl(jnp.concatenate(
                [dx_a.reshape(-1), _gather_b(dx_b_l).reshape(-1)]))
            return dx, ok
        if tbls is not None and win_loop is not None:
            # windowed sharded reduce: device slices of the loc tables
            # + multi-plan final reduces (leading (1, ...) row of each
            # P(axis)-sharded array)
            tb0 = jax.tree_util.tree_map(lambda l: l[0], tbls)
            loc_tri_sl, loc_slot_sl, ftri_sl, fslot_sl = tb0
            part_tri, part_diag, part_rhs, Cinv_f = win_loop(
                E_p, Cd_p, g_b_p, loc_tri_sl, loc_slot_sl)
            # barrier: ops/schur_obs.make_reduce_pass_window rationale
            part_tri, part_diag, part_rhs = \
                jax.lax.optimization_barrier(
                    (part_tri, part_diag, part_rhs))
            S_f = _reconstruct_S(
                fin_tri_apply(part_tri, ftri_sl),
                fin_slot_apply(part_diag, fslot_sl), n_a, da)
            rhs_acc = fin_slot_apply(part_rhs, fslot_sl)
        elif tbls is not None:
            # planned sharded reduce: this device's table slice is the
            # leading (1, ...) row of each P(axis)-sharded array
            tri_sl, slot_sl = jax.tree_util.tree_map(
                lambda l: l[0], tbls)
            tri_rows, diag_rows, rhs_rows, Cinv_f = \
                _planned_row_buffers(E_p, Cd_p, g_b_p, K, da, db,
                                     dtype, CH)
            S_f = _reconstruct_S(tri_apply(tri_rows, tri_sl),
                                 slot_apply(diag_rows, slot_sl),
                                 n_a, da)
            rhs_acc = slot_apply(rhs_rows, slot_sl)
        else:
            S_f, rhs_acc, Cinv_f = reduce_pass(E_p, Cd_p, cam_p,
                                               g_b_p)
        # The ONLY cross-landmark sums in the algebra: complete them once.
        S_f, rhs_acc = jax.lax.psum((S_f, rhs_acc), axis)
        dx_a, ok = assemble_reduced(S_f, rhs_acc, Bd, g_a, use_chol,
                                    refine, cg_iters, band)
        ok = ok & jnp.all(jnp.isfinite(dx_a))
        dx_b_l = backsub_pass(E_p, Cinv_f, cam_p, g_b_p, dx_a)[:nb_loc]
        bad_b = jax.lax.psum(
            jnp.any(~jnp.isfinite(dx_b_l)).astype(jnp.int32), axis)
        ok = ok & (bad_b == 0)
        dx = _to_gl(jnp.concatenate(
            [dx_a.reshape(-1), _gather_b(dx_b_l).reshape(-1)]))
        return dx, ok

    def _ghg_local(H: SchurObsSystem, g):
        """Replicated gᵀHg from the local slab (expands the local E —
        transient O(nb_loc · K · da · db), once per dogleg propose).
        Layout-invariant scalar: computed element-major."""
        g = _to_em(g)
        v_a = g[:n_a * da].reshape(n_a, da)
        v_b_l = _local_gb(g)
        E4 = H.E.reshape(nb_loc, K, da, db)
        C3 = H.C.reshape(nb_loc, db, db)
        t_a = jnp.vdot(v_a, _esum("iab,ib->ia", H.Ba, v_a))
        va_g = v_a[H.cam_idx]                             # (nb_loc, K, da)
        Evb = _esum("jkab,jb->jka", E4, v_b_l)
        t_cross = 2.0 * jnp.vdot(va_g, Evb)
        t_b = jnp.vdot(v_b_l, _esum("jab,jb->ja", C3, v_b_l))
        return t_a + jax.lax.psum(t_cross + t_b, axis)

    def make_propose(opts: Options):
        use_chol = opts.hessian.use_ldlt
        refine = opts.hessian.schur_refine
        cg_it = opts.hessian.schur_cg_iters
        band = band_g if opts.hessian.schur_banded == "auto" else None
        use_band = (band is not None and cg_it == 0
                    and band_loop is not None)
        kind = "band" if use_band else None
        ship = band_tables if use_band else tables
        ship_spec = band_tables_spec if use_band else tables_spec

        def _propose_core(H, g, lam, tbls):
            E_l, cam_l = H.E, H.cam_idx
            if opts.solver_type == SolverType.DOGLEG:
                from ..solvers.step import dogleg_core
                dx_gn, ok_gn = _eliminate_local(E_l, cam_l, H.Ba, H.C, g,
                                                use_chol, refine, cg_it,
                                                tbls, band, kind)
                return dogleg_core(
                    g, lam, dx_gn, ok_gn, _ghg_local(H, g),
                    lambda le: _eliminate_local(
                        E_l, cam_l, _damp_blocks(H.Ba, le),
                        _damp_flat(H.C, db, le), g, use_chol, refine,
                        cg_it, tbls, band, kind))
            is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
            Bd = _damp_blocks(H.Ba, lam) if is_lm else H.Ba
            Cd_l = _damp_flat(H.C, db, lam) if is_lm else H.C
            return _eliminate_local(E_l, cam_l, Bd, Cd_l, g, use_chol,
                                    refine, cg_it, tbls, band, kind)

        if ship is not None:
            @partial(_shard_map, mesh=mesh,
                     in_specs=(H_spec, P(), P(), ship_spec),
                     out_specs=(P(), P()))
            def _propose_sm_t(H, g, lam, tbls):
                return _propose_core(H, g, lam, tbls)

            def propose(H, g, lam, opts_inner):
                return _propose_sm_t(H, g, lam, ship)

            return propose

        @partial(_shard_map, mesh=mesh,
                 in_specs=(H_spec, P(), P()), out_specs=(P(), P()))
        def _propose_sm(H, g, lam):
            return _propose_core(H, g, lam, None)

        def propose(H, g, lam, opts_inner):
            return _propose_sm(H, g, lam)

        return propose

    def accumulate(x, obs=obs, cam_idx=cam_idx, mask=mask):
        H, g, rss = _accumulate_sm(x, obs, cam_idx, mask)
        return H, g, Cost.make(rss, n_res)

    def evaluate(x, obs=obs, cam_idx=cam_idx, mask=mask):
        return Cost.make(_evaluate_sm(x, obs, cam_idx, mask), n_res)

    return accumulate, evaluate, n_res, make_propose


def sharded_schur_sparse_optimize(x0: tuple, pair_fn: Callable, obs,
                                  cam_idx, mask,
                                  options: Options | None = None, *,
                                  mesh: Mesh | None = None,
                                  axis: str = "block",
                                  chunk: int = 1024, jit: bool = True):
    """Landmark-sharded sparse-observation BA over the mesh.

    Drop-in for :func:`tinyopt_tpu.sparse.schur_sparse_optimize` at
    multi-device scale — same point-major obs/cam_idx/mask contract,
    same Output semantics, same trajectory up to psum summation order.
    ``obs``/``cam_idx``/``mask`` are placed with
    ``NamedSharding(mesh, P(axis))`` on the landmark axis unless already
    global.  Returns ``(x_opt, Output)``.
    """
    options = options or Options()
    if mesh is None:
        from .mesh import local_mesh
        mesh = local_mesh(axis)
    if not (isinstance(x0, tuple) and len(x0) == 2):
        raise ValueError(
            "sharded_schur_sparse_optimize needs x0 = (a0, b0)")
    x0 = (mf.as_pytree(x0[0]), mf.as_pytree(x0[1]))
    cam_idx = jnp.asarray(cam_idx, jnp.int32)
    spec = mf.tangent_spec(x0)
    # Residual-multiplier mask follows the solve dtype (ops/schur_obs.py).
    mask = jnp.asarray(mask, spec.dtype)

    # Check divisibility BEFORE device_put (whose sharding error is
    # opaque); same message as make_sharded_schur_obs_system.
    n_b = jnp.shape(jax.tree_util.tree_leaves(x0[1])[0])[0]
    if n_b % mesh.shape[axis] != 0:
        raise ValueError(
            f"n_b={n_b} not divisible by mesh axis "
            f"'{axis}'={mesh.shape[axis]}; pad the landmark axis with "
            "mask=0 points (padded points contribute zero residual and "
            "zero Jacobian)")

    # Internal camera-locality sort (r5, mirrors sparse.py): when the
    # caller's landmark order defeats the per-device window plans but a
    # primary-camera sort admits them, route through the sharded bucket
    # machinery as ONE sorted slab (x stays in caller order).  Host
    # decision from concrete indices; multi-process global arrays keep
    # the natural order.
    if options.hessian.schur_sort == "auto":
        perm = None
        try:
            import numpy as _np
            from ..ops.schur_obs import camera_sort_perm
            if getattr(cam_idx, "is_fully_addressable", True):
                n_a_ = jnp.shape(
                    jax.tree_util.tree_leaves(x0[0])[0])[0]
                # per-DEVICE slabs must window: plan on the slab size
                perm = camera_sort_perm(
                    _np.asarray(cam_idx), _np.asarray(mask),
                    int(n_a_), int(cam_idx.shape[1]),
                    min(chunk, n_b // mesh.shape[axis]))
        except Exception:
            perm = None
        if perm is not None:
            permj = jnp.asarray(perm, jnp.int32)
            slab = (jax.tree_util.tree_map(
                        lambda l: jnp.asarray(l)[permj], obs),
                    cam_idx[permj], mask[permj], perm)
            return sharded_schur_sparse_optimize_buckets(
                x0, pair_fn, [slab], options, mesh=mesh, axis=axis,
                chunk=chunk, jit=jit)

    from ..sparse import (_solver_cache_get, _solver_cache_key,
                          _solver_cache_put)
    orig_leaves = jax.tree_util.tree_leaves((obs, cam_idx, mask))
    key = _solver_cache_key("sharded_schur_obs", pair_fn, options, jit,
                            x0, orig_leaves, extra=(mesh, axis, chunk))
    run = _solver_cache_get(key)
    if run is None:
        sharding = NamedSharding(mesh, P(axis))
        already_global = any(
            getattr(l, "sharding", None) is not None
            and not getattr(l, "is_fully_addressable", True)
            for l in jax.tree_util.tree_leaves((obs, cam_idx, mask)))
        if not already_global:
            obs = jax.tree_util.tree_map(
                lambda a: jax.device_put(jnp.asarray(a), sharding), obs)
            cam_idx = jax.device_put(cam_idx, sharding)
            mask = jax.device_put(mask, sharding)

        acc, ev, n_res, make_propose = make_sharded_schur_obs_system(
            pair_fn, x0[0], x0[1], obs, cam_idx, mask, mesh, axis, spec,
            chunk)
        propose = make_propose(options)

        # obs/cam_idx/mask ride as jit ARGUMENTS (multi-process global
        # arrays cannot be closed over — parallel/sharded.py).
        def solve(x, o, ci, mk):
            return optimize_from_acc(
                x, lambda xv: acc(xv, o, ci, mk),
                lambda xv: ev(xv, o, ci, mk), options, spec,
                propose=propose)

        if jit:
            solve = jax.jit(solve)
        obs_g, cam_g, mask_g = obs, cam_idx, mask

        def run(x):
            return solve(x, obs_g, cam_g, mask_g)

        _solver_cache_put(key, run, orig_leaves)
    return run(x0)


def sharded_schur_sparse_optimize_buckets(
        x0: tuple, pair_fn: Callable, slabs,
        options: Options | None = None, *, mesh: Mesh | None = None,
        axis: str = "block", chunk: int = 1024, jit: bool = True):
    """Landmark-sharded K-BUCKETED sparse-observation BA over the mesh.

    Composes the two r4 scale stories: the heavy-tail bucketed layout
    (``sparse.schur_sparse_optimize_buckets`` — a few padded slabs with
    per-bucket K caps instead of one n_b·K_max slab) sharded over the
    mesh on the landmark axis (this module's decomposition).  Every
    bucket's rows are split across devices; per-device slab kernels run
    per bucket, the camera-side partials and the per-bucket reduced-
    system partials are summed ACROSS buckets locally and completed
    with ONE fused ``psum``, the replicated reduced solve covers all
    buckets at once, and per-bucket back-substitutions ``all_gather``.
    Buckets are padded internally to a mesh-axis multiple with mask-0
    rows (exact zero contributions).  Same trajectory as the
    single-device bucketed entry up to psum summation order.  ``x0``
    stays in the ORIGINAL landmark order.  LM / GN / DogLeg.
    """
    import numpy as np

    options = options or Options()
    if mesh is None:
        from .mesh import local_mesh
        mesh = local_mesh(axis)
    if not (isinstance(x0, tuple) and len(x0) == 2):
        raise ValueError(
            "sharded_schur_sparse_optimize_buckets needs x0 = (a0, b0)")
    x0 = (mf.as_pytree(x0[0]), mf.as_pytree(x0[1]))
    axis_size = mesh.shape[axis]

    from ..sparse import (_solver_cache_get, _solver_cache_key,
                          _solver_cache_put)
    slabs = [(obs, jnp.asarray(ci, jnp.int32), jnp.asarray(mk),
              np.asarray(ids)) for obs, ci, mk, ids in slabs]
    orig_leaves = jax.tree_util.tree_leaves(
        [(obs, ci, mk) for obs, ci, mk, _ in slabs])
    key = _solver_cache_key(
        "sharded_schur_obs_buckets", pair_fn, options, jit, x0,
        orig_leaves,
        extra=(mesh, axis, chunk) + tuple(
            ids.tobytes() for *_, ids in slabs))
    run = _solver_cache_get(key)
    if run is None:
        a0, b0 = x0
        n_a = jnp.shape(jax.tree_util.tree_leaves(a0)[0])[0]
        n_b = jnp.shape(jax.tree_util.tree_leaves(b0)[0])[0]
        a_ex = jax.tree_util.tree_map(lambda l: l[0], a0)
        b_ex = jax.tree_util.tree_map(lambda l: l[0], b0)
        spec = mf.tangent_spec(x0)
        spec_a = mf.tangent_spec(a_ex)
        spec_b = mf.tangent_spec(b_ex)
        da, db = spec_a.dims, spec_b.dims
        dtype = spec.dtype

        ids_all = np.concatenate([ids for *_, ids in slabs])
        if (ids_all.size != n_b
                or np.any(np.sort(ids_all) != np.arange(n_b))):
            raise ValueError(
                "bucket ids must partition the landmark axis")
        inv_order = jnp.asarray(np.argsort(ids_all), jnp.int32)

        sharding = NamedSharding(mesh, P(axis))
        buckets = []
        n_res = jnp.zeros((), jnp.int32)
        for obs, ci, mk, ids in slabs:
            mk = jnp.asarray(mk, dtype)
            n_g, K = ci.shape
            # pad to a mesh multiple with mask-0 rows (zero contribs)
            n_gm = int(-(-n_g // axis_size) * axis_size)
            padm = n_gm - n_g
            if padm:
                obs = jax.tree_util.tree_map(
                    lambda l: jnp.concatenate(
                        [jnp.asarray(l),
                         jnp.zeros((padm,) + jnp.shape(l)[1:],
                                   jnp.result_type(l))]), obs)
                ci = jnp.concatenate(
                    [ci, jnp.zeros((padm, K), jnp.int32)])
                mk = jnp.concatenate(
                    [mk, jnp.zeros((padm, K), dtype)])
            ng_loc = n_gm // axis_size
            step = min(chunk, max(ng_loc, 1))
            n_lp = int(-(-ng_loc // step) * step)
            padc = n_lp - ng_loc
            CH = _pick_chunk(n_lp, chunk)
            d_ex = jax.tree_util.tree_map(lambda l: l[0, 0], obs)
            m = int(sum(math.prod(l.shape)
                        for l in jax.tree_util.tree_leaves(
                jax.eval_shape(lambda a, b, d: flatten_residuals(
                    pair_fn(a, b, d)), a_ex, b_ex, d_ex))))
            n_res = n_res + (jnp.count_nonzero(mk).astype(jnp.int32)
                             * m)
            kernels = make_obs_kernels(pair_fn, a0, spec_a, spec_b,
                                       dtype, n_a, K, CH)
            obs = jax.tree_util.tree_map(
                lambda l: jax.device_put(jnp.asarray(l), sharding), obs)
            buckets.append(dict(
                obs=obs, cam=jax.device_put(ci, sharding),
                mask=jax.device_put(mk, sharding),
                ids=jnp.asarray(ids, jnp.int32), n_g=n_g,
                ng_loc=ng_loc, padc=padc, K=K, CH=CH, kernels=kernels))

        em2gl, gl2em = bipartite_perms(a0, b0, n_a, n_b, da, db)

        def _to_gl(v):
            return v if em2gl is None else v[em2gl]

        def _to_em(v):
            return v if gl2em is None else v[gl2em]

        x_spec = jax.tree_util.tree_map(lambda _: P(), x0)
        data_spec = tuple(
            (jax.tree_util.tree_map(lambda _: P(axis), bk["obs"]),
             P(axis), P(axis)) for bk in buckets)
        data_vals = tuple((bk["obs"], bk["cam"], bk["mask"])
                          for bk in buckets)
        # H = (Ba replicated, per-bucket C rows, per-bucket E rows) —
        # landmark-side rows sharded on the mesh axis
        H_spec = (P(), tuple(P(axis) for _ in buckets),
                  tuple(P(axis) for _ in buckets))

        def _padc_rows(arr, padc):
            if not padc:
                return arr
            return jnp.concatenate(
                [arr, jnp.zeros((padc,) + arr.shape[1:], arr.dtype)])

        def _local_b(b, bk):
            """This device's rows of bucket bk, padded to CH multiple."""
            b_g = jax.tree_util.tree_map(lambda l: l[bk["ids"]], b)
            j = jax.lax.axis_index(axis)
            ng_loc = bk["ng_loc"]

            def slc(l):
                # bucket rows beyond n_g (mesh pad) have no landmark —
                # broadcast row 0 (mask 0 zeroes the math)
                src = jnp.concatenate(
                    [l, jnp.broadcast_to(
                        l[:1],
                        (ng_loc * axis_size - l.shape[0],)
                        + l.shape[1:])]) \
                    if l.shape[0] < ng_loc * axis_size else l
                loc = jax.lax.dynamic_slice_in_dim(
                    src, j * ng_loc, ng_loc, 0)
                if bk["padc"]:
                    loc = jnp.concatenate(
                        [loc, jnp.broadcast_to(
                            loc[:1], (bk["padc"],) + loc.shape[1:])])
                return loc

            return jax.tree_util.tree_map(slc, b_g)

        @partial(_shard_map, mesh=mesh,
                 in_specs=(x_spec, data_spec),
                 out_specs=(H_spec, P(), P()))
        def _accumulate_sm(x, data):
            a = mf.as_pytree(x[0])
            b = mf.as_pytree(x[1])
            Ba_p = jnp.zeros((n_a, da, da), dtype)
            ga_p = jnp.zeros((n_a, da), dtype)
            rss_p = jnp.zeros((), dtype)
            C_t, E_t, gb_t = [], [], []
            for bk, (obs_l, cam_l, mask_l) in zip(buckets, data):
                acc_slab = bk["kernels"][0]
                Ba_g, ga_g, E_f, C_f, g_b, rss_g = acc_slab(
                    a, _local_b(b, bk),
                    jax.tree_util.tree_map(
                        lambda l: _padc_rows(l, bk["padc"]), obs_l),
                    _padc_rows(cam_l, bk["padc"]),
                    _padc_rows(mask_l, bk["padc"]))
                Ba_p, ga_p = Ba_p + Ba_g, ga_p + ga_g
                rss_p = rss_p + rss_g
                nl = bk["ng_loc"]
                C_t.append(C_f[:nl])
                E_t.append(E_f[:nl])
                gb_t.append(jax.lax.all_gather(g_b[:nl], axis, axis=0,
                                               tiled=True))
            Ba, g_a, rss = jax.lax.psum((Ba_p, ga_p, rss_p), axis)
            g_b_all = jnp.concatenate(
                [gb[:bk["n_g"]] for gb, bk in zip(gb_t, buckets)]
            )[inv_order]
            g = _to_gl(jnp.concatenate(
                [g_a.reshape(-1), g_b_all.reshape(-1)]))
            return (Ba, tuple(C_t), tuple(E_t)), g, rss

        @partial(_shard_map, mesh=mesh, in_specs=(x_spec, data_spec),
                 out_specs=P())
        def _evaluate_sm(x, data):
            a = mf.as_pytree(x[0])
            b = mf.as_pytree(x[1])
            rss = jnp.zeros((), dtype)
            for bk, (obs_l, cam_l, mask_l) in zip(buckets, data):
                eval_slab = bk["kernels"][1]
                rss = rss + eval_slab(
                    a, _local_b(b, bk),
                    jax.tree_util.tree_map(
                        lambda l: _padc_rows(l, bk["padc"]), obs_l),
                    _padc_rows(cam_l, bk["padc"]),
                    _padc_rows(mask_l, bk["padc"]))
            return jax.lax.psum(rss, axis)

        def _bucket_local_rows(v_b, bk, j):
            """This device's rows of bucket bk from the (n_b, k) global
            landmark-side array (mesh-pad rows zero-filled)."""
            rows = v_b[bk["ids"]]
            nl = bk["ng_loc"]
            if bk["n_g"] < nl * axis_size:
                rows = jnp.concatenate(
                    [rows, jnp.zeros(
                        (nl * axis_size - bk["n_g"],) + rows.shape[1:],
                        rows.dtype)])
            return jax.lax.dynamic_slice_in_dim(rows, j * nl, nl, 0)

        def _eliminate_local(H, data, Bd, Cd_t, g, use_chol, refine,
                             cg_it):
            _, _, E_t = H
            g = _to_em(g)
            g_a = g[:n_a * da].reshape(n_a, da)
            g_b = g[n_a * da:].reshape(n_b, db)
            S_f = jnp.zeros((n_a * n_a, da * da), dtype)
            rhs = jnp.zeros((n_a, da), dtype)
            stash = []
            j = jax.lax.axis_index(axis)
            for bk, (obs_l, cam_l, mask_l), E_g, Cd_g in zip(
                    buckets, data, E_t, Cd_t):
                reduce_pass = bk["kernels"][2]
                nl = bk["ng_loc"]
                g_b_l = _bucket_local_rows(g_b, bk, j)
                E_p = _padc_rows(E_g, bk["padc"])
                Cd_p = _padc_rows(Cd_g, bk["padc"])
                cam_p = _padc_rows(cam_l, bk["padc"])
                g_b_p = _padc_rows(g_b_l, bk["padc"])
                S_g, rhs_g, Cinv_p = reduce_pass(E_p, Cd_p, cam_p,
                                                 g_b_p)
                S_f, rhs = S_f + S_g, rhs + rhs_g
                stash.append((E_p, Cinv_p, cam_p, g_b_p))
            S_f, rhs = jax.lax.psum((S_f, rhs), axis)
            dx_a, ok = assemble_reduced(S_f, rhs, Bd, g_a, use_chol,
                                        refine, cg_it)
            ok = ok & jnp.all(jnp.isfinite(dx_a))
            dxb_rows = []
            bad = jnp.zeros((), jnp.int32)
            for bk, (E_p, Cinv_p, cam_p, g_b_p) in zip(buckets, stash):
                backsub = bk["kernels"][3]
                dxb_l = backsub(E_p, Cinv_p, cam_p, g_b_p,
                                dx_a)[:bk["ng_loc"]]
                bad = bad + jnp.any(~jnp.isfinite(dxb_l)) \
                    .astype(jnp.int32)
                dxb_rows.append(jax.lax.all_gather(
                    dxb_l, axis, axis=0, tiled=True)[:bk["n_g"]])
            ok = ok & (jax.lax.psum(bad, axis) == 0)
            dx_b = jnp.concatenate(dxb_rows)[inv_order]
            dx = _to_gl(jnp.concatenate(
                [dx_a.reshape(-1), dx_b.reshape(-1)]))
            return dx, ok

        def make_propose(opts: Options):
            use_chol = opts.hessian.use_ldlt
            refine = opts.hessian.schur_refine
            cg_it = opts.hessian.schur_cg_iters

            @partial(_shard_map, mesh=mesh,
                     in_specs=(H_spec, P(), P(), data_spec),
                     out_specs=(P(), P()))
            def _propose_sm(H, g, lam, data):
                if opts.solver_type == SolverType.DOGLEG:
                    from ..solvers.step import dogleg_core
                    dx_gn, ok_gn = _eliminate_local(
                        H, data, H[0], H[1], g, use_chol, refine,
                        cg_it)
                    # gHg via per-bucket slab contributions + psum
                    gHg = _ghg_full(H, data, g)
                    return dogleg_core(
                        g, lam, dx_gn, ok_gn, gHg,
                        lambda le: _eliminate_local(
                            H, data, _damp_blocks(H[0], le),
                            tuple(_damp_flat(Cg, db, le)
                                  for Cg in H[1]), g, use_chol,
                            refine, cg_it))
                is_lm = (opts.solver_type
                         == SolverType.LEVENBERG_MARQUARDT)
                Bd = _damp_blocks(H[0], lam) if is_lm else H[0]
                Cd_t = (tuple(_damp_flat(Cg, db, lam) for Cg in H[1])
                        if is_lm else H[1])
                return _eliminate_local(H, data, Bd, Cd_t, g,
                                        use_chol, refine, cg_it)

            def propose(H, g, lam, opts_inner):
                return _propose_sm(H, g, lam, data_vals)

            return propose

        def _ghg_full(H, data, g):
            """Replicated gᵀHg from per-bucket slab rows."""
            _, C_t, E_t = H
            gv = _to_em(g)
            v_a = gv[:n_a * da].reshape(n_a, da)
            v_b = gv[n_a * da:].reshape(n_b, db)
            t_a = jnp.vdot(v_a, _esum("iab,ib->ia", H[0], v_a))
            t_loc = jnp.zeros((), dtype)
            j = jax.lax.axis_index(axis)
            for bk, (obs_l, cam_l, mask_l), C_g, E_g in zip(
                    buckets, data, C_t, E_t):
                nl = bk["ng_loc"]
                K = bk["K"]
                v_b_l = _bucket_local_rows(v_b, bk, j)
                E4 = E_g.reshape(nl, K, da, db)
                C3 = C_g.reshape(nl, db, db)
                va_g = v_a[cam_l[:nl]]
                Evb = _esum("jkab,jb->jka", E4, v_b_l)
                t_loc = t_loc + 2.0 * jnp.vdot(va_g, Evb) + jnp.vdot(
                    v_b_l, _esum("jab,jb->ja", C3, v_b_l))
            return t_a + jax.lax.psum(t_loc, axis)

        propose = make_propose(options)

        def accumulate(x, data):
            H, g, rss = _accumulate_sm(x, data)
            return H, g, Cost.make(rss, n_res)

        def evaluate(x, data):
            return Cost.make(_evaluate_sm(x, data), n_res)

        def solve(x, data):
            return optimize_from_acc(
                x, lambda xv: accumulate(xv, data),
                lambda xv: evaluate(xv, data), options, spec,
                propose=propose)

        if jit:
            solve = jax.jit(solve)

        def run(x):
            return solve(x, data_vals)

        _solver_cache_put(key, run, orig_leaves)
    return run(x0)


def sharded_schur_sparse_covariance(x, pair_fn: Callable, obs, cam_idx,
                                    mask, *, mesh: Mesh | None = None,
                                    axis: str = "block",
                                    chunk: int = 1024,
                                    rescaled: bool = False,
                                    jit: bool = True):
    """Posterior marginal covariance blocks over the mesh.

    The covariance companion of :func:`sharded_schur_sparse_optimize` —
    the mesh-scale form of ``sparse.schur_sparse_covariance``, same
    point-major layout, same return ``(cov_a (n_a, da, da), cov_b
    (n_b, db, db))`` and the same algebra (camera marginals = S⁻¹'s
    diagonal blocks; landmark blocks C⁻¹ + C⁻¹EᵀS⁻¹EC⁻¹).
    Decomposition: each device re-linearizes its landmark slab and
    builds its reduced-system partial; ONE ``psum`` each completes Ba
    and S (the reduced solve side is replicated by design, exactly as in
    the solver); the S⁻¹ and camera marginals compute replicated, and
    each device backs out its own slab's landmark marginals (the
    ``P(axis)``-sharded output).  ``rescaled`` as in output.h:80-93.
    """
    if mesh is None:
        from .mesh import local_mesh
        mesh = local_mesh(axis)
    if not (isinstance(x, tuple) and len(x) == 2):
        raise ValueError(
            "sharded_schur_sparse_covariance needs x = (a, b)")
    x = (mf.as_pytree(x[0]), mf.as_pytree(x[1]))
    cam_idx = jnp.asarray(cam_idx, jnp.int32)
    spec = mf.tangent_spec(x)
    mask = jnp.asarray(mask, spec.dtype)

    n_b = jnp.shape(jax.tree_util.tree_leaves(x[1])[0])[0]
    axis_size = mesh.shape[axis]
    if n_b % axis_size != 0:
        raise ValueError(
            f"n_b={n_b} not divisible by mesh axis "
            f"'{axis}'={axis_size}; pad the landmark axis with mask=0 "
            "points")

    from ..sparse import (_solver_cache_get, _solver_cache_key,
                          _solver_cache_put)
    orig_leaves = jax.tree_util.tree_leaves((obs, cam_idx, mask))
    key = _solver_cache_key(
        "sharded_schur_obs_cov", pair_fn, None, jit, x,
        orig_leaves, extra=(mesh, axis, chunk, rescaled))
    run = _solver_cache_get(key)
    if run is None:
        sharding = NamedSharding(mesh, P(axis))
        already_global = any(
            getattr(l, "sharding", None) is not None
            and not getattr(l, "is_fully_addressable", True)
            for l in jax.tree_util.tree_leaves((obs, cam_idx, mask)))
        if not already_global:
            obs = jax.tree_util.tree_map(
                lambda a: jax.device_put(jnp.asarray(a), sharding), obs)
            cam_idx = jax.device_put(cam_idx, sharding)
            mask = jax.device_put(mask, sharding)

        a0, b0 = x
        n_a = jnp.shape(jax.tree_util.tree_leaves(a0)[0])[0]
        a_ex = jax.tree_util.tree_map(lambda l: l[0], a0)
        b_ex = jax.tree_util.tree_map(lambda l: l[0], b0)
        spec_a = mf.tangent_spec(a_ex)
        spec_b = mf.tangent_spec(b_ex)
        da, db = spec_a.dims, spec_b.dims
        dtype = spec.dtype
        K = jnp.shape(cam_idx)[1]
        nb_loc = n_b // axis_size
        step = min(chunk, max(nb_loc, 1))
        n_lp = int(-(-nb_loc // step) * step)
        pad = n_lp - nb_loc
        CH = _pick_chunk(n_lp, chunk)

        d_ex = jax.tree_util.tree_map(lambda l: l[0, 0], obs)
        m = int(sum(math.prod(l.shape)
                    for l in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda a, b, d: flatten_residuals(
                pair_fn(a, b, d)), a_ex, b_ex, d_ex))))
        n_res = jnp.count_nonzero(mask).astype(jnp.int32) * m

        acc_slab, _, reduce_pass, _ = make_obs_kernels(
            pair_fn, a0, spec_a, spec_b, dtype, n_a, K, CH)
        marginal_pass = make_landmark_marginal_pass(
            n_a, K, da, db, dtype, CH)

        x_spec = jax.tree_util.tree_map(lambda _: P(), x)
        obs_spec = jax.tree_util.tree_map(lambda _: P(axis), obs)

        def _pad_rows(arr):
            if not pad:
                return arr
            return jnp.concatenate(
                [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])

        def _pad_b_rows(b):
            if not pad:
                return b
            return jax.tree_util.tree_map(
                lambda l: jnp.concatenate(
                    [l, jnp.broadcast_to(l[:1],
                                         (pad,) + l.shape[1:])]), b)

        @partial(_shard_map, mesh=mesh,
                 in_specs=(x_spec, obs_spec, P(axis), P(axis)),
                 out_specs=(P(), P(axis), P()))
        def _cov_sm(xv, obs_l, cam_l, mask_l):
            a = mf.as_pytree(xv[0])
            j = jax.lax.axis_index(axis)
            b_loc = jax.tree_util.tree_map(
                lambda l: jax.lax.dynamic_slice_in_dim(
                    l, j * nb_loc, nb_loc, 0), mf.as_pytree(xv[1]))
            Ba_p, _, E_f, C_f, _, rss_p = acc_slab(
                a, _pad_b_rows(b_loc),
                jax.tree_util.tree_map(_pad_rows, obs_l),
                _pad_rows(cam_l), _pad_rows(mask_l))
            Ba, rss = jax.lax.psum((Ba_p, rss_p), axis)
            cam_p = _pad_rows(cam_l)
            S_f, _, Cinv_p = reduce_pass(
                E_f, C_f, cam_p, jnp.zeros((n_lp, db), dtype))
            # the reconstruction inside reduce_pass is linear, so the
            # cross-landmark completion commutes with it: one psum.
            S_f = jax.lax.psum(S_f, axis)
            cov_a, Sinv = camera_marginals_from_S(S_f, Ba)
            cov_b_l = marginal_pass(E_f, Cinv_p, cam_p, Sinv)[:nb_loc]
            # zero-observation landmarks: NaN (inv_cov contract), not
            # the zero-C identity substitution's leak
            dead = jnp.all(C_f[:nb_loc] == 0, axis=1)
            cov_b_l = jnp.where(dead[:, None, None], jnp.nan, cov_b_l)
            return cov_a, cov_b_l, rss

        def compute(xv, o, ci, mk):
            cov_a, cov_b, rss = _cov_sm(xv, o, ci, mk)
            if rescaled:
                from ..ops.linalg import cov_rescale
                f = cov_rescale(rss, n_res, spec.dims)
                cov_a, cov_b = cov_a * f, cov_b * f
            return cov_a, cov_b

        if jit:
            compute = jax.jit(compute)
        obs_g, cam_g, mask_g = obs, cam_idx, mask

        def run(xv):
            return compute(xv, obs_g, cam_g, mask_g)

        _solver_cache_put(key, run, orig_leaves)
    return run(x)
