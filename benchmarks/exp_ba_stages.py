"""Stage-level device-time decomposition of the sparse-obs BA iteration.

Measures each pipeline stage of the 1000-camera corridor BA separately,
so an optimization target is a number, not a narrative:

  * ``accumulate``  — chunked linearize sweeps + Ba/g_a segment_sums
  * ``reduce``      — pass A: C⁻¹, EC, camera-pair blocks + the flat
                      (n_a², da²) scatter (the suspected bottleneck)
  * ``assemble``    — reduced 6000² Cholesky (+ schur_refine rounds)
  * ``backsub``     — pass C landmark back-substitution

Protocol: every stage runs K reps inside ONE dispatched
``lax.fori_loop``; per-rep inputs are perturbed from the loop carry so
no rep can be elided by DCE; a scalar derived from every output is
carried and read at the end.  Marginal time = (wall(K) − wall(1)) /
(K − 1) cancels dispatch and compile noise.

Usage: python benchmarks/exp_ba_stages.py [n_cams n_pts k_obs reps]
(f32; set BA_DTYPE=float64 for f64)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(n_cams=1000, n_pts=50_000, k_obs=8, reps=9, chunk=1024):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tinyopt_tpu import manifold as mf
    from tinyopt_tpu.models.bundle_adjustment import (make_ba_problem_sparse,
                                                      project)
    from tinyopt_tpu.ops.schur_obs import (_pick_chunk, assemble_reduced,
                                           make_obs_kernels)

    dtype = jnp.dtype(os.environ.get("BA_DTYPE", "float32"))
    (obs, cam_idx, mask), x0, _ = make_ba_problem_sparse(
        n_cams=n_cams, n_pts=n_pts, k_obs=k_obs, noise=1e-3, seed=7,
        dtype=dtype)
    a0, b0 = x0["poses"], x0["points"]
    spec_a = mf.tangent_spec(jax.tree_util.tree_map(lambda l: l[0],
                                                    mf.as_pytree(a0)))
    spec_b = mf.tangent_spec(b0[0])
    da, db = spec_a.dims, spec_b.dims
    K = int(cam_idx.shape[1])
    CH = _pick_chunk(n_pts, chunk)
    mask = jnp.asarray(mask, dtype)

    def pair_fn(pose, point, ob):
        return project(pose, point[None, :])[0] - ob

    acc_slab, _, reduce_scatter, backsub_pass = make_obs_kernels(
        pair_fn, mf.as_pytree(a0), spec_a, spec_b, dtype, n_cams, K, CH)
    from tinyopt_tpu.ops.schur_obs import make_reduce_pass_planned
    reduce_planned = make_reduce_pass_planned(
        n_cams, K, da, db, dtype, CH, np.asarray(cam_idx))

    a_tree = mf.as_pytree(a0)

    # one real accumulate to get representative E/C/g shapes+values
    Ba, g_a, E_f, C_f, g_b, _ = jax.jit(lambda b: acc_slab(
        a_tree, b, obs, cam_idx, mask))(b0)
    jax.block_until_ready(E_f)

    def timed(fn, *args):
        """Marginal per-rep wall of fn under the K-rep fori design."""

        def loop(k, *args):
            def body(i, carry):
                s, _ = carry
                out = fn(jnp.asarray(1.0, dtype) + s * 1e-12, *args)
                return (out, carry[0] * 0.0)

            out0 = fn(jnp.asarray(1.0, dtype), *args)
            s, _ = jax.lax.fori_loop(0, k - 1, body, (out0, out0 * 0.0))
            return s

        jl = jax.jit(loop, static_argnums=0)
        walls = {}
        for k in (1, reps):
            float(jl(k, *args))  # compile + warm
            t0 = time.perf_counter()
            float(jl(k, *args))
            walls[k] = time.perf_counter() - t0
        return (walls[reps] - walls[1]) / (reps - 1)

    # ---- stage closures: perturb via the carried scalar eps ----
    def st_accumulate(eps, b):
        Ba_, ga_, Ef_, Cf_, gb_, rss_ = acc_slab(
            a_tree, b * eps, obs, cam_idx, mask)
        return (rss_ + jnp.sum(Ba_[0]) + jnp.sum(Ef_[0]) + jnp.sum(Cf_[0])
                + jnp.sum(ga_[0]) + jnp.sum(gb_[0])).astype(dtype)

    def st_reduce(eps, E_p, C_p, g_b_p):
        S_f, rhs, Cinv = reduce_scatter(E_p * eps, C_p * eps, cam_idx,
                                        g_b_p)
        return (jnp.sum(S_f[0]) + jnp.sum(rhs[0])
                + jnp.sum(Cinv[0])).astype(dtype)

    def st_reduce_planned(eps, E_p, C_p, g_b_p):
        S_f, rhs, Cinv = reduce_planned(E_p * eps, C_p * eps, cam_idx,
                                        g_b_p)
        return (jnp.sum(S_f[0]) + jnp.sum(rhs[0])
                + jnp.sum(Cinv[0])).astype(dtype)

    S_f0, rhs0, Cinv0 = jax.jit(
        lambda E, C, g: reduce_scatter(E, C, cam_idx, g))(E_f, C_f, g_b)
    jax.block_until_ready(S_f0)

    def st_assemble(eps, S_f, rhs, Bd, g_a):
        dx_a, ok = assemble_reduced(S_f * eps, rhs, Bd, g_a,
                                    True, 2)
        return (jnp.sum(dx_a[0]) + ok).astype(dtype)

    def st_assemble_cg(eps, S_f, rhs, Bd, g_a):
        dx_a, ok = assemble_reduced(S_f * eps, rhs, Bd, g_a,
                                    True, 0, 64)
        return (jnp.sum(dx_a[0]) + ok).astype(dtype)

    from tinyopt_tpu.ops.schur_obs import (detect_camera_bandwidth,
                                           pick_band_group)
    band_g = pick_band_group(
        detect_camera_bandwidth(np.asarray(cam_idx), np.asarray(mask)),
        n_cams, da)

    def st_assemble_banded(eps, S_f, rhs, Bd, g_a):
        dx_a, ok = assemble_reduced(S_f * eps, rhs, Bd, g_a,
                                    True, 2, 0, band_g)
        return (jnp.sum(dx_a[0]) + ok).astype(dtype)

    def st_assemble_banded0(eps, S_f, rhs, Bd, g_a):
        dx_a, ok = assemble_reduced(S_f * eps, rhs, Bd, g_a,
                                    True, 0, 0, band_g)
        return (jnp.sum(dx_a[0]) + ok).astype(dtype)

    def st_backsub(eps, E_p, Cinv, g_b_p, dx_a):
        dx_b = backsub_pass(E_p * eps, Cinv, cam_idx, g_b_p, dx_a)
        return jnp.sum(dx_b[0]).astype(dtype)

    dx_a0 = jnp.zeros((n_cams, da), dtype)

    # ---- reduce sub-decomposition: planned reduces alone vs the chunk
    # loop; 3x3 C-inverse via batched Cholesky vs closed-form adjugate.
    from tinyopt_tpu.ops.schur_obs import make_planned_segment_reduce
    cam_np = np.asarray(cam_idx, np.int64)
    _ks = np.asarray([k for k in range(K) for l in range(k)])
    _ls = np.asarray([l for k in range(K) for l in range(k)])
    P_tri = len(_ks)
    reduce_tri = make_planned_segment_reduce(
        (cam_np[:, _ks] * n_cams + cam_np[:, _ls]).ravel(),
        n_cams * n_cams)
    reduce_slot = make_planned_segment_reduce(cam_np.ravel(), n_cams)
    tri_rows0 = jnp.zeros((n_pts * P_tri, da * da), dtype) + 0.5
    slot_rows0 = jnp.zeros((n_pts * K, da * da), dtype) + 0.5

    def st_tri_gather(eps, rows_):
        return jnp.sum(reduce_tri(rows_ * eps)[0]).astype(dtype)

    def st_slot_gather(eps, rows_):
        return jnp.sum(reduce_slot(rows_ * eps)[0]).astype(dtype)

    C3 = C_f.reshape(n_pts, db, db) + 2.0 * jnp.eye(db, dtype=dtype)

    def st_cinv_chol(eps, Cb):
        eye = jnp.eye(db, dtype=dtype)
        with jax.default_matmul_precision("highest"):
            ch = jax.vmap(jnp.linalg.cholesky)(Cb * eps)
            Ci = jax.vmap(lambda L: jax.scipy.linalg.cho_solve(
                (L, True), eye))(ch)
        return jnp.sum(Ci[0]).astype(dtype)

    def st_cinv_adj(eps, Cb):
        C = Cb * eps
        a, b, c = C[:, 0, 0], C[:, 0, 1], C[:, 0, 2]
        d, e, f = C[:, 1, 1], C[:, 1, 2], C[:, 2, 2]
        A = d * f - e * e
        Bc = c * e - b * f
        Cc = b * e - c * d
        det = a * A + b * Bc + c * Cc
        D = a * f - c * c
        E = b * c - a * e
        F = a * d - b * b
        inv_det = 1.0 / det
        Ci = jnp.stack([A, Bc, Cc, Bc, D, E, Cc, E, F], -1) \
            .reshape(-1, db, db) * inv_det[:, None, None]
        return jnp.sum(Ci[0]).astype(dtype)

    # ---- chunk-loop attribution (VERDICT r4 #2): split the planned
    # pass A into (a) the chunk loop alone (algebra + row-buffer
    # writes), (b) the pair algebra alone (blocks computed and summed,
    # never written to the global buffers), (c) the buffer writes alone
    # (constant blocks, no algebra).  (a) − reduce sub-gathers is the
    # previously-unattributed "remainder".
    from tinyopt_tpu.ops.schur_obs import (_pair_block_chunk,
                                           _planned_row_buffers)
    eye_db = jnp.eye(db, dtype=dtype)
    ks_j = jnp.asarray(_ks, jnp.int32)
    ls_j = jnp.asarray(_ls, jnp.int32)

    def st_chunkloop(eps, E_p, C_p, g_b_p):
        tri_rows, diag_rows, rhs_buf, Cinv_f = _planned_row_buffers(
            E_p * eps, C_p * eps, g_b_p, K, da, db, dtype, CH)
        return (jnp.sum(tri_rows[0]) + jnp.sum(diag_rows[0])
                + jnp.sum(rhs_buf[0]) + jnp.sum(Cinv_f[0])).astype(dtype)

    def st_pair_algebra(eps, E_p, C_p, g_b_p):
        def body(c, s):
            E_c = jax.lax.dynamic_slice_in_dim(E_p, c * CH, CH, 0) \
                .reshape(CH, K, da, db)
            Cd_c = jax.lax.dynamic_slice_in_dim(C_p, c * CH, CH, 0) \
                .reshape(CH, db, db)
            g_c = jax.lax.dynamic_slice_in_dim(g_b_p, c * CH, CH, 0)
            Ci, bt, bd, rr = _pair_block_chunk(E_c * eps, Cd_c * eps,
                                               g_c, ks_j, ls_j, eye_db,
                                               dtype)
            return s + jnp.sum(Ci) + jnp.sum(bt) + jnp.sum(bd) \
                + jnp.sum(rr)

        return jax.lax.fori_loop(0, n_pts // CH, body,
                                 jnp.zeros((), dtype)).astype(dtype)

    def st_buffer_writes(eps, blk_tri_c, blk_diag_c, rhs_c):
        def body(c, carry):
            tri_rows, diag_rows, rhs_buf = carry
            tri_rows = jax.lax.dynamic_update_slice_in_dim(
                tri_rows, blk_tri_c * eps, c * CH * P_tri, 0)
            diag_rows = jax.lax.dynamic_update_slice_in_dim(
                diag_rows, blk_diag_c * eps, c * CH * K, 0)
            rhs_buf = jax.lax.dynamic_update_slice_in_dim(
                rhs_buf, rhs_c * eps, c * CH * K, 0)
            return tri_rows, diag_rows, rhs_buf

        init = (jnp.zeros((n_pts * P_tri, da * da), dtype),
                jnp.zeros((n_pts * K, da * da), dtype),
                jnp.zeros((n_pts * K, da), dtype))
        tri_rows, diag_rows, rhs_buf = jax.lax.fori_loop(
            0, n_pts // CH, body, init)
        return (jnp.sum(tri_rows[0]) + jnp.sum(diag_rows[0])
                + jnp.sum(rhs_buf[0])).astype(dtype)

    blk_tri_c0 = jnp.full((CH * P_tri, da * da), 0.5, dtype)
    blk_diag_c0 = jnp.full((CH * K, da * da), 0.5, dtype)
    rhs_c0 = jnp.full((CH * K, da), 0.5, dtype)

    # ---- windowed matmul reduce: measured on the SORTED layout the
    # schur_sort="auto" path solves in (landmark order is arbitrary;
    # the sort is a one-time static permutation at build).
    from tinyopt_tpu.ops.schur_obs import (camera_sort_perm,
                                           make_reduce_pass_window,
                                           plan_window_reduce)
    sort_perm = camera_sort_perm(cam_np, np.asarray(mask), n_cams,
                                 k_obs, chunk)
    if sort_perm is None:
        wplan = plan_window_reduce(cam_np, n_cams, K, CH)
        cam_sorted = cam_idx
        E_srt, C_srt, g_b_srt = E_f, C_f, g_b
    else:
        wplan = plan_window_reduce(cam_np[sort_perm], n_cams, K, CH)
        permj = jnp.asarray(sort_perm)
        cam_sorted = cam_idx[permj]
        E_srt, C_srt, g_b_srt = E_f[permj], C_f[permj], g_b[permj]
    if wplan is not None:
        reduce_window = make_reduce_pass_window(
            n_cams, K, da, db, dtype, CH, wplan)

        def st_reduce_window(eps, E_p, C_p, g_b_p):
            S_f, rhs, Cinv = reduce_window(E_p * eps, C_p * eps,
                                           cam_sorted, g_b_p)
            return (jnp.sum(S_f[0]) + jnp.sum(rhs[0])
                    + jnp.sum(Cinv[0])).astype(dtype)

    # band-storage direct path: reduce straight into band entries +
    # CR solve from the band (taken when banded + window both plan —
    # replaces reduce+assemble in one stage)
    from tinyopt_tpu.ops.schur_obs import (_damp_blocks,
                                           banded_reduced_solve_band,
                                           make_reduce_pass_window_banded,
                                           plan_window_reduce_banded)
    bw_det = None
    bplan = None
    if band_g is not None:
        from tinyopt_tpu.ops.schur_obs import detect_camera_bandwidth
        cam_for_band = cam_np if sort_perm is None else cam_np[sort_perm]
        bw_det = detect_camera_bandwidth(cam_for_band, np.asarray(mask))
        bplan = plan_window_reduce_banded(cam_for_band, n_cams, K, CH,
                                          bw_det)
    if bplan is not None:
        reduce_band = make_reduce_pass_window_banded(
            n_cams, K, da, db, dtype, CH, bplan)
        lam0 = jnp.asarray(1e-4, dtype)

        def st_band_direct(eps, E_p, C_p, g_b_p, Ba_, g_a_):
            S_low, rhs, Cinv = reduce_band(E_p * eps, C_p * eps,
                                           cam_sorted, g_b_p)
            Bd = _damp_blocks(Ba_, lam0)
            dx_a, ok = banded_reduced_solve_band(
                S_low.reshape(n_cams, bw_det + 1, da, da), Bd,
                -g_a_ + rhs, band_g, 2)
            return (jnp.sum(dx_a[:da]) + jnp.sum(Cinv[0])
                    + ok).astype(dtype)

    rows = [
        ("accumulate", timed(st_accumulate, b0)),
        ("reduce (scatter)", timed(st_reduce, E_f, C_f, g_b)),
        ("reduce (planned)", timed(st_reduce_planned, E_f, C_f, g_b)),
    ] + ([
        (f"reduce (window W={wplan[2]}"
         + (" sorted)" if sort_perm is not None else ")"),
         timed(st_reduce_window, E_srt, C_srt, g_b_srt)),
    ] if wplan is not None else []) + ([
        (f"reduce+assemble (band W={bplan[2]})",
         timed(st_band_direct, E_srt, C_srt, g_b_srt, Ba, g_a)),
    ] if bplan is not None else []) + [
        ("  sub: chunk loop (alg+buf)", timed(st_chunkloop, E_f, C_f,
                                              g_b)),
        ("  sub: pair algebra only", timed(st_pair_algebra, E_f, C_f,
                                           g_b)),
        ("  sub: buffer writes only", timed(st_buffer_writes, blk_tri_c0,
                                            blk_diag_c0, rhs_c0)),
        ("assemble+refine2", timed(st_assemble, S_f0, rhs0, Ba, g_a)),
        ("backsub", timed(st_backsub, E_f, Cinv0, g_b, dx_a0)),
        ("  sub: assemble cg=64", timed(st_assemble_cg, S_f0, rhs0,
                                        Ba, g_a)),
    ] + ([
        (f"  sub: assemble banded g={band_g}+refine2",
         timed(st_assemble_banded, S_f0, rhs0, Ba, g_a)),
        (f"  sub: assemble banded g={band_g} refine0",
         timed(st_assemble_banded0, S_f0, rhs0, Ba, g_a)),
    ] if band_g else []) + [
        ("  sub: tri gather-reduce", timed(st_tri_gather, tri_rows0)),
        ("  sub: slot gather-reduce", timed(st_slot_gather, slot_rows0)),
        ("  sub: 3x3 inv (cholesky)", timed(st_cinv_chol, C3)),
        ("  sub: 3x3 inv (adjugate)", timed(st_cinv_adj, C3)),
    ]
    # the solver's DEFAULT path: planned reduce + (when the structure
    # allows) the banded reduced solve — total swaps in the banded
    # assemble row and excludes the scatter row + sub-probes
    banded_t = next((t for name, t in rows
                     if name.startswith("  sub: assemble banded")
                     and "refine2" in name), None)
    band_direct_t = next((t for name, t in rows
                          if name.startswith("reduce+assemble (band")),
                         None)
    if band_direct_t is not None:
        # the r5 default path: accumulate + band-direct + backsub
        total = band_direct_t + sum(
            t for name, t in rows if name in ("accumulate", "backsub"))
    else:
        has_window = any(name.startswith("reduce (window")
                         for name, _ in rows)
        total = sum(t for name, t in rows
                    if name != "reduce (scatter)"
                    and not name.startswith("reduce+assemble")
                    and not (has_window and name == "reduce (planned)")
                    and not name.startswith("  sub:")
                    and not (banded_t is not None
                             and name == "assemble+refine2"))
        if banded_t is not None:
            total += banded_t
    print(f"# stage decomposition: {n_cams} cams x {n_pts} pts, K={k_obs},"
          f" dtype={jnp.dtype(dtype).name},"
          f" backend={jax.default_backend()}, marginal over {reps-1} reps")
    for name, t in rows:
        print(f"{name:28s} {t*1e3:9.2f} ms/iter  {100*t/total:5.1f}%")
    print(f"{'TOTAL':28s} {total*1e3:9.2f} ms/iter")

    return rows


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
