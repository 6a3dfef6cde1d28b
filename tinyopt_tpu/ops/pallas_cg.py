"""Batched conjugate-gradient solve as one Pallas kernel through Triton.

Under ``vmap`` (the batched solvers) every LM iteration solves thousands
of small damped systems ``(H_b + λD_b) dx_b = −g_b`` with a fixed number
of Jacobi-preconditioned CG iterations.  XLA's version
(:func:`~tinyopt_tpu.ops.linalg.solve_psd_cg`) reads the whole H tensor
from device memory on every CG iteration — ``B·d²`` words, 100 MB at
B = 10k, d = 50 in f32, twice an H100's L2.  This kernel loads each
instance's H into registers once and runs every iteration there, so the
traffic drops from ``iters × |H|`` to ``|H|``.

Integration: :func:`make_cg_solver` is a ``custom_vmap``.  Called
un-batched (inside the per-instance optimizer loop) it is the plain CG;
under ``vmap`` its rule sees the whole batch once and
:func:`use_triton_cg` picks the kernel or XLA from the platform and the
padded width.  Both run :func:`~tinyopt_tpu.ops.linalg.pcg_core`, so the
iterates agree up to f32 summation order.

No reference counterpart: the reference is single-instance (SURVEY.md
§2.3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .linalg import pcg_core, solve_psd_cg

#: Padded widths (``d`` rounded up to a power of two, which the Triton
#: route requires of every block) the kernel takes.  Above the upper
#: bound one instance's (D, D) block no longer fits a program's
#: registers (D = 256 is 64k words, the whole SM's register file).
MIN_PADDED_D = 8
MAX_PADDED_D = 128
#: Words of H each program holds: a program solves
#: ``max(1, _PROGRAM_WORDS // D²)`` instances with 8 warps, the CG loop
#: inside (four at d = 50; on an H100 at B = 10k, d = 50, 8 iterations,
#: one, two and four instances per program took 0.54, 0.51 and 0.48 ms).
_PROGRAM_WORDS = 16384


def padded_width(d: int) -> int:
    """``d`` rounded up to the next power of two."""
    return 1 << max(d - 1, 0).bit_length()


def use_triton_cg(platform: str, d: int, batch: int) -> bool:
    """Whether a batched CG of ``batch`` systems of width ``d`` runs the
    Triton kernel: only on a GPU, only for padded widths within
    [``MIN_PADDED_D``, ``MAX_PADDED_D``], and only while the kernel's
    32-bit element offsets into the flattened H cannot overflow."""
    D = padded_width(d)
    return (platform == "gpu" and MIN_PADDED_D <= D <= MAX_PADDED_D
            and batch * d * d < 2 ** 31)


def _cg_kernel(H_ref, b_ref, x_ref, *, n: int, d: int, D: int, bt: int,
               iters: int):
    inst = pl.program_id(0) * bt + jnp.arange(bt)
    valid = inst < n
    row = jnp.arange(D)
    live = valid[:, None] & (row < d)[None, :]                   # (bt, D)
    h_mask = live[:, :, None] & (row < d)[None, None, :]         # (bt, D, D)
    h_off = (inst[:, None, None] * (d * d) + row[None, :, None] * d
             + row[None, None, :])
    v_off = inst[:, None] * d + row[None, :]
    H = plgpu.load(H_ref.at[h_off], mask=h_mask, other=0.0)
    b = plgpu.load(b_ref.at[v_off], mask=live, other=0.0)
    # Padding: identity on the padded diagonal (and for whole padded
    # instances) with a zero right-hand side, which CG leaves at zero.
    eye = (row[:, None] == row[None, :]).astype(H.dtype)
    H = H + jnp.where(live[:, :, None], 0.0, eye[None])
    diag = jnp.sum(H * eye[None], axis=2)
    dinv = jnp.where(diag > 0, 1.0 / jnp.where(diag > 0, diag, 1.0), 1.0)
    # Matvec as a multiply and a row reduction in full f32: no tensor
    # cores, so no TF32 rounding.
    x = pcg_core(lambda p: jnp.sum(H * p[:, None, :], axis=2), dinv, b,
                 iters)
    plgpu.store(x_ref.at[v_off], x.astype(x_ref.dtype), mask=live)


def batched_cg_triton(H: jax.Array, b: jax.Array, iters: int,
                      interpret: bool = False) -> jax.Array:
    """Solve B systems ``H[i] x = b[i]`` with the register-resident CG.

    ``H``: (B, d, d), ``b``: (B, d).  Each program loads its instances'
    blocks padded to (D, D), D = :func:`padded_width` (d), by masked
    loads from the flattened arrays, so no padded copy of H is written.
    ``interpret=True`` runs the same kernel on the CPU (tests).
    """
    B, d, _ = H.shape
    D = padded_width(d)
    bt = max(1, _PROGRAM_WORDS // (D * D))
    x = pl.pallas_call(
        functools.partial(_cg_kernel, n=B, d=d, D=D, bt=bt, iters=iters),
        grid=(pl.cdiv(B, bt),),
        out_shape=jax.ShapeDtypeStruct((B * d,), b.dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=8, num_stages=1),
        interpret=interpret,
        name="tinyopt_batched_cg",
    )(H.reshape(-1), b.reshape(-1))
    return x.reshape(B, d)


def make_cg_solver(iters: int):
    """A ``custom_vmap``-wrapped CG solve: (d,d),(d,) -> (d,).

    Unbatched → plain XLA CG.  vmapped (the batched optimizer) → one call
    on the whole batch, on the Triton kernel where :func:`use_triton_cg`
    says so and on XLA otherwise.
    """

    @jax.custom_batching.custom_vmap
    def cg(H, b):
        return solve_psd_cg(H, b, iters)

    @cg.def_vmap
    def _cg_vmap(axis_size, in_batched, H, b):
        H_b, b_b = in_batched
        if not H_b:
            H = jnp.broadcast_to(H, (axis_size,) + H.shape)
        if not b_b:
            b = jnp.broadcast_to(b, (axis_size,) + b.shape)
        if not use_triton_cg(jax.default_backend(), b.shape[-1],
                             axis_size):
            return solve_psd_cg(H, b, iters), True
        # Under a second vmap the kernel call itself is batched (one
        # more grid axis).
        return batched_cg_triton(H, b, iters), True

    return cg
