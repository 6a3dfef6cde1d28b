"""Residual-block sharding: psum-reduced normal equations over the mesh.

For a single large problem with many residual blocks, the blocks are
sharded over a mesh axis; each device accumulates its partial
(JᵀJ, JᵀR, cost) with vmapped forward-mode AD, and one ``psum`` per
quantity reduces them over ICI.  The outer LM loop then runs replicated —
every device holds identical (H, g) after the reduction, so the Cholesky
solve and λ schedule need no further communication.

This is the domain analogue of sequence-parallel gradient accumulation
(SURVEY.md §5.7-5.8, BASELINE.json north star) and is a new capability
with no reference counterpart (the reference is single-threaded).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import manifold as mf
from ..cost import Cost
from ..diff.auto import flatten_residuals, value_and_jacfwd
from ..optimizers.loop import optimize_from_acc
from ..options import Options


def _shard_map(fn, mesh, in_specs, out_specs):
    # check_vma/check_rep off: a Pallas call's out_shape carries no
    # varying-mesh-axes annotation, and per-shard independence is by
    # construction here (pure data parallelism over instances).
    try:
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    except (AttributeError, TypeError):
        from jax.experimental.shard_map import shard_map as sm
        return sm(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                  check_rep=False)


def make_block_system(block_fn: Callable, data, x0, mesh: Mesh,
                      axis: str = "block", spec=None):
    """Build psum-reduced (accumulate, evaluate, n_res) closures.

    ``block_fn(x, block_data) -> residuals`` evaluates one residual block;
    ``data`` leaves have a leading block axis whose size must be divisible
    by the mesh axis.  Jacobians are computed per block on the tangent
    space and contracted locally — the full J (n_blocks·block_size × dims)
    never exists in memory, matching the reference's accumulation-function
    contract (reference: docs/API.md:37-57) at scale.
    """
    if spec is None:
        spec = mf.tangent_spec(x0)
    d = spec.dims

    n_blocks = jax.tree_util.tree_leaves(data)[0].shape[0]
    axis_size = mesh.shape[axis]
    if n_blocks % axis_size != 0:
        raise ValueError(
            f"n_blocks={n_blocks} not divisible by mesh axis "
            f"'{axis}'={axis_size}; pad the block axis")
    # Shape-only probe (no a[0] indexing: in multi-process meshes ``data``
    # is a global array spanning non-addressable devices, which cannot be
    # computed on eagerly).
    block0 = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(jnp.shape(a)[1:],
                                       jnp.result_type(a)), data)
    r_shape = jax.eval_shape(lambda x, b: flatten_residuals(block_fn(x, b)),
                             x0, block0)
    n_res = n_blocks * math.prod(r_shape.shape)

    # x is replicated; data is sharded on the block axis.
    x_spec = jax.tree_util.tree_map(lambda _: P(), x0)
    data_spec = jax.tree_util.tree_map(lambda _: P(axis), data)

    def _local_partials(x, data_shard):
        def one(bd):
            def r_of_delta(delta):
                return flatten_residuals(
                    block_fn(mf.retract(x, delta, spec), bd))
            r, J = value_and_jacfwd(r_of_delta, mf.zero_tangent(x, spec))
            r = r.astype(spec.dtype)
            J = J.astype(spec.dtype)
            return (jnp.matmul(J.T, J, preferred_element_type=spec.dtype),
                    J.T @ r, jnp.vdot(r, r))
        Hs, gs, cs = jax.vmap(one)(data_shard)
        return jnp.sum(Hs, 0), jnp.sum(gs, 0), jnp.sum(cs, 0)

    @partial(_shard_map, mesh=mesh,
             in_specs=(x_spec, data_spec), out_specs=(P(), P(), P()))
    def _accumulate_sm(x, data):
        H, g, c = _local_partials(x, data)
        # ONE fused all-reduce for (H, g, cost): each psum is a
        # rendezvous (collective launch + barrier), and a tuple psum
        # lowers to a single variadic AllReduce — measured ~25 µs/iter
        # saved at n=2 on the virtual CPU mesh, and one ICI launch
        # instead of three on real chips.
        return jax.lax.psum((H, g, c), axis)

    @partial(_shard_map, mesh=mesh,
             in_specs=(x_spec, data_spec), out_specs=P())
    def _evaluate_sm(x, data):
        def one(bd):
            r = flatten_residuals(block_fn(x, bd)).astype(spec.dtype)
            return jnp.vdot(r, r)
        return jax.lax.psum(jnp.sum(jax.vmap(one)(data)), axis)

    def accumulate(x, data=data):
        H, g, c = _accumulate_sm(x, data)
        return H, g, Cost.make(c, n_res)

    def evaluate(x, data=data):
        return Cost.make(_evaluate_sm(x, data), n_res)

    return accumulate, evaluate, n_res


def sharded_optimize(x0, block_fn: Callable, data,
                     options: Options | None = None, *,
                     mesh: Mesh | None = None, axis: str = "block"):
    """Solve one large blocked NLLS problem sharded over the mesh.

    Returns ``(x_opt, Output)``.  The data should be placed with
    ``NamedSharding(mesh, P(axis))`` on its leading axis (done here if it
    isn't yet).
    """
    options = options or Options()
    if mesh is None:
        from .mesh import local_mesh
        mesh = local_mesh(axis)
    x0 = mf.as_pytree(x0)
    sharding = NamedSharding(mesh, P(axis))
    already_global = any(
        getattr(l, "sharding", None) is not None
        and not getattr(l, "is_fully_addressable", True)
        for l in jax.tree_util.tree_leaves(data))
    if not already_global:
        data = jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a), sharding), data)
    spec = mf.tangent_spec(x0)
    acc, ev, n_res = make_block_system(block_fn, data, x0, mesh, axis, spec)

    # ``data`` rides as a jit ARGUMENT: a multi-process mesh's global
    # arrays span non-addressable devices and cannot be closed over.
    def solve(x, d):
        return optimize_from_acc(x, lambda xv: acc(xv, d),
                                 lambda xv: ev(xv, d), options, spec)

    return jax.jit(solve)(x0, data)
