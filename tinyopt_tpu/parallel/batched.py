"""Batched instances: vmap over problems, sharded over a mesh axis.

The whole accept/reject LM loop is vmapped — every instance carries its
own λ schedule, stop reason and history — and the instance axis is laid
out over the mesh, so each device runs its share of thousands of
independent solves with no cross-instance communication.  No reference
counterpart (the reference solves one instance at a time).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..optimize import build_solver
from ..options import Options


def batched_solver(fn: Callable, options: Options, mode: str, x_example,
                   data_example=None) -> Callable:
    """vmapped solve: (x_batch[, data_batch]) -> (x_opt_batch, Output_batch).

    ``fn`` is a residual/cost/acc function of one instance; when
    ``data_example`` is given, ``fn(x, data)`` receives per-instance data
    (e.g. observations) and both arguments are vmapped.
    """
    if data_example is None:
        solve1 = build_solver(fn, options, mode, x_example)
        return jax.vmap(solve1)

    def solve1(x, data):
        return build_solver(lambda x_: fn(x_, data), options, mode, x)(x)

    return jax.vmap(solve1)


def batched_optimize(x0_batch, fn: Callable, options: Options | None = None,
                     *, data_batch=None, mode: str = "auto",
                     mesh: Mesh | None = None, axis: str = "batch"):
    """Solve a batch of independent instances, optionally mesh-sharded.

    ``x0_batch`` (and each leaf of ``data_batch``) has a leading instance
    axis.  With ``mesh``, inputs are placed with ``NamedSharding(mesh,
    P(axis))`` and the solve runs under ``shard_map``: each device solves
    its own slice of the batch, so kernels inside the solve (the batched
    CG, ops/pallas_cg.py) see the local batch and need no partitioning
    rule.
    """
    options = options or Options()
    x_example = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[0], x0_batch)
    data_example = None
    if data_batch is not None:
        data_example = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[0],
                                              data_batch)
    solve = batched_solver(fn, options, mode, x_example, data_example)

    if mesh is not None:
        from .sharded import _shard_map
        spec = P(axis)
        in_specs = (spec,) if data_batch is None else (spec, spec)
        solve = _shard_map(solve, mesh=mesh, in_specs=in_specs,
                           out_specs=spec)
        sharding = NamedSharding(mesh, P(axis))
        x0_batch = jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a), sharding), x0_batch)
        if data_batch is not None:
            data_batch = jax.tree_util.tree_map(
                lambda a: jax.device_put(jnp.asarray(a), sharding),
                data_batch)

    solve = jax.jit(solve)
    if data_batch is None:
        return solve(x0_batch)
    return solve(x0_batch, data_batch)
