"""Device-mesh construction helpers.

The scale-out axes of this framework (SURVEY.md §2.3 — new capability, no
reference counterpart): ``batch`` shards problem *instances* (data parallel)
and ``block`` shards residual blocks *within* an instance (the domain's
sequence-parallel analogue), with (JᵀJ, JᵀR) contributions psum-reduced
over ICI.

For multi-host pods, call ``jax.distributed.initialize()`` before building
the mesh; ``make_mesh`` lays the batch axis across hosts (DCN) and the
block axis within hosts (ICI) so the per-iteration psum rides ICI.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(batch: int | None = None, block: int = 1,
              devices=None, axis_names=("batch", "block")) -> Mesh:
    """Build a 2-D (batch, block) mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if batch is None:
        batch = n // block
    if batch * block != n:
        raise ValueError(f"mesh {batch}x{block} != {n} devices")
    arr = np.asarray(devices).reshape(batch, block)
    return Mesh(arr, axis_names)


def local_mesh(axis_name: str = "batch") -> Mesh:
    """1-D mesh over every addressable device."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def init_distributed(**kwargs) -> None:
    """Initialize multi-host JAX (a no-op if already initialized).

    Call once per process on a multi-host pod before building meshes;
    after this, ``jax.devices()`` spans all hosts, ``make_mesh`` lays the
    batch axis across hosts (DCN) and the block axis within hosts (ICI).
    Args are forwarded to ``jax.distributed.initialize`` (coordinator
    address, num_processes, process_id; a GPU host needs all three).
    """
    import jax

    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
