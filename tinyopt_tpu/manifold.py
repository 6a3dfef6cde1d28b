"""Parameters-as-pytrees with a manifold (retraction) registry.

This is the JAX re-design of the reference's ``params_trait`` system
(reference: include/tinyopt/traits.h:103-349), which provides per-type
``Dims`` (tangent dimension), ``cast`` (scalar promotion for Jets) and
``PlusEq`` (the retraction x ⊞ δ).

In JAX, parameters are pytrees, tracers flow through them natively (no cast
needed), and the retraction is a pure function.  Any pytree of arrays is a
valid parameter block: arrays are Euclidean leaves (tangent dim = size,
retraction = flattened addition, column-major-agnostic since JAX arrays are
dense); custom manifold types (e.g. SO3/SE3, see ``tinyopt_tpu.manifolds``)
register a ``Manifold`` implementation here and are treated as atomic
leaves whose tangent dimension differs from their ambient parameter count.

The tangent vector layout concatenates leaf tangents in pytree order —
the equivalent of the reference's pair/vector/array trait concatenation
(traits.h:217-349).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Manifold(NamedTuple):
    """Retraction + tangent-dimension spec for one registered type.

    dims(x) -> int                   static tangent dimension of the leaf
    retract(x, delta) -> x'          x ⊞ delta, delta has shape (dims,)
    local(x, y) -> delta (optional)  y ⊟ x, used by numerical differencing
    """

    dims: Callable[[Any], int]
    retract: Callable[[Any, jax.Array], Any]
    local: Callable[[Any, Any], jax.Array] | None = None


_REGISTRY: dict[type, Manifold] = {}


def register_manifold(cls: type, manifold: Manifold) -> None:
    """Register a manifold implementation for a (pytree-registered) type."""
    _REGISTRY[cls] = manifold


def manifold_for(x) -> Manifold | None:
    return _REGISTRY.get(type(x))


def _is_manifold_leaf(x) -> bool:
    return type(x) in _REGISTRY


def _leaf_dims(leaf) -> int:
    m = manifold_for(leaf)
    if m is not None:
        return int(m.dims(leaf))
    return int(np.size(leaf))


class TangentSpec(NamedTuple):
    """Static description of a parameter pytree's tangent space."""

    treedef: Any
    leaf_dims: tuple          # per-leaf tangent dimension
    offsets: tuple            # per-leaf offset into the flat tangent vector
    dims: int                 # total tangent dimension
    dtype: Any                # tangent dtype (promoted over leaves)


def _leaves(x):
    return jax.tree_util.tree_flatten(x, is_leaf=_is_manifold_leaf)


def tangent_spec(x) -> TangentSpec:
    """Compute the (static) tangent-space layout of parameter pytree ``x``."""
    leaves, treedef = _leaves(x)
    dims = tuple(_leaf_dims(l) for l in leaves)
    offsets = tuple(int(o) for o in np.cumsum((0,) + dims[:-1]))
    dtypes = []
    for l in leaves:
        subs = [jnp.asarray(a).dtype for a in jax.tree_util.tree_leaves(l)]
        if manifold_for(l) is not None:
            # a manifold leaf may carry structural integer sub-leaves
            # (e.g. a BCOO's indices) — only its floating storage
            # defines the tangent dtype
            subs = ([d for d in subs if jnp.issubdtype(d, jnp.floating)]
                    or subs)
        dtypes.extend(subs)
    dtype = jnp.result_type(*dtypes) if dtypes else jnp.float32
    total = int(sum(dims))
    if total > 0 and not jnp.issubdtype(dtype, jnp.floating):
        raise ValueError(
            f"parameters must be floating point, got dtype {dtype}; "
            "cast your initial values (e.g. jnp.asarray(x, jnp.float32)) — "
            "integer tangents cannot be differentiated")
    return TangentSpec(treedef, dims, offsets, total, dtype)


def retract(x, delta: jax.Array, spec: TangentSpec | None = None):
    """Manifold retraction ``x ⊞ delta`` over a full parameter pytree.

    ``delta`` is the flat tangent vector (shape ``(dims,)``).  Euclidean
    leaves get ``leaf + slice.reshape(leaf.shape)``; registered manifolds
    dispatch to their ``retract``.  This is the JAX equivalent of the
    reference's per-type ``PlusEq`` (traits.h:166-191, 310-349).
    """
    if spec is None:
        spec = tangent_spec(x)
    leaves, treedef = _leaves(x)
    new_leaves = []
    for leaf, d, off in zip(leaves, spec.leaf_dims, spec.offsets):
        sl = delta[off:off + d]
        m = manifold_for(leaf)
        if m is not None:
            new_leaves.append(m.retract(leaf, sl))
        else:
            arr = jnp.asarray(leaf)
            new_leaves.append((arr + sl.reshape(arr.shape).astype(arr.dtype)))
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def local(x, y, spec: TangentSpec | None = None) -> jax.Array:
    """Inverse retraction ``y ⊟ x`` as a flat tangent vector."""
    if spec is None:
        spec = tangent_spec(x)
    xl, xdef = _leaves(x)
    yl, ydef = _leaves(y)
    if xdef != ydef:
        raise ValueError(
            f"local(x, y): mismatched pytree structures {xdef} vs {ydef}")
    parts = []
    for lx, ly in zip(xl, yl):
        m = manifold_for(lx)
        if m is not None:
            if m.local is None:
                raise NotImplementedError(
                    f"Manifold for {type(lx).__name__} has no local() map")
            parts.append(jnp.ravel(m.local(lx, ly)))
        else:
            parts.append(jnp.ravel(jnp.asarray(ly) - jnp.asarray(lx)))
    if not parts:
        return jnp.zeros((0,), spec.dtype)
    return jnp.concatenate([p.astype(spec.dtype) for p in parts])


def zero_tangent(x, spec: TangentSpec | None = None) -> jax.Array:
    if spec is None:
        spec = tangent_spec(x)
    return jnp.zeros((spec.dims,), spec.dtype)


def as_pytree(x):
    """Canonicalize user input: Python scalars/lists -> jnp arrays.

    Python ints are promoted to floats (an integer starting point is
    clearly meant as a real-valued parameter; integer ARRAYS are left
    alone and rejected by ``tangent_spec`` with a clear error).
    """
    def conv(v):
        if _is_manifold_leaf(v):
            return v
        if isinstance(v, int) and not isinstance(v, bool):
            return jnp.asarray(float(v))
        return jnp.asarray(v)
    return jax.tree_util.tree_map(conv, x, is_leaf=_is_manifold_leaf)


def element_perm(x_batched, n: int) -> np.ndarray | None:
    """Index map from the ELEMENT-MAJOR flat tangent of a leading-axis
    batched pytree (element 0's full tangent, then element 1's, …) to
    the global leaf-major layout of ``tangent_spec(x_batched)``.

    Returns ``em2gl`` with ``t_global = t_elem_major[em2gl]`` — or
    ``None`` when the two layouts coincide (single-leaf pytrees: a
    batched SE3 array, a plain (n, d) array — the common case).

    Why: bipartite (Schur) systems do their algebra element-major (each
    camera's tangent block contiguous), while the loop retraction uses
    the leaf-major global layout; with a multi-leaf per-element pytree
    (e.g. BAL cameras {"pose": SE3, "intr": (3,)}) the two differ, and
    the Schur builders adapt at their boundary with this permutation.
    """
    leaves, _ = _leaves(x_batched)
    if len(leaves) <= 1:
        return None
    d_tot = [_leaf_dims(l) for l in leaves]
    d_el = [d // n for d in d_tot]
    if any(d != de * n for d, de in zip(d_tot, d_el)):
        raise ValueError(
            f"batched pytree leaf tangent dims {d_tot} not divisible by "
            f"the batch size {n}")
    da = sum(d_el)
    goff = np.cumsum([0] + [n * de for de in d_el])[:-1]
    eoff = np.cumsum([0] + d_el[:-1])
    em2gl = np.empty(n * da, np.int64)
    i = np.arange(n)[:, None]
    for l, de in enumerate(d_el):
        c = np.arange(de)[None, :]
        em2gl[(goff[l] + i * de + c).reshape(-1)] = \
            (i * da + eoff[l] + c).reshape(-1)
    return em2gl


def flatten_values(x) -> jax.Array:
    """Flatten the *values* (not tangents) of a pytree into one vector."""
    arrs = [jnp.ravel(jnp.asarray(a)) for a in jax.tree_util.tree_leaves(x)]
    if not arrs:
        return jnp.zeros((0,))
    return jnp.concatenate(arrs)


def _register_sparse_params() -> None:
    """Sparse-matrix parameter blocks: the ``params_trait<SparseMatrix>``
    analogue (reference: include/tinyopt/traits.h:193-215, which exposes
    a sparse matrix's STORED VALUES as the optimized parameters).

    A ``jax.experimental.sparse.BCOO`` leaf becomes a valid parameter
    block whose tangent is its ``data`` vector; the sparsity pattern
    (``indices``) is structural and frozen — exactly the reference's
    contract (it iterates stored values, never re-patterns).  AD flows
    through sparse ops natively (jvp rules on BCOO matmul etc.), so a
    residual like ``(M @ v - target)`` differentiates with respect to
    the stored values only.
    """
    try:
        from jax.experimental import sparse as jsparse
    except Exception:  # pragma: no cover - sparse is part of jax
        return

    def _dims(m) -> int:
        return int(np.prod(m.data.shape, dtype=int))

    def _retract(m, delta):
        data = m.data + delta.reshape(m.data.shape).astype(m.data.dtype)
        return jsparse.BCOO((data, m.indices), shape=m.shape,
                            indices_sorted=m.indices_sorted,
                            unique_indices=m.unique_indices)

    def _local(x, y):
        return jnp.ravel(y.data - x.data)

    register_manifold(jsparse.BCOO,
                      Manifold(dims=_dims, retract=_retract, local=_local))


_register_sparse_params()
