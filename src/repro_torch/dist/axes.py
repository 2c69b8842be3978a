"""Named logical axes over the physical mesh, a port of ``repro.dist.axes``.

Model code never names physical mesh axes: it constrains activations along
*logical* axes ("dp" for the batch dims, "tp" for tensor-parallel dims)
and this module resolves them against whatever mesh is active. The active
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
entered with ``use_mesh(mesh)``. Resolution is scoped: the launcher can
retarget "dp" (e.g. ``parallelism="dp_only"`` maps the whole mesh onto the
batch) with ``set_dp_axes``, either as a plain call or as a context
manager that restores the previous mapping on exit.

``constrain`` is the identity when no mesh is active, and on a plain
tensor; on a DTensor it redistributes to the placements its logical axes
resolve to, as ``with_sharding_constraint`` does in the reference.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

# Logical axis -> physical mesh axes it may map onto (filtered to the axes
# actually present on the active mesh). "dp" can be rescoped via
# ``set_dp_axes``; the rest are fixed vocabulary.
_DEFAULT_LOGICAL = {
    "dp": ("pod", "data"),       # data parallelism (batch dims)
    "tp": ("model",),            # tensor parallelism (feature/head dims)
    "ep": ("data", "model"),     # full expert parallelism (moe_full_ep)
}

_dp_override: Optional[Tuple[str, ...]] = None
_mesh_stack: List = []


class _DpScope:
    """Token returned by ``set_dp_axes``; optionally used as a context
    manager to restore the previous mapping."""

    def __init__(self, prev: Optional[Tuple[str, ...]]):
        self._prev = prev

    def __enter__(self) -> "_DpScope":
        return self

    def __exit__(self, *exc) -> bool:
        global _dp_override
        _dp_override = self._prev
        return False


def set_dp_axes(axes: Optional[Sequence[str]]) -> _DpScope:
    """Retarget the "dp" logical axis to ``axes`` (``None`` restores the
    default ("pod", "data") mapping). Returns a scope token usable as a
    context manager."""
    global _dp_override
    prev = _dp_override
    _dp_override = tuple(axes) if axes is not None else None
    return _DpScope(prev)


def dp_axes() -> Tuple[str, ...]:
    return _dp_override if _dp_override is not None \
        else _DEFAULT_LOGICAL["dp"]


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``) the active
    mesh inside the ``with`` block, as ``with mesh:`` does in the
    reference. Inside it a plain tensor that meets a DTensor in an op (a
    position table, a mask, a constant) counts as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    if not mesh.mesh_dim_names:
        raise ValueError("use_mesh: the mesh needs named dims")
    _mesh_stack.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _mesh_stack.pop()


def active_mesh():
    """The ``DeviceMesh`` of the innermost ``use_mesh`` scope, or
    ``None``."""
    return _mesh_stack[-1] if _mesh_stack else None


def current_mesh_axes() -> Tuple[str, ...]:
    """Axis names of the active mesh; ``()`` when no mesh is active."""
    m = active_mesh()
    return tuple(m.mesh_dim_names) if m is not None else ()


def mesh_extent(mesh, axes: Sequence[str]) -> int:
    """Product of the sizes of ``axes`` on ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    return n


def _resolve(logical: Optional[str],
             mesh_axes: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
    """Logical name -> tuple of physical axes present on the (active) mesh.

    Unknown names pass through as a physical axis name, so callers may mix
    vocabularies ("dp" and "data" both work).
    """
    if logical is None:
        return ()
    if mesh_axes is None:
        mesh_axes = current_mesh_axes()
    if logical == "dp":
        phys = dp_axes()
    else:
        phys = _DEFAULT_LOGICAL.get(logical, (logical,))
    return tuple(a for a in phys if a in mesh_axes)


def placements(spec: Sequence, mesh) -> list:
    """A ``PartitionSpec``-like tuple (one entry per tensor dim: ``None``,
    an axis name or a tuple of names) -> one DTensor placement per mesh
    dim: ``Shard(d)`` on each mesh dim that tensor dim ``d`` names, else
    ``Replicate()``. A tuple entry shards its dim over its axes in order,
    major first, as a ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(a)] = Shard(dim)
    return out


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor along logical axes when a mesh is active;
    identity otherwise (and on a plain tensor).

    One logical name (or ``None``) per tensor dim. A dim is left unsharded
    when its logical axis resolves to nothing on the mesh or its size does
    not divide by the resolved axes' total extent, so the same model code
    is valid on every mesh (including none).
    """
    m = active_mesh()
    if m is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"constrain: {len(logical_axes)} logical axes for rank-{x.ndim} "
            f"tensor {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh_axes = tuple(m.mesh_dim_names)
    entries = []
    for dim, name in zip(x.shape, logical_axes):
        phys = _resolve(name, mesh_axes)
        extent = mesh_extent(m, phys)
        if not phys or extent <= 1 or dim % extent != 0:
            entries.append(None)
        else:
            entries.append(phys[0] if len(phys) == 1 else phys)
    want = placements(entries, m)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(m, want)
