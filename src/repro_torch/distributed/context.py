"""Logical-axis sharding context (port of ``repro/distributed/context.py``).

Model code annotates tensors with *logical* axis names
(``hint(x, 'batch', 'qseq', 'heads', None)``); a distributed context maps
logical names to mesh axes per architecture and shape cell.  Outside a
context every hint is a no-op, so the same model code runs on one device
and under a mesh unchanged.

A sharding is a :class:`PartitionSpec`, as in JAX: one entry per tensor
dimension, ``None`` (replicated), a mesh axis name, or a tuple of names
(sharded over their product, major to minor).  :func:`placements` turns
it into DTensor placements, one per mesh dimension.

The mesh is anything with ``axis_names`` and ``devices.shape`` for the
rules (:class:`Mesh`, which ``launch/mesh.py``'s ``make_mesh`` builds, or
:class:`ShapeMesh`, a shape alone); collectives and ``hint`` need a
``Mesh``, which also holds the ``DeviceMesh``.
``ShardCtx.row_axes`` names the mesh axes over which the activations'
rows are already split on this process (the sharded train step splits
the batch); empty, every process holds the whole batch, as the
reference's global arrays do.

``ShardCtx.tp`` marks the sharded train step's context, in which the
parameters the rules split over 'model' reach the model as this
process's shards.  There the model asks :func:`tp_split` where the
reference writes ``hint(x, ..., name, ...)``: whether the rules map the
logical ``name`` to 'model' and 'model' divides the dimension (``hint``'s
guard), and if so the axis, its size and this process's index; it then
computes its block of that dimension and joins the blocks with the
collectives of ``collectives.py``.  Anywhere else ``tp_split`` is None
and the model computes whole.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

Axes = Union[None, str, Tuple[str, ...]]
TP = "model"    # the tensor-parallel mesh axis (``sharding.TP``)

_tls = threading.local()


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: a tuple of ``None | str | tuple[str, ...]``,
    one entry per tensor dimension."""

    def __new__(cls, *axes: Axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


class Mesh:
    """A ``DeviceMesh`` with the reference's names: ``axis_names``, and
    ``devices``, the array of ranks in the mesh's shape."""

    def __init__(self, device_mesh: DeviceMesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.devices = device_mesh.mesh.cpu().numpy()


class ShapeMesh:
    """A mesh's shape alone, for the rules and ``elastic.plan``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.axis_names = tuple(axes)
        self.devices = np.empty(tuple(shape), dtype=object)


def placements(spec: PartitionSpec, mesh) -> List[Placement]:
    """DTensor placements (one per mesh dimension) of ``spec`` on ``mesh``:
    ``Shard(d)`` on each mesh axis that dimension ``d`` names, ``Replicate()``
    on the others.  DTensor nests the shards of one dimension in mesh-dim
    order, which is JAX's major-to-minor order only while the spec lists
    the axes in mesh order: raises otherwise.  The spec must come from the
    rules, which replicate a dimension that does not divide (DTensor
    would shard it unevenly)."""
    names = tuple(mesh.axis_names)
    out: List[Placement] = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        idx = [names.index(a) for a in ((ax,) if isinstance(ax, str) else ax)]
        if idx != sorted(set(idx)):
            raise ValueError(f"{spec}: dimension {d} lists mesh axes {ax} "
                             f"out of the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} shards two "
                                 "dimensions")
            out[i] = Shard(d)
    return out


def current() -> Optional["ShardCtx"]:
    return getattr(_tls, "ctx", None)


class Split(NamedTuple):
    """One dimension split over the 'model' axis: the ``DeviceMesh``, the
    axes for ``collectives.py`` (``("model",)``), their process count
    ``n`` and this process's ``index``, whose block of a dimension of
    ``dim`` starts at ``index * dim // n``."""
    mesh: DeviceMesh
    axes: Tuple[str, ...]
    n: int
    index: int

    def block(self, dim: int) -> Tuple[int, int]:
        """(start, length) of this process's block of ``dim``."""
        size = dim // self.n
        return self.index * size, size


class ShardCtx:
    def __init__(self, mesh, rules: Dict[str, Axes],
                 row_axes: Tuple[str, ...] = (), tp: bool = False):
        self.mesh = mesh
        self.rules = dict(rules)
        self.row_axes = tuple(row_axes)
        self.tp = tp

    def splits(self, name: str) -> bool:
        """Whether the rules map the logical ``name`` to 'model' alone."""
        return self.rules.get(name) in (TP, (TP,))

    def tp_split(self, name: str, dim: int) -> Optional[Split]:
        """The split of a dimension of ``dim`` that the reference hints as
        ``name``, in the sharded train step's context (``tp``) where the
        rules map ``name`` to 'model' and 'model' divides ``dim``; else
        None (the dimension is whole on every process)."""
        if not (self.tp and self.splits(name)) \
                or TP not in self.mesh.axis_names:
            return None
        dm = self.mesh.device_mesh
        i = self.mesh.axis_names.index(TP)
        n = dm.size(i)
        if dim % n:
            return None
        return Split(dm, (TP,), n, int(dm.get_coordinate()[i]))

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        axes = []
        used = set()
        for name in logical:
            if name is None:
                axes.append(None)
                continue
            mapped = self.rules.get(name)
            if mapped is None:
                axes.append(None)
                continue
            if isinstance(mapped, str):
                mapped = (mapped,)
            fresh = tuple(a for a in mapped if a not in used)
            used.update(fresh)
            axes.append(fresh if len(fresh) > 1 else
                        (fresh[0] if fresh else None))
        return P(*axes)


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardCtx]):
    """Make ``ctx`` (or no context) current inside the block.  Code that
    autograd may rerun on another thread (a checkpointed region's
    recompute runs on the device's backward thread) enters the context
    its forward saw."""
    prev = current()
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def use_rules(mesh, rules: Dict[str, Axes], row_axes: Tuple[str, ...] = ()):
    return use_ctx(ShardCtx(mesh, rules, row_axes))


def tp_split(name: str, dim: int) -> Optional[Split]:
    """The current context's :meth:`ShardCtx.tp_split`; None outside a
    context."""
    ctx = current()
    return None if ctx is None else ctx.tp_split(name, dim)


def hint(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Re-place a DTensor per the rules when a context is active; any other
    tensor, or no context, passes through unchanged.  Logical dims that
    don't divide evenly fall back to replicated for that dim."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = list(ctx.spec(*logical))
    # divisibility guard per dim
    sizes = dict(zip(ctx.mesh.axis_names, ctx.mesh.devices.shape))
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        names = (ax,) if isinstance(ax, str) else ax
        k = 1
        for nm in names:
            k *= sizes[nm]
        if x.shape[i] % k != 0:
            spec[i] = None
    return x.redistribute(ctx.mesh.device_mesh,
                          placements(P(*spec), ctx.mesh))
