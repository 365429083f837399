"""Differentiable collectives over the named axes of a mesh, on local
tensors (the counterpart of ``jax.lax``'s collectives inside
``shard_map``).

Every function takes ``mesh`` (a ``DeviceMesh``) and mesh axes, by name or
index, and always calls the process group's collective, one mesh axis at a
time, also on a group of one process.  Each is a ``torch.autograd.Function``
whose backward is the forward's exact adjoint over the processes:

* ``all_gather`` concatenates along a dimension; backward reduce-scatters
  (sums) the gradient back to the shards;
* ``all_to_all`` exchanges equal chunks of dim 0; backward exchanges the
  gradient's chunks back;
* ``all_reduce`` sums; backward sums the gradients.

So when every process differentiates its own loss, each local tensor's
gradient is that of the sum of all the processes' losses.

``merge_partials`` combines attention outputs computed over blocks of a
split KV cache (the decode kernel's output and log-sum-exp on each
process) into the output over the whole cache.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Axis = Union[str, int]

# torch 2.13 renames the two flat collectives (same arguments)
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_flat(out, x, group=group)
    # (n, ..., s_dim, ...) -> (..., n * s_dim, ...), contiguous
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    chunks = torch.stack(g.chunk(n, dim=dim))
    out = g.new_empty(chunks.shape[1:])
    _reduce_scatter_flat(out, chunks.reshape((-1,) + tuple(out.shape[1:])),
                         op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_gather(x: torch.Tensor, dim: int, mesh, axes: Sequence[Axis]
               ) -> torch.Tensor:
    """Concatenate ``x`` along ``dim`` over ``axes`` (listed major to minor,
    as a spec lists them): the minor axis is gathered first."""
    for a in reversed(tuple(axes)):
        x = _AllGather.apply(x, dim, mesh.get_group(a))
    return x


def all_to_all(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """Chunk ``i`` of ``x``'s dim 0 goes to process ``i`` of ``axis``; the
    result's chunk ``j`` came from process ``j`` (``tiled`` all_to_all)."""
    return _AllToAll.apply(x, mesh.get_group(axis))


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[Axis]) -> torch.Tensor:
    """Sum of ``x`` over the processes of ``axes``."""
    for a in axes:
        x = _AllReduce.apply(x, mesh.get_group(a))
    return x


def axis_index(mesh, axes: Sequence[Axis]) -> int:
    """This process's linear index over ``axes`` (major to minor), as
    ``jax.lax.axis_index`` over a tuple of axes."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        i = names.index(a) if isinstance(a, str) else a
        idx = idx * mesh.size(i) + coord[i]
    return idx


def shard_of(x: torch.Tensor, dim: int, mesh, axes: Sequence[Axis]
             ) -> torch.Tensor:
    """This process's block of ``x`` along ``dim`` split over ``axes`` (a
    view: no communication; its backward pads with zeros)."""
    n = 1
    for a in axes:
        n *= mesh.get_group(a).size()
    step = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * step, step)


def make_whole(local: torch.Tensor, placements, mesh) -> torch.Tensor:
    """A DTensor's whole value from its local shard and ``placements``:
    gathered over every mesh dimension that shards it, the minor
    dimension first."""
    for i in reversed(range(len(placements))):
        if placements[i].is_shard():
            local = _AllGather.apply(local, placements[i].dim,
                                     mesh.get_group(i))
    return local


def sum_replicated(g: torch.Tensor, placements, mesh) -> torch.Tensor:
    """``g`` (a leaf's local gradient, contiguous) summed in place over the
    mesh dims whose placement replicates the leaf: there each process
    holds its own copy's gradient, which the gathers' reduce-scatters
    (over the dims that shard it) have not added."""
    for i, p in enumerate(placements):
        if p.is_replicate():
            dist.all_reduce(g, group=mesh.get_group(i))
    return g


def combine_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention output over every block from each block's output
    ``outs`` (n, ..., D) and log-sum-exp ``lses`` (n, ...): weights
    w_r = exp(lse_r - max lse), out = sum_r w_r out_r / sum_r w_r, in f32,
    summed in block order; cast to ``outs``' dtype.  A block of no key
    (lse -1e30) weighs nothing."""
    w = torch.exp(lses - lses.amax(dim=0))[..., None]
    acc = w[0] * outs[0].float()
    for r in range(1, outs.shape[0]):
        acc = acc + w[r] * outs[r].float()
    return (acc / w.sum(dim=0)).to(outs.dtype)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, mesh,
                   axes: Sequence[Axis]) -> torch.Tensor:
    """Each process's attention output ``out`` (..., D) over its block of
    the cache and its f32 log-sum-exp ``lse`` (...), gathered over
    ``axes`` and combined in rank order (:func:`combine_partials`), so the
    result is the same on every process and bitwise equal from run to
    run.  On a group of one it is ``out`` itself."""
    outs = all_gather(out[None], 0, mesh, axes)
    if outs.shape[0] == 1:
        return out
    return combine_partials(outs, all_gather(lse[None], 0, mesh, axes))
