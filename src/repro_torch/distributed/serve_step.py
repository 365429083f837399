"""Sharded serving: prefill and one decode step on a mesh, each process
computing on its local shards (the serving counterpart of the train
step's ``_sharded_grad``).

The parameters are DTensors placed by ``sharding.param_placements`` and
the cache DTensors placed by ``sharding.cache_specs``.  The step runs under the
current sharding context's rules (a prefill's or a decode's,
``sharding.logical_rules``; without a context, those of a prefill or a
decode of the inputs' sizes) in a serving context (``ShardCtx.serve``):

* the rows of the whole batch split over the fsdp axes as
  ``batch_specs`` places them, the same on the 'model' processes;
* each period's leaves gathered over the fsdp axes just in time, the
  'model' shards kept where the model splits their dimension
  (``gather.gatherer``): heads (or, in prefill, query rows), d_ff, the
  vocabulary, Mamba's inner channels, the experts through
  ``moe_sharded``;
* prefill returns its K/V in the decode layout (every KV head, this
  process's block of positions over 'model'), as the reference pins the
  cache prefill returns to the decode sharding of the same length;
* decode writes its token's K/V on the process that holds ``pos``, runs
  the decode kernel over each process's block of the cache (``kv_seq``,
  read from the cache's own placement) and merges the blocks' partials.

Both run under ``torch.no_grad()``.  They return the logits of this
process's rows, whole over the vocabulary, as a DTensor placed over the
rows, and the cache as DTensors in the decode layout.  On a mesh of one
process every collective still runs, and the results are the meshless
``prefill``'s and ``decode_step``'s bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import ArchConfig, Shape
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import (Mesh, P, ShardCtx, current,
                                            placements, use_ctx)
from repro_torch.distributed.gather import gatherer
from repro_torch.models import transformer
from repro_torch.models.transformer import tree_leaves, tree_map

# a cache leaf's dimension of positions (attention) or channels (Mamba's
# ssm): the period axis first, then the rows
_SEQ_DIM, _CHANNEL_DIM = 2, 2


def _split_tree(tree):
    """(local shards, placements) of a tree of DTensors."""
    return (tree_map(lambda x: x.to_local(), tree),
            tree_map(lambda x: tuple(x.placements), tree))


def _mesh_of(params, ctx) -> Mesh:
    if ctx is not None:
        return ctx.mesh
    return Mesh(tree_leaves(params)[0].device_mesh)


def _axes_of(pl, dim: int, names) -> Optional[Tuple[str, ...]]:
    """The mesh axes (in mesh order) whose placement shards ``dim``."""
    axes = tuple(names[i] for i, p in enumerate(pl) if p.is_shard(dim))
    return axes or None


def _rows(batch: Dict[str, torch.Tensor], cfg: ArchConfig, mesh,
          shape: Shape):
    """(row axes, this process's rows of the batch) as ``batch_specs``
    places them: a DTensor leaf so placed gives its local rows, a tensor
    is the whole batch."""
    spec = shd.batch_specs(cfg, shape, mesh)
    axes = spec[next(iter(spec))][0]
    axes = () if axes is None else ((axes,) if isinstance(axes, str)
                                    else tuple(axes))
    dm = mesh.device_mesh
    return axes, {k: x.to_local() if isinstance(x, DTensor)
                  else col.shard_of(x, 0, dm, axes) for k, x in batch.items()}


def _rows_dtensor(x: torch.Tensor, mesh, axes) -> DTensor:
    spec = P(axes if axes else None, *([None] * (x.dim() - 1)))
    return DTensor.from_local(x, mesh.device_mesh, placements(spec, mesh),
                              run_check=False)


def _context(cfg: ArchConfig, mesh, shape: Shape, row_axes, cache_place):
    """The serving context: the current rules (else ``shape``'s), with
    ``kv_seq`` and Mamba's ``inner`` read from the cache's placements
    where a cache is given."""
    ctx = current()
    rules = dict(ctx.rules if ctx is not None
                 else shd.logical_rules(cfg, shape, mesh))
    if cache_place is not None:
        names = mesh.axis_names
        for i, (mixer, _) in enumerate(cfg.block_pattern):
            pl = cache_place[f"slot{i}"]
            if mixer == "attn":
                rules["kv_seq"] = _axes_of(pl["k"], _SEQ_DIM, names)
            elif mixer == "mamba":
                rules["inner"] = _axes_of(pl["ssm"], _CHANNEL_DIM, names)
    return ShardCtx(mesh, rules, row_axes, serve=True)


def sharded_prefill(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """``transformer.prefill`` on a mesh: (logits of this process's rows as
    a DTensor over the rows, the cache as DTensors placed by
    ``cache_specs`` of a decode of the prompt's length).  ``batch``: the
    whole batch, or DTensors placed by ``batch_specs``."""
    ctx = current()
    mesh = _mesh_of(params, ctx)
    local, p_place = _split_tree(params)
    first = next(iter(batch.values()))
    b, s = first.shape[0], first.shape[1]
    shape = Shape("prefill", "prefill", s, b)
    row_axes, mine = _rows(batch, cfg, mesh, shape)
    step_ctx = _context(cfg, mesh, shape, row_axes, None)
    with torch.no_grad(), use_ctx(step_ctx):
        logits, cache = transformer.prefill(local, mine, cfg,
                                            gather=gatherer(cfg, p_place,
                                                            step_ctx))
    logits = _rows_dtensor(logits, mesh, row_axes)
    if not cache:
        return logits, cache
    c_place = shd.map2(lambda _, sp: placements(sp, mesh), cache,
                       shd.cache_specs(cfg, Shape("cache", "decode", s, b),
                                       mesh))
    return logits, shd.map2(lambda x, pl: DTensor.from_local(
        x, mesh.device_mesh, pl, run_check=False), cache, c_place)


def sharded_decode_step(params, cache, tokens: torch.Tensor, pos: int,
                        cfg: ArchConfig):
    """``transformer.decode_step`` on a mesh: (logits of this process's
    rows as a DTensor over the rows, the cache).  ``tokens`` (B, 1) is the
    whole batch, or a DTensor placed by ``batch_specs``; ``pos`` a host
    int; the cache is written in place."""
    ctx = current()
    mesh = _mesh_of(params, ctx)
    local, p_place = _split_tree(params)
    c_local, c_place = _split_tree(cache)
    # the rules' and the rows' decode shape (its length matters to neither)
    shape = Shape("decode", "decode", 0, tokens.shape[0])
    row_axes, mine = _rows({"tokens": tokens}, cfg, mesh, shape)
    step_ctx = _context(cfg, mesh, shape, row_axes, c_place)
    with torch.no_grad(), use_ctx(step_ctx):
        logits, c_local = transformer.decode_step(
            local, c_local, mine["tokens"], pos, cfg,
            gather=gatherer(cfg, p_place, step_ctx))
    return _rows_dtensor(logits, mesh, row_axes), cache
