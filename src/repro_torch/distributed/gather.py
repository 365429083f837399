"""Just-in-time gathers of a step's local parameter shards (the sharded
train step's and the sharded serving step's).

A step holds each parameter as its local shard, placed by
``sharding.param_placements``.  :func:`gatherer` returns the function the
model calls on a subtree just before it uses it (the top-level leaves
once, each period's slot leaves in turn): each leaf made whole by an
all-gather over the mesh dims that shard it (``collectives.make_whole``,
differentiable), except

* over 'model' for a leaf whose kind ``TP_LEAVES`` names and whose
  logical name the context's rules map to 'model' (the model computes on
  that shard, ``context.tp_split``), and in the serving context for every
  attention leaf (a decode projects its heads on the leaves' 'model'
  shards, as ``param_specs`` places them, whatever the rules say of
  ``heads``);
* an MoE feed-forward's leaves, which stay DTensors (their shards) for
  ``moe.apply_moe``'s expert-parallel paths.

Mamba's ``w_in`` holds u and z side by side and is always made whole (the
mixer takes its channels of each); the xLSTM mixers compute whole, as the
reference's DP-only recurrence.
"""
from __future__ import annotations

from typing import Callable

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.context import TP, ShardCtx

# the logical name the rules split each kind of leaf over, for the leaves
# the model computes on as their 'model' shards (``context.tp_split``):
# the top-level subtrees, then a slot's mixer and ffn by kind
TP_LEAVES = {"embed": "vocab", "lm_head": "vocab", "attn": "heads",
             "cross_attn": "heads", "mlp": "ff", "mamba": "inner"}
ATTENTION = ("attn", "cross_attn")


def gatherer(cfg: ArchConfig, place, ctx: ShardCtx) -> Callable:
    """``gather(tree, path)`` for local shards placed as ``place`` (a tree
    of placement lists like the parameters'): path ``""`` for the
    top-level subtrees, ``"slots"`` for one period's slots, whose leaves
    are placed as their stacked leaf, one dimension down (the period axis
    is never sharded).  See the module's docstring for what stays
    sharded."""
    dm = ctx.mesh.device_mesh
    names = list(dm.mesh_dim_names)
    tp = names.index(TP) if TP in names else None

    def per_period(pl):
        if any(p.is_shard(0) for p in pl):
            raise ValueError(f"a stacked leaf is sharded over periods: {pl}")
        return [Shard(p.dim - 1) if p.is_shard() else p for p in pl]

    def keeps_model_shard(kind, leaf):
        if (kind, leaf) == ("mamba", "w_in"):
            return False
        return (ctx.splits(TP_LEAVES.get(kind, ""))
                or (ctx.serve and kind in ATTENTION))

    def whole(x, pl, kind, leaf):
        if tp is not None and keeps_model_shard(kind, leaf):
            pl = [Replicate() if i == tp else p for i, p in enumerate(pl)]
        return col.make_whole(x, pl, dm)

    def gather(tree, path):
        if path == "":
            return {k: {leaf: whole(x, place[k][leaf], k, leaf)
                        for leaf, x in sub.items()} for k, sub in tree.items()}
        out = {}
        for slot, sub in tree.items():
            mixer, ffn = cfg.block_pattern[int(slot[len("slot"):])]
            out[slot] = {}
            for key, leaves in sub.items():
                kind = {"mixer": mixer, "ffn": ffn}.get(key, key)
                pl = place["slots"][slot][key]
                if kind == "moe":
                    out[slot][key] = {leaf: DTensor.from_local(
                        x, dm, per_period(pl[leaf]), run_check=False)
                        for leaf, x in leaves.items()}
                else:
                    out[slot][key] = {
                        leaf: whole(x, per_period(pl[leaf]), kind, leaf)
                        for leaf, x in leaves.items()}
        return out

    return gather
