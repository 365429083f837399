"""Elastic scaling: reshard a training state onto a different mesh (port of
``repro/distributed/elastic.py``).

Checkpoints store whole host arrays (training/checkpoint.py), so elastic
restart is: load → the target mesh's placements from the same rule set →
distribute each leaf (``checkpoint.load(..., mesh=, placements=)``).  This
module adds the in-memory variant (live resharding between meshes, e.g.
shrinking after a failure) and a planner that reports the per-device
memory implications before committing.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.hw import H100
from repro_torch.models import transformer
from repro_torch.models.transformer import tree_leaves


@dataclasses.dataclass
class ReshardPlan:
    n_from: int
    n_to: int
    bytes_per_device_from: float
    bytes_per_device_to: float
    fits: bool

    def __str__(self):
        return (f"reshard {self.n_from}→{self.n_to} devices: "
                f"{self.bytes_per_device_from/1e9:.2f} → "
                f"{self.bytes_per_device_to/1e9:.2f} GB/device "
                f"({'fits' if self.fits else 'DOES NOT FIT'})")


def plan(state, cfg: ArchConfig, mesh_from, mesh_to,
         hbm_bytes: int = H100.hbm_bytes) -> ReshardPlan:
    """Estimate per-device bytes under both meshes (sharded leaf sizes),
    from shapes alone: the leaves may be tensors, DTensors (their global
    shape) or meta tensors, the meshes shapes alone.  ``hbm_bytes``
    defaults to one H100's 80 GB, where the reference's default is a TPU
    v5e's 16 GiB."""
    def per_device(mesh):
        specs = shd.param_specs(state["params"], cfg, mesh)
        total = 0.0
        for leaf, spec in zip(tree_leaves(state["params"]),
                              tree_leaves(specs)):
            shard = shd.axis_size(mesh, tuple(
                a for dim in spec if dim for a in
                ((dim,) if isinstance(dim, str) else dim)))
            total += leaf.numel() * leaf.element_size() / max(shard, 1)
        # optimizer moments scale identically
        mult = 1.0 + sum(
            x.numel() for x in tree_leaves(state.get("opt", {}))) / max(
            1, sum(x.numel() for x in tree_leaves(state["params"])))
        return total * mult

    b_from = per_device(mesh_from)
    b_to = per_device(mesh_to)
    return ReshardPlan(mesh_from.devices.size, mesh_to.devices.size,
                       b_from, b_to, b_to <= hbm_bytes)


def full_value(x: torch.Tensor) -> torch.Tensor:
    """A leaf's whole value: gathered from a DTensor's shards (every
    process of its mesh takes part), a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def state_placements(state, cfg: ArchConfig, mesh):
    """The tree of DTensor placements of a ``{"params", "opt"}`` state on
    ``mesh``: params per ``param_specs``, the moments ``m``, ``v`` and
    ``err`` as their params (as the reference's ``reshard`` places them),
    anything else (the step) None, a plain tensor on every process."""
    p_pl = shd.param_placements(state["params"], cfg, mesh)
    out = {"params": p_pl}
    if "opt" in state:
        out["opt"] = {k: (p_pl if k in ("m", "v", "err") else None)
                      for k in state["opt"]}
    return out


def placer(cfg: ArchConfig, mesh, dtype: torch.dtype = torch.float32):
    """A ``place`` for ``init_params``/``init_train_state``: each leaf, as
    it is drawn, becomes a DTensor on ``mesh`` with its
    ``param_placements``.  Every process draws the same whole leaf from
    the same seeded generator and keeps its own shard, cloned so that no
    view keeps the whole storage alive: no collective, and the shards are
    bit for bit those that ``reshard`` cuts from the whole state.  The
    k-th leaf drawn takes the placements of the k-th leaf that the same
    init draws on the meta device."""
    drawn = []
    shapes = transformer.init_params(
        cfg, generator=torch.Generator(), dtype=dtype, device="meta",
        place=lambda x: drawn.append(x) or x)
    where = {}
    shd.map2(lambda x, pl: where.setdefault(id(x), pl), shapes,
             shd.param_placements(shapes, cfg, mesh))
    order = iter([where[id(x)] for x in drawn])
    dm = mesh.device_mesh

    def place(x):
        d = distribute_tensor(x, dm, next(order), src_data_rank=None)
        return DTensor.from_local(d.to_local().clone(), dm, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())
    return place


def distribute(tree, place, mesh):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with the placements
    of ``place`` (a tree of the same nesting; a None subtree keeps its
    leaves as they are), from the leaf's whole value: a whole tensor (the
    same on every process) or a DTensor of another mesh."""
    if place is None:
        return tree
    if isinstance(tree, dict):
        return {k: distribute(v, place[k], mesh) for k, v in tree.items()}
    return distribute_tensor(full_value(tree), mesh.device_mesh, place)


def reshard(state, cfg: ArchConfig, mesh_to):
    """Re-place every param and moment onto the target mesh per the rule
    set.  Works from live DTensors (of another mesh, whatever its size) or
    whole tensors (checkpoint load path): DTensor cannot redistribute
    across meshes, so each leaf goes through its whole value, one leaf at
    a time."""
    place = state_placements(state, cfg, mesh_to)
    return {k: distribute(v, place.get(k), mesh_to) for k, v in state.items()}
