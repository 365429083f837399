"""Fault-tolerant checkpointing: atomic, restart-exact (port of
``repro/training/checkpoint.py``).

* Atomic: state is written to ``<dir>/tmp.<step>`` and ``os.replace``d into
  place, so a crash mid-save can never corrupt the latest checkpoint.
* Restart-exact: (step, params, optimizer moments) are all captured;
  batches are a pure function of the step, so resumed training is bit
  for bit the uninterrupted run (tests/test_torch_checkpoint.py).
* Elastic: leaves are stored whole, as host arrays.  ``save`` of a
  sharded state (DTensor leaves) gathers each leaf on every process and
  writes on rank 0 alone; ``load`` places the leaves on the ``device``
  the restarted job runs on and, given a ``mesh`` and ``placements``
  (the reference's ``shardings``), distributes each onto that mesh, so
  the same checkpoint resumes on another process count.
* Async: ``save(..., blocking=False)`` copies every leaf to the host on
  the calling thread, then writes on a background thread, so training
  continues during the I/O and never changes what is written.

A checkpoint directory holds one ``leaf_<i>.npy`` per leaf (``i`` in
``jax.tree.leaves``' order: dict keys sorted; raw arrays, read and written
at the disk's rate, where the reference's one ``leaves.npz`` goes through
a zip archive) and ``meta.json``: the step, the leaves' dtypes (bfloat16
leaves are stored as their 16 bits), and the tree as nested JSON objects
whose leaves are leaf indices, empty dicts included.  No pickle: loading
runs no code from the file.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.elastic import full_value
from repro_torch.models.transformer import tree_leaves, tree_unflatten
from repro_torch.params import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "float64": torch.float64, "bool": torch.bool}


def _index_tree(tree):
    """``tree`` with each leaf replaced by its index in ``tree_leaves``."""
    return tree_unflatten(tree, list(range(len(tree_leaves(tree)))))


def _to_host(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of ``x`` on the host as numpy, and its dtype's name."""
    x = x.detach().to("cpu", copy=True)
    name = str(x.dtype).split(".")[1]
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy(), name
    return x.numpy(), name


def save(ckpt_dir: str, step: int, state: Dict[str, Any],
         keep: int = 3, blocking: bool = True) -> threading.Thread:
    """Write checkpoint atomically; prune to the newest ``keep``.  Every
    process of a sharded state must call it (each leaf is gathered whole);
    only rank 0 writes."""
    writer = not dist.is_initialized() or dist.get_rank() == 0
    host = []                                          # device→host snapshot
    for x in tree_leaves(state):
        x = full_value(x)
        if writer:
            host.append(_to_host(x))
    if not writer:
        th = threading.Thread(target=lambda: None, daemon=True)
        th.start()
        return th
    os.makedirs(ckpt_dir, exist_ok=True)
    meta = {"step": step, "n_leaves": len(host),
            "dtypes": [name for _, name in host], "tree": _index_tree(state)}

    def _write():
        tmp = os.path.join(ckpt_dir, f"tmp.{step}")
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        for i, (a, _) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), a)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                       # atomic publish
        _prune(ckpt_dir, keep)

    th = threading.Thread(target=_write, daemon=True)
    th.start()
    if blocking:
        th.join()
    return th


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def load(ckpt_dir: str, step: Optional[int] = None, device=None,
         mesh=None, placements=None) -> Tuple[int, Dict[str, Any]]:
    """Restore a checkpoint (the newest unless ``step`` is given) as
    tensors on ``device`` (the CPU when None).  With a ``mesh`` (a
    ``launch.mesh.Mesh``), each leaf whose entry in ``placements`` (a tree
    of the state's nesting; a None subtree stays plain) is a placement
    list becomes a DTensor on that mesh, one leaf on the device at a
    time: the elastic-resume path."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    dev = resolve_device(device if device is not None else "cpu")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves = []
    for i, name in enumerate(meta["dtypes"]):
        t = torch.from_numpy(np.load(os.path.join(d, f"leaf_{i}.npy")))
        if name == "bfloat16":
            t = t.view(torch.bfloat16)
        leaves.append(t.to(dtype=_DTYPES[name]))

    def place(tree, pl):
        if isinstance(tree, dict):
            return {k: place(v, None if pl is None else pl[k])
                    for k, v in tree.items()}
        tree = tree.to(dev)
        return tree if pl is None else distribute_tensor(
            tree, mesh.device_mesh, pl)

    return step, place(tree_unflatten(meta["tree"], leaves),
                       placements if mesh is not None else None)
