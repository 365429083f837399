"""Process groups and meshes (port of ``repro/launch/mesh.py``).

Defined as functions (never module-level constants) so importing this
module starts no process group.

``init_distributed`` starts the default process group once per process:
NCCL on ``cuda`` (one card per process, ``LOCAL_RANK``), gloo on ``cpu``.
Under ``torchrun`` (``python -m torch.distributed.run``) it reads the
rendezvous from the environment; in a plain process it starts a world of
one on a ``HashStore``.  A caller may start the group itself (tests use a
``file://`` rendezvous).  A failure to start NCCL raises: nothing falls
back to gloo or to the CPU.

``make_mesh`` wraps ``init_device_mesh`` in a ``distributed.context.Mesh``,
which gives the sharding rules the reference's ``axis_names`` and
``devices.shape``; ``make_production_mesh`` builds the 16x16 and 2x16x16
meshes (``distributed.context.ShapeMesh`` gives their shapes alone, for
rules and memory plans no process runs).
"""
from __future__ import annotations

import datetime
import os
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.context import Mesh
from repro_torch.params import resolve_device

# a collective that some process never joins fails after this long
# instead of hanging
TIMEOUT_S = 300


def init_distributed(device="cuda") -> str:
    """Start the default process group for ``device`` unless one runs;
    returns its backend (``nccl`` or ``gloo``)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group runs; "
                               f"device {dev} needs {backend}")
        return backend
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if dev.type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        kw["device_id"] = local
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # torchrun
        dist.init_process_group(**kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return backend


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` processes (all of
    them, as ``init_device_mesh`` builds it, unless the mesh is smaller
    than the world: an elastic shrink)."""
    init_distributed(device)
    dev_type = resolve_device(device).type
    shape, axes = tuple(shape), tuple(axes)
    n, world = int(np.prod(shape)), dist.get_world_size()
    if n > world:
        raise RuntimeError(f"a {shape} mesh needs {n} processes; this world "
                           f"has {world}")
    if n == world:
        return Mesh(init_device_mesh(dev_type, shape, mesh_dim_names=axes))
    return Mesh(DeviceMesh(dev_type, torch.arange(n).reshape(shape),
                           mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The 16x16 single-pod (256 devices) or 2x16x16 multi-pod (512)
    production mesh over this world, which must have exactly that many
    processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_distributed(device)
    if dist.get_world_size() != int(np.prod(shape)):
        raise RuntimeError(f"the production mesh {shape} needs "
                           f"{int(np.prod(shape))} processes; this world has "
                           f"{dist.get_world_size()}")
    return make_mesh(shape, axes, device)
