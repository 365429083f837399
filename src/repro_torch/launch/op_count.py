"""Per-device FLOPs, bytes and collectives of one traced step: the port's
counterpart of ``repro/launch/hlo_analysis.py``'s ``analyze``.

The reference parses the compiled HLO of a step: dot FLOPs, and the
*result-buffer* bytes of each collective by kind, multiplied by the trip
counts of the while loops around them.  The port has no HLO.  It counts
while the step runs (on fake tensors in the dry-run, on real ones on the
card), as a ``TorchDispatchMode`` beside
``torch.utils.flop_counter.FlopCounterMode``:

* ``flops``: ``FlopCounterMode``'s total (the products: ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions and attention, forward and
  backward), the counterpart of the reference's dot FLOPs;
* each collective the process group runs (the eager ``c10d`` ops under
  ``torch.distributed``'s calls, and the functional ``_c10d_functional``
  ops that DTensor issues), by count and by the bytes of its result
  buffer, by the reference's kinds (``coll_all-gather``, ...);
* ``bytes_accessed``: the input and output bytes of every op that is not a
  view, unfused, as XLA's "bytes accessed" counts them per HLO op.

Eager torch runs every iteration of a loop, so every count already is
what the reference's trip-count correction computes: the dry-run's
``_raw`` keys equal the corrected ones.  There is no HLO parser.

With ``by_label`` the FLOPs and collective bytes are also attributed to
the port's function that issued them (the innermost frame of the package
outside ``distributed/collectives.py``) and the op: the top 25 of each,
as ``analyze(..., by_label=True)`` attributes them to source ops.
"""
from __future__ import annotations

import contextlib
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
# op-name stem -> the reference's kind; the eager c10d ops take their result
# buffers as their first argument, the functional ones return them
_KINDS = (("allgather", "all-gather"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
          ("all_reduce", "all-reduce"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"))
_COMM_NAMESPACES = ("c10d", "_c10d_functional")
_PKG = Path(__file__).resolve().parents[1]
_SKIP = {Path(__file__).resolve(), _PKG / "distributed" / "collectives.py"}
TOP = 25


def nbytes(tree) -> int:
    """Bytes of the tensors of a tree (of a DTensor, its local shard)."""
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def collective_kind(func) -> str:
    """The reference's kind of a ``c10d`` or ``_c10d_functional`` op, or ""
    for any other op (``wait_tensor`` and the like move nothing)."""
    if func.namespace not in _COMM_NAMESPACES:
        return ""
    name = func._opname
    return next((kind for stem, kind in _KINDS if stem in name), "")


class OpCount(TorchDispatchMode):
    """Counts collectives (count and result bytes by kind) and every
    non-view op's input and output bytes; with ``by_label`` also FLOPs
    and collective bytes by issuing function and op."""

    def __init__(self, by_label: bool = False):
        super().__init__()
        self.by_label = by_label
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.n_coll: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.bytes_accessed = 0
        self.flops_lbl: Dict[str, float] = defaultdict(float)
        self.coll_lbl: Dict[str, float] = defaultdict(float)
        self._sites: Dict[object, str] = {}      # code object -> label

    def _site(self) -> str:
        """``module.function`` of the innermost frame of this package that
        is not the counting or the collectives' code: who issued the op."""
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            if code not in self._sites:
                path = Path(code.co_filename).resolve()
                self._sites[code] = "" if (
                    not path.is_relative_to(_PKG) or path in _SKIP) else (
                    ".".join(path.relative_to(_PKG).with_suffix("").parts)
                    + "." + code.co_qualname.replace("<locals>.", ""))
            if self._sites[code]:
                return self._sites[code]
            f = f.f_back
        return "<outside the package>"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # let DTensor turn its ops into local ops and collectives first, as
        # CommDebugMode does; those come back through this mode
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = collective_kind(func)
        if kind:
            b = nbytes(args[0] if func.namespace == "c10d" else out)
            self.coll[kind] += b
            self.n_coll[kind] += 1
            if self.by_label:
                self.coll_lbl[f"{self._site()}/{kind}"] += b
        if not func.is_view:
            self.bytes_accessed += nbytes((args, kwargs)) + nbytes(out)
        if self.by_label and func._overloadpacket in flop_registry:
            f = flop_registry[func._overloadpacket](*args, **kwargs,
                                                    out_val=out)
            self.flops_lbl[f"{self._site()}/{func._overloadpacket}"] += f
        return out

    def result(self, flops: float) -> Dict[str, object]:
        """The reference's ``analyze`` keys for a step of ``flops``, plus
        ``bytes_accessed`` and ``collective_counts`` (count by kind)."""
        out: Dict[str, object] = {
            "flops": float(flops),
            "collective_bytes": sum(self.coll.values()),
            "n_collectives": sum(self.n_coll.values()),
            "collective_counts": {k: n for k, n in self.n_coll.items() if n},
            "bytes_accessed": self.bytes_accessed}
        out.update({f"coll_{k}": v for k, v in self.coll.items() if v})
        if self.by_label:
            top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:TOP])
            out["flops_by_label"] = top(self.flops_lbl)
            out["coll_by_label"] = top(self.coll_lbl)
        return out


@contextlib.contextmanager
def counting(by_label: bool = False) -> Iterator[dict]:
    """Count what runs inside the block; the yielded dict is filled with
    :meth:`OpCount.result`'s keys when the block ends.  Enter it inside
    any ``FakeTensorMode``, so the counts see the ops before the fake
    tensors take them."""
    res: dict = {}
    flop_mode = FlopCounterMode(display=False)
    ops = OpCount(by_label)
    with flop_mode, ops:
        yield res
    res.update(ops.result(flop_mode.get_total_flops()))
