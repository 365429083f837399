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
  view and returns a tensor, unfused, as XLA's "bytes accessed" counts
  them per HLO op.

Eager torch runs every iteration of a loop, so the counts of a plain
step already are what the reference's trip-count correction computes:
the dry-run's ``_raw`` keys equal the corrected ones.  There is no HLO
parser.  The recurrent scans (``models/ssm.py``) are the exception the
reference's multipliers are for: a loop over 32768 tokens is 32768
Python steps through every mode.  Under ``counting(loops=True)`` (the
dry-run's) each scan runs its first and last turns as they are and the
turns between once (``counted_loop``): every count made inside that
turn, forward and backward (FLOPs, ``bytes_accessed``, each collective's
count and bytes, the ``by_label`` maps), is multiplied by the number of
turns it stands for (``OpCount.repeat``), the counterpart of
``hlo_analysis._multipliers``.  Outside that counting every turn runs.

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
from typing import Dict, Iterator, Optional

import torch
from torch.autograd.graph import get_gradient_edge
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
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
    and collective bytes by issuing function and op.  ``flop_mode`` is the
    ``FlopCounterMode`` beside it, whose total ``repeat`` corrects; with
    ``loops`` the recurrent scans count their turns (``counted_loop``)."""

    def __init__(self, flop_mode: FlopCounterMode, by_label: bool = False,
                 loops: bool = False):
        super().__init__()
        self.flop_mode = flop_mode
        self.by_label = by_label
        self.loops = loops
        # the product of the open ``repeat`` blocks' counts, and what they
        # add to ``flop_mode``'s total, which counts each op once
        self.scale = 1
        self.flops_extra = 0
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

    def flops(self) -> int:
        """``flop_mode``'s total with the ``repeat`` blocks' counts."""
        return self.flop_mode.get_total_flops() + self.flops_extra

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Every count made inside the block counts ``n`` times (0: not
        at all); blocks nest, their counts multiply."""
        f0 = self.flops()
        prev, self.scale = self.scale, self.scale * n
        try:
            yield
        finally:
            self.scale = prev
            self.flops_extra += (n - 1) * (self.flops() - f0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # let DTensor turn its ops into local ops and collectives first, as
        # CommDebugMode does; those come back through this mode
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        n = self.scale
        if not n:
            return out
        kind = collective_kind(func)
        if kind:
            b = nbytes(args[0] if func.namespace == "c10d" else out)
            self.coll[kind] += n * b
            self.n_coll[kind] += n
            if self.by_label:
                self.coll_lbl[f"{self._site()}/{kind}"] += n * b
        # a view, or an op that returns no tensor (``prim.device``, the
        # query behind ``x.device`` on a fake tensor), moves no bytes
        if not func.is_view and any(isinstance(t, torch.Tensor)
                                    for t in tree_leaves(out)):
            self.bytes_accessed += n * (nbytes((args, kwargs)) + nbytes(out))
        if self.by_label and func._overloadpacket in flop_registry:
            f = flop_registry[func._overloadpacket](*args, **kwargs,
                                                    out_val=out)
            self.flops_lbl[f"{self._site()}/{func._overloadpacket}"] += n * f
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
def counting(by_label: bool = False, loops: bool = False) -> Iterator[dict]:
    """Count what runs inside the block; the yielded dict is filled with
    :meth:`OpCount.result`'s keys when the block ends.  With ``loops``
    the recurrent scans run each distinct turn once, counted as many
    times as it stands for (the dry-run's trace; see the module's
    docstring).  Enter it inside any ``FakeTensorMode``, so the counts
    see the ops before the fake tensors take them."""
    res: dict = {}
    flop_mode = FlopCounterMode(display=False)
    ops = OpCount(flop_mode, by_label, loops)
    with flop_mode, ops:
        yield res
    res.update(ops.result(ops.flops()))


# --------------------------------------------------------------------------
# counted turns of a loop
# --------------------------------------------------------------------------
def loop_counter() -> Optional[OpCount]:
    """The innermost ``OpCount`` that counts loops on the dispatch mode
    stack (which autograd carries to its backward thread), else None: a
    loop runs every turn wherever this is None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCount) and mode.loops:
            return mode
    return None


def _storage(t: torch.Tensor):
    return t.untyped_storage()._cdata


class _Spec:
    """What ``_Turns`` and ``_Kept`` share of one loop: the counter, the
    body, the turns they stand for, the count of parameters and of carry
    tensors, the rows of a turn (``step``; 1: one row, its time dim
    dropped), and the bytes the turns keep for their backward (set by
    ``_Turns.forward``)."""

    def __init__(self, counter, run, n, n_p, n_c, step):
        self.counter, self.run, self.n = counter, run, n
        self.n_p, self.n_c, self.step = n_p, n_c, step
        self.keep = 0

    def split(self, flat):
        n_p, n_c = self.n_p, self.n_c
        return tuple(flat[:n_p]), tuple(flat[n_p:n_p + n_c]), tuple(
            flat[n_p + n_c:])

    def turn(self, x: torch.Tensor) -> torch.Tensor:
        """The first turn's rows of a block of turns."""
        return x[0] if self.step == 1 else x[:self.step]

    def rows(self, y: torch.Tensor) -> torch.Size:
        """The shape of ``n`` turns' outputs of the shape of ``y`` joined
        along dim 0."""
        return ((self.n,) + y.shape if self.step == 1 else
                (self.n * y.shape[0],) + y.shape[1:])


class _Turns(torch.autograd.Function):
    """``n`` turns of ``carry, y = run(params, carry, xs)``, each on its
    own rows of the blocks ``xs``, as one: the first turn's body runs once
    with every count multiplied by ``n``, its backward once inside
    ``repeat(n)``; the turns' outputs (joined along dim 0) and the blocks'
    gradients are uninitialised tensors of their shapes (made under
    ``repeat(0)``, so only ``MemTracker`` sees them).  Its backward
    recomputes the body (uncounted; ``run`` itself may be a
    ``checkpoint``, whose own recompute and early stop then count) and
    adds each parameter's gradient n - 1 times, as autograd adds the n
    turns' gradients of a parameter they share."""

    @staticmethod
    def forward(ctx, spec, *flat):
        counter, n = spec.counter, spec.n
        params, carry, blocks = spec.split(flat)
        xs = tuple(spec.turn(x) for x in blocks)
        first = params + carry + xs
        with counter.repeat(n):
            if not any(ctx.needs_input_grad[1:]):
                carry, y = spec.run(params, carry, xs)
            else:
                # as autograd records it: the bytes a turn keeps for its
                # backward that it made, and for a carry the next turn
                # keeps (one this turn keeps too, or its output, counted
                # once), the carry this turn was handed stands in (the
                # graph keeps no tensor, and its nodes keep the pack
                # hook, so ``saved`` is emptied: nothing of this run
                # outlives it)
                saved = []
                with torch.enable_grad(), \
                        torch.autograd.graph.saved_tensors_hooks(
                            saved.append, lambda _: None):
                    det = [t.detach().requires_grad_(t.requires_grad)
                           for t in first]
                    out, y = spec.run(*spec.split(det))
                kept = {_storage(t): t.untyped_storage().nbytes()
                        for t in saved}
                before = {_storage(t) for t in first}
                keep = sum(b for k, b in kept.items() if k not in before)
                keep += sum(kept[_storage(c)] for c, o in zip(carry, out)
                            if _storage(c) in kept and _storage(o) not in kept
                            and _storage(o) != _storage(y))
                spec.keep = n * keep
                carry, y = tuple(t.detach() for t in out), y.detach()
                saved.clear()
                del det, out
        with counter.repeat(0):
            ys = torch.empty(spec.rows(y), dtype=y.dtype, device=y.device)
        ctx.spec = spec
        ctx.save_for_backward(*first)
        return (*carry, ys)

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        counter, n, n_p, n_c = spec.counter, spec.n, spec.n_p, spec.n_c
        first = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            det = [t.detach().requires_grad_(r) for t, r in zip(first, need)]
            with counter.repeat(0):
                carry, y = spec.run(*spec.split(det))
                g_y = spec.turn(grads[n_c]) if grads[n_c] is not None \
                    else None
            # the outputs' graph edges, not the outputs: their memory is
            # freed before the backward, as the turns' own outputs are
            pairs = [(get_gradient_edge(o), g)
                     for o, g in zip((*carry, y), (*grads[:n_c], g_y))
                     if g is not None and o.requires_grad]
            del carry, y
            wrt = [t for t in det if t.requires_grad]
            with counter.repeat(n):
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], wrt, [g for _, g in pairs],
                    allow_unused=True) if pairs and wrt else ())
        out = [next(got) if t.requires_grad else None for t in det]
        with counter.repeat(n - 1):
            for g in out[:n_p]:
                if g is not None:
                    g + g
        with counter.repeat(0):
            out[n_p + n_c:] = [None if g is None else torch.empty(
                spec.rows(g), dtype=g.dtype, device=g.device)
                for g in out[n_p + n_c:]]
        return (None, *out)


class _Kept(torch.autograd.Function):
    """The identity on ``_Turns``' outputs that holds, for the backward,
    the bytes its turns would keep (uninitialised, under ``repeat(0)``):
    its backward runs just before ``_Turns``', which frees them first,
    as the turns' own backward frees a turn's tensors as it goes."""

    @staticmethod
    def forward(ctx, spec, *outs):
        if spec.keep:
            with spec.counter.repeat(0):
                ctx.save_for_backward(torch.empty(
                    spec.keep, dtype=torch.uint8, device=outs[0].device))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


def counted_loop(counter: OpCount, run, params, carry, xs, step: int):
    """``carry, y = run(params, carry, x_turn)`` over the turns of ``step``
    rows of the tensors ``xs`` (dim 0; a turn of one row drops it) in
    order, as ``counter`` counts them: (carry, the ys joined along dim 0).
    The first and last turns run; the n - 2 between run once, counted n -
    2 times (``_Turns``), their outputs uninitialised.  The joins are one
    split of each input and one ``cat`` of the outputs, whose bytes are
    those of the loop's split or unbind and its ``cat`` or ``stack``.
    Only for counting: the values are not the loop's."""
    n = xs[0].shape[0] // step
    parts = [x.split([step, (n - 2) * step, step]) for x in xs]
    one, lift = ((lambda t: t.squeeze(0), lambda t: t.unsqueeze(0))
                 if step == 1 else (lambda t: t, lambda t: t))
    carry, y0 = run(params, carry, tuple(one(p[0]) for p in parts))
    spec = _Spec(counter, run, n - 2, len(params), len(carry), step)
    out = _Turns.apply(spec, *params, *carry, *(p[1] for p in parts))
    out = _Kept.apply(spec, *out)
    carry, y1 = run(params, tuple(out[:-1]), tuple(one(p[2]) for p in parts))
    return carry, torch.cat([lift(y0), out[-1], lift(y1)])
