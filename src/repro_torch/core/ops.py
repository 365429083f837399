# Copied from src/repro/core/ops.py; `repro.` rewritten to `repro_torch.`.
"""Workload descriptors consumed by the PREMA predictor and simulator.

A network is a DAG flattened (inference order) into a list of ``NodeOp``s.
Following the paper's ISA (§II-B), the unit of work is a lowered GEMM
(CONV is im2col-lowered, Fig 3(c)) or a vector op; LOAD/STORE tiles are
folded into the per-tile memory phase of Algorithm 1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GemmOp:
    """(m x k) weights @ (k x n) activations — the paper's GEMM_OP tiling
    convention: m = output channels (SW dim), k = reduction (SH dim),
    n = spatial*batch columns streamed through the array (ACC dim)."""
    m: int
    k: int
    n: int
    name: str = ""
    # identical GEMMs executed back-to-back (e.g. depthwise conv = one tiny
    # GEMM per channel); time and flops scale by ``repeat``.
    repeat: int = 1
    # bytes of *output activations* live at this node's boundary — the
    # CHECKPOINT context-state contribution (paper §IV-B).
    out_bytes: Optional[int] = None
    weight_resident: bool = True   # False → weights streamed (no reuse)

    @property
    def flops(self) -> int:
        """Multiply-accumulate FLOPs (2·m·k·n per repeat)."""
        return 2 * self.m * self.k * self.n * self.repeat

    def output_bytes(self, bytes_per_elem: int = 2) -> int:
        """Output-activation bytes at this node (checkpoint context)."""
        if self.out_bytes is not None:
            return self.out_bytes
        return self.m * self.n * self.repeat * bytes_per_elem


@dataclasses.dataclass(frozen=True)
class VectorOp:
    """Element-wise work (ACTV/POOL fused per §IV-B; in-place)."""
    elems: int
    name: str = ""

    @property
    def flops(self) -> int:
        """One op per element."""
        return self.elems


NodeOp = object  # GemmOp | VectorOp


@dataclasses.dataclass(frozen=True)
class NetworkDesc:
    """A benchmark network, flattened as:

    ``static_ops`` (once) + ``encoder_ops`` × in_len + ``recurrent_ops`` × unroll.

    ``in_len`` is statically known before inference (paper §V-B); ``unroll``
    (decoder/output length) is the dynamically-predicted quantity for
    seq2seq networks."""
    name: str
    static_ops: Tuple[NodeOp, ...]
    encoder_ops: Tuple[NodeOp, ...] = ()
    recurrent_ops: Tuple[NodeOp, ...] = ()
    kind: str = "cnn"        # cnn | rnn_linear | rnn_seq2seq | llm
    batch: int = 1

    def ops(self, in_len: int = 0, unroll: int = 0) -> List[NodeOp]:
        """The flattened op list for one inference of the given lengths."""
        out = list(self.static_ops)
        for _ in range(in_len):
            out.extend(self.encoder_ops)
        for _ in range(unroll):
            out.extend(self.recurrent_ops)
        return out

    def with_batch(self, batch: int) -> "NetworkDesc":
        """Rescale every op's batch-proportional dimension to ``batch``."""
        scale = batch / self.batch

        def scale_op(op):
            if isinstance(op, GemmOp):
                return dataclasses.replace(op, n=max(1, int(round(op.n * scale))))
            return dataclasses.replace(op, elems=max(1, int(round(op.elems * scale))))

        return dataclasses.replace(
            self,
            static_ops=tuple(scale_op(o) for o in self.static_ops),
            encoder_ops=tuple(scale_op(o) for o in self.encoder_ops),
            recurrent_ops=tuple(scale_op(o) for o in self.recurrent_ops),
            batch=batch)


# --------------------------------------------------------------------------
# Lowering helpers
# --------------------------------------------------------------------------
def conv2d(name: str, in_c: int, out_c: int, kh: int, kw: int,
           oh: int, ow: int, batch: int = 1) -> GemmOp:
    """im2col-lowered convolution (paper CONV_OP)."""
    return GemmOp(m=out_c, k=in_c * kh * kw, n=oh * ow * batch, name=name)


def depthwise_conv2d(name: str, channels: int, kh: int, kw: int,
                     oh: int, ow: int, batch: int = 1) -> GemmOp:
    """Depthwise conv: per-channel (1 x kh*kw) GEMMs — drastically
    underutilizes a 128x128 array (paper Fig 10's red-circle region)."""
    return GemmOp(m=1, k=kh * kw, n=oh * ow * batch, repeat=channels,
                  name=f"{name}.dw{channels}")


def fc(name: str, in_f: int, out_f: int, batch: int = 1) -> GemmOp:
    """Fully-connected layer as a single GEMM."""
    return GemmOp(m=out_f, k=in_f, n=batch, name=name)


def lstm_cell(name: str, input_size: int, hidden: int, batch: int = 1
              ) -> List[NodeOp]:
    """One LSTM timestep: fused 4-gate GEMM + elementwise gate math."""
    return [GemmOp(m=4 * hidden, k=input_size + hidden, n=batch, name=name),
            VectorOp(elems=8 * hidden * batch, name=f"{name}.gates")]
