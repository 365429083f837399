"""Preemptible executor (port of ``repro/serving/executor.py``): runs the
model with preemption points at super-block (period) boundaries during
prefill and token boundaries during decode.

The execution context held at a boundary — hidden activations, the
projected image states of a VLM request, the cache (attention KV buffers,
cross-attention's static image KV, Mamba and xLSTM states), generated
tokens — is an explicit :class:`ExecState`.  Suspend and resume are exact: a
preempted-then-resumed run produces bit-identical outputs to an
uninterrupted one.  Each step runs under ``torch.inference_mode()``; the
decode cache is updated in place.  Only self-attention slots grow with
the context; the image KV and a recurrent state keep their sizes.  An
encoder-only model ends its prefill in phase ``done`` with logits at every
position and no token.

A decode step of a dense decoder on the card is replayed from a CUDA
graph, one per request and cache capacity (:func:`graph_engages` says
where, :func:`decode_plan` when): the first step at a capacity runs
eagerly and warms up, the second is captured (the model's every launch
and the greedy argmax, on static inputs: the token and a device ``pos``)
and replayed, and every later step at that capacity is replayed.  The
graph lives on the :class:`ExecState`, holds the decode kernel's merge
tickets it addresses, is dropped before the cache grows (it addresses the
buffers growth replaces) and when the state is done, and gives the same
bits as the eager step.

Each call asks ``obs.host`` whether to record (``host.arm()``) and, when
it records, leaves host-clock spans: ``exec.start``, ``exec.prefill`` (one
period), ``exec.decode`` and inside it ``exec.grow`` (the KV buffers'
growth, counters ``kv_grows`` and ``kv_grow_bytes``), ``exec.h2d`` (the
last token, and for a graph ``pos``, to the device), ``exec.model``
(``transformer.decode_step``, or the graph: inside it ``exec.capture``
and ``exec.replay``, counters ``decode_graph_captures`` and
``decode_graph_replays``, the capture step's replay counted) and
``exec.sample`` (``_greedy``'s copy to the host, the step's one sync;
counter ``host_syncs``; also in prefill's last period).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed.context import current
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models import transformer
from repro_torch.models.layers import apply_norm, unembed
from repro_torch.models.registry import Model
from repro_torch.obs import host

Params = Dict[str, Any]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _nbytes_of(cache: Dict[str, Dict[str, torch.Tensor]], slots: List[str]) -> int:
    return sum(_nbytes(t) for name in slots for t in cache[name].values())


@dataclasses.dataclass
class ExecState:
    """Checkpointable execution context (the CHECKPOINT payload)."""
    phase: str                            # prefill | decode | done
    period_idx: int = 0
    h: Optional[torch.Tensor] = None      # hidden activations at the boundary
    img_h: Optional[torch.Tensor] = None
    cache_slices: Optional[List] = None   # per completed period (prefill)
    cache: Optional[Any] = None           # stacked cache (decode)
    pos: int = 0                          # tokens in cache
    tokens_out: Optional[List[np.ndarray]] = None
    last_logits: Optional[torch.Tensor] = None
    graph: Optional["DecodeGraph"] = None       # decode step at the capacity
    eager_capacity: Optional[int] = None        # of the latest eager step

    def context_bytes(self) -> int:
        """Size of the state a CHECKPOINT must preserve: the live
        activation boundary state; the cache stays in device memory."""
        return int(sum(_nbytes(t) for t in (self.h, self.last_logits)
                       if t is not None))

    def cache_bytes(self) -> int:
        leaves = (transformer.tree_leaves(self.cache_slices)
                  + transformer.tree_leaves(self.cache))
        return int(sum(_nbytes(t) for t in leaves))


@dataclasses.dataclass
class DecodeGraph:
    """One decode step captured at one cache capacity, with its static
    tensors: ``inputs`` (B + 1,) int32, each sequence's token then
    ``pos``, read by each replay; ``logits`` and ``tokens``, the greedy
    (B,) int32, rewritten by each replay.  ``tickets``: the decode
    kernel's merge tickets it addresses, held so that they live as long as
    the graph (a larger batch's call replaces the kernel's own).
    ``launches``: the decode kernel's launches it captured, which each
    replay adds to the kernel's counter (none ask for the lse: no graph
    runs under a sharding context)."""
    graph: Any
    capacity: int
    inputs: torch.Tensor
    logits: torch.Tensor
    tokens: torch.Tensor
    tickets: torch.Tensor
    launches: int


def graph_engages(cfg: ArchConfig, device: torch.device) -> bool:
    """Whether decode steps are replayed from CUDA graphs, decided on what
    the executor observes: the weights on CUDA, no sharding context, and
    every block self-attention then an MLP, decoding tokens.  Other
    models (MoE, recurrent, cross-attention, encoder-only) and sharded
    steps run eagerly: their steps hold host syncs, collectives or state
    that a graph of one step does not capture."""
    return (device.type == "cuda" and current() is None
            and not cfg.encoder_only
            and all(block == ("attn", "mlp") for block in cfg.block_pattern))


def decode_plan(graph_capacity: Optional[int], eager_capacity: Optional[int],
                capacity: int) -> str:
    """How a decode step at cache ``capacity`` runs, given the capacity of
    the state's graph and that of its latest eager step: ``"replay"`` the
    graph captured at this capacity; ``"capture"`` on the second step at
    a capacity (the first warmed up); else ``"eager"``, so a request that
    decodes one step at a capacity never pays for a capture."""
    if graph_capacity == capacity:
        return "replay"
    return "capture" if eager_capacity == capacity else "eager"


# one capture stream per device for the process: cuBLAS keeps a workspace
# per stream, so each new stream would add one to a graph's memory pool
_capture_streams: Dict[torch.device, Any] = {}


def _capture_graph(fn, device: torch.device):
    """``fn()`` captured into a CUDA graph on a side stream, in a memory
    pool of its own; returns the graph and ``fn``'s outputs, which each
    replay rewrites.  Nothing runs on the device until a replay."""
    stream = _capture_streams.get(device)
    if stream is None:
        stream = _capture_streams[device] = torch.cuda.Stream(device)
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    return graph, out


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """First index of the maximum, as ``jnp.argmax``."""
    t0 = host.ON and host.now()
    return _to_host(_argmax(logits), t0)


def _to_host(tokens: torch.Tensor, t0: int) -> np.ndarray:
    """``tokens`` copied to the host, the step's one sync: the span
    ``exec.sample`` from ``t0`` while recording."""
    tokens = tokens.cpu().numpy()
    if t0:
        host.add("exec.sample", t0, host.now())
        host.count("host_syncs")
    return tokens


class PreemptibleExecutor:
    """Period/token-granular executor for one model instance."""

    def __init__(self, model: Model, params: Params):
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.params = params

    @property
    def n_periods(self) -> int:
        return self.cfg.n_periods

    def _device(self) -> torch.device:
        """The weights' device, read from the block stack every arch has."""
        return transformer.tree_leaves(self.params["slots"])[0].device

    @torch.inference_mode()
    def start(self, batch: Dict[str, Any]) -> ExecState:
        """``batch``: ``tokens`` or ``frames``, and ``img_embeds`` for a
        VLM, as array-likes (the engine hands over numpy arrays)."""
        t0 = host.arm() and host.now()
        dev = self._device()
        inputs = {k: torch.as_tensor(np.asarray(batch[k]), device=dev)
                  for k in ("tokens", "frames", "img_embeds") if k in batch}
        h, img_h = transformer._embed_inputs(self.params, self.cfg, inputs)
        st = ExecState(phase="prefill", period_idx=0, h=h, img_h=img_h,
                       cache_slices=[], tokens_out=[], pos=int(h.shape[1]))
        if t0:
            host.add("exec.start", t0, host.now(), st.pos)
        return st

    @torch.inference_mode()
    def step_prefill(self, st: ExecState) -> ExecState:
        """Execute one super-block period; boundary afterwards."""
        t0 = host.arm() and host.now()
        assert st.phase == "prefill"
        cfg = self.cfg
        period = st.period_idx
        slots = transformer.period_params(self.params["slots"], period)
        h, new_cache = st.h, {}
        for i in range(cfg.period):
            h, nc, _ = transformer._apply_block(i, h, slots[f"slot{i}"],
                                                cfg, "prefill", None, None,
                                                st.img_h,
                                                layer=period * cfg.period + i)
            new_cache[f"slot{i}"] = nc
        st.h = h
        st.cache_slices.append(new_cache)
        st.period_idx += 1
        if st.period_idx == self.n_periods:
            hn = apply_norm(st.h, self.params["final_norm"], cfg)
            if cfg.embedding_inputs:
                st.last_logits = hn @ self.params["lm_head"]["w"]
            else:
                st.last_logits = unembed(hn[:, -1:], self.params, cfg)
            if cfg.encoder_only:
                # no decode: the slices stay, and count in cache_bytes()
                st.phase = "done"
            else:
                # stack the per-period slices into the decode cache and
                # greedy-sample the first token
                st.cache = transformer.stack_periods(st.cache_slices)
                st.cache_slices = None
                st.tokens_out.append(_greedy(st.last_logits))
                st.phase = "decode"
        if t0:
            host.add("exec.prefill", t0, host.now(), period)
        return st

    def _attn_slots(self) -> List[str]:
        return [f"slot{i}" for i, (mixer, _) in
                enumerate(self.cfg.block_pattern) if mixer == "attn"]

    def _grow_cache(self, st: ExecState, extra: int) -> None:
        """Extend the self-attention KV buffers to hold ``extra`` more
        tokens; the image KV and recurrent states are left as they are.
        Recorded as ``exec.grow`` with the buffers' bytes before and after."""
        t0 = host.ON and host.now()

        def pad(a: torch.Tensor) -> torch.Tensor:
            shape = list(a.shape)
            shape[2] = extra             # (periods, B, T, H, Dh)
            return torch.cat([a, a.new_zeros(shape)], dim=2)
        slots = self._attn_slots()
        before = t0 and _nbytes_of(st.cache, slots)
        for name in slots:
            st.cache[name] = {k: pad(v) for k, v in st.cache[name].items()}
        if t0:
            after = _nbytes_of(st.cache, slots)
            host.add("exec.grow", t0, host.now(), (before, after))
            host.count("kv_grows")
            host.count("kv_grow_bytes", after - before)

    @torch.inference_mode()
    def step_decode(self, st: ExecState) -> ExecState:
        """Generate one token; boundary afterwards.  The KV buffers grow
        when full; a model without attention never grows.  Where
        :func:`graph_engages`, the step runs as :func:`decode_plan` says."""
        t0 = host.arm() and host.now()
        assert st.phase == "decode"
        attn_slots = self._attn_slots()
        plan, t_cap = "eager", None
        if attn_slots:
            t_cap = st.cache[attn_slots[0]]["k"].shape[2]
            if st.pos >= t_cap:
                st.graph = None          # it addresses the buffers replaced
                self._grow_cache(st, max(16, t_cap // 4))
                t_cap = st.cache[attn_slots[0]]["k"].shape[2]
            if graph_engages(self.cfg, self._device()):
                plan = decode_plan(st.graph and st.graph.capacity,
                                   st.eager_capacity, t_cap)
        t1 = t0 and host.now()
        if plan == "eager":
            tok = torch.as_tensor(st.tokens_out[-1][:, None],
                                  device=self._device())
            if t0:
                t2 = host.now()
                host.add("exec.h2d", t1, t2)
            logits, st.cache = transformer.decode_step(
                self.params, st.cache, tok, st.pos, self.cfg)
            if t0:
                host.add("exec.model", t2, host.now())
            st.eager_capacity, tokens = t_cap, None
        else:
            logits, tokens = self._graph_step(st, plan == "capture", t_cap,
                                              t1)
        st.pos += 1
        st.last_logits = logits
        st.tokens_out.append(_greedy(logits) if tokens is None else
                             _to_host(tokens, host.ON and host.now()))
        if t0:
            host.add("exec.decode", t0, host.now(), st.pos - 1)
        return st

    def _graph_step(self, st: ExecState, capture: bool, capacity: int,
                    t1: int):
        """The step from the state's graph, captured first if ``capture``;
        returns a copy of the logits (the graph's own are rewritten by its
        next replay) and the greedy tokens on the device.  ``t1``: where
        ``exec.h2d`` starts while recording, else 0."""
        inputs = np.append(st.tokens_out[-1], np.int32(st.pos))
        if capture:
            inputs = torch.as_tensor(inputs, device=self._device())
        else:
            st.graph.inputs.copy_(torch.from_numpy(inputs))
        if t1:
            t2 = host.now()
            host.add("exec.h2d", t1, t2)
        if capture:
            st.graph = self._capture(st, inputs, capacity)
            if t1:
                t3 = host.now()
                host.add("exec.capture", t2, t3)
                host.count("decode_graph_captures")
        else:
            t3 = t1 and host.now()
        g = st.graph
        g.graph.replay()
        decode_ops.launches += g.launches
        if t1:
            host.add("exec.replay", t3, host.now())
            host.count("decode_graph_replays")
        logits = g.logits.clone()
        if t1:
            host.add("exec.model", t2, host.now())
        return logits, g.tokens

    def _capture(self, st: ExecState, inputs: torch.Tensor,
                 capacity: int) -> DecodeGraph:
        """The decode step on the static ``inputs`` and the state's cache,
        and its greedy argmax, captured on the decode kernel's merge
        tickets, allocated first."""
        b = inputs.numel() - 1
        tickets = decode_ops.tickets(inputs.device, b * self.cfg.n_kv_heads)
        before = decode_ops.captured

        def step():
            logits, _ = transformer.decode_step(
                self.params, st.cache, inputs[:b].view(b, 1), inputs[b],
                self.cfg)
            return logits, _argmax(logits)
        graph, (logits, tokens) = _capture_graph(step, inputs.device)
        return DecodeGraph(graph, capacity, inputs, logits, tokens, tickets,
                           decode_ops.captured - before)

    def step(self, st: ExecState) -> ExecState:
        if st.phase == "prefill":
            return self.step_prefill(st)
        if st.phase == "decode":
            return self.step_decode(st)
        return st

    # ------------------------------------------------------------------
    def run_uninterrupted(self, batch: Dict[str, Any], max_new_tokens: int,
                          eos_id: Optional[int] = None) -> ExecState:
        st = self.start(batch)
        while st.phase == "prefill":
            st = self.step_prefill(st)
        while st.phase == "decode" and len(st.tokens_out) < max_new_tokens:
            st = self.step_decode(st)
            if eos_id is not None and bool(np.all(st.tokens_out[-1] == eos_id)):
                break
        st.phase, st.graph = "done", None
        return st

    @staticmethod
    def checkpoint(st: ExecState) -> ExecState:
        """Make the context a complete, consistent snapshot: wait for the
        work queued on the state's CUDA stream."""
        if st.h is not None and st.h.is_cuda:
            torch.cuda.current_stream(st.h.device).synchronize()
        return st

    @staticmethod
    def restore(st: ExecState) -> ExecState:
        return st
