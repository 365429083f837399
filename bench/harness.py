"""One run of one cell: set-up, the measured window of rounds, the check
of what the window served against the plain reference, and the metrics.

The window drives ``repro_torch.serving.ServingEngine.run`` with PREMA
(``policy="prema"``, ``mechanism="dynamic"``, one device, one batch slot)
over ``PreemptibleExecutor`` and the configuration's full-width weights,
drawn here from the seed.  The engine schedules on its virtual clock
(arrivals, step times predicted by Algorithm 1 on the frozen ``H100``
model of ``yardstick.py``); every latency and rate here is read on the
host's clock, in hooks on the engine's event bus (``submit``,
``dispatch``, ``preempt``, ``complete``) and in instance-attribute
wrappers around the executor's ``start``, ``step_prefill`` and
``step_decode``:

* a request is admitted when its ``submit`` event fires;
* its first token is at the return of the executor step that leaves
  phase ``prefill`` (``_greedy`` has copied the token to the host, so the
  device has finished), each later token at the return of its
  ``step_decode``;
* ``checkpoint`` is a static method the engine calls on the class: the
  wall from a ``preempt`` event to the next executor call or ``dispatch``
  stands for it and counts to the victim.

A round is a fresh engine fed one list of requests drawn from (seed,
round).  Rounds run until ``seconds`` have passed; the last runs to its
end.  The window is the wall from the first round's start to the last
round's end, and every metric is over all of its requests.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import bench
from bench import reference, traffic, yardstick

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
ARCH = ROOT / "arch"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})
now = time.perf_counter


def jax_side(modules) -> List[str]:
    """The JAX side's top-level packages among ``modules`` (names of
    loaded modules), compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)


# --------------------------------------------------------------------------
# the cell's files
# --------------------------------------------------------------------------
def load_benchmark() -> Dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def resolve(bm: Dict, workload: str) -> Dict:
    """The cell's entry, configuration, mix and cell file, found by name."""
    entry = next((w for w in bm["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bm["configs"] if c["name"] == entry["config"])
    return dict(entry=entry,
                cfg=json.loads((REPO / conf["file"]).read_text()),
                mix=traffic.load_mix(entry["traffic"]),
                cell=json.loads((ROOT / "cells" / f"{workload}.json")
                                .read_text()))


def cell_metrics(bm: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's metrics: end-to-end ones without the trace, per-layer
    ones with it; a metric with a ``workloads`` list only in those."""
    return [m for m in bm["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``read(window)`` of ``metrics/<name>.py``."""
    return bench.load(ROOT / "metrics" / f"{name}.py").read


def arch(cfg: Dict):
    """The module of the configuration's architecture, ``arch/<arch>.py``
    (``dense`` where its file names none): its ``ArchConfig``, weights,
    their layout in the program, and the counts the readers divide by
    (``step_flops``, ``periods``, ``attention_layers``,
    ``attention_per_period``, ``head_dim``)."""
    return bench.load(ARCH / f"{cfg.get('arch', 'dense')}.py")


# --------------------------------------------------------------------------
# weights and the program
# --------------------------------------------------------------------------
def draw_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration, drawn on ``device`` from
    ``seed`` by its architecture's module, under the benchmark's own
    names."""
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.seed_words(seed))
    return arch(cfg).draw_weights(cfg, gen, device)


def port_params(cfg: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    """The same tensors in the program's parameter layout."""
    return arch(cfg).port_params(w)


def build_model(cfg: Dict):
    """The program's model for the configuration as the file states it."""
    from repro_torch.models.registry import build
    return build(arch(cfg).arch_config(cfg))


def new_engine(model, params):
    from repro_torch.hw import HardwareModel
    from repro_torch.serving import EngineConfig, ServingEngine
    return ServingEngine({model.cfg.name: (model, params)}, cfg=EngineConfig(
        hw=HardwareModel(**yardstick.FROZEN_H100), policy="prema",
        mechanism="dynamic", n_devices=1, batch_slots=1))


def requests(cfg: Dict, drawn: List[Dict]):
    from repro_torch.serving import InferenceRequest
    return [InferenceRequest(rid=q["rid"], arch=cfg["name"], prompt=q["prompt"],
                             max_new_tokens=q["max_new_tokens"],
                             priority=q["priority"], arrival=q["arrival"],
                             true_decode_len=q["max_new_tokens"])
            for q in drawn]


# --------------------------------------------------------------------------
# the host clock
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Req:
    rid: int
    priority: int
    batch: int
    prompt_len: int
    max_new_tokens: int
    admit: Optional[float] = None
    start: Optional[float] = None        # its latest ``start``
    first: Optional[float] = None        # first token
    last: Optional[float] = None         # latest token
    done: Optional[float] = None         # ``complete`` event
    own: float = 0.0                     # its executor calls + checkpoints
    own_first: Optional[float] = None    # ``own`` at its first token
    ckpt: float = 0.0
    n_tokens: int = 0                    # tokens of its current run
    preemptions: int = 0                 # checkpoints and kills
    preempted_in_prefill: bool = False


@dataclasses.dataclass
class Step:
    kind: str                            # start | prefill | decode
    rid: int
    t0: float
    t1: float
    size: int                            # prompt length, or decode context


class Recorder:
    """Host-clock hooks on one engine at a time; the record spans the
    window's rounds."""

    def __init__(self):
        self.reqs: Dict[int, Req] = {}
        self.steps: List[Step] = []
        self.rounds: List[Tuple[float, float]] = []
        self._prompt_rid: Dict[int, int] = {}
        self._state_rid: Dict[int, int] = {}
        self._ckpt: Optional[Tuple[int, float]] = None

    def watch(self, engine, reqs) -> None:
        self._prompt_rid.clear()
        self._state_rid.clear()
        for q in reqs:
            self.reqs[q.rid] = Req(q.rid, q.priority, q.batch, q.prompt_len,
                                   q.max_new_tokens)
            self._prompt_rid[id(q.prompt)] = q.rid
        engine.events.subscribe_map({"submit": self._submit,
                                     "dispatch": self._dispatch,
                                     "preempt": self._preempt,
                                     "complete": self._complete})
        for executor in engine._executors.values():
            self._wrap(executor)

    def _submit(self, ev) -> None:
        r = self.reqs[ev.tid]
        if r.admit is None:
            r.admit = now()

    def _dispatch(self, ev) -> None:
        self._close_ckpt(now())

    def _preempt(self, ev) -> None:
        r = self.reqs[ev.tid]
        r.preemptions += 1
        r.preempted_in_prefill |= r.first is None
        self._ckpt = (ev.tid, now())

    def _complete(self, ev) -> None:
        self.reqs[ev.tid].done = now()

    def _close_ckpt(self, t: float) -> None:
        if self._ckpt is not None:
            rid, t0 = self._ckpt
            self.reqs[rid].ckpt += t - t0
            self.reqs[rid].own += t - t0
            self._ckpt = None

    def _wrap(self, ex) -> None:
        start, prefill, decode = ex.start, ex.step_prefill, ex.step_decode

        def timed_start(batch):
            t0 = now()
            self._close_ckpt(t0)
            st = start(batch)
            t1 = now()
            r = self.reqs[self._prompt_rid[id(batch["tokens"])]]
            self._state_rid[id(st)] = r.rid
            r.own += t1 - t0
            r.start, r.n_tokens = t0, 0
            self.steps.append(Step("start", r.rid, t0, t1, r.prompt_len))
            return st

        def timed_prefill(st):
            r = self.reqs[self._state_rid[id(st)]]
            t0 = now()
            self._close_ckpt(t0)
            st = prefill(st)
            t1 = now()
            r.own += t1 - t0
            self.steps.append(Step("prefill", r.rid, t0, t1, r.prompt_len))
            if st.phase != "prefill":
                r.n_tokens = 1
                r.last = t1
                if r.first is None:
                    r.first, r.own_first = t1, r.own
            return st

        def timed_decode(st):
            r = self.reqs[self._state_rid[id(st)]]
            t0 = now()
            self._close_ckpt(t0)
            st = decode(st)
            t1 = now()
            r.own += t1 - t0
            self.steps.append(Step("decode", r.rid, t0, t1,
                                   r.prompt_len + r.n_tokens))
            r.n_tokens += 1
            r.last = t1
            return st

        ex.start, ex.step_prefill, ex.step_decode = (timed_start, timed_prefill,
                                                     timed_decode)


# --------------------------------------------------------------------------
# the device trace
# --------------------------------------------------------------------------
MARK_CYCLES = 20_000


@dataclasses.dataclass
class Trace:
    by_name: Dict[str, List[float]]     # kernel name -> [seconds, launches]
    busy_s: float
    window_s: float
    gaps: List[Tuple[float, str, str]]  # (seconds, host label, kernel before)
    end_host: float = float("inf")      # the traced steps end by this host time

    def traced(self, steps: List[Step]) -> List[Step]:
        """The steps whose device work the trace holds."""
        return [s for s in steps if s.t1 <= self.end_host]

    def kernels(self, part: str) -> Tuple[float, int]:
        """Seconds and launches of the kernels whose name holds ``part``."""
        sec = sum(v[0] for k, v in self.by_name.items() if part in k)
        return sec, int(sum(v[1] for k, v in self.by_name.items() if part in k))


def _mark() -> int:
    """A short spin kernel launched from a synchronised host at a known
    host time: it places the device's clock against ``perf_counter``."""
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    torch.cuda._sleep(MARK_CYCLES)
    return t


def read_trace(prof, host_marks: Tuple[int, int], steps: List[Step]) -> Trace:
    """The window's device events between the two clock marks.  Where the
    profiler dropped the end of a long trace (its activity buffers are
    bounded) and the second mark with it, the traced window ends at the
    last decode step (each ends in a sync) whose end the trace still
    holds, and ``end_host`` says which steps the trace covers."""
    events = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA)
    marks = [e for e in events if "spin" in e[2]]
    if not marks or marks[0][0] > events[0][0]:
        raise RuntimeError(f"trace: the first clock mark is missing ({len(marks)} found)")
    offset = marks[0][0] - host_marks[0]
    lo, end_host = marks[0][1], float("inf")
    if len(marks) == 2:
        hi = marks[1][0]
    else:
        last = events[-1][1]
        ends = [s.t1 for s in steps
                if s.kind == "decode" and s.t1 * 1e9 + offset <= last]
        if not ends:
            raise RuntimeError("trace: the profiler kept no whole decode step")
        end_host = max(ends)
        hi = int(end_host * 1e9 + offset)
    by_name: Dict[str, List[float]] = {}
    busy, gaps, end, prev = 0, [], lo, marks[0][2]
    starts = [int(s.t0 * 1e9) for s in steps]
    for s, e, name in events:
        if s < lo or e > hi:
            continue
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (e - s) / 1e9
        acc[1] += 1
        if s > end:
            gaps.append((s - end, end, prev))
        if e > end:
            busy += e - max(s, end)
            end, prev = e, name
    if hi > end:
        gaps.append((hi - end, end, prev))

    def label(at_dev: int, length: int) -> str:
        mid = at_dev + length // 2 - offset
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= steps[i].t1 * 1e9:
            return f"host in {steps[i].kind}"
        return "host in engine"
    labelled = [(g / 1e9, label(at, g), name) for g, at, name in gaps]
    return Trace(by_name=by_name, busy_s=busy / 1e9, window_s=(hi - lo) / 1e9,
                 gaps=labelled, end_host=end_host)


def breakdown(tr: Trace) -> Dict:
    """The ten kernels that took most device time, and the idle time by
    what the host was doing, then the longest single gaps."""
    ops = sorted(tr.by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    idle: Dict[str, float] = {}
    for sec, lab, _ in tr.gaps:
        idle[lab] = idle.get(lab, 0.0) + sec
    rows = [[f"all gaps, {k}", v] for k, v in
            sorted(idle.items(), key=lambda kv: kv[1], reverse=True)]
    longest = sorted(tr.gaps, reverse=True)[:max(0, 10 - len(rows))]
    rows += [[f"one gap, {lab}, after {name[:60]}", sec]
             for sec, lab, name in longest]
    return {"device_ops": [[k[:120], v[0]] for k, v in ops[:10]],
            "idle_gaps": rows[:10]}


# --------------------------------------------------------------------------
# the window
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Window:
    """What the metric readers read."""
    workload: str
    cfg: Dict
    mix: Dict
    setup_s: float
    wall_s: float
    reqs: Dict[int, Req]
    steps: List[Step]
    rounds: List[Tuple[float, float]]
    trace: Optional[Trace]


def warm_requests(cfg: Dict, mix: Dict, seed: int, vocab: int):
    """Every size one block of the mix holds (so every shape the window
    uses), two tokens at most each (a prefill and a decode step), all
    arriving at once."""
    rng = np.random.default_rng([traffic.seed_words(seed), 4])
    drawn = [dict(rid=i, priority=s["priority"], arrival=0.0,
                  max_new_tokens=min(2, s["output_len"]),
                  prompt=rng.integers(0, vocab, (s["batch"], s["prompt_len"]),
                                      dtype=np.int64).astype(np.int32))
             for i, s in enumerate(traffic.block_sizes(mix))]
    return requests(cfg, drawn)


def serve(model, params, spec: Dict, seed: int, seconds: float,
          rec: Recorder) -> Tuple[list, Dict, list]:
    """Rounds until ``seconds`` have passed; returns the results, the
    requests by rid and each round's virtual-clock ``summary()``."""
    cfg, mix, cell = spec["cfg"], spec["mix"], spec["cell"]
    results, by_rid, virtual = [], {}, []
    begin, r = now(), 0
    while True:
        reqs = requests(cfg, traffic.round_requests(mix, cell, seed, r,
                                                    cfg["vocab_size"]))
        t0 = now()
        engine = new_engine(model, params)
        rec.watch(engine, reqs)
        results += engine.run(reqs)
        t1 = now()
        rec.rounds.append((t0, t1))
        by_rid.update((q.rid, q) for q in reqs)
        virtual.append(engine.summary())
        del engine
        r += 1
        if t1 - begin >= seconds:
            return results, by_rid, virtual


def check(w: Dict[str, torch.Tensor], cfg: Dict, results: list, by_rid: Dict,
          seed: int, want_tokens: int, device, fp8: bool = False) -> Dict:
    """The widest gap by which a served token's logit lies below the
    reference's best, over a sample drawn from the seed of the finished
    requests, the longest among them, of at least ``want_tokens`` served
    tokens.  With ``fp8`` also the control's reading on the same prompts
    and tokens: the gap of the token the fp8 forward puts first."""
    done = sorted(results, key=lambda res: res.rid)
    if not done:
        return dict(widest_gap=float("inf"), tokens=0, requests=0)
    size = [by_rid[res.rid].prompt_len + res.tokens.shape[1] for res in done]
    longest = int(np.argmax(size))
    chosen, n = [longest], done[longest].tokens.size
    for i in np.random.default_rng([traffic.seed_words(seed), 3]).permutation(len(done)):
        if n >= want_tokens:
            break
        if i != longest:
            chosen.append(int(i))
            n += done[i].tokens.size
    widest, control, compared = 0.0, 0.0, 0
    for i in chosen:
        res = done[i]
        prompt = by_rid[res.rid].prompt
        for b in range(res.tokens.shape[0]):
            served = torch.as_tensor(res.tokens[b], device=device)
            seq = torch.cat([torch.as_tensor(prompt[b], device=device),
                             served[:-1]])
            rows = range(prompt.shape[1] - 1, seq.numel())
            ref = reference.logits_at(cfg, w, seq, rows)
            widest = max(widest, float(reference.gaps(ref, served).max()))
            compared += served.numel()
            if fp8:
                low = reference.logits_at(cfg, w, seq, rows, fp8=True)
                control = max(control, float(reference.gaps(
                    ref, low.argmax(dim=-1)).max()))
            del ref
    out = dict(widest_gap=widest, tokens=compared, requests=len(chosen))
    if fp8:
        out["control_gap"] = control
    return out


def hi_ttft_quantiles(reqs: Dict[int, Req]) -> Dict[str, float]:
    """Where the priority-9 time to first token lies (info line only)."""
    ttft = [(r.first - r.admit) * 1e3 for r in reqs.values()
            if r.priority == 9 and r.first is not None]
    if not ttft:
        return {}
    return {f"p{q}": yardstick.percentile(ttft, q)
            for q in (10, 25, 50, 75, 90, 95, 99)}


def cycle_summary(virtual: List[Dict], cell: Dict) -> Dict[str, float]:
    """The engine's ``summary()`` on its virtual clock, each key's mean
    over the first ``cycle_rounds`` rounds: one whole cycle of the seed's
    stream, which holds the same rounds for every seed, so the reading
    depends on the engine's scheduling code, its frozen hardware model and
    the mix alone.  A window of fewer rounds gives the mean over all of
    them.  ``bench/test_bench_sched_antt.py`` holds its ``antt``."""
    rounds = virtual[:cell.get("cycle_rounds", len(virtual))]
    return {k: math.fsum(v[k] for v in rounds) / len(rounds)
            for k in rounds[0]}


def card_line() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device="cuda", spec: Optional[Dict] = None,
             bm: Optional[Dict] = None, log=sys.stderr) -> Dict:
    """Set-up, window, check and metrics of one run: the result's line."""
    bm = bm if bm is not None else load_benchmark()
    spec = spec if spec is not None else resolve(bm, workload)
    cfg, mix, cell = spec["cfg"], spec["mix"], spec["cell"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    t_entry = now()
    model = build_model(cfg)
    w = draw_weights(cfg, seed, dev)
    params = port_params(cfg, w)
    sync()
    t_weights = now()
    # the warm round: every shape of the mix once, the kernels built
    new_engine(model, params).run(warm_requests(cfg, mix, seed,
                                                cfg["vocab_size"]))
    sync()
    t_warm = now()
    rec = Recorder()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        mark0 = _mark()
    t_begin = now()
    setup_s = t_begin - t_process
    results, by_rid, virtual = serve(model, params, spec, seed, seconds, rec)
    sync()
    wall_s = rec.rounds[-1][1] - rec.rounds[0][0]
    tr = None
    if trace:
        mark1 = _mark()
        sync()
        t0 = now()
        prof.stop()
        stop_s = now() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace_s = 0.0
    if trace:
        t0 = now()
        tr = read_trace(prof, (mark0, mark1), rec.steps)
        del prof
        trace_s = now() - t0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    attempted = len(by_rid)
    unfinished = attempted - len(results)
    wrong_length = sum(res.tokens.shape[1] != by_rid[res.rid].max_new_tokens
                       for res in results)
    t0 = now()
    got = check(w, cfg, results, by_rid, seed, cell["check_tokens"], dev)
    check_s = now() - t0
    compared = {"widest_gap": {"value": got["widest_gap"],
                               "limit": cell["gap_limit"]},
                "unfinished": {"value": unfinished, "limit": 0},
                "wrong_length": {"value": wrong_length, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    window = Window(workload=workload, cfg=cfg, mix=mix, setup_s=setup_s,
                    wall_s=wall_s, reqs=rec.reqs, steps=rec.steps,
                    rounds=rec.rounds, trace=tr)
    metrics = {}
    for m in cell_metrics(bm, workload, trace):
        value = reader(m["name"])(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(json.dumps({"virtual_clock_summary": cycle_summary(virtual, cell),
                      "rounds": len(virtual),
                      "note": "engine summary() on the virtual clock of the "
                              "frozen H100 model, averaged over the first "
                              "cycle_rounds rounds; not measured time"}),
          flush=True)
    print(json.dumps({"check": dict(got, seconds=check_s),
                      "requests": attempted,
                      "priority9": sum(r.priority == 9 for r in rec.reqs.values()),
                      "hi_ttft_ms_quantiles": hi_ttft_quantiles(rec.reqs),
                      "preemptions": sum(r.preemptions for r in rec.reqs.values()),
                      "window_s": wall_s, "trace_read_s": trace_s,
                      "trace_stop_s": stop_s if trace else 0.0,
                      "card": card_line() if cuda else None,
                      "setup_parts_s": {"to_entry": t_entry - t_process,
                                        "weights": t_weights - t_entry,
                                        "warm_round": t_warm - t_weights}}),
          flush=True)
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": unfinished, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = breakdown(tr)
    line["compared"] = compared
    for name, c in compared.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=log, flush=True)
    return line
