# Copied from src/repro/serving/engine.py; `repro.` rewritten to `repro_torch.`.
"""Multi-tenant serving engine: PREMA scheduling over real JAX execution.

The engine advances a *virtual clock* using the Algorithm-1 predicted cost
of each executed step (this container has no TPU; on hardware the same loop
uses measured step times), while the tensors themselves are computed for
real by :class:`PreemptibleExecutor` — so scheduling behavior and model
outputs are both exact and testable.

Scheduling decisions (policy wake-up, candidate selection,
``Policy.may_preempt``, Algorithm-3 mechanism choice, KILL progress
guarantee) are delegated to the shared scheduling core in
``core/arbiter.py`` — the same :class:`~repro_torch.core.arbiter.Arbiter` that
drives the virtual-clock simulators (``core/simulator.py``,
``core/cluster.py``).  This module only executes the decision on real
tensor state: preemption points are step boundaries (super-block period
during prefill, token during decode); the scheduler re-evaluates at every
boundary and at request arrivals — the continuous-time analogue of the
paper's 0.25 ms scheduling period.

``n_devices > 1`` runs the engine as a cluster: one global ready queue,
per-device running slots and virtual clocks, per-device KV pools, and a
pluggable placement policy (``core/cluster.py``); resuming a checkpointed
request on a different device pays the cross-chip
:func:`~repro_torch.core.preemption.migration_latency` and moves its KV
residency, which the ``affinity`` placement exists to avoid.

Mechanisms follow §IV: CHECKPOINT holds the ExecState (KV/SSM cache stays
HBM-resident; under memory pressure the KVCacheManager offloads to host and
charges the un-hidable PCIe time), KILL discards it, DRAIN lets the running
request finish.

A ``straggler_factor`` hook perturbs realized step times (fault injection);
the predictive scheduler observes only predictions, so tests can verify
PREMA's robustness to mispredicted/straggling steps.
"""
from __future__ import annotations

import dataclasses
import heapq
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import arch_ops, metrics, preemption
from repro_torch.core import events as events_mod
from repro_torch.core.arbiter import Action, Arbiter
from repro_torch.core.cluster import Cluster, ClusterConfig, role_accepts
from repro_torch.core.predictor import (LengthRegressor, Predictor,
                                  network_time)
from repro_torch.core.preemption import Mechanism
from repro_torch.core.scheduler import SCHED_QUANTUM, Policy, make_policy
from repro_torch.core.task import Task, TaskState
from repro_torch.hw import H100, HardwareModel
from repro_torch.models.registry import Model
from repro_torch.serving.executor import ExecState, PreemptibleExecutor
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.request import InferenceRequest, RequestResult


@dataclasses.dataclass
class EngineConfig(ClusterConfig):
    """Everything a :class:`ServingEngine` is configured by, as one
    config object — the top of the ``SimConfig`` → ``ClusterConfig`` →
    ``EngineConfig`` hierarchy.

    Inherits the scheduling knobs (``mechanism``, ``admission``,
    ``kill_early_frac``/``max_kills``) and the cluster knobs
    (``n_devices``, ``placement``, ``device_hw``, ``provision_latency``)
    and adds the serving-only ones below.  Construct engines as
    ``ServingEngine(models, cfg=EngineConfig(...))``; the historical
    flat-kwarg constructor still works through a deprecation shim that
    forwards into this config (bit-identical — pinned by
    tests/test_engine_config.py).
    """

    hw: HardwareModel = H100
    policy: Union[str, Policy] = "prema"
    # None = the policy's own flag (string policies default preemptive).
    preemptive: Optional[bool] = None
    kv_capacity_bytes: Optional[int] = None
    straggler_factor: Optional[Callable[[int, int], float]] = None
    execute: bool = True
    batch_slots: int = 1
    chunked_prefill: bool = True
    device_roles: Optional[List[str]] = None
    batch_overhead: float = 0.15


_UNSET = object()          # marks legacy kwargs the caller actually passed

# Legacy flat-kwarg constructor parameters, in their historical
# positional order; each maps 1:1 onto an EngineConfig field.
_LEGACY_KWARGS = (
    "hw", "policy", "preemptive", "mechanism", "kv_capacity_bytes",
    "straggler_factor", "execute", "n_devices", "placement", "admission",
    "device_hw", "provision_latency", "batch_slots", "chunked_prefill",
    "device_roles", "batch_overhead")


@dataclasses.dataclass
class _Job:
    req: InferenceRequest
    task: Task                       # scheduler-visible context-table entry
    executor: PreemptibleExecutor
    state: Optional[ExecState] = None
    prefill_step_time: float = 0.0
    decode_step_time: float = 0.0
    first_token_time: Optional[float] = None
    result: Optional[RequestResult] = None


class _ReadyJobs:
    """Global ready queue keeping the policy-visible Task list in sync
    with the job list, so every pick() stops rebuilding an O(n) list and
    the selected Task maps back to its job in O(1)."""
    __slots__ = ("jobs", "tasks", "_by_task")

    def __init__(self):
        self.jobs: List[_Job] = []
        self.tasks: List[Task] = []
        self._by_task: Dict[int, _Job] = {}

    def __len__(self) -> int:
        return len(self.jobs)

    def append(self, j: _Job) -> None:
        self.jobs.append(j)
        self.tasks.append(j.task)
        self._by_task[id(j.task)] = j

    def remove(self, j: _Job) -> None:
        i = self.jobs.index(j)
        del self.jobs[i]
        del self.tasks[i]
        del self._by_task[id(j.task)]

    def job_for(self, task: Task) -> _Job:
        return self._by_task[id(task)]


class ServingEngine:
    def __init__(self,
                 models: Dict[str, Tuple[Model, dict]],
                 hw=_UNSET,
                 policy=_UNSET,
                 preemptive=_UNSET,
                 mechanism=_UNSET,
                 kv_capacity_bytes=_UNSET,
                 straggler_factor=_UNSET,
                 execute=_UNSET,
                 n_devices=_UNSET,
                 placement=_UNSET,
                 admission=_UNSET,
                 device_hw=_UNSET,
                 provision_latency=_UNSET,
                 batch_slots=_UNSET,
                 chunked_prefill=_UNSET,
                 device_roles=_UNSET,
                 batch_overhead=_UNSET,
                 cfg: Optional[EngineConfig] = None):
        """``models``: name → (Model, params).  ``cfg`` carries every
        other knob (:class:`EngineConfig`); the flat kwargs are the
        deprecated pre-config constructor — still honored, forwarded
        into an ``EngineConfig`` with a ``DeprecationWarning``, and
        mutually exclusive with ``cfg``.  ``policy`` is a name or a
        :class:`Policy` instance; ``preemptive`` overrides the policy's
        flag when given (string policies default to preemptive).
        ``execute=False`` runs the engine in pure virtual-time mode (no
        tensor computation) for large-scale scheduling studies.
        ``n_devices``/``placement`` scale the engine to a multi-NPU
        cluster (see module docstring); ``device_hw`` gives each device
        its own :class:`HardwareModel` (heterogeneous clusters — step
        times dilate by the device's Algorithm-1 relative speed; it
        overrides ``n_devices``).  ``provision_latency`` delays mid-run
        ``add_device`` joins.  ``admission`` is an optional
        :class:`repro_torch.workloads.admission.AdmissionPolicy`: rejected
        requests are DROPPED at ingest (a ``drop`` event fires, no tensors
        run) and appear in per-tenant accounting as ``n_rejected``.

        ``batch_slots > 1`` or ``device_roles`` switches the engine to
        the continuous-batching loop (:meth:`_run_batched`): each device
        holds up to ``batch_slots`` co-resident requests and advances all
        of them one step per iteration, Orca/vLLM-style.
        ``device_roles`` splits the cluster into disaggregated
        prefill/decode pools (one entry per device, ``"prefill"`` /
        ``"decode"`` / ``"any"``); a sequence finishing prefill on a
        prefill-pool device hands its KV over the interconnect to the
        decode pool.  ``chunked_prefill=False`` runs each prompt as one
        monolithic step (the whole remaining prefill blocks the
        iteration); ``True`` (default) advances prefill one period per
        iteration so long prompts never stall co-resident decodes.
        ``batch_overhead`` is the per-extra-resident iteration-time
        inflation (batching is not free: an iteration with ``B``
        residents costs ``(1 + batch_overhead*(B-1)) * max(step_i)``).
        The default single-slot configuration is bit-identical to the
        non-batched loop (tests/test_fastpath_parity.py)."""
        passed = {name: value for name, value in zip(_LEGACY_KWARGS, (
            hw, policy, preemptive, mechanism, kv_capacity_bytes,
            straggler_factor, execute, n_devices, placement, admission,
            device_hw, provision_latency, batch_slots, chunked_prefill,
            device_roles, batch_overhead)) if value is not _UNSET}
        if passed:
            if cfg is not None:
                raise TypeError(
                    "pass either cfg=EngineConfig(...) or the deprecated "
                    f"flat kwargs, not both: {sorted(passed)}")
            warnings.warn(
                f"ServingEngine({', '.join(sorted(passed))}) flat kwargs "
                "are deprecated; pass cfg=EngineConfig(...) instead",
                DeprecationWarning, stacklevel=2)
            cfg = EngineConfig(**passed)
        elif cfg is None:
            cfg = EngineConfig()
        self.cfg = cfg
        hw, policy, preemptive = cfg.hw, cfg.policy, cfg.preemptive
        mechanism, admission = cfg.mechanism, cfg.admission
        kv_capacity_bytes = cfg.kv_capacity_bytes
        straggler_factor, execute = cfg.straggler_factor, cfg.execute
        n_devices, placement = cfg.n_devices, cfg.placement
        device_hw, provision_latency = cfg.device_hw, cfg.provision_latency
        batch_slots, chunked_prefill = cfg.batch_slots, cfg.chunked_prefill
        device_roles, batch_overhead = cfg.device_roles, cfg.batch_overhead
        self.hw = hw
        if isinstance(policy, Policy):
            self.policy = policy
            if preemptive is not None:
                self.policy.preemptive = preemptive
        else:
            self.policy = make_policy(
                policy, preemptive=True if preemptive is None else preemptive)
        self.mechanism = mechanism
        self.arbiter = Arbiter(self.policy, cfg.arbiter_config())
        self.admission = admission
        self.placement = placement
        self.device_hw = list(device_hw) if device_hw else None
        self.provision_latency = float(provision_latency)
        self.batch_slots = int(batch_slots)
        self.chunked_prefill = bool(chunked_prefill)
        self.batch_overhead = float(batch_overhead)
        self.device_roles = list(device_roles) if device_roles else None
        self.batched = self.batch_slots > 1 or self.device_roles is not None
        if self.batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if self.device_roles is not None and not any(
                role_accepts(r, "prefill") for r in self.device_roles):
            raise ValueError("device_roles has no prefill-capable device "
                             "(every request starts with a prefill phase)")
        self.cluster = Cluster(int(n_devices), placement, base_hw=hw,
                               device_hw=self.device_hw,
                               device_roles=self.device_roles,
                               batch_slots=self.batch_slots)
        self.n_devices = self.cluster.n_devices
        self.execute = execute
        self.straggler_factor = straggler_factor
        self._executors: Dict[str, PreemptibleExecutor] = {}
        self._models = models
        for name, (model, params) in models.items():
            self._executors[name] = PreemptibleExecutor(model, params)
        self.predictor = Predictor(hw)
        self._kv_capacity = kv_capacity_bytes or hw.hbm_bytes
        self.kvs = [KVCacheManager(self._kv_capacity)
                    for _ in range(self.n_devices)]
        self.kv = self.kvs[0]        # back-compat alias (device 0)
        self._length_reg: Dict[str, LengthRegressor] = {}
        self.completed: List[RequestResult] = []
        self.tasks: List[Task] = []
        self._inject = None          # live only inside run()
        self._elastic = None         # (add, drain) hooks inside run()

    @property
    def events(self):
        """The shared event bus (core/events.py); subscribe before run()."""
        return self.arbiter.events

    def submit(self, req: InferenceRequest, at: float) -> None:
        """Inject a request mid-run (closed-loop clients); only valid from
        an event hook while ``run()`` is executing."""
        if self._inject is None:
            raise RuntimeError("submit() is only valid during run() — "
                               "call it from an event-bus hook")
        self._inject(req, at)

    # ---- elastic capacity (valid during run(), from event hooks) -----
    def _elastic_hooks(self):
        if self._elastic is None:
            raise RuntimeError("elastic capacity changes are only valid "
                               "during run() — call from an event-bus hook")
        return self._elastic

    def add_device(self, hw: Optional[HardwareModel] = None,
                   role: str = "any") -> int:
        """Scale up: join a device (schedulable after
        ``provision_latency``); returns its index.  ``role`` assigns it
        to a prefill/decode pool on the batched path."""
        return self._elastic_hooks()[0](hw, role)

    def drain_device(self, dev: int) -> None:
        """Stop placing on ``dev``; residents are checkpoint-migrated
        away at their next step boundary."""
        self._elastic_hooks()[1](dev, False)

    def remove_device(self, dev: int) -> None:
        """Scale down: drain ``dev`` and retire it once idle."""
        self._elastic_hooks()[1](dev, True)

    # ---- failures (valid during run(), from event hooks) -------------
    def fail_device(self, dev: int) -> None:
        """Crash ``dev`` now.  Its resident loses the device-resident
        tensor state and restarts KILL-style (``execute=False`` restores
        from the last durable checkpoint instead); the device contributes
        zero capacity until :meth:`recover_device`."""
        self._elastic_hooks()[2](dev)

    def recover_device(self, dev: int) -> None:
        """Repair a device crashed with :meth:`fail_device`."""
        self._elastic_hooks()[3](dev)

    @property
    def n_alive_devices(self) -> int:
        return self.cluster.n_alive

    # ------------------------------------------------------------------
    def fit_length_regressor(self, arch: str,
                             pairs: List[Tuple[int, int]]) -> None:
        """Profile-driven decode-length LUT for an architecture (§V-B)."""
        self._length_reg[arch] = LengthRegressor().fit(pairs)

    def _predict_decode_len(self, req: InferenceRequest) -> float:
        reg = self._length_reg.get(req.arch)
        if reg is not None:
            return reg.predict(req.prompt_len)
        return float(req.max_new_tokens)

    # ------------------------------------------------------------------
    def _make_job(self, req: InferenceRequest) -> _Job:
        model, _ = self._models[req.arch]
        cfg = model.cfg
        pre_ops = arch_ops.prefill_ops(cfg, req.prompt_len, req.batch)
        dec_ops = arch_ops.decode_step_ops(cfg, req.prompt_len, req.batch)
        prefill_total = network_time(pre_ops, self.hw)
        decode_step = network_time(dec_ops, self.hw) if not cfg.encoder_only else 0.0
        prefill_step = prefill_total / cfg.n_periods

        true_dec = 0
        if not cfg.encoder_only:
            true_dec = (req.true_decode_len if req.true_decode_len is not None
                        else req.max_new_tokens)
            true_dec = min(true_dec, req.max_new_tokens)
            true_dec = max(1, true_dec)
        pred_dec = 0.0 if cfg.encoder_only else min(
            float(req.max_new_tokens), self._predict_decode_len(req))

        node_times = np.asarray(
            [prefill_step] * cfg.n_periods
            + [decode_step] * max(0, true_dec - 1))
        act_bytes = req.batch * req.prompt_len * cfg.d_model * 2
        node_out_bytes = np.full(len(node_times), act_bytes, dtype=np.int64)
        predicted_total = prefill_total + decode_step * max(0.0, pred_dec - 1)

        task = Task(tid=req.rid, model=req.arch, priority=req.priority,
                    arrival=req.arrival, batch=req.batch,
                    node_times=node_times, node_out_bytes=node_out_bytes,
                    predicted_total=predicted_total, in_len=req.prompt_len,
                    tenant=req.tenant, sla_scale=req.sla_scale)
        return _Job(req=req, task=task, executor=self._executors[req.arch],
                    prefill_step_time=prefill_step,
                    decode_step_time=decode_step)

    def _batch_dict(self, req: InferenceRequest) -> dict:
        model, _ = self._models[req.arch]
        cfg = model.cfg
        batch = {}
        if cfg.embedding_inputs:
            batch["frames"] = req.frames
        else:
            batch["tokens"] = req.prompt
        if cfg.img_tokens:
            batch["img_embeds"] = req.img_embeds
        return batch

    # ------------------------------------------------------------------
    def run(self, requests: List[InferenceRequest]) -> List[RequestResult]:
        """``requests`` may be a prebuilt request list or a serving-kind
        :class:`repro_torch.workloads.Trace` (payloads synthesized per record)."""
        if hasattr(requests, "records"):     # workloads.Trace (duck-typed)
            from repro_torch.workloads.serving_adapter import to_requests
            requests = to_requests(requests, self._models)
        if self.batched:
            return self._run_batched(requests)
        jobs = {r.rid: self._make_job(r) for r in requests}
        arrivals = [(r.arrival, r.rid) for r in requests]
        heapq.heapify(arrivals)
        bus, admission = self.arbiter.events, self.admission
        self.arbiter.reset()
        bus.clear()
        if admission is not None:
            admission.reset()
        self.cluster = Cluster(self.n_devices, self.placement,
                               base_hw=self.hw, device_hw=self.device_hw)
        self._run_tasks: List[Task] = []   # this run only (cluster metrics)
        devices = self.cluster.devices     # grown in place by add_device
        dev_clock = [0.0] * len(devices)
        running: List[Optional[_Job]] = [None] * len(devices)
        del self.kvs[len(devices):]
        while len(self.kvs) < len(devices):
            self.kvs.append(KVCacheManager(self._kv_capacity))
        ready = _ReadyJobs()
        clock = 0.0                        # last observed sim time (hooks)
        # settled logical requests this run (rid-keyed: a request that is
        # dropped, retried, and later completed settles exactly once)
        settled_rids: set = set()
        recorded: set = set()              # rids appended to self.tasks

        def record(j: _Job) -> None:
            if j.req.rid not in recorded:
                recorded.add(j.req.rid)
                self.tasks.append(j.task)

        def inject(req: InferenceRequest, at: float):
            req.arrival = float(at)
            j = jobs.get(req.rid)
            if j is not None and j.req is req:
                # re-offer of the same logical request (client retry):
                # keep its Task — attempt counters and admission
                # accounting stay exact (one task, many attempts)
                j.task.arrival = req.arrival
                j.task.n_retries = int(req.n_retries)
                if req.first_offer is not None:
                    j.task.first_offer = float(req.first_offer)
                settled_rids.discard(req.rid)
            else:
                if j is not None:
                    recorded.discard(req.rid)  # rid reuse: new logical task
                    settled_rids.discard(req.rid)
                jobs[req.rid] = self._make_job(req)
            heapq.heappush(arrivals, (req.arrival, req.rid))
        self._inject = inject

        def settle_drain(dev: int, at: float):
            nonlocal clock
            d = devices[dev]
            if d.remove_pending and d.alive and d.running is None:
                clock = max(clock, at)
                self.cluster.remove_device(dev, at)
                bus.device_down(at, dev)

        def add_dev(hw_: Optional[HardwareModel], role: str = "any") -> int:
            d = self.cluster.add_device(
                clock, hw=hw_, provision_latency=self.provision_latency,
                role=role)
            dev_clock.append(d.alive_since)
            running.append(None)
            while len(self.kvs) < len(devices):
                self.kvs.append(KVCacheManager(self._kv_capacity))
            bus.device_up(clock, d.dev)
            return d.dev

        def drain_dev(dev: int, remove: bool) -> None:
            d = devices[dev]
            if not d.alive or (d.draining and not remove):
                return
            if not d.draining:
                d.draining = True
                bus.device_drain(clock, dev)
            d.remove_pending = d.remove_pending or remove
            settle_drain(dev, clock)

        def ingest(now):
            while arrivals and arrivals[0][0] <= now + 1e-15:
                at, rid = heapq.heappop(arrivals)
                j = jobs[rid]
                if at + 1e-15 < j.req.arrival or rid in settled_rids:
                    continue   # stale entry from a superseded attempt
                if not events_mod.offer(bus, admission, j.task, at,
                                        len(ready)):
                    if jobs[rid].req.arrival > at + 1e-15:
                        continue   # a drop hook already re-offered it
                    j.task.state = TaskState.DROPPED
                    j.task.abandoned = bool(j.req.abandoned)
                    record(j)
                    settled_rids.add(rid)
                    continue
                j.task.state = TaskState.WAITING
                j.task.last_wake = j.req.arrival
                ready.append(j)

        def pick(d: int) -> Optional[_Job]:
            ts = ready.tasks
            now = dev_clock[d]
            self.arbiter.wake(ts, now)
            run_t = running[d].task if running[d] else None
            sel = self.arbiter.pick(ts, now, run_t)
            if sel is None:
                return None
            return ready.job_for(sel)

        def dev_hw(d: int) -> HardwareModel:
            return devices[d].hw if devices[d].hw is not None else self.hw

        def begin(d: int, j: _Job):
            nonlocal clock
            t = j.task
            now = dev_clock[d]
            clock = max(clock, now)
            if t.restore_pending:
                lat = preemption.restore_latency(t, dev_hw(d))
                if t.device is not None and t.device != d:
                    # checkpoint + KV residency live on another chip
                    lat += preemption.migration_latency(t, dev_hw(d))
                    self.cluster.n_migrations += 1
                    self.kvs[t.device].release(j.req.rid)
                    nbytes = (j.state.cache_bytes()
                              if self.execute and j.state is not None else 0)
                    lat += self.kvs[d].register(j.req.rid, nbytes, now)
                else:
                    lat += self.kvs[d].touch(j.req.rid, now)
                t.checkpoint_overhead += lat
                t.restore_pending = False
                dev_clock[d] += lat
                if self.execute and j.state is not None:
                    j.state = PreemptibleExecutor.restore(j.state)
            if j.state is None and self.execute:
                j.state = j.executor.start(self._batch_dict(j.req))
                self.kvs[d].register(j.req.rid, 0, dev_clock[d])
            t.state = TaskState.RUNNING
            t.device = d
            devices[d].running = t
            devices[d].last_model = t.model
            if t.first_service is None:
                t.first_service = dev_clock[d]
            running[d] = j
            # emitted only after the job is fully installed, so a hook
            # that crashes this device (fail_device) evicts a consistent
            # resident instead of racing half-initialized state
            bus.dispatch(now, t, d)

        def do_checkpoint(d: int, j: _Job):
            t = j.task
            lat = preemption.checkpoint_latency(t, dev_hw(d))
            if self.execute and j.state is not None:
                j.state = PreemptibleExecutor.checkpoint(j.state)
                lat += self.kvs[d].resize(j.req.rid, j.state.cache_bytes(),
                                          dev_clock[d])
            t.checkpoint_overhead += lat
            t.ckpt_executed = t.executed   # durable snapshot
            t.restore_pending = True
            t.n_preemptions += 1
            t.state = TaskState.PREEMPTED
            dev_clock[d] += lat

        def do_kill(d: int, j: _Job):
            j.state = None
            self.kvs[d].release(j.req.rid)
            # everything since the last restart-from-zero is redone work
            j.task.lost_work += j.task.executed
            j.task.reset_progress()
            j.task.n_kills += 1
            j.task.state = TaskState.WAITING

        def complete(d: int, j: _Job):
            nonlocal clock
            t = j.task
            # the step that finished advanced this device's clock past the
            # iteration-start time; elastic hooks fired off the complete
            # event must see the post-step instant, not a stale one
            clock = t_done = dev_clock[d]
            t.executed = t.isolated_time
            t.completion = t_done
            t.state = TaskState.DONE
            self.kvs[d].release(j.req.rid)
            toks = (np.stack(j.state.tokens_out, axis=1)
                    if self.execute and j.state and j.state.tokens_out
                    else np.zeros((j.req.batch, 0), np.int32))
            n_dec = (0 if self._models[j.req.arch][0].cfg.encoder_only
                     else t.total_nodes - j.executor.n_periods + 1)
            j.result = RequestResult(
                rid=j.req.rid, arch=j.req.arch, tokens=toks,
                arrival=j.req.arrival,
                first_token_time=(j.first_token_time
                                  if j.first_token_time is not None else t_done),
                completion=t_done, isolated_time=t.isolated_time,
                n_preemptions=t.n_preemptions, n_kills=t.n_kills,
                ckpt_overhead=t.checkpoint_overhead, priority=j.req.priority,
                sla_target=j.req.sla_scale * t.isolated_time,
                tenant=j.req.tenant, n_decoded=n_dec)
            self.completed.append(j.result)
            record(j)
            settled_rids.add(j.req.rid)
            self._run_tasks.append(t)
            running[d] = None
            devices[d].running = None
            bus.complete(t_done, t, d)

        def exec_one_step(d: int, j: _Job):
            """Run one boundary-to-boundary step (real tensors + virtual
            clock).  Step times are predicted on the reference hardware;
            the device's wall clock advances at 1/speed of them."""
            t = j.task
            node = t.current_node()
            dt = float(t.node_times[min(node, t.total_nodes - 1)])
            if self.straggler_factor is not None:
                dt *= float(self.straggler_factor(j.req.rid, node))
            dt_wall = dt / devices[d].speed
            if self.execute:
                j.state = j.executor.step(j.state)
                if (j.first_token_time is None
                        and j.state.phase in ("decode", "done")):
                    j.first_token_time = dev_clock[d] + dt_wall
            else:
                if j.first_token_time is None and node + 1 >= j.executor.n_periods:
                    j.first_token_time = dev_clock[d] + dt_wall
            dev_clock[d] += dt_wall
            devices[d].busy_time += dt_wall
            t.executed = min(t.isolated_time, t.executed + dt)

        def step_done(j: _Job) -> bool:
            t = j.task
            if self.execute:
                st = j.state
                if st.phase == "done":
                    return True
                if st.phase == "decode":
                    if (len(st.tokens_out) >= j.req.max_new_tokens
                            or t.remaining <= 1e-15):
                        return True
                    if (j.req.eos_id is not None and
                            bool(np.all(st.tokens_out[-1] == j.req.eos_id))):
                        return True
                return False
            return t.remaining <= 1e-15

        # ---- failures (crash = KILL-style restart: the device's tensor
        # state is gone; in virtual mode a durable checkpoint restores) --
        def fail_dev(dev: int) -> None:
            d = devices[dev]
            if not d.alive or d.failed:
                return
            j = running[dev]
            if j is not None:
                t = j.task
                t.lost_work += max(0.0, t.executed - t.ckpt_executed)
                t.n_crashes += 1
                self.kvs[dev].release(j.req.rid)   # HBM content is gone
                if not self.execute and t.ckpt_executed > 0.0:
                    # virtual mode models spilled snapshots as durable
                    t.executed = t.ckpt_executed
                    t.restore_pending = True
                    t.state = TaskState.PREEMPTED
                else:
                    j.state = None
                    t.reset_progress()
                    t.state = TaskState.WAITING
                running[dev] = None
                d.running = None
                ready.append(j)
                t.last_wake = clock
            d.failed = True
            d.failed_at = clock
            self.cluster.n_failures += 1
            bus.device_fail(clock, dev)

        def recover_dev(dev: int) -> None:
            d = devices[dev]
            if not d.alive or not d.failed:
                return
            if d.failed_at is not None:
                d.downtime += max(0.0, clock - d.failed_at)
            d.failed = False
            d.failed_at = None
            dev_clock[dev] = max(dev_clock[dev], clock)
            bus.device_recover(clock, dev)
        self._elastic = (add_dev, drain_dev, fail_dev, recover_dev)

        # ---------------- main loop ----------------
        # Per-device virtual clocks; each iteration advances the device
        # with the smallest clock (running devices win ties so an idle
        # device waiting for work cannot starve progress).  Dead devices
        # drop out of the race; idle draining devices are parked.

        def selectable(i: int) -> bool:
            d = devices[i]
            return (d.alive and not d.failed
                    and (running[i] is not None or not d.draining))

        # closed-loop hooks can grow ``jobs`` mid-run; a request settles
        # exactly once (complete, or a drop with no client retry)
        try:
            while len(settled_rids) < len(jobs):
                cands = [i for i in range(len(devices)) if selectable(i)]
                assert cands, "engine has no schedulable devices left"
                d = min(cands,
                        key=lambda i: (dev_clock[i],
                                       0 if running[i] is not None else 1, i))
                now = clock = dev_clock[d]
                ingest(now)
                j = running[d]
                if j is None:
                    if not ready:
                        if arrivals:
                            dev_clock[d] = max(now, arrivals[0][0])
                        else:
                            # nothing to do on this device until another one
                            # finishes or preempts; follow the busy clocks
                            busy = [dev_clock[i] for i in cands
                                    if running[i] is not None]
                            assert busy, "engine stalled with work outstanding"
                            dev_clock[d] = max(now, min(busy))
                        continue
                    cand = pick(d)
                    if cand is None:
                        # policy abstained with a non-empty queue: advance to
                        # the next arrival, or by one scheduling quantum when
                        # there is none (anti-livelock; the old loop spun here)
                        if arrivals:
                            dev_clock[d] = max(now, arrivals[0][0])
                        else:
                            dev_clock[d] = now + SCHED_QUANTUM
                        continue
                    # among the devices free *now*, placement chooses which one
                    # takes the candidate (affinity avoids a cross-chip resume)
                    free = [devices[i] for i in range(len(devices))
                            if running[i] is None and devices[i].schedulable(now)
                            and dev_clock[i] <= now + 1e-15]
                    target = (self.cluster.choose(cand.task, free, now).dev
                              if len(free) > 1 else d)
                    ready.remove(cand)
                    dev_clock[target] = max(dev_clock[target], now)
                    begin(target, cand)
                    continue
                # a draining device gives up its resident at the step
                # boundary: checkpoint out, resume elsewhere (migration)
                if devices[d].draining:
                    bus.preempt(now, j.task, d, Mechanism.CHECKPOINT.value)
                    do_checkpoint(d, j)
                    devices[d].running = None
                    running[d] = None
                    ready.append(j)
                    j.task.last_wake = dev_clock[d]
                    settle_drain(d, dev_clock[d])
                    continue
                # at a step boundary: consider preemption, then run one step
                if ready and self.policy.preemptive:
                    cand = pick(d)
                    if cand is not None and cand is not j:
                        dec = self.arbiter.arbitrate(j.task, cand.task)
                        if dec.action is Action.PREEMPT:
                            victim = j
                            bus.preempt(dev_clock[d], victim.task, d,
                                        dec.mechanism.value)
                            if dec.mechanism is Mechanism.KILL:
                                do_kill(d, victim)
                            else:
                                do_checkpoint(d, victim)
                            devices[d].running = None
                            ready.append(victim)
                            victim.task.last_wake = dev_clock[d]
                            ready.remove(cand)
                            begin(d, cand)
                j = running[d]
                exec_one_step(d, j)
                if step_done(j):
                    complete(d, j)
                    settle_drain(d, dev_clock[d])
        finally:
            self._inject = None   # dead runs must not accept submissions
            self._elastic = None
        return self.completed

    # ------------------------------------------------------------------
    def _run_batched(self, requests: List[InferenceRequest]
                     ) -> List[RequestResult]:
        """Continuous-batching execution loop (``batch_slots > 1`` or
        pool roles configured).

        Orca/vLLM-style iteration-level scheduling: every device holds a
        vector of batch slots; one *iteration* advances every resident by
        one step (one prefill period or one decoded token), costing
        ``(1 + batch_overhead*(B-1)) * max(step_i) / speed`` wall time.
        New requests join at iteration boundaries (the arbiter STARTs
        them into a free slot, or PREEMPTs the policy's
        :meth:`~repro_torch.core.arbiter.Arbiter.slot_victim` when full).  With
        ``chunked_prefill`` a long prompt advances one period per
        iteration and never stalls co-resident decodes; without it the
        whole remaining prefill runs as one monolithic step.  Under
        disaggregated pools a sequence finishing prefill on a
        ``"prefill"``-role device is checkpointed out (KV handed over the
        interconnect, charged at restore as a migration) and re-queued
        for the decode pool.
        """
        jobs = {r.rid: self._make_job(r) for r in requests}
        arrivals = [(r.arrival, r.rid) for r in requests]
        heapq.heapify(arrivals)
        bus, admission = self.arbiter.events, self.admission
        self.arbiter.reset()
        bus.clear()
        if admission is not None:
            admission.reset()
        self.cluster = Cluster(self.n_devices, self.placement,
                               base_hw=self.hw, device_hw=self.device_hw,
                               device_roles=self.device_roles,
                               batch_slots=self.batch_slots)
        self._run_tasks: List[Task] = []
        devices = self.cluster.devices
        dev_clock = [0.0] * len(devices)
        # engine-side slot table, mirrored into DeviceState.residents so
        # cluster helpers (free_for, n_resident, drain ranking) agree
        slots: List[List[Optional[_Job]]] = [[] for _ in devices]
        del self.kvs[len(devices):]
        while len(self.kvs) < len(devices):
            self.kvs.append(KVCacheManager(self._kv_capacity))
        ready = _ReadyJobs()
        clock = 0.0
        settled_rids: set = set()
        recorded: set = set()

        # analytic KV accounting (both modes): prompt KV at admission,
        # one token's cache slice per resident per decode iteration
        dmodel = {name: m.cfg.d_model for name, (m, _) in self._models.items()}
        enc_only = {name: m.cfg.encoder_only
                    for name, (m, _) in self._models.items()}

        def tok_bytes(j: _Job) -> int:
            return j.req.batch * dmodel[j.req.arch] * 2

        def ctx_bytes(j: _Job) -> int:
            npf = j.executor.n_periods
            dec_done = max(0, j.task.current_node() - npf)
            return (j.req.batch * j.req.prompt_len * dmodel[j.req.arch] * 2
                    + dec_done * tok_bytes(j))

        def sync_phase(j: _Job) -> None:
            j.task.phase = ("prefill"
                            if j.task.current_node() < j.executor.n_periods
                            else "decode")

        def record(j: _Job) -> None:
            if j.req.rid not in recorded:
                recorded.add(j.req.rid)
                self.tasks.append(j.task)

        def inject(req: InferenceRequest, at: float):
            req.arrival = float(at)
            j = jobs.get(req.rid)
            if j is not None and j.req is req:
                j.task.arrival = req.arrival
                j.task.n_retries = int(req.n_retries)
                if req.first_offer is not None:
                    j.task.first_offer = float(req.first_offer)
                settled_rids.discard(req.rid)
            else:
                if j is not None:
                    recorded.discard(req.rid)
                    settled_rids.discard(req.rid)
                jobs[req.rid] = self._make_job(req)
            heapq.heappush(arrivals, (req.arrival, req.rid))
        self._inject = inject

        def settle_drain(dev: int, at: float):
            nonlocal clock
            d = devices[dev]
            if d.remove_pending and d.alive and d.n_resident == 0:
                clock = max(clock, at)
                self.cluster.remove_device(dev, at)
                bus.device_down(at, dev)

        def add_dev(hw_: Optional[HardwareModel], role: str = "any") -> int:
            d = self.cluster.add_device(
                clock, hw=hw_, provision_latency=self.provision_latency,
                role=role)
            dev_clock.append(d.alive_since)
            slots.append([])
            while len(self.kvs) < len(devices):
                self.kvs.append(KVCacheManager(self._kv_capacity))
            bus.device_up(clock, d.dev)
            return d.dev

        def drain_dev(dev: int, remove: bool) -> None:
            d = devices[dev]
            if not d.alive or (d.draining and not remove):
                return
            if not d.draining:
                d.draining = True
                bus.device_drain(clock, dev)
            d.remove_pending = d.remove_pending or remove
            settle_drain(dev, clock)

        def ingest(now):
            while arrivals and arrivals[0][0] <= now + 1e-15:
                at, rid = heapq.heappop(arrivals)
                j = jobs[rid]
                if at + 1e-15 < j.req.arrival or rid in settled_rids:
                    continue
                if not events_mod.offer(bus, admission, j.task, at,
                                        len(ready)):
                    if jobs[rid].req.arrival > at + 1e-15:
                        continue
                    j.task.state = TaskState.DROPPED
                    j.task.abandoned = bool(j.req.abandoned)
                    record(j)
                    settled_rids.add(rid)
                    continue
                j.task.state = TaskState.WAITING
                j.task.last_wake = j.req.arrival
                sync_phase(j)
                ready.append(j)

        def dev_hw(d: int) -> HardwareModel:
            return devices[d].hw if devices[d].hw is not None else self.hw

        def free_slot_index(di: int) -> Optional[int]:
            dv = devices[di]
            for i, r in enumerate(slots[di]):
                if r is None:
                    return i
            if len(slots[di]) < dv.batch_slots:
                return len(slots[di])
            return None

        def end_slot(di: int, si: int) -> None:
            slots[di][si] = None
            devices[di].residents[si] = None

        def begin_slot(di: int, si: int, j: _Job):
            nonlocal clock
            t = j.task
            now = dev_clock[di]
            clock = max(clock, now)
            dv = devices[di]
            if t.restore_pending:
                lat = preemption.restore_latency(t, dev_hw(di))
                if t.device is not None and t.device != di:
                    # KV lives on another chip: pay the interconnect
                    # transfer (pool hand-off or migration) and move
                    # residency
                    lat += preemption.migration_latency(t, dev_hw(di))
                    self.cluster.n_migrations += 1
                    self.kvs[t.device].release(j.req.rid)
                    lat += self.kvs[di].register(j.req.rid, ctx_bytes(j), now)
                else:
                    lat += self.kvs[di].touch(j.req.rid, now)
                t.checkpoint_overhead += lat
                t.restore_pending = False
                # simplification: the restore serializes the device's
                # iteration (every co-resident waits out the transfer)
                dev_clock[di] += lat
                if self.execute and j.state is not None:
                    j.state = PreemptibleExecutor.restore(j.state)
            else:
                dev_clock[di] += self.kvs[di].register(
                    j.req.rid, ctx_bytes(j), now)
            if j.state is None and self.execute:
                j.state = j.executor.start(self._batch_dict(j.req))
            t.state = TaskState.RUNNING
            t.device = di
            while len(slots[di]) <= si:
                slots[di].append(None)
            slots[di][si] = j
            while len(dv.residents) <= si:
                dv.residents.append(None)
            dv.residents[si] = t
            dv.last_model = t.model
            if t.first_service is None:
                t.first_service = dev_clock[di]
            bus.dispatch(now, t, di, slot=si)

        def do_checkpoint(di: int, j: _Job):
            t = j.task
            lat = preemption.checkpoint_latency(t, dev_hw(di))
            if self.execute and j.state is not None:
                j.state = PreemptibleExecutor.checkpoint(j.state)
            lat += self.kvs[di].resize(j.req.rid, ctx_bytes(j), dev_clock[di])
            t.checkpoint_overhead += lat
            t.ckpt_executed = t.executed
            t.restore_pending = True
            t.n_preemptions += 1
            t.state = TaskState.PREEMPTED
            dev_clock[di] += lat

        def do_kill(di: int, j: _Job):
            j.state = None
            self.kvs[di].release(j.req.rid)
            j.task.lost_work += j.task.executed
            j.task.reset_progress()
            j.task.n_kills += 1
            j.task.state = TaskState.WAITING
            sync_phase(j)

        def evict_slot(di: int, si: int, j: _Job, now: float) -> None:
            """Checkpoint a resident out of its slot and re-queue it."""
            bus.preempt(now, j.task, di, Mechanism.CHECKPOINT.value, slot=si)
            do_checkpoint(di, j)
            end_slot(di, si)
            ready.append(j)
            j.task.last_wake = dev_clock[di]

        def complete_slot(di: int, si: int, j: _Job):
            nonlocal clock
            t = j.task
            clock = t_done = dev_clock[di]
            t.executed = t.isolated_time
            t.completion = t_done
            t.state = TaskState.DONE
            self.kvs[di].release(j.req.rid)
            toks = (np.stack(j.state.tokens_out, axis=1)
                    if self.execute and j.state and j.state.tokens_out
                    else np.zeros((j.req.batch, 0), np.int32))
            # decoded-token count: decode nodes + the first token emitted
            # at prefill completion (0 for encoder-only architectures)
            n_dec = (0 if enc_only[j.req.arch]
                     else t.total_nodes - j.executor.n_periods + 1)
            j.result = RequestResult(
                rid=j.req.rid, arch=j.req.arch, tokens=toks,
                arrival=j.req.arrival,
                first_token_time=(j.first_token_time
                                  if j.first_token_time is not None else t_done),
                completion=t_done, isolated_time=t.isolated_time,
                n_preemptions=t.n_preemptions, n_kills=t.n_kills,
                ckpt_overhead=t.checkpoint_overhead, priority=j.req.priority,
                sla_target=j.req.sla_scale * t.isolated_time,
                tenant=j.req.tenant, n_decoded=n_dec)
            self.completed.append(j.result)
            record(j)
            settled_rids.add(j.req.rid)
            self._run_tasks.append(t)
            end_slot(di, si)
            bus.complete(t_done, t, di, slot=si)

        def try_fill(now: float) -> bool:
            """One placement pass: admit the policy's top candidate into
            a free slot anywhere in the cluster (role-compatible)."""
            if not ready:
                return False
            free = [dv for dv in devices
                    if dv.schedulable(now)
                    and dev_clock[dv.dev] <= now + 1e-15
                    and free_slot_index(dv.dev) is not None]
            if not free:
                return False
            ts = [t for t in ready.tasks
                  if any(role_accepts(dv.role, t.phase) for dv in free)]
            if not ts:
                return False
            self.arbiter.wake(ready.tasks, now)
            sel = self.arbiter.pick(ts, now, None)
            if sel is None:
                return False
            j = ready.job_for(sel)
            hosts = [dv for dv in free if role_accepts(dv.role, sel.phase)]
            target = (self.cluster.choose(sel, hosts, now)
                      if len(hosts) > 1 else hosts[0])
            ready.remove(j)
            si = free_slot_index(target.dev)
            dev_clock[target.dev] = max(dev_clock[target.dev], now)
            begin_slot(target.dev, si, j)
            return True

        def try_preempt(di: int, now: float) -> None:
            """All slots taken: let the arbiter displace the slot_victim."""
            dv = devices[di]
            res = [t for t in dv.residents if t is not None]
            ts = [t for t in ready.tasks if role_accepts(dv.role, t.phase)]
            if not ts or not res:
                return
            dec = self.arbiter.decide_batch(ts, now, res, 0)
            if dec.action is not Action.PREEMPT:
                return
            victim_t = self.arbiter.slot_victim(res)
            si = dv.residents.index(victim_t)
            vj = slots[di][si]
            bus.preempt(now, victim_t, di, dec.mechanism.value, slot=si)
            if dec.mechanism is Mechanism.KILL:
                do_kill(di, vj)
            else:
                do_checkpoint(di, vj)
            end_slot(di, si)
            ready.append(vj)
            victim_t.last_wake = dev_clock[di]
            cj = ready.job_for(dec.cand)
            ready.remove(cj)
            begin_slot(di, si, cj)

        def step_done(j: _Job) -> bool:
            t = j.task
            if self.execute:
                st = j.state
                if st.phase == "done":
                    return True
                if st.phase == "decode":
                    if (len(st.tokens_out) >= j.req.max_new_tokens
                            or t.remaining <= 1e-15):
                        return True
                    if (j.req.eos_id is not None and
                            bool(np.all(st.tokens_out[-1] == j.req.eos_id))):
                        return True
                return False
            return t.remaining <= 1e-15

        def run_iteration(di: int) -> None:
            """Advance every resident of ``di`` by one step, batched."""
            dv = devices[di]
            active = [(si, j) for si, j in enumerate(slots[di])
                      if j is not None]
            plan = []   # (slot, job, start_node, ref dt, n nodes covered)
            for si, j in active:
                t = j.task
                node = t.current_node()
                npf = j.executor.n_periods
                if node < npf and not self.chunked_prefill:
                    # monolithic prefill: the whole remaining prompt as
                    # one blocking step (what chunked prefill avoids)
                    dts = [float(t.node_times[k]) for k in range(node, npf)]
                else:
                    dts = [float(t.node_times[min(node, t.total_nodes - 1)])]
                if self.straggler_factor is not None:
                    dts = [dt * float(self.straggler_factor(j.req.rid,
                                                            node + k))
                           for k, dt in enumerate(dts)]
                plan.append((si, j, node, sum(dts), len(dts)))
            B = len(plan)
            iter_ref = (max(p[3] for p in plan)
                        * (1.0 + self.batch_overhead * (B - 1)))
            wall = iter_ref / dv.speed
            t_end = dev_clock[di] + wall
            kv_lat = 0.0
            for si, j, node, dt, nsteps in plan:
                t = j.task
                npf = j.executor.n_periods
                if self.execute:
                    for _ in range(nsteps):
                        j.state = j.executor.step(j.state)
                    if (j.first_token_time is None
                            and j.state.phase in ("decode", "done")):
                        j.first_token_time = t_end
                elif (j.first_token_time is None
                        and node + nsteps >= npf):
                    j.first_token_time = t_end
                t.executed = min(t.isolated_time, t.executed + dt)
                if node >= npf:       # decode: KV grows one token slice
                    kv_lat += self.kvs[di].grow(j.req.rid, tok_bytes(j),
                                                t_end)
                sync_phase(j)
            dev_clock[di] = t_end + kv_lat
            dv.busy_time += wall
            for si, j, node, dt, nsteps in plan:
                if step_done(j):
                    complete_slot(di, si, j)
                elif dv.role == "prefill" and j.task.phase == "decode":
                    # pool hand-off: prefill done, the decode pool takes
                    # over (KV crosses the interconnect at restore; not a
                    # scheduler preemption, so n_preemptions stays put)
                    t = j.task
                    bus.preempt(dev_clock[di], t, di,
                                Mechanism.CHECKPOINT.value, slot=si)
                    t.ckpt_executed = t.executed
                    t.restore_pending = True
                    t.state = TaskState.PREEMPTED
                    end_slot(di, si)
                    ready.append(j)
                    t.last_wake = dev_clock[di]
            settle_drain(di, dev_clock[di])

        def fail_dev(dev: int) -> None:
            d = devices[dev]
            if not d.alive or d.failed:
                return
            for si, j in [(si, j) for si, j in enumerate(slots[dev])
                          if j is not None]:
                t = j.task
                t.lost_work += max(0.0, t.executed - t.ckpt_executed)
                t.n_crashes += 1
                self.kvs[dev].release(j.req.rid)
                if not self.execute and t.ckpt_executed > 0.0:
                    t.executed = t.ckpt_executed
                    t.restore_pending = True
                    t.state = TaskState.PREEMPTED
                else:
                    j.state = None
                    t.reset_progress()
                    t.state = TaskState.WAITING
                sync_phase(j)
                end_slot(dev, si)
                ready.append(j)
                t.last_wake = clock
            d.failed = True
            d.failed_at = clock
            self.cluster.n_failures += 1
            bus.device_fail(clock, dev)

        def recover_dev(dev: int) -> None:
            d = devices[dev]
            if not d.alive or not d.failed:
                return
            if d.failed_at is not None:
                d.downtime += max(0.0, clock - d.failed_at)
            d.failed = False
            d.failed_at = None
            dev_clock[dev] = max(dev_clock[dev], clock)
            bus.device_recover(clock, dev)
        self._elastic = (add_dev, drain_dev, fail_dev, recover_dev)

        def selectable(i: int) -> bool:
            d = devices[i]
            return (d.alive and not d.failed
                    and (d.n_resident > 0 or not d.draining))

        try:
            while len(settled_rids) < len(jobs):
                cands = [i for i in range(len(devices)) if selectable(i)]
                assert cands, "engine has no schedulable devices left"
                d = min(cands,
                        key=lambda i: (dev_clock[i],
                                       0 if devices[i].n_resident else 1, i))
                now = clock = dev_clock[d]
                ingest(now)
                if devices[d].draining and devices[d].n_resident:
                    # iteration boundary on a draining device: every
                    # resident checkpoints out and resumes elsewhere
                    for si, j in [(si, j) for si, j in enumerate(slots[d])
                                  if j is not None]:
                        evict_slot(d, si, j, now)
                    settle_drain(d, dev_clock[d])
                    continue
                while try_fill(now):
                    pass
                if (ready and self.policy.preemptive
                        and free_slot_index(d) is None):
                    try_preempt(d, now)
                if devices[d].n_resident == 0:
                    if arrivals:
                        dev_clock[d] = max(now, arrivals[0][0])
                    else:
                        busy = [dev_clock[i] for i in cands
                                if devices[i].n_resident]
                        if busy:
                            dev_clock[d] = max(now, min(busy))
                        else:
                            assert ready, \
                                "engine stalled with work outstanding"
                            # policy abstained (or no role-compatible
                            # host): advance one quantum, anti-livelock
                            dev_clock[d] = now + SCHED_QUANTUM
                    continue
                run_iteration(d)
        finally:
            self._inject = None
            self._elastic = None
        return self.completed

    # ------------------------------------------------------------------
    def per_tenant(self) -> Dict[str, Dict[str, float]]:
        """SLA-class breakdown of every completed request (ANTT/STP, tail
        percentiles, SLA satisfaction per tenant)."""
        return metrics.per_tenant_summary(self.tasks)

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Run-level metrics: scheduler aggregates (``metrics.summarize``),
        serving throughput/latency (``metrics.serving_summary`` — tokens/s,
        TTFT/TPOT percentiles), KV-cache stats, and cluster health."""
        out = metrics.summarize(self.tasks)
        out["sla_met_rate"] = float(np.mean([r.sla_met for r in self.completed]))
        out.update(metrics.serving_summary(self.completed))
        kv_stats: Dict[str, float] = {}
        for kv in self.kvs:
            for k, v in kv.stats.items():
                kv_stats[k] = kv_stats.get(k, 0.0) + float(v)
        out.update({f"kv_{k}": v for k, v in kv_stats.items()})
        if self.cluster.n_devices > 1:
            # cluster accounting (busy times, migrations, clocks) is per
            # run, so the health section covers the *latest* run only —
            # cluster_health (not cluster_summary) keeps the per-task
            # aggregates above scoped to all completed requests
            run_tasks = getattr(self, "_run_tasks", self.tasks)
            if run_tasks:
                makespan = max(t.completion for t in run_tasks)
                out.update(metrics.cluster_health(
                    run_tasks, self.cluster.busy_times(), makespan,
                    capacity_seconds=self.cluster.capacity_seconds(makespan),
                    downtime_seconds=self.cluster.downtime_seconds(makespan)))
            out["migrations"] = float(self.cluster.n_migrations)
            out["n_scale_ups"] = float(self.cluster.n_scale_ups)
            out["n_scale_downs"] = float(self.cluster.n_scale_downs)
            out["n_failures"] = float(self.cluster.n_failures)
        return out
