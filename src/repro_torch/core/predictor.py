# Copied from src/repro/core/predictor.py; `repro.` rewritten to `repro_torch.`.
"""PREMA prediction model (paper §V-B).

Two components, exactly as the paper structures them:

1. **Node-level latency** — Algorithm 1: the architecture-aware analytical
   model of a weight-stationary systolic array.  Per inner tile, the compute
   phase ``C1 = (ACC + SH + 2*SW)/freq`` overlaps the memory phase
   ``M1 = (SH*SW + SH*ACC)*bytes/BW`` of the *next* tile (double-buffering),
   so each tile costs ``max(C1, M1)``; edge (outer) tiles in the streaming
   dimension get their own ``max(C2, M2)`` term.  We use ceil on the m/k tile
   counts so that layers smaller than the array still pay a full tile — this
   reproduces the paper's Fig-10 underutilization behavior (e.g. depthwise
   convs), which is why MAC-count proxies mislead.

2. **Executed-node-count prediction** — CNN DAGs are static; seq2seq RNN /
   LLM-decode lengths are input-dependent, so a profile-driven regression
   LUT (:class:`LengthRegressor`, the paper's Fig-9 characterization graph)
   maps the statically-known *input* length to the geometric mean of the
   profiled *output* lengths.

The same Algorithm-1 code serves the paper's Table-I NPU (figure
reproduction) and the TPU-v5e hardware model (serving engine), via
:class:`repro_torch.hw.HardwareModel`.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ops import GemmOp, NetworkDesc, NodeOp, VectorOp
from repro_torch.hw import HardwareModel

# Columns of activations streamed per GEMM_OP (accumulator-queue depth).
DEFAULT_ACC = 256


# ==========================================================================
# Algorithm 1 — node-level latency
# ==========================================================================
def gemm_time(op: GemmOp, hw: HardwareModel, acc: int = DEFAULT_ACC) -> float:
    """Inference-time estimate of one lowered GEMM on ``hw`` (seconds)."""
    sw, sh = hw.sa_rows, hw.sa_cols
    n_mxu = hw.n_mxu
    bpe = hw.bytes_per_elem
    m, k, n = op.m, op.k, op.n

    # inner tile: compute overlapped with next tile's loads (line 3-5)
    c1 = (acc + sh + 2 * sw) / hw.freq_hz
    m1 = (sh * sw + sh * acc) * bpe / hw.hbm_bw
    t_inner = max(c1, m1)

    # outer (edge) tile in the streaming dim (line 6-9)
    n_rem = n - (n // acc) * acc
    phi = 0 if n_rem == 0 else 1
    c2 = (n_rem + sh + 2 * sw) / hw.freq_hz
    m2 = (sh * sw + sh * n_rem) * bpe / hw.hbm_bw
    t_outer = max(c2, m2)

    tiles_m = max(1, math.ceil(m / sw))
    tiles_k = max(1, math.ceil(k / sh))
    t = tiles_m * tiles_k * ((n // acc) * t_inner + phi * t_outer)
    # multiple MXUs process independent (m,k) tiles in parallel
    return t * op.repeat / n_mxu


def vector_time(op: VectorOp, hw: HardwareModel) -> float:
    """Vector-unit node latency: max of compute and in-place memory."""
    compute = op.elems / hw.peak_vector_flops * 2
    mem = op.elems * hw.bytes_per_elem / hw.hbm_bw  # in-place (§IV-B)
    return max(compute, mem)


def node_time(op: NodeOp, hw: HardwareModel, acc: int = DEFAULT_ACC) -> float:
    """Latency of one node op on ``hw`` (Algorithm 1 per-op model)."""
    if isinstance(op, GemmOp):
        return gemm_time(op, hw, acc)
    if isinstance(op, VectorOp):
        return vector_time(op, hw)
    raise TypeError(op)


def network_time(ops: Sequence[NodeOp], hw: HardwareModel,
                 acc: int = DEFAULT_ACC) -> float:
    """End-to-end latency of an op sequence (sum of node times)."""
    return float(sum(node_time(op, hw, acc) for op in ops))


def per_node_times(ops: Sequence[NodeOp], hw: HardwareModel,
                   acc: int = DEFAULT_ACC) -> np.ndarray:
    """Per-node latencies — the Task's schedulable-period durations."""
    return np.asarray([node_time(op, hw, acc) for op in ops])


def network_flops(ops: Sequence[NodeOp]) -> int:
    """Total FLOPs over an op sequence."""
    return sum(op.flops for op in ops)


# ==========================================================================
# Device-relative speed (heterogeneous clusters)
# ==========================================================================
# A small basket of GEMM shapes spanning the suite's regimes (compute-bound
# large GEMMs, a skinny memory-bound one, and an underutilizing tall-thin
# one), so the ratio reflects Algorithm 1 rather than raw peak FLOPs.
_SPEED_PROBE: Tuple[GemmOp, ...] = (
    GemmOp(m=1024, k=1024, n=512),
    GemmOp(m=256, k=4096, n=64),
    GemmOp(m=64, k=64, n=2048, repeat=8),
)


def relative_speed(hw: HardwareModel, base: HardwareModel,
                   probe: Optional[Sequence[GemmOp]] = None) -> float:
    """How much faster ``hw`` runs the probe basket than ``base``.

    ``speed > 1`` means a faster device: a task whose reference (``base``)
    service time is ``T`` takes ``T / speed`` wall seconds on ``hw``.  The
    ratio is measured through the same Algorithm-1 latency model the
    scheduler's predictor trusts, so heterogeneous cost estimates stay
    consistent with single-device predictions.  Identical hardware maps to
    exactly 1.0 (elastic homogeneous clusters keep bit-identical math).
    """
    if hw is base or hw == base:
        return 1.0
    ops = tuple(probe) if probe is not None else _SPEED_PROBE
    return network_time(ops, base) / network_time(ops, hw)


# ==========================================================================
# Output-length regression (profile-driven characterization graph, Fig 9)
# ==========================================================================
class LengthRegressor:
    """Software LUT: input length → geometric mean of profiled output
    lengths.  ``fit`` is paid once per model (paper §V-B observation 2)."""

    def __init__(self):
        self._table: Dict[int, float] = {}
        self._keys: List[int] = []
        self._samples: Dict[int, List[int]] = {}

    def fit(self, pairs: Sequence[Tuple[int, int]]) -> "LengthRegressor":
        """Profile (in_len, out_len) pairs into a geometric-mean LUT."""
        buckets: Dict[int, List[int]] = {}
        for in_len, out_len in pairs:
            buckets.setdefault(int(in_len), []).append(max(1, int(out_len)))
        self._samples = buckets
        self._table = {
            k: float(np.exp(np.mean(np.log(np.asarray(v, dtype=np.float64)))))
            for k, v in buckets.items()}
        self._keys = sorted(self._table)
        return self

    def predict(self, in_len: int) -> float:
        """Expected output length for ``in_len`` (LUT + interpolation)."""
        if not self._keys:
            raise RuntimeError("LengthRegressor not fitted")
        if in_len in self._table:
            return self._table[in_len]
        # nearest-neighbour interpolation between profiled input lengths
        i = bisect.bisect_left(self._keys, in_len)
        if i == 0:
            return self._table[self._keys[0]]
        if i == len(self._keys):
            return self._table[self._keys[-1]]
        lo, hi = self._keys[i - 1], self._keys[i]
        tl, th = self._table[lo], self._table[hi]
        w = (in_len - lo) / (hi - lo)
        return tl * (1 - w) + th * w

    def sample_actual(self, in_len: int, rng: np.random.Generator) -> int:
        """Draw an *actual* output length for simulation: a uniformly random
        member of the profiled set for this input length (paper §VI)."""
        if in_len in self._samples:
            return int(rng.choice(self._samples[in_len]))
        return max(1, int(round(self.predict(in_len))))

    @property
    def input_lengths(self) -> List[int]:
        """Profiled input lengths, ascending."""
        return list(self._keys)


# ==========================================================================
# Task-level prediction
# ==========================================================================
@dataclasses.dataclass
class Prediction:
    """Algorithm-1 output: total time plus the per-node breakdown."""

    total_time: float
    node_times: np.ndarray          # per executed node (predicted unroll)
    n_static: int
    unroll: int


class Predictor:
    """Network-wide inference-time prediction (Algorithm 1 + LUT)."""

    def __init__(self, hw: HardwareModel, acc: int = DEFAULT_ACC):
        self.hw = hw
        self.acc = acc
        self._regressors: Dict[str, LengthRegressor] = {}

    def register_regressor(self, model_name: str, reg: LengthRegressor):
        """Install the fitted output-length LUT for a seq2seq model."""
        self._regressors[model_name] = reg

    def regressor(self, model_name: str) -> Optional[LengthRegressor]:
        """The registered LUT for ``model_name``, or None."""
        return self._regressors.get(model_name)

    def predict_unroll(self, net: NetworkDesc, in_len: Optional[int]) -> int:
        """Predicted decode/unroll length for one inference of ``net``."""
        if not net.recurrent_ops:
            return 0
        if net.kind == "rnn_linear":
            # linear RNNs: output length statically determined by input
            return int(in_len)
        reg = self._regressors.get(net.name)
        if reg is None or in_len is None:
            raise RuntimeError(
                f"{net.name}: seq2seq network needs a fitted LengthRegressor")
        return max(1, int(round(reg.predict(in_len))))

    def predict(self, net: NetworkDesc, in_len: Optional[int] = None,
                unroll_override: Optional[int] = None) -> Prediction:
        """Full Algorithm-1 prediction for one inference of ``net``."""
        unroll = (unroll_override if unroll_override is not None
                  else self.predict_unroll(net, in_len))
        ops = net.ops(in_len or 0, unroll)
        times = per_node_times(ops, self.hw, self.acc)
        return Prediction(total_time=float(times.sum()), node_times=times,
                          n_static=len(net.static_ops), unroll=unroll)


# ==========================================================================
# Runtime predictors — the pluggable task-level prediction API
# ==========================================================================
# Every predictive controller (SJF/PREMA selection, predicted-cost
# admission, lookahead autoscaling, backfill) consumes one number per
# task: its predicted isolated runtime, carried as ``Task.predicted_total``.
# A :class:`RuntimePredictor` produces that number; installing one is a
# *pre-run rewrite* of ``predicted_total`` (:func:`apply_runtime_predictor`)
# so the hot scheduling loops never change and an exact predictor is
# bit-identical to not installing one at all.

class RuntimePredictor:
    """Protocol for task-level runtime prediction.

    Implementations provide ``name`` and :meth:`predict_runtime`; they
    never mutate the task.  Install via :func:`apply_runtime_predictor`.
    """

    name: str = "base"

    def predict_runtime(self, task) -> float:
        """Predicted isolated runtime of ``task`` in reference-hardware
        seconds."""
        raise NotImplementedError


class AnalyticalRuntime(RuntimePredictor):
    """The paper's Algorithm-1 prediction, as already baked into the
    task at trace-generation time — the exact-prediction identity
    predictor (applying it is a no-op by construction)."""

    name = "analytical"

    def predict_runtime(self, task) -> float:
        """Return the task's existing Algorithm-1 ``predicted_total``."""
        return float(task.predicted_total)


class FittedPredictor(RuntimePredictor):
    """Ridge regression over executed-trace features (deterministic fit).

    Learns ``log(isolated_time)`` from the features available *before* a
    task runs: model name and tenant (one-hot over the training vocab,
    all-zero for unseen categories), ``log1p(batch)``, ``log1p(in_len)``,
    and the device relative speed (an optional per-task callable; 1.0 for
    homogeneous fleets).  The fit is closed-form normal equations
    (``(XᵀX + λI) w = Xᵀy``) so identical training sets give bit-identical
    weights — no iterative optimizer, no RNG.
    """

    name = "fitted"

    def __init__(self, l2: float = 1e-3):
        self.l2 = float(l2)
        self._w: Optional[np.ndarray] = None
        self._models: List[str] = []
        self._tenants: List[str] = []

    # -- feature layout: [1, log1p(batch), log1p(in_len), speed,
    #                     one-hot(model), one-hot(tenant)]
    def _features(self, task, speed: float) -> np.ndarray:
        x = np.zeros(4 + len(self._models) + len(self._tenants))
        x[0] = 1.0
        x[1] = math.log1p(float(task.batch))
        x[2] = math.log1p(float(task.in_len))
        x[3] = float(speed)
        if task.model in self._models:
            x[4 + self._models.index(task.model)] = 1.0
        tenant = task.tenant if task.tenant is not None else "-"
        if tenant in self._tenants:
            x[4 + len(self._models) + self._tenants.index(tenant)] = 1.0
        return x

    def fit(self, tasks: Sequence,
            speed_of=None) -> "FittedPredictor":
        """Fit on executed tasks (positive ``isolated_time``).

        ``speed_of`` maps a task to the relative speed of the device it
        ran on (default 1.0 — homogeneous fleet).  Tasks with
        non-positive or non-finite runtimes are skipped; an empty
        training set raises ``ValueError``.
        """
        rows = [t for t in tasks
                if math.isfinite(t.isolated_time) and t.isolated_time > 0.0]
        if not rows:
            raise ValueError("FittedPredictor.fit: no executed tasks with "
                             "positive isolated_time")
        self._models = sorted({t.model for t in rows})
        self._tenants = sorted({t.tenant if t.tenant is not None else "-"
                                for t in rows})
        sp = speed_of if speed_of is not None else (lambda t: 1.0)
        X = np.stack([self._features(t, sp(t)) for t in rows])
        y = np.asarray([math.log(t.isolated_time) for t in rows])
        a = X.T @ X + self.l2 * np.eye(X.shape[1])
        self._w = np.linalg.solve(a, X.T @ y)
        return self

    def predict_runtime(self, task, speed: float = 1.0) -> float:
        """``exp(x · w)`` over the task's features (``fit`` first)."""
        if self._w is None:
            raise RuntimeError("FittedPredictor not fitted")
        return float(math.exp(self._features(task, speed) @ self._w))


class NoisyPredictor(RuntimePredictor):
    """Controlled-error wrapper: multiplies an inner predictor's output
    by a deterministic per-task lognormal factor.

    ``error`` is the log-space standard deviation of the factor; the
    ``exp(σz − σ²/2)`` form keeps the *mean* prediction unbiased.  The
    draw is seeded by ``(seed, task.tid)`` so it does not depend on call
    order, and ``error=0`` short-circuits to the inner prediction
    unchanged — the bit-identical zero-noise contract the parity tests
    pin (tests/test_fastpath_parity.py).
    """

    name = "noisy"

    def __init__(self, inner: RuntimePredictor, error: float = 0.0,
                 seed: int = 0):
        if error < 0.0:
            raise ValueError(f"error must be >= 0, got {error}")
        self.inner = inner
        self.error = float(error)
        self.seed = int(seed)

    def predict_runtime(self, task) -> float:
        """Inner prediction, perturbed when ``error > 0``."""
        base = self.inner.predict_runtime(task)
        if self.error == 0.0:
            return base
        z = np.random.default_rng([self.seed, int(task.tid)])
        factor = math.exp(self.error * z.standard_normal()
                          - 0.5 * self.error * self.error)
        return base * factor


def apply_runtime_predictor(tasks: Sequence, rp: RuntimePredictor) -> list:
    """Rewrite each fresh task's ``predicted_total`` with ``rp``'s view.

    Call before handing the tasks to a simulator/engine run: every
    predictive consumer (policy selection, admission, autoscaling,
    backfill) reads ``predicted_total``/``predicted_remaining``, so one
    rewrite retargets them all without touching the scheduling loops.
    Tasks must not have started executing yet.  Returns ``tasks`` for
    chaining.
    """
    out = list(tasks)
    for t in out:
        if t.executed:
            raise ValueError(f"task {t.tid} already started; predictions "
                             "must be installed before the run")
        t.predicted_total = float(rp.predict_runtime(t))
    return out
