# Copied from src/repro/core/__init__.py; `repro.` rewritten to `repro_torch.`.
"""PREMA core: predictor (Algorithm 1 + LUT), token scheduler (Algorithm 2),
preemption mechanisms + dynamic selection (Algorithm 3), the shared
scheduling arbiter, metrics, and the event-driven single-NPU and
multi-NPU-cluster simulators."""
from repro_torch.core.arbiter import (Action, Arbiter, ArbiterConfig,  # noqa: F401
                                Decision)
from repro_torch.core.cluster import (PLACEMENT_NAMES, Cluster,  # noqa: F401
                                ClusterConfig, ClusterSimulator, DeviceState,
                                make_placement)
from repro_torch.core.metrics import (antt, cluster_summary, fairness,  # noqa: F401
                                goodput, per_device_summary,
                                per_tenant_summary, percentile_summary,
                                prediction_error_summary, prediction_errors,
                                sla_satisfaction, stp, summarize)
from repro_torch.core.predictor import (AnalyticalRuntime,  # noqa: F401
                                  FittedPredictor, LengthRegressor,
                                  NoisyPredictor, Predictor,
                                  RuntimePredictor, apply_runtime_predictor)
from repro_torch.core.preemption import Mechanism, select_mechanism  # noqa: F401
from repro_torch.core.registry import Registry  # noqa: F401
from repro_torch.core.scheduler import POLICY_NAMES, Backfill, make_policy  # noqa: F401
from repro_torch.core.simulator import NPUSimulator, SimConfig  # noqa: F401
from repro_torch.core.task import Task, TaskState  # noqa: F401
