"""Multi-NPU cluster: one PREMA scheduler across N preemptible devices
(port of ``examples/multi_npu_cluster.py``).

Part 1 simulates the paper's 8-DNN workload on clusters of 1/2/4/8 NPUs
(core/cluster.py) under PREMA with affinity placement; part 2 runs the
real serving engine with ``n_devices=2`` — same scheduling core, real
execution, per-device KV pools, checkpoint migration on cross-device
resume.  The engine's two devices are scheduling devices: both run on
the one torch device the weights live on (``cuda`` unless ``--device
cpu``), so their tensors are shared.  ``--dtype`` and ``--full`` as in
``repro_torch.examples.quickstart``, whose models and requests part 2
serves.

    PYTHONPATH=src python -m repro_torch.examples.multi_npu_cluster \
        --device cpu
"""
import numpy as np

from repro_torch.core import trace
from repro_torch.core.cluster import ClusterConfig, ClusterSimulator
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import make_policy
from repro_torch.examples import quickstart
from repro_torch.hw import H100, PAPER_NPU, HardwareModel
from repro_torch.serving import EngineConfig, ServingEngine


def simulate_cluster():
    pred = Predictor(PAPER_NPU)
    trace.build_regressors(pred, np.random.default_rng(1))
    tasks = trace.make_workload(pred, np.random.default_rng(0), n_tasks=32,
                                contention=0.125)

    print(f"{'devices':>8} {'antt':>6} {'makespan_ms':>12} {'util':>6} "
          f"{'tput_tasks/s':>13} {'migrations':>10}")
    for n_devices in (1, 2, 4, 8):
        sim = ClusterSimulator(
            PAPER_NPU, make_policy("prema", preemptive=True),
            ClusterConfig(mechanism="dynamic", n_devices=n_devices,
                          placement="affinity"))
        sim.run(trace.clone_tasks(tasks))
        s = sim.summary()
        print(f"{n_devices:>8} {s['antt']:>6.2f} "
              f"{s['makespan']*1e3:>12.2f} {s['util_mean']:>6.1%} "
              f"{s['throughput']:>13.1f} {s['migrations']:>10.0f}")


def serve_on_two_devices(models: dict, hw: HardwareModel = H100):
    """Quickstart's requests on a 2-device engine over ``models`` with the
    hardware model ``hw``.  Returns the engine and its results."""
    engine = ServingEngine(models, cfg=EngineConfig(
        hw=hw, policy="prema", mechanism="dynamic", n_devices=2,
        placement="affinity"))
    results = engine.run(quickstart.make_requests())
    print(f"\n{'rid':>3} {'arch':12} {'prio':>4} {'dev':>3} {'ntt':>6} "
          f"{'preempts':>8}")
    for r in sorted(results, key=lambda r: r.rid):
        task = next(t for t in engine.tasks if t.tid == r.rid)
        print(f"{r.rid:>3} {r.arch:12} {r.priority:>4} {task.device:>3} "
              f"{r.ntt:>6.2f} {r.n_preemptions:>8}")
    s = engine.summary()
    print(f"\n2-device engine: ANTT={s['antt']:.2f}  "
          f"throughput={s['throughput']:.1f} req/s  "
          f"util={s['util_mean']:.1%}  migrations={s['migrations']:.0f}")
    return engine, results


def main(argv=None):
    args = quickstart.parse_args(argv)
    print("== Cluster scaling simulation (PREMA, dynamic mechanism) ==")
    simulate_cluster()
    print("\n== 2-device serving engine (real execution) ==")
    models = quickstart.build_models(args.device,
                                     quickstart.DTYPES[args.dtype], args.full)
    return serve_on_two_devices(models)


if __name__ == "__main__":
    main()
