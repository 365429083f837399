# Copied from src/repro/hw.py; `repro.` rewritten to `repro_torch.`.
"""Hardware models used across the framework.

Two instantiations matter:

* ``PAPER_NPU`` — the NPU of the paper's Table I (TPU-v1-like systolic array).
  Used by the figure-reproduction benchmarks so the simulator reproduces the
  paper's numbers on the paper's hardware.
* ``TPU_V5E``  — the deployment target of this framework.  Its constants feed
  the roofline analysis (EXPERIMENTS.md) and the serving engine's predictor.

The analytical latency model (core/predictor.py) is parameterized by a
``HardwareModel`` so that the same Algorithm-1 code serves both.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Parameters of a systolic-array accelerator chip."""

    name: str
    # Systolic array geometry (one logical MXU; n_mxu of them per chip).
    sa_rows: int  # SW in the paper: weight-stationary rows
    sa_cols: int  # SH: columns / depth of the array
    n_mxu: int    # number of independent systolic units per chip
    freq_hz: float
    # Memory system.
    hbm_bw: float          # bytes/sec off-chip bandwidth
    hbm_bytes: int         # HBM capacity per chip
    vmem_bytes: int        # on-chip SRAM (activations; UBUF analogue)
    wmem_bytes: int        # on-chip SRAM (weights; weight-FIFO analogue)
    mem_latency_cycles: int
    # Interconnect (0 for single-chip parts).
    ici_bw: float = 0.0    # bytes/sec per link
    ici_links: int = 0
    # Numerics.
    bytes_per_elem: int = 2  # bf16/int16 datapath

    @property
    def macs_per_cycle(self) -> int:
        return self.sa_rows * self.sa_cols * self.n_mxu

    @property
    def peak_flops(self) -> float:
        """Peak FLOP/s (2 flops per MAC)."""
        return 2.0 * self.macs_per_cycle * self.freq_hz

    @property
    def peak_vector_flops(self) -> float:
        """Element-wise (VPU) throughput; modeled as one SA row of lanes."""
        return 2.0 * self.sa_cols * self.n_mxu * self.freq_hz


# The paper's Table I configuration: 128x128 PEs @ 700 MHz, 8 MB UBUF,
# 4 MB weight buffer, 358 GB/s memory, 100-cycle latency.
PAPER_NPU = HardwareModel(
    name="paper-npu",
    sa_rows=128,
    sa_cols=128,
    n_mxu=1,
    freq_hz=700e6,
    hbm_bw=358e9,
    hbm_bytes=16 * 1024**3,
    vmem_bytes=8 * 1024**2,
    wmem_bytes=4 * 1024**2,
    mem_latency_cycles=100,
    bytes_per_elem=2,
)

# TPU v5e-like part (the roofline constants mandated for this project):
#   197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI, 16 GiB HBM.
# 4 MXUs of 128x128 @ ~940 MHz gives 4*16384*2*0.94e9 = 123 TF; to match the
# given 197 TF peak we model the MXU clock at the effective rate
# 197e12 / (2 * 4 * 128 * 128) = 1.503 GHz.  Only the *product* matters for
# the analytical model.
TPU_V5E = HardwareModel(
    name="tpu-v5e",
    sa_rows=128,
    sa_cols=128,
    n_mxu=4,
    freq_hz=197e12 / (2 * 4 * 128 * 128),
    hbm_bw=819e9,
    hbm_bytes=16 * 1024**3,
    vmem_bytes=128 * 1024**2,
    wmem_bytes=0,  # unified VMEM on TPU
    mem_latency_cycles=250,
    ici_bw=50e9,
    ici_links=4,
    bytes_per_elem=2,
)

# Roofline constants (per chip) used by benchmarks/ and launch/roofline.
PEAK_FLOPS_BF16 = 197e12
HBM_BW = 819e9
ICI_BW_PER_LINK = 50e9


def get_hw(name: str) -> HardwareModel:
    if name in ("paper", "paper-npu", "npu"):
        return PAPER_NPU
    if name in ("tpu", "tpu-v5e", "v5e"):
        return TPU_V5E
    raise KeyError(f"unknown hardware model: {name!r}")


# NVIDIA H100 SXM (data sheet, dense rates): 989 TFLOP/s bf16 on the tensor
# cores, 80 GB of HBM3 at 3.35 TB/s, 132 SMs.  As for TPU_V5E, the array
# geometry is nominal (one 128x128 unit per SM) and the clock is the
# effective rate that makes the product match the peak:
# 989e12 / (2 * 132 * 128 * 128) = 228.65 MHz.  On-chip SRAM is the 228 KB
# of shared memory each SM offers.  One card: no chip-to-chip link.
H100 = HardwareModel(
    name="h100-sxm",
    sa_rows=128,
    sa_cols=128,
    n_mxu=132,
    freq_hz=989e12 / (2 * 132 * 128 * 128),
    hbm_bw=3.35e12,
    hbm_bytes=80 * 10**9,
    vmem_bytes=132 * 228 * 1024,
    wmem_bytes=0,
    mem_latency_cycles=0,  # read by no model in this package
    ici_bw=0.0,
    ici_links=0,
    bytes_per_elem=2,
)
