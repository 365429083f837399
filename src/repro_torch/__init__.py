"""PREMA on PyTorch and CUDA: the port of ``src/repro`` to one NVIDIA H100.

The scheduling core, configs, workload generator and serving engine are
copies of the JAX package's framework-free modules; the model, the
executor, the two attention kernels and the preemptible GEMM are ported.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
