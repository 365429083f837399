"""PREMA on PyTorch and CUDA: the port of ``src/repro`` to one NVIDIA H100.

The scheduling core, configs and serving engine are copies of the JAX
package's framework-free modules; the model, the executor and the two
attention kernels are ported.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
