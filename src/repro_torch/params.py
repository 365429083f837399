"""Parameter bridge and device choice.

``params_from_numpy`` maps the JAX pytree of ``transformer.init_params``
(leaves as numpy arrays) leaf by leaf to tensors, keeping the nested names
and the leading ``n_periods`` axis of every slot leaf, so both packages can
run on the same weights.  ``opt_state_from_numpy`` carries the
reference's training state across the same way (AdamW's moments in their
own dtype, the step, the error-feedback buffers), so both packages can
take the same optimizer step.  ``matmul_checkpoint_from_numpy`` does the same
for a preempted GEMM's checkpoint, so a GEMM stopped in one package
resumes in the other.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.preemptible_matmul import MatmulCheckpoint

# leaves the reference keeps in f32 whatever the model dtype: the MoE
# router (repro/models/moe.py, init_moe), Mamba's A_log and D, mLSTM's
# input and forget gates, sLSTM's recurrent weights and bias
# (repro/models/ssm.py, init_mamba, init_mlstm, init_slstm)
F32_LEAVES = frozenset({"router", "A_log", "D", "w_i", "w_f", "b_i", "b_f",
                        "r_zifo", "b_zifo"})


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for ``cuda`` without a card
    (never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _leaf_to_tensor(a, device: torch.device,
                    dtype: Optional[torch.dtype]) -> torch.Tensor:
    # np.array copies: arrays handed over from JAX are read-only
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (from ml_dtypes) is unknown to torch.from_numpy;
        # reinterpret the same 16 bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], device,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of array-likes → the same nesting of tensors on
    ``device`` (cast to ``dtype`` when given, except ``F32_LEAVES``, which
    stay f32).  Empty dicts (the ``layernorm_np`` norms) stay empty."""
    dev = resolve_device(device)

    def convert(node, name=None):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        return _leaf_to_tensor(node, dev, torch.float32
                               if name in F32_LEAVES else dtype)
    return convert(tree)


def opt_state_from_numpy(state: Dict[str, Any], device) -> Dict[str, Any]:
    """The reference's optimizer state (``init_opt_state`` or
    ``apply_updates``' result, leaves as array-likes) → the port's on
    ``device``, every leaf in its own dtype: ``m`` and ``v`` in their
    ``moment_dtype``, ``step`` a 0-dim int32 tensor, ``err`` (the
    error-feedback buffers, when present) f32."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _leaf_to_tensor(node, dev, None)
    return convert(state)


def matmul_checkpoint_from_numpy(acc, k_tile: int, n_ktiles: int,
                                 shape: Tuple[int, int],
                                 device) -> MatmulCheckpoint:
    """The fields of a ``repro`` ``MatmulCheckpoint`` (its accumulator as an
    array-like) → the port's checkpoint on ``device``."""
    return MatmulCheckpoint(
        acc=_leaf_to_tensor(acc, resolve_device(device), torch.float32),
        k_tile=int(k_tile), n_ktiles=int(n_ktiles),
        shape=(int(shape[0]), int(shape[1])))
