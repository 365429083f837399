from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    bf16_tolerance, flash_attention_plain)
