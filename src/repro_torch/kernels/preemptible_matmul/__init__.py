from repro_torch.kernels.preemptible_matmul.ops import (  # noqa: F401
    MatmulCheckpoint, advance, finish, matmul, matmul_resumable, start)
from repro_torch.kernels.preemptible_matmul.ref import (  # noqa: F401
    f32_sum_tolerance, matmul_partial_plain, matmul_plain)
