"""Sharding for the port (port of ``repro/distributed``): logical-axis
rules as DTensor placements, the logical-axis context, differentiable
collectives on local tensors, and elastic resharding."""
from repro_torch.distributed.context import hint, use_rules  # noqa: F401
from repro_torch.distributed import sharding  # noqa: F401
