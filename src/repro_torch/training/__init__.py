"""Training (port of ``repro/training``): AdamW with a cosine schedule,
the train step with gradient accumulation, remat and int8 gradient
compression, the deterministic data pipeline (a copy), and atomic,
restart-exact checkpoints."""
from repro_torch.training.optimizer import OptConfig, apply_updates, init_opt_state  # noqa: F401
from repro_torch.training.train_step import TrainConfig, init_train_state, make_train_step  # noqa: F401
from repro_torch.training.data import DataConfig, TokenDataset  # noqa: F401
from repro_torch.training import checkpoint  # noqa: F401
