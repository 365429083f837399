from repro_torch.models.registry import Model, build, get_model  # noqa: F401
