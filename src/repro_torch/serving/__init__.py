# Copied from src/repro/serving/__init__.py; `repro.` rewritten to `repro_torch.`.
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
from repro_torch.serving.executor import ExecState, PreemptibleExecutor  # noqa: F401
from repro_torch.serving.kv_cache import KVCacheManager  # noqa: F401
from repro_torch.serving.request import InferenceRequest, RequestResult  # noqa: F401
