"""The benchmark of the PyTorch and CUDA port: ``python3 bench/run.py``."""
import functools
import importlib.util
from pathlib import Path


@functools.lru_cache(maxsize=None)
def load(path: Path):
    """The module in the file ``path``, loaded once.  What belongs to one
    metric (``metrics/``), architecture (``arch/``) or plain reference
    (``ref/``) sits in a file of its own, found by name in
    ``BENCHMARK.json`` or a configuration, never imported as a package."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
