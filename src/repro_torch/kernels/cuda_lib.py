"""Builds the port's CUDA kernels and loads them with ctypes.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``, one
``nvcc`` per ``.cu`` file, all started together, then linked into one
shared library with a plain C interface.  The library lands in ``build/``
at the repository root, named by a hash of the sources and flags, so it is
rebuilt exactly when they change.  Nothing is built at import: the first
call of :func:`library` builds (a missing ``nvcc`` or a failed build
raises).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # dtype, q, k, v, o, B, Hq, Hkv, S, T, D, strides, scale, causal,
    # q_offset, stream
    "prema_flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _S,
                              _F, _I, _I, _P],
    # dtype, q, k, v, o, part, tickets, lse, pos_ptr, pos, B, Hq, Hkv, T, D,
    # strides, scale, stream
    "prema_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _S, _F, _P],
    # q, k, v, o, B, Hq, Hkv, S, T, strides, scale, causal, q_offset, stream
    "prema_flash_attention_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _S,
                                    _F, _I, _I, _P],
    # dtype, x, y, acc_in, acc_out, M, N, accM, accN, lo, hi, strides, stream
    "prema_matmul_resumable": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _S,
                               _P],
    # x, y, acc_in, acc_out, M, N, K, accM, accN, lo, hi, strides, stream
    "prema_matmul_resumable_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _S, _P],
    "prema_decode_chunk": [],
    "prema_decode_max_group": [],
}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(the CPU path uses the plain PyTorch versions)")
    return exe


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, headers = _sources()
    for path in cus + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # one nvcc per source, all at once: the build time stays that of the
        # slowest file as kernels are added
        objs = [Path(tmp) / f"{src.stem}.o" for src in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                   str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cus, objs)]
        failed = []
        for src, proc in zip(cus, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"== {src.name}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = Path(tmp) / target.name
        link = subprocess.run([nvcc, "-shared", "-o", str(so),
                               *map(str, objs)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(so, target)   # atomic: concurrent builds agree


def library_path() -> Path:
    """Where the library of the current sources and flags is built."""
    return BUILD_DIR / f"libprema_kernels-{_digest()}.so"


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.prema_error_string.argtypes = [ctypes.c_int]
        lib.prema_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if err != 0:
        msg = library().prema_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")


def strides_arg(*tensors) -> ctypes.Array:
    """The element strides of ``tensors``, concatenated, as a C array."""
    vals = [s for t in tensors for s in t.stride()]
    return (ctypes.c_longlong * len(vals))(*vals)

