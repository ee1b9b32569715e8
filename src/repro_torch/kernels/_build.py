"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use, by ``nvcc`` alone, into a shared
library with a plain C interface that ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so <name>.cu

No PyTorch header is compiled, so a build takes seconds. Libraries land
in ``build/torch_kernels/`` at the repository root, named by a hash of
their source, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing outside the repository is read but the CUDA
toolkit.

Every C entry point takes its pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()`` of its launch; ``check`` raises on a
nonzero code. ``launch_counts`` counts, per kernel, the launches its
wrapper made; the wrappers are the only writers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("hamming_scan", "srp_hash")

launch_counts: dict[str, int] = {"hamming_scores": 0, "srp_hash": 0}

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA kernels need nvcc: no CUDA toolkit was "
                           "found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=KERNELS) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent; raises on a failed build."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [_start(n) for n in names if not _target(n).exists()]
    errors = []
    for proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{out.name}:\n{log}")
        else:
            os.replace(tmp, out)   # atomic: concurrent builders never race
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def entry(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """C entry point ``symbol`` of library ``name``, typed as ``n_ptrs``
    pointers, ``n_ints`` ints and the stream, returning an int error code.
    Configured once and cached: wrappers call it on every launch."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
