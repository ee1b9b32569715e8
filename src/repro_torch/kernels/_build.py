"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use, by ``nvcc`` alone, into a shared
library with a plain C interface that ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
         -shared -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so
         <name>.cu

No PyTorch header is compiled, so a build takes seconds. Libraries land
in ``build/torch_kernels/`` at the repository root, named by a hash of
their source, every ``csrc/*.cuh`` header and the flags, so an edited
source, header or flag is rebuilt and an unchanged one is loaded as it
is; nvcc's output (``-Xptxas -v``: registers, shared memory and spills
of each kernel) is kept beside the library as ``<name>-<hash>.log``.
Nothing outside the repository is read but the CUDA toolkit.

Every C entry point takes its pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()`` of its launch; ``check`` raises on a
nonzero code. ``launch_counts`` counts, per kernel, the launches its
wrapper made; the wrappers are the only writers, through ``count_launch``.

Serving threads may use a kernel for the first time together and launch
together: ``load`` and ``entry`` run under one lock, so a library is built
and loaded once per process, each build writes a temporary file of its
own, and ``count_launch`` adds under a lock, so no launch is lost.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import uuid
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("hamming_scan", "srp_hash", "fused_scan", "ip_topk",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# "flash_attention" counts every launch of the flash kernels,
# "flash_attention_wgmma" those of its wgmma route alone
launch_counts: dict[str, int] = {"hamming_scores": 0, "hamming_nearest": 0,
                                 "srp_hash": 0, "fused_scan": 0, "ip_topk": 0,
                                 "flash_attention": 0,
                                 "flash_attention_wgmma": 0}

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, ctypes._CFuncPtr] = {}
_load_lock = threading.RLock()
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``launch_counts``."""
    with _count_lock:
        launch_counts[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA kernels need nvcc: no CUDA toolkit was "
                           "found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    """The library of source ``name``: named by a hash of the source, every
    header in ``CSRC`` and ``NVCC_FLAGS``, so that a change to any of them
    builds anew."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output from the build of the current library of ``name``."""
    return _target(name).with_suffix(".log").read_text()


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}-{uuid.uuid4().hex}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)   # atomic: concurrent builders never race
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    with _load_lock:
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
        with _load_lock:
            fn = _entries.get(symbol)
            if fn is None:
                fn = getattr(load(name), symbol)
                fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                               + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                _entries[symbol] = fn
    return fn


def check_input(name: str, t, dtype, dim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dim``-D ``dtype`` CUDA tensor:
    what every kernel's wrapper checks before it passes a pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
