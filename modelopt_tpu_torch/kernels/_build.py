"""Build the port's CUDA sources with nvcc at first use and bind them with
ctypes.

Every source under ``csrc/`` exposes a plain C function (no PyTorch
headers), so one nvcc call per file takes seconds. The shared libraries go
to ``_build/`` beside the package (listed in .gitignore), named by a hash of
their source, so an edited kernel is rebuilt and a stale one never loads.
``build_all()`` starts one nvcc per source at once and waits for all of
them. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("w4a8_gemm", "kv_write", "fused_decode_attention",
           "flash_prefill_attention", "w4a16_gemm", "grouped_w4a8_gemm")
GENCODE = "arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIBS: dict = {}
# source name -> nvcc's stderr of its last build (ptxas registers / smem)
BUILD_LOG: dict = {}

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the port's kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _paths(name: str):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=SOURCES) -> None:
    """Compile every listed source that has no current library, all nvcc
    processes at once; raise with nvcc's output if any fails."""
    jobs = []
    for name in names:
        src, out = _paths(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        BUILD_LOG[name] = err
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{err}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def function(name: str, argtypes, source: str = None):
    """The C entry point ``name`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``; built on first use), returning the launch's
    cudaGetLastError() as an int."""
    source = source or name
    with _LOCK:
        fn = _LIBS.get((source, name))
        if fn is None:
            build_all((source,))
            fn = getattr(ctypes.CDLL(_paths(source)[1]), name)
            fn.argtypes = list(argtypes)
            fn.restype = c_int
            _LIBS[(source, name)] = fn
        return fn


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()


def check_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device and contiguous (None entries skip)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on the card, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
