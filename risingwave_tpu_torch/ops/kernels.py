"""Build, load and count the hand-written CUDA kernels.

Each kernel is one CUDA C++ source under `risingwave_tpu_torch/csrc/`
with a plain C interface. It is compiled by `nvcc` for sm_90a into a
shared library under the git-ignored `risingwave_tpu_torch/build/`,
loaded with ctypes, built at first use and rebuilt when a source is
newer than its library. `build_all()` starts one nvcc per source, all
at once.

Every C entry launches on the caller's stream, allocates nothing, and
returns `cudaGetLastError()`; `CudaKernel.call` raises when it is not 0.
Each kernel keeps a plain integer `launches`, which its wrapper bumps
exactly where it calls the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "-lineinfo"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def ptr_array(tensors) -> ctypes.Array:
    """Host array of device pointers (copied into a by-value kernel
    argument struct by the C entry, so no host->device copy)."""
    ps = [None if t is None else t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * max(1, len(ps)))(*ps)


def int_array(vals) -> ctypes.Array:
    vals = list(vals)
    return (ctypes.c_int * max(1, len(vals)))(*vals)


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


class CudaKernel:
    """One source file, its library, its C entry points and its count."""

    def __init__(self, name: str, replaces: str,
                 functions: dict[str, list]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.replaces = replaces
        self.functions = functions      # C entry -> ctypes argtypes
        self.launches = 0
        self._lib = None

    @property
    def so_path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}.so"

    @property
    def log_path(self) -> Path:
        return BUILD_DIR / f"{self.name}.log"

    def stale(self) -> bool:
        if not self.so_path.exists():
            return True
        newest = max(p.stat().st_mtime for p in
                     [self.source, *CSRC.glob("*.cuh")])
        return self.so_path.stat().st_mtime < newest

    def _start_build(self) -> tuple[subprocess.Popen, str, object]:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build into a private name, then rename: concurrent processes
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = open(self.log_path, "w")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp, str(self.source)]
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), \
            tmp, log

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            if self.stale():
                build_all([self])
            lib = ctypes.CDLL(str(self.so_path))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        rc = getattr(self.lib(), fn)(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name}.{fn} failed: cudaError {rc}")


# name -> CudaKernel; each wrapper module registers its kernel at import
KERNELS: dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all(kernels: Iterable[CudaKernel] | None = None) -> float:
    """Compile every stale kernel, one nvcc each, all started together.
    Returns the wall seconds spent; raises with the compiler output of
    any build that failed."""
    ks = [k for k in (KERNELS.values() if kernels is None else kernels)
          if k.stale()]
    t0 = time.perf_counter()
    started = [(k, *k._start_build()) for k in ks]
    failed = []
    for k, proc, tmp, log in started:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, k.so_path)
        else:
            os.unlink(tmp)
            failed.append(f"{k.name}: nvcc exit {rc}\n"
                          + k.log_path.read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
