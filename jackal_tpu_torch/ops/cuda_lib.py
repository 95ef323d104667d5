"""The hand-written CUDA kernels under csrc/: build, load, launch checks.

Each csrc/<name>.cu exposes a plain C entry point that launches its kernel
on the stream it is given and returns cudaGetLastError(). It is compiled
with nvcc for sm_90a into its own shared library (build.py) and loaded
with ctypes; no PyTorch headers are involved, so a build takes seconds.
Nothing here runs when a module is imported: a library builds at the
first launch of one of its kernels (chip_smoke.py builds them all at once
with build.build).
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict

import torch

from ..build import PKG_DIR, Library, build

CSRC = os.path.join(PKG_DIR, "csrc")
KERNEL_SOURCES = ("support_kernel", "elas_dense_kernel", "raster_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library(name: str) -> Library:
    return Library(name=name, compiler=_nvcc(), flags=NVCC_FLAGS,
                   sources=(os.path.join(CSRC, f"{name}.cu"),))


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build([library(name)])[0])
        return _libs[name]


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    """Raise unless t is a contiguous, 16-byte aligned tensor of this dtype
    and shape on this CUDA device (the kernels load 16 bytes at a time)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device},"
            f" got {t.dtype} {tuple(t.shape)} on {t.device}"
            f" (contiguous={t.is_contiguous()}, address {t.data_ptr():#x})")
