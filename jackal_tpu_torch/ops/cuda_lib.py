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
KERNEL_SOURCES = ("support_kernel", "elas_dense_kernel", "raster_kernel",
                  "census_kernel", "sgm_paths_kernel", "sgm_wta_kernel",
                  "bm_kernel", "elas_post_kernel", "speckle_kernel",
                  "remap_kernel", "scan_kernel", "descriptor_kernel",
                  "prior_kernel", "sgm_tail_kernel", "bm_gate_kernel",
                  "bm_tp_kernel", "exact_scan_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# headers under csrc/, hashed into every library's name (elas_lr.cuh: the
# L/R check of kernel H and of kernel B's epilogue; sgm_epilogue.cuh: the
# SGM epilogue of kernel O2 and of F with O2 folded in)
HEADERS = ("elas_lr.cuh", "sgm_epilogue.cuh")
# libraries built from another library's source with extra flags: the BM
# kernel's per-part timing (G') is the BM source with its diagnostic entry;
# the scan kernels, the prior kernels M1, M2, the SGM tail O1, O2, F with
# O2 folded in, the ELAS front (R; A with Q) and the BM kernel G (with S's
# gate) built without contraction (-fmad=false), whose
# FFMA and DFMA counts chip_smoke.py holds against the library's own;
# the exact scan V, whose DFMA count chip_smoke.py holds likewise;
# kernel R at the band heights that it does not run (tools/
# time_support_kernel.py --kernel front times them beside its 8 rows);
# and M1's and M2's one launch with an entry that launches either part's
# blocks alone (chip_smoke.py and the tool time them apart)
VARIANTS = {"bm_kernel_diag": ("bm_kernel", ("-DBM_KERNEL_DIAG",)),
            "scan_kernel_nofmad": ("scan_kernel", ("-fmad=false",)),
            "prior_kernel_nofmad": ("prior_kernel", ("-fmad=false",)),
            "sgm_tail_kernel_nofmad": ("sgm_tail_kernel", ("-fmad=false",)),
            "descriptor_kernel_nofmad": ("descriptor_kernel",
                                         ("-fmad=false",)),
            "support_kernel_nofmad": ("support_kernel", ("-fmad=false",)),
            "bm_kernel_nofmad": ("bm_kernel", ("-fmad=false",)),
            "sgm_wta_kernel_nofmad": ("sgm_wta_kernel", ("-fmad=false",)),
            "exact_scan_kernel_nofmad": ("exact_scan_kernel",
                                         ("-fmad=false",)),
            "prior_kernel_parts": ("prior_kernel", ("-DPRIOR_KERNEL_PARTS",)),
            **{f"descriptor_kernel_band{b}": (
                "descriptor_kernel", (f"-DDESCRIPTOR_BAND={b}",))
               for b in (4, 16, 32)}}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library(name: str) -> Library:
    src, extra = VARIANTS.get(name, (name, ()))
    return Library(name=name, compiler=_nvcc(), flags=NVCC_FLAGS + extra,
                   sources=(os.path.join(CSRC, f"{src}.cu"),),
                   headers=tuple(os.path.join(CSRC, h) for h in HEADERS))


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build([library(name)])[0])
        return _libs[name]


def launch(fn, kernel: str, t: torch.Tensor, *args) -> None:
    """fn(*args, stream) with t's card made current and that card's
    current stream appended; raise if the kernel failed to launch. The C
    entry points launch on whatever card the calling thread has current,
    where torch's own ops follow their tensors, so every kernel launch goes
    through here."""
    with torch.cuda.device(t.device):
        err = fn(*args, ctypes.c_void_p(
            torch.cuda.current_stream(t.device).cuda_stream))
    check(err, kernel)


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device,
           align: int = 16):
    """Raise unless t is a contiguous, ``align``-byte aligned tensor of this
    dtype and shape on this CUDA device (most kernels load 16 bytes at a
    time)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device},"
            f" got {t.dtype} {tuple(t.shape)} on {t.device}"
            f" (contiguous={t.is_contiguous()}, address {t.data_ptr():#x})")
