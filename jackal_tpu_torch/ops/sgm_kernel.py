"""SGM's three CUDA kernels, their wrappers and their plain versions.

  census5x5_batch       kernel D  csrc/census_kernel.cu
  aggregate_paths_bhdw  kernel E  csrc/sgm_paths_kernel.cu
  sgm_wta_maps          kernel F  csrc/sgm_wta_kernel.cu

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its plain twin, ``<name>_plain``, for a CPU tensor. The plain twins are
the reference engine of matching/sgm.py in the kernels' layouts. The
volumes keep the reference kernels' [B, H, D, W] layout at the wrappers.
``launches`` counts the calls that launched a kernel, by kernel name.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import SGMParams
from ..matching.sgm import (_CARRY_BIG, aggregate_paths, census5x5,
                            right_view_volume, wta_maps)
from . import cuda_lib

launches = {"census": 0, "sgm_paths": 0, "sgm_wta": 0}

# the least disparity count the kernels E and F take; past D = 256 each
# takes its second path (csrc/sgm_paths_kernel.cu, csrc/sgm_wta_kernel.cu)
D_MIN = 2
_P_MAX = (1 << 31) - 1 - _CARRY_BIG     # penalties the path kernel takes


def _fn(lib_name: str, fn_name: str, n_ptr: int, n_int: int):
    fn = getattr(cuda_lib.load(lib_name), fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_d(D: int) -> None:
    if D < D_MIN:
        raise ValueError(f"the SGM kernels take D >= {D_MIN}, got D = {D}")


# ---- D: census ------------------------------------------------------------

def census5x5_batch_plain(img_u8_b: torch.Tensor) -> torch.Tensor:
    return census5x5(img_u8_b)


def census5x5_batch(img_u8_b: torch.Tensor) -> torch.Tensor:
    """uint8 [N, H, W] -> int32 [N, H, W] 24-bit census codes."""
    if not img_u8_b.is_cuda:
        return census5x5_batch_plain(img_u8_b)
    N, H, W = img_u8_b.shape
    cuda_lib.expect(img_u8_b, "img", torch.uint8, (N, H, W), img_u8_b.device)
    out = torch.empty((N, H, W), dtype=torch.int32, device=img_u8_b.device)
    cuda_lib.launch(_fn("census_kernel", "census5x5", 2, 3), "census5x5",
                    img_u8_b, img_u8_b.data_ptr(), out.data_ptr(), N, H, W)
    launches["census"] += 1
    return out


# ---- E: path aggregation ----------------------------------------------------

def aggregate_paths_bhdw_plain(cost_bhdw: torch.Tensor, params: SGMParams
                               ) -> torch.Tensor:
    return aggregate_paths(cost_bhdw.transpose(-3, -2), params
                           ).transpose(-3, -2).contiguous()


def aggregate_paths_bhdw(cost_bhdw: torch.Tensor, params: SGMParams
                         ) -> torch.Tensor:
    """8-path (4-path when num_paths < 8) aggregation of an int16 cost
    volume [B, H, D, W] -> int16 S [B, H, D, W]; the costs are >= 0, as the
    census volume's are. The kernels lay the cost out as [B, H, W, DP], d
    innermost and padded with _CARRY_BIG to DP (a multiple of 64), so that
    one step of a path reads DP contiguous costs; every direction writes
    its own path volume, and their sum is written in [B, H, D, W]. Any
    D >= 2; past D = 256 the kernel walks the lines with its carry in
    shared memory."""
    if not cost_bhdw.is_cuda:
        return aggregate_paths_bhdw_plain(cost_bhdw, params)
    B, H, D, W = cost_bhdw.shape
    _check_d(D)
    # P1, P2 >= 0 keeps every path value >= 0, which the kernel's single
    # clamp of the sum relies on; the upper limit keeps carry + P in int32
    if not (0 <= params.p1 <= _P_MAX and 0 <= params.p2 <= _P_MAX):
        raise ValueError(f"the path kernel takes 0 <= P1, P2 <= {_P_MAX}, "
                         f"got {params.p1}, {params.p2}")
    cuda_lib.expect(cost_bhdw, "cost", torch.int16, (B, H, D, W),
                    cost_bhdw.device)
    n_paths = 8 if params.num_paths >= 8 else 4
    DP = -(-D // 64) * 64
    dev = cost_bhdw.device
    padded = torch.empty((B, H, W, DP), dtype=torch.int16, device=dev)
    paths = torch.empty((n_paths, B, H, W, DP), dtype=torch.int16,
                        device=dev)
    S = torch.empty_like(cost_bhdw)
    cuda_lib.launch(_fn("sgm_paths_kernel", "sgm_paths", 4, 7), "sgm_paths",
                    cost_bhdw, cost_bhdw.data_ptr(), padded.data_ptr(),
                    paths.data_ptr(), S.data_ptr(), B, H, W, D, params.p1,
                    params.p2, n_paths)
    launches["sgm_paths"] += 1
    return S


# ---- F: WTA maps ----------------------------------------------------------

def sgm_wta_maps_plain(S_bhdw: torch.Tensor) -> torch.Tensor:
    vol = S_bhdw.transpose(-3, -2)                       # [B, D, H, W]
    maps = wta_maps(vol) + wta_maps(right_view_volume(vol))
    return torch.stack(maps, dim=-2).to(torch.int16)


def sgm_wta_maps(S_bhdw: torch.Tensor) -> torch.Tensor:
    """int16 [B, H, D, W] aggregated volume -> int16 [B, H, 10, W]: best,
    best_d, second, cost at d-1, cost at d+1 of the left view, then of the
    right view SR[d, v, u] = S[d, v, u+d] (_INVALID past the edge). The
    kernel takes S in [0, _CARRY_BIG], the path sum's range: it compares
    the values as unsigned 16-bit lanes. Any D >= 2; past D = 256 the
    kernel walks d in device memory, a thread a column, with the key
    value << 16 | d."""
    if not S_bhdw.is_cuda:
        return sgm_wta_maps_plain(S_bhdw)
    B, H, D, W = S_bhdw.shape
    _check_d(D)
    cuda_lib.expect(S_bhdw, "S", torch.int16, (B, H, D, W), S_bhdw.device)
    out = torch.empty((B, H, 10, W), dtype=torch.int16, device=S_bhdw.device)
    cuda_lib.launch(_fn("sgm_wta_kernel", "sgm_wta_maps", 2, 4),
                    "sgm_wta_maps", S_bhdw, S_bhdw.data_ptr(), out.data_ptr(),
                    B, H, D, W)
    launches["sgm_wta"] += 1
    return out
