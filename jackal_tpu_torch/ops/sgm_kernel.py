"""SGM's five CUDA kernels, their wrappers and their plain versions.

  census5x5_batch       kernel D   csrc/census_kernel.cu
  census5x5_pair        kernel D   the same, left and right where they lie
  sgm_cost_volume       kernel O1  csrc/sgm_tail_kernel.cu
  aggregate_paths_bhdw  kernel E   csrc/sgm_paths_kernel.cu
  sgm_wta_maps          kernel F   csrc/sgm_wta_kernel.cu
  sgm_epilogue          kernel O2  csrc/sgm_tail_kernel.cu
  sgm_wta_epilogue      F with O2 folded in (csrc/sgm_wta_kernel.cu, one
                        launch) or, for true_right and past D = 64, F then
                        O2 (sgm_tail_route)

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its plain twin, ``<name>_plain``, for a CPU tensor. The plain twins are
the reference engine of matching/sgm.py in the kernels' layouts. The
volumes keep the reference kernels' [B, H, D, W] layout at the wrappers.
``launches`` counts the calls that launched a kernel, by kernel name;
F's three kernels (its maps, the path past D = 256, and F with O2 folded
in) count as "sgm_wta".
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import SGMParams
from ..matching.sgm import (_CARRY_BIG, _lr_tail, _wta_from_maps,
                            aggregate_paths, census5x5,
                            census_cost_volume_hdw, right_view_volume,
                            shift_by_d, wta_maps)
from . import cuda_lib
from .convert import dmap_u8

launches = {"census": 0, "sgm_paths": 0, "sgm_wta": 0, "sgm_cost": 0,
            "sgm_epilogue": 0}

# the least disparity count the kernels E, F, O1 and O2 take; past D = 256
# E and F take their second paths (csrc/sgm_paths_kernel.cu,
# csrc/sgm_wta_kernel.cu)
D_MIN = 2
_P_MAX = (1 << 31) - 1 - _CARRY_BIG     # penalties the path kernel takes
# the largest D at which F with O2 folded in (csrc/sgm_wta_kernel.cu) was
# measured faster than F then O2 on the H100 (the slab with its halo cuts
# the blocks an SM holds as D grows: at D = 96 the fold took 0.0729 ms
# against 0.0576, at D = 64 0.0367 against 0.0374; PERF.md section 6)
FOLD_MAX_D = 64


def _fn(lib_name: str, fn_name: str, n_ptr: int, n_int: int,
        n_float: int = 0):
    fn = getattr(cuda_lib.load(lib_name), fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_float] * n_float + [ctypes.c_void_p]
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


def census5x5_pair(left_b: torch.Tensor, right_b: torch.Tensor
                   ) -> torch.Tensor:
    """uint8 [B, H, W] left and right batches -> int32 [2B, H, W] codes,
    the left frames' then the right ones': census5x5_batch of their
    concatenation, which kernel D reads where the two batches lie (one
    launch, no copy). A batch that is not contiguous (a cropped view) is
    copied first."""
    if not left_b.is_cuda:
        return census5x5_batch_plain(torch.cat([left_b, right_b]))
    if left_b.dim() != 3 or right_b.shape != left_b.shape:
        raise ValueError(f"need two uint8 [B, H, W] batches of one shape, "
                         f"got {tuple(left_b.shape)} and "
                         f"{tuple(right_b.shape)}")
    B, H, W = left_b.shape
    left_b, right_b = left_b.contiguous(), right_b.contiguous()
    for name, t in (("left", left_b), ("right", right_b)):
        cuda_lib.expect(t, name, torch.uint8, (B, H, W), left_b.device)
    out = torch.empty((2 * B, H, W), dtype=torch.int32, device=left_b.device)
    cuda_lib.launch(_fn("census_kernel", "census5x5_pair", 3, 3),
                    "census5x5_pair", left_b, left_b.data_ptr(),
                    right_b.data_ptr(), out.data_ptr(), B, H, W)
    launches["census"] += 1
    return out


# ---- O1: the cost volume ----------------------------------------------------

def sgm_cost_volume_plain(codes_l: torch.Tensor, codes_r: torch.Tensor,
                          D: int, right: bool = False):
    cost = census_cost_volume_hdw(codes_l, codes_r, D)
    return (cost, shift_by_d(cost, -2)) if right else cost


def sgm_cost_volume(codes_l: torch.Tensor, codes_r: torch.Tensor, D: int,
                    right: bool = False):
    """int32 census codes [B, H, W] of the left and right frames -> the
    int16 Hamming cost volume [B, H, D, W] (matching/sgm.
    census_cost_volume_hdw): popcount(cl[u] ^ cr[u - d]), _INVALID where
    u < d. With ``right`` also the right view's volume, shift_by_d(cost,
    -2), from the same launch: (cost, cost_right). Any D >= 2."""
    if not codes_l.is_cuda:
        return sgm_cost_volume_plain(codes_l, codes_r, D, right)
    _check_d(D)
    if codes_l.dim() != 3:
        raise ValueError(f"need int32 [B, H, W] codes, got "
                         f"{tuple(codes_l.shape)}")
    B, H, W = codes_l.shape
    # 16-byte loads of the codes where W % 8 == 0, scalar ones otherwise
    align = 16 if W % 8 == 0 else 4
    for name, t in (("codes_l", codes_l), ("codes_r", codes_r)):
        cuda_lib.expect(t, name, torch.int32, (B, H, W), codes_l.device,
                        align)
    cost = torch.empty((B, H, D, W), dtype=torch.int16, device=codes_l.device)
    cost_r = torch.empty_like(cost) if right else None
    cuda_lib.launch(_fn("sgm_tail_kernel", "sgm_cost_volume", 4, 4),
                    "sgm_cost_volume", codes_l, codes_l.data_ptr(),
                    codes_r.data_ptr(), cost.data_ptr(),
                    None if cost_r is None else cost_r.data_ptr(), B, H, W, D)
    launches["sgm_cost"] += 1
    return (cost, cost_r) if right else cost


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


# ---- O2: the epilogue -------------------------------------------------------

def sgm_epilogue_plain(maps: torch.Tensor, maps_right, D: int,
                       params: SGMParams, u8: bool = False):
    m = maps.to(torch.int32)
    dL = _wta_from_maps(*m[:, :, 0:5].unbind(2), D, params)
    mr = m[:, :, 5:10] if maps_right is None \
        else maps_right.to(torch.int32)[:, :, 0:5]
    dR = _wta_from_maps(*mr.unbind(2), D, params)
    dL, dR = _lr_tail(dL, dR, D, params)
    return (dL, dR, dmap_u8(dL)) if u8 else (dL, dR)


def sgm_epilogue(maps: torch.Tensor, maps_right, D: int, params: SGMParams,
                 u8: bool = False):
    """The float epilogue of F's int16 maps [B, H, 10, W]: each view's
    uniqueness and parabolic sub-pixel (matching/sgm._wta_from_maps), the
    right view from rows 5-9 of ``maps`` or, where ``maps_right`` (F's
    maps of the separately aggregated right volume, true_right) is given,
    from its rows 0-4; then the L/R check (_lr_tail). Returns (dL, dR)
    float32 [B, H, W], -1 for invalid, and with ``u8`` also dL's u8 map
    (ops/convert.dmap_u8)."""
    if not maps.is_cuda:
        return sgm_epilogue_plain(maps, maps_right, D, params, u8)
    _check_d(D)
    if maps.dim() != 4 or maps.shape[2] != 10:
        raise ValueError(f"need int16 maps [B, H, 10, W], got "
                         f"{tuple(maps.shape)}")
    B, H, _, W = maps.shape
    dev = maps.device
    cuda_lib.expect(maps, "maps", torch.int16, (B, H, 10, W), dev, 2)
    if maps_right is not None:
        cuda_lib.expect(maps_right, "maps_right", torch.int16, (B, H, 10, W),
                        dev, 2)
    dl = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    dr = torch.empty_like(dl)
    out = torch.empty((B, H, W), dtype=torch.uint8, device=dev) if u8 \
        else None
    # the factors as float32, as the plain version's tensors round them
    cuda_lib.launch(
        _fn("sgm_tail_kernel", "sgm_epilogue", 5, 4, 2), "sgm_epilogue",
        maps, maps.data_ptr(),
        None if maps_right is None else maps_right.data_ptr(), dl.data_ptr(),
        dr.data_ptr(), None if out is None else out.data_ptr(), B, H, W, D,
        float(np.float32(params.uniqueness)),
        float(np.float32(params.lr_threshold)))
    launches["sgm_epilogue"] += 1
    return (dl, dr, out) if u8 else (dl, dr)


# ---- F with O2 folded in ----------------------------------------------------

def sgm_tail_route(shape, true_right: bool) -> str:
    """The route of sgm_wta_epilogue on the card for an aggregated volume
    of this [B, H, D, W] shape, decided before any launch: "fold" (F with
    O2 in one launch) up to FOLD_MAX_D, else "F then O2" (true_right, whose
    right maps come from a second F; past FOLD_MAX_D, where the fold is
    slower). The fold's kernel itself takes any D whose slab fits a block's
    shared memory (D <= 183; its launcher refuses past it)."""
    D = shape[2]
    if true_right or D > FOLD_MAX_D:
        return "F then O2"
    return "fold"


def sgm_wta_epilogue_plain(S_bhdw: torch.Tensor, params: SGMParams,
                           u8: bool = False, S_right=None):
    maps_right = None if S_right is None else sgm_wta_maps_plain(S_right)
    return sgm_epilogue_plain(sgm_wta_maps_plain(S_bhdw), maps_right,
                              S_bhdw.shape[2], params, u8)


def _fold_cuda(S_bhdw: torch.Tensor, params: SGMParams, u8: bool):
    """One launch of F with O2 folded in."""
    B, H, D, W = S_bhdw.shape
    dev = S_bhdw.device
    cuda_lib.expect(S_bhdw, "S", torch.int16, (B, H, D, W), dev)
    dl = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    dr = torch.empty_like(dl)
    out = torch.empty((B, H, W), dtype=torch.uint8, device=dev) if u8 \
        else None
    # the factors as float32, as the plain version's tensors round them
    cuda_lib.launch(
        _fn("sgm_wta_kernel", "sgm_wta_epilogue", 4, 4, 2), "sgm_wta_epilogue", S_bhdw,
        S_bhdw.data_ptr(), dl.data_ptr(), dr.data_ptr(),
        None if out is None else out.data_ptr(), B, H, D, W,
        float(np.float32(params.uniqueness)),
        float(np.float32(params.lr_threshold)))
    launches["sgm_wta"] += 1
    return (dl, dr, out) if u8 else (dl, dr)


def sgm_wta_epilogue(S_bhdw: torch.Tensor, params: SGMParams,
                     u8: bool = False, S_right=None):
    """The SGM engine's tail on an aggregated int16 volume S [B, H, D, W]:
    both views' WTA maps (F), their uniqueness and sub-pixel, the L/R check
    and, with ``u8``, dL's u8 map (O2). Returns (dL, dR[, u8]) as
    sgm_epilogue does, equal to sgm_wta_epilogue_plain. ``S_right``, the
    separately aggregated right volume (true_right), gives the right view's
    maps. On the card one launch of F with O2 folded in, or F then O2 where
    sgm_tail_route says so."""
    if not S_bhdw.is_cuda:
        return sgm_wta_epilogue_plain(S_bhdw, params, u8, S_right)
    if S_bhdw.dim() != 4:
        raise ValueError(f"need an int16 volume [B, H, D, W], got "
                         f"{tuple(S_bhdw.shape)}")
    D = S_bhdw.shape[2]
    _check_d(D)
    if sgm_tail_route(tuple(S_bhdw.shape), S_right is not None) == "fold":
        return _fold_cuda(S_bhdw, params, u8)
    maps_right = None if S_right is None else sgm_wta_maps(S_right)
    return sgm_epilogue(sgm_wta_maps(S_bhdw), maps_right, D, params, u8)
