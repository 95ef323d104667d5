"""BM's CUDA kernel G, its wrappers and their plain versions.

  bm_match_fused   kernel G   csrc/bm_kernel.cu
  bm_match_gated   kernel G with kernel S's texture gate and u8 map
                              folded in (the nodes' BM step)
  bm_match_diag    G'         the same source built with its diagnostic
                              entry: a per-part timing of G

bm_match_fused launches G for CUDA tensors (or raises) and runs its plain
twin, bm_match_fused_plain, for CPU tensors. Both return what the
reference package's bm_match_pallas returns: both views' disparities, the
left one after the L/R check and before the texture gate. bm_match_gated
(plain twin bm_match_gated_plain) adds the gate and the u8 map: on the
card inside G's two launches where G's strip takes the shape, else G's
path without shared memory, then kernel S (matching/bm.bm_gate_u8's
kernel), chosen by shape before any launch. bm_match_diag and
strip_width serve chip_smoke.py and the card's tests alone. ``launches``
counts the calls that launched a kernel, by kernel name ("bm": G, by
either entry).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import BMParams
from ..matching.bm import (WINDOW_MAX, _gate_cuda, bm_texture_gate_plain,
                           bm_views)
from ..matching.sgm import _lr_tail
from . import cuda_lib
from .convert import dmap_u8

launches = {"bm": 0, "bm_diag": 0}

D_MIN = 2                # the least disparity count the kernel takes
DIAG_MODES = ("full", "onewta", "boxonly", "nobox", "full32")


def _fn(lib_name: str, fn_name: str, extra_types, u8: bool = False):
    fn = getattr(cuda_lib.load(lib_name), fn_name)
    fn.argtypes = [ctypes.c_void_p] * (5 if u8 else 4) + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 2 + list(extra_types) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _shape_fn(lib_name: str, fn_name: str, restype=ctypes.c_int):
    """A C function of csrc/bm_kernel.cu of (B, H, W, D, r)."""
    fn = getattr(cuda_lib.load(lib_name), fn_name)
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = restype
    return fn


def bm_match_fused_plain(left_b: torch.Tensor, right_b: torch.Tensor,
                         params: BMParams = BMParams()
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    dL, dR = bm_views(left_b, right_b, params)
    return _lr_tail(dL, dR, params.disp_num, params)


def _checked(left_b: torch.Tensor, right_b: torch.Tensor, params: BMParams,
             lib_name: str):
    """Contiguous copies of the inputs, or ValueError for what the kernel
    does not take. G' (bm_kernel_diag) takes only the shapes G's strip
    takes."""
    D, win = params.disp_num, params.window
    if D < D_MIN:
        raise ValueError(f"the BM kernel takes D >= {D_MIN}, got D = {D}")
    if win % 2 == 0 or not 1 <= win <= WINDOW_MAX:
        raise ValueError(f"the BM kernel takes an odd window of 1 to "
                         f"{WINDOW_MAX}, got {win}")
    if left_b.dim() != 3 or left_b.shape != right_b.shape \
            or left_b.dtype != torch.uint8 or right_b.dtype != torch.uint8 \
            or right_b.device != left_b.device:
        raise ValueError(f"need two uint8 [B, H, W] batches of one shape on "
                         f"one device, got {left_b.dtype} "
                         f"{tuple(left_b.shape)} on {left_b.device} and "
                         f"{right_b.dtype} {tuple(right_b.shape)} on "
                         f"{right_b.device}")
    if lib_name == "bm_kernel_diag" and strip_width(
            tuple(left_b.shape), params, lib_name) == 0:
        raise ValueError(f"G' runs G's strip alone, which cannot hold "
                         f"{tuple(left_b.shape)} at D = {D}, window {win} "
                         f"in shared memory")
    return left_b.contiguous(), right_b.contiguous()


def _launch(lib_name, fn_name, left_b, right_b, params, extra,
            extra_types, u8=None):
    """Launch fn_name(L, R, dl, dr[, u8], B, H, W, D, r, lr_threshold,
    uniqueness, *extra, stream); returns (dl, dr)."""
    left_b, right_b = _checked(left_b, right_b, params, lib_name)
    B, H, W = left_b.shape
    dl = torch.empty((B, H, W), dtype=torch.float32, device=left_b.device)
    dr = torch.empty_like(dl)
    maps = (dl.data_ptr(), dr.data_ptr()) + (
        () if u8 is None else (u8.data_ptr(),))
    cuda_lib.launch(_fn(lib_name, fn_name, extra_types, u8 is not None),
                    fn_name, left_b, left_b.data_ptr(), right_b.data_ptr(),
                    *maps, B, H, W, params.disp_num, params.window // 2,
                    float(params.lr_threshold), float(params.uniqueness),
                    *extra)
    return dl, dr


def bm_match_fused(left_b: torch.Tensor, right_b: torch.Tensor,
                   params: BMParams = BMParams()
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W] pairs -> (D_left after the L/R check, D_right),
    float32 [B, H, W], -1 for invalid: kernel G on the card.

    Any D >= 2 and odd window up to WINDOW_MAX, as the reference package's
    bm_match: where G's strip does not take the shape (D > 256, a window
    past 255, a strip past a block's shared memory) the kernel takes its
    path without shared memory, which needs a scratch of two int32
    [H, W, D] volumes (bm_scratch_bytes; allocated here, the frames run
    one after another through it)."""
    if not left_b.is_cuda:
        return bm_match_fused_plain(left_b, right_b, params)
    n = (_shape_fn("bm_kernel", "bm_scratch_bytes", ctypes.c_longlong)(
        *left_b.shape, params.disp_num, params.window // 2)
        if left_b.dim() == 3 else 0)
    scratch = (torch.empty(n, dtype=torch.uint8, device=left_b.device)
               if n > 0 else None)
    out = _launch("bm_kernel", "bm_match", left_b, right_b, params,
                  (None if scratch is None else scratch.data_ptr(),),
                  (ctypes.c_void_p,))
    launches["bm"] += 1
    return out


def bm_match_gated_plain(left_b: torch.Tensor, right_b: torch.Tensor,
                         params: BMParams = BMParams()
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    dL, dR = bm_match_fused_plain(left_b, right_b, params)
    dL = bm_texture_gate_plain(left_b, dL, params)
    return dL, dR, dmap_u8(dL)


def bm_match_gated(left_b: torch.Tensor, right_b: torch.Tensor,
                   params: BMParams = BMParams()
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W] pairs -> (D_left after the texture gate and the L/R
    check, D_right, D_left's u8 map): the BM node's step, bm_match_fused
    followed by the texture gate (matching/bm.bm_texture_gate) and the u8
    map. On the card G's two launches where its strip takes the shape
    (strip_width > 0: the texture summed by the strip, the u8 map written
    by its L/R check); elsewhere G then kernel S, one launch each."""
    if not left_b.is_cuda:
        return bm_match_gated_plain(left_b, right_b, params)
    win = params.window
    thr = params.texture_threshold * win
    if not -2 ** 31 <= thr < 2 ** 31:
        raise ValueError(f"the BM kernel takes an int32 texture_threshold *"
                         f" window, got {thr}")
    left_b, right_b = _checked(left_b, right_b, params, "bm_kernel")
    if strip_width(tuple(left_b.shape), params) == 0:
        dL, dR = bm_match_fused(left_b, right_b, params)
        gated, u8 = _gate_cuda(left_b, dL, params, gated=True, u8=True)
        return gated, dR, u8
    u8 = torch.empty(left_b.shape, dtype=torch.uint8, device=left_b.device)
    dl, dr = _launch("bm_kernel", "bm_match_gated", left_b, right_b, params,
                     (thr,), (ctypes.c_int,), u8)
    launches["bm"] += 1
    return dl, dr, u8


def strip_width(shape: Tuple[int, int, int], params: BMParams,
                lib_name: str = "bm_kernel") -> int:
    """The columns a block of G owns (64 or 32) at a [B, H, W] shape, as
    bm_match_fused's launch chooses them; 0 where it takes its path
    without shared memory."""
    return _shape_fn(lib_name, "bm_strip_width")(
        *shape, params.disp_num, params.window // 2)


def bm_match_diag(left_b: torch.Tensor, right_b: torch.Tensor,
                  params: BMParams, mode: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """G' on the card: G with its parts gated by ``mode`` (one of
    DIAG_MODES), for timing them. "full" is G; "onewta" the left view
    alone, its box and WTA (dr = dl, no L/R check); "boxonly" both views'
    boxes without a WTA (each output its view's cost summed over d);
    "nobox" both WTAs on the centre row's AD without the box, no L/R
    check; "full32" G with strips of 32 columns at every shape (G takes 64
    where a batch fills the card, see strip_width)."""
    if not left_b.is_cuda:
        raise ValueError("bm_match_diag runs on the card only")
    out = _launch("bm_kernel_diag", "bm_match_diag", left_b, right_b, params,
                  (DIAG_MODES.index(mode),), (ctypes.c_int,))
    launches["bm_diag"] += 1
    return out
