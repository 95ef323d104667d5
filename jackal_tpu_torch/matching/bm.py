"""Block matching (BM): SAD cost with a box window, WTA, L/R check.

BASELINE config 5's engine in the reference package (bench.py's headline
runs it at D = 64, and at D = 256 in bench_bm256): the absolute
difference of the left image and the right one shifted by d, summed over
a (2r+1)^2 zero-padded box; winner-take-all with the smallest d on ties,
uniqueness as "best < uniqueness * (the best outside best_d +- 1)",
parabolic sub-pixel from the costs at best_d +- 1, a texture gate and the
left/right consistency check. Invalid costs (u < d in the left view, u + d
>= W in the right one) are 1 << 24 at every D, and that value enters the
parabola where best_d +- 1 is invalid.

This is the plain engine, on [..., H, W] tensors: the reference of kernel
G (ops/bm_kernel.py), whose plain twin is built from bm_views and the L/R
check. bm_match equals the reference package's bm_match bit for bit. The
texture gate is kernel S (csrc/bm_gate_kernel.cu) on the card:
bm_texture_gate gives the gated float map, bm_gate_u8 its u8 map, each
one launch; bm_texture_gate_plain and bm_gate_u8_plain are the CPU's.
The nodes take the gate and the u8 map from kernel G itself where its
strip takes the shape (ops/bm_kernel.bm_match_gated), and S only past it.
``launches`` counts the calls that launched S.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BMParams
from ..ops import cuda_lib
from ..ops.convert import dmap_u8
from .sgm import _lr_tail

_BIG = 1 << 24        # invalid-cost sentinel, as the reference's bm_match
# the widest window kernels G and S take, r = 1450: the reference's int32
# box sums, at most (2r + 1)^2 * 255, wrap past it
WINDOW_MAX = 2901

launches = {"bm_gate": 0}

Image = Union[np.ndarray, torch.Tensor]


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Separable (2r+1)^2 box sum of int32 [..., H, W], zero outside the
    frame: a zero-padded cumsum and a slice difference per axis, exact in
    int32."""
    k = 2 * r + 1

    def along(a: torch.Tensor, dim: int) -> torch.Tensor:
        n = a.shape[dim]
        pad = (r, r) if dim == -1 else (0, 0, r, r)
        c = torch.cumsum(F.pad(a, pad), dim, dtype=torch.int32)
        c = F.pad(c, (1, 0) if dim == -1 else (0, 0, 1, 0))
        return c.narrow(dim, k, n) - c.narrow(dim, 0, n)

    return along(along(x, -1), -2)


def _wta(c: torch.Tensor, params: BMParams) -> torch.Tensor:
    """Disparity of an int32 cost volume [..., D, H, W]: float32 [..., H, W],
    -1 where the best is not unique. The uniqueness factor is rounded to
    float32 first, as the reference's weakly typed scalar is."""
    D = c.shape[-3]
    dev = c.device
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)
    best_d = torch.argmin(c, dim=-3, keepdim=True)          # first minimum
    best = c.gather(-3, best_d)
    ds = torch.arange(D, device=dev)[:, None, None]
    second = torch.where((ds - best_d).abs() <= 1, big, c).amin(-3)
    # the least of the cost at best_d -+ 1 and the invalid cost, as the
    # reference's masked minima: a real cost passes 1 << 24 past window 255
    cm = torch.where(best_d > 0, c.gather(-3, (best_d - 1).clamp_min(0)),
                     big).clamp_max(_BIG)
    cp = torch.where(best_d < D - 1,
                     c.gather(-3, (best_d + 1).clamp_max(D - 1)),
                     big).clamp_max(_BIG)
    best_d, best, cm, cp = (x.squeeze(-3) for x in (best_d, best, cm, cp))
    return wta_disparity(best_d, best, second, cm, cp, D, params)


def wta_disparity(bd: torch.Tensor, best: torch.Tensor, second: torch.Tensor,
                  cm: torch.Tensor, cp: torch.Tensor, D: int,
                  params: BMParams) -> torch.Tensor:
    """The WTA's last step from a pixel's best d and cost, its least cost
    outside best_d +- 1 and its costs at best_d -+ 1: float32 best_d + the
    parabola's offset, -1 where best is not below uniqueness * second (in
    float32)."""
    f32 = torch.float32
    dev = bd.device
    ratio = torch.full((), params.uniqueness, dtype=f32, device=dev)
    unique = best.to(f32) < ratio * second.to(f32)
    den = cm + cp - 2 * best
    offs = torch.where((bd > 0) & (bd < D - 1) & (den > 0),
                       (cm - cp).to(f32) / (2.0 * den.to(f32)),
                       torch.zeros((), dtype=f32, device=dev))
    return torch.where(unique, bd.to(f32) + offs,
                       torch.full((), -1.0, dtype=f32, device=dev))


def bm_views(left: Image, right: Image, params: BMParams = BMParams()
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both WTA disparities of uint8 [..., H, W] pairs before any check:
    (D_left, D_right) float32, -1 where not unique. The right view's cost
    is cost_R(u, d) = cost_L(u + d, d)."""
    L = torch.as_tensor(left).to(torch.int32)
    R = torch.as_tensor(right).to(torch.int32)
    W = L.shape[-1]
    D = params.disp_num
    r = params.window // 2
    u = torch.arange(W, device=L.device)
    R_pad = F.pad(R, (D, 0))          # R(x - d) reads 0 where x < d
    costs = []
    for d in range(D):
        c = _box_filter((L - R_pad[..., D - d:D - d + W]).abs(), r)
        costs.append(torch.where(u >= d, c, _BIG))
    costs_r = [torch.cat([c[..., d:], torch.full_like(c[..., :d], _BIG)], -1)
               for d, c in enumerate(costs)]
    return (_wta(torch.stack(costs, -3), params),
            _wta(torch.stack(costs_r, -3), params))


def bm_texture_gate_plain(left: Image, dL: torch.Tensor, params: BMParams
                          ) -> torch.Tensor:
    L = torch.as_tensor(left).to(torch.int32)
    W = L.shape[-1]
    cols = torch.clamp(torch.arange(-1, W + 1, device=L.device), 0, W - 1)
    Lp = L[..., cols]
    tex = _box_filter((Lp[..., 2:] - Lp[..., :-2]).abs(), params.window // 2)
    return torch.where(tex >= params.texture_threshold * params.window, dL,
                       torch.full((), -1.0, device=dL.device))


def bm_gate_u8_plain(left: Image, dL: torch.Tensor, params: BMParams
                     ) -> torch.Tensor:
    return dmap_u8(bm_texture_gate_plain(left, dL, params))


def bm_texture_gate(left: Image, dL: torch.Tensor, params: BMParams
                    ) -> torch.Tensor:
    """Invalidate low-texture pixels: the box sum of the edge-padded
    Sobel-x magnitude |L(x+1) - L(x-1)| below texture_threshold * window.
    uint8 left frames and float32 dL [..., H, W]; kernel S where dL lies on
    the card, the plain version where it lies on the CPU."""
    if not dL.is_cuda:
        return bm_texture_gate_plain(left, dL, params)
    return _gate_cuda(left, dL, params, gated=True, u8=False)[0]


def bm_gate_u8(left: Image, dL: torch.Tensor, params: BMParams
               ) -> torch.Tensor:
    """The texture gate's u8 map, ops/convert.dmap_u8 of bm_texture_gate:
    the BM node's published map as kernel S alone computes it, one launch
    on the card (the node takes it from ops/bm_kernel.bm_match_gated)."""
    if not dL.is_cuda:
        return bm_gate_u8_plain(left, dL, params)
    return _gate_cuda(left, dL, params, gated=False, u8=True)[1]


def _gate_cuda(left, dL: torch.Tensor, params: BMParams, gated: bool,
               u8: bool):
    """Kernel S on [..., H, W] frames as [N, H, W], one launch: (the gated
    float32 map if ``gated``, its u8 map if ``u8``), None for what was not
    asked. A left batch that is not contiguous (a cropped view) is copied
    first."""
    if not isinstance(left, torch.Tensor) or left.device != dL.device \
            or left.dtype != torch.uint8 or left.shape != dL.shape \
            or dL.dtype != torch.float32 or dL.dim() < 2:
        raise ValueError(
            f"kernel S takes uint8 left frames and float32 dL [..., H, W] "
            f"of one shape on one card, got {type(left).__name__} "
            f"{getattr(left, 'dtype', None)} "
            f"{tuple(getattr(left, 'shape', ()))} on "
            f"{getattr(left, 'device', None)} and {dL.dtype} "
            f"{tuple(dL.shape)} on {dL.device}")
    win = params.window
    thr = params.texture_threshold * win
    if not 1 <= win <= WINDOW_MAX or not -2 ** 31 <= thr < 2 ** 31:
        raise ValueError(f"kernel S takes windows of 1 to {WINDOW_MAX}"
                         f" and an int32 texture_threshold * window, got "
                         f"{win} and {thr}")
    H, W = dL.shape[-2:]
    N = dL.numel() // max(H * W, 1)
    img = left.contiguous().view(N, H, W)
    d = dL.contiguous().view(N, H, W)
    dev = dL.device
    cuda_lib.expect(img, "left", torch.uint8, (N, H, W), dev, 1)
    cuda_lib.expect(d, "dL", torch.float32, (N, H, W), dev, 4)
    out_f = (torch.empty((N, H, W), dtype=torch.float32, device=dev)
             if gated else None)
    out_u8 = (torch.empty((N, H, W), dtype=torch.uint8, device=dev)
              if u8 else None)
    fn = getattr(cuda_lib.load("bm_gate_kernel"), "bm_gate")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_lib.launch(fn, "bm_gate", d, img.data_ptr(), d.data_ptr(),
                    None if out_f is None else out_f.data_ptr(),
                    None if out_u8 is None else out_u8.data_ptr(), N, H, W,
                    win // 2, thr)
    launches["bm_gate"] += 1
    return tuple(None if o is None else o.view(dL.shape)
                 for o in (out_f, out_u8))


def bm_finalize(left: Image, dL: torch.Tensor, dR: torch.Tensor,
                params: BMParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """The texture gate, then the L/R check (both only write -1, so their
    order does not matter: kernel G checks first and the pipeline gates
    after)."""
    dL = bm_texture_gate(left, dL, params)
    return _lr_tail(dL, dR, params.disp_num, params)


def bm_match(left: Image, right: Image, params: BMParams = BMParams()
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAD block matching of uint8 [..., H, W] pairs: (D_left, D_right)
    float32, -1 for invalid."""
    return bm_finalize(left, *bm_views(left, right, params), params)


bm_match_batch = bm_match       # [B, H, W] pairs: the batch is a leading axis
