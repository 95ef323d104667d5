"""Bilinear remap (undistort/rectify warp) of uint8 frames in PyTorch.

Equivalent of the per-frame cv::remap(..., INTER_LINEAR, BORDER_CONSTANT(0))
calls at point_cloud.cpp:440,481: out-of-range source taps read 0. The
maps are precomputed once on the host (geometry.rectify); per frame this
is a gather + lerp.

Integer images use 15-bit fixed-point weights (sx = rint(2^15 * mapx),
rint rounding half to even like torch.round) with an exact two-stage lerp
in integer-valued f32: a horizontal blend at scale 2^15 (every product
<= 255*2^15 < 2^23 is exact), a renormalization with round-half-up, then
the vertical blend the same way. Every f32 operation is exact, so the
result does not depend on fusion or on the device. sx converts to int32
as XLA converts (ops/convert.to_int32: saturating, NaN -> 0), so a NaN or
far out-of-range map entry samples what the reference samples.

remap_bilinear and remap_bilinear_pair are wrappers: on CUDA tensors they
launch kernel N (csrc/remap_kernel.cu, one launch a call: the pair call
warps both views in one launch; a block stages each frame's source window
of its output tile in shared memory where the window fits, else gathers
from global memory), on CPU tensors they run the plain version,
remap_bilinear_plain, which the kernel equals bit for bit.
``launches["remap"]`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..ops import cuda_lib
from ..ops.convert import to_int32

_FRAC = 15
_ONE = float(1 << _FRAC)          # 32768.0
_HALF = float(1 << (_FRAC - 1))   # 16384.0

launches = {"remap": 0}
# the most views one launch of kernel N takes (csrc/remap_kernel.cu kViews)
_VIEWS = 2


def _fixed15(mapx: torch.Tensor, mapy: torch.Tensor):
    """rint(2^15*coord) -> (integer tap coordinate, integer-valued f32
    fractional weights in [0, 2^15)). The rounded value is integral, so
    to_int32's truncation is exact; it saturates and sends NaN to 0."""
    sx = to_int32(torch.round(mapx * _ONE))
    sy = to_int32(torch.round(mapy * _ONE))
    mask = (1 << _FRAC) - 1
    return (sx >> _FRAC, sy >> _FRAC,
            (sx & mask).to(torch.float32), (sy & mask).to(torch.float32))


def _lerp15(v00, v01, v10, v11, fx, fy):
    wx0 = _ONE - fx
    h0 = torch.floor((v00 * wx0 + v01 * fx + _HALF) * (1.0 / _ONE))
    h1 = torch.floor((v10 * wx0 + v11 * fx + _HALF) * (1.0 / _ONE))
    wy0 = _ONE - fy
    return torch.floor((h0 * wy0 + h1 * fy + _HALF) * (1.0 / _ONE))


def _check_frames(img: torch.Tensor) -> None:
    if img.dtype != torch.uint8:
        raise TypeError(f"remap_bilinear takes uint8 frames, got {img.dtype}")


def remap_bilinear_plain(img: torch.Tensor, mapx: torch.Tensor,
                         mapy: torch.Tensor) -> torch.Tensor:
    """Sample uint8 img [..., H, W] at (mapx, mapy) [Ho, Wo] float32
    source coordinates; returns uint8 [..., Ho, Wo]."""
    _check_frames(img)
    H, W = img.shape[-2:]
    x0, y0, fx, fy = _fixed15(mapx, mapy)
    flat = img.reshape(*img.shape[:-2], H * W)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(-1)
        v = flat[..., idx].reshape(*img.shape[:-2], *mapx.shape)
        return torch.where(valid, v.to(torch.float32), 0.0)

    out = _lerp15(tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0),
                  tap(y0 + 1, x0 + 1), fx, fy)
    return out.to(torch.uint8)


def _remap_cuda(views: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]],
                paths: Optional[torch.Tensor] = None) -> list:
    """Kernel N on up to _VIEWS (img, mapx, mapy) triples in one launch.
    Every view has the same leading dimensions, frame shape and map
    shape; each has its own maps. The inputs stay alive in ``keep`` until
    the launch is queued. ``paths``, an int32 [2] tensor on the card, gains
    the launch's output tiles that took the kernel's staged path and its
    global one (csrc/remap_kernel.cu)."""
    img0, mx0, _ = views[0]
    dev = img0.device
    lead, (H, W), (Ho, Wo) = img0.shape[:-2], img0.shape[-2:], mx0.shape
    F = 1
    for n in lead:
        F *= n
    if mx0.dim() != 2 or F * H * W >= 2 ** 31 or F * Ho * Wo >= 2 ** 31:
        raise ValueError(f"kernel N takes [..., H, W] frames and [Ho, Wo] "
                         f"maps under 2^31 elements, got {tuple(img0.shape)}"
                         f" and {tuple(mx0.shape)}")
    args, outs, keep = [], [], []
    for img, mx, my in views:
        _check_frames(img)
        if img.shape != img0.shape:
            raise ValueError(f"kernel N: views {tuple(img0.shape)} and "
                             f"{tuple(img.shape)} differ")
        for m in (mx, my):
            if m.dtype != torch.float32 or m.shape != mx0.shape \
                    or m.device != dev or img.device != dev:
                raise ValueError(
                    f"kernel N: expected float32 {tuple(mx0.shape)} maps and"
                    f" frames on {dev}, got {m.dtype} {tuple(m.shape)} on "
                    f"{m.device}, frames on {img.device}")
        img, mx, my = img.contiguous(), mx.contiguous(), my.contiguous()
        keep += [img, mx, my]
        out = torch.empty((*lead, Ho, Wo), dtype=torch.uint8, device=dev)
        args += [img.data_ptr(), mx.data_ptr(), my.data_ptr(),
                 out.data_ptr()]
        outs.append(out)
    args += [None] * (4 * (_VIEWS - len(views)))
    fn = cuda_lib.load("remap_kernel").remap_bilinear_u8
    fn.argtypes = [ctypes.c_void_p] * (4 * _VIEWS) + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    if paths is not None:
        cuda_lib.expect(paths, "paths", torch.int32, (2,), dev)
    if F and Ho * Wo:
        cuda_lib.launch(fn, "remap", img0, *args, len(views), F, H, W, Ho,
                        Wo, None if paths is None else paths.data_ptr())
        launches["remap"] += 1
    return outs


def remap_bilinear(img: torch.Tensor, mapx: torch.Tensor,
                   mapy: torch.Tensor) -> torch.Tensor:
    """remap_bilinear_plain's contract: kernel N on a CUDA tensor, the
    plain version on a CPU one."""
    if img.is_cuda:
        return _remap_cuda([(img, mapx, mapy)])[0]
    return remap_bilinear_plain(img, mapx, mapy)


def remap_bilinear_pair(left: torch.Tensor, right: torch.Tensor,
                        lmap: Tuple[torch.Tensor, torch.Tensor],
                        rmap: Tuple[torch.Tensor, torch.Tensor]):
    """(remap_bilinear(left, *lmap), remap_bilinear(right, *rmap)); on the
    card one launch of kernel N where the two views share their shapes."""
    if left.is_cuda and left.shape == right.shape \
            and lmap[0].shape == rmap[0].shape:
        return tuple(_remap_cuda([(left, *lmap), (right, *rmap)]))
    return remap_bilinear(left, *lmap), remap_bilinear(right, *rmap)
