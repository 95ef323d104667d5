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
result does not depend on fusion or on the device.
"""
from __future__ import annotations

import torch

_FRAC = 15
_ONE = float(1 << _FRAC)          # 32768.0
_HALF = float(1 << (_FRAC - 1))   # 16384.0


def _fixed15(mapx: torch.Tensor, mapy: torch.Tensor):
    """rint(2^15*coord) -> (integer tap coordinate, integer-valued f32
    fractional weights in [0, 2^15))."""
    sx = torch.round(mapx * _ONE).to(torch.int32)
    sy = torch.round(mapy * _ONE).to(torch.int32)
    mask = (1 << _FRAC) - 1
    return (sx >> _FRAC, sy >> _FRAC,
            (sx & mask).to(torch.float32), (sy & mask).to(torch.float32))


def _lerp15(v00, v01, v10, v11, fx, fy):
    wx0 = _ONE - fx
    h0 = torch.floor((v00 * wx0 + v01 * fx + _HALF) * (1.0 / _ONE))
    h1 = torch.floor((v10 * wx0 + v11 * fx + _HALF) * (1.0 / _ONE))
    wy0 = _ONE - fy
    return torch.floor((h0 * wy0 + h1 * fy + _HALF) * (1.0 / _ONE))


def remap_bilinear(img: torch.Tensor, mapx: torch.Tensor,
                   mapy: torch.Tensor) -> torch.Tensor:
    """Sample uint8 img [..., H, W] at (mapx, mapy) [Ho, Wo] float32
    source coordinates; returns uint8 [..., Ho, Wo]."""
    if img.dtype != torch.uint8:
        raise TypeError(f"remap_bilinear takes uint8 frames, got {img.dtype}")
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
