"""ELAS postprocessing in PyTorch, per frame ([H, W] float32 maps).

Reference: leftRightConsistencyCheck (elas.cpp:909-979), gapInterpolation
(1101-1284), adaptiveMean (1287-1492, SSE approximate bilateral), median
(1494-1560). The speckle filter (removeSmallSegments, 981-1099) is the
native BFS (native_prior.remove_small_segments_native) between the L/R
check and this tail.

Exactness: every float operation here is a single eager PyTorch op, so no
multiply is fused into an add, and f32 division is correctly rounded on
both the CPU and the card. The adaptive mean's sums keep the reference's
SSE lane order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...config import ElasParams


def left_right_consistency_check(
    D1: torch.Tensor, D2: torch.Tensor, params: ElasParams = ElasParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """elas.cpp:909-979 on [..., H, W] maps. Invalid -> -10.

    A pixel keeps its disparity when the other view, read at the warped
    column (int)(u -/+ d), agrees within lr_threshold."""
    W = D1.shape[-1]
    u = torch.arange(W, device=D1.device)

    def check(Da, Db, sign):
        uw = u.to(torch.float32) + sign * Da
        ok = (Da >= 0) & (uw >= 0) & (uw < W)
        s = torch.clamp(sign * (uw.to(torch.int32) - u), 0, params.disp_max)
        col = u + sign * s
        inside = (col >= 0) & (col < W)
        other = torch.gather(Db, -1, torch.clamp(col, 0, W - 1).to(torch.int64))
        other = torch.where(inside, other, -1e9)
        ok = ok & ((other - Da).abs() <= params.lr_threshold)
        return torch.where(ok, Da, -10.0)

    return check(D1, D2, -1), check(D2, D1, +1)


def speckle_size_eff(params: ElasParams) -> int:
    """elas.cpp:986-991: sqrt(speckle_size)*2 under subsampling."""
    if params.subsampling:
        return int(np.sqrt(np.float32(params.speckle_size)) * 2)
    return params.speckle_size


def gap_width_eff(params: ElasParams) -> int:
    """elas.cpp:1106-1111: ipol_gap_width/2+1 under subsampling."""
    if params.subsampling:
        return params.ipol_gap_width // 2 + 1
    return params.ipol_gap_width


def _interp(d1, d2):
    return torch.where((d1 - d2).abs() < 3.0, (d1 + d2) / 2.0,
                       torch.minimum(d1, d2))


def _gap_fill_rows(D: torch.Tensor, gap_width: int) -> torch.Tensor:
    """Row-wise gap interpolation (elas.cpp:1122-1166). Small gap widths
    (ROBOTICS: 3 px) look gap_width+1 columns each way; wide ones
    (MIDDLEBURY: 5000) find the nearest valid pixels with running maxima."""
    valid = D >= 0
    H, W = D.shape
    if gap_width <= 8:
        K = gap_width + 1
        big = -1e9
        Dp = F.pad(D, (K, K), value=big)
        d1 = torch.full_like(D, big)
        kl = torch.full(D.shape, K + 1, dtype=torch.int32, device=D.device)
        d2 = torch.full_like(D, big)
        kr = kl.clone()
        for k in range(K, 0, -1):  # nearest (smallest k) wins by overwrite
            lv = Dp[:, K - k:K - k + W]
            d1 = torch.where(lv >= 0, lv, d1)
            kl = torch.where(lv >= 0, k, kl)
            rv = Dp[:, K + k:K + k + W]
            d2 = torch.where(rv >= 0, rv, d2)
            kr = torch.where(rv >= 0, k, kr)
        gap_len = kl + kr - 1
        has_both = (d1 >= 0) & (d2 >= 0)
        fill = (~valid) & has_both & (gap_len <= gap_width)
        return torch.where(fill, _interp(d1, d2), D)

    idx = torch.arange(W, device=D.device).expand(H, W)
    left = torch.cummax(torch.where(valid, idx, -1), dim=1).values
    right = -torch.cummax(
        torch.where(valid, -idx, -W).flip(1), dim=1).values.flip(1)
    has_both = (left >= 0) & (right < W)
    gap_len = right - left - 1
    d1 = torch.gather(D, 1, torch.clamp(left, 0, W - 1))
    d2 = torch.gather(D, 1, torch.clamp(right, 0, W - 1))
    fill = (~valid) & has_both & (gap_len >= 1) & (gap_len <= gap_width)
    return torch.where(fill, _interp(d1, d2), D)


def _extrapolate_rows(D: torch.Tensor, gap_width: int) -> torch.Tensor:
    """Border extrapolation for add_corners mode (elas.cpp:1169-1198)."""
    valid = D >= 0
    W = D.shape[1]
    idx = torch.arange(W, device=D.device)[None, :]
    anyv = valid.any(1, keepdim=True)
    vi = valid.to(torch.uint8)
    first = torch.where(anyv, torch.argmax(vi, dim=1, keepdim=True), W)
    last = torch.where(
        anyv, W - 1 - torch.argmax(vi.flip(1), dim=1, keepdim=True), -1)
    dfirst = torch.gather(D, 1, torch.clamp(first, 0, W - 1))
    dlast = torch.gather(D, 1, torch.clamp(last, 0, W - 1))
    out = torch.where((idx < first) & (idx >= first - gap_width), dfirst, D)
    return torch.where((idx > last) & (idx <= last + gap_width), dlast, out)


def gap_interpolation(D: torch.Tensor,
                      params: ElasParams = ElasParams()) -> torch.Tensor:
    """elas.cpp:1101-1284: row pass then column pass (on the row result)."""
    g = gap_width_eff(params)
    out = _gap_fill_rows(D, g)
    if params.add_corners:
        out = _extrapolate_rows(out, g)
    out = _gap_fill_rows(out.t().contiguous(), g).t()
    if params.add_corners:
        out = _extrapolate_rows(out.t().contiguous(), g).t()
    return out.contiguous()


def _ref_absmask(x: torch.Tensor) -> torch.Tensor:
    """The reference's broken 'absolute value' (elas.cpp:1320):
    `_mm_set1_ps(0x7FFFFFFF)` builds the float 2^31 (bits 0x4F000000), so
    `_mm_and_ps(x, mask)` keeps only exponent bits {30,27,26,25,24} of x —
    NOT |x|. Emulated bit for bit."""
    return (x.contiguous().view(torch.int32) & 0x4F000000).view(torch.float32)


def _adaptive_pass(src: torch.Tensor, axis: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One 8-tap pass of the reference's approximate bilateral filter.

    Window offsets -4..+3 around the center; weight
    max(0, 4 - ref_absmask(v - center)). Returns (result, store_ok) with
    store_ok = weight_sum>0 and result>=0 (elas.cpp:1434-1437)."""
    x = src if axis == 1 else src.t()
    H, W = x.shape
    pad = F.pad(x, (4, 4), value=0.0)

    def tap(off):
        v = pad[:, 4 + off:4 + off + W]
        w = torch.clamp(4.0 - _ref_absmask(v - x), min=0.0)
        return v, w

    # SSE lane pairing: the circular val[8] buffer puts cols 4 apart in
    # lanes (k, k+4), which _mm_add_ps sums first; the horizontal reduce
    # then adds lanes 0..3 sequentially. Pair t = cols (c-4+t, c+t); lane of
    # pair t is (c+t)%4, so the sequential order rotates with c%4.
    pw, pf = [], []
    for t in range(4):
        v_a, w_a = tap(t - 4)
        v_b, w_b = tap(t)
        pw.append(w_a + w_b)
        pf.append(w_a * v_a + w_b * v_b)
    m = (torch.arange(W, device=x.device) % 4)[None, :]
    wsum = torch.zeros_like(x)
    fsum = torch.zeros_like(x)
    for mm in range(4):
        o = [(k - mm) % 4 for k in range(4)]
        wv = ((pw[o[0]] + pw[o[1]]) + pw[o[2]]) + pw[o[3]]
        fv = ((pf[o[0]] + pf[o[1]]) + pf[o[2]]) + pf[o[3]]
        wsum = torch.where(m == mm, wv, wsum)
        fsum = torch.where(m == mm, fv, fsum)

    d = fsum / torch.where(wsum > 0, wsum, 1.0)
    ok = (wsum > 0) & (d >= 0)
    res = torch.where(ok, d, x)
    return (res, ok) if axis == 1 else (res.t(), ok.t())


def adaptive_mean(D: torch.Tensor) -> torch.Tensor:
    """elas.cpp:1287-1492 (full-resolution 8-px variant), reproducing the
    reference's buffer semantics:

      D_copy = D with invalid -> -10 (valid values unchanged)
      D_tmp  = zero pages, invalid -> -10; horizontal pass writes only
               rows [3, H-4] x cols [4, W-4]
      final  = D overwritten only at rows [4, H-4] x cols [3, W-4] where the
               vertical pass stored
    """
    H, W = D.shape
    r = torch.arange(H, device=D.device)[:, None]
    c = torch.arange(W, device=D.device)[None, :]
    invalid = D < 0
    D_copy = torch.where(invalid, -10.0, D)

    hres, hok = _adaptive_pass(D_copy, axis=1)
    hmask = (r >= 3) & (r <= H - 4) & (c >= 4) & (c <= W - 4) & hok
    D_tmp = torch.where(invalid, -10.0, 0.0)
    D_tmp = torch.where(hmask, hres, D_tmp)

    vres, vok = _adaptive_pass(D_tmp, axis=0)
    vmask = (r >= 4) & (r <= H - 4) & (c >= 3) & (c <= W - 4) & vok
    return torch.where(vmask, vres, D)


def median_filter(D: torch.Tensor) -> torch.Tensor:
    """elas.cpp:1494-1560: separable 7-tap median, only where D >= 0,
    with D_temp's calloc-zero border."""
    H, W = D.shape
    ws = 3

    def pass_axis(src, axis):
        x = src if axis == 1 else src.t()
        w = x.shape[1]
        pad = F.pad(x, (ws, ws), value=0.0)
        taps = torch.stack([pad[:, k:k + w] for k in range(2 * ws + 1)], 0)
        med = taps.median(dim=0).values
        return med if axis == 1 else med.t()

    valid = D >= 0
    interior = torch.zeros_like(valid)
    interior[ws:H - ws, ws:W - ws] = True
    med_h = pass_axis(D, 1)
    D_temp = torch.where(interior, torch.where(valid, med_h, D), 0.0)
    med_v = pass_axis(D_temp, 0)
    return torch.where(interior & valid, med_v, D)


def post_tail(D1: torch.Tensor, D2: torch.Tensor,
              params: ElasParams = ElasParams()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gap interpolation + optional filters (the post-speckle tail)."""
    views = [D1] if params.postprocess_only_left else [D1, D2]
    out = []
    for Dv in views:
        Dv = gap_interpolation(Dv, params)
        if params.filter_adaptive_mean:
            Dv = adaptive_mean(Dv)
        if params.filter_median:
            Dv = median_filter(Dv)
        out.append(Dv)
    return (out[0], D2) if params.postprocess_only_left else tuple(out)
