"""Semi-global matching (SGM): census cost, 8-path aggregation, WTA.

BASELINE config 3 of the reference package: census 5x5 -> 24-bit codes;
cost = Hamming distance of the left code and the d-shifted right code;
8-path (or 4-path) aggregation (Hirschmueller 2008)

    L(p, d) = C(p, d) + min(L(q, d), L(q, d+-1) + P1, min_d' L(q, d') + P2)
              - min_d' L(q, d')

with the carry clamped to _CARRY_BIG and reset to it at the image edge
(diagonal paths); winner-take-all over the path sum with uniqueness,
parabolic sub-pixel and the L/R check. The right view is S_R(u, d) =
S_L(u+d, d), or, with SGMParams.true_right, its own aggregation of the
right-view cost volume.

Two forms, as in the reference package:

  - the plain engine in the reference's layouts ([D, H, W] volumes, [H, W]
    float32 maps with -1 for invalid, any leading batch axes):
    census5x5, census_cost_volume(_hdw), aggregate_paths, _finalize. The
    kernels' plain twins (ops/sgm_kernel.py) are built from it;
  - sgm_match_batch, the engine of the node: census (CUDA kernel D) ->
    cost volume ([B, H, D, W], kernel O1) -> aggregation (kernel E) ->
    WTA maps (kernel F) and the float epilogue (_wta_from_maps, _lr_tail
    and the u8 map, kernel O2) in one launch of F, or F then O2 for
    true_right and past D = 64 (ops/sgm_kernel.sgm_tail_route); on the
    card no eager op runs between them. sgm_match is it on a batch of
    one.

The integer volumes never wrap: costs are <= 24 or the 12000 sentinel,
carries and sums are clamped to _CARRY_BIG before they are stored as
int16, and the recurrence runs in int32. Every function is bit-equal to
the reference package's wherever the reference's int16 recurrence does
not wrap, which is _CARRY_BIG + max(P1, P2) < 2^15 (every preset); above
that the reference wraps and this engine does not.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SGMParams
from ..device import DeviceLike, resolve_device
from ..ops.shifts import shifted_row_lookup

_INVALID = 12000      # cost-volume "no such pair" sentinel
_CARRY_BIG = 28000    # DP carry clamp / edge reset
_WTA_BIG = 30000      # WTA exclusion sentinel (> any volume value)

Image = Union[np.ndarray, torch.Tensor]


def census5x5(img_u8: torch.Tensor) -> torch.Tensor:
    """24-neighbour census transform of uint8 [..., H, W]: int32 codes,
    bit k set where the k-th neighbour (dv-major, then du, centre skipped)
    is darker than the centre; edge-replicated borders."""
    H, W = img_u8.shape[-2:]
    x = img_u8.to(torch.int32)
    dev = x.device
    rows = torch.clamp(torch.arange(-2, H + 2, device=dev), 0, H - 1)
    cols = torch.clamp(torch.arange(-2, W + 2, device=dev), 0, W - 1)
    p = x[..., rows, :][..., cols]
    code = torch.zeros_like(x)
    bit = 0
    for dv in range(-2, 3):
        for du in range(-2, 3):
            if dv == 0 and du == 0:
                continue
            nb = p[..., 2 + dv:2 + dv + H, 2 + du:2 + du + W]
            code |= (nb < x).to(torch.int32) << bit
            bit += 1
    return code


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int32 values, negative ones too (the first step wraps
    as the reference's does; every later step is masked non-negative).
    The byte counts are summed with shifts: the reference's multiply by
    0x01010101 relies on int32 wrap-around."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x += x >> 4
    x &= 0x0F0F0F0F
    x += x >> 8          # byte 0 collects the four byte counts, <= 32
    x += x >> 16
    return x & 0x3F


def census_cost_volume_hdw(cl: torch.Tensor, cr: torch.Tensor, D: int
                           ) -> torch.Tensor:
    """Hamming cost [..., H, D, W] int16 between the left census codes
    and the right ones shifted by d: popcount(cl[u] ^ cr[u-d]), _INVALID
    where u < d. One vectorised pass over a strided view of the padded
    right codes."""
    W = cl.shape[-1]
    dev = cl.device
    win = F.pad(cr, (D, 0)).unfold(-1, W, 1)      # [..., H, D+1, W]
    # window j holds cr[u + j - D]: j = D - d for d = D-1 .. 0
    cost = _popcount(cl.unsqueeze(-2) ^ win[..., 1:, :]).to(torch.int16)
    cost = cost.flip(-2)
    u = torch.arange(W, device=dev)
    d = torch.arange(D, device=dev)[:, None]
    return torch.where(u >= d, cost,
                       torch.full((), _INVALID, dtype=torch.int16,
                                  device=dev))


def census_cost_volume(cl: torch.Tensor, cr: torch.Tensor, D: int
                       ) -> torch.Tensor:
    """census_cost_volume_hdw in the reference's [..., D, H, W] layout."""
    return census_cost_volume_hdw(cl, cr, D).transpose(-3, -2).contiguous()


def _path_scan(cost_twd: torch.Tensor, p1: int, p2: int, shift: int,
               reverse: bool, acc: torch.Tensor) -> None:
    """DP over axis -3 of int32 [..., T, W, D], walked from the last step
    back when ``reverse``; adds each step's path values into ``acc`` (same
    shape). shift in {-1, 0, +1} moves the carry one column a step
    (diagonal paths), resetting the column it leaves open to _CARRY_BIG."""
    T, W = cost_twd.shape[-3:-1]
    order = range(T - 1, -1, -1) if reverse else range(T)
    prev = None
    for t in order:
        c = cost_twd[..., t, :, :]
        if prev is None:
            prev = torch.clamp_max(c, _CARRY_BIG)
        else:
            if shift:
                prev = torch.roll(prev, shift, dims=-2)
                prev[..., 0 if shift == 1 else W - 1, :] = _CARRY_BIG
            m = prev.amin(-1, keepdim=True)
            # the missing d-1 / d+1 neighbour is a plain _CARRY_BIG sentinel
            pp = F.pad(prev, (1, 1), value=_CARRY_BIG)
            best = torch.minimum(
                torch.minimum(prev, m + p2),
                torch.minimum(pp[..., :-2], pp[..., 2:]) + p1)
            prev = torch.clamp_max(c + (best - m), _CARRY_BIG)
        acc[..., t, :, :] += prev


def _clamp16(x: torch.Tensor) -> torch.Tensor:
    """Pass-group clamp, in place, of an int32 partial sum to the int16
    domain."""
    return x.clamp_max_(_CARRY_BIG)


def aggregate_paths(cost: torch.Tensor, params: SGMParams) -> torch.Tensor:
    """8-path (or 4-path) SGM aggregation: int16 [..., D, H, W] -> int16
    [..., D, H, W], grouped and clamped as the reference engine does: the
    down group (vertical + both down diagonals), the up group added onto
    it, the two horizontal passes, then the total, each group's int32 sum
    clamped to _CARRY_BIG."""
    p1, p2 = params.p1, params.p2
    c_hwd = cost.movedim(-3, -1).to(torch.int32).contiguous()   # [.., H, W, D]
    shifts = (0, 1, -1) if params.num_paths >= 8 else (0,)
    Sv = torch.zeros_like(c_hwd)
    for reverse in (False, True):          # the down group, then the up
        for s in shifts:
            _path_scan(c_hwd, p1, p2, s, reverse, Sv)
        _clamp16(Sv)
    c_whd = c_hwd.transpose(-3, -2).contiguous()
    Sh = torch.zeros_like(c_whd)
    for reverse in (False, True):          # left to right, right to left
        _path_scan(c_whd, p1, p2, 0, reverse, Sh)
        _clamp16(Sh)
    Sv += Sh.transpose(-3, -2)
    return _clamp16(Sv).movedim(-1, -3).to(torch.int16).contiguous()


def shift_by_d(vol: torch.Tensor, d_dim: int) -> torch.Tensor:
    """out[..., d, ..., u] = vol[..., d, ..., u+d], _INVALID where u+d >=
    W; d is axis d_dim, u the last axis. A strided view of the padded
    volume, made contiguous."""
    D = vol.shape[d_dim]
    vp = F.pad(vol, (0, D), value=_INVALID).contiguous()
    stride = list(vp.stride())
    stride[d_dim] += 1
    return vp.as_strided(vol.shape, stride).contiguous()


def right_view_volume(vol: torch.Tensor) -> torch.Tensor:
    """[..., D, H, W] left-anchored volume -> right-anchored: out[d, v, u]
    = vol[d, v, u+d], _INVALID where u+d >= W. Exact for the raw cost
    volume (cost_R(u, d) compares the same pixel pair as cost_L(u+d, d))."""
    return shift_by_d(vol, -3)


def wta_maps(vol: torch.Tensor):
    """The five per-pixel WTA statistics of a [..., D, H, W] volume, int32
    [..., H, W]: best cost, its first d, the best outside d +- 1, and the
    costs at d-1 and d+1 (_WTA_BIG where there is none)."""
    D = vol.shape[-3]
    # int16 holds every value here (volumes <= _WTA_BIG, d <= 256)
    vol = vol.to(torch.int16)
    ds = torch.arange(D, dtype=torch.int16, device=vol.device)[:, None, None]
    big = torch.full((), _WTA_BIG, dtype=torch.int16, device=vol.device)
    best = vol.amin(-3)
    bd = torch.where(vol == best.unsqueeze(-3), ds, D).amin(-3)
    b = bd.unsqueeze(-3)
    second = torch.where((ds >= b - 1) & (ds <= b + 1), big, vol).amin(-3)
    cm = torch.where(ds == b - 1, vol, big).amin(-3)
    cp = torch.where(ds == b + 1, vol, big).amin(-3)
    return tuple(x.to(torch.int32) for x in (best, bd, second, cm, cp))


def _wta_from_maps(best, best_d, second, cm, cp, D: int,
                   params: SGMParams) -> torch.Tensor:
    """Uniqueness and parabolic sub-pixel from the five WTA maps: float32
    disparity, -1 where not unique. The uniqueness factor is rounded to
    float32 first, as the reference's weakly typed scalar is."""
    f32 = torch.float32
    ratio = torch.full((), params.uniqueness, dtype=f32, device=best.device)
    unique = best.to(f32) < ratio * second.to(f32)
    den = cm + cp - 2 * best
    offs = torch.where(
        (best_d > 0) & (best_d < D - 1) & (den > 0),
        (cm - cp).to(f32) / (2.0 * den.to(f32)),
        torch.zeros((), dtype=f32, device=best.device))
    return torch.where(unique, best_d.to(f32) + offs,
                       torch.full((), -1.0, dtype=f32, device=best.device))


def _lr_tail(dL: torch.Tensor, dR: torch.Tensor, D: int,
             params: SGMParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """L/R consistency on [..., H, W]: invalidate left pixels whose right
    correspondent disagrees by more than lr_threshold."""
    W = dL.shape[-1]
    u = torch.arange(W, device=dL.device)
    uw = torch.clamp((u - dL).to(torch.int32), 0, W - 1)   # trunc to zero
    s = torch.clamp(u - uw, 0, D)
    other = shifted_row_lookup(dR, s, D, -1)
    ok = (dL >= 0) & (other >= 0) & ((other - dL).abs()
                                     <= params.lr_threshold)
    return torch.where(ok, dL, torch.full((), -1.0, device=dL.device)), dR


def _finalize(S: torch.Tensor, params: SGMParams, S_right=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WTA, uniqueness, sub-pixel and L/R check on the aggregated volume S
    [..., D, H, W]. S_right, when given, is a separately aggregated
    right-view volume (true_right); otherwise S_R(u, d) = S(u+d, d)."""
    D = S.shape[-3]
    dL = _wta_from_maps(*wta_maps(S), D, params)
    SR = right_view_volume(S) if S_right is None else S_right
    dR = _wta_from_maps(*wta_maps(SR), D, params)
    return _lr_tail(dL, dR, D, params)


def sgm_match_batch(left_b: Image, right_b: Image,
                    params: SGMParams = SGMParams(),
                    device: DeviceLike = None, u8: bool = False):
    """Batched SGM: uint8 [B, H, W] pairs -> (D_left, D_right) float32
    [B, H, W], -1 for invalid, on ``device`` (the card unless "cpu"); with
    ``u8`` also D_left's u8 map. On the card it runs kernels D, O1, E and
    F with O2 folded in (F then O2 for true_right and past D = 64); on the
    CPU their plain versions. Equal, frame by frame, to the reference's
    sgm_match."""
    from ..ops.sgm_kernel import (aggregate_paths_bhdw, census5x5_pair,
                                  sgm_cost_volume, sgm_wta_epilogue)

    dev = resolve_device(device)
    left = torch.as_tensor(left_b).to(dev)
    right = torch.as_tensor(right_b).to(dev)
    if left.dim() != 3 or left.shape != right.shape \
            or left.dtype != torch.uint8 or right.dtype != torch.uint8:
        raise ValueError(f"need two uint8 [B, H, W] batches of one shape, "
                         f"got {left.dtype} {tuple(left.shape)} and "
                         f"{right.dtype} {tuple(right.shape)}")
    B = left.shape[0]
    D = params.disp_num
    codes = census5x5_pair(left, right)
    # true_right: the right view's own aggregation of its cost volume (from
    # the same launch); its direct WTA maps are rows 0-4 of the maps kernel
    if params.true_right:
        cost, cost_r = sgm_cost_volume(codes[:B], codes[B:], D, True)
        S_right = aggregate_paths_bhdw(cost_r, params)
        del cost_r
    else:
        cost = sgm_cost_volume(codes[:B], codes[B:], D)
        S_right = None
    return sgm_wta_epilogue(aggregate_paths_bhdw(cost, params), params, u8,
                            S_right)


def sgm_match(left_u8: Image, right_u8: Image,
              params: SGMParams = SGMParams(), device: DeviceLike = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SGM of one uint8 [H, W] pair: (D_left, D_right) float32 [H, W]."""
    dL, dR = sgm_match_batch(torch.as_tensor(left_u8)[None],
                             torch.as_tensor(right_u8)[None], params, device)
    return dL[0], dR[0]
