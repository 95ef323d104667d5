"""TP BM's CUDA kernels T1 and T2, their wrappers and their plain versions.

  tp_partials   kernel T1   csrc/bm_tp_kernel.cu   a rank's SAD box and
                                                   partial WTA over its
                                                   disparity range
  tp_combine    kernel T2   csrc/bm_tp_kernel.cu   a data row's combine of
                                                   the ranks' partials, the
                                                   L/R check

parallel/mesh.bm_match_tp runs T1 once a rank, T2 once a data row, then
kernel S (matching/bm.bm_texture_gate) for the texture gate, when its
mesh's devices are cards; on a CPU mesh it runs the reference's eager
program (mesh._bm_tp_shard_plain). tp_partials_plain and tp_combine_plain
are the kernels' plain twins, which the wrappers run for CPU tensors: the
partials as csrc/bm_tp_kernel.cu lists them, int32 [2 views, NF, B, H, W],
and their combine with _tp_wta's arithmetic (matching/bm.wta_disparity) and
matching/sgm._lr_tail.
``launches`` counts the calls that launched a kernel, by kernel name.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..config import BMParams
from ..matching.bm import _BIG, WINDOW_MAX, _box_filter, wta_disparity
from ..matching.sgm import _lr_tail
from . import cuda_lib

launches = {"bm_tp_partials": 0, "bm_tp_combine": 0}

# the partials a pixel and view, in the order of csrc/bm_tp_kernel.cu
FIELDS = ("key", "best", "cm", "cp", "second", "first", "last", "xfirst",
          "xlast")
NF = len(FIELDS)
KEY, BEST, CM, CP, SECOND, FIRST, LAST, XFIRST, XLAST = range(NF)


def invalid_cost(D: int) -> int:
    """The key's invalid-cost clamp: 1 << 24, the engine's in-volume
    sentinel, while the key cost * D + d fits int32 (D <= 64); lower past
    that (it changes only keys of costs that are invalid already)."""
    return min(1 << 24, (1 << 30) // D - 1)


def rank_costs(left: torch.Tensor, right: torch.Tensor, d0: int, Dl: int,
               D: int, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views' int32 cost volumes [Dl, ..., H, W] of uint8 [..., H, W]
    frames over d in [d0, d0 + Dl), 1 << 24 where the pair is invalid, as
    the reference's _bm_tp_shard builds them."""
    W = left.shape[-1]
    L = left.to(torch.int32)
    R_pad = torch.nn.functional.pad(right.to(torch.int32), (D, 0))
    u = torch.arange(W, device=L.device)
    ds = range(d0, d0 + Dl)
    cl = []
    for d in ds:
        c = _box_filter((L - R_pad[..., D - d:D - d + W]).abs(), r)
        cl.append(torch.where(u >= d, c, _BIG))
    # right view from the same slice: cost_R(u, d) = cost_L(u + d, d)
    cr = [torch.cat([c[..., d:], torch.full_like(c[..., :d], _BIG)], -1)
          for d, c in zip(ds, cl)]
    return torch.stack(cl), torch.stack(cr)


def _view_partials(c: torch.Tensor, d0: int, D: int) -> torch.Tensor:
    """The NF partials [NF, ...] of one view's costs c [Dl, ...]."""
    Dl = c.shape[0]
    big = torch.full((), _BIG, dtype=torch.int32, device=c.device)
    j = torch.arange(Dl, dtype=torch.int32, device=c.device).view(
        -1, *([1] * (c.dim() - 1)))
    key, bj = (torch.clamp_max(c, invalid_cost(D)) * D + (j + d0)).min(0)

    def at(i):
        return c.gather(0, i.clamp(0, Dl - 1)[None])[0]

    def rest(x):           # the least cost of x [n, ...], 1 << 24 if n = 0
        return x.amin(0) if x.shape[0] else big.expand(c.shape[1:])

    parts = [key, at(bj),
             torch.where(bj > 0, at(bj - 1), big),
             torch.where(bj < Dl - 1, at(bj + 1), big),
             torch.where((j - bj).abs() > 1, c, big).amin(0),
             c[0], c[-1], rest(c[1:]), rest(c[:-1])]
    return torch.stack([p if i == KEY else torch.clamp_max(p, _BIG)
                        for i, p in enumerate(parts)])


def tp_partials_plain(left: torch.Tensor, right: torch.Tensor, d0: int,
                      Dl: int, D: int, r: int) -> torch.Tensor:
    return torch.stack([_view_partials(c, d0, D)
                        for c in rank_costs(left, right, d0, Dl, D, r)])


def tp_combine_plain(parts: torch.Tensor, D: int, Dl: int, params: BMParams
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    K = parts.shape[0]
    big = torch.full((), _BIG, dtype=torch.int32, device=parts.device)
    views = []
    for view in range(2):
        P = parts[:, view]                                 # [K, NF, ...]
        key, w = P[:, KEY].min(0)
        q = key % D
        lo = w * Dl
        hi = lo + Dl

        def at(f, k):
            return P[:, f].gather(0, k.clamp(0, K - 1)[None])[0]

        cm = torch.where(q - 1 >= lo, at(CM, w),
                         torch.where(w > 0, at(LAST, w - 1), big))
        cp = torch.where(q + 1 < hi, at(CP, w),
                         torch.where(w + 1 < K, at(FIRST, w + 1), big))
        ks = torch.arange(K, device=parts.device).view(
            -1, *([1] * (key.dim())))
        other = torch.where(
            (ks == w - 1) & (q == lo), P[:, XLAST],
            torch.where((ks == w + 1) & (q == hi - 1), P[:, XFIRST],
                        torch.minimum(P[:, FIRST], P[:, XFIRST])))
        second = torch.where(ks == w, P[:, SECOND], other).amin(0)
        views.append(wta_disparity(q, at(BEST, w), second, cm, cp, D,
                                   params))
    return _lr_tail(views[0], views[1], D, params)


def _checked_frames(left: torch.Tensor, right: torch.Tensor):
    if left.dim() != 3 or left.shape != right.shape \
            or left.dtype != torch.uint8 or right.dtype != torch.uint8 \
            or left.device != right.device:
        raise ValueError(f"T1 takes two uint8 [B, H, W] batches of one shape "
                         f"on one device, got {left.dtype} "
                         f"{tuple(left.shape)} on {left.device} and "
                         f"{right.dtype} {tuple(right.shape)} on "
                         f"{right.device}")
    return left.contiguous(), right.contiguous()


def tp_partials(left: torch.Tensor, right: torch.Tensor, d0: int, Dl: int,
                D: int, r: int, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The partials, int32 [2, NF, B, H, W], of a rank that scores d in
    [d0, d0 + Dl) of D, for uint8 [B, H, W] frames and box radius r: kernel
    T1 on the card (written into ``out`` where given), the plain twin on
    the CPU."""
    left, right = _checked_frames(left, right)
    B, H, W = left.shape
    if D < 2 or Dl < 1 or d0 < 0 or d0 + Dl > D \
            or not 0 <= r <= WINDOW_MAX // 2:
        raise ValueError(f"T1 takes 0 <= d0, 1 <= Dl, d0 + Dl <= D, D >= 2 "
                         f"and r <= {WINDOW_MAX // 2}, got d0 {d0}, Dl {Dl},"
                         f" D {D}, r {r}")
    if not left.is_cuda:
        got = tp_partials_plain(left, right, d0, Dl, D, r)
        return got if out is None else out.copy_(got)
    dev = left.device
    if out is None:
        out = torch.empty((2, NF, B, H, W), dtype=torch.int32, device=dev)
    cuda_lib.expect(out, "partials", torch.int32, (2, NF, B, H, W), dev, 4)
    scratch = torch.empty(2 * H * W * Dl, dtype=torch.int32, device=dev)
    fn = cuda_lib.load("bm_tp_kernel").tp_partials
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_lib.launch(fn, "tp_partials", left, left.data_ptr(),
                    right.data_ptr(), out.data_ptr(), scratch.data_ptr(), B,
                    H, W, D, d0, Dl, r)
    launches["bm_tp_partials"] += 1
    return out


def tp_combine(parts: torch.Tensor, D: int, Dl: int, params: BMParams
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ranks' partials int32 [K, 2, NF, B, H, W] -> (D_left after the
    L/R check, D_right), float32 [B, H, W], -1 for invalid: kernel T2 on the
    card, the plain twin on the CPU."""
    if parts.dim() != 6 or parts.shape[1:3] != (2, NF) \
            or parts.dtype != torch.int32 or D < 2 or Dl < 1 \
            or parts.shape[0] * Dl > D:
        raise ValueError(f"T2 takes int32 partials [K, 2, {NF}, B, H, W] with"
                         f" K * Dl <= D, got {parts.dtype} "
                         f"{tuple(parts.shape)}, D {D}, Dl {Dl}")
    if not parts.is_cuda:
        return tp_combine_plain(parts, D, Dl, params)
    K, _, _, B, H, W = parts.shape
    dev = parts.device
    cuda_lib.expect(parts, "partials", torch.int32, parts.shape, dev, 4)
    dl = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    dr = torch.empty_like(dl)
    fn = cuda_lib.load("bm_tp_kernel").tp_combine
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_lib.launch(fn, "tp_combine", parts, parts.data_ptr(), dl.data_ptr(),
                    dr.data_ptr(), K, B, H, W, D, Dl,
                    float(params.uniqueness), float(params.lr_threshold))
    launches["bm_tp_combine"] += 1
    return dl, dr


def rank_partials(left: torch.Tensor, right: torch.Tensor, D: int, r: int,
                  devs: Sequence[torch.device]) -> torch.Tensor:
    """Every rank's partials [K, 2, NF, B, H, W] on the row's first device:
    rank k (device devs[k]) scores [k Dl, (k + 1) Dl), Dl = D // K, through
    tp_partials; a rank on another device than the first sends its
    partials there (the pmins' transfer; on one device nothing moves)."""
    K = len(devs)
    Dl = D // K
    B, H, W = left.shape
    parts = torch.empty((K, 2, NF, B, H, W), dtype=torch.int32,
                        device=devs[0])
    frames = {}
    for k, dev in enumerate(devs):
        if dev not in frames:
            frames[dev] = (left.to(dev), right.to(dev))
        got = tp_partials(*frames[dev], k * Dl, Dl, D, r,
                          out=parts[k] if dev == devs[0] else None)
        if dev != devs[0]:
            parts[k].copy_(got)
    return parts
