"""ELAS postprocessing in PyTorch on [..., H, W] float32 maps.

Reference: leftRightConsistencyCheck (elas.cpp:909-979), removeSmallSegments
(981-1099, BFS speckle), gapInterpolation (1101-1284), adaptiveMean
(1287-1492, SSE approximate bilateral), median (1494-1560). The speckle
filter's plain versions (remove_small_segments_plain, _batch_plain) find
4-connected components under |d_i - d_j| <= sim_threshold by min-label
run scans to a fixed point, then kill small components by size, bit-equal
to the BFS of the per-frame CPU path
(native_prior.remove_small_segments_native) wherever every invalid pixel
is -10 and sim_threshold < 10 (pipeline._speckle says why).

The speckle filter, the L/R check, the gap interpolation, the adaptive
mean and the median are each a wrapper: on CUDA tensors it launches its
hand-written kernel (csrc/speckle_kernel.cu: L; csrc/elas_post_kernel.cu:
H, I, J, K), on CPU tensors it runs its plain version (the *_plain
function), which the kernel equals bit for bit. ``launches`` counts the
wrapper calls that launched a kernel, by kernel; ``device_launches`` the
kernel launches those calls made (L: 1, a cooperative launch; I: 1 a call
up to GAP_TILE_MAX without corners, else 2; J: 1; H: 1; K: 1). Where the
card's dense kernel owns whole rows (dense.lr_fused: every preset), the
L/R check runs as its epilogue (dense.dense_match_pair_lr) and H does not
launch.

The tail (post_tail: I, then J and K where the filters are on) takes two
optional sinks for its last step: ``out``, the tensors its final maps go
to (the batched path's output rows), and ``u8``, a uint8 map that gets
ops.convert.dmap_u8 of the final D1 (the node's published map). On the
card the last kernel stores both itself (its epilogue), so neither costs
a launch; on the CPU the plain result is copied into them. Both views of
a pair that lie one after the other in one storage (kernel B's paired
output, and every pair a wrapper returns) are taken as one [2, ...]
tensor, without a stack.

Exactness: every float operation of a plain version is a single eager
PyTorch op, so no multiply is fused into an add, and f32 division is
correctly rounded on both the CPU and the card. The adaptive mean's sums
keep the reference's SSE lane order.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...config import ElasParams
from ...ops import cuda_lib
from ...ops.convert import dmap_u8
from ...ops.shifts import shifted_row_lookup

launches = {"elas_lr": 0, "elas_gap": 0, "elas_mean": 0, "elas_median": 0,
            "elas_speckle": 0, "elas_u8": 0}
device_launches = dict(launches)
# kernel I's one-launch tile design takes gap widths up to this without
# corners (csrc/elas_post_kernel.cu kGapTileMax); its scan design the rest
GAP_TILE_MAX = 8


def _frames(D: torch.Tensor, name: str) -> torch.Tensor:
    """A CUDA map as a contiguous float32 [B, H, W] batch (B the product
    of the leading dimensions); raises on what the kernels do not take."""
    if D.dtype != torch.float32 or D.dim() < 2 or D.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty float32 [..., H, W] "
                         f"map, got {D.dtype} {tuple(D.shape)}")
    return D.contiguous().reshape(-1, *D.shape[-2:])


def _run(name: str, kernel: str, X: torch.Tensor, ptrs, ints, tail=(),
         lib: str = "elas_post_kernel"):
    """Launch the C entry point ``name`` of csrc/<lib>.cu with the pointers
    ``ptrs`` (None for a null one), the ints ``ints`` and the (ctype,
    value) pairs of ``tail`` on X's card; count the call and the kernel
    launches it reports."""
    fn = getattr(cuda_lib.load(lib), name)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) \
        + [t for t, _ in tail] + [ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    cuda_lib.launch(fn, kernel, X, *ptrs, *ints, *(v for _, v in tail),
                    ctypes.byref(n))
    launches[kernel] += 1
    device_launches[kernel] += n.value


def _lr_cuda(D1: torch.Tensor, D2: torch.Tensor, smax: int,
             params: ElasParams):
    X1, X2 = _frames(D1, "D1"), _frames(D2, "D2")
    if X1.shape != X2.shape or X1.device != X2.device:
        raise ValueError(f"L/R check: D1 {tuple(D1.shape)} on {D1.device} "
                         f"and D2 {tuple(D2.shape)} on {D2.device}")
    B, H, W = X1.shape
    O1, O2 = torch.empty((2, B, H, W), dtype=X1.dtype, device=X1.device)
    _run("elas_lr_check", "elas_lr", X1,
         (X1.data_ptr(), X2.data_ptr(), O1.data_ptr(), O2.data_ptr()),
         (B, H, W, smax), ((ctypes.c_float, float(params.lr_threshold)),
                           (ctypes.c_int, int(params.subsampling))))
    return O1.reshape(D1.shape), O2.reshape(D2.shape)


def _pair(D1: torch.Tensor, D2: torch.Tensor) -> torch.Tensor:
    """Both views as one [2, ...] tensor: a view of their storage where D2
    directly follows D1 in it, else torch.stack."""
    n = D1.numel()
    if D1.shape == D2.shape and D1.dtype == D2.dtype \
            and D1.device == D2.device and D1.is_contiguous() \
            and D2.is_contiguous() and n > 0 \
            and D1.untyped_storage().data_ptr() \
            == D2.untyped_storage().data_ptr() \
            and D2.data_ptr() == D1.data_ptr() + n * D1.element_size():
        return D1.as_strided((2, *D1.shape), (n, *D1.stride()))
    return torch.stack([D1, D2])


def _sink_frames(X: torch.Tensor, out, u8):
    """(O, O2, n0) of a map kernel's store of X [B, H, W] (_map_cuda): out
    (one tensor a view, their frames X's in order) checked, else None;
    n0, the first view's frames, those of out[0], else of u8, else B."""
    B, H, W = X.shape
    if u8 is not None:
        if u8.dtype != torch.uint8 or u8.device != X.device \
                or not u8.is_contiguous() or u8.numel() % (H * W) \
                or not 0 < u8.numel() <= X.numel():
            raise ValueError(f"u8: expected a contiguous uint8 map of "
                             f"{H}x{W} frames on {X.device}, got {u8.dtype}"
                             f" {tuple(u8.shape)} on {u8.device}")
    if out is None:
        return None, None, B if u8 is None else u8.numel() // (H * W)
    if not 1 <= len(out) <= 2 \
            or sum(o.numel() for o in out) != X.numel() \
            or any(o.dtype != torch.float32 or o.device != X.device
                   or not o.is_contiguous() for o in out) \
            or out[0].numel() % (H * W):
        raise ValueError(f"out: expected one or two contiguous float32 "
                         f"tensors on {X.device} holding {B} frames of "
                         f"{H}x{W}, got "
                         f"{[(o.dtype, tuple(o.shape)) for o in out]}")
    n0 = out[0].numel() // (H * W)
    if u8 is not None and u8.numel() != out[0].numel():
        raise ValueError(f"u8 {tuple(u8.shape)} is not out[0]'s "
                         f"{tuple(out[0].shape)}")
    return out[0], out[1] if len(out) > 1 else None, n0


def _map_cuda(entry: str, kernel: str, D: torch.Tensor, ints,
              scratch: Optional[bool] = None, out=None, u8=None):
    """A kernel of one map, D -> O. ``scratch`` for an entry point that
    takes a scratch map T (a row pass, then a column pass through T): True
    to allocate it, False to pass null (I's one-launch design); None for
    one that takes none. ``out`` and ``u8`` are the sinks (_sink_frames):
    the kernel writes its frames into out and the u8 map of the first
    view's frames into u8 (its epilogue)."""
    X = _frames(D, kernel)
    O, O2, n0 = _sink_frames(X, out, u8)
    O = torch.empty_like(X) if O is None else O
    T = torch.empty_like(X) if scratch else None
    ptrs = (X.data_ptr(),) + (() if scratch is None else (
        None if T is None else T.data_ptr(),)) + (
        O.data_ptr(), None if O2 is None else O2.data_ptr(),
        None if u8 is None else u8.data_ptr())
    _run(entry, kernel, X, ptrs, (n0,) + tuple(X.shape) + tuple(ints))
    return tuple(out) if out is not None else O.reshape(D.shape)


def _store(res: torch.Tensor, out, u8):
    """A plain version's result of a map wrapper given sinks: res copied
    into ``out`` (one tensor a view, res's frames in order) and dmap_u8 of
    its first view's frames into ``u8``; returns what the kernel's wrapper
    returns (out as a tuple, else res)."""
    X = res.reshape(-1, *res.shape[-2:])
    _sink_frames(X, out, u8)
    if u8 is not None:
        u8.copy_(dmap_u8(X[:u8.numel() // X[0].numel()]).reshape(u8.shape))
    if out is None:
        return res
    at = 0
    for o in out:
        n = o.numel() // X[0].numel()
        o.copy_(X[at:at + n].reshape(o.shape))
        at += n
    return tuple(out)


def u8_map(D: torch.Tensor, u8: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """ops.convert.dmap_u8 of a float32 map (into ``u8`` where given): on a
    CUDA tensor one launch of elas_u8 (for a map that reaches no tail
    kernel: the per-frame bail-out), on a CPU one dmap_u8."""
    if u8 is None:
        u8 = torch.empty(D.shape, dtype=torch.uint8, device=D.device)
    if not D.is_cuda:
        return u8.copy_(dmap_u8(D))
    X = _frames(D, "elas_u8")
    _sink_frames(X, None, u8)
    if u8.numel() != X.numel():
        raise ValueError(f"u8 {tuple(u8.shape)} is not D's "
                         f"{tuple(D.shape)}")
    fn = cuda_lib.load("elas_post_kernel").elas_u8
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    cuda_lib.launch(fn, "elas_u8", X, X.data_ptr(), u8.data_ptr(),
                    X.numel(), ctypes.byref(n))
    launches["elas_u8"] += 1
    device_launches["elas_u8"] += n.value
    return u8


def left_right_consistency_check(
    D1: torch.Tensor, D2: torch.Tensor, params: ElasParams = ElasParams(),
    smax: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """left_right_consistency_check_plain's contract: kernel H (both views
    in one launch) on CUDA tensors, the plain version on CPU tensors."""
    if D1.is_cuda:
        smax = params.disp_max if smax < 0 else min(smax, params.disp_max)
        return _lr_cuda(D1, D2, smax, params)
    return left_right_consistency_check_plain(D1, D2, params, smax)


def left_right_consistency_check_plain(
    D1: torch.Tensor, D2: torch.Tensor, params: ElasParams = ElasParams(),
    smax: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """elas.cpp:909-979 on [..., H, W] maps. Invalid -> -10.

    A pixel keeps its disparity when the other view, read at the warped
    column (int)(u -/+ d), agrees within lr_threshold; under subsampling
    the maps are half-resolution and the warp is (int)(u -/+ d/2)
    (elas.cpp:937-939), truncated as the C cast truncates. The shift is
    clamped to [0, smax]; smax < 0 means disp_max. The batched path
    passes a bound no dense output exceeds (pipeline._lr_ladder), as the
    reference package does."""
    W = D1.shape[-1]
    u = torch.arange(W, device=D1.device)
    smax = params.disp_max if smax < 0 else min(smax, params.disp_max)

    def check(Da, Db, sign):
        uw = u.to(torch.float32) + sign * (Da / 2 if params.subsampling
                                           else Da)
        ok = (Da >= 0) & (uw >= 0) & (uw < W)
        s = torch.clamp(sign * (uw.to(torch.int32) - u), 0, smax)
        other = shifted_row_lookup(Db, s, smax, sign, fill=-1e9)
        ok = ok & ((other - Da).abs() <= params.lr_threshold)
        return torch.where(ok, Da, -10.0)

    return check(D1, D2, -1), check(D2, D1, +1)


def _t(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> contiguous [..., W, H]."""
    return x.transpose(-1, -2).contiguous()


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
    W = D.shape[-1]
    if gap_width <= 8:
        K = gap_width + 1
        big = -1e9
        Dp = F.pad(D, (K, K), value=big)
        d1 = torch.full_like(D, big)
        kl = torch.full(D.shape, K + 1, dtype=torch.int32, device=D.device)
        d2 = torch.full_like(D, big)
        kr = kl.clone()
        for k in range(K, 0, -1):  # nearest (smallest k) wins by overwrite
            lv = Dp[..., K - k:K - k + W]
            d1 = torch.where(lv >= 0, lv, d1)
            kl = torch.where(lv >= 0, k, kl)
            rv = Dp[..., K + k:K + k + W]
            d2 = torch.where(rv >= 0, rv, d2)
            kr = torch.where(rv >= 0, k, kr)
        gap_len = kl + kr - 1
        has_both = (d1 >= 0) & (d2 >= 0)
        fill = (~valid) & has_both & (gap_len <= gap_width)
        return torch.where(fill, _interp(d1, d2), D)

    idx = torch.arange(W, device=D.device).expand(D.shape)
    left = torch.cummax(torch.where(valid, idx, -1), dim=-1).values
    right = -torch.cummax(
        torch.where(valid, -idx, -W).flip(-1), dim=-1).values.flip(-1)
    has_both = (left >= 0) & (right < W)
    gap_len = right - left - 1
    d1 = torch.gather(D, -1, torch.clamp(left, 0, W - 1))
    d2 = torch.gather(D, -1, torch.clamp(right, 0, W - 1))
    fill = (~valid) & has_both & (gap_len >= 1) & (gap_len <= gap_width)
    return torch.where(fill, _interp(d1, d2), D)


def _extrapolate_rows(D: torch.Tensor, gap_width: int) -> torch.Tensor:
    """Border extrapolation for add_corners mode (elas.cpp:1169-1198)."""
    valid = D >= 0
    W = D.shape[-1]
    idx = torch.arange(W, device=D.device)
    anyv = valid.any(-1, keepdim=True)
    vi = valid.to(torch.uint8)
    first = torch.where(anyv, torch.argmax(vi, dim=-1, keepdim=True), W)
    last = torch.where(
        anyv, W - 1 - torch.argmax(vi.flip(-1), dim=-1, keepdim=True), -1)
    dfirst = torch.gather(D, -1, torch.clamp(first, 0, W - 1))
    dlast = torch.gather(D, -1, torch.clamp(last, 0, W - 1))
    out = torch.where((idx < first) & (idx >= first - gap_width), dfirst, D)
    return torch.where((idx > last) & (idx <= last + gap_width), dlast, out)


def gap_interpolation(D: torch.Tensor, params: ElasParams = ElasParams(),
                      out=None, u8=None):
    """gap_interpolation_plain's contract: kernel I on CUDA tensors (one
    launch up to GAP_TILE_MAX without corners, else a row launch and a
    column launch through a scratch map), the plain version on CPU
    tensors. out, u8: sinks (_map_cuda)."""
    if D.is_cuda:
        g = gap_width_eff(params)
        corners = int(params.add_corners)
        return _map_cuda("elas_gap_interp", "elas_gap", D, (g, corners),
                         g > GAP_TILE_MAX or bool(corners), out, u8)
    return _store(gap_interpolation_plain(D, params), out, u8)


def gap_interpolation_plain(D: torch.Tensor,
                            params: ElasParams = ElasParams()) -> torch.Tensor:
    """elas.cpp:1101-1284: row pass then column pass (on the row result)."""
    g = gap_width_eff(params)
    out = _gap_fill_rows(D, g)
    if params.add_corners:
        out = _extrapolate_rows(out, g)
    out = _gap_fill_rows(_t(out), g).transpose(-1, -2)
    if params.add_corners:
        out = _extrapolate_rows(_t(out), g).transpose(-1, -2)
    return out.contiguous()


def _ref_absmask(x: torch.Tensor) -> torch.Tensor:
    """The reference's broken 'absolute value' (elas.cpp:1320):
    `_mm_set1_ps(0x7FFFFFFF)` builds the float 2^31 (bits 0x4F000000), so
    `_mm_and_ps(x, mask)` keeps only exponent bits {30,27,26,25,24} of x —
    NOT |x|. Emulated bit for bit."""
    return (x.contiguous().view(torch.int32) & 0x4F000000).view(torch.float32)


def _lane_mean(x: torch.Tensor, pw, pf, shift: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The filter's weighted mean from its four SSE lanes' weights pw and
    weighted values pf: the lanes are added sequentially, starting from
    lane (shift - c) % 4 at column c, for bit-identical f32 rounding.
    Returns (result, store_ok) with store_ok = weight_sum > 0 and
    result >= 0 (elas.cpp:1434-1437); elsewhere the result is x."""
    m = torch.arange(x.shape[-1], device=x.device) % 4
    wsum = torch.zeros_like(x)
    fsum = torch.zeros_like(x)
    for mm in range(4):
        o = [(k - mm + shift) % 4 for k in range(4)]
        wv = ((pw[o[0]] + pw[o[1]]) + pw[o[2]]) + pw[o[3]]
        fv = ((pf[o[0]] + pf[o[1]]) + pf[o[2]]) + pf[o[3]]
        wsum = torch.where(m == mm, wv, wsum)
        fsum = torch.where(m == mm, fv, fsum)
    d = fsum / torch.where(wsum > 0, wsum, 1.0)
    ok = (wsum > 0) & (d >= 0)
    return torch.where(ok, d, x), ok


def _adaptive_pass(src: torch.Tensor, axis: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One 8-tap pass of the reference's approximate bilateral filter.

    Window offsets -4..+3 around the center; weight
    max(0, 4 - ref_absmask(v - center)). Returns _lane_mean's (result,
    store_ok)."""
    x = src if axis == 1 else _t(src)
    W = x.shape[-1]
    pad = F.pad(x, (4, 4), value=0.0)

    def tap(off):
        v = pad[..., 4 + off:4 + off + W]
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
    res, ok = _lane_mean(x, pw, pf, 0)
    return (res, ok) if axis == 1 else (_t(res), _t(ok))


def _adaptive_pass4(src: torch.Tensor, axis: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 4-tap pass of the subsampling branch (elas.cpp:1323-1391):
    window offsets -2..+1 around the center, the same broken abs-mask
    weights, one SSE lane group (tap t in lane t)."""
    x = src if axis == 1 else _t(src)
    W = x.shape[-1]
    pad = F.pad(x, (2, 2), value=0.0)
    pw, pf = [], []
    for t in range(4):                 # offset t-2
        v = pad[..., t:t + W]
        w = torch.clamp(4.0 - _ref_absmask(v - x), min=0.0)
        pw.append(w)
        pf.append(w * v)
    res, ok = _lane_mean(x, pw, pf, 2)
    return (res, ok) if axis == 1 else (_t(res), _t(ok))


def adaptive_mean_sub(D: torch.Tensor, out=None, u8=None):
    """adaptive_mean_sub_plain's contract: kernel J's 4-tap variant on
    CUDA tensors, the plain version on CPU tensors. out, u8: sinks
    (_map_cuda)."""
    if D.is_cuda:
        return _map_cuda("elas_adaptive_mean", "elas_mean", D, (4,),
                         out=out, u8=u8)
    return _store(adaptive_mean_sub_plain(D), out, u8)


def adaptive_mean_sub_plain(D: torch.Tensor) -> torch.Tensor:
    """adaptiveMean, subsampling branch (4-px window; elas.cpp:1323-1391).

    Horizontal writes rows [3, H-4] x cols [2, W-2] into D_tmp; vertical
    writes rows [2, H-2] x cols [3, W-4] into D."""
    H, W = D.shape[-2:]
    r = torch.arange(H, device=D.device)[:, None]
    c = torch.arange(W, device=D.device)[None, :]
    invalid = D < 0
    D_copy = torch.where(invalid, -10.0, D)

    hres, hok = _adaptive_pass4(D_copy, axis=1)
    hmask = (r >= 3) & (r <= H - 4) & (c >= 2) & (c <= W - 2) & hok
    D_tmp = torch.where(invalid, -10.0, 0.0)
    D_tmp = torch.where(hmask, hres, D_tmp)

    vres, vok = _adaptive_pass4(D_tmp, axis=0)
    vmask = (r >= 2) & (r <= H - 2) & (c >= 3) & (c <= W - 4) & vok
    return torch.where(vmask, vres, D)


def adaptive_mean(D: torch.Tensor, out=None, u8=None):
    """adaptive_mean_plain's contract: kernel J (8 taps) on CUDA tensors,
    the plain version on CPU tensors. out, u8: sinks (_map_cuda)."""
    if D.is_cuda:
        return _map_cuda("elas_adaptive_mean", "elas_mean", D, (8,),
                         out=out, u8=u8)
    return _store(adaptive_mean_plain(D), out, u8)


def adaptive_mean_plain(D: torch.Tensor) -> torch.Tensor:
    """elas.cpp:1287-1492 (full-resolution 8-px variant), reproducing the
    reference's buffer semantics:

      D_copy = D with invalid -> -10 (valid values unchanged)
      D_tmp  = zero pages, invalid -> -10; horizontal pass writes only
               rows [3, H-4] x cols [4, W-4]
      final  = D overwritten only at rows [4, H-4] x cols [3, W-4] where the
               vertical pass stored
    """
    H, W = D.shape[-2:]
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


def median_filter(D: torch.Tensor, out=None, u8=None):
    """median_filter_plain's contract: kernel K (one launch) on CUDA
    tensors, the plain version on CPU tensors. out, u8: sinks
    (_map_cuda)."""
    if D.is_cuda:
        return _map_cuda("elas_median", "elas_median", D, (), out=out,
                         u8=u8)
    return _store(median_filter_plain(D), out, u8)


def median_filter_plain(D: torch.Tensor) -> torch.Tensor:
    """elas.cpp:1494-1560: separable 7-tap median, only where D >= 0,
    with D_temp's calloc-zero border."""
    H, W = D.shape[-2:]
    ws = 3

    def pass_axis(src, axis):
        x = src if axis == 1 else _t(src)
        w = x.shape[-1]
        pad = F.pad(x, (ws, ws), value=0.0)
        taps = torch.stack([pad[..., k:k + w] for k in range(2 * ws + 1)], 0)
        med = taps.median(dim=0).values
        return med if axis == 1 else _t(med)

    valid = D >= 0
    interior = torch.zeros((H, W), dtype=torch.bool, device=D.device)
    interior[ws:H - ws, ws:W - ws] = True
    med_h = pass_axis(D, 1)
    D_temp = torch.where(interior, torch.where(valid, med_h, D), 0.0)
    med_v = pass_axis(D_temp, 0)
    return torch.where(interior & valid, med_v, D)


def post_tail(D1: torch.Tensor, D2: torch.Tensor,
              params: ElasParams = ElasParams(), out=None, u8=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gap interpolation + optional filters (the post-speckle tail); the
    adaptive mean is the subsampling branch's under subsampling. Both
    views go through each step together, so on the card each of kernels
    I, J, K launches once a call. out: None, or the tensors the final maps
    go to, (O1,) under postprocess_only_left (D2 is returned as it is),
    else (O1, O2); u8: None, or a uint8 map of D1's shape that gets
    dmap_u8 of the final D1. The last step writes both (on the card its
    kernel's epilogue: no launch of its own)."""
    left = params.postprocess_only_left
    X = D1 if left else _pair(D1, D2)
    steps = [lambda Y, **kw: gap_interpolation(Y, params, **kw)]
    if params.filter_adaptive_mean:
        steps.append(adaptive_mean_sub if params.subsampling
                     else adaptive_mean)
    if params.filter_median:
        steps.append(median_filter)
    for step in steps[:-1]:
        X = step(X)
    Y = steps[-1](X, out=out, u8=u8)
    if left:
        return (Y if out is None else Y[0]), D2
    return Y[0], Y[1]


# ---------------------------------------------------------------------------
# the speckle filter: kernel L's wrappers and their plain versions
# ---------------------------------------------------------------------------

_RUN_CAP = 128   # run slots per row of the compact size count


def _label_bits(n: int) -> int:
    """Bits needed to hold labels 0..n-1."""
    return max(int(n - 1).bit_length(), 1)


def _cummin(x: torch.Tensor, dim: int, reverse: bool = False):
    if reverse:
        return torch.cummin(x.flip(dim), dim=dim).values.flip(dim)
    return torch.cummin(x, dim=dim).values


def _rev_conn(conn: torch.Tensor, dim: int) -> torch.Tensor:
    """Run boundaries of the reverse scan: element j starts a reversed run
    when it is not connected to element j+1."""
    nxt = torch.roll(conn, -1, dim)
    nxt.select(dim, -1).fill_(False)
    return ~nxt


def _seg_terms(conn: torch.Tensor, dim: int, k: int):
    """The run scans' packed segment terms. conn[..., j] says element j is
    connected to element j-1 along ``dim`` (conn[..., 0] is False). Each
    scan direction numbers its runs from its starting end; the term
    (runs - run id) << k makes keys of earlier runs larger than any key of
    the current run, so a plain cummin keeps the current run's minimum
    label in the low k bits."""
    S = conn.shape[dim] + 1
    segf = torch.cumsum(~conn, dim=dim, dtype=torch.int32)
    segr = torch.cumsum(_rev_conn(conn, dim).flip(dim), dim=dim,
                        dtype=torch.int32).flip(dim)
    return (S - segf) << k, (S - segr) << k


def _run_min_scan_packed(lbl, terms, dim: int, k: int):
    """Minimum label over each maximal connected run along ``dim``: two
    packed cummin scans."""
    tf, tr = terms
    mask = (1 << k) - 1
    fwd = _cummin(tf | lbl, dim) & mask
    rev = _cummin(tr | lbl, dim, reverse=True) & mask
    return torch.minimum(fwd, rev)


def _run_min_scan_tuple(lbl, conn, dim: int):
    """The same run minimum for frames too large for int32 keys: the
    segment term rides in the high half of an int64 key."""
    terms = tuple(t.to(torch.int64) << 32 for t in _seg_terms(conn, dim, 0))
    return _run_min_scan_packed(lbl.to(torch.int64), terms, dim, 32) \
        .to(torch.int32)


def _connected_component_labels(D: torch.Tensor,
                                sim_threshold: float) -> torch.Tensor:
    """Per [..., H, W] frame, the minimum flat index over each 4-connected
    component of valid pixels with |d_i - d_j| <= sim_threshold; invalid
    pixels keep their own index. Alternating row and column run-min scans
    repeat until nothing changes (two sweeps per check: a sweep past the
    fixed point changes nothing). The fixed point is the reference BFS's
    segmentation."""
    H, W = D.shape[-2:]
    lbl = torch.arange(H * W, dtype=torch.int32, device=D.device) \
        .reshape(H, W).expand(D.shape).contiguous()
    valid = D >= 0
    k = _label_bits(H * W)
    packed_ok = ((max(H, W) + 2) << k) < 2 ** 31

    def conn_along(dim):
        c = ((D - torch.roll(D, 1, dim)).abs() <= sim_threshold) \
            & valid & torch.roll(valid, 1, dim)
        c.select(dim, 0).fill_(False)
        return c

    conn_row, conn_col = conn_along(-1), conn_along(-2)
    if packed_ok:
        terms_row = _seg_terms(conn_row, -1, k)
        terms_col = _seg_terms(conn_col, -2, k)

        def sweep(x):
            x = _run_min_scan_packed(x, terms_row, -1, k)
            return _run_min_scan_packed(x, terms_col, -2, k)
    else:
        def sweep(x):
            x = _run_min_scan_tuple(x, conn_row, -1)
            return _run_min_scan_tuple(x, conn_col, -2)

    while True:
        new = sweep(sweep(lbl))
        changed = bool((new != lbl).any())
        lbl = new
        if not changed:
            return lbl


def _segment_sizes(lbl: torch.Tensor, valid: torch.Tensor,
                   clamp: Optional[int] = None) -> torch.Tensor:
    """Per-pixel component size of one [H, W] frame: sort the labels so
    each component is one run, total each run with monotone scans, and put
    the totals back in pixel order. Invalid pixels share a sentinel run
    (the caller masks them). With ``clamp``, sizes are min(size, clamp)
    where the reference package's packed unsort applies it (position and
    clamped-size bits fit 31 bits)."""
    n = lbl.numel()
    dev = lbl.device
    flat = torch.where(valid.reshape(-1), lbl.reshape(-1), n)
    sk, sp = torch.sort(flat, stable=True)
    sv = (sk < n).to(torch.int32)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_seg = torch.cat([one, sk[1:] != sk[:-1]])
    end_seg = torch.cat([new_seg[1:], one])
    cs = torch.cumsum(sv, 0, dtype=torch.int32)
    cs_before = torch.cummax(torch.where(new_seg, cs - sv, -1), 0).values
    cs_end = _cummin(torch.where(end_seg, cs, n + 1), 0, reverse=True)
    tot = cs_end - cs_before
    if clamp is not None and _label_bits(n) + int(clamp).bit_length() <= 31:
        tot = torch.clamp(tot, max=clamp)
    out = torch.empty_like(tot)
    out[sp] = tot
    return out.reshape(lbl.shape)


def speckle_plan(device: torch.device, B: int, H: int, W: int
                 ) -> Tuple[int, int]:
    """(grid, spilled labels) of kernel L's launch for B frames of H x W
    on this card: the persistent blocks (every one resident) and the tile
    labels that do not stay in a block's shared memory, those of its
    tiles past the first 4 (csrc/speckle_kernel.cu elas_speckle_plan)."""
    fn = cuda_lib.load("speckle_kernel").elas_speckle_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    grid, spill = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(B, H, W, ctypes.byref(grid), ctypes.byref(spill))
    cuda_lib.check(err, "elas_speckle")
    return grid.value, spill.value


def _speckle_cuda(D: torch.Tensor, params: ElasParams, labels: bool,
                  stamps: Optional[torch.Tensor] = None):
    """Kernel L on every [H, W] frame of a CUDA map (one cooperative
    launch, no host read): (out, int32 labels or None). ``stamps``, an
    int64 [8] tensor on the card, gets the launch's first block's clock64
    at its start, at the end of its work in each phase and at the end of
    each grid barrier (csrc/speckle_kernel.cu elas_speckle)."""
    X = _frames(D, "speckle filter")
    B, H, W = X.shape
    if X.numel() >= 2 ** 31 - 1:
        raise ValueError(f"speckle filter: {tuple(D.shape)} holds 2^31 - 1"
                         f" pixels or more")
    grid, spill_labels = speckle_plan(X.device, B, H, W)
    if stamps is not None:
        cuda_lib.expect(stamps, "stamps", torch.int64, (8,), X.device)
    O = torch.empty_like(X)
    parent, count = (torch.empty(X.shape, dtype=torch.int32, device=X.device)
                     for _ in range(2))
    spill = torch.empty(spill_labels, dtype=torch.int32,
                        device=X.device) if spill_labels else None
    lbl = torch.empty_like(parent) if labels else None
    _run("elas_speckle", "elas_speckle", X,
         (X.data_ptr(), O.data_ptr(), None if lbl is None else lbl.data_ptr(),
          parent.data_ptr(), count.data_ptr(),
          None if spill is None else spill.data_ptr(),
          None if stamps is None else stamps.data_ptr()), (B, H, W, grid),
         ((ctypes.c_float, float(params.speckle_sim_threshold)),
          (ctypes.c_int, speckle_size_eff(params))), lib="speckle_kernel")
    return O.reshape(D.shape), None if lbl is None else lbl.reshape(D.shape)


def remove_small_segments(D: torch.Tensor,
                          params: ElasParams = ElasParams()) -> torch.Tensor:
    """remove_small_segments_plain's contract: kernel L on a CUDA tensor
    (one call, any leading dimensions), the plain version on a CPU one."""
    if D.is_cuda:
        return _speckle_cuda(D, params, False)[0]
    return remove_small_segments_plain(D, params)


def remove_small_segments_plain(D: torch.Tensor,
                                params: ElasParams = ElasParams()
                                ) -> torch.Tensor:
    """elas.cpp:981-1099 on one [H, W] frame: components smaller than
    speckle_size become -10."""
    lbl = _connected_component_labels(D, params.speckle_sim_threshold)
    thr = speckle_size_eff(params)
    # a size clamped at thr still fails `< thr`: the clamp is exact here
    seg_size = _segment_sizes(lbl, D >= 0, clamp=max(thr, 1))
    return torch.where((D >= 0) & (seg_size < thr), -10.0, D)


def _runs_along_rows(lbl2: torch.Tensor, valid2: torch.Tensor):
    """Maximal same-label runs of valid pixels along the rows of [R, W]:
    (run start mask, run length at starts, the largest run count of a
    row). Equal labels of neighbours mean one component, so the runs
    partition each component's pixels."""
    W = lbl2.shape[1]
    u = torch.arange(W, dtype=torch.int32, device=lbl2.device)
    same = (lbl2 == torch.roll(lbl2, 1, 1)) & valid2 & torch.roll(valid2, 1, 1)
    same[:, 0] = False
    start = valid2 & ~same
    same_next = torch.roll(same, -1, 1)
    same_next[:, -1] = False
    end = valid2 & ~same_next
    # the next run end at or after u: a reverse cummin of marked columns
    u_end_next = _cummin(torch.where(end, u, W), 1, reverse=True)
    runlen = u_end_next - u + 1
    nruns = start.sum(1, dtype=torch.int32).max()
    return start, runlen, nruns


def _small_segment_kill_batch(lbl: torch.Tensor, valid: torch.Tensor,
                              thr: int) -> torch.Tensor:
    """[B, H, W] mask of valid pixels whose component has fewer than thr
    pixels. Compact branch: components split into row runs; the row runs'
    starts are sorted to the front of their rows, the first _RUN_CAP
    slots of every row are totalled per label by one sort, and each run's
    kill bit goes back to its pixels. A frame with a row of more runs
    than that takes the per-frame sort of _segment_sizes instead (the
    branch is read back to the host), so the result is exact for every
    input."""
    B, H, W = lbl.shape
    n = H * W
    R = B * H
    cap = min(_RUN_CAP, W)
    dev = lbl.device
    offs = (torch.arange(B, dtype=torch.int32, device=dev) * n)[:, None, None]
    l2 = (lbl + offs).reshape(R, W)               # batch-global labels
    v2 = valid.reshape(R, W)
    start, runlen, nruns = _runs_along_rows(l2, v2)
    if int(nruns) > cap:
        thr_c = max(int(thr), 1)
        sizes = torch.stack([_segment_sizes(lbl[b], valid[b], clamp=thr_c)
                             for b in range(B)])
        return valid & (sizes < thr)

    u = torch.arange(W, dtype=torch.int32, device=dev)
    k1 = torch.where(start, u, W + u)             # unique keys per row
    sk, order = torch.sort(k1, dim=1)
    sl = torch.gather(l2, 1, order)
    srl = torch.gather(runlen, 1, order)
    slot_ok = sk[:, :cap] < W
    big = 2 ** 30
    key = torch.where(slot_ok, sl[:, :cap], big).reshape(-1)
    rl = torch.where(slot_ok, srl[:, :cap], 0).reshape(-1)
    gk, gpos = torch.sort(key, stable=True)
    grl = rl[gpos]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_seg = torch.cat([one, gk[1:] != gk[:-1]])
    end_seg = torch.cat([new_seg[1:], one])
    cs = torch.cumsum(grl, 0, dtype=torch.int32)
    cs_before = torch.cummax(torch.where(new_seg, cs - grl, -1), 0).values
    cs_end = _cummin(torch.where(end_seg, cs, B * n + 1), 0, reverse=True)
    tot = cs_end - cs_before
    kill_sorted = ((tot < thr) & (gk < big)).to(torch.int32)
    kill_slot = torch.empty_like(kill_sorted)
    kill_slot[gpos] = kill_sorted                 # back to slot order
    kill_pad = torch.zeros((R, W), dtype=torch.int32, device=dev)
    kill_pad[:, :cap] = kill_slot.reshape(R, cap)
    inv = torch.zeros_like(kill_pad).scatter_(1, order, kill_pad)
    # each run's kill bit, flooded from its start across the run
    flood = torch.cummax(torch.where(start, (u << 1) | inv, -1), 1).values
    return (v2 & ((flood & 1) == 1)).reshape(B, H, W)


def remove_small_segments_batch(D: torch.Tensor,
                                params: ElasParams) -> torch.Tensor:
    """remove_small_segments_batch_plain's contract: kernel L on a CUDA
    tensor (one call for every frame), the plain version on a CPU one."""
    if D.is_cuda:
        return _speckle_cuda(D, params, False)[0]
    return remove_small_segments_batch_plain(D, params)


def remove_small_segments_batch_plain(D: torch.Tensor,
                                      params: ElasParams) -> torch.Tensor:
    """remove_small_segments_plain on each [H, W] frame of [..., H, W],
    bit-equal to it."""
    X = D.reshape(-1, *D.shape[-2:])
    lbl = _connected_component_labels(X, params.speckle_sim_threshold)
    kill = _small_segment_kill_batch(lbl, X >= 0, speckle_size_eff(params))
    return torch.where(kill, -10.0, X).reshape(D.shape)


def speckle_labels(D: torch.Tensor, params: ElasParams
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speckle filter of [..., H, W] maps and each pixel's component
    label (_connected_component_labels': the component's least flat index
    in its frame, an invalid pixel's own): on a CUDA tensor one call of
    kernel L that also writes the labels, on a CPU one the plain
    versions."""
    if D.is_cuda:
        return _speckle_cuda(D, params, True)
    return (remove_small_segments_batch_plain(D, params),
            _connected_component_labels(D, params.speckle_sim_threshold))


def postprocess_after_lr(
    D1: torch.Tensor, D2: torch.Tensor, params: ElasParams = ElasParams(),
    out=None, u8=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The postprocess of [..., H, W] maps after their L/R check, on the
    device: speckle filter, gap interpolation, adaptive mean, median,
    honouring postprocess_only_left. Where both views are processed they
    go through the speckle filter together (one call of kernel L on the
    card). The batched path calls it on dense.dense_match_pair_lr's maps.
    out, u8: post_tail's sinks."""
    if params.postprocess_only_left:
        D1 = remove_small_segments_batch(D1, params)
    else:
        D1, D2 = remove_small_segments_batch(_pair(D1, D2), params)
    return post_tail(D1, D2, params, out, u8)


def postprocess(
    D1: torch.Tensor, D2: torch.Tensor, params: ElasParams = ElasParams(),
    lr_smax: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole postprocess chain (elas.cpp:108-140) of dense maps on the
    device: L/R check (sweep bound lr_smax), speckle filter by the device
    function, gap interpolation, adaptive mean, median, honouring
    postprocess_only_left. On the card kernels H, L, I, J and K, each
    taking both views in one launch; on the CPU their plain versions. The
    maps are [H, W] frames or batches [..., H, W] of them, each frame
    processed alone."""
    D1, D2 = left_right_consistency_check(D1, D2, params, lr_smax)
    return postprocess_after_lr(D1, D2, params)


def postprocess_batch(
    D1: torch.Tensor, D2: torch.Tensor, params: ElasParams = ElasParams(),
    lr_smax: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole postprocess of [B, H, W] dense maps on the device
    (postprocess on a batch): L/R check (sweep bound lr_smax), then
    postprocess_after_lr."""
    return postprocess(D1, D2, params, lr_smax)
