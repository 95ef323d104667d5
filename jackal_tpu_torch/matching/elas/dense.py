"""ELAS dense MAP matching: the CUDA kernel and its plain version.

Reference: computeDisparity/findMatch (elas.cpp:661-907). Per pixel the
candidate walk (grid candidates outside the plane window, then the plane
window with a log-prior penalty) is one keyed minimum over d:

    cost = SAD16(q[v', u], t[v', u -/+ d]),  v' = clamp(v, 2, H-3)
    S1   = d in the pixel's grid-cell candidate set, outside the window
    S2   = d in the plane window [d_plane - r, d_plane + r]
    key  = (cost + (S2 ? prior * P[|d - d_plane|] : 0) + 16) * 512 + rank,
    rank = d (S1) | 256 + d (S2)

over candidates whose warped column lies in [2, W-3], at pixels that are
covered by a triangle, lie in u in [2, W-3] and pass the texture gate. The
keys are unique per pixel (the rank carries d), so the minimum does not
depend on the order d is visited, and it reproduces the reference's
strict-< visit order (S1 ascending d, then S2 ascending d). The result is
d, -1 (no candidate) or -10 (pixel not matched).

dense_match_pair() runs the CUDA kernel (csrc/elas_dense_kernel.cu) once
for both views on CUDA tensors and dense_match_pair_plain() (two
dense_match_plain() calls) on CPU tensors; dense_match() does one view on
the same kernel. dense_match_pair_lr() is the pair followed by the L/R
check (post.left_right_consistency_check): on the card one launch of the
kernel with the check as its row epilogue where one block owns whole rows
(lr_fused: W <= 1024, no subsampling; every preset), else the pair and
then kernel H. The pair's two outputs are one [2, B, H, W] tensor, whose
[0] and [1] the calls return (the postprocess takes them as one, post.
_pair), or the tensors given as ``out`` (the batched path's output rows).
Under subsampling the function is the same: the caller
computes every pixel from the half-resolution descriptors and keeps the
even ones (pipeline.elas_match, as the reference's elas_match does).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ...config import ElasParams
from ...ops import cuda_lib
from .post import (left_right_consistency_check,
                   left_right_consistency_check_plain)

_WINDOW = 2          # findMatch window_size (elas.cpp:689)
_KEY_BIAS = 16       # priors reach -14; keep keys non-negative
_BIG = 1 << 30
# the kernel takes P[0..radius] by value up to this radius (its unrolled
# instantiations), from a table on the card past it
_UNROLLED_RADIUS = 7
# the widest row one block owns (csrc/elas_dense_kernel.cu kStripMax): the
# L/R epilogue needs the whole row of both views on chip
STRIP_MAX = 1024

launches = 0         # elas_dense kernel launches since the last reset
lr_launches = 0      # of which with the L/R check as the epilogue


def prior_table(params: ElasParams = ElasParams()) -> np.ndarray:
    """P[delta_d] int32 (elas.cpp:802-805), C-cast truncation."""
    dd = np.arange(params.disp_num, dtype=np.float64)
    two_s2 = 2.0 * params.sigma * params.sigma
    val = (-np.log(params.gamma + np.exp(-dd * dd / two_s2))
           + np.log(params.gamma)) / params.beta
    return val.astype(np.int32)  # trunc toward zero, like (int32_t)(float)


def _views(desc1, desc2, right_image):
    return (desc2, desc1, 1) if right_image else (desc1, desc2, -1)


def dense_match_plain(
    desc1: torch.Tensor,        # [B, H, W, 16] uint8 (left descriptor)
    desc2: torch.Tensor,        # [B, H, W, 16] uint8 (right descriptor)
    d_plane: torch.Tensor,      # [B, H, W] int (int)(a*u+b*v+c)
    plane_valid: torch.Tensor,  # [B, H, W] bool (|a|<0.7 both images)
    covered: torch.Tensor,      # [B, H, W] bool (pixel rasterized by a tri)
    grid_words: torch.Tensor,   # [B, gh, gw, ceil(D/32)] int32 (pack_grid)
    params: ElasParams = ElasParams(),
    right_image: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: [B, H, W] float32."""
    B, H, W, _ = desc1.shape
    D = params.disp_num
    gs = params.grid_size
    radius = params.plane_radius
    dev = desc1.device
    q, t, sign = _views(desc1, desc2, right_image)

    vidx = torch.clamp(torch.arange(H, device=dev), 2, H - 3)
    qc = q[:, vidx].to(torch.int32)                      # [B, H, W, 16]
    tc = t[:, vidx].to(torch.int32)
    u = torch.arange(W, device=dev)
    tex = (qc - 128).abs().sum(-1)
    u_ok = (u >= _WINDOW) & (u < W - _WINDOW)
    pixel_ok = covered & u_ok & (tex >= params.match_texture)

    dp = d_plane.to(torch.int32)
    d_min = torch.clamp(dp - radius, min=0)
    d_max = torch.clamp(dp + radius, max=D - 1)
    prior = plane_valid.to(torch.int32)
    P = [int(x) for x in prior_table(params)[:radius + 1]]
    rows = (torch.arange(H, device=dev) // gs)[:, None]
    cols = (torch.arange(W, device=dev) // gs)[None, :]

    best = torch.full((B, H, W), _BIG, dtype=torch.int32, device=dev)
    for d in range(D):
        warp = u + sign * d
        warp_ok = (warp >= _WINDOW) & (warp < W - _WINDOW)
        if sign < 0:
            t_sh = F.pad(tc, (0, 0, d, 0))[:, :, :W]
        else:
            t_sh = F.pad(tc, (0, 0, 0, d))[:, :, d:d + W]
        cost = (qc - t_sh).abs().sum(-1, dtype=torch.int32)
        in_grid = ((grid_words[:, rows, cols, d // 32] >> (d % 32)) & 1) > 0
        in_win = (d >= d_min) & (d <= d_max)
        dd = (d - dp).abs()
        pd = torch.zeros_like(dp)
        for j, pj in enumerate(P):
            pd = torch.where(dd == j, pj, pd)
        val = cost + torch.where(in_win, prior * pd, 0)
        rank = d + 256 * in_win.to(torch.int32)
        key = (val + _KEY_BIAS) * 512 + rank
        live = (in_grid | in_win) & warp_ok & pixel_ok
        best = torch.minimum(best, torch.where(live, key, _BIG))

    d_best = (best % 512) % 256
    out = torch.where(best < _BIG, d_best.to(torch.float32), -1.0)
    return torch.where(pixel_ok, out, -10.0)


class _PriorTable(ctypes.Structure):
    _fields_ = [("p", ctypes.c_int * (_UNROLLED_RADIUS + 1))]


class _ViewMaps(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("d_plane", "valid", "covered", "grid", "out")]


def pack_grid(grid_mask: np.ndarray) -> np.ndarray:
    """[..., D] bool candidate sets -> [..., ceil(D/32)] int32 bit words
    (bit k of word w is candidate d = 32w + k). Runs on the host, where the
    native prior makes the grid, so 1/8 of its bytes cross to the card."""
    D = grid_mask.shape[-1]
    pad = [(0, 0)] * (grid_mask.ndim - 1) + [(0, -D % 32)]
    return np.packbits(np.pad(grid_mask, pad), axis=-1,
                       bitorder="little").view("<i4")


def _checked_maps(maps, name, shape, grid_shape, dev):
    """A view's (d_plane, plane_valid, covered, grid_words), contiguous and
    checked for the kernel; d_plane stays int16 or becomes int32."""
    d_plane, plane_valid, covered, grid_words = maps
    if d_plane.dtype not in (torch.int16, torch.int32):
        d_plane = d_plane.to(torch.int32)
    out = [x.contiguous() for x in (d_plane, plane_valid, covered,
                                    grid_words)]
    for x, what, dt, shp in zip(
            out, ("d_plane", "plane_valid", "covered", "grid_words"),
            (out[0].dtype, torch.bool, torch.bool, torch.int32),
            (shape, shape, shape, grid_shape)):
        cuda_lib.expect(x, f"{name} {what}", dt, shp, dev)
    return out


def _dense_match_cuda(desc1, desc2, maps_left, maps_right, params, views,
                      lr_smax=None, out=None):
    """Launch the kernel once for the views named by ``views`` (1 left, 2
    right, 3 both); maps_* are the views' prior maps (the unused view's
    may be None). With lr_smax (views 3, lr_fused shapes only) the kernel
    runs the L/R check with that sweep bound as its epilogue. Returns the
    views' outputs: both views' are [0] and [1] of one tensor, or the
    tensors of ``out`` (a pair, None for a view to allocate)."""
    global launches, lr_launches
    B, H, W, C = desc1.shape
    D = params.disp_num
    gs = params.grid_size
    radius = params.plane_radius
    dev = desc1.device
    # the key's rank field holds d < 256 (256 + d marks a window candidate,
    # decoded by % 512 % 256), as in the reference kernel: the function is
    # the reference's for D <= 256 only, on the card and on the CPU
    if D > 256 or not (5 <= H <= 65535 and 5 <= W <= 65535):
        raise ValueError(f"dense kernel needs D <= 256, 5 <= H, W <= 65535; "
                         f"got D={D}, {H}x{W}")
    some = maps_left if maps_left is not None else maps_right
    gh, gw, nw = some[3].shape[1:4]
    if gh * gs < H or gw * gs < W or nw != -(-D // 32):
        raise ValueError(f"grid {gh}x{gw}x{nw} words of cell {gs} does not "
                         f"cover {H}x{W}x{D}")
    cuda_lib.expect(desc1, "desc1", torch.uint8, (B, H, W, 16), dev)
    cuda_lib.expect(desc2, "desc2", torch.uint8, (B, H, W, 16), dev)
    checked = [None if m is None else
               _checked_maps(m, nm, (B, H, W), (B, gh, gw, nw), dev)
               for m, nm in ((maps_left, "left"), (maps_right, "right"))]
    dts = {m[0].dtype for m in checked if m is not None}
    if len(dts) != 1:
        raise ValueError(f"both views' d_plane need one dtype, got {dts}")
    if views == 3 and out is None:
        outs = list(torch.empty((2, B, H, W), dtype=torch.float32,
                                device=dev))
    else:
        outs = [None if m is None else
                torch.empty((B, H, W), dtype=torch.float32, device=dev)
                if o is None else o
                for m, o in zip(checked, out or (None, None))]
    structs = []
    for i, (m, o) in enumerate(zip(checked, outs)):
        if m is not None:
            cuda_lib.expect(o, f"out {i}", torch.float32, (B, H, W), dev, 4)
        structs.append(_ViewMaps() if m is None else _ViewMaps(
            *(x.data_ptr() for x in m), o.data_ptr()))
    table = prior_table(params)[:radius + 1]
    P, table_dev = _PriorTable(), None
    if radius <= _UNROLLED_RADIUS:
        for j, pj in enumerate(table):
            P.p[j] = int(pj)
    else:
        table_dev = torch.from_numpy(np.ascontiguousarray(table)).to(dev)
    fn = cuda_lib.load("elas_dense_kernel").elas_dense
    fn.argtypes = ([ctypes.c_void_p] * 2 + [_ViewMaps] * 2
                   + [ctypes.c_int] * 14 + [ctypes.c_float]
                   + [_PriorTable, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lr = lr_smax is not None
    cuda_lib.launch(fn, "elas_dense", desc1, desc1.data_ptr(),
                    desc2.data_ptr(), *structs, views,
                    int(torch.int16 in dts), B, H, W, D, gh, gw, nw, gs,
                    radius, params.match_texture, int(lr),
                    lr_smax if lr else 0, float(params.lr_threshold), P,
                    None if table_dev is None else table_dev.data_ptr())
    launches += 1
    lr_launches += int(lr)
    return outs


def dense_match(desc1, desc2, d_plane, plane_valid, covered, grid_words,
                params: ElasParams = ElasParams(),
                right_image: bool = False) -> torch.Tensor:
    """Dense disparity [B, H, W] float32 of one view; the CUDA kernel (one
    launch for this view) on CUDA tensors, the plain version on CPU
    tensors. grid_words is the candidate grid as pack_grid gives it."""
    if desc1.is_cuda:
        maps = (d_plane, plane_valid, covered, grid_words)
        outs = _dense_match_cuda(desc1, desc2,
                                 None if right_image else maps,
                                 maps if right_image else None, params,
                                 2 if right_image else 1)
        return outs[1 if right_image else 0]
    return dense_match_plain(desc1, desc2, d_plane, plane_valid, covered,
                             grid_words, params, right_image)


def dense_match_pair_plain(desc1, desc2, maps_left, maps_right,
                           params: ElasParams = ElasParams()):
    """The pair kernel's function in plain PyTorch: two dense_match_plain
    calls."""
    return (dense_match_plain(desc1, desc2, *maps_left, params, False),
            dense_match_plain(desc1, desc2, *maps_right, params, True))


def dense_match_pair(desc1, desc2, maps_left, maps_right,
                     params: ElasParams = ElasParams()):
    """Both views' dense disparities (D1, D2), each [B, H, W] float32:
    one kernel launch for both on CUDA tensors, the plain version on CPU
    tensors. maps_left / maps_right are each view's (d_plane, plane_valid,
    covered, grid_words)."""
    if desc1.is_cuda:
        return tuple(_dense_match_cuda(desc1, desc2, maps_left, maps_right,
                                       params, 3))
    return dense_match_pair_plain(desc1, desc2, maps_left, maps_right,
                                  params)


def lr_fused(W: int, params: ElasParams) -> bool:
    """Whether the card runs the L/R check as the pair kernel's epilogue at
    row width W: one block must own the whole row of both views, and the
    check must see the maps the kernel writes (under subsampling the caller
    keeps the even pixels first)."""
    return W <= STRIP_MAX and not params.subsampling


def dense_match_pair_lr_plain(desc1, desc2, maps_left, maps_right,
                              params: ElasParams = ElasParams(),
                              smax: int = -1):
    """The fused kernel's function in plain PyTorch: dense_match_pair_plain
    then left_right_consistency_check_plain (sweep bound smax; < 0 means
    disp_max)."""
    D1, D2 = dense_match_pair_plain(desc1, desc2, maps_left, maps_right,
                                    params)
    return left_right_consistency_check_plain(D1, D2, params, smax)


def dense_match_pair_lr(desc1, desc2, maps_left, maps_right,
                        params: ElasParams = ElasParams(), smax: int = -1,
                        out=None):
    """Both views' dense disparities after the L/R check (sweep bound smax;
    < 0 means disp_max), each [B, H, W] float32. On CUDA tensors one launch
    of the pair kernel with the check as its epilogue where lr_fused holds,
    else the pair kernel and then kernel H; the plain version on CPU
    tensors. out: None, or a pair of contiguous float32 [B, H, W] tensors
    (None for a view to allocate) the checked maps are written to (on the
    fused route by the kernel itself)."""
    if not desc1.is_cuda or not lr_fused(desc1.shape[2], params):
        if desc1.is_cuda:
            D1, D2 = dense_match_pair(desc1, desc2, maps_left, maps_right,
                                      params)
            D1, D2 = left_right_consistency_check(D1, D2, params, smax)
        else:
            D1, D2 = dense_match_pair_lr_plain(desc1, desc2, maps_left,
                                               maps_right, params, smax)
        if out is None:
            return D1, D2
        return tuple(D if o is None else o.copy_(D)
                     for D, o in zip((D1, D2), out))
    smax = params.disp_max if smax < 0 else min(smax, params.disp_max)
    return tuple(_dense_match_cuda(desc1, desc2, maps_left, maps_right,
                                   params, 3, smax, out))
