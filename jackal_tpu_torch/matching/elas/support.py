"""ELAS support-point matching: the CUDA kernel, its plain version, and
the acceptance tests around both.

Reference: computeSupportMatches / computeMatchingDisparity
(elas.cpp:269-443). For every support-grid row v and every column c the
4-block descriptor SAD decomposes as

    cost_L(c, d) = S(v, c-2, d) + S(v, c+2, d),
    S(v, x, d)   = sum over 32 bytes |Q(v, x) - T(v, x-d)|,

where Q/T stack the 16-byte descriptors of rows v-2 and v+2 (32 bytes per
column), and the right image's cost is cost_R(c, d) = cost_L(c+d, d). Per
view only the two smallest keys cost*512 + d survive the d loop (visited
ascending, so the lowest d wins ties, as the reference's strict-<
best/second bookkeeping does, elas.cpp:354-362). A key is live only
where its taps lie inside the image:

    left:  d+5 <= c <= W-6        right:  5 <= c <= W-5-d

and is _KBIG elsewhere. grid_row_keys() computes the four key maps from
the descriptors: kernel A (csrc/support_kernel.cu), which reads the grid
rows itself, for a CUDA tensor; grid_row_blocks() then
support_keys_plain() for a CPU tensor. support_epilogue_plain() applies
the texture / ratio / bounds / forward-backward tests to the keys.
support_candidates() is the main path's front after the descriptor: on
the card one call of kernel A that writes the candidate grid as the
epilogue of its last launch (the tests are kernel Q's function, run by
the block that holds a grid row's final keys); on the CPU the plain
versions of both. support_epilogue() runs the tests alone on given keys:
kernel Q's standalone launch on the card (on no path; the card tests feed
it keys built at the ratio test's edge).

The host-side pruning in numpy (remove_inconsistent_support_points,
remove_redundant_support_points, collect_support_points) is a copy of the
reference package's, in its scan order, in place: each invalidation
changes later decisions. The C++ engine (native_prior.
collect_support_points_native) computes the same; elas_match(...,
use_native=False) runs this copy instead. prune_support_parallel is the
reference's one-shot variant, on no path of either package.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...config import ElasParams
from ...ops import cuda_lib

_KBIG = 1 << 24   # > max key (32*255*2*512 + 255)
_GAP = 5          # window(3) + u_step(2): min margin to the image edge

launches = 0      # A: grid_row_keys and support_candidates calls that
                  # launched it (one or two launches) since the last reset
fused_launches = 0      # of those, the calls whose last launch wrote the
                        # candidate grid (support_candidates)
epilogue_launches = 0   # Q alone: support_epilogue calls that launched it


def effective_stepsize(params: ElasParams) -> int:
    """candidate_stepsize, rounded up to even under subsampling so only
    every-second-line descriptors are touched (elas.cpp:379-381)."""
    step = params.candidate_stepsize
    if params.subsampling:
        step += step % 2
    return step


def grid_row_blocks(desc: torch.Tensor, step: int, ncv: int) -> torch.Tensor:
    """[B, H, W, 16] -> [B, nv, W, 32] uint8: the descriptors of rows
    vs-2 and vs+2 side by side, vs = (1..ncv-1)*step. Rows outside the
    image (past it, or above it at step 1) read the bias value 128."""
    rows = torch.arange(1, ncv, device=desc.device) * step
    pad = F.pad(desc, (0, 0, 0, 0, 2, 2), value=128)    # row y at y + 2
    return torch.cat([pad[:, rows], pad[:, rows + 4]], dim=-1).contiguous()


def support_keys_plain(Q: torch.Tensor, T: torch.Tensor, disp_min: int,
                       D: int) -> Tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch: (l1, l2, r1, r2) int32
    [B, nv, W] best and second-best keys of the left and right views."""
    B, nv, W, _ = Q.shape
    q = Q.to(torch.int32)
    t = T.to(torch.int32)
    col = torch.arange(W, device=Q.device)
    big = torch.full((B, nv, W), _KBIG, dtype=torch.int32, device=Q.device)
    l1, l2, r1, r2 = big, big.clone(), big.clone(), big.clone()
    for d in range(disp_min, D):
        # S(x, d) = |Q(x) - T(x-d)|, defined (garbage-free) for x >= d
        t_sh = F.pad(t, (0, 0, d, 0), value=128)[:, :, :W]
        s = (q - t_sh).abs().sum(-1, dtype=torch.int32)
        s_pad = F.pad(s, (2, 2 + D))               # index x+2 -> S(x)
        # cost_L(c) = S(c-2) + S(c+2); cost_R(c) = cost_L(c+d)
        cost_l = s_pad[..., 0:W] + s_pad[..., 4:W + 4]
        cost_r = s_pad[..., d:d + W] + s_pad[..., d + 4:d + 4 + W]
        live_l = (col >= d + _GAP) & (col <= W - _GAP - 1)
        live_r = (col >= _GAP) & (col <= W - _GAP - d)
        key = torch.where(live_l, cost_l * 512 + d, _KBIG)
        l2 = torch.minimum(l2, torch.maximum(l1, key))
        l1 = torch.minimum(l1, key)
        key_r = torch.where(live_r, cost_r * 512 + d, _KBIG)
        r2 = torch.minimum(r2, torch.maximum(r1, key_r))
        r1 = torch.minimum(r1, key_r)
    return l1, l2, r1, r2


@functools.lru_cache(maxsize=None)
def plan(device_index: int, B: int, nv: int, W: int, disp_min: int,
         D: int) -> Tuple[int, int]:
    """(R, DC) of the kernel at this shape on this card: the d ranges a
    grid row (R blocks, merged by a second launch when R > 1) and the d a
    chunk of its shared table. Raises ValueError for a W whose table does
    not fit in shared memory; the d range must be one the kernel
    takes (0 <= disp_min < D <= 512, checked by the caller)."""
    fn = cuda_lib.load("support_kernel").support_keys_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    ranges, chunk = ctypes.c_int(), ctypes.c_int()
    if fn(B, nv, W, disp_min, D, device_index, ctypes.byref(ranges),
          ctypes.byref(chunk)):
        raise ValueError(f"support_keys takes W up to the shared table's "
                         f"width on this card, got W = {W}")
    return ranges.value, chunk.value


def _keys_cuda(desc1: torch.Tensor, desc2: torch.Tensor, H: int,
               step: int, disp_min: int, D: int,
               params: Optional[ElasParams] = None):
    """Kernel A's call on descriptors [B, H, W, 16]: (int32 [4, B, nv, W]
    keys, nv = ceil(H / step) - 1, and, given params, the int16 [B, nv + 1,
    ceil(W / step)] candidate grid its last launch writes as its epilogue;
    else None)."""
    global launches, fused_launches
    B, _, W, _ = desc1.shape
    nv = -(-H // step) - 1
    if not 0 <= disp_min < D <= 512:
        raise ValueError(f"need 0 <= disp_min < D <= 512, got {disp_min}, {D}")
    if B > 65535:
        raise ValueError(f"support_keys takes up to 65535 frames, got {B}")
    dev = desc1.device
    out = torch.empty((4, B, nv, W), dtype=torch.int32, device=dev)
    grid = None if params is None else torch.empty(
        (B, nv + 1, -(-W // step)), dtype=torch.int16, device=dev)
    if out.numel() == 0:        # nv = 0: no grid row, nothing to launch
        if grid is not None:
            grid.zero_()        # the border row alone
        return out, grid
    ranges, chunk = plan(dev.index, B, nv, W, disp_min, D)
    part = (torch.empty((ranges, 4, B, nv, W), dtype=torch.int32,
                        device=dev) if ranges > 1 else out)
    fn = cuda_lib.load("support_kernel").support_keys
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = params if params is not None else ElasParams()
    cuda_lib.launch(fn, "support_keys", desc1, desc1.data_ptr(),
                    desc2.data_ptr(), out.data_ptr(), part.data_ptr(),
                    0 if grid is None else grid.data_ptr(), B, nv, W, H,
                    step, disp_min, D, ranges, chunk, p.support_texture,
                    p.lr_threshold, p.support_threshold)
    launches += 1
    fused_launches += grid is not None
    return out, grid


def grid_row_keys(desc1: torch.Tensor, desc2: torch.Tensor, step: int,
                  disp_min: int, D: int) -> torch.Tensor:
    """The best-two key maps of both views at grid step ``step`` from two
    descriptors [B, H, W, 16], as one int32 [4, B, ncv - 1, W] tensor (l1,
    l2, r1, r2; ncv = ceil(H / step)). On a CUDA tensor kernel A reads the
    rows vs -+ 2 of the descriptors itself (128 outside the image); on a
    CPU tensor grid_row_blocks builds the blocks for support_keys_plain."""
    B, H, W, _ = desc1.shape
    if step < 1:
        raise ValueError(f"grid step must be at least 1, got {step}")
    ncv = -(-H // step)
    if not desc1.is_cuda:
        return torch.stack(support_keys_plain(
            grid_row_blocks(desc1, step, ncv),
            grid_row_blocks(desc2, step, ncv), disp_min, D))
    for name, x in (("desc1", desc1), ("desc2", desc2)):
        cuda_lib.expect(x, name, torch.uint8, (B, H, W, 16), desc1.device)
    return _keys_cuda(desc1, desc2, H, step, disp_min, D)[0]


def support_epilogue_plain(keys: torch.Tensor, desc1: torch.Tensor,
                           desc2: torch.Tensor,
                           params: ElasParams = ElasParams()) -> torch.Tensor:
    """Kernel Q's function in plain PyTorch: the candidate grid [B, ncv,
    ncu] int16 from the key maps keys [4, B, ncv - 1, W] (grid_row_keys)
    and the descriptors [B, H, W, 16]: each view's texture, ratio and
    bounds tests, then the forward-backward check on the grid columns;
    border row and column 0 are 0."""
    B, H, W, _ = desc1.shape
    step = effective_stepsize(params)
    ncu = -(-W // step)
    ncv = -(-H // step)
    dev = desc1.device
    l1, l2, r1, r2 = keys

    vs = torch.arange(1, ncv, device=dev) * step
    us = torch.arange(1, ncu, device=dev) * step
    u_all = torch.arange(W, device=dev)
    in_v = (vs >= _GAP) & (vs <= H - _GAP - 1)                       # [nv]
    tex1 = (desc1[:, vs].to(torch.int32) - 128).abs().sum(-1)        # [B,nv,W]
    tex2 = (desc2[:, vs].to(torch.int32) - 128).abs().sum(-1)
    # filled on the device: a copy from the host would wait for the stream
    thr = torch.full((), params.support_threshold, dtype=torch.float32,
                     device=dev)

    def accept(k1, k2, tex, dmax_col, ok_col):
        cnt = torch.clamp(dmax_col - params.disp_min + 1, min=0)
        acc = (
            ok_col[None, None, :] & in_v[None, :, None]
            & (tex >= params.support_texture)
            & (cnt[None, None, :] >= 2)
            & (k1 < _KBIG)
            & ((k1 >> 9).to(torch.float32)
               < thr * (k2 >> 9).to(torch.float32))
        )
        return torch.where(acc, k1 & 511, -1)

    dmaxL = torch.clamp(u_all - _GAP, max=params.disp_max)
    okL = ((u_all >= _GAP) & (u_all <= W - _GAP - 1)
           & (dmaxL - params.disp_min >= 10))
    dL_all = accept(l1, l2, tex1, dmaxL, okL)

    dmaxR = torch.clamp(W - u_all - _GAP, max=params.disp_max)
    okR = ((u_all >= _GAP) & (u_all <= W - _GAP - 1)
           & (dmaxR - params.disp_min >= 10))
    dR_all = accept(r1, r2, tex2, dmaxR, okR)

    # forward-backward consistency on the grid columns
    dg = dL_all[:, :, us]                                            # [B,nv,nu]
    back_col = torch.clamp(us[None, None, :] - dg, 0, W - 1)
    d2 = torch.gather(dR_all, 2, back_col)
    ok = (dg >= 0) & (d2 >= 0) & ((dg - d2).abs() <= params.lr_threshold)
    out = torch.zeros((B, ncv, ncu), dtype=torch.int16, device=dev)
    out[:, 1:, 1:] = torch.where(ok, dg, -1).to(torch.int16)
    return out


def _epilogue_cuda(keys: torch.Tensor, desc1: torch.Tensor,
                   desc2: torch.Tensor, params: ElasParams) -> torch.Tensor:
    global epilogue_launches
    B, H, W, _ = desc1.shape
    step = effective_stepsize(params)
    ncu, ncv = -(-W // step), -(-H // step)
    for name, x in (("desc1", desc1), ("desc2", desc2)):
        cuda_lib.expect(x, name, torch.uint8, (B, H, W, 16), desc1.device)
    cuda_lib.expect(keys, "keys", torch.int32, (4, B, ncv - 1, W),
                    desc1.device)
    if B > 65535:
        raise ValueError(f"support_epilogue takes up to 65535 frames, got {B}")
    out = torch.empty((B, ncv, ncu), dtype=torch.int16, device=desc1.device)
    if out.numel() == 0:
        return out
    fn = cuda_lib.load("support_kernel").support_epilogue
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_lib.launch(fn, "support_epilogue", desc1, keys.data_ptr(),
                    desc1.data_ptr(), desc2.data_ptr(), out.data_ptr(), B, H,
                    W, step, params.disp_min, params.disp_max,
                    params.support_texture, params.lr_threshold,
                    params.support_threshold)
    epilogue_launches += 1
    return out


def support_epilogue(keys: torch.Tensor, desc1: torch.Tensor,
                     desc2: torch.Tensor,
                     params: ElasParams = ElasParams()) -> torch.Tensor:
    """The candidate grid from the key maps (support_epilogue_plain's
    function): kernel Q, one launch, on a CUDA tensor; the plain version
    on a CPU tensor."""
    if desc1.is_cuda:
        return _epilogue_cuda(keys, desc1, desc2, params)
    return support_epilogue_plain(keys, desc1, desc2, params)


def support_candidates(desc1: torch.Tensor, desc2: torch.Tensor,
                       params: ElasParams = ElasParams()) -> torch.Tensor:
    """Candidate grid [B, ncv, ncu] int16 from descriptors [B, H, W, 16]
    (calloc-0 border row/col 0). Entry (v_can, u_can) for u_can, v_can >= 1
    is the L/R-consistent support disparity at (u_can*step, v_can*step),
    or -1. Under subsampling the descriptors are the half-resolution ones
    (create_descriptor(..., half_resolution=True)) and the step is even,
    so the grid rows read only the rows those keep. On the card one call
    of kernel A (one or two launches), whose last launch writes the grid
    as its epilogue; on the CPU grid_row_keys then support_epilogue_plain
    (what the kernel equals bit for bit)."""
    step = effective_stepsize(params)
    D = params.disp_max + 1
    if not desc1.is_cuda:
        keys = grid_row_keys(desc1, desc2, step, params.disp_min, D)
        return support_epilogue_plain(keys, desc1, desc2, params)
    B, H, W, _ = desc1.shape
    for name, x in (("desc1", desc1), ("desc2", desc2)):
        cuda_lib.expect(x, name, torch.uint8, (B, H, W, 16), desc1.device)
    return _keys_cuda(desc1, desc2, H, step, params.disp_min, D, params)[1]


def add_corner_support_points(
    support: np.ndarray, width: int, height: int
) -> np.ndarray:
    """elas.cpp:237-267 (MIDDLEBURY add_corners): nearest-neighbor corner
    points plus two right-image corners."""
    corners = np.array(
        [[0, 0], [0, height - 1], [width - 1, 0], [width - 1, height - 1]],
        dtype=np.int64,
    )
    extra = []
    for cu, cv in corners:
        dd = (support[:, 0] - cu) ** 2 + (support[:, 1] - cv) ** 2
        best = support[np.argmin(dd), 2] if len(support) else 0
        extra.append([cu, cv, best])
    extra.append([extra[2][0] + extra[2][2], extra[2][1], extra[2][2]])
    extra.append([extra[3][0] + extra[3][2], extra[3][1], extra[3][2]])
    return np.concatenate([support, np.array(extra, support.dtype)], axis=0)


# ---------------------------------------------------------------------------
# host-side pruning in numpy (elas.cpp:153-235), the C++ engine's twin
# ---------------------------------------------------------------------------

def remove_inconsistent_support_points(
    D_can: np.ndarray, params: ElasParams = ElasParams()
) -> np.ndarray:
    """In place, elas.cpp:153-179 in its scan order (u outer): a candidate
    with fewer than incon_min_support candidates within incon_threshold in
    its (2 incon_window_size + 1)^2 window becomes -1."""
    D = D_can
    ncv, ncu = D.shape
    win, thr, min_s = (params.incon_window_size, params.incon_threshold,
                       params.incon_min_support)
    for u in range(ncu):
        u0, u1 = max(u - win, 0), min(u + win, ncu - 1)
        for v in range(ncv):
            d = D[v, u]
            if d >= 0:
                v0, v1 = max(v - win, 0), min(v + win, ncv - 1)
                nb = D[v0:v1 + 1, u0:u1 + 1]
                if ((nb >= 0) & (np.abs(nb - d) <= thr)).sum() < min_s:
                    D[v, u] = -1
    return D


def remove_redundant_support_points(
    D_can: np.ndarray, redun_max_dist: int = 5, redun_threshold: int = 1,
    vertical: bool = True,
) -> np.ndarray:
    """In place, elas.cpp:181-235: a candidate with a candidate within
    redun_threshold among the next redun_max_dist cells on both sides
    (vertically or horizontally) becomes -1."""
    D = D_can
    ncv, ncu = D.shape
    dirs = [(-1, 0), (1, 0)] if vertical else [(0, -1), (0, 1)]
    for u in range(ncu):
        for v in range(ncv):
            d = D[v, u]
            if d < 0:
                continue
            redundant = True
            for dv, du in dirs:
                support = False
                v2, u2 = v, u
                for _ in range(redun_max_dist):
                    v2 += dv
                    u2 += du
                    if not (0 <= v2 < ncv and 0 <= u2 < ncu):
                        break
                    d2 = D[v2, u2]
                    if d2 >= 0 and abs(int(d) - int(d2)) <= redun_threshold:
                        support = True
                        break
                if not support:
                    redundant = False
                    break
            if redundant:
                D[v, u] = -1
    return D


def collect_support_points(
    D_can: np.ndarray, params: ElasParams = ElasParams(),
    width: int = 0, height: int = 0,
) -> np.ndarray:
    """Prune a copy of the candidate grid and collect the (u, v, d)
    support points int32 [N, 3] in the reference's vector order (u outer,
    elas.cpp:426), with the corner points under add_corners."""
    D = np.array(D_can, dtype=np.int16)
    remove_inconsistent_support_points(D, params)
    remove_redundant_support_points(D, 5, 1, True)
    remove_redundant_support_points(D, 5, 1, False)
    step = effective_stepsize(params)
    ncv, ncu = D.shape
    pts = [(u * step, v * step, int(D[v, u]))
           for u in range(1, ncu) for v in range(1, ncv) if D[v, u] >= 0]
    out = np.array(pts, dtype=np.int32).reshape(-1, 3)
    if params.add_corners and width and height:
        out = add_corner_support_points(out, width, height)
    return out


def prune_support_parallel(D_can: torch.Tensor,
                           params: ElasParams = ElasParams()) -> torch.Tensor:
    """The one-shot pruning: remove_inconsistent_support_points' test with
    every neighbourhood read from the unpruned grid (no sequential
    effects), on [ncv, ncu] candidates; int16, -1 where pruned."""
    D = D_can.to(torch.int32)
    win = params.incon_window_size
    Dp = F.pad(D, (win, win, win, win), value=-1)
    support = torch.zeros_like(D)
    ncv, ncu = D.shape
    for dv in range(-win, win + 1):
        for du in range(-win, win + 1):
            nb = Dp[win + dv:win + dv + ncv, win + du:win + du + ncu]
            support += ((nb >= 0)
                        & ((nb - D).abs() <= params.incon_threshold))
    keep = (D >= 0) & (support >= params.incon_min_support)
    return torch.where(keep, D, -1).to(torch.int16)
