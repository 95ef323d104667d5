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

and is _KBIG elsewhere. support_keys() computes the four key maps with the
CUDA kernel (csrc/support_kernel.cu) for a CUDA tensor and with
support_keys_plain() for a CPU tensor; support_candidates() applies the
texture / ratio / bounds / forward-backward tests to either.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...config import ElasParams
from ...ops import cuda_lib

_KBIG = 1 << 24   # > max key (32*255*2*512 + 255)
_GAP = 5          # window(3) + u_step(2): min margin to the image edge

launches = 0      # support_keys kernel launches since the last reset


def effective_stepsize(params: ElasParams) -> int:
    """candidate_stepsize, rounded up to even under subsampling so only
    every-second-line descriptors are touched (elas.cpp:379-381)."""
    step = params.candidate_stepsize
    if params.subsampling:
        step += step % 2
    return step


def grid_row_blocks(desc: torch.Tensor, step: int, ncv: int) -> torch.Tensor:
    """[B, H, W, 16] -> [B, nv, W, 32] uint8: the descriptors of rows
    vs-2 and vs+2 side by side, vs = (1..ncv-1)*step. Rows past the image
    read the bias value 128."""
    B, H, W, C = desc.shape
    nv = ncv - 1
    need = (ncv - 1) * step + 2 + 1
    if need > H:
        desc = F.pad(desc, (0, 0, 0, 0, 0, need - H), value=128)
    rm = desc[:, step - 2::step][:, :nv]
    rp = desc[:, step + 2::step][:, :nv]
    return torch.cat([rm, rp], dim=-1).contiguous()


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


def _support_keys_cuda(Q: torch.Tensor, T: torch.Tensor, disp_min: int,
                       D: int) -> Tuple[torch.Tensor, ...]:
    global launches
    B, nv, W, _ = Q.shape
    for name, x in (("Q", Q), ("T", T)):
        cuda_lib.expect(x, name, torch.uint8, (B, nv, W, 32), Q.device)
    if not 0 <= disp_min < D <= 512:
        raise ValueError(f"need 0 <= disp_min < D <= 512, got {disp_min}, {D}")
    lib = cuda_lib.load("support_kernel")
    fn = lib.support_keys
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    outs = [torch.empty((B, nv, W), dtype=torch.int32, device=Q.device)
            for _ in range(4)]
    err = fn(Q.data_ptr(), T.data_ptr(), *(o.data_ptr() for o in outs),
             B, nv, W, disp_min, D, cuda_lib.stream_ptr(Q))
    cuda_lib.check(err, "support_keys")
    launches += 1
    return tuple(outs)


def support_keys(Q: torch.Tensor, T: torch.Tensor, disp_min: int, D: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Best-two key maps of both views; the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if Q.is_cuda:
        return _support_keys_cuda(Q, T, disp_min, D)
    return support_keys_plain(Q, T, disp_min, D)


def support_candidates(desc1: torch.Tensor, desc2: torch.Tensor,
                       params: ElasParams = ElasParams()) -> torch.Tensor:
    """Candidate grid [B, ncv, ncu] int16 from descriptors [B, H, W, 16]
    (calloc-0 border row/col 0). Entry (v_can, u_can) for u_can, v_can >= 1
    is the L/R-consistent support disparity at (u_can*step, v_can*step),
    or -1."""
    if params.subsampling:
        raise NotImplementedError(
            "ELAS subsampling waits for a later slice of the port "
            "(ROADMAP Queue 1, item 6)")
    B, H, W, _ = desc1.shape
    step = effective_stepsize(params)
    ncu = -(-W // step)
    ncv = -(-H // step)
    D = params.disp_max + 1
    dev = desc1.device

    l1, l2, r1, r2 = support_keys(grid_row_blocks(desc1, step, ncv),
                                  grid_row_blocks(desc2, step, ncv),
                                  params.disp_min, D)

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
