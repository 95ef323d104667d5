"""ELAS postprocessing in PyTorch on [..., H, W] float32 maps.

Reference: leftRightConsistencyCheck (elas.cpp:909-979), removeSmallSegments
(981-1099, BFS speckle), gapInterpolation (1101-1284), adaptiveMean
(1287-1492, SSE approximate bilateral), median (1494-1560). The per-frame
path runs the speckle filter as the native BFS
(native_prior.remove_small_segments_native); the batched path runs it on
the device (remove_small_segments_batch): 4-connected components under
|d_i - d_j| <= sim_threshold by min-label run scans to a fixed point, then
a component-size kill, bit-equal to the BFS.

Exactness: every float operation here is a single eager PyTorch op, so no
multiply is fused into an add, and f32 division is correctly rounded on
both the CPU and the card. The adaptive mean's sums keep the reference's
SSE lane order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...config import ElasParams


def left_right_consistency_check(
    D1: torch.Tensor, D2: torch.Tensor, params: ElasParams = ElasParams(),
    smax: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """elas.cpp:909-979 on [..., H, W] maps. Invalid -> -10.

    A pixel keeps its disparity when the other view, read at the warped
    column (int)(u -/+ d), agrees within lr_threshold. The shift is
    clamped to [0, smax]; smax < 0 means disp_max. The batched path
    passes a bound no dense output exceeds (pipeline._lr_ladder), as the
    reference package does."""
    W = D1.shape[-1]
    u = torch.arange(W, device=D1.device)
    smax = params.disp_max if smax < 0 else min(smax, params.disp_max)

    def check(Da, Db, sign):
        uw = u.to(torch.float32) + sign * Da
        ok = (Da >= 0) & (uw >= 0) & (uw < W)
        s = torch.clamp(sign * (uw.to(torch.int32) - u), 0, smax)
        col = u + sign * s
        inside = (col >= 0) & (col < W)
        other = torch.gather(Db, -1, torch.clamp(col, 0, W - 1).to(torch.int64))
        other = torch.where(inside, other, -1e9)
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


def gap_interpolation(D: torch.Tensor,
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


def _adaptive_pass(src: torch.Tensor, axis: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One 8-tap pass of the reference's approximate bilateral filter.

    Window offsets -4..+3 around the center; weight
    max(0, 4 - ref_absmask(v - center)). Returns (result, store_ok) with
    store_ok = weight_sum>0 and result>=0 (elas.cpp:1434-1437)."""
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
    m = torch.arange(W, device=x.device) % 4
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
    return (res, ok) if axis == 1 else (_t(res), _t(ok))


def adaptive_mean(D: torch.Tensor) -> torch.Tensor:
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


def median_filter(D: torch.Tensor) -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# speckle filter on the device (the batched path)
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


def remove_small_segments(D: torch.Tensor,
                          params: ElasParams = ElasParams()) -> torch.Tensor:
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
    """remove_small_segments on each frame of [B, H, W], bit-equal to it."""
    lbl = _connected_component_labels(D, params.speckle_sim_threshold)
    kill = _small_segment_kill_batch(lbl, D >= 0, speckle_size_eff(params))
    return torch.where(kill, -10.0, D)


def postprocess_batch(
    D1: torch.Tensor, D2: torch.Tensor, params: ElasParams = ElasParams(),
    lr_smax: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole postprocess of [B, H, W] dense maps on the device: L/R
    check (sweep bound lr_smax), speckle filter, gap interpolation,
    adaptive mean, median, honouring postprocess_only_left."""
    D1, D2 = left_right_consistency_check(D1, D2, params, lr_smax)
    D1 = remove_small_segments_batch(D1, params)
    if not params.postprocess_only_left:
        D2 = remove_small_segments_batch(D2, params)
    return post_tail(D1, D2, params)
