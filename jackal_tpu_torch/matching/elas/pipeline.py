"""ELAS matching (Elas::process, elas.cpp:32-151) on the card.

Two paths. The per-frame path, elas_match, stage by stage:

  1. descriptors                    device (ops/descriptor.py)
  2. support search                 device, CUDA kernel (support.py)
  3. pruning, exact Delaunay,       host, C++ (native_prior.py)
     plane fit, raster, grids
  4. dense MAP matching, both views device, CUDA kernel (dense.py)
  5. L/R check                      device (post.py)
  6. speckle filter                 host, C++ BFS (native_prior.py)
  7. gap fill, adaptive mean,       device (post.py)
     median

The frame crosses to the host twice: the int16 candidate grid before
stage 3, and the int16 left (and, when both views are postprocessed, right)
disparity before stage 6. Every stage is bit-equal to the reference build,
so D1/D2 equal libelas's.

The batched path, elas_match_batch_device / elas_match_batch /
elas_match_stream, keeps only pruning and triangulation on the host:

  1. descriptors + support search       device, whole batch (kernel A)
  2. candidate grids to the host        one copy into pinned memory
  3. pruning, Delaunay, triangle wire   host, C++, on worker threads
  4. one flat int32 wire per chunk      pinned upload on a side stream
  5. plane fit (float64), slopes,       device (device_prior.py,
     candidate grids, raster             device_fit.py; kernel C)
  6. dense matching, both views         device (kernel B)
  7. L/R check, speckle filter,         device (post.postprocess_batch)
     gap fill, adaptive mean, median

Frames are reordered by support count into content-homogeneous chunks
(_content_perm) and the outputs return in arrival order. The stream form
overlaps one batch's host prior with the previous batch's device work.
"""
from __future__ import annotations

import ctypes
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ...config import ElasParams
from ...device import DeviceLike, resolve_device
from ...native import load as load_native
from ...ops.descriptor import create_descriptor
from ...ops.transfer import HostCopy, ready, to_device
from . import device_prior as dp
from .dense import dense_match, pack_grid
from .native_prior import (build_priors_native, collect_support_points_native,
                           remove_small_segments_native,
                           tri_wire_and_bin_native)
from .post import left_right_consistency_check, post_tail, postprocess_batch
from .prior import delaunay
from .support import support_candidates

Image = Union[np.ndarray, torch.Tensor]


def _speckle(D: torch.Tensor, params: ElasParams) -> torch.Tensor:
    """Native BFS speckle filter; disparities are integers here, so the
    int16 round trip is exact."""
    Dh = D.to(torch.int16).cpu().numpy().astype(np.float32)
    out = remove_small_segments_native(Dh, params).astype(np.int16)
    return torch.from_numpy(out).to(D.device).to(torch.float32)


def elas_match(
    left_u8: Image,
    right_u8: Image,
    params: ElasParams = ElasParams(),
    tri_left: Optional[np.ndarray] = None,
    tri_right: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense stereo: two uint8 [H, W] images -> two float32 [H, W]
    disparity maps on ``device`` (the card unless ``device="cpu"``).

    Invalid pixels are negative (-1 / -10), matching libelas encodings.
    tri_left/tri_right override the Delaunay triangulation (tests)."""
    if params.subsampling:
        raise NotImplementedError(
            "ELAS subsampling waits for a later slice of the port "
            "(ROADMAP Queue 1, item 6)")
    if tuple(left_u8.shape) != tuple(right_u8.shape):
        raise ValueError(
            f"left/right shape mismatch: {left_u8.shape} vs {right_u8.shape}")
    dev = resolve_device(device)
    H, W = left_u8.shape
    imgs = torch.stack([torch.as_tensor(left_u8), torch.as_tensor(right_u8)])
    desc = create_descriptor(imgs.to(dev))                # [2, H, W, 16]
    desc1, desc2 = desc[0:1], desc[1:2]

    dcan = support_candidates(desc1, desc2, params)[0].cpu().numpy()
    support = collect_support_points_native(dcan, params, W, H)
    if len(support) < 3:
        bad = torch.full((H, W), -10.0, device=dev)
        return bad, bad.clone()
    maps1, maps2, grid1, grid2 = build_priors_native(
        support, W, H, params, tri_left=tri_left, tri_right=tri_right)

    def upload(maps, grid):
        host = (maps.d_plane, maps.valid, maps.tri_id >= 0, pack_grid(grid))
        return [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
                for a in host]

    D1 = dense_match(desc1, desc2, *upload(maps1, grid1), params, False)[0]
    D2 = dense_match(desc1, desc2, *upload(maps2, grid2), params, True)[0]

    D1, D2 = left_right_consistency_check(D1, D2, params)
    D1 = _speckle(D1, params)
    if not params.postprocess_only_left:
        D2 = _speckle(D2, params)
    return post_tail(D1, D2, params)


# ---------------------------------------------------------------------------
# the batched path, host side: per-frame triangle wires and chunk wires
# ---------------------------------------------------------------------------

def _content_perm(dcan: np.ndarray, B: int):
    """Frame order for content-homogeneous chunks, its inverse, and
    whether it is the identity. A chunk's pads (Np, Tp, Ts) and the
    speckle filter's sweep count are the chunk's maxima, so frames are
    sorted by their support-candidate count (stable: ties keep arrival
    order). Results do not depend on the order: padded rows are masked
    everywhere."""
    counts = np.asarray([(dcan[b] >= 0).sum() for b in range(B)])
    perm = np.argsort(counts, kind="stable")
    inv = np.empty(B, np.int64)
    inv[perm] = np.arange(B)
    return perm, inv, bool(np.all(perm == np.arange(B)))


def _prior_tri_job(dcan_b: np.ndarray, params: ElasParams, W: int, H: int):
    """Host prior of one frame: support pruning and collection, the two
    Delaunay triangulations, and the triangle wire with its tile lists
    (C++). Returns (support int16 [N, 3], tri_l, paint_l, tri_r, paint_r,
    sel_l, sel_r). With fewer than 3 support points no triangle exists, so
    nothing is covered and the dense matcher gives -10 everywhere, as the
    reference's bail-out does (elas.cpp:66-71)."""
    slab, ctile = dp._RASTER_SLAB, dp._RASTER_CTILE
    support = collect_support_points_native(dcan_b, params, W, H)
    if len(support) < 3:
        e3 = np.zeros((0, 3), np.int16)
        e1 = np.zeros((0,), np.int16)
        S = -(-H // slab) * -(-W // ctile)
        es = np.full((S, 1), -1, np.int32)
        return (np.zeros((0, 3), np.int16), e3, e1, e3.copy(), e1.copy(),
                es, es.copy())
    left_pts = support[:, :2].astype(np.float32)
    right_pts = np.stack([support[:, 0] - support[:, 2], support[:, 1]],
                         -1).astype(np.float32)
    sp16 = support.astype(np.int16)
    t1, p1, sel1 = tri_wire_and_bin_native(sp16, delaunay(left_pts), W, H,
                                           slab, ctile)
    t2, p2, sel2 = tri_wire_and_bin_native(sp16, delaunay(right_pts), W, H,
                                           slab, ctile, right=True)
    return sp16, t1, p1, t2, p2, sel1, sel2


def _pad_up(n: int, step: int = 512) -> int:
    return -(-max(n, 1) // step) * step


def _lr_ladder(wires, params: ElasParams) -> int:
    """The L/R check's sweep bound for a chunk: no dense output exceeds the
    largest support disparity + 2 (grid candidates reach d + 1, plane
    windows d_plane + plane_radius); one margin, rounded up to 32."""
    maxd = -1
    for w in wires:
        if len(w[0]):
            maxd = max(maxd, int(w[0][:, 2].max()))
    if maxd < 0:
        return 32
    return min(params.disp_max, -(-(maxd + 3) // 32) * 32)


def _chunk_pads(wires):
    """(Np, Tp, Ts) of a chunk: support rows, triangle rows and tile slots,
    padded up a ladder. Tp exceeds every triangle count, so row Tp-1 is
    always a degenerate pad row (paint -1), which pads the tile lists."""
    Np = _pad_up(max(len(w[0]) for w in wires))
    Tp = _pad_up(max(max(len(w[1]), len(w[3])) for w in wires) + 1)
    Ts = _pad_up(max(max(w[5].shape[1], w[6].shape[1]) for w in wires), 16)
    return Np, Tp, Ts


def _flatten_chunk_wire(wires, Np: int, Tp: int, Ts: int) -> np.ndarray:
    """One int32 buffer for a chunk, all int16 inside: padded support
    triples [CH, Np, 3] (pad rows (0, 0, -1)); per side the padded
    triangles [CH, Tp, 3] (pad rows index support[0] thrice) and paints
    [CH, Tp] (pad -1); per side the tile lists [CH, S*C, Ts] (pads and
    empty slots -> Tp-1). Built in C++ (native/wire_engine.cpp);
    _flatten_chunk_wire_np is its numpy twin."""
    return _flatten_chunk_wire_native(wires, Np, Tp, Ts)


def _flatten_chunk_wire_native(wires, Np: int, Tp: int,
                               Ts: int) -> np.ndarray:
    lib = load_native()
    CH = len(wires)
    SC = wires[0][5].shape[0]
    keep = [[np.ascontiguousarray(w[k], np.int16) for k in range(7)]
            for w in wires]
    i64 = np.int64
    sp_ptrs = np.array([f[0].ctypes.data for f in keep], i64)
    sp_lens = np.array([len(f[0]) for f in keep], np.int32)
    tri_ptrs = np.array([f[1].ctypes.data for f in keep]
                        + [f[3].ctypes.data for f in keep], i64)
    paint_ptrs = np.array([f[2].ctypes.data for f in keep]
                          + [f[4].ctypes.data for f in keep], i64)
    tri_lens = np.array([len(f[1]) for f in keep]
                        + [len(f[3]) for f in keep], np.int32)
    sel_ptrs = np.array([f[5].ctypes.data for f in keep]
                        + [f[6].ctypes.data for f in keep], i64)
    sel_ts = np.array([f[5].shape[1] for f in keep]
                      + [f[6].shape[1] for f in keep], np.int32)
    out = np.empty(CH * Np * 3 + 2 * (CH * Tp * 3 + CH * Tp)
                   + 2 * (CH * SC * Ts), np.int16)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.flatten_chunk_wire(
        p(sp_ptrs, ctypes.c_int64), p(sp_lens, ctypes.c_int32),
        p(tri_ptrs, ctypes.c_int64), p(paint_ptrs, ctypes.c_int64),
        p(tri_lens, ctypes.c_int32),
        p(sel_ptrs, ctypes.c_int64), p(sel_ts, ctypes.c_int32),
        CH, Np, Tp, Ts, SC, p(out, ctypes.c_int16))
    return out.view(np.int32)


def _flatten_chunk_wire_np(wires, Np: int, Tp: int, Ts: int) -> np.ndarray:
    parts = []
    sp = np.zeros((len(wires), Np, 3), np.int16)
    sp[:, :, 2] = -1
    for i, w in enumerate(wires):
        sp[i, :len(w[0])] = w[0]
    parts.append(sp.reshape(-1).view(np.int32))
    for ti, pi in ((1, 2), (3, 4)):
        tris = np.zeros((len(wires), Tp, 3), np.int16)
        paints = np.zeros((len(wires), Tp), np.int16)
        for i, w in enumerate(wires):
            tris[i], paints[i] = dp.pad_tri_wire(w[ti], w[pi], Tp)
        parts.append(tris.reshape(-1).view(np.int32))
        parts.append(paints.reshape(-1).view(np.int32))
    for si in (5, 6):
        S = wires[0][si].shape[0]
        sels = np.full((len(wires), S, Ts), Tp - 1, np.int16)
        for i, w in enumerate(wires):
            s = w[si]
            sels[i, :, :s.shape[1]] = np.where(s < 0, Tp - 1, s)
        parts.append(sels.reshape(-1).view(np.int32))
    return np.concatenate(parts).astype(np.int32, copy=False)


# ---------------------------------------------------------------------------
# the batched path, device side
# ---------------------------------------------------------------------------

def _front(left: torch.Tensor, right: torch.Tensor, params: ElasParams):
    """Descriptors and the support candidate grid of a whole batch."""
    B = left.shape[0]
    desc = create_descriptor(torch.cat([left, right]))
    d1, d2 = desc[:B], desc[B:]
    return d1, d2, support_candidates(d1, d2, params)


def _unflatten(flat: torch.Tensor, CH: int, Np: int, Tp: int, Ts: int,
               SC: int):
    """The chunk wire on the device -> (support [CH, Np, 3] int32, per side
    [tri [CH, Tp, 3] int32, paint [CH, Tp] int16, sel [CH, SC, Ts] int32])."""
    x = flat.view(torch.int16)
    pos = 0

    def take(*shape):
        nonlocal pos
        n = int(np.prod(shape))
        out = x[pos:pos + n].reshape(shape)
        pos += n
        return out

    sp = take(CH, Np, 3).to(torch.int32)
    sides = [[take(CH, Tp, 3).to(torch.int32), take(CH, Tp)]
             for _ in range(2)]
    for side in sides:
        side.append(take(CH, SC, Ts).to(torch.int32))
    return sp, sides


def _chunk_coeffs(flat: torch.Tensor, CH: int, Np: int, Tp: int, Ts: int,
                  W: int, H: int, params: ElasParams):
    """Per side (coefficient table [CH*Tp, 16], tile lists [CH, S*C, Ts],
    candidate grid words [CH, gh, gw, ceil(D/32)]): both sides' triangles
    in one coefficient call, both sides' grids in one grid call."""
    gs = params.grid_size
    SC = -(-H // dp._RASTER_SLAB) * -(-W // dp._RASTER_CTILE)
    sp, sides = _unflatten(flat, CH, Np, Tp, Ts, SC)
    dev = flat.device
    K = CH * Tp
    offs = (torch.arange(CH, dtype=torch.int32, device=dev) * Np)[:, None]
    tri_cat = torch.cat([(sides[0][0] + offs[..., None]).reshape(K, 3),
                         (sides[1][0] + offs[..., None]).reshape(K, 3)])
    rflags = torch.arange(2 * K, device=dev) >= K
    cu, cv, sb, pb, pv = dp._tri_coeffs_impl(sp.reshape(CH * Np, 3),
                                             tri_cat, rflags)
    grids = dp._grid_impl(torch.cat([sp, sp]),
                          torch.arange(2 * CH, device=dev) >= CH,
                          gs=gs, gh=-(-H // gs), gw=-(-W // gs),
                          disp_max=params.disp_max)
    words = dp.pack_grid_device(grids)
    out = []
    for i, (_, paint, sel) in enumerate(sides):
        sl = slice(i * K, (i + 1) * K)
        table = dp.pack_table(cu[sl], cv[sl], sb[sl], pb[sl], pv[sl],
                              paint.reshape(K))
        out.append((table, sel, words[i * CH:(i + 1) * CH]))
    return out


def _chunk_raster(coeffs, Tp: int, W: int, H: int):
    """Per side the dense matcher's prior: (d_plane int16, plane valid,
    covered, grid words), from the raster kernel (CUDA tensors) or its
    plain version (CPU tensors)."""
    return [(*dp.decode_win(dp.raster(table, sel, Tp, W, H)), words)
            for table, sel, words in coeffs]


def _chunk_tail(flat: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor,
                CH: int, Np: int, Tp: int, Ts: int, W: int, H: int,
                params: ElasParams, lr_smax: int):
    """One chunk's device work: coefficients and grids, the raster of both
    sides, dense matching of both views and the whole postprocess."""
    m1, m2 = _chunk_raster(
        _chunk_coeffs(flat, CH, Np, Tp, Ts, W, H, params), Tp, W, H)
    D1 = dense_match(d1, d2, *m1, params, False)
    D2 = dense_match(d1, d2, *m2, params, True)
    return postprocess_batch(D1, D2, params, lr_smax)


def _index(order: np.ndarray, dev: torch.device) -> torch.Tensor:
    return to_device(order.astype(np.int64), dev)[0]


def _batch_inputs(left_b, right_b, params: ElasParams, chunk, device):
    if params.subsampling:
        raise NotImplementedError(
            "ELAS subsampling waits for a later slice of the port "
            "(ROADMAP Queue 1, item 6); the batched path has none")
    dev = resolve_device(device)
    left, right = (torch.as_tensor(x) for x in (left_b, right_b))
    if left.shape != right.shape or left.dim() != 3:
        raise ValueError(f"need two [B, H, W] batches, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    B = left.shape[0]
    chunk = B if not chunk or chunk >= B else chunk
    if B % chunk:
        raise ValueError(f"chunk {chunk} must divide batch {B}")
    if left.device != dev and dev.type == "cuda":
        left, right = left.pin_memory(), right.pin_memory()
    return (dev, left.to(dev, non_blocking=True),
            right.to(dev, non_blocking=True), chunk)


def elas_match_batch_device(
    left_b: Image, right_b: Image, params: ElasParams = ElasParams(),
    chunk: Optional[int] = None, device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ELAS: uint8 [B, H, W] pairs -> float32 [B, H, W] disparity
    maps (D1, D2) on ``device`` (the card unless ``device="cpu"``), equal to
    elas_match frame by frame.

    Per batch one download (the candidate grids) and one upload per chunk
    of ``chunk`` frames (the flat wire); the host priors of the frames run
    on a pool of threads while the card works."""
    dev, left, right, chunk = _batch_inputs(left_b, right_b, params, chunk,
                                            device)
    B, H, W = left.shape
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    d1, d2, dcan_dev = _front(left, right, params)
    dcan = HostCopy(dcan_dev).numpy()
    perm, inv, perm_id = _content_perm(dcan, B)
    if not perm_id:
        pj = _index(perm, dev)
        d1, d2 = d1.index_select(0, pj), d2.index_select(0, pj)

    def upload_chunk(prior_futs, c0):
        wires = [prior_futs[b].result() for b in range(c0, c0 + chunk)]
        Np, Tp, Ts = _chunk_pads(wires)
        flat, ev = to_device(_flatten_chunk_wire(wires, Np, Tp, Ts), dev,
                              side)
        return flat, ev, Np, Tp, Ts, _lr_ladder(wires, params)

    outs = []
    with ThreadPoolExecutor(max_workers=3) as pool:
        prior_futs = [pool.submit(_prior_tri_job, dcan[perm[b]], params, W, H)
                      for b in range(B)]
        # queued after every prior job, so a worker never waits on a job
        # that no other worker will run
        up_futs = [pool.submit(upload_chunk, prior_futs, c0)
                   for c0 in range(0, B, chunk)]
        for c0, uf in zip(range(0, B, chunk), up_futs):
            flat, ev, Np, Tp, Ts, lad = uf.result()
            sl = slice(c0, c0 + chunk)
            outs.append(_chunk_tail(ready(flat, ev), d1[sl], d2[sl], chunk,
                                    Np, Tp, Ts, W, H, params, lad))
    D1 = torch.cat([o[0] for o in outs])
    D2 = torch.cat([o[1] for o in outs])
    if not perm_id:
        ij = _index(inv, dev)
        D1, D2 = D1.index_select(0, ij), D2.index_select(0, ij)
    return D1, D2


def elas_match_batch(
    left_u8: Image, right_u8: Image, params: ElasParams = ElasParams(),
    chunk: Optional[int] = None, device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """elas_match_batch_device with the maps brought to the host."""
    D1, D2 = elas_match_batch_device(left_u8, right_u8, params, chunk,
                                     device)
    return D1.cpu().numpy(), D2.cpu().numpy()


def elas_match_stream(
    pairs: Iterable[Tuple[Image, Image]], params: ElasParams = ElasParams(),
    chunk: Optional[int] = None, depth: int = 2, device: DeviceLike = None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Batched ELAS over a stream of ([B, H, W], [B, H, W]) pairs; yields
    (D1, D2) device tensors per batch, in order, each equal to
    elas_match_batch_device's.

    Up to ``depth`` batches are in flight: batch k+depth's front is queued
    on the card before batch k's tail, and a worker thread per batch waits
    only for its own candidate grids (an event after a pinned copy), then
    runs the host priors and uploads the chunk wires on a side stream. So
    the host prior of later batches overlaps the card's work on earlier
    ones."""
    if params.subsampling:
        raise NotImplementedError(
            "ELAS subsampling waits for a later slice of the port "
            "(ROADMAP Queue 1, item 6); the batched path has none")
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def prep(dl: HostCopy, B: int, W: int, H: int, chunkB: int):
        dcan = dl.numpy()
        perm, inv, perm_id = _content_perm(dcan, B)
        wires = [_prior_tri_job(dcan[perm[b]], params, W, H)
                 for b in range(B)]
        chunks = []
        for c0 in range(0, B, chunkB):
            w = wires[c0:c0 + chunkB]
            Np, Tp, Ts = _chunk_pads(w)
            flat, ev = to_device(_flatten_chunk_wire(w, Np, Tp, Ts), dev,
                                  side)
            chunks.append((flat, ev, Np, Tp, Ts, c0, _lr_ladder(w, params)))
        return perm, inv, perm_id, chunks

    it = iter(pairs)
    pending: deque = deque()
    with ThreadPoolExecutor(max_workers=depth) as pool:
        def start(pair) -> None:
            _, left, right, chunkB = _batch_inputs(pair[0], pair[1], params,
                                                   chunk, dev)
            B, H, W = left.shape
            d1, d2, dcan_dev = _front(left, right, params)
            pending.append((pool.submit(prep, HostCopy(dcan_dev), B, W, H,
                                        chunkB), d1, d2, chunkB, W, H))

        for _ in range(depth):
            nxt = next(it, None)
            if nxt is None:
                break
            start(nxt)
        while pending:
            fut, d1, d2, chunkB, W, H = pending.popleft()
            perm, inv, perm_id, chunks = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                start(nxt)                       # front(k + depth) first
            if not perm_id:
                pj = _index(perm, dev)
                d1, d2 = d1.index_select(0, pj), d2.index_select(0, pj)
            outs: List[Tuple[torch.Tensor, torch.Tensor]] = []
            for flat, ev, Np, Tp, Ts, c0, lad in chunks:
                sl = slice(c0, c0 + chunkB)
                outs.append(_chunk_tail(ready(flat, ev), d1[sl], d2[sl],
                                        chunkB, Np, Tp, Ts, W, H, params,
                                        lad))
            D1 = torch.cat([o[0] for o in outs])
            D2 = torch.cat([o[1] for o in outs])
            if not perm_id:
                ij = _index(inv, dev)
                D1, D2 = D1.index_select(0, ij), D2.index_select(0, ij)
            yield D1, D2
