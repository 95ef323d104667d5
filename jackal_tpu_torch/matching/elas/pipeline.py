"""ELAS matching (Elas::process, elas.cpp:32-151) on the card.

Two paths. The per-frame path, elas_match, stage by stage:

  1. descriptors                    device (ops/descriptor.py)
  2. support search                 device, CUDA kernel (support.py)
  3. pruning, exact Delaunay,       host, C++ (native_prior.py)
     plane fit, raster, grids
  4. dense MAP matching, both views device, CUDA kernel (dense.py)
  5. L/R check                      device: kernel B's epilogue, or
                                    kernel H under subsampling (post.py)
  6. speckle filter                 device, kernel L (post.py), where
                                    speckle_sim_threshold < 10; else
                                    host, C++ BFS (_speckle)
  7. gap fill, adaptive mean,       device (post.py)
     median

The frame crosses to the host once, the int16 candidate grid before
stage 3 (and, on the BFS route, the int16 maps before stage 6). Every
stage is bit-equal to the reference build, so D1/D2 equal libelas's. It alone takes ElasParams.subsampling (half-
resolution maps); the batched path raises the reference's ValueError.

The batched path, elas_match_batch_device / elas_match_batch /
elas_match_stream, keeps only pruning and triangulation on the host:

  1. descriptors + support search       device, whole batch (kernel A)
  2. candidate grids to the host        one copy into pinned memory
  3. pruning, Delaunay, triangle wire   host, C++, on worker threads
  4. one flat int32 wire per chunk      pinned upload on a side stream
  5. plane fit (float64), slopes,       device, kernels M1 and M2 (one
     candidate grids, raster             launch) and C (device_prior.py)
  6. dense matching, both views,        device (kernel B with the L/R
     and the L/R check                  check as its epilogue)
  7. speckle filter, gap fill,          device (post.postprocess_after_lr)
     adaptive mean, median

Frames are reordered by support count into content-homogeneous chunks
(_content_perm) and the outputs return in arrival order. Each chunk's last
kernel writes its frames straight into the batch's output rows. The
stream form overlaps one batch's host prior with the previous batch's
device work. elas_match_batch_multichip runs the batched path as one
replica a device, each on its shard of the frames, with one host pool for
all of them.

use_native=False (every entry) runs the host prior in the numpy copy of
the reference's (support.collect_support_points, prior.build_priors;
device_prior.tri_wire and slab_select on the batched path) instead of the
C++ engine, and the per-frame path then filters speckles by the device
function at every threshold, as the reference's does (post.postprocess).

The node needs only D1's u8 map (ops.convert.dmap_u8). Its routes,
_elas_match_u8 (a frame), _elas_match_batch_u8 (a batch) and
_elas_stream_u8 (a stream), take it from the epilogue of the tail's last
kernel (post.post_tail's u8 sink) and postprocess no D2 past kernel B.
"""
from __future__ import annotations

import ctypes
import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ...config import ElasParams
from ...device import DeviceLike, device_list, resolve_device
from ...native import load as load_native
from ...ops.descriptor import create_descriptor_pair
from ...ops.transfer import HostCopy, ready, to_device
from . import device_prior as dp
from .dense import dense_match_pair, dense_match_pair_lr, pack_grid
from .native_prior import (build_priors_native, collect_support_points_native,
                           remove_small_segments_native,
                           tri_wire_and_bin_native)
from .post import (_pair, left_right_consistency_check, post_tail,
                   postprocess_after_lr, remove_small_segments, u8_map)
from .prior import build_priors, delaunay
from .support import collect_support_points, support_candidates

Image = Union[np.ndarray, torch.Tensor]


# per-frame speckle filters by route: kernel L on the card, the C++ BFS
speckle_routes = {"elas_speckle": 0, "bfs": 0}
# L equals the BFS below this similarity threshold (_speckle_on_card)
KERNEL_SPECKLE_BELOW = 10.0


def _speckle(D: torch.Tensor, params: ElasParams) -> torch.Tensor:
    """Native BFS speckle filter, as the reference's per-frame path runs
    it (jackal_tpu/matching/elas/pipeline.py _postprocess_hybrid);
    disparities are integers here, so the int16 round trip is exact.

    The BFS and the device function (post.remove_small_segments, kernel
    L) segment differently: the BFS starts from every pixel, invalid ones
    included, and from an invalid start takes in a valid neighbour when
    |D[start] - D[n]| <= speckle_sim_threshold; the device function joins
    valid pixels only. After the L/R check every invalid pixel is exactly
    -10 and every valid one >= 0, so the two agree whenever the threshold
    is below 10 (both presets: 1) and differ at 10 and above
    (tests/test_torch_speckle_route.py)."""
    speckle_routes["bfs"] += 1
    Dh = D.to(torch.int16).cpu().numpy().astype(np.float32)
    out = remove_small_segments_native(Dh, params).astype(np.int16)
    return torch.from_numpy(out).to(D.device).to(torch.float32)


def _speckle_on_card(dev: torch.device, params: ElasParams) -> bool:
    """Whether elas_match runs its speckle filter as kernel L: on the card
    where the threshold is below 10 (_speckle). The choice follows the
    device and the parameters alone; on the CPU the BFS runs, as the
    reference's per-frame path runs it."""
    return dev.type == "cuda" and \
        params.speckle_sim_threshold < KERNEL_SPECKLE_BELOW


@dataclasses.dataclass
class ElasDebug:
    """elas_match(..., return_debug=True)'s third item: the support points
    (int32 [N, 3], on the host) and both views' dense maps before the L/R
    check (float32, on the maps' device; [H // 2, W // 2] under
    subsampling)."""
    support: np.ndarray
    dense_D1: torch.Tensor
    dense_D2: torch.Tensor


def _host_prior(dcan: np.ndarray, params: ElasParams, W: int, H: int,
                tri_left, tri_right, native: bool):
    """(support, priors) of a candidate grid, by the C++ engine or the
    numpy prior; priors None with fewer than 3 support points."""
    collect = (collect_support_points_native if native
               else collect_support_points)
    support = collect(dcan, params, W, H)
    if len(support) < 3:
        return support, None
    build = build_priors_native if native else build_priors
    return support, build(support, W, H, params, tri_left=tri_left,
                          tri_right=tri_right)


def _match_frame(left_u8: Image, right_u8: Image, params: ElasParams,
                 tri_left, tri_right, device: DeviceLike,
                 use_native: Optional[bool], return_debug: bool, u8: bool):
    """elas_match's work. With u8 (the node's route) it returns D1's u8
    map alone, written by the tail's last kernel, and postprocesses no D2
    past the L/R check."""
    if tuple(left_u8.shape) != tuple(right_u8.shape):
        raise ValueError(
            f"left/right shape mismatch: {left_u8.shape} vs {right_u8.shape}")
    dev = resolve_device(device)
    native = use_native is None or bool(use_native)
    H, W = left_u8.shape
    desc = create_descriptor_pair(torch.as_tensor(left_u8).to(dev),
                                  torch.as_tensor(right_u8).to(dev),
                                  params.subsampling)          # [2,H,W,16]
    desc1, desc2 = desc[0:1], desc[1:2]

    dcan = support_candidates(desc1, desc2, params)[0].cpu().numpy()
    support, priors = _host_prior(dcan, params, W, H, tri_left, tri_right,
                                  native)
    if priors is None:
        bad = torch.full((H, W), -10.0, device=dev)
        return u8_map(bad) if u8 else (bad, bad.clone())
    maps1, maps2, grid1, grid2 = priors

    def upload(maps, grid):
        host = (maps.d_plane, maps.valid, maps.tri_id >= 0, pack_grid(grid))
        return [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
                for a in host]

    views = (upload(maps1, grid1), upload(maps2, grid2))
    dbg = None
    if params.subsampling or return_debug:
        D1, D2 = (x[0] for x in dense_match_pair(desc1, desc2, *views,
                                                 params))
        if params.subsampling:
            # the L/R check runs on the kept even pixels, after the kernel
            D1, D2 = (x[0::2, 0::2][:H // 2, :W // 2].contiguous()
                      for x in (D1, D2))
        if return_debug:
            dbg = ElasDebug(support, D1, D2)
        D1, D2 = left_right_consistency_check(D1, D2, params)
    else:
        D1, D2 = (x[0] for x in dense_match_pair_lr(desc1, desc2, *views,
                                                    params))
    params = _node_params(params, u8)
    if not native or _speckle_on_card(dev, params):
        speckle_routes["elas_speckle"] += 1
        if params.postprocess_only_left:
            D1 = remove_small_segments(D1, params)
        else:
            D1, D2 = remove_small_segments(_pair(D1, D2), params)
    else:
        D1 = _speckle(D1, params)
        if not params.postprocess_only_left:
            D2 = _speckle(D2, params)
    if u8:
        U = torch.empty(D1.shape, dtype=torch.uint8, device=dev)
        post_tail(D1, D2, params, u8=U)
        return U
    D1, D2 = post_tail(D1, D2, params)
    return (D1, D2, dbg) if return_debug else (D1, D2)


def elas_match(
    left_u8: Image,
    right_u8: Image,
    params: ElasParams = ElasParams(),
    tri_left: Optional[np.ndarray] = None,
    tri_right: Optional[np.ndarray] = None,
    return_debug: bool = False,
    use_native: Optional[bool] = None,
    device: DeviceLike = None,
):
    """Dense stereo: two uint8 [H, W] images -> two float32 [H, W]
    disparity maps on ``device`` (the card unless ``device="cpu"``).

    Invalid pixels are negative (-1 / -10), matching libelas encodings.
    tri_left/tri_right override the Delaunay triangulation (tests). Under
    params.subsampling (elas.h:82-84) the descriptors are half-resolution,
    the support step even, and the maps [H // 2, W // 2]: the dense
    matcher computes every pixel and the even ones are kept
    (elas.cpp:793-795, 877-881); with fewer than 3 support points the
    maps are [H, W] of -10, as the reference's bail-out returns them (and,
    as there, without the debug item).

    use_native: None or True, the C++ host prior; False, the numpy host
    prior and the device speckle filter (kernel L on the card, its plain
    version on the CPU) at every threshold. return_debug: also return
    ElasDebug (the support points and kernel B's maps before the L/R
    check, which then runs as kernel H)."""
    return _match_frame(left_u8, right_u8, params, tri_left, tri_right,
                        device, use_native, return_debug, False)


def _elas_match_u8(left_u8: Image, right_u8: Image,
                   params: ElasParams = ElasParams(),
                   device: DeviceLike = None) -> torch.Tensor:
    """The node's per-frame route: dmap_u8 of elas_match's D1, uint8
    [H, W] on ``device``, written by the epilogue of the tail's last
    kernel (the bail-out's by one launch of elas_u8)."""
    return _match_frame(left_u8, right_u8, params, None, None, device, None,
                        False, True)


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


def _prior_tri_job(dcan_b: np.ndarray, params: ElasParams, W: int, H: int,
                   use_native: Optional[bool] = None):
    """Host prior of one frame: support pruning and collection, the two
    Delaunay triangulations, and the triangle wire with its tile lists
    (C++; numpy with use_native=False). Returns (support int16 [N, 3],
    tri_l, paint_l, tri_r, paint_r, sel_l, sel_r). With fewer than 3
    support points no triangle exists, so nothing is covered and the dense
    matcher gives -10 everywhere, as the reference's bail-out does
    (elas.cpp:66-71)."""
    slab, ctile = dp._RASTER_SLAB, dp._RASTER_CTILE
    native = use_native is None or bool(use_native)
    support = (collect_support_points_native if native
               else collect_support_points)(dcan_b, params, W, H)
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
    if native:
        t1, p1, sel1 = tri_wire_and_bin_native(sp16, delaunay(left_pts), W,
                                               H, slab, ctile)
        t2, p2, sel2 = tri_wire_and_bin_native(sp16, delaunay(right_pts), W,
                                               H, slab, ctile, right=True)
    else:
        t1, p1 = dp.tri_wire(support, delaunay(left_pts))
        t2, p2 = dp.tri_wire(support, delaunay(right_pts))
        sel1 = dp.slab_select(support, t1, W, H, slab, ctile)
        sel2 = dp.slab_select(support, t2, W, H, slab, ctile, right=True)
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
    """Descriptors and the support candidate grid of a whole batch: on the
    card one launch of kernel R for both views and one call of kernel A,
    which writes the grid as its epilogue."""
    desc = create_descriptor_pair(left, right)
    d1, d2 = desc[0], desc[1]
    return d1, d2, support_candidates(d1, d2, params)


def _chunk_coeffs(flat: torch.Tensor, CH: int, Np: int, Tp: int, Ts: int,
                  W: int, H: int, params: ElasParams):
    """Per side (coefficient table [CH*Tp, 16], tile lists [CH, S*C, Ts],
    candidate grid words [CH, gh, gw, ceil(D/32)]) of the chunk wire: both
    sides' tables, tile lists and grids in one launch of kernels M1 and M2
    (their plain versions on a CPU wire)."""
    gs = params.grid_size
    SC = -(-H // dp._RASTER_SLAB) * -(-W // dp._RASTER_CTILE)
    table, sels, words = dp.coeff_grid(flat, CH, Np, Tp, SC, Ts, gs,
                                       -(-H // gs), -(-W // gs),
                                       params.disp_num)
    K = CH * Tp
    return [(table[i * K:(i + 1) * K], sels[i], words[i * CH:(i + 1) * CH])
            for i in range(2)]


def _chunk_raster(coeffs, Tp: int, W: int, H: int):
    """Per side the dense matcher's prior: (d_plane int16, plane valid,
    covered, grid words), from one launch of the raster kernel for both
    sides (CUDA tensors) or its plain version (CPU tensors)."""
    tables, sels, words = zip(*coeffs)
    maps = dp.raster_maps(tables, sels, Tp, W, H)
    CH = sels[0].shape[0]
    return [(*(m[i * CH:(i + 1) * CH] for m in maps), words[i])
            for i in range(len(coeffs))]


def _chunk_tail(flat: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor,
                CH: int, Np: int, Tp: int, Ts: int, W: int, H: int,
                params: ElasParams, lr_smax: int, out=None, u8=None):
    """One chunk's device work: coefficients and grids, the raster of both
    sides, dense matching of both views with the L/R check (sweep bound
    lr_smax) and the rest of the postprocess. out: None, or the chunk's
    (D1, D2) output rows, which the last kernel of each view writes (kernel
    B D2's under postprocess_only_left); u8: None, or the chunk's rows of
    the u8 map (post_tail's sinks)."""
    m1, m2 = _chunk_raster(
        _chunk_coeffs(flat, CH, Np, Tp, Ts, W, H, params), Tp, W, H)
    left = params.postprocess_only_left
    D1, D2 = dense_match_pair_lr(
        d1, d2, m1, m2, params, lr_smax,
        (None, out[1]) if left and out is not None else None)
    return postprocess_after_lr(
        D1, D2, params, None if out is None else out[:1] if left else out,
        u8)


def _upload_chunk(prior_futs, c0: int, chunk: int, params: ElasParams,
                  dev: torch.device, side):
    """A worker's job: wait for the chunk's host priors, build its flat
    wire and start its upload to ``dev`` (on ``side`` when given). Returns
    (flat, event, Np, Tp, Ts, L/R sweep bound)."""
    wires = [prior_futs[b].result() for b in range(c0, c0 + chunk)]
    Np, Tp, Ts = _chunk_pads(wires)
    flat, ev = to_device(_flatten_chunk_wire(wires, Np, Tp, Ts), dev, side)
    return flat, ev, Np, Tp, Ts, _lr_ladder(wires, params)


def _index(order: np.ndarray, dev: torch.device) -> torch.Tensor:
    return to_device(order.astype(np.int64), dev)[0]


_NO_SUBSAMPLING = "batched path does not support subsampling; use elas_match"


def _batch_inputs(left_b, right_b, params: ElasParams, chunk, device):
    if params.subsampling:
        raise ValueError(_NO_SUBSAMPLING)
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


def _out_rows(Bs: int, H: int, W: int, dev: torch.device, u8: bool):
    """A replica's output: the u8 map [Bs, H, W], or (D1, D2) as [0] and
    [1] of one float32 [2, Bs, H, W] tensor."""
    if u8:
        return torch.empty((Bs, H, W), dtype=torch.uint8, device=dev)
    return tuple(torch.empty((2, Bs, H, W), dtype=torch.float32,
                             device=dev))


def _tail_into(rows, sl: slice, u8: bool):
    """_chunk_tail's (out, u8) sinks for the frames ``sl`` of _out_rows."""
    if u8:
        return None, rows[sl]
    return (rows[0][sl], rows[1][sl]), None


def _arrival(rows, inv: np.ndarray, perm_id: bool, dev: torch.device):
    """_out_rows back in arrival order (index_select by the inverse of the
    content order, which scatters whole frames)."""
    if perm_id:
        return rows
    ij = _index(inv, dev)
    if torch.is_tensor(rows):
        return rows.index_select(0, ij)
    return tuple(x.index_select(0, ij) for x in rows)


def _node_params(params: ElasParams, u8: bool) -> ElasParams:
    """The u8 routes read D1 alone: D2 is not postprocessed past B."""
    return dataclasses.replace(params, postprocess_only_left=True) if u8 \
        else params


def _elas_replicas(shards, params: ElasParams, chunk: int,
                   use_native: Optional[bool] = None, u8: bool = False):
    """The batched path on one or more replicas. ``shards`` lists
    (device, left, right), each [Bs, H, W] already on its device; returns
    each replica's (D1, D2) (with u8, its u8 maps [Bs, H, W]) on its
    device, in its frames' order. Three phases:
      1. every replica's front (descriptors, support candidates) is queued
         before any download of the candidate grids;
      2. one pool of 3 workers runs the host priors of every replica's
         frames, then each chunk's wire build and upload, so one device's
         chunks overlap another's priors;
      3. each chunk's upload (a side stream a distinct card) and its tail
         (raster, dense, postprocess) run on its replica's device, chunk by
         chunk across the replicas; each chunk's last kernels write its
         frames into the replica's output rows."""
    Bs, H, W = shards[0][1].shape
    tail_params = _node_params(params, u8)
    sides = {dev: torch.cuda.Stream(dev) for dev, _, _ in shards
             if dev.type == "cuda"}
    fronts = [_front(left, right, params) for _, left, right in shards]
    copies = [HostCopy(f[2]) for f in fronts]
    dcans = [c.numpy() for c in copies]
    views, perms = [], []
    for (dev, _, _), (d1, d2, _), dcan in zip(shards, fronts, dcans):
        perm, inv, perm_id = _content_perm(dcan, Bs)
        if not perm_id:
            pj = _index(perm, dev)
            d1, d2 = d1.index_select(0, pj), d2.index_select(0, pj)
        views.append((d1, d2))
        perms.append((perm, inv, perm_id))

    outs = [_out_rows(Bs, H, W, dev, u8) for dev, _, _ in shards]
    with ThreadPoolExecutor(max_workers=3) as pool:
        prior_futs = [[pool.submit(_prior_tri_job, dcan[perm[b]], params, W,
                                   H, use_native) for b in range(Bs)]
                      for dcan, (perm, _, _) in zip(dcans, perms)]
        # queued after every prior job, so a worker never waits on a job
        # that no other worker will run
        up_futs = [(i, c0, pool.submit(_upload_chunk, prior_futs[i], c0,
                                       chunk, params, dev, sides.get(dev)))
                   for c0 in range(0, Bs, chunk)
                   for i, (dev, _, _) in enumerate(shards)]
        for i, c0, uf in up_futs:
            flat, ev, Np, Tp, Ts, lad = uf.result()
            d1, d2 = views[i]
            sl = slice(c0, c0 + chunk)
            _chunk_tail(ready(flat, ev), d1[sl], d2[sl], chunk, Np, Tp, Ts,
                        W, H, tail_params, lad, *_tail_into(outs[i], sl, u8))
    return [_arrival(rows, inv, perm_id, dev)
            for (dev, _, _), rows, (_, inv, perm_id)
            in zip(shards, outs, perms)]


def elas_match_batch_device(
    left_b: Image, right_b: Image, params: ElasParams = ElasParams(),
    use_native: Optional[bool] = None, chunk: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ELAS: uint8 [B, H, W] pairs -> float32 [B, H, W] disparity
    maps (D1, D2) on ``device`` (the card unless ``device="cpu"``), equal to
    elas_match frame by frame.

    Per batch one download (the candidate grids) and one upload per chunk
    of ``chunk`` frames (the flat wire); the host priors of the frames run
    on a pool of threads while the card works (numpy's with
    use_native=False)."""
    dev, left, right, chunk = _batch_inputs(left_b, right_b, params, chunk,
                                            device)
    return _elas_replicas([(dev, left, right)], params, chunk,
                          use_native)[0]


def _elas_match_batch_u8(left_b: Image, right_b: Image,
                         params: ElasParams = ElasParams(),
                         chunk: Optional[int] = None,
                         device: DeviceLike = None) -> torch.Tensor:
    """The node's batched route: dmap_u8 of elas_match_batch_device's D1,
    uint8 [B, H, W], each chunk's rows written by the epilogue of its
    tail's last kernel; no D2 is postprocessed."""
    dev, left, right, chunk = _batch_inputs(left_b, right_b, params, chunk,
                                            device)
    return _elas_replicas([(dev, left, right)], params, chunk, None,
                          True)[0]


def elas_match_batch(
    left_u8: Image, right_u8: Image, params: ElasParams = ElasParams(),
    use_native: Optional[bool] = None, chunk: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """elas_match_batch_device with the maps brought to the host."""
    D1, D2 = elas_match_batch_device(left_u8, right_u8, params, use_native,
                                     chunk, device)
    return D1.cpu().numpy(), D2.cpu().numpy()


def elas_match_batch_multichip(
    left_u8: Image, right_u8: Image, params: ElasParams = ElasParams(),
    use_native: Optional[bool] = None, chunk: Optional[int] = None,
    devices: Optional[Iterable] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """ELAS data parallelism: replica a device, frames sharded. uint8
    [B, H, W] pairs, B a multiple of len(devices) (every visible card by
    default) -> host float32 [B, H, W] maps (D1, D2), equal to
    elas_match_batch's.

    The host prior sits mid-pipeline, so there is no single step to shard;
    each device runs the batched path on its shard of B / n frames (the
    reference's one ELAS a node), all replicas in one pass of
    _elas_replicas, chunks of ``chunk`` frames."""
    if params.subsampling:
        raise ValueError(_NO_SUBSAMPLING)
    devs = device_list(devices)
    left, right = (torch.as_tensor(x) for x in (left_u8, right_u8))
    B = left.shape[0]
    n = len(devs)
    if B % n:
        raise ValueError(f"batch {B} not divisible by {n} devices")
    Bs = B // n
    if chunk is None or chunk >= Bs:
        chunk = Bs
    if Bs % chunk:
        raise ValueError(f"chunk {chunk} must divide shard {Bs}")
    shards = [(dev, left[i * Bs:(i + 1) * Bs].to(dev),
               right[i * Bs:(i + 1) * Bs].to(dev))
              for i, dev in enumerate(devs)]
    maps = _elas_replicas(shards, params, chunk, use_native)
    return (np.concatenate([D1.cpu().numpy() for D1, _ in maps]),
            np.concatenate([D2.cpu().numpy() for _, D2 in maps]))


def elas_match_stream(
    pairs: Iterable[Tuple[Image, Image]], params: ElasParams = ElasParams(),
    use_native: Optional[bool] = None, chunk: Optional[int] = None,
    depth: int = 2, device: DeviceLike = None,
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
    return _stream(pairs, params, use_native, chunk, depth, device, False)


def _elas_stream_u8(
    pairs: Iterable[Tuple[Image, Image]], params: ElasParams = ElasParams(),
    chunk: Optional[int] = None, depth: int = 2, device: DeviceLike = None,
) -> Iterator[torch.Tensor]:
    """The streaming node's route: elas_match_stream's D1 as u8 maps
    [B, H, W] per batch (_elas_match_batch_u8's)."""
    return _stream(pairs, params, None, chunk, depth, device, True)


def _stream(pairs, params: ElasParams, use_native: Optional[bool],
            chunk: Optional[int], depth: int, device: DeviceLike, u8: bool):
    if params.subsampling:
        raise ValueError(_NO_SUBSAMPLING)
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    tail_params = _node_params(params, u8)

    def prep(dl: HostCopy, B: int, W: int, H: int, chunkB: int):
        dcan = dl.numpy()
        perm, inv, perm_id = _content_perm(dcan, B)
        wires = [_prior_tri_job(dcan[perm[b]], params, W, H, use_native)
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
            rows = _out_rows(d1.shape[0], H, W, dev, u8)
            for flat, ev, Np, Tp, Ts, c0, lad in chunks:
                sl = slice(c0, c0 + chunkB)
                _chunk_tail(ready(flat, ev), d1[sl], d2[sl], chunkB, Np, Tp,
                            Ts, W, H, tail_params, lad,
                            *_tail_into(rows, sl, u8))
            yield _arrival(rows, inv, perm_id, dev)
