#!/usr/bin/env python3
"""Drive jackal_tpu_torch's main path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no success line):
  1. card: name and power limit, torch / CUDA / nvcc versions; build the
     CUDA kernels and the C++ prior in parallel from the sources;
  2. kernels against their plain PyTorch versions on the card, bit for bit:
     support and dense at 640x480, D = 256, on the two 640x480 golden
     fixtures, and on two seeded random frames at a width that is not a
     multiple of 32 (dense each view alone and both views in one launch,
     dense_match_pair; the pair call also at D = 32 and at D = 8 with
     cells of one pixel); support also on chip_smoke.SUPPORT_EDGE_CASES (the
     node's and the batched node's shapes, D = 512 at W = 2112 and 4096,
     W < D, disp_min near D, an odd width, constant descriptors);
  2b. (a) the raster kernel against its plain version (torch.equal) on
     every chunk of the two 640x480 golden fixtures batched by chunks of 1
     and 2, on wide triangles, on planes that overflow int32 and on
     chip_smoke.RASTER_EDGE_CASES (three rounds of slots, a triangle over
     every tile, tiles of pad slots only, 8 frames at 640x480); (b) the
     card's device prior against the C++ host prior: covered, valid,
     d_plane where covered and grids equal, planes bit-equal to
     fit_planes_native, coefficients (slopes, planes, grids) equal to the
     CPU's;
  3. ELAS on the card against libelas: D1/D2 of both 640x480 fixtures;
     (c) the batched path on the card: both fixtures in one batch, chunk 1
     and chunk 2, against libelas; the 9 synthetic node frames against the
     per-frame elas_match;
  4. the node: make_pipeline(engine="elas") at 640x480 and process_frame on
     seeded raw 640x360 pairs of a known scene (pipeline/synthetic.py),
     with the launch counters reset just before and read just after (the
     dense kernel once a frame, both views in one launch);
     per-stage medians, fps, the device's busy time under torch.profiler,
     a per-stage breakdown of one frame;
  4b. (d) the batched node: StreamingRunner at batch 8 over 48 frames with
     the launch counters reset just before and read just after (the dense
     kernel once a batch); fps, the
     frames published, the device's busy time and idle share under
     torch.profiler beside process_batch's, and a per-stage breakdown of
     one batch;
  5. the roofline bound of each kernel from this run's inputs; the peak
     rate of its byte SADs is measured on the card (csrc/sad_rate.cu, the
     median of 7 windows, refused above the card's cap), and cuobjdump
     shows the instructions __vsadu4 became (the dense and census kernels'
     whole opcode mix) and that the raster kernel has no FFMA; the dense
     kernel's pair call against its plain version on the batched node's 8
     frames, its time there and at the node's shape, its bound for both
     views (the bound a view at a time, summed, beside it) and the
     candidates a pixel and warp steps of each view (dense_work); the
     support kernel against its plain version on the batched
     node's 8 frames, its time there and at the node's shape, its bound
     restated in instructions (support_work; the old byte-SAD bound
     beside it); a time of the support or the dense kernel below its
     bound fails; (e) the raster kernel against its plain version on the
     batched node's chunk of 8 frames, its device time, its plain
     version's and its bound from this run's live tile slots, by
     instruction type (f32,
     integer, conversions at their rates; the old f32-only bound beside
     it; a time below the bound fails);
  6. SGM: (a) kernels D (census), E (paths) and F (WTA maps) against their
     plain versions (torch.equal) on the golden pair at 640x480, D = 64
     and 128, and on seeded awkward shapes (4 paths, true_right, penalties
     past E's 16-bit lanes, lines shorter than E's ring, H and W under 32,
     D > W), and F alone on chip_smoke.WTA_EDGE_CASES (constant and
     tie-heavy volumes at D = 2, 3 and 64, a single column, D = 256 at
     W = 1280, config 3's B = 4 at 1280x960); (b)
     sgm_match_batch on the card against the CPU's plain path on both
     golden scenes at D = 64 and 128, with the pooled RMSE and mask
     agreement against libelas; (c) the SGM node, make_pipeline() at
     640x480: process_frame on 9 synthetic pairs, stage medians, fps, idle
     share; process_batch_fused at batch 4 against process_frame;
     StreamingRunner at batch 4 over 48 frames; the SGM stages of one
     frame; (d) BASELINE config 3, process_batch_fused at 1280x960, D = 64,
     B = 4; each of these four paths with the launch counters of D, E and
     F set to 0 just before and read just after; (e) each kernel against
     its plain version (torch.equal), its device time, its plain version's
     and its bound (and E's bound as counted before its 16-bit lanes) at
     the node's shape and at config 3's (D's bound at its byte lanes' 26
     instructions a pixel, the unpacked 48 beside it), and E's device
     memory a call; a time below its bound fails;
  7. BM and gen_pcl: (a) kernel G against its plain twin (torch.equal) on
     both golden pairs at D = 64 and 256 and on seeded awkward shapes
     (W = 2000, W % 64 != 0, D past G's strip, H and W under 32, fewer rows
     than the window, windows 1 to 21, B = 32 batches in G's 64-column
     strip); (b)
     the BM node, make_pipeline(engine="bm") at 640x480, D = 64:
     process_frame on 9 synthetic pairs (stage medians, fps, idle share),
     process_batch_fused at batch 8 against process_frame, StreamingRunner
     at batch 8 over 48 frames; (c) BASELINE config 5, the headline:
     process_batch_fused_pcl at B = 32 on the golden scenes interleaved
     (fps, peak memory, its stages), its maps against process_batch_fused's,
     one frame's cloud (points exact) and scan against the CPU's and G
     against its plain twin on the rectified batch; (d) bench_bm256's
     process_batch_fused at B = 16, D = 256, and G against its plain twin
     on that rectified batch; each of these paths with G's
     launch counter set to 0 just before and read just after (9, 1, 6, 1,
     1); (e) BM-64's RMSE and mask agreement against libelas D1; (f) G's
     device time, its plain twin's and its bound (and the bound as counted
     before G's packed instructions) at the node's shape, at D = 256, at
     config 5's and at bench_bm256's, a time below its bound failing, at
     the last two beside G' "full32" (32-column strips), and G' (the
     per-part timing) in its five modes;
  9. the node shell, the CLIs a user runs (cli/point_cloud.main in this
     process at 640x480 on ELAS): (a) per frame over 9 frames of the
     synthetic stream (synthetic:9) and of an NPZ replay of phase 4's
     calibrated pairs, maps against process_frame's (torch.equal), scans
     within relative 1e-5, A called once a frame and B launched once a
     frame on the replay (the synthetic stream's rectified frames give
     ELAS fewer than 3 support points, so B does not run there), the
     median logged dmap time and the frame loop's fps from the CLI's
     per-frame lines; (b) --batch 8 over 48 and 240 frames of the replay
     (the stream scheduler): A and B once a batch and C twice, the fps the
     CLI prints; (c) -m --phi --trans on the replay: scans against
     process_frame's after update_extrinsics, and unlike (a)'s; (d) the
     navigate CLI on (a)'s scans; each CLI call with the launch counters
     set to 0 just before it and read just after; one JSON line;
  8. a "kernels" JSON line, the card line, and the final JSON line.

A kernel's time a call ("ms") is CUDA events around calls queued behind a
spin kernel (events_ms); torch.profiler only splits it by kernel, since it
leaves some launches of these kernels unrecorded. A plain version's time
is CUDA events around its calls, host gaps included. Integer operations
are bounded at 64 a clock an SM (int_ops_rate: the support kernel's and
D-G's instructions); the raster's f32 operations at 128 a clock an SM and
its conversions at 16 (raster_bound_ms); the dense kernel's byte SADs at
the measured byte SAD rate.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

FIX = "tests/fixtures"
GOLDEN = ("elas_golden_s640_boxes", "elas_golden_photo")
# published H100 SXM HBM rate (NVIDIA data sheet); the rate of the
# kernels' operations (byte SADs) is measured in phase 5
PEAK_BYTES_PER_S = 3.35e12
# float32 operations outside the tensor cores (the same sheet), counting an
# FFMA as two: the raster's bound before it was counted by instruction type
# (raster_bound_ms), printed beside it. The SGM kernels' 32-bit integer
# operations run at int_ops_rate().
PEAK_F32_OPS_PER_S = 67e12
DEVICE = "cuda:0"
# BASELINE config 3 of the reference package (bench.py bench_sgm): SGM at
# 1280x960, D = 64, batch 4
CONFIG3 = (4, 960, 1280)
# BASELINE config 5, the reference package's headline (bench.py
# bench_headline): BM, D = 64, gen_pcl, 640x480, batch 32; and bench_bm256:
# BM at D = 256, batch 16
CONFIG5_B, BM256_B = 32, 16


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def host_ms(fn, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _union_ms(spans) -> float:
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / 1e3


# the kernel names of the device_busy windows in which torch.profiler
# recorded no device activity at all; the run's summary repeats them
EMPTY_PROFILER_WINDOWS = []


def device_busy(fn, name: str = "", host_ops: bool = True):
    """(wall ms, device-busy ms, ms of the kernels named ``name``, their
    launches' device times in ms) of fn() under torch.profiler: the union
    of the intervals in which a CUDA kernel or copy ran, and of those whose
    name contains ``name`` (None and [] when no name is given).
    host_ops=False traces the card alone, which keeps the profiler's own
    host cost out of a multi-threaded run's wall time. A window in which
    the profiler recorded no device activity at all is traced again, up
    to 3 windows (it happened once in a window of kernel E's 20 calls,
    cause unknown), with a warning that the run's summary repeats; raises
    if all 3 record none, or if none is in a kernel of that name:
    there is no other yardstick."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host_ops else [])
    for window in range(3):
        with profile(activities=activities) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
        EMPTY_PROFILER_WINDOWS.append(name or "(unnamed)")
        print(f"WARNING: torch.profiler recorded no device activity in "
              f"window {window + 1} of 3{f' ({name})' if name else ''}; "
              f"traced again")
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    named = [e for e in dev if name and name in e.name]
    if name and not named:
        raise RuntimeError(f"torch.profiler recorded no kernel named {name}")
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    return (wall, _union_ms(spans), _union_ms(
        (e.time_range.start, e.time_range.end) for e in named)
        if name else None,
        [(e.time_range.end - e.time_range.start) / 1e3 for e in named])


def launch_ms(fn, reps: int, name: str):
    """(ms, launches recorded): the mean device time of the launches of
    the kernels named ``name`` that torch.profiler recorded over reps calls
    of fn() after two warm-ups, the split of a call's time by kernel. The
    profiler leaves some launches of these kernels unrecorded (PERF.md,
    Findings), so a call's time comes from events_ms instead."""
    for _ in range(2):
        fn()
    *_, times = device_busy(lambda: [fn() for _ in range(reps)], name)
    return statistics.mean(times), len(times)


def events_ms(fn, reps: int, spin: bool = True) -> float:
    """Device ms a call of fn(): CUDA events around reps calls after two
    warm-ups. With ``spin`` the calls are queued behind a spin kernel of
    about 50 ms, so the card runs them back to back whatever the host's
    pace; raises if the host took longer to queue them than the spin
    lasted (then the card may have waited on it). Without it the time
    includes the host's gaps between launches: what a caller of a
    host-bound function (a plain version) waits."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    if spin:
        torch.cuda._sleep(100_000_000)       # ~50 ms at 1980 MHz
    ev[1].record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ev[2].record()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    spun = ev[0].elapsed_time(ev[1])
    if spin and host_ms >= spun:
        raise RuntimeError(f"events_ms: the host took {host_ms:.3f} ms to "
                           f"queue the calls, the spin lasted {spun:.3f} ms")
    return ev[1].elapsed_time(ev[2]) / reps


def max_sm_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout)


def int_ops_rate(dev) -> float:
    """32-bit integer operations (add, min, compare, logic, shift) a
    second: 64 a clock an SM on compute capability 9.0 (CUDA C++
    Programming Guide, arithmetic instruction throughput), at the maximum
    SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * 64 * max_sm_hz()


def sad_rate(dev):
    """(rate, cap): byte SADs per second that __vsadu4 sustains on the
    card, from the microbenchmark csrc/sad_rate.cu (8 resident blocks of
    256 threads on every SM), and the most the card could do: one 64-lane
    __vsadu4 unit an SM (256 byte SADs a clock) at the maximum SM clock.
    The rate is the median of 7 windows of 3 launches, each timed by
    events_ms (torch.profiler both misses launches of this kernel and has
    been seen to record one at half its time). Raises when
    the median is above the cap, which no card can reach."""
    import ctypes

    import torch
    from jackal_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load("sad_rate")
    lib.sad_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_uint32, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = 8 * sms
    threads, iters, reps = 256, 16384, 3
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)

    def run():
        cuda_lib.check(lib.sad_rate(out.data_ptr(), blocks, threads, iters,
                                    12345, cuda_lib.stream_ptr(out)),
                       "sad_rate")
    sads = blocks * threads * iters * lib.sad_rate_chains() * 4
    windows = [sads / (events_ms(run, reps) * 1e-3) for _ in range(7)]
    mhz = max_sm_hz() / 1e6
    cap = sms * mhz * 1e6 * 64 * 4
    rate = statistics.median(windows)
    print(f"byte SAD rate windows (csrc/sad_rate.cu, {reps} launches each, "
          f"CUDA events): " + ", ".join(f"{w:.6g}" for w in windows))
    print(f"byte SAD rate, median: {rate:.6g} /s = {rate / 4 / (sms * mhz * 1e6):.2f}"
          f" __vsadu4 a clock per SM at the {mhz:.0f} MHz max SM clock, "
          f"{sms} SMs; cap (64 a clock per SM) {cap:.6g} /s")
    if rate > cap:
        raise AssertionError(f"byte SAD rate {rate:.6g} /s is above the "
                             f"card's cap {cap:.6g} /s: a faulty reading")
    return rate, cap


def sass_opcodes(path: str, top=8, prefix: str = "") -> str:
    """The most frequent SASS opcodes of a built library (cuobjdump), or
    all of those that start with ``prefix``."""
    import collections
    import os
    import re

    from jackal_tpu_torch.ops import cuda_lib

    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    ops = collections.Counter(re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
        sass))
    return ", ".join(f"{op} {n}" for op, n in ops.most_common(top)
                     if op.startswith(prefix))


def prior_inputs(desc1, desc2, params, dev):
    """Native prior of a descriptor pair: per view the dense-kernel
    inputs (d_plane, valid, covered, grid words), each with a batch axis."""
    import torch
    from jackal_tpu_torch.matching.elas.dense import pack_grid
    from jackal_tpu_torch.matching.elas.native_prior import (
        build_priors_native, collect_support_points_native)
    from jackal_tpu_torch.matching.elas.support import support_candidates

    H, W = desc1.shape[1:3]
    dcan = support_candidates(desc1, desc2, params)[0].cpu().numpy()
    support = collect_support_points_native(dcan, params, W, H)
    m1, m2, g1, g2 = build_priors_native(support, W, H, params)
    return [[torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
             for a in (m.d_plane, m.valid, m.tri_id >= 0, pack_grid(g))]
            for m, g in ((m1, g1), (m2, g2))]


def random_prior(rng, B, H, W, params, dev):
    import torch
    from jackal_tpu_torch.matching.elas.dense import pack_grid

    gs = params.grid_size
    gh, gw = -(-H // gs), -(-W // gs)
    arrs = (rng.integers(-4, 64, (B, H, W)).astype(np.int32),
            rng.random((B, H, W)) < 0.7, rng.random((B, H, W)) < 0.9,
            pack_grid(rng.random((B, gh, gw, params.disp_num)) < 0.1))
    return [torch.from_numpy(a).to(dev) for a in arrs]


def support_work(Q, disp_min, D):
    """(bytes, instructions, the old count in byte SADs) of the support
    function on Q's shape. Bytes: the inputs read once, the four key maps
    written once. Instructions, the least the function needs: 8 __vsadu4
    for each S(x, d) that some live key reads (its taps enumerated d by d:
    x = c-2 and c+2 of the left view's live columns, c+d-2 and c+d+2 of
    the right view's) and 3 for each live (c, d, view): the best-two
    update with the key's add fused into __viaddmax_s32 and
    __viaddmin_s32, then a min (csrc/support_kernel.cu). The old count: the
    64 byte SADs of every live (c, d, view), at the measured byte SAD
    rate."""
    B, nv, W, _ = Q.shape
    c = np.arange(W)
    reads = live = 0
    for d in range(disp_min, D):
        lc = c[(c >= d + 5) & (c <= W - 6)]
        rc = c[(c >= 5) & (c <= W - 5 - d)]
        taps = np.zeros(W + 2, bool)
        for x in (lc - 2, lc + 2, rc + d - 2, rc + d + 2):
            taps[x] = True
        reads += int(taps.sum())
        live += len(lc) + len(rc)
    rows = B * nv
    nbytes = 2 * Q.numel() + 4 * 4 * rows * W
    return nbytes, rows * (8 * reads + 3 * live), rows * live * 64


def dense_work(desc1, desc2, d_plane, valid, covered, words, params, right):
    """(bytes, candidates a pixel, warp steps) of one dense view on these
    inputs. Bytes: the descriptor pair and the view's maps read once, its
    output written once (a pair call reads the descriptors once for both
    views: dense_pair_work). The operations are the 16 byte SADs of every
    candidate this run's data visits at a matched pixel. Warp steps, over
    the warps of 32 consecutive columns, summed over the warps: the
    kernel's (2r+1 window steps plus its longest lane's grid candidates
    outside the window), a warp-uniform walk's (2r+1 plus the size of the
    union of the lanes' grid candidates outside their windows) and the
    first design's (its longest lane's candidate count)."""
    import torch
    import torch.nn.functional as F

    B, H, W, _ = desc1.shape
    D, gs, r = params.disp_num, params.grid_size, params.plane_radius
    dev = desc1.device
    q = desc2 if right else desc1
    vidx = torch.clamp(torch.arange(H, device=dev), 2, H - 3)
    tex = (q[:, vidx].to(torch.int32) - 128).abs().sum(-1)
    u = torch.arange(W, device=dev)
    pixel_ok = covered & (u >= 2) & (u < W - 2) & (tex >= params.match_texture)
    rows = (torch.arange(H, device=dev) // gs)[:, None]
    cols = (u // gs)[None, :]
    dp = d_plane.to(torch.int32)
    lo, hi = torch.clamp(dp - r, min=0), torch.clamp(dp + r, max=D - 1)
    count = torch.zeros((B, H, W), dtype=torch.int64, device=dev)
    grid_only = torch.zeros_like(count)
    union = torch.zeros((B, H, -(-W // 32)), dtype=torch.int64, device=dev)
    sign = 1 if right else -1
    pad = -W % 32
    for d in range(D):
        warp = u + sign * d
        ok = (warp >= 2) & (warp < W - 2) & pixel_ok
        in_grid = ((words[:, rows, cols, d // 32] >> (d % 32)) & 1) > 0
        in_win = (d >= lo) & (d <= hi)
        count += (in_grid | in_win) & ok
        g = in_grid & ~((d >= dp - r) & (d <= dp + r)) & ok
        grid_only += g
        union += F.pad(g, (0, pad)).view(B, H, -1, 32).any(-1)
    lanes = F.pad(count, (0, pad)).view(B, H, -1, 32).amax(-1)
    lanes_grid = F.pad(grid_only, (0, pad)).view(B, H, -1, 32).amax(-1)
    window = (2 * r + 1) * union.numel()
    nbytes = (2 * desc1.numel() + d_plane.numel() * d_plane.element_size()
              + valid.numel() + covered.numel() + 4 * words.numel()
              + 4 * B * H * W)
    return nbytes, count, {"steps": window + int(lanes_grid.sum()),
                           "uniform_steps": window + int(union.sum()),
                           "first_design_steps": int(lanes.sum()),
                           "warps": union.numel(),
                           "grid_candidates": int(grid_only.sum())}


def dense_pair_work(desc1, desc2, maps_left, maps_right, params):
    """(bytes, byte SADs, per-view counts) of one pair call: the descriptor
    pair read once, each view's maps and output once; the byte SADs of
    both views' candidates (dense_work)."""
    views = [dense_work(desc1, desc2, *m, params, right)
             for m, right in ((maps_left, False), (maps_right, True))]
    nbytes = sum(v[0] for v in views) - 2 * desc1.numel()
    sads = sum(int(v[1].sum()) for v in views) * 16
    return nbytes, sads, views


def raster_work(table, sel, Tp, W, H):
    """(bytes, operations by type, the old count, live slots) of one raster
    call on these inputs: the table, the tile lists and the key map each
    moved once. A live slot names a row of its frame other than the pad
    row Tp-1 whose paint is >= 0. The operations are what this run's
    triangles need, by the instruction type that runs them:
      per live slot: its three intercepts (3 f32 multiplies, 3 subtracts,
        4 int -> float conversions of its corners) and pb * v for each row
        of its tile (1 f32 multiply);
      per column of the tile inside its span [A_u, C_u): the two scanline
        bounds and pa * u (5 f32 multiplies and adds; two float -> int
        conversions and the column's int -> float; 10 integer operations:
        the span test, the segment select, the bounds' minima and maxima
        with H, the band's row range);
      per pixel of the band the slot covers (lo <= v < hi): the plane
        value's two f32 adds, one float -> int conversion, and 6 integer
        operations: the clamp, the key and the maximum.
    Columns outside the span, rows outside [lo, hi) and pad slots need
    nothing. The scanline bounds are computed here as the kernel computes
    them (float32, each product and sum rounded on its own, XLA's
    saturating truncation, read as uint32). The old count, kept beside
    it: 17 operations a column in the span and 11 a row of the tile for
    each such column, 2 a row per slot, all at the f32 rate."""
    from jackal_tpu_torch.matching.elas import device_prior as dp

    CH, SC, _ = sel.shape
    tab = table.cpu().numpy().reshape(CH, Tp, -1)
    sl = sel.cpu().numpy()
    rows = tab[np.arange(CH)[:, None, None], np.clip(sl, 0, Tp - 1)]
    live = (sl >= 0) & (sl < Tp - 1) & (rows[..., 12] >= 0)
    C = -(-W // dp._RASTER_CTILE)
    s, c = np.divmod(np.arange(SC), C)
    # the old count, over every slot of the lists
    c0 = (c * dp._RASTER_CTILE)[None, :, None]
    c1 = np.minimum(c0 + dp._RASTER_CTILE, W)
    nr = np.minimum(dp._RASTER_SLAB, H - s * dp._RASTER_SLAB)[None, :, None]
    ncols = np.clip(np.minimum(rows[..., 2], c1)
                    - np.maximum(rows[..., 0], c0), 0, None)
    old = int((live * (ncols * (17 + 11 * nr) + 2 * nr)).sum())
    # this run's work, over the live slots
    _, tile, _ = np.nonzero(live)
    r = rows[live]                                          # [N, 16]
    v0 = (s[tile] * dp._RASTER_SLAB)[:, None]
    nrow = np.minimum(dp._RASTER_SLAB, H - v0)
    u = (c[tile] * dp._RASTER_CTILE)[:, None] + np.arange(dp._RASTER_CTILE)
    span = (u >= r[:, 0:1]) & (u < r[:, 2:3]) & (u < W)
    f32 = np.float32
    sl_f = np.ascontiguousarray(r[:, 5:8]).view(f32)
    A_u, B_u = r[:, 0:1].astype(f32), r[:, 1:2].astype(f32)
    A_v, B_v = r[:, 3:4].astype(f32), r[:, 4:5].astype(f32)
    u_f = u.astype(f32)

    def line(k, b):
        x = (sl_f[:, k:k + 1] * u_f + b).astype(np.float64)
        i = np.where(np.isnan(x), 0, np.clip(np.trunc(np.nan_to_num(x)),
                                             -2.0 ** 31, 2.0 ** 31 - 1))
        return i.astype(np.int64) & 0xFFFFFFFF
    with np.errstate(all="ignore"):
        v1 = line(0, A_v - sl_f[:, 0:1] * A_u)
        v2 = np.where(u < r[:, 1:2], line(1, A_v - sl_f[:, 1:2] * A_u),
                      line(2, B_v - sl_f[:, 2:3] * B_u))
    lo = np.minimum(np.minimum(v1, v2), H)
    hi = np.minimum(np.maximum(v1, v2), H)
    covered = np.clip(np.minimum(hi, v0 + nrow) - np.maximum(lo, v0), 0,
                      None)
    n_slots, n_cols = len(r), int(span.sum())
    n_pix = int((covered * span).sum())
    ops = {"f32": 6 * n_slots + int(nrow.sum()) + 5 * n_cols + 2 * n_pix,
           "int": 10 * n_cols + 6 * n_pix,
           "cvt": 4 * n_slots + 3 * n_cols + n_pix}
    nbytes = 4 * (table.numel() + sel.numel() + CH * H * W)
    return nbytes, ops, old, n_slots


def raster_bound_ms(nbytes, ops, dev):
    """(ms, by, the time of each type) of the raster's least time: the
    larger of its bytes over the HBM rate and its operations, each type
    at its rate on compute capability 9.0 (CUDA C++ Programming Guide,
    arithmetic instruction throughput): f32 multiply and add 128 a clock
    an SM, 32-bit integer 64 (int_ops_rate), conversions 16, at the
    maximum SM clock. The types run on separate units, so the slowest of
    them bounds the operations."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hz = max_sm_hz()
    rates = {"f32": sms * 128 * hz, "int": int_ops_rate(dev),
             "cvt": sms * 16 * hz}
    times = {k: ops[k] / rates[k] * 1e3 for k in ops}
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    by = max(times, key=times.get)
    if tb >= times[by]:
        return tb, "bytes", times
    return times[by], "operations", times


def batch_chunks(params, lb, rb, chunk, dev):
    """The batched path's host side, as elas_match_batch_device runs it, for
    uint8 [B, H, W] pairs: per chunk (flat wire on the host, Np, Tp, Ts,
    per frame (support, left and right triangulations, wire)). Frames keep
    their order (the kernels do not depend on it)."""
    import torch
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.matching.elas.native_prior import (
        collect_support_points_native)
    from jackal_tpu_torch.matching.elas.prior import delaunay

    B, H, W = lb.shape
    _, _, dcan = ep._front(torch.from_numpy(lb).to(dev),
                           torch.from_numpy(rb).to(dev), params)
    dcan = dcan.cpu().numpy()
    out = []
    for c0 in range(0, B, chunk):
        frames = []
        for b in range(c0, c0 + chunk):
            sp = collect_support_points_native(dcan[b], params, W, H)
            rp = np.stack([sp[:, 0] - sp[:, 2], sp[:, 1]], -1)
            frames.append((sp, delaunay(sp[:, :2].astype(np.float32)),
                           delaunay(rp.astype(np.float32)),
                           ep._prior_tri_job(dcan[b], params, W, H)))
        wires = [f[3] for f in frames]
        Np, Tp, Ts = ep._chunk_pads(wires)
        out.append((torch.from_numpy(ep._flatten_chunk_wire(wires, Np, Tp,
                                                            Ts)),
                    Np, Tp, Ts, frames))
    return out


def raster_overflow_case(rng, CH, T, W, H, Ts):
    """Random triangles, and three top-painted ones whose planes leave the
    int32 range (pa = pc = +1e17, -1e17, NaN), each listed first in every
    third tile (tests/test_torch_cuda.py runs it too)."""
    import torch
    from jackal_tpu_torch.matching.elas import device_prior as dp

    u = np.sort(rng.integers(-20, W + 20, (CH, T, 3)), -1)
    v = rng.integers(-10, H + 10, (CH, T, 3))
    tab = np.zeros((CH, T, 16), np.int32)
    tab[..., 0:3], tab[..., 3:5] = u, v[..., :2]
    tab[..., 5:8] = rng.uniform(-3, 3, (CH, T, 3)).astype(
        np.float32).view(np.int32)
    tab[..., 8:11] = np.stack([rng.uniform(-0.6, 0.6, (CH, T)),
                               rng.uniform(-0.3, 0.3, (CH, T)),
                               rng.uniform(-50, 300, (CH, T))],
                              -1).astype(np.float32).view(np.int32)
    tab[..., 11] = rng.random((CH, T)) < 0.7
    tab[..., 12] = np.arange(T)
    big = np.array([1e17, -1e17, np.nan], np.float32).view(np.int32)
    tab[:, 0:3, 0:3] = [[0, W // 2, W]]
    tab[:, 0:3, 3:5] = [[0, -1]]
    tab[:, 0:3, 5:8] = np.array([0.0, -1.0, 0.0], np.float32).view(np.int32)
    tab[:, 0:3, 8] = tab[:, 0:3, 10] = big
    tab[:, 0:3, 9] = 0
    tab[:, 0:3, 12] = T + 1
    tab[:, -1] = 0
    tab[:, -1, 12] = -1
    SC = -(-H // dp._RASTER_SLAB) * -(-W // dp._RASTER_CTILE)
    sel = rng.integers(3, T - 1, (CH, SC, Ts))
    sel[rng.random(sel.shape) < 0.3] = T - 1
    sel[:, :, 0] = np.arange(SC) % 3
    return (torch.from_numpy(tab.reshape(CH * T, 16)),
            torch.from_numpy(sel.astype(np.int32)))


# the WTA kernel's edges (tests/test_torch_cuda.py runs them too)
WTA_EDGE_CASES = ("constant, D = 2", "constant, D = 3", "constant, D = 64",
                  "ties, D = 2", "ties, D = 64", "one column, D = 24",
                  "D = 256, W = 1280", "B = 4, 1280x960")


def wta_edge_volume(name, dev):
    """An int16 [B, H, D, W] path sum for one of WTA_EDGE_CASES, made on
    dev from a seed: a constant 15000 (every d ties: best_d 0, the second
    best the value, and the right view's 12000 wins at the border); values
    of {0, 9000, 18000} (ties everywhere); a single column, where the
    right view reads 12000 for every d > 0; D = 256 (the kernel's dynamic
    shared memory); BASELINE config 3's batch. Values lie in [0, 28000],
    the path sum's range, a tenth of them 28000 where drawn at random."""
    import torch

    i = WTA_EDGE_CASES.index(name)
    B, H, D, W = ((1, 5, 2, 37), (2, 4, 3, 130), (1, 3, 64, 200),
                  (1, 6, 2, 77), (1, 8, 64, 129), (1, 7, 24, 1),
                  (1, 4, 256, 1280), (4, 960, 64, 1280))[i]
    g = torch.Generator(dev).manual_seed(50 + i)
    if name.startswith("constant"):
        return torch.full((B, H, D, W), 15000, dtype=torch.int16, device=dev)
    if name.startswith("ties"):
        return (torch.randint(0, 3, (B, H, D, W), generator=g, device=dev)
                * 9000).to(torch.int16)
    S = torch.randint(0, 28001, (B, H, D, W), generator=g, device=dev)
    S[torch.rand((B, H, D, W), generator=g, device=dev) < 0.1] = 28000
    return S.to(torch.int16)


# the support kernel's edges (tests/test_torch_cuda.py runs them too)
SUPPORT_EDGE_CASES = ("node, 640x480, D = 256", "B = 8 at 640x480",
                      "D = 512 at W = 2112", "D = 512 at W = 4096",
                      "W < D: W = 200, D = 256",
                      "disp_min near D: 250 of 256",
                      "odd W = 333, disp_min 4, B = 2",
                      "constant descriptors, 640 wide")


def support_edge_case(name, dev):
    """(Q, T, disp_min, D) of one of SUPPORT_EDGE_CASES on dev, from a
    seed: the grid-row blocks of a random frame and of the same frame
    shifted by 9 columns (a true disparity of 9) at the node's shape, the
    batched node's B = 8, wide frames at D = 512 (at W = 4096 the kernel's
    shared table holds fewer d a chunk), W < D (the right view's top d are
    dead), disp_min near D, an odd width; and constant descriptors, where
    every cost ties."""
    import torch
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import support as sm
    from jackal_tpu_torch.ops.descriptor import create_descriptor

    i = SUPPORT_EDGE_CASES.index(name)
    B, H, W, disp_min, D = ((1, 480, 640, 0, 256), (8, 480, 640, 0, 256),
                            (1, 40, 2112, 0, 512), (1, 30, 4096, 0, 512),
                            (1, 60, 200, 0, 256), (1, 60, 640, 250, 256),
                            (2, 60, 333, 4, 131), (1, 480, 640, 0, 256))[i]
    step = sm.effective_stepsize(ElasParams())
    ncv = -(-H // step)
    if name.startswith("constant"):
        Q = torch.full((B, ncv - 1, W, 32), 7, dtype=torch.uint8, device=dev)
        return Q, Q.clone(), disp_min, D
    rng = np.random.default_rng(60 + i)
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    d1 = create_descriptor(torch.from_numpy(left).to(dev))
    d2 = create_descriptor(torch.from_numpy(np.roll(left, -9, 2)).to(dev))
    return (sm.grid_row_blocks(d1, step, ncv),
            sm.grid_row_blocks(d2, step, ncv), disp_min, D)


# the raster's edges (tests/test_torch_cuda.py runs them too)
RASTER_EDGE_CASES = ("Ts 300, three rounds of slots",
                     "a triangle over the whole image",
                     "tiles of pad slots only", "8 frames at 640x480")


def raster_edge_case(name):
    """(table, sel, Tp, W, H) of one of RASTER_EDGE_CASES, seeded, on the
    pattern of raster_overflow_case: a tile list longer than two rounds of
    the kernel's 128 slots; a triangle that covers every pixel of every
    tile, painted in the middle of the others; tiles whose slots are all
    the pad row or a row painted -1; 8 frames of the node's size."""
    import torch

    rng = np.random.default_rng(40 + RASTER_EDGE_CASES.index(name))
    CH, T, W, H, Ts = {0: (2, 400, 333, 70, 300),
                       3: (8, 300, 640, 480, 48)}.get(
        RASTER_EDGE_CASES.index(name), (2, 60, 300, 50, 20))
    tab, sel = (x.numpy() for x in raster_overflow_case(rng, CH, T, W, H,
                                                        Ts))
    tab = tab.reshape(CH, T, 16)
    if name == RASTER_EDGE_CASES[1]:
        # AC along v = 0, BC along v = H + 50 (B_u = A_u: no AB segment)
        tab[:, 3, 0:5] = [0, 0, W, 0, H + 50]
        tab[:, 3, 5:8] = 0
        tab[:, 3, 8:11] = np.array([0.25, -0.5, 40.0],
                                   np.float32).view(np.int32)
        tab[:, 3, 11:13] = [1, T // 2]
        sel[:, :, 1] = 3
    elif name == RASTER_EDGE_CASES[2]:
        tab[:, 4, 12] = -1
        sel[:, ::2, :] = T - 1
        sel[:, 1::4, :] = 4
    return (torch.from_numpy(tab.reshape(CH * T, 16)),
            torch.from_numpy(sel), T, W, H)


def bound_ms(nbytes, ops, ops_per_s):
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def sgm_work(kernel, B, H, W, D, num_paths=8):
    """(bytes, 32-bit integer instructions) the SGM kernel ``kernel`` must
    do on [B, H, W] frames at D disparities. census (2B images): one byte
    read and an int32 code written a pixel; the least count of its
    byte-lane packing, 26 instructions a pixel: 24 compares, each 4
    instructions for 4 pixels (a subtract, a LOP3, a shift and a LOP3 into
    the code byte), and 2 byte permutes of the codes' transpose
    (csrc/census_kernel.cu; before, 24 compares and 24 bit inserts,
    CENSUS_OPS_UNPACKED).
    sgm_paths: the int16 cost read and the int16 sum written once a cell;
    per cell, d and path at least 3.25 instructions: the carry's minimum
    (a three-way min of 16-bit pairs, 0.25), the neighbours + P1 against
    the carry (two min(a + b, c) of pairs, 1), the minimum with m + P2,
    best - m, C + best - m against BIG and the add into the sum (a pair
    each, 2) (csrc/sgm_paths_kernel.cu; before the kernel packed 16-bit
    pairs the count was 11 operations, SGM_PATHS_OPS_32). sgm_wta: the sum
    read once, ten int16 maps written; a compare and a select a value in
    each of two walks over d, both views."""
    px = B * H * W
    if kernel == "census":
        return 2 * px * (1 + 4), 2 * px * 26
    if kernel == "sgm_paths":
        return 4 * px * D, 3.25 * num_paths * px * D
    return 2 * px * D + 20 * px, 8 * px * D


# the path kernel's operations a cell, d and path as counted one a 32-bit
# instruction, before its 16-bit pairs, kept beside the restated count
SGM_PATHS_OPS_32 = 11
# the census's instructions a pixel as counted before its byte lanes (a
# compare and a bit insert a neighbour), kept beside the restated count
CENSUS_OPS_UNPACKED = 48


def sgm_phase(dev, hold):
    """Phase 6: kernels D, E, F against their plain versions, the card's
    SGM against the CPU's on the golden scenes, the SGM node, BASELINE
    config 3 and the kernels' times. Returns the kernels' JSON entries."""

    import torch
    from jackal_tpu_torch.config import PipelineParams, SGMParams
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.matching import sgm
    from jackal_tpu_torch.ops import sgm_kernel as sk
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.runner import (TOPIC_DEPTH,
                                                  StreamingRunner)
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    gold = [np.load(f"{FIX}/{f}.npz") for f in GOLDEN]
    gl = torch.from_numpy(np.stack([g["left"] for g in gold])).to(dev)
    gr = torch.from_numpy(np.stack([g["right"] for g in gold])).to(dev)

    # (a) D, E, F == their plain versions on the card, bit for bit
    def hold_sgm(name, left, right, p):
        B = left.shape[0]
        imgs = torch.cat([left, right])
        codes = sk.census5x5_batch(imgs)
        hold("census", f"census {name}", [codes],
             [sk.census5x5_batch_plain(imgs)])
        cost = sgm.census_cost_volume_hdw(codes[:B], codes[B:], p.disp_num)
        costs = [cost] + ([sgm.shift_by_d(cost, -2)] if p.true_right else [])
        for c in costs:
            S = sk.aggregate_paths_bhdw(c, p)
            hold("sgm_paths", f"paths {name}", [S],
                 [sk.aggregate_paths_bhdw_plain(c, p)])
            hold("sgm_wta", f"wta {name}", [sk.sgm_wta_maps(S)],
                 [sk.sgm_wta_maps_plain(S)])

    hold_sgm("golden 640x480 D=64", gl, gr, SGMParams())
    hold_sgm("golden 640x480 D=128", gl, gr, SGMParams(disp_num=128))
    rng = np.random.default_rng(6)
    for B, H, W, D, kw in ((2, 23, 150, 24, {}), (1, 41, 333, 48, {}),
                           (1, 97, 200, 48, {"num_paths": 4}),
                           (2, 31, 130, 24, {"true_right": True}),
                           # E's 32-bit path, and its 16-bit lanes' limit
                           (1, 29, 90, 24, {"p1": 6000, "p2": 100000}),
                           (2, 40, 77, 64, {"p1": 4767, "p2": 4767}),
                           # lines shorter than E's ring; H, W < 32; D > W
                           (1, 3, 5, 24, {}), (2, 7, 31, 64, {}),
                           (1, 40, 6, 100, {}), (1, 33, 97, 192, {})):
        left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
        right = np.roll(left, 6, axis=2)
        p = dataclasses.replace(SGMParams(disp_num=D), **kw)
        hold_sgm(f"seeded B={B} {H}x{W} D={D} {kw}",
                 torch.from_numpy(left).to(dev),
                 torch.from_numpy(right).to(dev), p)
    for name in WTA_EDGE_CASES:
        S = wta_edge_volume(name, dev)
        hold("sgm_wta", f"wta {name}", [sk.sgm_wta_maps(S)],
             [sk.sgm_wta_maps_plain(S)])
    del S
    torch.cuda.synchronize()
    print(f"6a. WTA maps kernel == plain (torch.equal) on "
          f"{', '.join(WTA_EDGE_CASES)}")
    print("6a. SGM kernels == plain (torch.equal): census, paths, WTA maps "
          "on the golden pair at 640x480 D=64 and 128 and on seeded frames "
          "(odd H, W % 32 != 0, D 24, 48, 64, 100 and 192, 4 paths, "
          "true_right, penalties past the 16-bit lanes and at their limit, "
          "lines shorter than the ring, H and W under 32, D > W)")

    # (b) the card's sgm_match_batch == the CPU's plain path; accuracy
    for D in (64, 128):
        p = SGMParams(disp_num=D)
        card = sgm.sgm_match_batch(gl, gr, p, device=dev)
        cpu = sgm.sgm_match_batch(gl.cpu(), gr.cpu(), p, device="cpu")
        for nm, a, b in zip(("D_left", "D_right"), card, cpu):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"SGM D={D} {nm}: card != CPU in "
                                     f"{int((a.cpu() != b).sum())} pixels")
        se, n, agree, tot = 0.0, 0, 0.0, 0
        for b, g in enumerate(gold):
            Dl, ref = card[0][b].cpu().numpy(), g["D1"]
            both = (Dl >= 0) & (ref >= 0)
            se += float(((Dl[both] - ref[both]) ** 2).sum())
            n += int(both.sum())
            agree += float(((Dl >= 0) == (ref >= 0)).sum())
            tot += ref.size
        print(f"6b. sgm_match_batch on the card == the CPU's plain path "
              f"(D_left, D_right) on {', '.join(GOLDEN)} at D={D}; against "
              f"libelas D1, pooled: RMSE {np.sqrt(se / max(n, 1)):.6f} px, "
              f"mask agreement {agree / tot:.6f}")

    # (c) the SGM node: make_pipeline() at 640x480, D = 64
    pipe = make_pipeline(params=PipelineParams(
        im_width=640, im_height=480, crop_im_width=640, crop_im_height=480),
        device=dev)
    pairs = [synthetic_raw_pair(pipe, s, 8.0 + 5 * s, 0.03 * (s % 3))
             for s in range(9)]
    def counted(label, fn):
        """fn() with the counters of D, E and F set to 0 just before and
        read just after: (its result, the counts); raises if a kernel was
        launched no time."""
        for k in sk.launches:
            sk.launches[k] = 0
        out = fn()
        n = dict(sk.launches)
        print(f"6c. launches of {label}: {n}")
        if min(n.values()) == 0:
            raise AssertionError(f"{label} bypassed a kernel: {n}")
        return out, n

    pipe.process_frame(*pairs[0])                       # warm-up
    results, walls = [], []

    def frames():
        for lr, rr in pairs:
            t = time.perf_counter()
            results.append(pipe.process_frame(lr, rr, timing=True))
            walls.append(time.perf_counter() - t)
    _, launches = counted(f"the SGM node, process_frame over {len(pairs)} "
                          f"frames", frames)
    for fr in results:
        sc = fr.scan.scan
        if fr.dmap.shape != (480, 640) or fr.dmap.dtype != np.uint8 \
                or sc.shape != (90,) or not bool(torch.isfinite(sc).all()):
            raise AssertionError("SGM node output has the wrong shape/type")
    valid = float(np.mean([(fr.dmap > 0).mean() for fr in results]))
    filled = float(np.mean([(fr.scan.scan < 1e9 - 1).sum().item()
                            for fr in results]))
    if valid < 0.3 or filled < 10:
        raise AssertionError(f"SGM node output implausible: {valid} valid,"
                             f" {filled} bins filled")
    med = {k: statistics.median(getattr(fr, k) for fr in results) * 1e3
           for k in ("rect_time", "dmap_time", "scan_time")}
    wall = statistics.median(walls) * 1e3
    print(f"SGM node 640x480 D=64 (median of {len(pairs)} frames after 1 "
          f"warm-up): rectify {med['rect_time']:.3f} ms, dmap "
          f"{med['dmap_time']:.3f} ms, scan {med['scan_time']:.3f} ms, frame "
          f"{wall:.3f} ms = {1e3 / wall:.2f} fps; dmap valid {valid:.3f}, "
          f"scan bins filled {filled:.1f}")
    wall_p, busy, *_ = device_busy(
        lambda: [pipe.process_frame(lr, rr) for lr, rr in pairs[:3]])
    print(f"SGM node device busy over 3 frames under torch.profiler: "
          f"{busy:.3f} ms of {wall_p:.3f} ms wall, idle share "
          f"{1 - busy / wall_p:.3f}")
    lb = np.stack([p[0] for p in pairs[:4]])
    rb = np.stack([p[1] for p in pairs[:4]])
    (dm4, sc4), _ = counted("process_batch_fused at batch 4",
                            lambda: pipe.process_batch_fused(lb, rb))
    for b in range(4):
        if not (np.array_equal(dm4[b].cpu().numpy(), results[b].dmap)
                and torch.equal(sc4.scan[b], results[b].scan.scan)):
            raise AssertionError(f"process_batch_fused frame {b} != "
                                 f"process_frame")
    print("process_batch_fused at batch 4 == process_frame, frame by frame")
    n_frames, batch = 48, 4
    stream = [pairs[i % len(pairs)] for i in range(n_frames)]
    bus = TopicBus()
    depth = []
    bus.subscribe(TOPIC_DEPTH, depth.append)
    runner = StreamingRunner(pipe, bus, batch_size=batch,
                             stage_sample_every=4)
    runner.run(iter(stream[:2 * batch]))                # warm-up
    depth.clear()

    def timed_stream():
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = runner.run(iter(stream))
        torch.cuda.synchronize()
        return n, time.perf_counter() - t
    (done, stream_s), _ = counted(f"StreamingRunner at batch {batch} over "
                                  f"{n_frames} frames", timed_stream)
    if done != n_frames or len(depth) != n_frames or not all(
            np.array_equal(m.data, results[i % len(pairs)].dmap)
            for i, m in enumerate(depth)):
        raise AssertionError("SGM StreamingRunner did not publish "
                             "process_frame's maps")
    wall_s, busy_s, *_ = device_busy(lambda: runner.run(iter(stream)),
                                    host_ops=False)
    print(f"SGM StreamingRunner batch {batch}, 640x480: {done} frames in "
          f"{stream_s * 1e3:.3f} ms = {done / stream_s:.2f} fps, each "
          f"depth map == process_frame's; card alone under torch.profiler: "
          f"busy {busy_s:.3f} ms of {wall_s:.3f} ms wall, idle share "
          f"{1 - busy_s / wall_s:.3f}")

    # the SGM stages of one frame, each alone
    p = pipe.sgm_params
    D = p.disp_num
    lt, rt = pipe._rectify_crop(torch.from_numpy(lb[:1]).to(dev),
                                torch.from_numpy(rb[:1]).to(dev))
    st = {}
    imgs = torch.cat([lt, rt])
    st["rectify"] = host_ms(lambda: pipe._rectify_crop(
        torch.from_numpy(lb[:1]).to(dev), torch.from_numpy(rb[:1]).to(dev)),
        5)
    st["census (kernel D)"] = host_ms(lambda: sk.census5x5_batch(imgs), 5)
    codes = sk.census5x5_batch(imgs)
    st["cost volume (plain torch)"] = host_ms(
        lambda: sgm.census_cost_volume_hdw(codes[:1], codes[1:], D), 5)
    cost = sgm.census_cost_volume_hdw(codes[:1], codes[1:], D)
    st["aggregation (kernel E)"] = host_ms(
        lambda: sk.aggregate_paths_bhdw(cost, p), 5)
    S = sk.aggregate_paths_bhdw(cost, p)
    st["WTA maps (kernel F)"] = host_ms(lambda: sk.sgm_wta_maps(S), 5)
    m = sk.sgm_wta_maps(S).to(torch.int32)

    def epilogue():
        dL = sgm._wta_from_maps(*m[:, :, 0:5].unbind(2), D, p)
        dR = sgm._wta_from_maps(*m[:, :, 5:10].unbind(2), D, p)
        return pipe._dmap_u8(sgm._lr_tail(dL, dR, D, p)[0])
    st["epilogue (uniqueness, sub-pixel, L/R, u8)"] = host_ms(epilogue, 5)
    dm = epilogue()
    st["scan"] = host_ms(lambda: pipe._scan_stage(dm), 5)
    for k, v in st.items():
        print(f"  SGM stage {k}: {v:.3f} ms")
    print("SGM stages: " + json.dumps({k: round(v, 4) for k, v in st.items()}))

    # (d) BASELINE config 3: process_batch_fused at 1280x960, D = 64, B = 4
    B3, H3, W3 = CONFIG3
    big = make_pipeline(params=PipelineParams(
        calib_im_size=(640, 360), im_width=W3, im_height=H3,
        crop_im_width=W3, crop_im_height=H3), device=dev)
    rng3 = np.random.default_rng(0)
    l3, r3 = ((torch.from_numpy((rng3.random(CONFIG3) * 255)
                                .astype(np.uint8)).to(dev)) for _ in range(2))
    counted(f"BASELINE config 3, process_batch_fused at {W3}x{H3}, B={B3}",
            lambda: big.process_batch_fused(l3, r3))
    ms3 = host_ms(lambda: big.process_batch_fused(l3, r3), 5)
    torch.cuda.reset_peak_memory_stats(dev)
    big.process_batch_fused(l3, r3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"6d. BASELINE config 3 (process_batch_fused {W3}x{H3}, D={D}, "
          f"B={B3}): {ms3:.3f} ms a batch = {B3 * 1e3 / ms3:.2f} fps; peak "
          f"device memory {peak:.2f} GiB")

    # (e) each kernel against its plain version, its device time, the plain
    # version's and its bound, at the node's shape and at config 3's
    ops_rate = int_ops_rate(dev)
    print(f"32-bit integer operations: {ops_rate:.6g} /s (64 a clock an SM "
          f"at the maximum SM clock)")
    out = {}
    for label, (Bs, Hs, Ws) in (("node", (1, 480, 640)),
                                ("config 3", CONFIG3)):
        if label == "node":
            li, ri = lt, rt
        else:
            li, ri = big._rectify_crop(l3, r3)
        im = torch.cat([li, ri])
        cd = sk.census5x5_batch(im)
        cv = sgm.census_cost_volume_hdw(cd[:Bs], cd[Bs:], D)
        Sv = sk.aggregate_paths_bhdw(cv, p)
        # E's device memory a call: its layout copy, one int16 path volume a
        # direction and S, above what was allocated before the call
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sk.aggregate_paths_bhdw(cv, p)
        torch.cuda.synchronize()
        print(f"6e. E's device memory a call at {label} shape: "
              f"{(torch.cuda.max_memory_allocated(dev) - before) / 2 ** 30:.3f}"
              f" GiB (its cost volume in: "
              f"{cv.numel() * cv.element_size() / 2 ** 30:.3f} GiB)")
        reps_plain = 3 if label == "node" else 1
        for kname, fn, plain, kern in (
                ("census", lambda: sk.census5x5_batch(im),
                 lambda: sk.census5x5_batch_plain(im), "census5x5_kernel"),
                ("sgm_paths", lambda: sk.aggregate_paths_bhdw(cv, p),
                 lambda: sk.aggregate_paths_bhdw_plain(cv, p), "sgm_"),
                ("sgm_wta", lambda: sk.sgm_wta_maps(Sv),
                 lambda: sk.sgm_wta_maps_plain(Sv), "sgm_wta_maps_kernel")):
            hold(kname, f"{kname} at {label} shape", [fn()], [plain()])
            # E is three kernels a call: the cost's layout, the path lines
            # and their sum
            per_call = 3 if kname == "sgm_paths" else 1
            k_ms = events_ms(fn, 20)
            l_ms, seen = launch_ms(fn, 20, kern)
            p_ms = events_ms(plain, reps_plain, spin=False)
            nb, ops = sgm_work(kname, Bs, Hs, Ws, D)
            b_ms, by = bound_ms(nb, ops, ops_rate)
            old = ""
            if kname == "sgm_paths":
                ob, oby = bound_ms(nb, SGM_PATHS_OPS_32 * 8 * Bs * Hs * Ws * D,
                                   ops_rate)
                old = (f"; the bound counted one operation an instruction "
                       f"(unpacked) {ob:.5f} by {oby}")
            if kname == "census":
                ob, oby = bound_ms(nb, CENSUS_OPS_UNPACKED * 2 * Bs * Hs * Ws,
                                   ops_rate)
                old = (f"; the bound counted a compare and a bit insert a "
                       f"neighbour (unpacked) {ob:.5f} by {oby}")
            print(f"6e. {kname} at {label} shape (B={Bs}, {Hs}x{Ws}, D={D}):"
                  f" == plain (torch.equal); device ms a call {k_ms:.4f} "
                  f"(CUDA events, calls queued behind a spin); its "
                  f"{per_call} kernel launches {l_ms * per_call:.4f} (mean "
                  f"of the {seen} of {20 * per_call} launches torch.profiler"
                  f" recorded); plain {p_ms:.3f}; bound {b_ms:.5f} by {by} "
                  f"({nb} bytes, {ops:.6g} instructions){old}")
            if k_ms < b_ms:
                raise AssertionError(f"{kname} at {label}: {k_ms} ms is "
                                     f"below its bound {b_ms} ms")
            if label == "node":
                out[kname] = (k_ms, p_ms, b_ms, by)
    srcs = {"census": ("census_kernel", 327), "sgm_paths":
            ("sgm_paths_kernel", 64), "sgm_wta": ("sgm_wta_kernel", 415)}
    return [{"name": k, "route": "cuda",
             "source": f"jackal_tpu_torch/csrc/{srcs[k][0]}.cu",
             "replaces": f"jackal_tpu/ops/pallas/sgm_kernel.py:{srcs[k][1]}",
             "launches": launches[k], "ms": out[k][0], "plain_ms": out[k][1],
             "bound_ms": out[k][2], "bound_by": out[k][3],
             "library_ms": None} for k in ("census", "sgm_paths", "sgm_wta")]


def bm_work(B, H, W, D):
    """(bytes, 32-bit integer instructions) kernel G must do on [B, H, W]
    pairs at D disparities: the two u8 images read and the two f32 maps
    written once (10 bytes a pixel); per (pixel, d) 5.75 instructions, the
    least that any design computing G's function needs when it packs what
    it can: the cost's two running box sums (the absolute difference, four
    a __vabsdiffu4; the vertical add and subtract and the horizontal add
    and subtract, two 16-bit lanes an instruction: 1.75) and, in each view,
    two minima a d, at least an instruction each: one for the best (cost,
    d) and one for the least cost outside best_d +- 1 (2 a view, as a
    design that walks the d twice needs). Not counted: the invalid-d selects (a loop can skip those
    d), the costs at best_d -+ 1 (read once a pixel) and whatever a
    one-pass design adds to keep the second best. Before the kernel's
    redesign the count was 12, one operation an instruction (BM_OPS_32)."""
    px = B * H * W
    return 10 * px, 5.75 * px * D


BM_OPS_32 = 12


def bm_phase(dev, hold):
    """Phase 7: kernel G against its plain twin, the BM node, BASELINE
    config 5 (BM + gen_pcl) and bench_bm256's configuration, BM's accuracy
    against libelas, G's times and G''s parts. Returns G's JSON entry."""
    import torch
    from jackal_tpu_torch.config import BMParams, PipelineParams
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.matching import bm
    from jackal_tpu_torch.ops import bm_kernel as bk
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.runner import (TOPIC_DEPTH, TOPIC_PCL,
                                                  StreamingRunner)
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    gold = [np.load(f"{FIX}/{f}.npz") for f in GOLDEN]
    gl = torch.from_numpy(np.stack([g["left"] for g in gold])).to(dev)
    gr = torch.from_numpy(np.stack([g["right"] for g in gold])).to(dev)

    # (a) G == its plain twin on the card, bit for bit
    def hold_bm(name, left, right, p):
        hold("bm", f"bm {name}", bk.bm_match_fused(left, right, p),
             bk.bm_match_fused_plain(left, right, p))

    for D in (64, 256):
        hold_bm(f"golden 640x480 D={D}", gl, gr, BMParams(disp_num=D))
    rng = np.random.default_rng(7)
    for B, H, W, D, win, shift in ((3, 37, 333, 33, 9, 7),
                                   (1, 61, 150, 64, 5, 20),
                                   (2, 23, 1280, 128, 7, 45),
                                   (1, 9, 2000, 16, 3, 3),
                                   (1, 30, 200, 64, 1, 9),
                                   # D past the 64-column strip, H and W
                                   # under 32, fewer rows than the window
                                   (2, 17, 150, 100, 7, 30),
                                   (1, 5, 20, 16, 5, 2),
                                   (1, 3, 64, 8, 7, 1),
                                   # batches that take the 64-column strip
                                   (32, 161, 333, 101, 21, 17),
                                   (32, 330, 333, 33, 1, 3)):
        left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
        p = BMParams(disp_num=D, window=win)
        sw = bk.strip_width((B, H, W), p)
        if B == 32 and sw != 64:
            raise AssertionError(f"G took a {sw}-column strip at B={B} "
                                 f"{H}x{W} D={D}, not 64")
        hold_bm(f"seeded B={B} {H}x{W} D={D} window {win} ({sw}-column "
                f"strip)", torch.from_numpy(left).to(dev),
                torch.from_numpy(np.roll(left, -shift, axis=2)).to(dev), p)
    torch.cuda.synchronize()
    print("7a. kernel G == plain (torch.equal, both views) on the golden "
          "pair at 640x480 D=64 and 256 and on seeded frames (B=3, odd H "
          "and D, W % 64 != 0, W=1280 and 2000, windows 1, 3, 5, 7, 9 and "
          "21, D past the strip, H and W under 32, fewer rows than the "
          "window; B=32 at H % 64 != 0, W % 64 != 0, odd D, in the "
          "64-column strip)")

    def counted(label, fn, want):
        """(fn(), G's launches in it): the counter set to 0 just before and
        read just after; raises unless G was launched ``want`` times."""
        bk.launches["bm"] = 0
        out = fn()
        n = bk.launches["bm"]
        print(f"7. launches of G in {label}: {n}")
        if n != want:
            raise AssertionError(f"{label}: G launched {n} times, not {want}")
        return out, n

    # (b) the BM node at 640x480, D = 64
    size = dict(im_width=640, im_height=480, crop_im_width=640,
                crop_im_height=480)
    pipe = make_pipeline(engine="bm", bm_params=BMParams(disp_num=64),
                         params=PipelineParams(**size), device=dev)
    pairs = [synthetic_raw_pair(pipe, s, 8.0 + 5 * s, 0.03 * (s % 3))
             for s in range(9)]
    pipe.process_frame(*pairs[0])                       # warm-up
    results, walls = [], []

    def frames():
        for lr, rr in pairs:
            t = time.perf_counter()
            results.append(pipe.process_frame(lr, rr, timing=True))
            walls.append(time.perf_counter() - t)
    _, node_launches = counted(
        f"the BM node, process_frame over {len(pairs)} frames", frames,
        len(pairs))
    for fr in results:
        sc = fr.scan.scan
        if fr.dmap.shape != (480, 640) or fr.dmap.dtype != np.uint8 \
                or sc.shape != (90,) or not bool(torch.isfinite(sc).all()):
            raise AssertionError("BM node output has the wrong shape/type")
    valid = float(np.mean([(fr.dmap > 0).mean() for fr in results]))
    filled = float(np.mean([(fr.scan.scan < 1e9 - 1).sum().item()
                            for fr in results]))
    if valid < 0.3 or filled < 10:
        raise AssertionError(f"BM node output implausible: {valid} valid, "
                             f"{filled} bins filled")
    med = {k: statistics.median(getattr(fr, k) for fr in results) * 1e3
           for k in ("rect_time", "dmap_time", "scan_time")}
    wall = statistics.median(walls) * 1e3
    print(f"7b. BM node 640x480 D=64 (median of {len(pairs)} frames after 1 "
          f"warm-up): rectify {med['rect_time']:.3f} ms, dmap "
          f"{med['dmap_time']:.3f} ms, scan {med['scan_time']:.3f} ms, frame "
          f"{wall:.3f} ms = {1e3 / wall:.2f} fps; dmap valid {valid:.3f}, "
          f"scan bins filled {filled:.1f}")
    wall_p, busy, *_ = device_busy(
        lambda: [pipe.process_frame(lr, rr) for lr, rr in pairs[:3]])
    print(f"BM node device busy over 3 frames under torch.profiler: "
          f"{busy:.3f} ms of {wall_p:.3f} ms wall, idle share "
          f"{1 - busy / wall_p:.3f}")
    batch = 8
    lb = np.stack([pairs[i % len(pairs)][0] for i in range(batch)])
    rb = np.stack([pairs[i % len(pairs)][1] for i in range(batch)])
    (dm8, sc8), _ = counted(f"process_batch_fused at batch {batch}",
                            lambda: pipe.process_batch_fused(lb, rb), 1)
    for b in range(batch):
        fr = results[b % len(pairs)]
        if not (np.array_equal(dm8[b].cpu().numpy(), fr.dmap)
                and torch.equal(sc8.scan[b], fr.scan.scan)):
            raise AssertionError(f"BM process_batch_fused frame {b} != "
                                 f"process_frame")
    print(f"BM process_batch_fused at batch {batch} == process_frame, frame "
          f"by frame")
    n_frames = 48
    stream = [pairs[i % len(pairs)] for i in range(n_frames)]
    bus = TopicBus()
    depth = []
    bus.subscribe(TOPIC_DEPTH, depth.append)
    runner = StreamingRunner(pipe, bus, batch_size=batch,
                             stage_sample_every=3)
    runner.run(iter(stream[:2 * batch]))                # warm-up
    depth.clear()

    def timed_stream():
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = runner.run(iter(stream))
        torch.cuda.synchronize()
        return n, time.perf_counter() - t
    (done, stream_s), _ = counted(f"StreamingRunner at batch {batch} over "
                                  f"{n_frames} frames", timed_stream,
                                  n_frames // batch)
    if done != n_frames or len(depth) != n_frames or not all(
            np.array_equal(m.data, results[i % len(pairs)].dmap)
            for i, m in enumerate(depth)):
        raise AssertionError("BM StreamingRunner did not publish "
                             "process_frame's maps")
    wall_s, busy_s, *_ = device_busy(lambda: runner.run(iter(stream)),
                                    host_ops=False)
    print(f"BM StreamingRunner batch {batch}, 640x480: {done} frames in "
          f"{stream_s * 1e3:.3f} ms = {done / stream_s:.2f} fps, each depth "
          f"map == process_frame's; card alone under torch.profiler: busy "
          f"{busy_s:.3f} ms of {wall_s:.3f} ms wall, idle share "
          f"{1 - busy_s / wall_s:.3f}")

    # (c) BASELINE config 5: process_batch_fused_pcl, B = 32, D = 64, on
    # the golden scenes interleaved as bench.py's _fixture_batch does
    pp5 = PipelineParams(calib_im_size=(640, 360), gen_pcl=True, **size)
    p64 = BMParams(disp_num=64)
    cfg5 = make_pipeline(engine="bm", bm_params=p64, params=pp5, device=dev)
    scene = np.arange(CONFIG5_B) % len(gold)
    l5 = torch.from_numpy(np.stack([gold[s]["left"] for s in scene])).to(dev)
    r5 = torch.from_numpy(np.stack([gold[s]["right"] for s in scene])).to(dev)
    cfg5.process_batch_fused_pcl(l5, r5)                # warm-up
    (dm5, cloud5, sc5), _ = counted(
        f"BASELINE config 5, process_batch_fused_pcl at B={CONFIG5_B}",
        lambda: cfg5.process_batch_fused_pcl(l5, r5), 1)
    if not torch.equal(dm5, cfg5.process_batch_fused(l5, r5)[0]):
        raise AssertionError("config 5 maps != process_batch_fused's")
    if cloud5[0].shape != (CONFIG5_B, 480 * 640, 3) \
            or not bool(torch.isfinite(sc5.scan).all()):
        raise AssertionError("config 5 output has the wrong shape")
    ms5 = host_ms(lambda: cfg5.process_batch_fused_pcl(l5, r5), 5)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg5.process_batch_fused_pcl(l5, r5)
    peak5 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    wall5, busy5, *_ = device_busy(
        lambda: cfg5.process_batch_fused_pcl(l5, r5))
    print(f"7c. BASELINE config 5 (BM D=64 + gen_pcl, process_batch_fused_pcl"
          f" 640x480, B={CONFIG5_B}): {ms5:.3f} ms a batch = "
          f"{CONFIG5_B * 1e3 / ms5:.2f} fps (median of 5); peak device "
          f"memory {peak5:.2f} GiB; device busy {busy5:.3f} ms of "
          f"{wall5:.3f} ms wall, idle share {1 - busy5 / wall5:.3f}; maps "
          f"== process_batch_fused's")
    # one frame with a seeded colour frame: the card's cloud and scan
    # against the CPU's plain path
    cpu5 = make_pipeline(engine="bm", bm_params=p64, params=pp5, device="cpu")
    col = np.random.default_rng(5).integers(0, 256, (1, 480, 640, 3)).astype(
        np.uint8)
    a = cfg5.process_batch_fused_pcl(l5[1:2], r5[1:2], col)
    c = cpu5.process_batch_fused_pcl(l5[1:2].cpu(), r5[1:2].cpu(), col)
    if not (torch.equal(a[0].cpu(), c[0])
            and torch.equal(a[1][1].cpu().view(torch.int32),
                            c[1][1].view(torch.int32))
            and torch.equal(a[1][2].cpu(), c[1][2])):
        raise AssertionError("config 5 frame: card != CPU map/rgb/mask")
    ws, gs = c[2].scan.numpy(), a[2].scan.cpu().numpy()
    filled5 = ws < 1e9 - 1
    if not (np.array_equal(gs < 1e9 - 1, filled5) and np.allclose(
            gs[filled5], ws[filled5], rtol=1e-5, atol=0)):
        raise AssertionError("config 5 frame: card scan != CPU scan")
    v = c[1][2].numpy()[0]
    if not np.array_equal(a[1][0].cpu().numpy()[0][v], c[1][0].numpy()[0][v]):
        raise AssertionError("config 5 frame: card points != CPU points")
    print(f"config 5, the photo frame with a seeded colour frame: card == "
          f"CPU plain path (u8 map, rgb bits, valid mask and the "
          f"{int(v.sum())} valid points exact; scan within relative 1e-5, "
          f"{int(filled5.sum())} bins)")
    # G against its plain twin on config 5's rectified batch
    L5, R5 = cfg5._rectify_crop(l5, r5)
    hold_bm(f"config 5's rectified batch B={CONFIG5_B} D=64", L5, R5, p64)
    torch.cuda.empty_cache()
    print(f"7c. kernel G == plain (torch.equal, both views) on config 5's "
          f"rectified batch (B={CONFIG5_B}, 640x480, D=64)")
    # its stages, each alone
    st = {}
    st["rectify (both images)"] = host_ms(
        lambda: cfg5._rectify_crop(l5, r5), 5)
    st["G (kernel)"] = host_ms(lambda: bk.bm_match_fused(L5, R5, p64), 5)
    dL5 = bk.bm_match_fused(L5, R5, p64)[0]
    st["texture gate + u8"] = host_ms(lambda: cfg5._dmap_u8(
        bm.bm_texture_gate(L5, dL5, p64)), 5)
    st["cloud"] = host_ms(lambda: cfg5._cloud_stage(dm5), 5)
    st["scan from the points"] = host_ms(lambda: cfg5._points_scan(cloud5),
                                         5)
    for k, v_ms in st.items():
        print(f"  config 5 stage {k}: {v_ms:.3f} ms")
    print("config 5 stages: " + json.dumps({k: round(x, 4)
                                            for k, x in st.items()}))
    # the pcl topic of the stream at config 5's shape
    clouds = []
    bus.subscribe(TOPIC_PCL, clouds.append)
    StreamingRunner(cfg5, bus, batch_size=batch).run(
        iter([(gold[i % 2]["left"], gold[i % 2]["right"]) for i in
              range(batch)]))
    if len(clouds) != batch or len(clouds[1].points) != int(
            (dm5[1] >= 2).sum()):
        raise AssertionError("the gen_pcl stream did not publish the clouds")
    print(f"gen_pcl StreamingRunner: {len(clouds)} clouds published, "
          f"{len(clouds[1].points)} points in the photo frame's")

    # (d) bench_bm256's configuration: process_batch_fused, B = 16, D = 256
    p256 = BMParams(disp_num=256)
    big = make_pipeline(engine="bm", bm_params=p256, params=PipelineParams(
        calib_im_size=(640, 360), **size), device=dev)
    l16, r16 = l5[:BM256_B], r5[:BM256_B]
    big.process_batch_fused(l16, r16)                   # warm-up
    counted(f"bench_bm256, process_batch_fused at B={BM256_B}, D=256",
            lambda: big.process_batch_fused(l16, r16), 1)
    ms256 = host_ms(lambda: big.process_batch_fused(l16, r16), 5)
    L16, R16 = big._rectify_crop(l16, r16)
    hold_bm(f"bench_bm256's rectified batch B={BM256_B} D=256", L16, R16,
            p256)
    torch.cuda.empty_cache()
    print(f"7d. bench_bm256 (BM D=256, process_batch_fused 640x480, "
          f"B={BM256_B}): {ms256:.3f} ms a batch = "
          f"{BM256_B * 1e3 / ms256:.2f} fps (median of 5); kernel G == "
          f"plain (torch.equal, both views) on its rectified batch")

    # (e) BM-64 against libelas D1, pooled over both scenes
    dl = bm.bm_texture_gate(gl, bk.bm_match_fused(gl, gr, p64)[0], p64)
    se, n, agree, tot = 0.0, 0, 0.0, 0
    for b, g in enumerate(gold):
        Dl, ref = dl[b].cpu().numpy(), g["D1"]
        both = (Dl >= 0) & (ref >= 0)
        se += float(((Dl[both] - ref[both]) ** 2).sum())
        n += int(both.sum())
        agree += float(((Dl >= 0) == (ref >= 0)).sum())
        tot += ref.size
    print(f"7e. BM D=64 (G + texture gate) against libelas D1 on "
          f"{', '.join(GOLDEN)}, pooled: RMSE {np.sqrt(se / max(n, 1)):.6f} "
          f"px, mask agreement {agree / tot:.6f}")

    # (f) G's device time, its plain twin's and its bound; G''s parts
    ops_rate = int_ops_rate(dev)
    lt, rt = pipe._rectify_crop(torch.from_numpy(lb[:1]).to(dev),
                                torch.from_numpy(rb[:1]).to(dev))
    out = None
    for label, (li, ri), p in (("node", (lt, rt), p64),
                               ("D=256", (L5[:1], R5[:1]), p256)):
        hold("bm", f"bm at the {label} shape", bk.bm_match_fused(li, ri, p),
             bk.bm_match_fused_plain(li, ri, p))
        k_ms = events_ms(lambda: bk.bm_match_fused(li, ri, p), 20)
        p_ms = events_ms(lambda: bk.bm_match_fused_plain(li, ri, p), 3,
                         spin=False)
        nb, ops = bm_work(1, 480, 640, p.disp_num)
        b_ms, by = bound_ms(nb, ops, ops_rate)
        ob, oby = bound_ms(nb, BM_OPS_32 * 480 * 640 * p.disp_num, ops_rate)
        print(f"7f. G at the {label} shape (B=1, 640x480, D={p.disp_num}): "
              f"== plain (torch.equal); device ms a call {k_ms:.4f} (CUDA "
              f"events, calls queued behind a spin); plain {p_ms:.3f}; bound "
              f"{b_ms:.5f} by {by} ({nb} bytes, {ops:.6g} instructions; "
              f"counted one operation an instruction, unpacked: "
              f"{ob:.5f} by {oby}); library: none")
        if k_ms < b_ms:
            raise AssertionError(f"G at {label}: {k_ms} ms is below its "
                                 f"bound {b_ms} ms")
        if label == "node":
            out = (k_ms, p_ms, b_ms, by)
    # the batched shapes, where G takes 64-column strips: G against G'
    # "full32" (32-column strips), timed G, 32, G, 32 in one process
    for label, (li, ri), p in (
            (f"config 5's shape (B={CONFIG5_B}, D=64)", (L5, R5), p64),
            (f"bench_bm256's shape (B={BM256_B}, D=256)", (L16, R16), p256)):
        if not all(torch.equal(x, y) for x, y in zip(
                bk.bm_match_diag(li, ri, p, "full32"),
                bk.bm_match_fused(li, ri, p))):
            raise AssertionError(f"G' full32 != G at {label}")
        sw = bk.strip_width(tuple(li.shape), p)
        ks, k32s = [], []
        for _ in range(2):
            ks.append(events_ms(lambda: bk.bm_match_fused(li, ri, p), 10))
            k32s.append(events_ms(
                lambda: bk.bm_match_diag(li, ri, p, "full32"), 10))
        nbb, opsb = bm_work(li.shape[0], 480, 640, p.disp_num)
        bb, byb = bound_ms(nbb, opsb, ops_rate)
        obb, obyb = bound_ms(nbb, BM_OPS_32 * li.shape[0] * 480 * 640
                             * p.disp_num, ops_rate)
        print(f"7f. G at {label}: device ms a call "
              f"{', '.join(f'{k:.4f}' for k in ks)} ({sw}-column strips); "
              f"with 32-column strips (G' full32, equal to G) "
              f"{', '.join(f'{k:.4f}' for k in k32s)}; bound {bb:.5f} by "
              f"{byb} (counted one operation an instruction, unpacked: "
              f"{obb:.5f} by {obyb})")
        if min(ks) < bb:
            raise AssertionError(f"G at {label}: {min(ks)} ms is below its "
                                 f"bound")
    parts = {mode: events_ms(lambda: bk.bm_match_diag(lt, rt, p64, mode), 20)
             for mode in bk.DIAG_MODES}
    if not all(torch.equal(x, y) for x, y in zip(
            bk.bm_match_diag(lt, rt, p64, "full"),
            bk.bm_match_fused(lt, rt, p64))):
        raise AssertionError("G' full != G")
    print("7f. G' (per-part timing of G, B=1, 640x480, D=64, device ms a "
          "call): " + ", ".join(f"{m} {t:.4f}" for m, t in parts.items()))
    return {"name": "bm", "route": "cuda",
            "source": "jackal_tpu_torch/csrc/bm_kernel.cu",
            "replaces": "jackal_tpu/ops/pallas/bm_kernel.py:107",
            "launches": node_launches, "ms": out[0], "plain_ms": out[1],
            "bound_ms": out[2], "bound_by": out[3], "library_ms": None}


# the node shell's live extrinsics in phase 9 (c): a tilt of the -m
# sliders that keeps the calibrated scene's scan filled and moves it
SHELL_PHI, SHELL_TRANS = (1.35, -3.1, 1.6), (0.05, 0.0, 0.3)


class _StampedOut:
    """A stdout that keeps each line a CLI prints with the time it was
    printed (perf_counter), to time the CLI's frame loop from its own
    per-frame log lines."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, s):
        self._part += s
        *done, self._part = self._part.split("\n")
        t = time.perf_counter()
        self.lines += [(t, line) for line in done]
        return len(s)

    def flush(self):
        pass

    def text(self):
        return "\n".join(line for _, line in self.lines) + self._part


def shell_phase(dev):
    """Phase 9: the node shell. The point_cloud CLI (cli/point_cloud.main)
    in this process at 640x480 on ELAS: (a) per frame on the synthetic
    stream and on an NPZ replay of phase 4's calibrated pairs, its maps
    against process_frame's (torch.equal) and its scans within the scan
    tolerance, A's and B's launches counted around each call; (b) at
    --batch 8 over 48 and 240 frames of the replay (the stream scheduler),
    A's, B's and C's launches (exactly 1, 1 and 2 a batch) and the fps it
    prints; (c) -m --phi --trans, its scans
    against process_frame's after update_extrinsics and apart from (a)'s;
    (d) the navigate CLI on (a)'s scans. Returns the phase's JSON line."""
    import contextlib
    import os
    import tempfile

    import torch
    from jackal_tpu_torch.cli import navigate as nav_cli
    from jackal_tpu_torch.cli import point_cloud as pc_cli
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.io_bus.camera import open_source
    from jackal_tpu_torch.matching.elas import dense as dense_mod
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import support as support_mod
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    params = PipelineParams(logging=True, im_width=640, im_height=480,
                            crop_im_width=640, crop_im_height=480)
    pipe = make_pipeline(engine="elas", params=params, device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shell_")
    replay = os.path.join(tmp, "pairs.npz")
    pairs = [synthetic_raw_pair(pipe, seed, 8.0 + 6 * seed, 0.03 * (seed % 3))
             for seed in range(9)]
    np.savez(replay, left=np.stack([p[0] for p in pairs]),
             right=np.stack([p[1] for p in pairs]))
    sources = {"synthetic": ("synthetic:9", list(open_source("synthetic:9"))),
               "replay": (replay, pairs)}

    def run(module, argv):
        """(stdout lines with their times, launch counts) of one in-process
        CLI call; the counters are set to 0 just before it."""
        out = _StampedOut()
        support_mod.launches = dense_mod.launches = dp.launches = 0
        torch.cuda.synchronize()
        with contextlib.redirect_stdout(out):
            rc = module.main(argv)
        torch.cuda.synchronize()
        counts = {"support": support_mod.launches,
                  "elas_dense": dense_mod.launches, "raster": dp.launches}
        if rc != 0:
            raise AssertionError(f"{module.__name__} {argv}: rc {rc}\n"
                                 f"{out.text()}")
        return out, counts

    def held(npz, frames, ref_pipe, label):
        """The CLI's --out against ref_pipe.process_frame on the same
        frames: maps torch.equal, scans within relative 1e-5 on the same
        filled bins. Returns the scans."""
        with np.load(npz) as z:
            dmaps, scans = z["dmaps"], z["scans"]
        if dmaps.shape != (9, 480, 640) or scans.shape != (9, 90):
            raise AssertionError(f"{label}: --out shapes {dmaps.shape}, "
                                 f"{scans.shape}")
        exact = True
        for i, (lf, rf) in enumerate(frames):
            fr = ref_pipe.process_frame(lf, rf)
            if not torch.equal(torch.from_numpy(dmaps[i]),
                               torch.from_numpy(fr.dmap)):
                raise AssertionError(f"{label} frame {i}: CLI map != "
                                     f"process_frame's")
            want = fr.scan.scan.cpu().numpy().astype(np.float64)
            got = scans[i].astype(np.float64)
            filled = want < 1e9 - 1
            if not (np.array_equal(got < 1e9 - 1, filled) and np.all(
                    np.abs(got - want)[filled] <= 1e-5 * np.abs(want[filled]))
                    and np.isfinite(got).all()):
                raise AssertionError(f"{label} frame {i}: CLI scan != "
                                     f"process_frame's")
            exact = exact and np.array_equal(got, want)
        print(f"9. {label}: CLI maps == process_frame's (torch.equal), "
              f"scans within 1e-5 ({'bit-equal' if exact else 'not bit-equal'}"
              f"); valid {float((dmaps > 0).mean()):.3f}, scan bins filled "
              f"{float((scans < 1e9 - 1).sum(1).mean()):.1f}")
        return scans

    result = {}
    for name, (src, frames) in sources.items():
        base = os.path.join(tmp, name)
        out, counts = run(pc_cli, [
            "--size", "640x480", "--engine", "elas", "--source", src,
            "--frames", "9", "-l", "-d", base + ".d", "-s", base + ".s",
            "--out", base + ".npz"])
        held(base + ".npz", frames, pipe, f"9a per frame, {name}")
        if counts["support"] != 9:
            raise AssertionError(f"9a {name}: A called {counts['support']} "
                                 f"times over 9 frames")
        if name == "replay" and counts["elas_dense"] != 9:
            raise AssertionError(f"9a {name}: B launched "
                                 f"{counts['elas_dense']} times over 9 frames")
        stamps = [t for t, line in out.lines if line.startswith("frame ")]
        dmap_ms = [float(x) * 1e3 for x in open(base + ".d").read().split()]
        if len(stamps) != 9 or len(dmap_ms) != 9 \
                or "processed 9 frames (engine=elas)" not in out.text():
            raise AssertionError(f"9a {name}: {len(stamps)} frame lines, "
                                 f"{len(dmap_ms)} logged dmap times")
        fps = 8 / (stamps[-1] - stamps[0])
        med = statistics.median(dmap_ms[1:])
        print(f"9a. CLI per frame, {name} (--source {os.path.basename(src)}):"
              f" launches {counts}; logged dmap median {med:.3f} ms (frames "
              f"2-9); frame loop {fps:.2f} fps (frame 1's line to frame 9's)")
        result[f"per_frame_{name}"] = {"launches": counts, "fps": fps,
                                       "dmap_ms_median": med}

    # 48 frames, and 240 to show what the first batch's warm-up, inside
    # the CLI's clock, does to the fps it prints
    for frames in (48, 240):
        out, counts = run(pc_cli, [
            "--size", "640x480", "--engine", "elas", "--source", replay,
            "--loop", "--frames", str(frames), "--batch", "8"])
        text = out.text()
        last = [line for _, line in out.lines if "processed" in line]
        if not last or f"processed {frames} frames" not in last[-1] \
                or "elas_match_stream" not in last[-1]:
            raise AssertionError(f"9b {frames} frames: {text}")
        batches = frames // 8
        want = {"support": batches, "elas_dense": batches,
                "raster": 2 * batches}
        if counts != want:
            raise AssertionError(f"9b {frames} frames: launches {counts}, "
                                 f"expected {want}")
        fps = float(last[-1].split("->")[1].split("fps")[0])
        print(f"9b. CLI --batch 8, {frames} frames, replay: {last[-1]}; "
              f"launches {counts}")
        result[f"batched_replay_{frames}"] = {"launches": counts, "fps": fps}

    base = os.path.join(tmp, "extrinsics")
    _, counts = run(pc_cli, [
        "--size", "640x480", "--engine", "elas", "--source", replay,
        "--frames", "9", "-m", "--phi", *map(str, SHELL_PHI),
        "--trans", *map(str, SHELL_TRANS), "--out", base + ".npz"])
    moved = make_pipeline(engine="elas", params=params, device=dev)
    moved.update_extrinsics(SHELL_PHI, SHELL_TRANS)
    scans_c = held(base + ".npz", pairs, moved,
                   "9c -m --phi --trans, replay, against update_extrinsics")
    with np.load(os.path.join(tmp, "replay.npz")) as z:
        if np.array_equal(scans_c, z["scans"]):
            raise AssertionError("9c: the live extrinsics left the scans as "
                                 "they were")
    print(f"9c. live extrinsics reach the scan: phi {SHELL_PHI}, trans "
          f"{SHELL_TRANS}; scans differ from 9a's; launches {counts}")
    result["extrinsics"] = {"launches": counts}

    for name in sources:
        out, _ = run(nav_cli, ["--scans", os.path.join(tmp, name + ".npz"),
                               "--ticks", "9"])
        ticks = [line for _, line in out.lines if line.count(",") == 4]
        if len(ticks) != 9:
            raise AssertionError(f"9d navigate on {name}: {out.text()}")
        print(f"9d. navigate on 9a's {name} scans: 9 ticks, last "
              f"'{ticks[-1]}'")
    result["navigate_ticks"] = 9
    return {"shell": result}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print("chip_smoke: runs on one card; make exactly one visible "
              "(CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 2
    try:
        import jackal_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: jackal_tpu_torch not importable: {e}",
              file=sys.stderr)
        return 2
    from jackal_tpu_torch import build as buildmod
    from jackal_tpu_torch import native
    from jackal_tpu_torch.config import ElasParams, PipelineParams
    from jackal_tpu_torch.matching.elas import dense as dense_mod
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.matching.elas import support as support_mod
    from jackal_tpu_torch.matching.elas.native_prior import (
        build_priors_native, fit_planes_native)
    from jackal_tpu_torch.matching.elas.pipeline import (
        elas_match, elas_match_batch_device)
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.ops.descriptor import create_descriptor
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    dev = torch.device(DEVICE)
    params = ElasParams()
    D = params.disp_num

    # ---- 1. card and build --------------------------------------------
    card = card_line()
    print(f"card: {card}")
    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc}")
    t = time.perf_counter()
    buildmod.build([native.LIBRARY] + [
        cuda_lib.library(n) for n in cuda_lib.KERNEL_SOURCES
        + ("bm_kernel_diag", "sad_rate")])
    print(f"build: {time.perf_counter() - t:.1f} s (nvcc per kernel and "
          f"g++ in parallel)")
    for name in cuda_lib.KERNEL_SOURCES + ("bm_kernel_diag",):
        for line in buildmod.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ------------------------
    max_err = {"support": 0.0, "elas_dense": 0.0, "raster": 0.0,
               "census": 0.0, "sgm_paths": 0.0, "sgm_wta": 0.0, "bm": 0.0}

    def hold(kernel, name, got, want):
        """Kernel outputs must equal the plain version's (torch.equal);
        records the largest absolute difference seen."""
        for i, (g, w) in enumerate(zip(got, want)):
            err = float((g.double() - w.double()).abs().max())
            max_err[kernel] = max(max_err[kernel], err)
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{name}[{i}]: {bad} elements differ")

    frames = {}
    for fix in GOLDEN:
        g = np.load(f"{FIX}/{fix}.npz")
        imgs = torch.from_numpy(np.stack([g["left"], g["right"]])).to(dev)
        desc = create_descriptor(imgs)
        frames[fix] = (g, desc[0:1], desc[1:2])
    rng = np.random.default_rng(2024)
    Hr, Wr = 120, 333
    left = rng.integers(0, 256, (2, Hr, Wr + 16)).astype(np.uint8)
    rand = torch.from_numpy(np.stack([left[:, :, 16:],
                                      left[:, :, 16 - 7:-7]])).to(dev)
    rdesc = create_descriptor(rand)
    cases = [(fix, d1, d2) for fix, (_, d1, d2) in frames.items()]
    cases.append((f"random B=2 {Hr}x{Wr}", rdesc[0].contiguous(),
                  rdesc[1].contiguous()))

    support_mod.launches = dense_mod.launches = 0
    step = support_mod.effective_stepsize(params)
    for name, d1, d2 in cases:
        H, W = d1.shape[1:3]
        ncv = -(-H // step)
        Q = support_mod.grid_row_blocks(d1, step, ncv)
        T = support_mod.grid_row_blocks(d2, step, ncv)
        hold("support", f"support {name}", support_mod.support_keys(Q, T, 0, D),
             support_mod.support_keys_plain(Q, T, 0, D))
        if name in frames:
            views = prior_inputs(d1, d2, params, dev)
        else:
            views = [random_prior(rng, 2, H, W, params, dev)
                     for _ in range(2)]
        for right, args in ((False, views[0]), (True, views[1])):
            hold("elas_dense", f"dense {name} right={right}",
                 [dense_mod.dense_match(d1, d2, *args, params, right)],
                 [dense_mod.dense_match_plain(d1, d2, *args, params, right)])
        hold("elas_dense", f"dense pair {name}",
             dense_mod.dense_match_pair(d1, d2, *views, params),
             dense_mod.dense_match_pair_plain(d1, d2, *views, params))
        print(f"kernels == plain (torch.equal, both views; dense also both "
              f"views in one launch): {name}")
    # one candidate word a cell (D <= 32), and cells of one pixel
    d1, d2 = rdesc[0].contiguous(), rdesc[1].contiguous()
    for Ds, gs in ((32, 20), (8, 1)):
        ps = dataclasses.replace(params, disp_max=Ds - 1, grid_size=gs)
        views = [random_prior(rng, 2, Hr, Wr, ps, dev) for _ in range(2)]
        hold("elas_dense", f"dense pair D = {Ds}, cells of {gs}",
             dense_mod.dense_match_pair(d1, d2, *views, ps),
             dense_mod.dense_match_pair_plain(d1, d2, *views, ps))
    print("dense kernel == plain (torch.equal, both views in one launch): "
          "D = 32 with cells of 20, D = 8 with cells of 1")
    for name in SUPPORT_EDGE_CASES:
        Qe, Te, lo, hi = support_edge_case(name, dev)
        hold("support", f"support {name}", support_mod.support_keys(
            Qe, Te, lo, hi), support_mod.support_keys_plain(Qe, Te, lo, hi))
    print(f"support kernel == plain (torch.equal, both views): "
          f"{', '.join(SUPPORT_EDGE_CASES)}")
    torch.cuda.synchronize()
    if support_mod.launches == 0 or dense_mod.launches == 0:
        raise AssertionError("a kernel wrapper never launched its kernel")

    # ---- 2b. the raster kernel and the device prior -----------------------
    H, W = 480, 640
    gold_l = np.stack([frames[f][0]["left"] for f in GOLDEN])
    gold_r = np.stack([frames[f][0]["right"] for f in GOLDEN])
    dp.launches = 0
    n_chunks = 0
    for chunk in (1, 2):
        for flat, Np, Tp, Ts, fr in batch_chunks(params, gold_l, gold_r,
                                                 chunk, dev):
            CH = len(fr)
            coeffs = ep._chunk_coeffs(flat.to(dev), CH, Np, Tp, Ts, W, H,
                                      params)
            coeffs_cpu = ep._chunk_coeffs(flat, CH, Np, Tp, Ts, W, H, params)
            for side, ((tab, sel, words), cpu) in enumerate(zip(coeffs,
                                                               coeffs_cpu)):
                # slopes (f32 division), planes (f64 fit) and grids: the
                # card's equal the CPU's and the C++ engine's
                for x, y in zip((tab, sel, words), cpu):
                    if not torch.equal(x.cpu(), y):
                        raise AssertionError(f"chunk {chunk} side {side}: "
                                             f"card != CPU coefficients")
                for f, (sp, _, _, wire) in enumerate(fr):
                    tw = wire[1 + 2 * side]
                    want = fit_planes_native(sp, tw)[:, 3 * side:3 * side + 3]
                    got = tab[f * Tp:f * Tp + len(tw), 8:11].cpu().numpy()
                    if not np.array_equal(got, want.view(np.int32)):
                        raise AssertionError("planes != fit_planes_native")
                win = dp.raster(tab, sel, Tp, W, H)
                hold("raster", f"raster chunk {chunk} side {side}", [win],
                     [dp.raster_plain(tab, sel, Tp, W, H)])
                dpl, valid, cov = (x.cpu().numpy() for x in dp.decode_win(win))
                for f, (sp, t1, t2, _) in enumerate(fr):
                    host = build_priors_native(sp, W, H, params, tri_left=t1,
                                               tri_right=t2)
                    m, g = host[side], host[2 + side]
                    c = m.tri_id >= 0
                    if not (np.array_equal(cov[f], c)
                            and np.array_equal(valid[f], m.valid)
                            and np.array_equal(dpl[f][c], m.d_plane[c])
                            and np.array_equal(words[f].cpu().numpy(),
                                               dense_mod.pack_grid(g))):
                        raise AssertionError(
                            f"device prior != C++ host prior (chunk {chunk},"
                            f" frame {f}, side {side})")
            n_chunks += 1
    print(f"raster kernel == plain (torch.equal) and device prior == C++ "
          f"host prior, planes == fit_planes_native, card coefficients == "
          f"CPU's: {n_chunks} chunks of the golden pair, both sides")
    rng_w = np.random.default_rng(11)
    sp = np.stack([rng_w.choice(np.arange(8, W - 8), 14, replace=False),
                   rng_w.choice(np.arange(8, H - 8), 14, replace=False),
                   rng_w.integers(6, 120, 14)], -1).astype(np.int32)
    rp = np.stack([sp[:, 0] - sp[:, 2], sp[:, 1]], -1).astype(np.float32)
    from jackal_tpu_torch.matching.elas.prior import delaunay
    from jackal_tpu_torch.matching.elas.native_prior import (
        tri_wire_and_bin_native)
    t1, t2 = delaunay(sp[:, :2].astype(np.float32)), delaunay(rp)
    a1 = tri_wire_and_bin_native(sp.astype(np.int16), t1, W, H, 16, 128)
    a2 = tri_wire_and_bin_native(sp.astype(np.int16), t2, W, H, 16, 128,
                                 right=True)
    wire = (sp.astype(np.int16), a1[0], a1[1], a2[0], a2[1], a1[2], a2[2])
    Np, Tp, Ts = ep._chunk_pads([wire])
    flat = torch.from_numpy(ep._flatten_chunk_wire([wire], Np, Tp, Ts))
    host = build_priors_native(sp, W, H, params, tri_left=t1, tri_right=t2)
    for side, (tab, sel, _) in enumerate(ep._chunk_coeffs(
            flat.to(dev), 1, Np, Tp, Ts, W, H, params)):
        win = dp.raster(tab, sel, Tp, W, H)
        hold("raster", f"raster wide triangles side {side}", [win],
             [dp.raster_plain(tab, sel, Tp, W, H)])
        c = host[side].tri_id >= 0
        dpl, _, cov = (x[0].cpu().numpy() for x in dp.decode_win(win))
        if not (np.array_equal(cov, c)
                and np.array_equal(dpl[c], host[side].d_plane[c])):
            raise AssertionError("wide triangles: device prior != host")
    tab, sel = raster_overflow_case(np.random.default_rng(5), 2, 300, W, H,
                                    48)
    win = dp.raster(tab.to(dev), sel.to(dev), 300, W, H)
    hold("raster", "raster overflowing planes", [win],
         [dp.raster_plain(tab.to(dev), sel.to(dev), 300, W, H)])
    dpl = dp.decode_win(win)[0].cpu().numpy()
    v, u = np.mgrid[0:H, 0:W]
    want = np.array([511, -512, 0])[((v // 16) * 5 + u // 128) % 3]
    if not np.array_equal(dpl[:, :, 1:], np.broadcast_to(want[:, 1:],
                                                         (2, H, W - 1))):
        raise AssertionError("overflowing planes: not XLA's saturation")
    for name in RASTER_EDGE_CASES:
        tab, sel, Tp_e, W_e, H_e = (x.to(dev) if torch.is_tensor(x) else x
                                    for x in raster_edge_case(name))
        hold("raster", f"raster {name}", [dp.raster(tab, sel, Tp_e, W_e, H_e)],
             [dp.raster_plain(tab, sel, Tp_e, W_e, H_e)])
    print(f"raster kernel == plain (torch.equal): "
          f"{', '.join(RASTER_EDGE_CASES)}")
    probe = torch.tensor([3e9, -3e9, float("nan")], device=dev)
    from jackal_tpu_torch.ops.convert import to_int32
    print(f"raster kernel == plain on wide triangles and overflowing planes "
          f"(+1e17 -> 511, -1e17 -> -512, NaN -> 0); float->int32 of "
          f"[3e9, -3e9, nan] on the card: torch cast "
          f"{probe.to(torch.int32).tolist()}, to_int32 "
          f"{to_int32(probe).tolist()}")
    if dp.launches == 0:
        raise AssertionError("the raster wrapper never launched its kernel")

    # ---- 3. ELAS on the card against libelas ------------------------------
    for fix, (g, _, _) in frames.items():
        D1, D2 = elas_match(g["left"], g["right"], params, device=dev)
        for nm, got in (("D1", D1), ("D2", D2)):
            ref = torch.from_numpy(g[nm]).to(dev)
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"{fix} {nm}: {int((got != ref).sum())} pixels differ "
                    f"from libelas")
        print(f"elas_match on the card == libelas D1/D2 bit for bit: {fix}")
    for chunk in (1, 2):
        D1, D2 = elas_match_batch_device(gold_l, gold_r, params, chunk=chunk,
                                         device=dev)
        for i, fix in enumerate(GOLDEN):
            for nm, got in (("D1", D1[i]), ("D2", D2[i])):
                if not torch.equal(got, torch.from_numpy(
                        frames[fix][0][nm]).to(dev)):
                    raise AssertionError(f"batch chunk {chunk} {fix} {nm} "
                                         f"!= libelas")
    print(f"elas_match_batch_device on the card == libelas D1/D2 bit for bit:"
          f" {', '.join(GOLDEN)} in one batch, chunk 1 and chunk 2")

    # ---- 4. the node -----------------------------------------------------
    pipe = make_pipeline(engine="elas", params=PipelineParams(
        im_width=640, im_height=480, crop_im_width=640, crop_im_height=480),
        device=dev)
    # seeded raw 640x360 pairs: walls and slanted surfaces (synthetic.py)
    pairs = [synthetic_raw_pair(pipe, seed, 8.0 + 6 * seed, 0.03 * (seed % 3))
             for seed in range(9)]
    raw_l = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    raw_r = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    L9, R9 = pipe._rectify_crop(raw_l, raw_r)
    B1, B2 = elas_match_batch_device(L9, R9, params, chunk=3, device=dev)
    for b in range(len(pairs)):
        s1, s2 = elas_match(L9[b], R9[b], params, device=dev)
        if not (torch.equal(B1[b], s1) and torch.equal(B2[b], s2)):
            raise AssertionError(f"synthetic frame {b}: batch != per-frame")
    print(f"elas_match_batch_device on the card == elas_match on the "
          f"{len(pairs)} synthetic node frames (chunk 3), D1 and D2")
    support_mod.launches = dense_mod.launches = 0
    results, walls = [], []
    for i, (lr, rr) in enumerate(pairs):
        t = time.perf_counter()
        fr = pipe.process_frame(lr, rr, timing=True)
        walls.append(time.perf_counter() - t)
        results.append(fr)
    launches = {"support": support_mod.launches,
                "elas_dense": dense_mod.launches}
    print(f"node launches over {len(pairs)} frames: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"the node bypassed a kernel: {launches}")
    if launches["elas_dense"] != len(pairs):
        raise AssertionError(f"the node launched the dense kernel "
                             f"{launches['elas_dense']} times over "
                             f"{len(pairs)} frames, not once a frame")
    for fr in results:
        sc = fr.scan.scan
        if fr.dmap.shape != (480, 640) or fr.dmap.dtype != np.uint8 \
                or sc.shape != (90,) or not bool(torch.isfinite(sc).all()):
            raise AssertionError("node output has the wrong shape or type")
    valid_frac = float(np.mean([(fr.dmap > 0).mean() for fr in results]))
    filled = float(np.mean([(fr.scan.scan < 1e9 - 1).sum().item()
                            for fr in results]))
    if valid_frac < 0.5 or filled < 10:
        raise AssertionError(f"node output implausible: {valid_frac} of "
                             f"pixels valid, {filled} scan bins filled")
    steady = results[1:]
    med = {k: statistics.median(getattr(fr, k) for fr in steady) * 1e3
           for k in ("rect_time", "dmap_time", "scan_time")}
    wall = statistics.median(walls[1:]) * 1e3
    print(f"node 640x480 (median of {len(steady)} frames after 1 warm-up): "
          f"rectify {med['rect_time']:.3f} ms, dmap {med['dmap_time']:.3f} ms,"
          f" scan {med['scan_time']:.3f} ms, frame {wall:.3f} ms = "
          f"{1e3 / wall:.2f} fps; dmap valid {valid_frac:.3f}, "
          f"scan bins filled {filled:.1f}")
    wall_p, busy, *_ = device_busy(
        lambda: [pipe.process_frame(lr, rr) for lr, rr in pairs[1:4]])
    print(f"node device busy over 3 frames under torch.profiler: "
          f"{busy:.3f} ms of {wall_p:.3f} ms wall, "
          f"idle share {1 - busy / wall_p:.3f}")

    # per-stage breakdown of one frame at the node's shapes
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.matching.elas.native_prior import (
        build_priors_native, collect_support_points_native)
    from jackal_tpu_torch.matching.elas.post import (
        left_right_consistency_check, post_tail)
    lt, rt = pipe._rectify_crop(torch.from_numpy(pairs[-1][0]).to(dev),
                                torch.from_numpy(pairs[-1][1]).to(dev))
    H, W = lt.shape
    st = {}
    desc = create_descriptor(torch.stack([lt, rt]))
    d1, d2 = desc[0:1], desc[1:2]
    st["descriptor"] = host_ms(lambda: create_descriptor(torch.stack([lt, rt])), 5)
    dc = support_mod.support_candidates(d1, d2, params)
    st["support (kernel + epilogue)"] = host_ms(
        lambda: support_mod.support_candidates(d1, d2, params), 5)
    st["hop 1: candidate grid to host"] = host_ms(lambda: dc.cpu(), 5)
    dcan = dc[0].cpu().numpy()

    def host_prior():
        sp = collect_support_points_native(dcan, params, W, H)
        return build_priors_native(sp, W, H, params)
    m1, m2, g1, g2 = host_prior()
    st["host prior (C++)"] = host_ms(host_prior, 5)

    def upload(m, g):
        return [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
                for a in (m.d_plane, m.valid, m.tri_id >= 0,
                          dense_mod.pack_grid(g))]
    v1, v2 = upload(m1, g1), upload(m2, g2)
    st["prior upload (grid packed on the host)"] = host_ms(lambda: (upload(m1, g1), upload(m2, g2)), 5)
    st["dense, both views (kernel B, one launch)"] = host_ms(
        lambda: dense_mod.dense_match_pair(d1, d2, v1, v2, params), 5)
    Da, Db = (x[0] for x in dense_mod.dense_match_pair(d1, d2, v1, v2,
                                                        params))
    L1, L2 = left_right_consistency_check(Da, Db, params)
    st["L/R check"] = host_ms(
        lambda: left_right_consistency_check(Da, Db, params), 5)
    st["hop 2: speckle (D1 to host, C++ BFS, back)"] = host_ms(
        lambda: ep._speckle(L1, params), 5)
    S1 = ep._speckle(L1, params)
    st["tail (gap, adaptive mean)"] = host_ms(
        lambda: post_tail(S1, L2, params), 5)
    for k, v in st.items():
        print(f"  stage {k}: {v:.3f} ms")
    print("stages: " + json.dumps({k: round(v, 4) for k, v in st.items()}))

    # ---- 4b. the batched node ---------------------------------------------
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.matching.elas.post import (
        postprocess_batch, remove_small_segments_batch)
    from jackal_tpu_torch.ops.transfer import HostCopy, to_device
    from jackal_tpu_torch.pipeline.runner import (TOPIC_DEPTH, TOPIC_SCAN,
                                                  StreamingRunner)
    n_frames, batch = 48, 8
    stream = [pairs[i % len(pairs)] for i in range(n_frames)]
    bus = TopicBus()
    depth_msgs, scan_msgs = [], []
    bus.subscribe(TOPIC_DEPTH, depth_msgs.append)
    bus.subscribe(TOPIC_SCAN, scan_msgs.append)
    runner = StreamingRunner(pipe, bus, batch_size=batch,
                             stage_sample_every=3)
    runner.run(iter(stream[:2 * batch]))                # warm-up
    depth_msgs.clear()
    scan_msgs.clear()
    support_mod.launches = dense_mod.launches = dp.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    done = runner.run(iter(stream))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t
    launches_b = {"support": support_mod.launches,
                  "elas_dense": dense_mod.launches, "raster": dp.launches}
    print(f"batched node launches over {done} frames: {launches_b}")
    if min(launches_b.values()) == 0:
        raise AssertionError(f"the batched node bypassed a kernel: "
                             f"{launches_b}")
    if launches_b["elas_dense"] != n_frames // batch:
        raise AssertionError(f"the batched node launched the dense kernel "
                             f"{launches_b['elas_dense']} times over "
                             f"{n_frames // batch} batches, not once a "
                             f"batch")
    if done != n_frames or len(depth_msgs) != n_frames \
            or len(scan_msgs) != n_frames:
        raise AssertionError(f"published {len(depth_msgs)} depth maps and "
                             f"{len(scan_msgs)} scans of {done} frames")
    for i, m in enumerate(depth_msgs):
        if not np.array_equal(m.data, results[i % len(pairs)].dmap):
            raise AssertionError(f"published depth map {i} != process_frame")
    print(f"batched node (StreamingRunner, batch {batch}, 640x480): "
          f"{done} frames in {stream_s * 1e3:.3f} ms = "
          f"{done / stream_s:.2f} fps, {len(depth_msgs)} depth maps and "
          f"{len(scan_msgs)} scans published, each equal to process_frame's")
    raw_b = [(torch.from_numpy(np.stack([p[0] for p in stream[i:i + batch]])
                               ).to(dev),
              torch.from_numpy(np.stack([p[1] for p in stream[i:i + batch]])
                               ).to(dev))
             for i in range(0, n_frames, batch)]

    def batches():
        return [pipe.process_batch(lb, rb) for lb, rb in raw_b]
    batches()
    t = time.perf_counter()
    batches()
    torch.cuda.synchronize()
    pb_s = time.perf_counter() - t
    print(f"process_batch, the same {n_frames} frames one batch after "
          f"another: {pb_s * 1e3:.3f} ms = {n_frames / pb_s:.2f} fps")
    for host_ops in (True, False):
        wall_s, busy_s, *_ = device_busy(lambda: runner.run(iter(stream)),
                                        host_ops=host_ops)
        wall_b, busy_b, *_ = device_busy(batches, host_ops=host_ops)
        print(f"device busy under torch.profiler ("
              f"{'host ops and card' if host_ops else 'card alone'}) over "
              f"{n_frames} frames: stream {busy_s:.3f} ms of {wall_s:.3f} ms"
              f" wall, idle share {1 - busy_s / wall_s:.3f}; process_batch "
              f"{busy_b:.3f} ms of {wall_b:.3f} ms wall, idle share "
              f"{1 - busy_b / wall_b:.3f}")
    lb8, rb8 = raw_b[0]

    # per-stage breakdown of one batch of 8 in one chunk (process_batch)
    L8, R8 = pipe._rectify_crop(lb8, rb8)
    sb = {}
    sb["front (descriptors + support, 8 frames)"] = host_ms(
        lambda: ep._front(L8, R8, params), 5)
    bd1, bd2, dcan_dev = ep._front(L8, R8, params)
    sb["candidate grids to the host"] = host_ms(
        lambda: HostCopy(dcan_dev).numpy(), 5)
    dcan8 = HostCopy(dcan_dev).numpy()
    sb["host prior, per frame"] = host_ms(
        lambda: [ep._prior_tri_job(dcan8[b], params, W, H)
                 for b in range(batch)], 3) / batch
    wires = [ep._prior_tri_job(dcan8[b], params, W, H) for b in range(batch)]
    Np, Tp, Ts = ep._chunk_pads(wires)
    lad = ep._lr_ladder(wires, params)
    sb["wire flatten + upload"] = host_ms(
        lambda: to_device(ep._flatten_chunk_wire(wires, Np, Tp, Ts), dev), 5)
    flat = to_device(ep._flatten_chunk_wire(wires, Np, Tp, Ts), dev)[0]
    sb["coefficients + grids (both sides)"] = host_ms(
        lambda: ep._chunk_coeffs(flat, batch, Np, Tp, Ts, W, H, params), 5)
    coeffs = ep._chunk_coeffs(flat, batch, Np, Tp, Ts, W, H, params)
    sb["raster (2 x kernel C + decode)"] = host_ms(
        lambda: ep._chunk_raster(coeffs, Tp, W, H), 5)
    m1, m2 = ep._chunk_raster(coeffs, Tp, W, H)
    sb["dense, both views (kernel B, one launch)"] = host_ms(
        lambda: dense_mod.dense_match_pair(bd1, bd2, m1, m2, params), 5)
    BD1, BD2 = dense_mod.dense_match_pair(bd1, bd2, m1, m2, params)
    sb["postprocess (L/R, speckle, tail)"] = host_ms(
        lambda: postprocess_batch(BD1, BD2, params, lad), 3)
    BL1, _ = left_right_consistency_check(BD1, BD2, params, lad)
    sb["  of which the speckle filter (left view)"] = host_ms(
        lambda: remove_small_segments_batch(BL1, params), 3)
    dmaps8 = pipe._dmap_u8(postprocess_batch(BD1, BD2, params, lad)[0])
    sb["scan"] = host_ms(lambda: pipe._scan_stage(dmaps8), 5)
    for k, v in sb.items():
        print(f"  batch stage {k}: {v:.3f} ms")
    print(f"batch stages (Np {Np}, Tp {Tp}, Ts {Ts}, lr_smax {lad}): "
          + json.dumps({k: round(v, 4) for k, v in sb.items()}))

    # ---- 5. the kernels' roofline bounds --------------------------------
    rate, _ = sad_rate(dev)
    for name in cuda_lib.KERNEL_SOURCES + ("sad_rate",):
        # the two kernels redesigned last: their whole opcode mix
        top = 40 if name in ("elas_dense_kernel", "census_kernel") else 8
        print(f"  sass {name}: "
              f"{sass_opcodes(cuda_lib.library(name).path, top=top)}")
    ffma = sass_opcodes(cuda_lib.library("raster_kernel").path, top=None,
                        prefix="FFMA")
    print(f"  sass raster_kernel FFMA instructions: {ffma or 'none'}")
    if ffma:
        raise AssertionError("the raster kernel contracts into FFMA")

    # kernel timing at the node's shapes, beside the plain versions
    ncv = -(-H // step)
    Q = support_mod.grid_row_blocks(d1, step, ncv)
    T = support_mod.grid_row_blocks(d2, step, ncv)
    nb, opsA, sads = support_work(Q, params.disp_min, D)
    bA, byA = bound_ms(nb, opsA, int_ops_rate(dev))
    obA, obyA = bound_ms(nb, sads, rate)

    def sup():
        return support_mod.support_keys(Q, T, 0, D)

    def den():
        return dense_mod.dense_match_pair(d1, d2, v1, v2, params)

    # B at the batched node's shape: its chunk of 8 frames (phase 4b; int16
    # d_plane from the raster)
    hold("elas_dense", f"dense pair, the batched node's {batch} frames",
         dense_mod.dense_match_pair(bd1, bd2, m1, m2, params),
         dense_mod.dense_match_pair_plain(bd1, bd2, m1, m2, params))

    def den8():
        return dense_mod.dense_match_pair(bd1, bd2, m1, m2, params)

    # A at the batched node's shape: its B = 8 descriptors (phase 4b)
    Q8 = support_mod.grid_row_blocks(bd1, step, ncv)
    T8 = support_mod.grid_row_blocks(bd2, step, ncv)
    hold("support", f"support, the batched node's {batch} frames",
         support_mod.support_keys(Q8, T8, 0, D),
         support_mod.support_keys_plain(Q8, T8, 0, D))
    nb8, ops8, sads8 = support_work(Q8, params.disp_min, D)
    b8, by8 = bound_ms(nb8, ops8, int_ops_rate(dev))

    def sup8():
        return support_mod.support_keys(Q8, T8, 0, D)

    kA, kB, kA8 = events_ms(sup, 50), events_ms(den, 50), events_ms(sup8, 20)
    kB8 = events_ms(den8, 20)
    plans = {n: support_mod.plan(dev.index, *q.shape[:3], 0, D)
             for n, q in ((1, Q), (batch, Q8))}
    lA, seenA = launch_ms(sup, 50, "support_keys_kernel")
    lM, seenM = (launch_ms(sup, 50, "support_merge_kernel")
                 if plans[1][0] > 1 else (0.0, 0))
    lB, seenB = launch_ms(den, 50, "elas_dense_kernel")
    pA = events_ms(lambda: support_mod.support_keys_plain(Q, T, 0, D), 3,
                   spin=False)
    nbB, sadsB, viewsB = dense_pair_work(d1, d2, v1, v2, params)
    bB, byB = bound_ms(nbB, sadsB, rate)
    # the bound as counted before the pair call: each view alone, summed
    obB = sum(bound_ms(v[0], int(v[1].sum()) * 16, rate)[0] for v in viewsB)
    nb8B, sads8B, views8B = dense_pair_work(bd1, bd2, m1, m2, params)
    b8B, by8B = bound_ms(nb8B, sads8B, rate)
    ob8B = sum(bound_ms(v[0], int(v[1].sum()) * 16, rate)[0]
               for v in views8B)
    pB = events_ms(lambda: dense_mod.dense_match_pair_plain(
        d1, d2, v1, v2, params), 3, spin=False)
    for label, vw in (("node", viewsB), (f"B = {batch}", views8B)):
        for side, (_, cnt, ws) in zip(("left", "right"), vw):
            ok = cnt > 0
            print(f"dense {label} {side} view: candidates a matched pixel "
                  f"{float(cnt[ok].float().mean()):.3f} (grid outside the "
                  f"window {ws['grid_candidates'] / max(int(ok.sum()), 1):.3f}"
                  f"); warp steps a warp: this kernel "
                  f"{ws['steps'] / ws['warps']:.3f} ({2 * params.plane_radius + 1}"
                  f" window + the longest lane's grid walk), a warp-uniform "
                  f"walk {ws['uniform_steps'] / ws['warps']:.3f} (the grid "
                  f"union), the first design's longest lane "
                  f"{ws['first_design_steps'] / ws['warps']:.3f}; "
                  f"{ws['warps']} warps")
    print(f"device ms a call (CUDA events, calls queued behind a spin): "
          f"support {kA:.4f} (R, DC = {plans[1]}: its keys kernel {lA:.4f}"
          f" and its merge kernel {lM:.4f}, the means of the {seenA} and "
          f"{seenM} of 50 launches torch.profiler recorded; plain {pA:.3f}; "
          f"bound {bA:.5f} by {byA}: {nb} bytes, {opsA} instructions at "
          f"the 32-bit integer rate; the old bound {obA:.5f} by {obyA}: "
          f"{sads} byte SADs at the measured byte SAD rate); support at "
          f"the batched node's B = {batch} {kA8:.4f} (R, DC = "
          f"{plans[batch]}; bound {b8:.5f} by {by8}: {nb8} bytes, {ops8} "
          f"instructions; the old bound "
          f"{bound_ms(nb8, sads8, rate)[0]:.5f}); dense, both views in one "
          f"launch {kB:.4f} (its kernel launch {lB:.4f}, {seenB} of 50 "
          f"recorded; plain, two views, {pB:.3f}; bound {bB:.5f} by {byB}: "
          f"{nbB} bytes, {sadsB} byte SADs; the bound as counted a view, "
          f"summed over both, {obB:.5f}); dense at the batched node's "
          f"B = {batch} {kB8:.4f} (bound {b8B:.5f} by {by8B}: {nb8B} bytes, "
          f"{sads8B} byte SADs; a view at a time, summed, {ob8B:.5f})")
    for name, k, b in (("support", kA, bA), (f"support B = {batch}", kA8, b8),
                       ("dense", kB, bB), (f"dense B = {batch}", kB8, b8B)):
        if k < b:
            raise AssertionError(f"{name}: {k} ms is below its bound {b} ms")

    tabC, selC, _ = coeffs[0]
    hold("raster", f"raster, left side of a chunk of {batch} frames",
         [dp.raster(tabC, selC, Tp, W, H)],
         [dp.raster_plain(tabC, selC, Tp, W, H)])
    nbC, opsC, oldC, liveC = raster_work(tabC, selC, Tp, W, H)
    bC, byC, typeC = raster_bound_ms(nbC, opsC, dev)
    obC, obyC = bound_ms(nbC, oldC, PEAK_F32_OPS_PER_S)
    kC = events_ms(lambda: dp.raster(tabC, selC, Tp, W, H), 50)
    lC, seenC = launch_ms(lambda: dp.raster(tabC, selC, Tp, W, H), 50,
                          "raster_kernel")
    pC = events_ms(lambda: dp.raster_plain(tabC, selC, Tp, W, H), 3,
                   spin=False)
    print(f"device ms a call (CUDA events behind a spin): raster, left side "
          f"of a chunk of {batch} frames {kC:.4f} (its kernel launch "
          f"{lC:.4f}, {seenC} of 50 recorded; plain {pC:.3f}; bound "
          f"{bC:.5f} by {byC}: {nbC} bytes, {liveC} live tile slots of "
          f"{selC.numel()}, Ts {Ts}; operations f32 {opsC['f32']}, integer "
          f"{opsC['int']}, conversions {opsC['cvt']}, ms at their rates "
          + ", ".join(f"{k} {v:.5f}" for k, v in typeC.items())
          + f"; the old bound, {oldC} operations at {PEAK_F32_OPS_PER_S:.3g}"
          f" /s, {obC:.5f} by {obyC})")
    if kC < bC:
        raise AssertionError(f"raster: {kC} ms is below its bound {bC} ms")

    kernels = [
        {"name": "support", "route": "cuda",
         "source": "jackal_tpu_torch/csrc/support_kernel.cu",
         "replaces": "jackal_tpu/ops/pallas/support_kernel.py:61",
         "launches": launches["support"], "max_abs_err": max_err["support"],
         "ms": kA, "plain_ms": pA, "bound_ms": bA, "bound_by": byA,
         "library_ms": None},
        {"name": "elas_dense", "route": "cuda",
         "source": "jackal_tpu_torch/csrc/elas_dense_kernel.cu",
         "replaces": "jackal_tpu/ops/pallas/elas_dense_kernel.py:30",
         "launches": launches["elas_dense"],
         "max_abs_err": max_err["elas_dense"],
         "ms": kB, "plain_ms": pB, "bound_ms": bB, "bound_by": byB,
         "library_ms": None},
        {"name": "raster", "route": "cuda",
         "source": "jackal_tpu_torch/csrc/raster_kernel.cu",
         "replaces": "jackal_tpu/ops/pallas/raster_kernel.py:59",
         "launches": launches_b["raster"], "max_abs_err": max_err["raster"],
         "ms": kC, "plain_ms": pC, "bound_ms": bC, "bound_by": byC,
         "library_ms": None},
    ]

    # ---- 6. SGM: kernels D, E, F, the engine, the node, config 3 ---------
    for entry in sgm_phase(dev, hold):
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 7. BM and gen_pcl: kernel G, the BM node, configs 5 and bm256 ----
    entry = bm_phase(dev, hold)
    entry["max_abs_err"] = max_err["bm"]
    kernels.append(entry)

    # ---- 9. the node shell: the point_cloud and navigate CLIs ------------
    print(json.dumps(shell_phase(dev)))

    # ---- 8. the kernels line, the card, the result -----------------------
    print(f"torch.profiler windows traced again for want of device activity:"
          f" {len(EMPTY_PROFILER_WINDOWS)} {EMPTY_PROFILER_WINDOWS}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
