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
     dense_match_pair, and with the L/R check as its epilogue,
     dense_match_pair_lr, at sweep bounds disp_max, 0 and 7; the pair call
     also at D = 32 and at D = 8 with
     cells of one pixel); support also on chip_smoke.SUPPORT_EDGE_CASES (the
     node's and the batched node's shapes, D = 512 at W = 2112 and 4096,
     W < D, disp_min near D, an odd width, constant descriptors);
  2b. (a) the raster kernel (its decoded maps, both sides of a chunk in
     one launch, and one side alone) against its plain version
     (decode_win(raster_plain) a side; torch.equal) on
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
     dense kernel once a frame, both views and the L/R check as its
     epilogue in one launch; the speckle filter L, I, J and rectify N
     once a frame, the BFS hop never; H and K never: the check is B's
     epilogue, ROBOTICS has no median; the scan kernel P1 once a frame,
     P2 and P3 never; the descriptor R (both views, its pair entry) and
     the support kernel A with Q's tests as its epilogue once a frame, Q
     alone never);
     per-stage medians, fps, the device's busy time under torch.profiler,
     a per-stage breakdown of one frame (rectify, B alone, B with the L/R
     epilogue, kernel H alone, the speckle filter, with the BFS hop it
     replaced, and the tail beside their plain versions on the card), and
     elas_match_batch_device
     at chunk 1 on one frame beside elas_match;
  4b. (d) the batched node: StreamingRunner at batch 8 over 48 frames with
     the launch counters reset just before and read just after (the dense
     kernel with its L/R epilogue, L, I, J, P1, R and Q once a batch, M1
     and M2 once a chunk of 8, the raster C once a chunk for both sides,
     H, K, P2, P3 and elas_u8 never: J's epilogue writes the u8 map);
     fps, the
     frames published, the device's busy time and idle share under
     torch.profiler beside process_batch's, and a per-stage breakdown of
     one batch;
  5. the roofline bound of each kernel from this run's inputs; the peak
     rate of its byte SADs is measured on the card (csrc/sad_rate.cu, the
     median of 7 windows, refused above the card's cap), and cuobjdump
     shows the instructions __vsadu4 became (the dense and census kernels'
     whole opcode mix) and that the raster kernel has no FFMA and the
     postprocess kernels H-K, the dense kernel, the speckle kernel L and
     the rectify kernel N no FFMA or DFMA; the
     dense kernel's pair call against its plain version at plane radius
     8 and 9 (its instantiation with the radius at run time); the dense
     kernel's pair call against its plain version on the batched node's 8
     frames, its time there and at the node's shape, its bound for both
     views (the bound a view at a time, summed, beside it) and the
     candidates a pixel and warp steps of each view (dense_work); the
     support kernel (from the descriptors' rows, as the nodes run it)
     against its plain version on the batched node's 8 frames, its time
     there and at the node's shape, its bound
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
     W = 1280, config 3's B = 4 at 1280x960), and E and F past D = 256 (D
     = 320 and 512, their second paths); (b)
     sgm_match_batch on the card against the CPU's plain path on both
     golden scenes at D = 64 and 128, with the pooled RMSE and mask
     agreement against libelas; (c) the SGM node, make_pipeline() at
     640x480: process_frame on 9 synthetic pairs, stage medians, fps, idle
     share; process_batch_fused at batch 4 against process_frame;
     StreamingRunner at batch 4 over 48 frames; the SGM stages of one
     frame; (d) BASELINE config 3, process_batch_fused at 1280x960, D = 64,
     B = 4, and its stages each alone (rectify, D, O1, E, F, O2, the scan;
     O1's and O2's plain versions beside them); each of these four paths
     with the launch counters of D, E, F, O1, O2 (once a frame or a batch),
     N (rectify: 9, 1, 12, 1) and P1-P3 (the scan P1 as N, P2 and P3
     never) set to 0 just before and read just after, and rectify beside
     its plain version; (e) each kernel against
     its plain version (torch.equal), its device time, its plain version's
     and its bound (and E's bound as counted before its 16-bit lanes) at
     the node's shape and at config 3's (D's bound at its byte lanes' 26
     instructions a pixel, the unpacked 48 beside it), and E's device
     memory a call; a time below its bound fails; (f) E's and F's D > 256
     paths at the node's shape, D = 512: against their plain versions,
     their device times, the plain versions' and their bounds;
  7. BM and gen_pcl: (a) kernel G against its plain twin (torch.equal) on
     both golden pairs at D = 64 and 256 and on seeded awkward shapes
     (W = 2000, W % 64 != 0, D past G's strip, H and W under 32, fewer rows
     than the window, windows 1 to 21, B = 32 batches in G's 64-column
     strip, G's path without shared memory at D = 320 and 512 and at the
     windows its strip cannot hold: 255 at D = 64 on 300x640, 75 at D =
     256, 227, and 257 on a 0/255 pair whose costs pass 1 << 24); (b)
     the BM node, make_pipeline(engine="bm") at 640x480, D = 64:
     process_frame on 9 synthetic pairs (stage medians, fps, idle share),
     process_batch_fused at batch 8 against process_frame, StreamingRunner
     at batch 8 over 48 frames; (c) BASELINE config 5, the headline:
     process_batch_fused_pcl at B = 32 on the golden scenes interleaved
     (fps, peak memory, its device time on CUDA events and idle share, its
     stages), its maps against process_batch_fused's,
     one frame's cloud (points exact) and scan against the CPU's and G
     against its plain twin on the rectified batch; (d) bench_bm256's
     process_batch_fused at B = 16, D = 256, and G against its plain twin
     on that rectified batch; each of these paths with G's, S's, N's and
     P1-P3's and cloud_scan's launch counters set to 0 just before and
     read just after (G and N 9, 1, 6, 1, 1; S 0 on every one: G's strip
     applies the texture gate and writes the u8 map; the scan P1 9, 1, 6,
     0, 1;
     config 5's fused cloud and scan once, never elsewhere; P2 and P3
     never), and rectify beside its
     plain version (7b, 7c); (e) BM-64's RMSE and mask agreement against libelas D1; (f) G's
     device time, its plain twin's and its bound (and the bound as counted
     before G's packed instructions) at the node's shape, at D = 256, at
     D = 512 (its D > 256 path), at window 255 (its path without shared
     memory), at config 5's and at bench_bm256's, a
     time below its bound failing, at the last two beside G' "full32"
     (32-column strips), and G' (the per-part timing) in its five modes;
     (G with S's gate folded in is timed in phase 17);
  9. the node shell, the CLIs a user runs (cli/point_cloud.main in this
     process at 640x480 on ELAS): (a) per frame over 9 frames of the
     synthetic stream (synthetic:9) and of an NPZ replay of phase 4's
     calibrated pairs, maps against process_frame's (torch.equal), scans
     within relative 1e-5, A called once a frame and B launched once a
     frame on the replay (the synthetic stream's rectified frames give
     ELAS fewer than 3 support points, so B does not run there), the
     median logged dmap time and the frame loop's fps from the CLI's
     per-frame lines; (b) --batch 8 over 48 and 240 frames of the replay
     (the stream scheduler): A, B and C once a batch, the fps the
     CLI prints; (c) -m --phi --trans on the replay: scans against
     process_frame's after update_extrinsics, and unlike (a)'s; (d) the
     navigate CLI on (a)'s scans; each CLI call with the launch counters
     (A, B, C, N, rectify, the scan P1, R and A with Q's epilogue: once a
     frame or a batch; P2, P3 and Q alone never) set to 0 just before it
     and read just after, and
     rectify beside its plain version; one JSON line;
  10. ELAS subsampling and the exact scan (subsampling_phase): kernel A on
     half-resolution descriptors and kernel B under subsampling against
     their plain twins; the card's subsampled elas_match against libelas's
     final_D1 and against the CPU's, with A's, B's, H's, R's and Q's
     launch counters set to 0 just before and read just after (H once a
     call: under subsampling the check runs on the kept even pixels,
     after B; R on half-resolution descriptors and A with Q's epilogue at
     the even step once a call, Q alone never); the
     card's exact float64 scan (kernel V: once a call, one read, its DFMA
     as at -fmad=false, its time against its bound) against the CPU's on
     phase 4's 9 maps at 640x480 and EXACT_SCAN_EDGE_CASES; one JSON line;
  11. the multi-device paths on meshes of this one card repeated
     (multidevice_phase): DP SGM and DP BM against process_batch_fused,
     TP BM (kernels T1 once a rank, T2 and S once a row, no other ATen
     op on the card; TP_CARD_CASES) against the plain TP path on the card
     and bm_match, T1 and T2 against their twins and their bounds, the
     ELAS replicas against
     the single-device batched path and libelas, each with the launches of
     its kernels pinned (D, O1, E, F, O2 or G once a shard, S never
     there, S once a row of TP BM, R and A with Q's epilogue once a
     replica, M1 and M2's one launch once a chunk),
     entry.dryrun_multichip(8);
     the filters, linalg,
     the experiments and the coefficient-wire raster against the CPU; host
     times beside the single-device calls (no scaling: one card); one
     JSON line;
  12. the ELAS postprocess kernels (postprocess_phase): H (L/R check), I
     (gap interpolation), J (adaptive mean) and K (median) against their
     plain versions, torch.equal and int32 bits, on
     chip_smoke.POST_EDGE_CASES, the golden 640x480 maps and the node's and
     batched node's dense maps; the MIDDLEBURY preset's elas_match (K's
     path) against libelas with H-K's launches pinned (H none: B's L/R
     epilogue launches once; K one launch); postprocess_batch on the
     node's frame against the CPU;
     H-K's times at the node's shape beside their plain versions' and
     their byte bounds, with the kernel launches a call (one each), and
     I's scan design on MIDDLEBURY's gaps over both views (B = 2); (d)
     kernel B with the L/R epilogue against its plain version and timed
     beside B alone, B then H and H alone at the node's and the batched
     node's shapes, with B's bound, and the blocks an SM of B's two
     instantiations; one JSON line;
  13. the speckle filter (kernel L) and rectify (kernel N)
     (speckle_remap_phase): L against its plain versions, maps and labels
     bit for bit, on chip_smoke.SPECKLE_EDGE_CASES and the node's and
     batched node's maps after the L/R check at t = 0, 1 and 12, one
     cooperative kernel launch a call, its launch plans (B = 16 spills
     tiles past its blocks' shared memory); N against its plain version
     (torch.equal) on chip_smoke.REMAP_EDGE_CASES (its staged and global
     tiles in one launch among them), phase 4's raw pairs, config 5's
     frames and config 5's colour call (F = 96), one launch a pair call,
     its tiles counted by path; their times at the nodes' shapes beside
     their plain versions', their byte bounds, the colour call, the BFS
     hop L replaced and L's split by phase (the first block's clock64 at
     each grid barrier); one JSON line;
  14. the scan and the cloud (scan_phase): kernels P1 (scan from a u8
     map), P2 (the cloud), P3 (scan from points) and cloud_scan (P2 with
     P3 as its epilogue, the gen-pcl paths' one launch) against their
     plain versions on the card (NaN masks equal, torch.equal otherwise;
     rgb bits and valid masks torch.equal; one launch a call; cloud_scan's
     scan also against P3 on P2's cloud) on chip_smoke.SCAN_EDGE_CASES
     (NaN and +-inf points, points a few ulps about every bin edge at
     three fields of view, bin 90, the ground threshold, empty and
     all-ground sets, B = 1, 8 and 32, a width that is no multiple of 32,
     crop offsets, colour present and absent, a cache that accepts d = 0,
     and the flush cases: every pair of subnormal, zero, tiny and unit
     operand classes, the ground gate at a zero threshold, maps whose
     reprojection flushes), on phase 4's 9 maps and on config 5's batch;
     their FFMA counts against the same source built with -fmad=false (no
     contraction; the FFMAs are the written __fmaf_rn and those inside
     division and square root); no host read inside a call
     (torch.cuda.set_sync_debug_mode), one kernel and no fill a call under
     torch.profiler, the cached scratch zero after the calls; their times
     beside their plain versions' and their bounds (scan_work) at the
     node's shape (P1 at B = 1 and 8, and on a map whose every pixel is
     rejected) and config 5's (P2 with and without colour, P3, cloud_scan
     with and without colour), the scan and cloud stages on the host
     clock, and probes of the card's scatter_reduce at NaN and of the bin
     index the plain version computed before (scan_probes); one JSON
     line;
  15. the ELAS front (front_phase): kernel R (the descriptor, through
     its pair entry), A's keys (support.grid_row_keys), A with Q's tests
     as its epilogue (support.support_candidates) and Q alone against
     their plain versions (torch.equal) on the golden pairs, phase 4's 9
     frames, the batched node's 48, every SUPPORT_EDGE_CASES shape,
     chip_smoke.FRONT_EDGE_CASES, R alone on DESCRIPTOR_EDGE_SHAPES and
     the subsampled frames, at A's plans R = 1 and R > 1; each library's
     FFMA count equal to its -fmad=false build's; the ATen ops of one
     create_descriptor_pair and one support_candidates call on the card
     (allocations and views only); the times of R and of A with its
     epilogue (A alone, A then Q and Q alone beside them) with their plain
     versions' and bounds (R by bytes; A with its epilogue A's operations
     plus Q's bytes, epilogue_work) at the per-frame and batched nodes'
     shapes, a time below its bound failing; one JSON line;
  16. the batched prior's coefficient table and candidate grids
     (prior_phase): kernels M1 (the table and the tile lists) and M2 (the
     grid words) in their one launch (device_prior.coeff_grid) against
     their plain versions (torch.equal) on phase 2b's chunks of the golden
     pair, phase 4b's batched node's chunks and
     chip_smoke.PRIOR_EDGE_CASES (degenerate and tied triangles, d > u,
     pad rows, D = 100, grids of 3 x 2 cells and of 2 rows, 2112 cells a
     row, the batched node's chunk size); the ATen ops of one
     _chunk_coeffs call (allocations and views only, one launch); the
     launch's FFMA and DFMA counts against a -fmad=false build; its time
     beside the plain versions' and against the bounds (prior_work), a
     time below its bound failing, and the stage on the host clock; one
     JSON line (phases 2b, 4b, 9 and 11 pin the launch once a chunk);
  17. the SGM and BM tails (tail_phase): kernels O1 (the census cost
     volume, both views from one launch), O2 (the SGM epilogue: uniqueness,
     sub-pixel, L/R, u8), S (the BM texture gate and u8 map) and G with
     S's work folded in (ops/bm_kernel.bm_match_gated: the gated map, dR
     and the u8 map) against their plain versions (torch.equal) on phase
     6's golden pair (D = 64 and 128, with and without true_right), node
     frames and config 3's batch, phase 7's golden pair, node frames,
     config 5's and bench_bm256's batches, chip_smoke.TAIL_EDGE_CASES and
     (G with the gate, its launches of G and S pinned a call)
     chip_smoke.GATE_FOLD_CASES and a 640x480 frame at D = 320 (past G's
     strip: G then S); kernel D's pair entry against its batch entry; the
     ATen ops of one sgm_match_batch call and one BM _match_batch call on
     the card (allocations and views only; O1, O2, G once, S never); O1's,
     O2's and G's FFMA counts against a -fmad=false build; their times
     beside their plain versions' and their bounds (tail_work, gated_work)
     at the node's shape and config 3's (O1, O2) or config 5's and
     bench_bm256's (G with the gate, beside G alone and G then S in the
     same run; S alone, and at D = 320), a time below its bound failing;
     one JSON line (phases 6c, 6d, 7b, 7c and 11 pin them);
  18. the ELAS paths without eager ops and the ELAS options
     (elas_eager_phase): the ATen ops that one call of the ELAS node's
     process_frame, the MIDDLEBURY elas_match and u8 route, a batched
     chunk with the u8 sink and the batched u8 route dispatch on the card,
     only copies and the content order's index_selects, pinned
     (ELAS_EAGER_PINS), C and elas_u8 counted; elas_match with
     use_native=False and return_debug=True and post.postprocess on the
     card against the CPU on a node frame; the node's u8 routes against
     the CPU's; one JSON line (phase 12 holds I, J, K with their u8
     epilogue and out rows and elas_u8 against dmap_u8, and times the tail
     with and without the u8 map);
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
        cuda_lib.launch(lib.sad_rate, "sad_rate", out, out.data_ptr(), blocks,
                        threads, iters, 12345)
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


def support_work(B, nv, W, disp_min, D):
    """(bytes, instructions, the old count in byte SADs) of the support
    function at B frames of nv grid rows of W columns. Bytes: the inputs
    (the two descriptor rows of each grid row, both views) read once, the
    four key maps written once. Instructions, the least the function needs: 8 __vsadu4
    for each S(x, d) that some live key reads (its taps enumerated d by d:
    x = c-2 and c+2 of the left view's live columns, c+d-2 and c+d+2 of
    the right view's) and 3 for each live (c, d, view): the best-two
    update with the key's add fused into __viaddmax_s32 and
    __viaddmin_s32, then a min (csrc/support_kernel.cu). The old count: the
    64 byte SADs of every live (c, d, view), at the measured byte SAD
    rate."""
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
    nbytes = 2 * rows * W * 32 + 4 * 4 * rows * W
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
    """(bytes, operations by type, the old count, live slots) of one side's
    raster on these inputs: the table, the tile lists and the decoded maps
    (4 bytes a pixel) each moved once. A live slot names a row of its frame other than the pad
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
        operations: the clamp, the key and the maximum;
      per pixel of the image: the decode of its key into the three maps
        the kernel stores (6 integer operations: the covered test, the
        shift, mask and offset of d_plane, its select, the valid bit).
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
           "int": 10 * n_cols + 6 * n_pix + 6 * CH * H * W,
           "cvt": 4 * n_slots + 3 * n_cols + n_pix}
    # the maps written: d_plane (2 bytes), valid and covered (1 each)
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


def support_edge_images(name):
    """(left, right, disp_min, D) of one of SUPPORT_EDGE_CASES, u8 [B, H, W]
    from a seed: a random frame and the same frame shifted by 9 columns (a
    true disparity of 9) at the node's shape, the batched node's B = 8,
    wide frames at D = 512 (at W = 4096 the kernel's shared table holds
    fewer d a chunk), W < D (the right view's top d are dead), disp_min
    near D, an odd width; and, for the constant descriptors, constant
    frames."""
    i = SUPPORT_EDGE_CASES.index(name)
    B, H, W, disp_min, D = ((1, 480, 640, 0, 256), (8, 480, 640, 0, 256),
                            (1, 40, 2112, 0, 512), (1, 30, 4096, 0, 512),
                            (1, 60, 200, 0, 256), (1, 60, 640, 250, 256),
                            (2, 60, 333, 4, 131), (1, 480, 640, 0, 256))[i]
    if name.startswith("constant"):
        left = np.full((B, H, W), 7, np.uint8)
        return left, left.copy(), disp_min, D
    rng = np.random.default_rng(60 + i)
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    return left, np.roll(left, -9, 2), disp_min, D


def support_edge_case(name, dev):
    """(desc1, desc2, disp_min, D) of one of SUPPORT_EDGE_CASES on dev: the
    descriptors of support_edge_images' frames; for the constant case
    descriptors of 7 everywhere, where every cost ties."""
    import torch
    from jackal_tpu_torch.ops.descriptor import create_descriptor

    left, right, disp_min, D = support_edge_images(name)
    if name.startswith("constant"):
        d = torch.full(left.shape + (16,), 7, dtype=torch.uint8, device=dev)
        return d, d.clone(), disp_min, D
    return (create_descriptor(torch.from_numpy(left).to(dev)),
            create_descriptor(torch.from_numpy(right).to(dev)), disp_min, D)


def support_keys_held(hold, label, d1, d2, step, disp_min, D):
    """Kernel A from the descriptors' rows (grid_row_keys) against its
    plain version, grid_row_blocks then support_keys_plain; returns the
    kernel's keys."""
    from jackal_tpu_torch.matching.elas import support as sm

    ncv = -(-d1.shape[1] // step)
    keys = sm.grid_row_keys(d1, d2, step, disp_min, D)
    hold("support", label, tuple(keys),
         sm.support_keys_plain(sm.grid_row_blocks(d1, step, ncv),
                               sm.grid_row_blocks(d2, step, ncv), disp_min,
                               D))
    return keys


# the ELAS front's edges, kernels R (descriptor) and Q (support epilogue):
# tests/test_torch_front_kernels.py holds the plain versions against the
# JAX package on them, tests/test_torch_cuda.py and phase 15 the kernels
# against the plain versions. name: (B, H, W, ElasParams fields)
FRONT_EDGE_CASES = {
    "odd W": (1, 40, 101, dict(disp_max=30)),
    # (ncv - 1) * step + 3 > H: the last grid row's vs + 2 is past the image
    "H where the grid rows pad": (1, 42, 80, dict(disp_max=30)),
    "half resolution, even H": (1, 44, 90, dict(disp_max=30,
                                                subsampling=True)),
    "half resolution, odd H": (1, 45, 90, dict(disp_max=30,
                                               subsampling=True)),
    "disp_min > 0": (1, 40, 120, dict(disp_max=40, disp_min=7)),
    "W < D": (1, 35, 60, dict(disp_max=80)),
    "B = 3, frames that differ": (3, 30, 70, dict(disp_max=24)),
    "constant images": (2, 30, 64, dict(disp_max=20)),
    # the grid rows' vs - 2 is above the image at step 1
    "candidate step 1": (1, 24, 50, dict(disp_max=20, candidate_stepsize=1)),
    # kernel R's warp strips (26 columns) and row bands (8 rows) cut
    # mid-way: W % 16 of 1, 3 and 15, H ending mid-band, frames whose rows
    # start off 16-byte boundaries (H * W odd, B > 1), with half_resolution
    # off and on (W < 16 and smaller frames, which hold no support point:
    # DESCRIPTOR_EDGE_SHAPES)
    "W % 16 = 1": (1, 40, 97, dict(disp_max=30)),
    "W % 16 = 3, half resolution": (1, 40, 99, dict(disp_max=30,
                                                    subsampling=True)),
    "W % 16 = 15, frames off 16-byte rows": (2, 37, 79, dict(disp_max=24)),
    "W % 16 = 15, half resolution": (1, 41, 47, dict(disp_max=20,
                                                     subsampling=True)),
    "H ends mid-band": (1, 14, 64, dict(disp_max=20)),
    "H ends mid-band, half resolution": (2, 13, 50, dict(disp_max=20,
                                                         subsampling=True)),
    # the grid row 0 / key row 0 pairing and the last key row: at step 2
    # the last grid row's vs + 2 is past the image ((ncv - 1) * 2 + 2 >= H),
    # at step 1 both the first row's vs - 2 and the last's vs + 2
    "step 2, the last grid row past the image": (
        1, 21, 60, dict(disp_max=20, candidate_stepsize=2)),
    "step 1, B = 3 frames off 16-byte rows": (
        3, 13, 45, dict(disp_max=20, candidate_stepsize=1)),
    "step 2, half resolution": (1, 26, 70, dict(
        disp_max=24, subsampling=True, candidate_stepsize=2)),
    # A's epilogue at R = 1 (one chunk of d) on a row whose four key maps
    # do not fit the staging planes (W > 1616): it reads the keys back
    # from the out array
    "R = 1 past the staging planes: W = 2000, D = 16": (
        1, 30, 2000, dict(disp_max=15)),
}


# kernel R alone at the edges of its warp strips and row bands, where no
# support point can be (W < 16, a few rows): (N, H, W), each with
# half_resolution off and on (tests/test_torch_front_redesign.py holds the
# plain version against the JAX package on them,
# tests/test_torch_cuda.py and phase 15 the kernel)
DESCRIPTOR_EDGE_SHAPES = ((1, 20, 13), (1, 21, 11), (3, 33, 15), (2, 15, 17),
                          (1, 50, 19), (2, 9, 64), (1, 3, 5), (1, 1, 1),
                          (2, 31, 27), (1, 70, 131))


def front_edge_images(name):
    """(left, right, ElasParams fields) of one of FRONT_EDGE_CASES: u8
    [B, H, W] noise from a seed and the same noise shifted by 4 + 3b
    columns in frame b (a true disparity), or constant frames (77 and
    200)."""
    B, H, W, kw = FRONT_EDGE_CASES[name]
    rng = np.random.default_rng(sorted(FRONT_EDGE_CASES).index(name) + 70)
    if name == "constant images":
        left = np.full((B, H, W), 77, np.uint8)
        left[1] = 200
        return left, left.copy(), kw
    left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    right = np.stack([np.roll(left[b], -(4 + 3 * b), axis=1)
                      for b in range(B)])
    return left, right, kw


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


def sgm_stages(pipe, left, right) -> dict:
    """Host-clock times (median of 5) of the SGM engine's stages, each
    alone, on rectified uint8 [B, H, W] batches, the scan on the map: the
    kernels D, O1, E, F with O2 folded in (the path's) and P1, F and O2
    alone, and O1's and O2's plain versions beside them."""
    import torch
    from jackal_tpu_torch.ops import sgm_kernel as sk

    p = pipe.sgm_params
    D, B = p.disp_num, left.shape[0]
    st = {"census (kernel D, both views, one launch)": host_ms(
        lambda: sk.census5x5_pair(left, right), 5)}
    codes = sk.census5x5_pair(left, right)
    cl, cr = codes[:B], codes[B:]
    st["cost volume (kernel O1)"] = host_ms(
        lambda: sk.sgm_cost_volume(cl, cr, D), 5)
    st["cost volume, plain version"] = host_ms(
        lambda: sk.sgm_cost_volume_plain(cl, cr, D), 3)
    cost = sk.sgm_cost_volume(cl, cr, D)
    st["aggregation (kernel E)"] = host_ms(
        lambda: sk.aggregate_paths_bhdw(cost, p), 5)
    S = sk.aggregate_paths_bhdw(cost, p)
    del cost
    st["WTA maps + epilogue + u8 (F with O2 folded in, one launch; the "
       "path's)"] = host_ms(lambda: sk.sgm_wta_epilogue(S, p, u8=True), 5)
    st["WTA maps (kernel F alone)"] = host_ms(lambda: sk.sgm_wta_maps(S), 5)
    m = sk.sgm_wta_maps(S)
    del S
    st["epilogue (kernel O2 alone: uniqueness, sub-pixel, L/R, u8)"] = host_ms(
        lambda: sk.sgm_epilogue(m, None, D, p, u8=True), 5)
    st["epilogue, plain version"] = host_ms(
        lambda: sk.sgm_epilogue_plain(m, None, D, p, u8=True), 5)
    dm = sk.sgm_epilogue(m, None, D, p, u8=True)[2]
    torch.cuda.synchronize()
    st["scan (kernel P1)"] = host_ms(lambda: pipe._scan_stage(dm), 5)
    return st


def sgm_phase(dev, hold):
    """Phase 6: kernels D, E, F against their plain versions, the card's
    SGM against the CPU's on the golden scenes, the SGM node, BASELINE
    config 3 and the kernels' times. Returns (the kernels' JSON entries,
    the inputs phase 17 holds O1 and O2 on: rectified node frames, config
    3's batch, the golden pair, O1's and O2's launches on the node)."""

    import torch
    from jackal_tpu_torch.config import PipelineParams, SGMParams
    from jackal_tpu_torch.geometry import remap
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
                           (1, 40, 6, 100, {}), (1, 33, 97, 192, {}),
                           # E's and F's D > 256 paths
                           (1, 40, 400, 320, {}), (2, 24, 600, 512, {}),
                           (1, 24, 600, 512, {"p1": 6000, "p2": 100000})):
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
          "lines shorter than the ring, H and W under 32, D > W; E and F "
          "past D = 256 at D = 320 and 512)")

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
    def counted(label, fn, rect):
        """fn() with the counters of D, O1, E, F, O2, N and P1-P3 set to 0
        just before and read just after: (its result, the counts of D, O1,
        E, F, O2); raises if D or E was launched no time, or O1, F (with
        O2 folded in), N (rectify, both views in one launch) and P1 (the
        scan) other than ``rect`` times (once a frame or a batch), O2, P2
        or P3 at all."""
        for k in sk.launches:
            sk.launches[k] = 0
        remap.launches["remap"] = 0
        reset_scan()
        out = fn()
        pin_scan(f"6c. {label}", scan=rect)
        n = dict(sk.launches)
        nr = remap.launches["remap"]
        print(f"6c. launches of {label}: {n}, kernel N (rectify) {nr}")
        if min(v for k, v in n.items() if k != "sgm_epilogue") == 0:
            raise AssertionError(f"{label} bypassed a kernel: {n}")
        if nr != rect or any(n[k] != rect for k in ("sgm_cost", "sgm_wta")) \
                or n["sgm_epilogue"] != 0:
            raise AssertionError(f"{label}: kernels N, O1, F (with O2 "
                                 f"folded in), O2 launched {nr}, {n}, not "
                                 f"{rect}, {rect}, {rect}, 0")
        return out, n

    pipe.process_frame(*pairs[0])                       # warm-up
    results, walls = [], []

    def frames():
        for lr, rr in pairs:
            t = time.perf_counter()
            results.append(pipe.process_frame(lr, rr, timing=True))
            walls.append(time.perf_counter() - t)
    _, launches = counted(f"the SGM node, process_frame over {len(pairs)} "
                          f"frames", frames, len(pairs))
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
                            lambda: pipe.process_batch_fused(lb, rb), 1)
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
                                  f"{n_frames} frames", timed_stream,
                                  n_frames // batch)
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
    l1, r1 = (torch.from_numpy(x[:1]).to(dev) for x in (lb, rb))
    st["rectify (kernel N, both views, one launch)"] = host_ms(
        lambda: pipe._rectify_crop(l1, r1), 5)
    st["rectify, plain version"] = host_ms(
        lambda: (remap.remap_bilinear_plain(l1, *pipe.lmap),
                 remap.remap_bilinear_plain(r1, *pipe.rmap)), 5)
    st.update(sgm_stages(pipe, lt, rt))
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
            lambda: big.process_batch_fused(l3, r3), 1)
    ms3 = host_ms(lambda: big.process_batch_fused(l3, r3), 5)
    torch.cuda.reset_peak_memory_stats(dev)
    big.process_batch_fused(l3, r3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"6d. BASELINE config 3 (process_batch_fused {W3}x{H3}, D={D}, "
          f"B={B3}): {ms3:.3f} ms a batch = {B3 * 1e3 / ms3:.2f} fps; peak "
          f"device memory {peak:.2f} GiB")
    # its stages, each alone
    L3, R3 = big._rectify_crop(l3, r3)
    st3 = {"rectify (kernel N, both views, one launch)": host_ms(
        lambda: big._rectify_crop(l3, r3), 5)}
    st3.update(sgm_stages(big, L3, R3))
    for k, v in st3.items():
        print(f"  config 3 stage {k}: {v:.3f} ms")
    print("config 3 stages: " + json.dumps({k: round(v, 4)
                                            for k, v in st3.items()}))

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
    # (f) E's and F's D > 256 paths at the node's shape, D = 512
    Dw = 512
    pw = dataclasses.replace(p, disp_num=Dw)
    cd = sk.census5x5_batch(torch.cat([lt, rt]))
    cw = sgm.census_cost_volume_hdw(cd[:1], cd[1:], Dw)
    Sw = sk.aggregate_paths_bhdw(cw, pw)
    wide = {}
    for kname, fn, plain in (
            ("sgm_paths", lambda: sk.aggregate_paths_bhdw(cw, pw),
             lambda: sk.aggregate_paths_bhdw_plain(cw, pw)),
            ("sgm_wta", lambda: sk.sgm_wta_maps(Sw),
             lambda: sk.sgm_wta_maps_plain(Sw))):
        hold(kname, f"{kname} D > 256 path at 640x480 D={Dw}", [fn()],
             [plain()])
        k_ms = events_ms(fn, 5)
        p_ms = events_ms(plain, 1, spin=False)
        nb, ops = sgm_work(kname, 1, 480, 640, Dw)
        b_ms, by = bound_ms(nb, ops, ops_rate)
        wide[kname] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": by}
        print(f"6f. {kname}, its D > 256 path at the node's shape (B=1, "
              f"480x640, D={Dw}): == plain (torch.equal); device ms a call "
              f"{k_ms:.4f} (CUDA events, calls queued behind a spin); plain "
              f"{p_ms:.3f}; bound {b_ms:.5f} by {by} ({nb} bytes, "
              f"{ops:.6g} instructions)")
        if k_ms < b_ms:
            raise AssertionError(f"{kname} at D={Dw}: {k_ms} ms is below "
                                 f"its bound {b_ms} ms")
    del cw, Sw
    print(json.dumps({"d_past_256": wide}))
    tail = {"node": (lt, rt), "node batch": pipe._rectify_crop(
        torch.from_numpy(lb).to(dev), torch.from_numpy(rb).to(dev)),
            "config 3": (L3, R3), "golden": (gl, gr),
            "node launches": launches,
            # F's entry: its times come from phase 17, F as the node runs
            # it, with O2 folded in
            "entry": {"name": "sgm_wta", "route": "cuda",
                      "source": "jackal_tpu_torch/csrc/sgm_wta_kernel.cu",
                      "replaces": "jackal_tpu/ops/pallas/sgm_kernel.py:415",
                      "launches": launches["sgm_wta"],
                      "alone_ms": out["sgm_wta"][0],
                      "alone_plain_ms": out["sgm_wta"][1],
                      "alone_bound_ms": out["sgm_wta"][2],
                      "library_ms": None}}
    srcs = {"census": ("census_kernel", 327), "sgm_paths":
            ("sgm_paths_kernel", 64)}
    return [{"name": k, "route": "cuda",
             "source": f"jackal_tpu_torch/csrc/{srcs[k][0]}.cu",
             "replaces": f"jackal_tpu/ops/pallas/sgm_kernel.py:{srcs[k][1]}",
             "launches": launches[k], "ms": out[k][0], "plain_ms": out[k][1],
             "bound_ms": out[k][2], "bound_by": out[k][3],
             "library_ms": None} for k in ("census", "sgm_paths")], tail


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


def binary_pair(seed=0, H=270, W=290, density=0.002):
    """A seeded 0/255 pair (uint8 [H, W] each) whose absolute differences
    are 255 nearly everywhere: a left image of 255 with sparse 0s and a
    right one of 0 with sparse 255s. At window 257 its real costs pass
    1 << 24 where the box lies inside the frame."""
    rng = np.random.default_rng(seed)
    left = np.where(rng.random((H, W)) < density, 0, 255).astype(np.uint8)
    right = np.where(rng.random((H, W)) < density, 255, 0).astype(np.uint8)
    return left, right


def bm_phase(dev, hold):
    """Phase 7: kernel G against its plain twin, the BM node, BASELINE
    config 5 (BM + gen_pcl) and bench_bm256's configuration, BM's accuracy
    against libelas, G's times and G''s parts. Returns what phase 17 holds
    G with the gate and S on: rectified node frames, the golden pair,
    config 5's and bench_bm256's rectified batches, G's launches on the
    node ("node launches"; S's are pinned at 0) and G's kernels-line
    entry, which phase 17 completes with the node's times."""
    import torch
    from jackal_tpu_torch.config import BMParams, PipelineParams
    from jackal_tpu_torch.geometry import remap
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
                                   (32, 330, 333, 33, 1, 3),
                                   # G's path without shared memory: D >
                                   # 256, then windows the strip cannot
                                   # hold (past 255, past its shared
                                   # memory at D = 64 and 256)
                                   (1, 40, 400, 320, 9, 40),
                                   (2, 24, 600, 512, 5, 33),
                                   (1, 9, 560, 512, 21, 100),
                                   (1, 300, 640, 64, 255, 9),
                                   (1, 96, 320, 256, 75, 40),
                                   (2, 40, 300, 64, 227, 5)):
        left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
        p = BMParams(disp_num=D, window=win)
        sw = bk.strip_width((B, H, W), p)
        if B == 32 and sw != 64:
            raise AssertionError(f"G took a {sw}-column strip at B={B} "
                                 f"{H}x{W} D={D}, not 64")
        path = f"{sw}-column strip" if sw else "the path without shared memory"
        hold_bm(f"seeded B={B} {H}x{W} D={D} window {win} ({path})",
                torch.from_numpy(left).to(dev),
                torch.from_numpy(np.roll(left, -shift, axis=2)).to(dev), p)
    # window 257 on a 0/255 pair whose real costs pass the invalid cost
    # 1 << 24 (tests/test_torch_bm.py holds the plain twin against the
    # reference there)
    bl, br = (torch.from_numpy(x).to(dev)[None] for x in binary_pair())
    pb = BMParams(disp_num=64, window=257, uniqueness=1.0, lr_threshold=1000)
    hold_bm("a 0/255 pair at window 257, costs past 1 << 24", bl, br, pb)
    torch.cuda.synchronize()
    print("7a. kernel G == plain (torch.equal, both views) on the golden "
          "pair at 640x480 D=64 and 256 and on seeded frames (B=3, odd H "
          "and D, W % 64 != 0, W=1280 and 2000, windows 1, 3, 5, 7, 9 and "
          "21, D past the strip, H and W under 32, fewer rows than the "
          "window; B=32 at H % 64 != 0, W % 64 != 0, odd D, in the "
          "64-column strip; G's path without shared memory at D = 320 and "
          "512, windows 5, 9 and 21, and at windows the strip does not "
          "hold: 255 at D = 64 on 300x640, 75 at D = 256, 227 at D = 64 "
          "(B = 2), 257 on a 0/255 pair whose costs pass 1 << 24)")

    def counted(label, fn, want, rect, pcl=False):
        """(fn(), G's launches in it): G's, S's, N's and P1-P3's counters
        set to 0 just before and read just after; raises unless G (with
        the texture gate and u8 map folded in) was launched ``want`` times,
        S never, N (rectify, both views in one launch) ``rect`` times and,
        once a frame or a batch, P1 (the scan) or, where ``pcl``, the fused
        cloud and scan (P2 and P3 never)."""
        bk.launches["bm"] = bm.launches["bm_gate"] = 0
        remap.launches["remap"] = 0
        reset_scan()
        out = fn()
        if pcl:
            pin_scan(f"7c. {label}", fused=rect, key="config 5")
        else:
            pin_scan(f"7b. {label}", scan=rect)
        n, nr = bk.launches["bm"], remap.launches["remap"]
        ns = bm.launches["bm_gate"]
        print(f"7. launches of G (with the texture gate and u8 map) in "
              f"{label}: {n}; of kernel S alone: {ns}; of kernel N "
              f"(rectify): {nr}")
        if n != want or ns != 0 or nr != rect:
            raise AssertionError(f"{label}: G launched {n} times, not "
                                 f"{want}; S {ns}, not 0; N {nr} times, "
                                 f"not {rect}")
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
        len(pairs), len(pairs))
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
    l1, r1 = (torch.from_numpy(x).to(dev) for x in pairs[0])
    rect_k = host_ms(lambda: pipe._rectify_crop(l1, r1), 5)
    rect_p = host_ms(lambda: (remap.remap_bilinear_plain(l1, *pipe.lmap),
                              remap.remap_bilinear_plain(r1, *pipe.rmap)), 5)
    print(f"7b. rectify of one pair alone, host clock (median of 5): kernel N"
          f" {rect_k:.3f} ms, plain version {rect_p:.3f} ms")
    wall_p, busy, *_ = device_busy(
        lambda: [pipe.process_frame(lr, rr) for lr, rr in pairs[:3]])
    print(f"BM node device busy over 3 frames under torch.profiler: "
          f"{busy:.3f} ms of {wall_p:.3f} ms wall, idle share "
          f"{1 - busy / wall_p:.3f}")
    batch = 8
    lb = np.stack([pairs[i % len(pairs)][0] for i in range(batch)])
    rb = np.stack([pairs[i % len(pairs)][1] for i in range(batch)])
    (dm8, sc8), _ = counted(f"process_batch_fused at batch {batch}",
                            lambda: pipe.process_batch_fused(lb, rb), 1, 1)
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
                                  n_frames // batch, n_frames // batch)
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
        lambda: cfg5.process_batch_fused_pcl(l5, r5), 1, 1, pcl=True)
    if not torch.equal(dm5, cfg5.process_batch_fused(l5, r5)[0]):
        raise AssertionError("config 5 maps != process_batch_fused's")
    if cloud5[0].shape != (CONFIG5_B, 480 * 640, 3) \
            or not bool(torch.isfinite(sc5.scan).all()):
        raise AssertionError("config 5 output has the wrong shape")
    ms5 = host_ms(lambda: cfg5.process_batch_fused_pcl(l5, r5), 5)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg5.process_batch_fused_pcl(l5, r5)
    peak5 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # the call launches only the port's kernels (ctypes) and no ATen kernel;
    # torch.profiler records such windows unreliably in this long process
    # (none at all in three windows running, in two runs of this script;
    # tools/probe_profiler_window.py records every launch in a fresh
    # process), so its device time is CUDA events around calls queued
    # behind a spin: one stream, its kernels back to back
    busy5 = events_ms(lambda: cfg5.process_batch_fused_pcl(l5, r5), 5)
    print(f"7c. BASELINE config 5 (BM D=64 + gen_pcl, process_batch_fused_pcl"
          f" 640x480, B={CONFIG5_B}): {ms5:.3f} ms a batch = "
          f"{CONFIG5_B * 1e3 / ms5:.2f} fps (median of 5); peak device "
          f"memory {peak5:.2f} GiB; device busy {busy5:.3f} ms a call (CUDA "
          f"events behind a spin) of {ms5:.3f} ms wall, idle share "
          f"{1 - busy5 / ms5:.3f}; maps == process_batch_fused's")
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
    st["rectify (kernel N, both images, one launch)"] = host_ms(
        lambda: cfg5._rectify_crop(l5, r5), 5)
    st["rectify, plain version"] = host_ms(
        lambda: (remap.remap_bilinear_plain(l5, *cfg5.lmap),
                 remap.remap_bilinear_plain(r5, *cfg5.rmap)), 3)
    st["G with the texture gate and u8 map (kernel G)"] = host_ms(
        lambda: bk.bm_match_gated(L5, R5, p64), 5)
    st["G alone"] = host_ms(lambda: bk.bm_match_fused(L5, R5, p64), 5)
    dL5 = bk.bm_match_fused(L5, R5, p64)[0]
    st["texture gate + u8 alone (kernel S)"] = host_ms(
        lambda: bm.bm_gate_u8(L5, dL5, p64), 5)
    st["texture gate + u8, plain version"] = host_ms(
        lambda: bm.bm_gate_u8_plain(L5, dL5, p64), 5)
    st["cloud and its scan (fused kernel)"] = host_ms(
        lambda: cfg5._cloud_scan(dm5), 5)
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
            lambda: big.process_batch_fused(l16, r16), 1, 1)
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
    dl = bk.bm_match_gated(gl, gr, p64)[0]
    se, n, agree, tot = 0.0, 0, 0.0, 0
    for b, g in enumerate(gold):
        Dl, ref = dl[b].cpu().numpy(), g["D1"]
        both = (Dl >= 0) & (ref >= 0)
        se += float(((Dl[both] - ref[both]) ** 2).sum())
        n += int(both.sum())
        agree += float(((Dl >= 0) == (ref >= 0)).sum())
        tot += ref.size
    print(f"7e. BM D=64 (G with the texture gate) against libelas D1 on "
          f"{', '.join(GOLDEN)}, pooled: RMSE {np.sqrt(se / max(n, 1)):.6f} "
          f"px, mask agreement {agree / tot:.6f}")

    # (f) G's device time, its plain twin's and its bound; G''s parts
    ops_rate = int_ops_rate(dev)
    lt, rt = pipe._rectify_crop(torch.from_numpy(lb[:1]).to(dev),
                                torch.from_numpy(rb[:1]).to(dev))
    out = None
    for label, (li, ri), p in (("node", (lt, rt), p64),
                               ("D=256", (L5[:1], R5[:1]), p256),
                               ("D=512 (its D > 256 path)", (lt, rt),
                                BMParams(disp_num=512)),
                               ("window 255 (its path without shared "
                                "memory)", (lt, rt),
                                BMParams(disp_num=64, window=255))):
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
    tail = {"node": (lt, rt), "node batch": pipe._rectify_crop(
        torch.from_numpy(lb).to(dev), torch.from_numpy(rb).to(dev)),
            "golden": (gl, gr), "config 5": (L5, R5), "bm256": (L16, R16),
            "node launches": node_launches,
            "entry": {"name": "bm", "route": "cuda",
                      "source": "jackal_tpu_torch/csrc/bm_kernel.cu",
                      "replaces": "jackal_tpu/ops/pallas/bm_kernel.py:107",
                      "launches": node_launches, "ungated_ms": out[0],
                      "ungated_plain_ms": out[1], "ungated_bound_ms": out[2],
                      "library_ms": None}}
    return tail


# ---- kernel V: the exact float64 scan (phase 10c) ------------------------

# maps that meet the exact scan's edges (tests/test_torch_exact_scan_edges.py
# holds the CPU path to the JAX package on them, tests/test_torch_cuda.py and
# phase 10c kernel V to the CPU path)
EXACT_SCAN_EDGE_CASES = ("origin pixel", "X <= 0", "tied extrema",
                         "nothing accepted")
# the tied extrema's pixels: (u - cx, v - cy, d). (3, 1, 1) and (6, 2, 206)
# have the same float64 ratio Y / X and band but atan2 values an ulp apart,
# as (4, 3, 68) and (8, 6, 206) have: the least and the greatest angle are
# the first pixel of each pair by flat index, not the pair's least or
# greatest atan2
EXACT_SCAN_TIES = ((3, 1, 1), (6, 2, 206), (4, 3, 68), (8, 6, 206))


def exact_scan_edge_case(name):
    """(uint8 map [H, W], uint8 range [H, W, 2], Q, XR, XT (float64), crop
    offset x, y) of one of EXACT_SCAN_EDGE_CASES, from a seed. The
    calibration is exact: X = (u - cx) / d, Y = (v - cy) / d, Xr = X,
    Yr = Y. "origin pixel": the pixel at (cx, cy) has X = Y = 0 (bin 45,
    range 0); "X <= 0": three quarters of the columns lie at or left of
    cx (the angle's bands 0, 1, 3 and 4); "tied extrema": only
    EXACT_SCAN_TIES' pixels accepted; "nothing accepted": every range is
    empty (lo > hi)."""
    i = EXACT_SCAN_EDGE_CASES.index(name)
    rng = np.random.default_rng(100 + i)
    H, W = 24, 40
    cx, cy = {"X <= 0": (30, 12)}.get(name, (20, 12))
    dmap = rng.integers(1, 256, (H, W)).astype(np.uint8)
    valid = np.zeros((H, W, 2), np.uint8)
    valid[..., 0], valid[..., 1] = 1, 255
    if name == "nothing accepted":
        valid[..., 0], valid[..., 1] = 255, 0
    if name == "tied extrema":
        valid[..., 0], valid[..., 1] = 255, 0
        for dx, dy, d in EXACT_SCAN_TIES:
            dmap[cy + dy, cx + dx] = d
            valid[cy + dy, cx + dx] = d
    Q = np.array([[1, 0, 0, -cx], [0, 1, 0, -cy], [0, 0, 0, 100],
                  [0, 0, 1, 0]], np.float64)
    return dmap, valid, Q, np.eye(3), np.zeros(3), 0, 0


def exact_scan_work(n_px: int, accepted: int, midpoint: int):
    """(bytes, float64 operations) of kernel V on a map of n_px pixels:
    the map and its range in (3 bytes a pixel) and the int64 output out
    (csrc/exact_scan_kernel.cu); 45 float64 operations an accepted pixel as
    written (the Q rows 4 x 6, three quotients, the two robot rows 2 x 6,
    the range's two products, sum and root, the ratio) and 94 more a pixel
    that ran the midpoint tests (two error-free products of 17 each and
    13 more a test, two tests)."""
    from jackal_tpu_torch.scan.exact_scan import N_OUT

    return 3 * n_px + 8 * N_OUT, 45 * accepted + 94 * midpoint


# ---- kernels T1, T2: TP BM's shard (phase 11b) ---------------------------

# the pairs of TP BM's cases (tests/test_torch_tp_partials.py holds the
# plain twins of T1 and T2 to the JAX package's bm_match_tp on them at
# 48x96, tests/test_torch_cuda.py the kernels to the twins)
TP_PAIR_KINDS = ("seeded", "rank edges", "ties across ranks")


def tp_pair(kind, B, H, W, D, ranks, seed=0, band=4):
    """uint8 (left, right) [B, H, W] and the uniqueness factor of a TP BM
    case. "seeded": a random left frame, the right one shifted by a random
    disparity a band of ``band`` rows (a window much taller than a band
    finds no unique d); "rank edges": shifted by the first and last
    d of the ranks' ranges in turn (Dl = D // ranks), so many best d lie on
    a range's edge; "ties across ranks": rows periodic with period Dl, so
    a cost repeats Dl disparities on, in the next rank's range, the
    uniqueness factor 1.5 so that tied pixels stay (ties go to the
    smaller d)."""
    rng = np.random.default_rng(seed + 17 * TP_PAIR_KINDS.index(kind))
    Dl = D // ranks
    if kind == "ties across ranks":
        left = np.tile(rng.integers(0, 256, (B, H, Dl)),
                       (1, 1, -(-W // Dl)))[..., :W].astype(np.uint8)
    else:
        left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    if kind == "rank edges":
        shifts = sorted({0, ranks * Dl - 1} | {e for k in range(1, ranks)
                                             for e in (k * Dl - 1, k * Dl)})
    else:
        shifts = list(rng.integers(0, D, 8))
    right = left.copy()
    for i, v in enumerate(range(0, H, band)):
        s = int(shifts[i % len(shifts)])
        right[:, v:v + band] = np.roll(left[:, v:v + band], -s, 2)
    return left, right, 1.5 if kind == "ties across ranks" else 0.85


# phase 11b's cases at 640x480, (D, data rows, disp ranks, frames,
# window): D = 64 on 2 x 2 and 1 x 4, D = 256 on 1 x 8, D = 30 on 1 x 4
# (Dl = 7: d = 28 and 29 scored by no rank), and a window past G's strip
# (227) on 1 x 4 (tests/test_torch_cuda.py runs them too)
TP_CARD_CASES = ((64, 2, 2, 2, 9), (64, 1, 4, 2, 9), (256, 1, 8, 1, 9),
                 (30, 1, 4, 2, 9), (64, 1, 4, 2, 227))


def tp_work(kernel: str, B: int, H: int, W: int, D: int, ranks: int,
            reads: int = 0):
    """(bytes, 32-bit integer instructions) of TP BM's T1 over every rank
    (each rank's frames in, 2 bytes a pixel, its partials out, 72; G's
    5.75 instructions a pixel and scored d, over the ranks * Dl scored d)
    or T2 (the ``reads`` int32 partials its combine reads, tp_combine_reads,
    and the two float maps out, 8 bytes a pixel; no operation counted)."""
    px = B * H * W
    if kernel == "bm_tp_partials":
        return ranks * px * (2 + 2 * 9 * 4), 5.75 * px * ranks * (D // ranks)
    return 4 * reads + 8 * px, 0


def tp_combine_reads(parts, D: int, Dl: int) -> int:
    """The int32 partials that T2's combine reads from the ranks' partials
    parts [K, 2, NF, B, H, W], summed over pixels and views: every rank's
    key, the winner's best and second, cm and cp where a rank holds q -+ 1,
    and two fields of each other rank (its first and xfirst, or its last
    and xlast where it holds q - 1, or its first and xfirst where it holds
    q + 1: one of them counted with cm or cp)."""
    import torch

    K = parts.shape[0]
    total = 0
    for view in range(2):
        key, w = parts[:, view, 0].min(0)
        q = key % D
        lo = w * Dl
        hi = lo + Dl
        n = K + 2 + ((q - 1 >= lo) | (w > 0)).long() \
            + ((q + 1 < hi) | (w + 1 < K)).long()
        ks = torch.arange(K, device=parts.device).view(
            -1, *([1] * key.dim()))
        edge = ((ks == w - 1) & (q == lo)) | ((ks == w + 1) & (q == hi - 1))
        rest = torch.where(ks == w, 0, torch.where(edge, 1, 2)).sum(0)
        total += int((n + rest).sum())
    return total


def subsampling_phase(dev, hold, pipe, dmaps):
    """Phase 10: ELAS subsampling and the exact float64 scan on the card.
    (a) kernel A on half-resolution descriptors against its plain twin and
    kernel B under subsampling against the plain dense, both full and
    after the subsampled output's slice, on libelas's subsampling fixture
    and the two 640x480 golden pairs; (b) the card's subsampled elas_match
    against libelas's final_D1 (with the fixture's triangulations) and
    against the CPU's on the same inputs, with A's, B's and H's launch
    counters set to 0 just before and read just after (the L/R check runs
    on the kept even pixels: kernel H once a call, B without its L/R
    epilogue); (c) the card's exact scan (kernel V) against the CPU's on
    phase 4's 9 maps at 640x480 (pipe: phase 4's node) and on
    EXACT_SCAN_EDGE_CASES, V's launches counted (once a call), the ATen ops
    of a call, V's DFMA count against its -fmad=false build's, its time
    against its bound and the call's host ms beside the eager path's.
    Returns (the phase's JSON line, V's entry of the kernels line)."""
    import torch
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import dense as dense_mod
    from jackal_tpu_torch.matching.elas import post
    from jackal_tpu_torch.matching.elas import support as support_mod
    from jackal_tpu_torch.matching.elas.pipeline import elas_match
    from jackal_tpu_torch.ops.descriptor import create_descriptor
    from jackal_tpu_torch.scan.exact_scan import (
        obstacle_scan_from_disparity_exact)

    sub = ElasParams(subsampling=True)
    D = sub.disp_num
    step = support_mod.effective_stepsize(sub)
    st = np.load(f"{FIX}/elas_stages_sub320.npz")
    cases = [("elas_stages_sub320", st["left"], st["right"])] + [
        (f, g["left"], g["right"])
        for f, g in ((f, np.load(f"{FIX}/{f}.npz")) for f in GOLDEN)]

    # (a) A and B under subsampling against their plain twins
    for name, left, right in cases:
        H, W = left.shape
        desc = create_descriptor(torch.from_numpy(np.stack([left, right]))
                                 .to(dev), True)
        d1, d2 = desc[0:1], desc[1:2]
        support_keys_held(hold, f"support, half-resolution descriptors, "
                          f"{name}", d1, d2, step, 0, D)
        views = prior_inputs(d1, d2, sub, dev)
        got = dense_mod.dense_match_pair(d1, d2, *views, sub)
        want = dense_mod.dense_match_pair_plain(d1, d2, *views, sub)
        hold("elas_dense", f"dense pair under subsampling, {name}", got,
             want)
        hold("elas_dense", f"dense pair under subsampling, sliced, {name}",
             [x[:, 0::2, 0::2][:, :H // 2, :W // 2] for x in got],
             [x[:, 0::2, 0::2][:, :H // 2, :W // 2] for x in want])
    torch.cuda.synchronize()
    print(f"10a. kernel A on half-resolution descriptors == plain and "
          f"kernel B under subsampling == plain dense (full, and sliced "
          f"[0::2, 0::2]) (torch.equal): {', '.join(c[0] for c in cases)}")

    # (b) the card's subsampled elas_match against libelas and the CPU
    support_mod.launches = dense_mod.launches = dense_mod.lr_launches = 0
    post.launches["elas_lr"] = post.device_launches["elas_lr"] = 0
    reset_front()
    D1, _ = elas_match(st["left"], st["right"], sub, tri_left=st["tri1"],
                       tri_right=st["tri2"], device=dev)
    outs = [(name, elas_match(left, right, sub, device=dev))
            for name, left, right in cases]
    launches = {"support": support_mod.launches,
                "elas_dense": dense_mod.launches,
                "elas_dense_lr": dense_mod.lr_launches,
                "elas_lr": post.device_launches["elas_lr"]}
    print(f"10b. launches over {1 + len(cases)} subsampled elas_match calls"
          f" on the card: {launches}")
    n = 1 + len(cases)
    launches.update(pin_front(f"10b. {n} subsampled elas_match calls (R on "
                              f"half-resolution descriptors, A with Q's "
                              f"epilogue at the even step, once a call)", n))
    if launches != {"support": n, "elas_dense": n, "elas_dense_lr": 0,
                    "elas_lr": n, "descriptor": n, "support_fused": n,
                    "support_epilogue": 0} \
            or post.launches["elas_lr"] != n:
        raise AssertionError(f"subsampled elas_match did not launch A, B "
                             f"(without its L/R epilogue) and H once a "
                             f"call: {launches}")
    ref = torch.from_numpy(st["final_D1"])
    if not torch.equal(D1.cpu(), ref):
        raise AssertionError(f"subsampled elas_match != libelas final_D1 in "
                             f"{int((D1.cpu() != ref).sum())} pixels")
    for (name, left, right), (_, card) in zip(cases, outs):
        cpu = elas_match(left, right, sub, device="cpu")
        H, W = left.shape
        for nm, a, b in zip(("D1", "D2"), card, cpu):
            if a.shape != (H // 2, W // 2) or not torch.equal(a.cpu(), b):
                raise AssertionError(f"subsampled elas_match {name} {nm}: "
                                     f"card != CPU")
    print(f"10b. subsampled elas_match on the card == libelas final_D1 "
          f"(elas_stages_sub320, its triangulations) bit for bit, and == the"
          f" CPU's D1, D2 on {', '.join(c[0] for c in cases)}")

    # (c) the exact float64 scan: kernel V against the CPU
    fields, entry = exact_scan_phase(dev, hold, pipe, dmaps)
    return {"subsampling": {"launches": launches, **fields}}, [entry]


def exact_scan_phase(dev, hold, pipe, dmaps):
    """Phase 10c: kernel V against the CPU path on phase 4's maps (numpy
    u8, pipe: phase 4's node) and the CPU tests' edge maps (uploaded first:
    their calls upload nothing); see subsampling_phase. Returns (the
    phase's JSON fields, V's entry of the kernels line)."""
    import torch
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.scan import exact_scan as es
    from jackal_tpu_torch.scan.exact_scan import (
        obstacle_scan_from_disparity_exact)


    Q, XR, XT = pipe.rect.Q, pipe.calib.XR, pipe.calib.XT
    valid = pipe.valid_disp.cpu().numpy()
    ox, oy = pipe.p.crop_offset_x, pipe.p.crop_offset_y
    fields = ("scan", "angle_min", "angle_max", "range_min", "range_max")
    cases = [(f"phase 4's map {i}", (dm, valid, Q, XR, XT, ox, oy))
             for i, dm in enumerate(dmaps)]
    for name in EXACT_SCAN_EDGE_CASES:
        dm, vd, *rest = exact_scan_edge_case(name)
        cases.append((name, (torch.from_numpy(dm).to(dev),
                             torch.from_numpy(vd).to(dev), *rest)))
    read = _counted([(es, "exact_scan")])
    filled = []
    for name, case in cases:
        card = obstacle_scan_from_disparity_exact(*case, device=dev)
        cpu = obstacle_scan_from_disparity_exact(
            *(x.cpu() if torch.is_tensor(x) else x for x in case),
            device="cpu")
        for f in fields:
            a, b = getattr(card, f), getattr(cpu, f)
            if a.dtype != torch.float64 or a.device.type != dev.type:
                raise AssertionError(f"exact scan {f}: {a.dtype} on "
                                     f"{a.device}")
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(),
                                          err_msg=f"exact scan {name} {f}")
        hold("exact_scan", f"exact scan {name}",
             [card.scan.cpu(), torch.stack([card.angle_min, card.angle_max,
                                         card.range_min, card.range_max]
                                        ).cpu()],
             [cpu.scan, torch.stack([cpu.angle_min, cpu.angle_max,
                                  cpu.range_min, cpu.range_max])])
        filled.append(int((cpu.scan < 1e9 - 1).sum()))
    v_launches = read()[0]
    if v_launches != len(cases):
        raise AssertionError(f"exact scan: V launched {v_launches} times in "
                             f"{len(cases)} calls, not once a call")
    ops = aten_ops_of_a_call(lambda: obstacle_scan_from_disparity_exact(
        dmaps[0], valid, Q, XR, XT, ox, oy, device=dev))
    card_ops = [n for n, ok in ops if not ok]
    # the map's and the range's uploads; the one read's output lies on the
    # host, and the result's torch.tensor on the card dispatches no ATen op
    if len(card_ops) != 2:
        raise AssertionError(f"exact scan: {card_ops} launch work on the "
                             f"card, not the map's and the range's uploads")
    dm_t, vd_t = (torch.from_numpy(x).to(dev) for x in (dmaps[0], valid))
    Q64, XR64 = (np.asarray(x, np.float64) for x in (Q, XR))
    XT64 = np.asarray(XT, np.float64).reshape(3)
    out = es._device_scan_cuda(dm_t, vd_t, Q64, XR64, XT64, ox, oy).cpu()
    H, W = dmaps[0].shape
    nbV, opsV = exact_scan_work(H * W, int(out[es.OUT_N]),
                                int(out[es.OUT_MID]))
    bV, byV = bound_ms(nbV, opsV, PEAK_F64_OPS_PER_S)
    kV = events_ms(lambda: es._device_scan_cuda(dm_t, vd_t, Q64, XR64, XT64,
                                                ox, oy), 50)
    pV = events_ms(lambda: es._device_scan(
        dm_t, vd_t[..., 0], vd_t[..., 1], Q64.tolist(), XR64.tolist(),
        XT64.tolist(), ox, oy), 3, spin=False)
    t_card = host_ms(lambda: obstacle_scan_from_disparity_exact(
        dmaps[0], valid, Q, XR, XT, ox, oy, device=dev), 5)
    t_eager = host_ms(lambda: es.obstacle_scan_from_disparity_exact_plain(
        dmaps[0], valid, Q, XR, XT, ox, oy, device=dev), 5)
    fns = ("exact_scan_records_kernel", "exact_scan_reduce_kernel")
    dfma = {lib: sass_by_function(cuda_lib.library(lib).path, "DFMA", fns)
            for lib in ("exact_scan_kernel", "exact_scan_kernel_nofmad")}
    if dfma["exact_scan_kernel"] != dfma["exact_scan_kernel_nofmad"]:
        raise AssertionError(f"kernel V: DFMA {dfma} differ from the "
                             f"-fmad=false build's")
    print(f"10c. exact float64 scan, kernel V, on the card == the CPU's "
          f"(assert_array_equal, every field: the bins, so the card's atan2f "
          f"candidate took every pixel's bin) on {len(dmaps)} maps at "
          f"{W}x{H} (filled bins {filled[:len(dmaps)]}) and "
          f"{', '.join(EXACT_SCAN_EDGE_CASES)} (filled {filled[len(dmaps):]});"
          f" V {v_launches} launches in {len(cases)} calls; ATen ops that "
          f"launch work a call {card_ops}; DFMA {dfma} (as at -fmad=false); "
          f"device ms a call (CUDA events behind a spin) {kV:.5f} (plain, "
          f"_device_scan's eager ops, {pV:.3f}; bound {bV:.6f} by {byV}: "
          f"{nbV} bytes, {opsV} f64 operations, {int(out[es.OUT_N])} "
          f"accepted, {int(out[es.OUT_MID])} midpoint-tested); host ms a "
          f"call {t_card:.3f} (the eager _device_scan path on the card "
          f"{t_eager:.3f})")
    if kV < bV:
        raise AssertionError(f"kernel V: {kV} ms is below its bound {bV} ms")
    entry = {"name": "exact_scan", "route": "cuda",
             "source": "jackal_tpu_torch/csrc/exact_scan_kernel.cu",
             "replaces": "jackal_tpu/scan/exact_scan.py:132",
             "launches": v_launches, "ms": kV, "plain_ms": pV,
             "bound_ms": bV, "bound_by": byV, "library_ms": None}
    return {"exact_scan_frames": len(dmaps),
            "exact_scan_edge_maps": len(EXACT_SCAN_EDGE_CASES),
            "exact_scan_launches": v_launches,
            "exact_scan_card_ops": card_ops, "exact_scan_dfma": dfma,
            "exact_scan_kernel_ms": kV, "exact_scan_bound_ms": bV,
            "exact_scan_ms": t_card, "exact_scan_eager_ms": t_eager}, entry


def _same(name, got, want) -> None:
    """Raise unless got equals want (torch.equal, want moved to got's
    device)."""
    import torch

    if got.shape != want.shape or not torch.equal(got, want.to(got.device)):
        raise AssertionError(f"{name}: not torch.equal")


def _counted(mods):
    """Set the launch counters of the kernels named by (module, key) pairs
    (key None: the module's int) to 0; the returned function reads them."""
    for m, k in mods:
        if k is None:
            m.launches = 0
        else:
            m.launches[k] = 0
    return lambda: [m.launches if k is None else m.launches[k]
                    for m, k in mods]


def tp_phase(dev, hold, rect_l, rect_r, out):
    """Phase 11b: TP BM at TP_CARD_CASES on phase 4's rectified frames
    (see multidevice_phase); each case's numbers go into ``out``. Returns
    the kernels line's entries of T1 and T2 (the first case)."""
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.matching import bm as bm_mod
    from jackal_tpu_torch.matching.bm import bm_match
    from jackal_tpu_torch.ops import bm_tp_kernel as tpk
    from jackal_tpu_torch.parallel.mesh import (bm_match_tp, bm_match_tp_plain,
                                                gather, make_mesh)

    rate = int_ops_rate(dev)
    entries = []
    for D, data, disp, B, win in TP_CARD_CASES:
        n = data * disp
        p = BMParams(disp_num=D, window=win)
        mesh = make_mesh(n, disp_parallel=disp, devices=[dev] * n)
        tp, plain = bm_match_tp(mesh, p), bm_match_tp_plain(mesh, p)
        L, R = rect_l[:B], rect_r[:B]
        H, W = L.shape[1:]
        label = (f"D = {D}{'' if win == 9 else f', window {win}'} on "
                 f"{data}x{disp}")
        read = _counted([(tpk, "bm_tp_partials"), (tpk, "bm_tp_combine"),
                         (bm_mod, "bm_gate")])
        dl, dr = (gather(x) for x in tp(L, R))
        counts = dict(zip(("T1", "T2", "S"), read()))
        if counts != {"T1": n, "T2": data, "S": data}:
            raise AssertionError(f"TP BM {label}: launches {counts}, not T1 "
                                 f"once a rank, T2 and S once a row of "
                                 f"'data'")
        card_ops = [nm for nm, ok in aten_ops_of_a_call(lambda: tp(L, R))
                    if not ok]
        if card_ops:
            raise AssertionError(f"TP BM {label}: {card_ops} launch work on "
                                 f"the card")
        pl, pr = (gather(x) for x in plain(L, R))
        _same(f"TP BM {label} left vs the plain TP path", dl, pl)
        _same(f"TP BM {label} right vs the plain TP path", dr, pr)
        if D % disp == 0:
            for b in range(B):
                sl, sr = bm_match(L[b], R[b], p)
                _same(f"TP BM {label} frame {b} left", dl[b], sl)
                _same(f"TP BM {label} frame {b} right", dr[b], sr)
        # T1 and T2 against their twins on the first row's frames
        Bs, Dl, r = B // data, D // disp, win // 2
        Ls, Rs = L[:Bs], R[:Bs]
        parts = tpk.rank_partials(Ls, Rs, D, r, [dev] * disp)
        for k in range(disp):
            hold("bm_tp_partials", f"T1 {label} rank {k}", [parts[k]],
                 [tpk.tp_partials_plain(Ls, Rs, k * Dl, Dl, D, r)])
        hold("bm_tp_combine", f"T2 {label}", tpk.tp_combine(parts, D, Dl, p),
             tpk.tp_combine_plain(parts, D, Dl, p))
        k1 = events_ms(lambda: tpk.rank_partials(Ls, Rs, D, r, [dev] * disp),
                       20)
        k2 = events_ms(lambda: tpk.tp_combine(parts, D, Dl, p), 20)
        p1 = events_ms(lambda: [tpk.tp_partials_plain(Ls, Rs, k * Dl, Dl, D,
                                                      r)
                                for k in range(disp)], 3, spin=False)
        p2 = events_ms(lambda: tpk.tp_combine_plain(parts, D, Dl, p), 3,
                       spin=False)
        b1, by1 = bound_ms(*tp_work("bm_tp_partials", Bs, H, W, D, disp), rate)
        b2, by2 = bound_ms(*tp_work("bm_tp_combine", Bs, H, W, D, disp,
                                    tp_combine_reads(parts, D, Dl)), rate)
        ms = host_ms(lambda: tp(L, R), 5)
        plain_ms = host_ms(lambda: plain(L, R), 3)
        single = host_ms(lambda: bm_match(L, R, p), 5)
        shape = f"{data}x{disp}"
        out[f"d{D}_w{win}_{shape}"] = {
            "frames": B, "launches": counts, "ms": ms, "plain_ms": plain_ms,
            "single_ms": single, "T1_ms": k1, "T1_bound_ms": b1,
            "T2_ms": k2, "T2_bound_ms": b2}
        print(f"11b. TP BM {W}x{H} {label} (data x disp) of {dev}, {B} "
              f"frames: both maps == the plain TP path on the card and"
              f"{' == bm_match frame by frame' if D % disp == 0 else ' (D % ranks != 0: no bm_match)'}"
              f" (torch.equal); T1's partials and T2's maps == their twins; "
              f"launches {counts}; ATen ops that launch work a call "
              f"{card_ops}; host ms a call {ms:.3f} (the plain TP path on the"
              f" card {plain_ms:.3f}, bm_match on the batch {single:.3f}); "
              f"device ms (CUDA events behind a spin), a row of {Bs} frames:"
              f" T1 over its {disp} ranks {k1:.4f} (plain {p1:.3f}; bound "
              f"{b1:.5f} by {by1}), T2 {k2:.4f} (plain {p2:.3f}; bound "
              f"{b2:.5f} by {by2})")
        for nm, k, bd in (("T1", k1, b1), ("T2", k2, b2)):
            if k < bd:
                raise AssertionError(f"{nm} {label}: {k} ms is below its "
                                     f"bound {bd} ms")
        if not entries:   # the kernels line: D = 64 on 2 x 2
            entries = [
                {"name": "bm_tp_partials", "route": "cuda",
                 "source": "jackal_tpu_torch/csrc/bm_tp_kernel.cu",
                 "replaces": "jackal_tpu/parallel/mesh.py:118",
                 "launches": counts["T1"], "ms": k1, "plain_ms": p1,
                 "bound_ms": b1, "bound_by": by1, "library_ms": None},
                {"name": "bm_tp_combine", "route": "cuda",
                 "source": "jackal_tpu_torch/csrc/bm_tp_kernel.cu",
                 "replaces": "jackal_tpu/parallel/mesh.py:81",
                 "launches": counts["T2"], "ms": k2, "plain_ms": p2,
                 "bound_ms": b2, "bound_by": by2, "library_ms": None}]
    return entries


def multidevice_phase(dev, hold, raw_pairs, rect_l, rect_r):
    """Phase 11: the multi-device paths (parallel/mesh.py, the ELAS
    replicas) and the last modules on meshes of one card repeated. (a) DP
    SGM and DP BM, make_pipeline at 640x480, D = 64, B = 8 of phase 4's
    raw pairs, on 4 and 8 ranks: maps, scans and closest against
    process_batch_fused on the batch, the launches of D, E, F or G counted
    under the step; (b) TP BM on phase 4's rectified frames at
    TP_CARD_CASES (D = 64 on 2 x 2 and 1 x 4, D = 256 on 1 x 8, D = 30 on
    1 x 4, window 227 on 1 x 4): both maps against the plain TP path on
    the card and bm_match frame by frame where the ranks divide D, T1's
    and T2's launches counted (T1 once a rank, T2 and S once a row), the
    ATen ops of a call (none that launch work), T1's partials and T2's
    maps against their twins, their times against their bounds; (c) the ELAS replicas on 8 distinct 640x480 pairs (phase 4's
    frames, frame b rolled 3 b columns) on 2 and 4 replicas, chunk 1 and
    2, against elas_match_batch_device(chunk=1), A, B and C counted; on
    the golden pairs against libelas; (d) entry.dryrun_multichip(8);
    (e) filters, linalg, the experiments and the coefficient-wire raster
    on the card against the CPU. Host-clock times (median of 5) beside
    the single-device step's; every rank is this one card, so no time
    here says anything of scaling. Returns (the phase's JSON line, the
    kernels line's entries of T1 and T2)."""
    import torch
    from jackal_tpu_torch import entry as entry_mod
    from jackal_tpu_torch.config import BMParams, ElasParams, PipelineParams
    from jackal_tpu_torch.experiments import confidence, feature_matching
    from jackal_tpu_torch.matching import bm as bm_mod
    from jackal_tpu_torch.matching.bm import bm_match
    from jackal_tpu_torch.matching.elas import dense as dense_mod
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import support as support_mod
    from jackal_tpu_torch.matching.elas.native_prior import (
        build_priors_native, fit_planes_native)
    from jackal_tpu_torch.matching.elas.pipeline import (
        elas_match_batch_device, elas_match_batch_multichip)
    from jackal_tpu_torch.matching.elas.prior import delaunay
    from jackal_tpu_torch.ops import bm_kernel as bk
    from jackal_tpu_torch.ops import filters, linalg
    from jackal_tpu_torch.ops import sgm_kernel as sk
    from jackal_tpu_torch.parallel.mesh import (dp_sharded_step, gather,
                                                make_mesh)
    from jackal_tpu_torch.pipeline.default import make_pipeline

    out = {"dp": {}, "tp": {}, "elas": {}}
    size = PipelineParams(im_width=640, im_height=480, crop_im_width=640,
                          crop_im_height=480)

    # (a) DP SGM and DP BM over the data rows
    lb = np.stack([p[0] for p in raw_pairs[:8]])
    rb = np.stack([p[1] for p in raw_pairs[:8]])
    fields = ("scan", "angle_min", "angle_max", "range_min", "range_max")
    for engine, keys in (("sgm", [(sk, "census"), (sk, "sgm_cost"),
                                  (sk, "sgm_paths"), (sk, "sgm_wta"),
                                  (sk, "sgm_epilogue")]),
                         ("bm", [(bk, "bm"), (bm_mod, "bm_gate")])):
        pipe = make_pipeline(engine=engine, params=size, device=dev)
        wd, ws = pipe.process_batch_fused(lb, rb)
        single = host_ms(lambda: pipe.process_batch_fused(lb, rb), 5)
        for n in (4, 8):
            step = dp_sharded_step(pipe, make_mesh(n, devices=[dev] * n))
            read = _counted(keys)
            dmaps, scans, closest = step(lb, rb)
            torch.cuda.synchronize()
            counts = dict(zip((k for _, k in keys), read()))
            # S never on BM's shards: G's strip applies the gate; O2 never
            # on SGM's: F's launch carries its epilogue
            if counts != {k: 0 if k in ("bm_gate", "sgm_epilogue") else n
                          for _, k in keys}:
                raise AssertionError(f"DP {engine} on {n} ranks launched "
                                     f"{counts}, not once a shard (S and O2 "
                                     f"never)")
            _same(f"DP {engine} {n} dmaps", gather(dmaps), wd)
            got = gather(scans)
            for f in fields:
                _same(f"DP {engine} {n} scans.{f}", getattr(got, f),
                      getattr(ws, f))
            _same(f"DP {engine} {n} closest", closest, ws.scan.min())
            ms = host_ms(lambda: step(lb, rb), 5)
            # the shards' work alone: n single-device calls of B / n
            Bs = 8 // n
            shards = host_ms(lambda: [pipe.process_batch_fused(
                lb[i:i + Bs], rb[i:i + Bs]) for i in range(0, 8, Bs)], 5)
            out["dp"][f"{engine}_{n}"] = {"launches": counts, "ms": ms,
                                         "single_ms": single,
                                         "shards_ms": shards}
            print(f"11a. DP {engine} 640x480 D = 64 B = 8 on {n} ranks of "
                  f"{dev}: dmaps, scans (every field), closest == "
                  f"process_batch_fused (torch.equal); launches {counts}; "
                  f"host ms a step {ms:.3f} (single-device on B = 8 "
                  f"{single:.3f}, {n} single-device calls of B = {Bs} "
                  f"{shards:.3f})")

    # (b) TP BM on the rectified frames: T1 a rank, T2 and S a row
    entries = tp_phase(dev, hold, rect_l, rect_r, out["tp"])

    # (c) the ELAS replicas on 8 distinct pairs
    params = ElasParams()
    el = torch.stack([torch.roll(rect_l[b], 3 * b, 1) for b in range(8)])
    er = torch.stack([torch.roll(rect_r[b], 3 * b, 1) for b in range(8)])
    S1, S2 = elas_match_batch_device(el, er, params, chunk=1, device=dev)
    single = {c: host_ms(lambda: elas_match_batch_device(
        el, er, params, chunk=c, device=dev), 5) for c in (1, 2)}
    keys = [(support_mod, None), (dense_mod, None), (dp, None)]
    for n in (2, 4):
        for chunk in (1, 2):
            read = _counted(keys)
            reset_front()
            reset_prior()
            D1, D2 = elas_match_batch_multichip(el, er, params, chunk=chunk,
                                                devices=[dev] * n)
            counts = dict(zip(("support", "elas_dense", "raster"), read()),
                          **front_counts(), **prior_counts())
            want = {"support": n, "elas_dense": 8 // chunk,
                    "raster": 8 // chunk, "descriptor": n,
                    "support_fused": n, "support_epilogue": 0,
                    "coeff_grid": 8 // chunk}
            if counts != want:
                raise AssertionError(f"ELAS replicas {n} chunk {chunk}: "
                                     f"launches {counts}, expected {want}")
            _same(f"ELAS {n} replicas chunk {chunk} D1",
                  torch.from_numpy(D1), S1)
            _same(f"ELAS {n} replicas chunk {chunk} D2",
                  torch.from_numpy(D2), S2)
            ms = host_ms(lambda: elas_match_batch_multichip(
                el, er, params, chunk=chunk, devices=[dev] * n), 5)
            out["elas"][f"{n}_chunk{chunk}"] = {
                "launches": counts, "ms": ms, "single_ms": single[chunk]}
            print(f"11c. ELAS {n} replicas of {dev}, chunk {chunk}, 8 "
                  f"distinct 640x480 pairs: D1, D2 == elas_match_batch_"
                  f"device(chunk=1) (torch.equal); launches {counts}; host "
                  f"ms a call {ms:.3f} (single-device at chunk {chunk} "
                  f"{single[chunk]:.3f})")
    gold = [np.load(f"{FIX}/{f}.npz") for f in GOLDEN]
    G1, G2 = elas_match_batch_multichip(
        np.stack([g["left"] for g in gold]),
        np.stack([g["right"] for g in gold]), params, devices=[dev] * 2)
    for i, g in enumerate(gold):
        _same(f"ELAS replicas {GOLDEN[i]} D1", torch.from_numpy(G1[i]),
              torch.from_numpy(g["D1"]))
        _same(f"ELAS replicas {GOLDEN[i]} D2", torch.from_numpy(G2[i]),
              torch.from_numpy(g["D2"]))
    print(f"11c. ELAS on 2 replicas == libelas D1/D2 bit for bit: "
          f"{', '.join(GOLDEN)}")

    # (d) the dry run of every multi-device path
    t = time.perf_counter()
    entry_mod.dryrun_multichip(8, device=dev)
    print(f"11d. entry.dryrun_multichip(8) on {dev}: passed in "
          f"{time.perf_counter() - t:.3f} s")

    # (e) the last modules on the card against the CPU
    img = rect_l[0]
    for fn in (filters.integral_image, filters.sobel5x5,
               filters.checkerboard5x5, filters.blob5x5):
        got, want = fn(img), fn(img.cpu())
        got, want = (x if isinstance(x, tuple) else (x,)
                     for x in (got, want))
        for g, w in zip(got, want):
            _same(f"{fn.__name__} 640x480", g, w)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4096, 3, 3))
    Bm = rng.standard_normal((4096, 3, 2))
    Ad, Bd = (torch.from_numpy(x).to(dev) for x in (A, Bm))
    for name, got, want in (
            ("gauss_jordan_solve", linalg.gauss_jordan_solve(Ad, Bd),
             linalg.gauss_jordan_solve(A, Bm, "cpu")),
            ("lu", linalg.lu(Ad), linalg.lu(A, "cpu"))):
        for g, w in zip(got, want):
            _same(f"{name} 4096 x 3x3 float64", g, w)
    U, w, V = linalg.svd(Ad)
    Uc, wc, Vc = linalg.svd(A, "cpu")
    rec = U @ torch.diag_embed(w) @ V.transpose(-1, -2)
    rec_err = float((rec.cpu() - Ad.cpu()).abs().max())
    # singular values against the CPU's, relative to each system's largest
    w_err = float(((w.cpu() - wc).abs() / wc[:, :1]).max())
    if rec_err > 1e-12 or w_err > 1e-12:
        raise AssertionError(f"svd on the card: reconstruction {rec_err}, "
                             f"singular values {w_err}")
    print(f"11e. filters at 640x480 (integral, sobel5x5, checkerboard5x5, "
          f"blob5x5) and gauss_jordan_solve, lu on 4096 float64 3x3 "
          f"systems == the CPU (torch.equal); svd: reconstruction within "
          f"{rec_err:.3g} of A, singular values within {w_err:.3g} of the "
          f"CPU's, relative to each system's largest (bound 1e-12 each)")
    for i, g in enumerate(gold):
        pl, pr = feature_matching.match_features(g["left"], g["right"],
                                                 device=dev)
        cl, cr = feature_matching.match_features(g["left"], g["right"],
                                                 device="cpu")
        if not (np.array_equal(pl, cl) and np.array_equal(pr, cr)):
            raise AssertionError(f"match_features {GOLDEN[i]}: card != CPU")
        H, W = g["left"].shape
        prng = np.random.default_rng(i)
        pts_l = np.stack([prng.integers(20, W - 20, 200),
                          prng.integers(20, H - 20, 200)], -1)
        pts_r = pts_l - np.stack([prng.integers(0, 60, 200),
                                  np.zeros(200, int)], -1)
        a = confidence.confidence_check(g["left"], g["right"], pts_l, pts_r,
                                        device=dev)
        b = confidence.confidence_check(g["left"], g["right"], pts_l, pts_r,
                                        device="cpu")
        if not np.array_equal(a, b):
            raise AssertionError(f"confidence_check {GOLDEN[i]}: card != "
                                 f"CPU")
        print(f"11e. match_features ({len(pl)} matches) and "
              f"confidence_check (200 pairs, {int(a.sum())} flagged) on "
              f"the card == the CPU: {GOLDEN[i]}")
    st = np.load(f"{FIX}/elas_stages_st320.npz")
    support = st["support"].astype(np.int32)
    H, W = st["left"].shape
    tris = {False: delaunay(support[:, :2].astype(np.float32)),
            True: delaunay(np.stack([support[:, 0] - support[:, 2],
                                     support[:, 1]], -1).astype(np.float32))}
    host = build_priors_native(support, W, H, params, tri_left=tris[False],
                               tri_right=tris[True])
    for right in (False, True):
        tri = tris[right]
        wire = dp.pad_coeff_wire(dp.sort_wire_rows(dp.prior_coeff_wire(
            support, tri, right, fit_planes_native)), -(-len(tri) // 64) * 64)
        rows = [getattr(wire, f)[None] for f in (
            "corners_u", "corners_v", "slope_bits", "plane_bits", "pvalid",
            "paint_idx")]
        card = dp.prior_maps_device(
            *(torch.from_numpy(np.ascontiguousarray(r)).to(dev)
              for r in rows), W, H)
        cpu = dp.prior_maps_device(*rows, W, H, device="cpu")
        for nm, a, b in zip(("d_plane", "valid", "covered"), card, cpu):
            _same(f"prior_maps_device {nm} right={right}", a, b)
        maps = host[1] if right else host[0]
        cov = torch.from_numpy(maps.tri_id >= 0)
        _same(f"prior_maps_device covered right={right} vs host",
              card[2][0], cov)
        _same(f"prior_maps_device valid right={right} vs host", card[1][0],
              torch.from_numpy(maps.valid))
        _same(f"prior_maps_device d_plane right={right} vs host",
              card[0][0].cpu()[cov], torch.from_numpy(maps.d_plane)[cov])
    print("11e. prior_maps_device (the coefficient-wire raster) on the card "
          "== the CPU (torch.equal) and == the C++ host prior's PlaneMaps "
          "(covered, valid, d_plane where covered): elas_stages_st320, both "
          "sides")

    # (f) the host cost of the device guard that cuda_lib.launch puts
    # around every ctypes launch, beside the stream lookup it always did
    probe = torch.empty(16, device=dev)

    def lookups(guarded: bool):
        for _ in range(1000):
            if guarded:
                with torch.cuda.device(probe.device):
                    torch.cuda.current_stream(probe.device).cuda_stream
            else:
                torch.cuda.current_stream(probe.device).cuda_stream

    bare_us = host_ms(lambda: lookups(False), 5)        # ms / 1000 = us
    guard_us = host_ms(lambda: lookups(True), 5)
    out["launch_guard_us"] = {"guarded": guard_us, "bare": bare_us}
    print(f"11f. host us a kernel launch for the stream argument: "
          f"{guard_us:.3f} with the device guard, {bare_us:.3f} without "
          f"(median of 5 loops of 1000)")
    return {"multidevice": out}, entries


# the ELAS postprocess kernels' cases (tests/test_torch_cuda.py runs them too)
POST_EDGE_CASES = ("W = 83, not a multiple of 4", "H and W under 9: 5 x 7",
                   "3 x 2", "all invalid", "all valid",
                   "abs-mask steps and signed zeros",
                   "MIDDLEBURY, both views, long gaps",
                   "subsampled, 240 x 320", "B = 8 at 640x480",
                   # the 32 x 32 tiles of I and J, and I's two designs
                   "70 x 101, not multiples of the tile",
                   "gaps and valid runs across tile edges",
                   "one row: 1 x 200", "one column: 200 x 1",
                   "smaller than the halo: 4 x 6, gap width 8",
                   "gap width 8, the tile design's widest",
                   "gap width 9, the scan design",
                   "add_corners at gap width 3",
                   "lines past 1024 pixels: 1030 x 2100")


def _post_maps(rng, B, H, W, holes=0.25):
    """Seeded piecewise-smooth disparities in half steps with holes (-10)
    and speckles (-1), the first three columns invalid."""
    D = rng.random((B, H, W)) * 4 + np.linspace(5, 60, W)[None, None, :]
    D = np.round(D * 2) / 2
    D[rng.random((B, H, W)) < holes] = -10.0
    D[rng.random((B, H, W)) < 0.05] = -1.0
    D[:, :, :3] = -10.0
    return D.astype(np.float32)


def _runs(rng, D, max_run, n):
    """D with n seeded runs of 1..max_run invalid pixels (-10 or -1) along
    rows and as many along columns, in place."""
    B, H, W = D.shape
    for axis in (2, 1):
        for _ in range(n):
            b, y, x = (int(rng.integers(0, k)) for k in (B, H, W))
            k = int(rng.integers(1, max_run + 1))
            v = -10.0 if rng.random() < 0.7 else -1.0
            if axis == 2:
                D[b, y, x:x + k] = v
            else:
                D[b, y:y + k, x] = v
    return D


def post_edge_case(name, dev):
    """(D1, D2, params) of one of POST_EDGE_CASES on dev, from a seed: a
    width that is not a multiple of 4 (the adaptive mean's lane rotation
    along rows); frames under the filters' 9-pixel reach; all pixels
    invalid (-10 and -1) and all valid; values on the abs-mask's steps
    (differences at powers of two, one ulp either side) with -0.0 and
    +0.0 among them; MIDDLEBURY (5000-pixel gaps, corner extrapolation,
    median, both views) on maps with long holes and empty rows and
    columns; half-resolution maps in quarter steps under subsampling (the
    d/2 warp, the 4-tap mean); a batch of 8 at the node's size. Then the
    32 x 32 tiles of I and J: H and W not multiples of the tile; runs of
    invalid and valid pixels across the tiles' edges (columns and rows
    around 32, 64 and 96); one-row and one-column maps; a map smaller than
    I's halo at gap width 8 (9 pixels); gap widths 8 and 9, either side of
    I's switch from its tile design to its scan design, on runs of 1 to 11
    pixels; add_corners at gap width 3 (the scan design at a short gap);
    rows and columns longer than the scan design's chunk of 1024."""
    import torch
    from jackal_tpu_torch.config import ElasParams

    i = POST_EDGE_CASES.index(name)
    rng = np.random.default_rng(80 + i)
    p = ElasParams()
    B, H, W = ((1, 48, 83), (1, 5, 7), (2, 3, 2), (1, 40, 64), (1, 40, 64),
               (2, 37, 61), (2, 96, 130), (1, 240, 320), (8, 480, 640),
               (2, 70, 101), (2, 100, 130), (2, 1, 200), (2, 200, 1),
               (1, 4, 6), (2, 90, 110), (2, 90, 110), (2, 90, 110),
               (1, 1030, 2100))[i]
    D1, D2 = _post_maps(rng, B, H, W), _post_maps(rng, B, H, W)
    if name == "all invalid":
        D1 = np.where(rng.random((B, H, W)) < 0.5, -10.0, -1.0)
        D2 = np.full((B, H, W), -10.0)
    elif name == "all valid":
        D1, D2 = (rng.random((2, B, H, W)) * 40).round()
    elif name.startswith("abs-mask"):
        steps = 2.0 ** np.arange(-3, 8)
        vals = np.concatenate([steps, np.nextafter(steps, 0),
                               np.nextafter(steps, 1e9), [0.0, -0.0, 3.0,
                                                          -10.0, -1.0]])
        base = rng.integers(1, 60, (B, H, W)).astype(np.float32)
        D1 = base + rng.choice(vals, (B, H, W)).astype(np.float32)
        D1[rng.random((B, H, W)) < 0.15] = -0.0
        D1[rng.random((B, H, W)) < 0.15] = 0.0
        D2 = rng.choice(vals, (B, H, W))
    elif name.startswith("MIDDLEBURY"):
        p = ElasParams.middlebury()
        for D in (D1, D2):
            D[rng.random((B, H, W)) < 0.3] = -10.0
            D[:, 20:60, 30:100] = -10.0        # holes longer than 3
            D[:, 5, :] = -10.0                 # an empty row
            D[:, :, 7] = -1.0                  # an empty column
    elif name.startswith("subsampled"):
        p = dataclasses.replace(p, subsampling=True)
        D1, D2 = (np.where(D >= 0, D / 2, D) for D in (D1, D2))
    elif name.startswith("gaps and valid runs"):
        for D in (D1, D2):
            D[D < 0] = 7.5                     # only the runs below
            for e in (32, 64, 96):
                for k, lo in enumerate(range(e - 4, e + 1)):
                    # runs of 1-5 pixels ending at, crossing and starting
                    # at the edge, valid runs of 1-3 between them
                    D[:, lo:lo + k % 4 + 1, 5 + 9 * k::17] = -10.0
                    D[:, 5 + 9 * k::13, lo:lo + k % 4 + 1] = -1.0
            D[:, 31:34, 31:34] = -10.0         # a hole on a tile corner
            D[:, 32, 32] = 9.0                 # with one valid pixel in it
    elif name.startswith("one column"):
        D1, D2 = (np.ascontiguousarray(_post_maps(rng, B, W, H).transpose(
            0, 2, 1)) for _ in range(2))
    elif name.startswith(("smaller than the halo", "gap width 8")):
        p = dataclasses.replace(p, ipol_gap_width=8)
    elif name.startswith("gap width 9"):
        p = dataclasses.replace(p, ipol_gap_width=9)
    elif name.startswith("add_corners"):
        p = dataclasses.replace(p, add_corners=True)
    if name.startswith(("gap width", "add_corners")):
        for D in (D1, D2):
            D[D < 0] = 20.0
            _runs(rng, D, 11, H * W // 40)
            D[:, :, :4] = -10.0                # the corners' reach
            D[:, -5:, :] = -1.0
    return (torch.from_numpy(np.ascontiguousarray(D1, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(D2, np.float32)).to(dev), p)


def post_kernels_hold(D1, D2, params, hold, label, smax=-1):
    """Kernels H, I, J, K against their plain versions on [..., H, W] maps
    on the card (hold: torch.equal), and their bits equal (int32 views:
    torch.equal takes -0.0 for +0.0). H under ``params`` and ``smax``; I
    under params and under MIDDLEBURY's 5000-pixel gaps with
    extrapolation; J's 8- and 4-tap variants; K; all on both views
    stacked, and each of I, J, K again with its sinks (the two views'
    frames into two given tensors and the first view's u8 map, its
    epilogue), which must equal the call without them and dmap_u8 of its
    first view; the u8 map alone (elas_u8) against dmap_u8."""
    import torch
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import post
    from jackal_tpu_torch.ops.convert import dmap_u8

    X = torch.stack([D1, D2])
    mb = ElasParams.middlebury()
    checks = [("elas_lr", post.left_right_consistency_check(
                   D1, D2, params, smax),
               post.left_right_consistency_check_plain(D1, D2, params, smax))]
    maps = [("elas_gap", lambda Y, **kw: post.gap_interpolation(Y, params,
                                                               **kw),
             post.gap_interpolation_plain(X, params)),
            ("elas_gap", lambda Y, **kw: post.gap_interpolation(Y, mb, **kw),
             post.gap_interpolation_plain(X, mb)),
            ("elas_mean", post.adaptive_mean, post.adaptive_mean_plain(X)),
            ("elas_mean", post.adaptive_mean_sub,
             post.adaptive_mean_sub_plain(X)),
            ("elas_median", post.median_filter, post.median_filter_plain(X))]
    for kernel, fn, want in maps:
        got = fn(X)
        checks.append((kernel, [got], [want]))
        out = (torch.full_like(D1, 7.0), torch.full_like(D2, 7.0))
        U = torch.empty(D1.shape, dtype=torch.uint8, device=D1.device)
        sunk = fn(X, out=out, u8=U)
        if sunk[0].data_ptr() != out[0].data_ptr():
            raise AssertionError(f"{kernel} {label}: not written to out")
        checks.append((kernel, [*sunk, U], [want[0], want[1],
                                           dmap_u8(want[0])]))
    checks.append(("elas_u8", [post.u8_map(X)], [dmap_u8(X)]))
    for kernel, got, want in checks:
        hold(kernel, f"{kernel} {label}", got, want)
        for g, w in zip(got, want):
            if g.dtype != torch.float32:
                continue
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{kernel} {label}: bits differ at "
                                     f"{int((g.view(torch.int32) != w.view(torch.int32)).sum())} pixels")


def post_work(maps_in: int, maps_out: int, shape) -> int:
    """Bytes a postprocess kernel must move: its float32 maps read once
    and written once."""
    return 4 * int(np.prod(shape)) * (maps_in + maps_out)


def dense_blocks_per_sm(W, params, lr):
    """The blocks of kernel B (lr: its instantiation with the L/R
    epilogue) that fit an SM at row width W: the occupancy its launcher
    sizes the persistent grid by."""
    import ctypes

    from jackal_tpu_torch.ops import cuda_lib

    fn = cuda_lib.load("elas_dense_kernel").elas_dense_per_sm
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    cuda_lib.check(fn(W, params.disp_num, params.grid_size,
                      params.plane_radius, int(lr), ctypes.byref(n)),
                   "elas_dense_per_sm")
    return n.value


def postprocess_phase(dev, hold, node, batch, node_launches, dense_cases,
                      path_launches):
    """Phase 12: the ELAS postprocess kernels H-K and kernel B's L/R
    epilogue. (a) H-K each against its plain version (post_kernels_hold:
    torch.equal and int32 bits) on POST_EDGE_CASES, on the two golden
    fixtures' 640x480 maps, on the node's dense maps of one frame and on
    the batched node's 8; (b) the MIDDLEBURY preset's elas_match on its
    libelas fixture (184x320), K's path, against libelas with the launches
    of B's L/R epilogue and H-K counted (H never, K one launch);
    postprocess_batch on the node's frame, on the card against the CPU;
    (c) each kernel's device time at the node's shape (640x480, B = 1)
    beside its plain version's and its byte bound (a time below it
    fails) and the kernel launches a call as the entry points report
    them (pinned: one each), and I's scan design on MIDDLEBURY's gaps and
    corners over both views (B = 2, two launches); (d) kernel B with the
    L/R epilogue against its plain version and timed beside B alone and
    B then H, at the node's shape and the batched node's, with B's bound,
    and the blocks an SM of B's two instantiations. node: (dense D1,
    dense D2, speckled D1) of phase 4's frame; batch: (D1, D2, lr_smax)
    of phase 4b's chunk; node_launches: H-K's launches over phase 4's 9
    frames; dense_cases: label -> (desc1, desc2, left maps, right maps,
    lr_smax, B's bound ms, bound by) of phase 5; path_launches: the
    launches of H on its path (phase 10, subsampled elas_match) and of B
    with the epilogue on its (phase 4). Returns (the phase's JSON line,
    the kernels line's entries of H-K and of B with the epilogue)."""
    import torch
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import dense as dense_mod
    from jackal_tpu_torch.matching.elas import post
    from jackal_tpu_torch.matching.elas.pipeline import elas_match
    from jackal_tpu_torch.ops.convert import dmap_u8

    params = ElasParams()
    for name in POST_EDGE_CASES:
        D1, D2, p = post_edge_case(name, dev)
        for smax in (-1, 32):
            post_kernels_hold(D1, D2, p, hold, name, smax)
    for fix in GOLDEN:
        g = np.load(f"{FIX}/{fix}.npz")
        post_kernels_hold(torch.from_numpy(g["D1"]).to(dev),
                          torch.from_numpy(g["D2"]).to(dev), params, hold, fix)
    Da, Db, S1 = node
    post_kernels_hold(Da, Db, params, hold, "the node's dense maps")
    BD1, BD2, lad = batch
    post_kernels_hold(BD1, BD2, params, hold, "the batched node's 8 frames",
                      lad)
    print(f"12a. kernels H-K == plain (torch.equal and int32 bits): "
          f"{', '.join(POST_EDGE_CASES)}; {', '.join(GOLDEN)}; the node's "
          f"frame; the batched node's 8 frames (lr_smax {lad})")

    # (b) K's path: MIDDLEBURY, and the whole chain card vs CPU
    g = np.load(f"{FIX}/elas_golden_s320_mb.npz")
    mb = ElasParams.middlebury()
    for k in post.launches:
        post.launches[k] = post.device_launches[k] = 0
    dense_mod.lr_launches = 0
    D1, D2 = elas_match(g["left"], g["right"], mb, device=dev)
    mb_launches = dict(post.launches)
    mb_dev = dict(post.device_launches)
    mb_fused = dense_mod.lr_launches
    _same("MIDDLEBURY elas_match D1 vs libelas", D1, torch.from_numpy(g["D1"]))
    _same("MIDDLEBURY elas_match D2 vs libelas", D2, torch.from_numpy(g["D2"]))
    want = {"elas_lr": 0, "elas_gap": 1, "elas_mean": 0, "elas_median": 1,
            "elas_speckle": 1, "elas_u8": 0}
    if mb_launches != want or mb_fused != 1 or mb_dev["elas_median"] != 1 \
            or mb_dev["elas_speckle"] != SPECKLE_LAUNCHES:
        raise AssertionError(f"MIDDLEBURY elas_match launched {mb_launches}"
                             f" (kernel launches {mb_dev}), B with the L/R "
                             f"epilogue {mb_fused} times")
    print(f"12b. elas_match MIDDLEBURY on the card == libelas D1/D2 "
          f"(elas_golden_s320_mb); launches {mb_launches} (kernel launches "
          f"{mb_dev}), kernel B with the L/R epilogue {mb_fused}")
    for p in (params, mb):
        got = post.postprocess_batch(Da[None], Db[None], p)
        want = post.postprocess_batch(Da[None].cpu(), Db[None].cpu(), p)
        for x, y in zip(got, want):
            _same("postprocess_batch card vs CPU", x, y)
    print("12b. postprocess_batch (ROBOTICS, MIDDLEBURY) on the node's dense "
          "maps: card == CPU")

    # (c) times at the node's shape; I's scan design also on MIDDLEBURY's
    # gaps and corners over both views (B = 2)
    X = S1
    G = post.gap_interpolation(X, params)
    X2 = torch.stack([S1, Db])
    shape = tuple(Da.shape)
    # (label, kernel, call, plain call, bytes, kernel launches a call)
    runs = [
        ("elas_lr", "elas_lr",
         lambda: post.left_right_consistency_check(Da, Db, params),
         lambda: post.left_right_consistency_check_plain(Da, Db, params),
         post_work(2, 2, shape), 1),
        ("elas_gap", "elas_gap", lambda: post.gap_interpolation(X, params),
         lambda: post.gap_interpolation_plain(X, params),
         post_work(1, 1, shape), 1),
        ("elas_mean", "elas_mean", lambda: post.adaptive_mean(G),
         lambda: post.adaptive_mean_plain(G), post_work(1, 1, shape), 1),
        ("elas_median", "elas_median", lambda: post.median_filter(G),
         lambda: post.median_filter_plain(G), post_work(1, 1, shape), 1),
        ("elas_gap MIDDLEBURY B = 2", "elas_gap",
         lambda: post.gap_interpolation(X2, mb),
         lambda: post.gap_interpolation_plain(X2, mb),
         post_work(1, 1, tuple(X2.shape)), 2),
    ]
    # each of I, J, K with the u8 epilogue (its sinks: the float map and
    # the first view's u8 map) beside it without: one byte a pixel more
    u8_shape = tuple(X.shape)
    U1 = torch.empty(u8_shape, dtype=torch.uint8, device=dev)
    O1 = torch.empty_like(X)
    runs += [
        ("elas_gap with the u8 epilogue", "elas_gap",
         lambda: post.gap_interpolation(X, params, out=(O1,), u8=U1),
         lambda: dmap_u8(post.gap_interpolation_plain(X, params)),
         post_work(1, 1, shape) + X.numel(), 1),
        ("elas_mean with the u8 epilogue", "elas_mean",
         lambda: post.adaptive_mean(G, out=(O1,), u8=U1),
         lambda: dmap_u8(post.adaptive_mean_plain(G)),
         post_work(1, 1, shape) + X.numel(), 1),
        ("elas_median with the u8 epilogue", "elas_median",
         lambda: post.median_filter(G, out=(O1,), u8=U1),
         lambda: dmap_u8(post.median_filter_plain(G)),
         post_work(1, 1, shape) + X.numel(), 1),
        ("elas_u8", "elas_u8", lambda: post.u8_map(X, U1),
         lambda: dmap_u8(X), 5 * X.numel(), 1),
    ]
    replaces = {"elas_lr": "matching/elas/post.py:34",
                "elas_gap": "matching/elas/post.py:443",
                "elas_mean": "matching/elas/post.py:587",
                "elas_median": "matching/elas/post.py:686",
                "elas_u8": "pipeline/frame_pipeline.py:382"}
    entries, times = [], {}
    for label, k, kern, plain, nbytes, want in runs:
        # the kernel launches of one call, as the entry point reports them
        before = post.device_launches[k]
        kern()
        per_call = post.device_launches[k] - before
        ms = events_ms(kern, 50)
        pms = events_ms(plain, 3, spin=False)
        bms, by = bound_ms(nbytes, 0, PEAK_F32_OPS_PER_S)
        times[label] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                        "bytes": nbytes, "launches_a_call": per_call}
        print(f"12c. {label} at 640x480{'' if 'B =' in label else ', B = 1'}"
              f": {ms:.5f} ms a call (CUDA events behind a spin; plain "
              f"{pms:.3f}; bound {bms:.6f} by {by}: {nbytes} bytes, "
              f"{ms / bms:.1f}x; {per_call} kernel launches a call)")
        if ms < bms:
            raise AssertionError(f"{label}: {ms} ms is below its bound {bms}"
                                 f" ms")
        if per_call != want:
            raise AssertionError(f"{label}: {per_call} kernel launches a "
                                 f"call, not {want}")
        if label != k:
            continue
        # K runs on the MIDDLEBURY elas_match alone, H (off the presets'
        # paths since it runs as B's epilogue) on the subsampled elas_match;
        # elas_u8 on the bail-out alone (none of the node's frames)
        launches = {"elas_median": mb_launches[k],
                    "elas_lr": path_launches["elas_lr"]}.get(
                        k, node_launches[k])
        entries.append({
            "name": k, "route": "cuda",
            "source": "jackal_tpu_torch/csrc/elas_post_kernel.cu",
            "replaces": f"jackal_tpu/{replaces[k]}",
            "launches": launches, "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
        if k == "elas_lr":
            entries[-1]["fused_into"] = "elas_dense_lr"
        if k in ("elas_gap", "elas_mean", "elas_median"):
            entries[-1]["epilogue"] = ("the u8 map (jackal_tpu/pipeline/"
                                       "frame_pipeline.py:382) where it is "
                                       "the tail's last kernel")

    # the tail and the u8 map at the node's frame: the parent's route (the
    # tail, then dmap_u8's three eager launches) against the tail whose
    # last kernel writes the u8 map; ROBOTICS (I, J, the left view) and
    # MIDDLEBURY (I, K, both views)
    tails = {}
    for name, p, V2 in (("ROBOTICS", params, Db), ("MIDDLEBURY", mb, Db)):
        U = torch.empty(tuple(S1.shape), dtype=torch.uint8, device=dev)
        T1, _ = post.post_tail(S1, V2, p)
        post.post_tail(S1, V2, p, u8=U)
        hold("elas_u8", f"the tail's u8 epilogue, {name}", [U], [dmap_u8(T1)])
        tails[name] = {
            "tail_ms": events_ms(lambda: post.post_tail(S1, V2, p), 50),
            "tail_then_dmap_u8_ms": events_ms(
                lambda: dmap_u8(post.post_tail(S1, V2, p)[0]), 50),
            "tail_with_u8_epilogue_ms": events_ms(
                lambda: post.post_tail(S1, V2, p, u8=U), 50),
            "dmap_u8_alone_ms": events_ms(lambda: dmap_u8(T1), 50)}
        print(f"12c. the tail at 640x480, {name}: " + ", ".join(
            f"{k} {v:.5f}" for k, v in tails[name].items())
            + " (CUDA events behind a spin; the u8 map equal to dmap_u8)")
    times["tail and u8 map"] = tails

    # (d) kernel B with H's epilogue beside B alone and B then H; its bound
    # is B's (it writes the same two maps, already checked)
    fused = {}
    for label, (q1, q2, ml, mr, smax, bnd, by) in dense_cases.items():
        hold("elas_dense_lr", f"dense pair + L/R, {label}",
             dense_mod.dense_match_pair_lr(q1, q2, ml, mr, params, smax),
             dense_mod.dense_match_pair_lr_plain(q1, q2, ml, mr, params,
                                                 smax))
        PD1, PD2 = dense_mod.dense_match_pair(q1, q2, ml, mr, params)

        def b_then_h():
            return post.left_right_consistency_check(
                *dense_mod.dense_match_pair(q1, q2, ml, mr, params), params,
                smax)
        t = {"fused_ms": events_ms(lambda: dense_mod.dense_match_pair_lr(
                 q1, q2, ml, mr, params, smax), 50),
             "b_alone_ms": events_ms(lambda: dense_mod.dense_match_pair(
                 q1, q2, ml, mr, params), 50),
             "b_then_h_ms": events_ms(b_then_h, 50),
             "h_alone_ms": events_ms(lambda: post.left_right_consistency_check(
                 PD1, PD2, params, smax), 50),
             "bound_ms": bnd, "bound_by": by}
        if label == "node":
            t["plain_ms"] = events_ms(
                lambda: dense_mod.dense_match_pair_lr_plain(
                    q1, q2, ml, mr, params, smax), 3, spin=False)
        fused[label] = t
        print(f"12d. kernel B with the L/R epilogue, {label} "
              f"{tuple(q1.shape[:3])}: {t['fused_ms']:.5f} ms a call (B "
              f"alone {t['b_alone_ms']:.5f}, B then H {t['b_then_h_ms']:.5f},"
              f" H alone {t['h_alone_ms']:.5f}; bound {bnd:.5f} by {by}, "
              f"{t['fused_ms'] / bnd:.2f}x)")
        if t["fused_ms"] < bnd:
            raise AssertionError(f"dense + L/R {label}: {t['fused_ms']} ms "
                                 f"is below its bound {bnd} ms")
    W = dense_cases["node"][0].shape[2]
    per_sm = {("with" if lr else "without") + " the L/R epilogue":
              dense_blocks_per_sm(W, params, lr) for lr in (False, True)}
    print(f"12d. kernel B's blocks an SM at {W} columns, plane radius "
          f"{params.plane_radius}: {per_sm}")
    node_t = fused["node"]
    entries.append({
        "name": "elas_dense_lr", "route": "cuda",
        "source": "jackal_tpu_torch/csrc/elas_dense_kernel.cu",
        "replaces": "jackal_tpu/ops/pallas/elas_dense_kernel.py:30",
        "fuses": "jackal_tpu/matching/elas/post.py:34",
        "launches": path_launches["elas_dense_lr"], "ms": node_t["fused_ms"],
        "plain_ms": node_t["plain_ms"], "bound_ms": node_t["bound_ms"],
        "bound_by": node_t["bound_by"], "library_ms": None})
    return {"postprocess": {"middlebury_launches": mb_launches,
                            "middlebury_kernel_launches": mb_dev,
                            "times": times, "dense_lr": fused,
                            "dense_blocks_per_sm": per_sm}}, entries


# kernel L's kernel launches a call: one cooperative launch
# (csrc/speckle_kernel.cu)
SPECKLE_LAUNCHES = 1
# the speckle kernel's cases (tests/test_torch_cuda.py runs them too)
SPECKLE_EDGE_CASES = ("smooth field 60 x 80", "random field 60 x 80",
                      "serpentine spiral 100 x 100", "all valid",
                      "all invalid (-10, -1, NaN)",
                      "checkerboard and stripes: more runs a row than the "
                      "compact slots",
                      "one row: 1 x 200", "one column: 200 x 1",
                      "70 x 101, not multiples of the tile",
                      "t = 0 on quarter-step disparities",
                      "t = 0.1 on 0.05-step disparities",
                      "speckle_size 0", "speckle_size 1",
                      "speckle_size past H * W",
                      "subsampling's speckle_size_eff", "NaN, -0.0 and +0.0",
                      "B = 8 at 640x480", "both views of B = 2",
                      "one component over every tile of 640x480",
                      "a coiled one-pixel path over 480 x 640",
                      "B = 16 at 640x480: tiles past the blocks' shared "
                      "memory", "1 x 4000 frames", "3000 x 1 frames")


def speckle_field(rng, shape, smooth):
    """Disparities with holes (-10): piecewise-smooth integers (few runs a
    row) or random integers 0-7 (a run every pixel or two)."""
    if smooth:
        D = np.round(rng.random(shape) * 1.5 + np.linspace(5, 40, shape[-1]))
        D[rng.random(shape) < 0.08] = -10.0
        D[..., 5:9, :] = -10.0
    else:
        D = rng.integers(-1, 8, shape).astype(np.float64)
        D[D < 0] = -10.0
    return D.astype(np.float32)


def speckle_spiral(n):
    """A one-pixel serpentine spiral of 7.0 on -10: one component that
    bends at every ring, across every tile it crosses."""
    d = np.full((n, n), -10.0, np.float32)
    x, y, dx, dy = 0, 0, 1, 0
    for s in [n - 1 - q // 2 for q in range(2 * n)]:
        if s <= 0:
            break
        for _ in range(s):
            d[y, x] = 7.0
            x, y = x + dx, y + dy
        dx, dy = -dy, dx
    return d


def speckle_coil(n):
    """A one-pixel spiral path of 7.0 on -10 whose rings keep a row or
    column of -10 between them: one component about n^2 / 2 pixels long,
    a chain that turns back across every tile it crosses."""
    d = np.full((n, n), -10.0, np.float32)
    x, y, dx, dy = 0, 0, 1, 0
    d[0, 0] = 7.0
    steps = [n - 1, n - 1, n - 1] + [n - 1 - 2 * (q // 2 + 1)
                                     for q in range(2 * n)]
    for s in steps:
        if s <= 0:
            break
        for _ in range(s):
            x, y = x + dx, y + dy
            d[y, x] = 7.0
        dx, dy = -dy, dx
    return d


def speckle_edge_case(name, dev):
    """(D, params) of one of SPECKLE_EDGE_CASES on dev, from a seed."""
    import torch
    from jackal_tpu_torch.config import ElasParams

    i = SPECKLE_EDGE_CASES.index(name)
    rng = np.random.default_rng(130 + i)
    p = ElasParams()
    if name == SPECKLE_EDGE_CASES[18]:
        # a ramp whose neighbours differ by at most 1, with lone holes: one
        # component in every tile; then stripes that wrap from 4 to 0
        y, x = np.mgrid[0:480, 0:640]
        D = np.stack([(x + y) // 40, (3 * x + y) // 97 % 5]).astype(np.float32)
        D[0][rng.random((480, 640)) < 0.02] = -10.0
    elif name == SPECKLE_EDGE_CASES[19]:
        # a coil over 15 x 15 tiles; its transpose cut in two, whose
        # pieces fall below the coil's own size
        sp = speckle_coil(480)
        D = np.full((2, 480, 640), -10.0, np.float32)
        D[0, :, 80:560] = sp
        D[1, :, :480] = sp.T
        D[1, 240, :] = -10.0
        p = dataclasses.replace(p, speckle_size=int((sp >= 0).sum()))
    elif name == SPECKLE_EDGE_CASES[20]:
        D = speckle_field(rng, (16, 480, 640), True)
        D[::2] = speckle_field(rng, (8, 480, 640), False)
    elif name in SPECKLE_EDGE_CASES[21:23]:
        D = rng.integers(-2, 4, (3, 1, 4000) if name.startswith("1 x")
                         else (3, 3000, 1)).astype(np.float32)
        D[D < 0] = -10.0
        p = dataclasses.replace(p, speckle_size=5)
    elif name.startswith("smooth"):
        D = speckle_field(rng, (2, 60, 80), True)
    elif name.startswith("random"):
        D = speckle_field(rng, (2, 60, 80), False)
    elif name.startswith("serpentine"):
        D = np.stack([speckle_spiral(100), speckle_spiral(100).T])
        D[1, 50, :] = -10.0          # cut into pieces of 4900 and 4901
        p = dataclasses.replace(p, speckle_size=4901)
    elif name == "all valid":
        D = rng.integers(0, 41, (2, 50, 70)).astype(np.float32)
        D[1] = 12.0                              # one component
    elif name.startswith("all invalid"):
        D = rng.choice(np.array([-10.0, -1.0, np.nan], np.float32),
                       (2, 40, 50))
    elif name.startswith("checkerboard"):
        y, x = np.mgrid[0:40, 0:300]
        D = np.stack([np.where((y + x) % 2 == 0, (x // 2) % 7, -10.0),
                      np.where(x % 2 == 0, 0.0, 5.0)]).astype(np.float32)
    elif name.startswith("one row"):
        D = rng.integers(-2, 4, (3, 1, 200)).astype(np.float32)
        D[D < 0] = -10.0
        p = dataclasses.replace(p, speckle_size=5)
    elif name.startswith("one column"):
        D = rng.integers(-2, 4, (3, 200, 1)).astype(np.float32)
        D[D < 0] = -10.0
        p = dataclasses.replace(p, speckle_size=5)
    elif name.startswith("70 x 101"):
        D = speckle_field(rng, (2, 70, 101), True)
        D[1] = speckle_field(rng, (70, 101), False)
        p = dataclasses.replace(p, speckle_size=20)
    elif name.startswith("t = 0 "):
        D = np.round((rng.random((2, 60, 90)) * 2
                      + np.linspace(3, 9, 90)) * 4) / 4
        D[rng.random(D.shape) < 0.1] = -10.0
        p = dataclasses.replace(p, speckle_sim_threshold=0.0, speckle_size=3)
    elif name.startswith("t = 0.1"):
        D = np.round((rng.random((2, 60, 90)) * 0.5
                      + np.linspace(3, 9, 90)) * 20) / 20
        D[rng.random(D.shape) < 0.1] = -10.0
        p = dataclasses.replace(p, speckle_sim_threshold=0.1, speckle_size=6)
    elif name.startswith("speckle_size 0"):
        D = speckle_field(rng, (2, 60, 80), False)
        p = dataclasses.replace(p, speckle_size=0)
    elif name.startswith("speckle_size 1"):
        D = speckle_field(rng, (2, 60, 80), False)
        p = dataclasses.replace(p, speckle_size=1)
    elif name.startswith("speckle_size past"):
        D = speckle_field(rng, (2, 30, 40), True)
        p = dataclasses.replace(p, speckle_size=30 * 40 + 1)
    elif name.startswith("subsampling"):
        D = speckle_field(rng, (2, 60, 80), False)
        D[1] = speckle_field(rng, (60, 80), True)
        p = dataclasses.replace(p, subsampling=True)
    elif name.startswith("NaN"):
        D = rng.integers(0, 3, (2, 60, 80)).astype(np.float32)
        for v, share in ((np.nan, 0.05), (-0.0, 0.2), (0.0, 0.2),
                         (-10.0, 0.1)):
            D[rng.random(D.shape) < share] = v
        p = dataclasses.replace(p, speckle_size=6)
    elif name.startswith("B = 8"):
        D = speckle_field(rng, (8, 480, 640), True)
        D[::2] = speckle_field(rng, (4, 480, 640), False)
    else:                                        # both views of B = 2
        D = speckle_field(rng, (2, 2, 120, 160), True)
        D[1] = speckle_field(rng, (2, 120, 160), False)
    return torch.from_numpy(np.ascontiguousarray(D, np.float32)).to(dev), p


def speckle_hold(D, params, hold, label):
    """Kernel L against its plain versions on [..., H, W] maps on the card:
    remove_small_segments(_batch) and the labels of speckle_labels against
    remove_small_segments_batch_plain and _connected_component_labels,
    bit for bit (int32 views: torch.equal takes NaN for unequal and -0.0
    for +0.0). hold records the largest difference of the maps with their
    NaNs at 0."""
    import torch
    from jackal_tpu_torch.matching.elas import post

    got, lbl = post.speckle_labels(D, params)
    want = post.remove_small_segments_batch_plain(D, params)
    want_lbl = post._connected_component_labels(D,
                                                params.speckle_sim_threshold)
    hold("elas_speckle", f"speckle {label}", [got.nan_to_num()],
         [want.nan_to_num()])
    for name, g, w in (("maps", got, want),
                       ("maps without labels",
                        post.remove_small_segments_batch(D, params), want),
                       ("labels", lbl, want_lbl)):
        g32, w32 = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not torch.equal(g32, w32):
            raise AssertionError(f"speckle {label}: {name} differ at "
                                 f"{int((g32 != w32).sum())} pixels")


# the rectify kernel's cases (tests/test_torch_cuda.py runs them too)
REMAP_EDGE_CASES = ("NaN and out-of-range coordinates: 8 x 10",
                    "rounding ties of 2^-16", "odd sizes: 37 x 53 frames, "
                    "41 x 67 maps", "B x colour: 3 x 3 x 120 x 161",
                    "maps smaller than the frame: 480 x 640 to 120 x 160",
                    "the views' shapes differ",
                    "staged and global tiles in one launch: 2 x 480 x 640",
                    "staged, odd map sizes: 2 x 96 x 128 frames, 37 x 101 "
                    "maps", "the colour call's F = 96: 96 x 480 x 640")


def remap_affine_maps(rng, Ho, Wo, sx, sy, ox, oy):
    """Smooth maps as a rectification's: column x, row y of the output
    read about (sx * x + 0.013 * y + ox, sy * y + 0.011 * x + oy) of the
    frame, with a seeded fraction up to 0.5 on each."""
    y, x = np.mgrid[0:Ho, 0:Wo].astype(np.float64)
    mx = sx * x + 0.013 * y + ox + rng.random((Ho, Wo)) * 0.5
    my = sy * y + 0.011 * x + oy + rng.random((Ho, Wo)) * 0.5
    return mx.astype(np.float32), my.astype(np.float32)


def remap_edge_case(name, dev):
    """(left frames, left maps, right frames, right maps) of one of
    REMAP_EDGE_CASES on dev, from a seed: NaN, +-70000, +-2e9 and +-inf
    coordinates (XLA's saturating convert, NaN -> 0) among seeded ones
    over the frame and past its borders; coordinates on the half steps of
    2^-15 (round half to even); odd frame and map sizes with the maps
    larger than the frame; a batch of 3 frames of 3 colour channels; maps
    smaller than the frame; views whose frames differ in shape (two
    launches of the pair call); then smooth maps whose tiles the kernel
    stages in shared memory: beside tiles of scattered, special and
    far-away coordinates (its global path) in the same launch, past the
    frame's top and left borders; at output sizes that are not multiples
    of its tile or of 4; and over 96 frames, the colour call's F at
    config 5's B = 32."""
    import torch

    i = REMAP_EDGE_CASES.index(name)
    rng = np.random.default_rng(150 + i)
    lead, (H, W), (Ho, Wo) = (
        ((), (8, 10), (9, 13)), ((2,), (30, 40), (30, 40)),
        ((2,), (37, 53), (41, 67)), ((3, 3), (120, 161), (120, 161)),
        ((1,), (480, 640), (120, 160)), ((2,), (50, 70), (30, 40)),
        ((2,), (480, 640), (480, 640)), ((2,), (96, 128), (37, 101)),
        ((96,), (480, 640), (480, 640)))[i]
    special = np.array([np.nan, 70000.0, -70000.0, 2e9, -2e9, np.inf,
                        -np.inf, 0.5, -0.5, -1.0], np.float32)

    def maps(h, w):
        if i >= 6:
            mx, my = remap_affine_maps(
                rng, Ho, Wo, *((0.9, 0.8, 3.0, -2.0) if i == 7
                               else (0.97, 0.74, -3.0, -2.5)))
            if i == 6:
                # scattered coordinates over two tile rows, special ones in
                # a tile, a tile wholly past the right border
                mx[96:128, :256] = rng.random((32, 256)) * (w + 4) - 2
                my[96:128, :256] = rng.random((32, 256)) * (h + 4) - 2
                hit = rng.random((16, 64)) < 0.3
                mx[208:224, 320:384][hit] = rng.choice(special,
                                                       int(hit.sum()))
                mx[400:416, 512:576] += w + 100
            return tuple(torch.from_numpy(m).to(dev) for m in (mx, my))
        mx = (rng.random((Ho, Wo)) * (w + 4) - 2).astype(np.float32)
        my = (rng.random((Ho, Wo)) * (h + 4) - 2).astype(np.float32)
        if i == 1:                      # exact ties of 2^-16
            mx = ((rng.integers(-40, 32768 * w, (Ho, Wo)) * 2 + 1)
                  / 65536.0).astype(np.float32)
            my = ((rng.integers(-40, 32768 * h, (Ho, Wo)) * 2 + 1)
                  / 65536.0).astype(np.float32)
        for m in (mx, my):
            hit = rng.random((Ho, Wo)) < (0.3 if i == 0 else 0.05)
            m[hit] = rng.choice(special, int(hit.sum()))
        return tuple(torch.from_numpy(m).to(dev) for m in (mx, my))

    left = torch.from_numpy(rng.integers(0, 256, (*lead, H, W)).astype(
        np.uint8)).to(dev)
    rH, rW = (H + 3, W - 5) if i == 5 else (H, W)
    right = torch.from_numpy(rng.integers(0, 256, (*lead, rH, rW)).astype(
        np.uint8)).to(dev)
    return left, maps(H, W), right, maps(rH, rW)


def remap_hold(left, lmap, right, rmap, hold, label):
    """Kernel N against its plain version on the card: remap_bilinear on
    each view and remap_bilinear_pair on both, torch.equal (uint8). The
    pair call is one launch where the views' shapes agree, else two;
    where it is one, the pair call again with its tiles counted by path.
    Returns {"staged": tiles, "global": tiles} of that call (None where
    the views' shapes differ)."""
    import torch
    from jackal_tpu_torch.geometry import remap

    n0 = remap.launches["remap"]
    want = (remap.remap_bilinear_plain(left, *lmap),
            remap.remap_bilinear_plain(right, *rmap))
    hold("remap", f"remap {label}", [remap.remap_bilinear(left, *lmap),
                                     remap.remap_bilinear(right, *rmap)],
         want)
    pair = remap.remap_bilinear_pair(left, right, lmap, rmap)
    hold("remap", f"remap pair {label}", pair, want)
    one = left.shape == right.shape and lmap[0].shape == rmap[0].shape
    paths = None
    if one:
        cnt = torch.zeros(2, dtype=torch.int32, device=left.device)
        hold("remap", f"remap pair, paths counted, {label}",
             remap._remap_cuda([(left, *lmap), (right, *rmap)], cnt), want)
        paths = {"staged": int(cnt[0]), "global": int(cnt[1])}
    if remap.launches["remap"] - n0 != 4:
        raise AssertionError(f"remap {label}: {remap.launches['remap'] - n0}"
                             f" launches for 2 calls and {1 + one} pair "
                             f"calls")
    return paths


def remap_work(frames: int, H, W, Ho, Wo, views: int = 2) -> int:
    """Bytes kernel N must move: each u8 frame read once, both float32
    maps of each view read once, each u8 output written once."""
    return views * (frames * H * W + 8 * Ho * Wo + frames * Ho * Wo)


def speckle_phase_split(D, params, reps: int = 20):
    """Kernel L's time split by its phases, which the profiler cannot see
    inside one launch: the medians over reps calls of the launch's first
    block's clock64 spans (csrc/speckle_kernel.cu elas_speckle's stamps).
    Each phase (a tile parts, b border unites, c counts, d kill) spans
    from the end of the barrier before it to the end of the barrier after
    it (d: to the block's end), with its share of the block's whole span;
    "work" is the first block's own part of it, the rest its wait at the
    barrier for the slowest block and the barrier itself."""
    import torch
    from jackal_tpu_torch.matching.elas import post

    stamps = torch.zeros(8, dtype=torch.int64, device=D.device)
    runs = []
    for _ in range(reps + 2):
        post._speckle_cuda(D, params, False, stamps)
        runs.append(stamps.cpu().tolist())
    runs = runs[2:]

    def med(i, j):
        return statistics.median(r[j] - r[i] for r in runs)

    total = med(0, 7)
    out = {}
    for name, (i, w, j) in zip(("a tile parts", "b border unites",
                                "c counts", "d kill"),
                               ((0, 1, 2), (2, 3, 4), (4, 5, 6), (6, 7, 7))):
        out[name] = {"cycles": med(i, j), "share": med(i, j) / total,
                     "work_cycles": med(i, w)}
    return out


def speckle_remap_phase(dev, hold, node, batch, pipe, raw, node_launches):
    """Phase 13: kernels L (speckle) and N (rectify). (a) L against its
    plain versions, maps and labels bit for bit (speckle_hold), on
    SPECKLE_EDGE_CASES and on the node's and the batched node's maps after
    their L/R check (phase 4, 4b), ROBOTICS and with t = 0 and 12, both
    views stacked, with its launches a call (one call, one cooperative
    kernel launch) pinned, and its launch plans (grid, spilled tiles) at
    640x480 and B = 1, 8, 16; (b) N against its plain version
    (torch.equal) on REMAP_EDGE_CASES, on phase 4's 9 raw pairs with the
    node's maps, on BASELINE config 5's 32 golden frames with its maps and
    on config 5's colour call (32 seeded colour frames, F = 96), one
    launch a pair call, with its tiles by path (staged, global); (c) L's
    and N's device times at the node's shape and the batched ones beside
    their plain versions', their byte bounds and, for L, the host ms of
    the BFS hop it replaced on the node and its split by phase (in-kernel
    clocks). node: (left, right) maps of phase 4's frame after the L/R
    check; batch: phase 4b's; pipe: phase 4's pipeline; raw: its raw
    (left, right) pairs [9, H, W]; node_launches: L's and N's launches
    over phase 4's 9 frames. Returns (the phase's JSON line, the kernels
    line's entries of L and N)."""
    import torch
    from jackal_tpu_torch.config import BMParams, ElasParams, PipelineParams
    from jackal_tpu_torch.geometry import remap
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.matching.elas import post
    from jackal_tpu_torch.pipeline.default import make_pipeline

    params = ElasParams()
    l0, d0 = post.launches["elas_speckle"], post.device_launches["elas_speckle"]
    for name in SPECKLE_EDGE_CASES:
        D, p = speckle_edge_case(name, dev)
        speckle_hold(D, p, hold, name)
    n_edge = len(SPECKLE_EDGE_CASES)
    (L1, L2), (B1, B2) = node, batch
    for label, X in (("the node's frame", torch.stack([L1, L2])),
                     ("the batched node's 8 frames", torch.stack([B1, B2]))):
        for t in (1.0, 0.0, 12.0):
            speckle_hold(X, dataclasses.replace(
                params, speckle_sim_threshold=t), hold, f"{label}, t = {t}")
    calls = post.launches["elas_speckle"] - l0
    kern = post.device_launches["elas_speckle"] - d0
    if calls != 2 * (n_edge + 6) or kern != SPECKLE_LAUNCHES * calls:
        raise AssertionError(f"speckle: {calls} calls and {kern} kernel "
                             f"launches for {2 * (n_edge + 6)} calls")
    plans = {f"B = {b}": dict(zip(("grid", "spilled_labels"),
                                  post.speckle_plan(dev, b, 480, 640)))
             for b in (1, 8, 16)}
    if plans["B = 16"]["spilled_labels"] == 0:
        raise AssertionError(f"speckle: B = 16 spilled no tile: {plans}")
    print(f"13a. kernel L == plain (maps and labels, int32 bits): "
          f"{', '.join(SPECKLE_EDGE_CASES)}; the node's and the batched "
          f"node's maps after the L/R check, both views, t = 1, 0, 12; "
          f"{calls} calls, {kern} kernel launches ({SPECKLE_LAUNCHES} a "
          f"call); launch plans at 640x480: {plans}")

    paths = {}
    for name in REMAP_EDGE_CASES:
        paths[name] = remap_hold(*remap_edge_case(name, dev), hold, name)
    mixed = paths[REMAP_EDGE_CASES[6]]
    if not (mixed["staged"] and mixed["global"]):
        raise AssertionError(f"remap: {REMAP_EDGE_CASES[6]} took {mixed}")
    raw_l, raw_r = raw
    paths["phase 4's 9 raw pairs"] = remap_hold(
        raw_l, pipe.lmap, raw_r, pipe.rmap, hold, "phase 4's 9 raw pairs")
    size = dict(im_width=640, im_height=480, crop_im_width=640,
                crop_im_height=480)
    cfg5 = make_pipeline(engine="bm", bm_params=BMParams(disp_num=64),
                         params=PipelineParams(calib_im_size=(640, 360),
                                               gen_pcl=True, **size),
                         device=dev)
    scene = np.arange(CONFIG5_B) % len(GOLDEN)
    gold = [np.load(f"{FIX}/{f}.npz") for f in GOLDEN]
    l5 = torch.from_numpy(np.stack([gold[s]["left"] for s in scene])).to(dev)
    r5 = torch.from_numpy(np.stack([gold[s]["right"] for s in scene])).to(dev)
    paths[f"config 5's {CONFIG5_B} frames"] = remap_hold(
        l5, cfg5.lmap, r5, cfg5.rmap, hold, f"config 5's {CONFIG5_B} frames")
    # config 5's colour call: the raw colour frames' channels ride the
    # batch axis of one launch on the left maps (F = 96)
    col5 = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (CONFIG5_B, *l5.shape[-2:], 3)).astype(np.uint8)).to(dev)
    colc = col5.movedim(-1, -3).contiguous()
    nf = colc.shape[0] * colc.shape[1]            # 32 frames x 3 channels
    n0 = remap.launches["remap"]
    got = cfg5._rectify_crop_color(col5)
    if remap.launches["remap"] - n0 != 1:
        raise AssertionError(f"the colour call launched N "
                             f"{remap.launches['remap'] - n0} times")
    want = remap.remap_bilinear_plain(colc, *cfg5.lmap)
    pp = cfg5.p
    hold("remap", "remap, config 5's colour call", [got], [want[
        ..., pp.crop_offset_y:pp.crop_offset_y + pp.crop_im_height,
        pp.crop_offset_x:pp.crop_offset_x + pp.crop_im_width].movedim(
            -3, -1)])
    cnt = torch.zeros(2, dtype=torch.int32, device=dev)
    hold("remap", "remap, config 5's colour frames, paths counted",
         remap._remap_cuda([(colc, *cfg5.lmap)], cnt), [want])
    paths["config 5's colour call"] = {"staged": int(cnt[0]),
                                       "global": int(cnt[1])}
    for k in ("phase 4's 9 raw pairs", f"config 5's {CONFIG5_B} frames",
              "config 5's colour call"):
        if paths[k]["staged"] == 0:
            raise AssertionError(f"remap: {k} staged no tile: {paths[k]}")
    print(f"13b. kernel N == plain (torch.equal): "
          f"{', '.join(REMAP_EDGE_CASES)}; phase 4's 9 raw pairs; config 5's"
          f" {CONFIG5_B} frames and its colour call (F = "
          f"{nf}); one launch a pair call; output tiles by path "
          f"(staged, global): {paths}")

    # (c) times: L on the node's left view (its path), on the batched
    # node's 8 and on 16 frames (spilled tiles); N's pair call on the
    # node's raw pair and config 5's batch, and config 5's colour call
    X8 = B1
    X16 = speckle_edge_case(SPECKLE_EDGE_CASES[20], dev)[0]
    n0 = post.device_launches["elas_speckle"]
    post.remove_small_segments(L1, params)
    per_call = post.device_launches["elas_speckle"] - n0
    times, entries = {}, []
    runs = [
        ("elas_speckle", lambda: post.remove_small_segments(L1, params),
         lambda: post.remove_small_segments_batch_plain(L1, params),
         post_work(1, 1, tuple(L1.shape)), "640x480, B = 1"),
        ("elas_speckle", lambda: post.remove_small_segments_batch(X8, params),
         lambda: post.remove_small_segments_batch_plain(X8, params),
         post_work(1, 1, tuple(X8.shape)), "640x480, B = 8"),
        ("elas_speckle",
         lambda: post.remove_small_segments_batch(X16, params),
         lambda: post.remove_small_segments_batch_plain(X16, params),
         post_work(1, 1, tuple(X16.shape)), "640x480, B = 16 (spilled)"),
    ]
    Hr, Wr = raw_l.shape[-2:]
    Ho, Wo = pipe.lmap[0].shape
    r1l, r1r = raw_l[:1], raw_r[:1]
    runs += [
        ("remap", lambda: remap.remap_bilinear_pair(r1l, r1r, pipe.lmap,
                                                    pipe.rmap),
         lambda: (remap.remap_bilinear_plain(r1l, *pipe.lmap),
                  remap.remap_bilinear_plain(r1r, *pipe.rmap)),
         remap_work(1, Hr, Wr, Ho, Wo),
         f"both views, {Wr}x{Hr} to {Wo}x{Ho}, B = 1"),
        ("remap", lambda: remap.remap_bilinear_pair(l5, r5, cfg5.lmap,
                                                    cfg5.rmap),
         lambda: (remap.remap_bilinear_plain(l5, *cfg5.lmap),
                  remap.remap_bilinear_plain(r5, *cfg5.rmap)),
         remap_work(CONFIG5_B, *l5.shape[-2:], *cfg5.lmap[0].shape),
         f"both views, config 5's B = {CONFIG5_B}"),
        ("remap", lambda: remap.remap_bilinear(colc, *cfg5.lmap),
         lambda: remap.remap_bilinear_plain(colc, *cfg5.lmap),
         remap_work(nf, *l5.shape[-2:], *cfg5.lmap[0].shape, 1),
         f"config 5's colour frames, F = {nf}, one view"),
    ]
    for k, kern_fn, plain, nbytes, label in runs:
        ms = events_ms(kern_fn, 50)
        pms = events_ms(plain, 3, spin=False)
        bms, by = bound_ms(nbytes, 0, PEAK_F32_OPS_PER_S)
        times[f"{k} {label}"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                                 "bytes": nbytes}
        print(f"13c. {k} at {label}: {ms:.5f} ms a call (CUDA events behind"
              f" a spin; plain {pms:.3f}; bound {bms:.6f} by {by}: {nbytes} "
              f"bytes, {ms / bms:.1f}x)")
        if ms < bms:
            raise AssertionError(f"{k} {label}: {ms} ms is below its bound "
                                 f"{bms} ms")
        if not entries or entries[-1]["name"] != k:
            src = {"elas_speckle": "speckle_kernel", "remap": "remap_kernel"}
            entries.append({
                "name": k, "route": "cuda",
                "source": f"jackal_tpu_torch/csrc/{src[k]}.cu",
                "replaces": {"elas_speckle":
                             "jackal_tpu/matching/elas/post.py:356",
                             "remap": "jackal_tpu/geometry/remap.py:57"}[k],
                "also_replaces": {"elas_speckle": [
                    "jackal_tpu/matching/elas/post.py:129",
                    "jackal_tpu/matching/elas/post.py:242"],
                    "remap": ["jackal_tpu/geometry/remap.py:106"]}[k],
                "paths": {"elas_speckle": plans, "remap": paths}[k],
                "launches": node_launches[k], "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the colour call as the node makes it: the channels' transpose copy
    # (torch), N, the crop
    col_ms = events_ms(lambda: cfg5._rectify_crop_color(col5), 50)
    times["remap config 5's colour call (_rectify_crop_color)"] = {
        "ms": col_ms}
    print(f"13c. config 5's colour call _rectify_crop_color ({CONFIG5_B} "
          f"frames of 3 channels, the transpose copy included): "
          f"{col_ms:.5f} ms a call (CUDA events behind a spin)")
    hop = host_ms(lambda: ep._speckle(L1, params), 5)
    print(f"13c. the BFS hop L replaced on the node (D1 to the host, C++ "
          f"BFS, back), host clock: {hop:.3f} ms; L's kernel launches a "
          f"call: {per_call}")
    # L's split by phase: the profiler sees one launch, so the first
    # block's clocks give each phase's share of the call's time
    parts = {}
    for label, X, run in (("B = 1", L1, "B = 1"), ("B = 8", X8, "B = 8"),
                          ("B = 16", X16, "B = 16 (spilled)")):
        parts[label] = speckle_phase_split(X, params)
        call = times[f"elas_speckle 640x480, {run}"]["ms"]
        for v in parts[label].values():
            v["ms"] = v["share"] * call
        print(f"13c. L's phases at {label} (share of the first block's "
              f"clock64 span, times the call's {call:.5f} ms; its own work "
              f"in cycles): " + ", ".join(
                  f"{k} {v['ms']:.5f} ms ({v['share']:.3f}, "
                  f"{v['cycles']:.0f} cycles, work {v['work_cycles']:.0f})"
                  for k, v in parts[label].items()))
    times["elas_speckle phases"] = parts
    if per_call != SPECKLE_LAUNCHES:
        raise AssertionError(f"speckle: {per_call} kernel launches a call")
    return {"speckle_remap": {"times": times, "bfs_hop_ms": hop,
                              "speckle_launches_a_call": per_call,
                              "speckle_plans": plans,
                              "remap_paths": paths}}, entries

# ---- kernels P1-P3: the scan and the cloud (phase 14) --------------------

# the scan kernels' names in the kernels line and in scan/obstacle.launches
# (P1, P2, P3) and launches_fused (the fused cloud and scan)
SCAN_KERNELS = ("scan", "cloud", "scan_points", "cloud_scan")
# launches of P1-P3 read by pin_scan, by path (phase 14's kernels line)
SCAN_LAUNCHES = {}
# f32 operations a point as csrc/scan_kernel.cu writes them, an FFMA as two
# and each __fdiv_rn and __fsqrt_rn as one (they take more instructions on
# the card; flushes, selects and comparisons are not counted, so the bound
# stays a lower one). Every point: P1 the pixel's coordinates 2, w and the
# numerators of X, Y, Z 4 x 6, the three divisions 3, Xr and Yr 2 x 6; P2
# 2 + 24 + 3 and Xr, Yr, Zr 3 x 6; P3 the ground threshold 3 (a
# difference, an FFMA); cloud_scan P2's and P3's. An accepted point only
# (SCAN_ACCEPTED_OPS; a rejected one skips them): the range 4 (a product,
# an FFMA, the root), the angle 26 (glibc's atan2f on its shortest path:
# the quotient 1, z and w 2, the two polynomials 11 + 9, t * (s1 + s2) 2,
# t - p 1), the bin 4 (an FFMA, the ratio, floor)
_ANGLE_OPS = 1 + 2 + 11 + 9 + 2 + 1
SCAN_ACCEPTED_OPS = 4 + _ANGLE_OPS + 4
SCAN_OPS = {"scan": 2 + 24 + 3 + 12, "cloud": 2 + 24 + 3 + 18,
            "scan_points": 3}
SCAN_OPS["cloud_scan"] = SCAN_OPS["cloud"] + SCAN_OPS["scan_points"]
# the calibration the kernels read: Q [4, 4], XR [3, 3], XT [3] float32
_CALIB_BYTES = (16 + 9 + 3) * 4


def scan_work(kernel: str, B: int, H: int, W: int, bins: int = 90,
              colour: bool = False, accepted=None):
    """(bytes, f32 operations) of one call of kernel P1 ("scan"), P2
    ("cloud"), P3 ("scan_points") or the fused cloud and scan
    ("cloud_scan") on B sets of H x W pixels or points: each input byte
    read once, each output byte written once. P1 reads the u8 maps, the u8
    [H, W, 2] cache and the calibration and writes bins + 4 floats a set;
    P2 reads the maps (and the colour frames) and the calibration and
    writes 12 + 4 + 1 bytes a pixel; P3 reads 12 + 1 bytes a point and
    writes as P1; cloud_scan moves P2's bytes and writes P1's outputs. The
    int32 scratch is not counted. accepted: the points of these inputs that
    the scan accepts (scan_accepted), which alone take the range, the angle
    and the bin; None counts every point of a scan kernel as accepted (the
    most the shape can need)."""
    n = B * H * W
    out = B * (bins + 4) * 4
    cloud = n * (1 + 3 * colour + 12 + 4 + 1) + _CALIB_BYTES
    nbytes = {"scan": n + 2 * H * W + _CALIB_BYTES + out, "cloud": cloud,
              "scan_points": n * 13 + out, "cloud_scan": cloud + out}[kernel]
    if kernel == "cloud":
        accepted = 0
    elif accepted is None:
        accepted = n
    return nbytes, n * SCAN_OPS[kernel] + accepted * SCAN_ACCEPTED_OPS


def scan_accepted(valid_disp=None, dmaps=None, gp=None, pts=None,
                  valid=None) -> int:
    """The points a scan accepts, counted on the card by the plain
    version's rules: P1's u8 dmaps within the valid-range cache
    valid_disp, or (P3, cloud_scan) the points pts under their mask valid
    that the ground gate gp keeps. Only these take the range, the angle
    and the bin (scan_work's accepted)."""
    import torch
    from jackal_tpu_torch.scan import obstacle as obs

    if dmaps is not None:
        d = dmaps.to(torch.int32)
        ok = (d >= valid_disp[..., 0].to(torch.int32)) \
            & (d <= valid_disp[..., 1].to(torch.int32))
    else:
        ok = valid & ~obs._ground_mask(pts[..., 0], pts[..., 2], gp)
    return int(ok.sum())


def scan_counts() -> dict:
    """The launch counters of P1-P3 and the fused cloud and scan."""
    from jackal_tpu_torch.scan import obstacle

    return {**obstacle.launches, **obstacle.launches_fused}


def pin_scan(label: str, scan: int = 0, cloud: int = 0, points: int = 0,
             fused: int = 0, key=None) -> dict:
    """Raise unless kernels P1, P2, P3 and the fused cloud and scan
    launched scan, cloud, points and fused times since their counters were
    set to 0 (reset_scan); records the counts under key in
    SCAN_LAUNCHES."""
    got = scan_counts()
    want = dict(zip(SCAN_KERNELS, (scan, cloud, points, fused)))
    print(f"{label}: launches of P1-P3 and cloud_scan {got}")
    if got != want:
        raise AssertionError(f"{label}: P1-P3 and cloud_scan launched {got},"
                             f" not {want}")
    if key is not None:
        SCAN_LAUNCHES[key] = got
    return got


def reset_scan() -> None:
    from jackal_tpu_torch.scan import obstacle

    for counts in (obstacle.launches, obstacle.launches_fused):
        for k in counts:
            counts[k] = 0


# kernels P1-P3's cases (tests/test_torch_cuda.py runs them too)
SCAN_EDGE_CASES = (
    "NaN and +-inf points: 4 sets of 500",
    "one ulp either side of every bin edge: 90 bins over 90 degrees",
    "one ulp either side of every bin edge: 90 bins over 60 degrees",
    "one ulp either side of every bin edge: 45 bins over 70 degrees",
    "bin 90 exactly: points on y = -x",
    "on the ground threshold: 2 sets of 4000, a fifth on it",
    "an empty set and an all-ground set beside a full one",
    "seeded maps, B = 1 at 480 x 640, no colour",
    "seeded maps, B = 8 at 480 x 640, colour as the node's planar view",
    "seeded maps, B = 32 at 96 x 128, contiguous colour",
    "a width that is no multiple of 32: 2 x 37 x 101",
    "nonzero crop offsets: 150 x 300 at (8, 20)",
    "a cache that accepts d = 0: NaN and infinite points",
    "flushed operands: [2, 0.1, 0.5] beside every pair of operand classes",
    "flushed ground gate: zero height and distance, x and z of the classes",
    "flushed reprojection: 4 x 12 x 16 maps whose Xr and Yr are tiny")


def scan_classes():
    """The operand classes of the scan's flush cases (as
    tests/test_torch_scan_flush.py): +-0, the least subnormal, 1e-40,
    1.17e-38, the largest subnormal, the least normal, 1e-20 and 1e-30
    (whose squares underflow), +-1, +-2, +-inf, four seeded subnormals
    and NaN."""
    f32 = np.float32
    mags = [f32(0.0), f32(1.4e-45), f32(1e-40), f32(1.17e-38),
            np.array([0x007FFFFF], np.uint32).view(np.float32)[0],
            f32(1.1754944e-38), f32(1e-20), f32(1e-30), f32(1.0), f32(2.0),
            f32(np.inf)]
    mags += list(np.random.default_rng(21).integers(1, 1 << 23, 4)
                 .astype(np.uint32).view(np.float32))
    return np.array([s * m for m in mags for s in (f32(1), f32(-1))]
                    + [f32(np.nan)], np.float32)


def tiny_calibration(sx: float, sy: float):
    """Q, XR, XT (float32 numpy) whose products and sums are exact: w = d/2,
    X = (u - 6) / w, Y = (v - 4) / w, Z = 8 / w; Xr = sx * Z, Yr = -sy * X,
    Zr = -Y."""
    Q = np.array([[1, 0, 0, -6], [0, 1, 0, -4], [0, 0, 0, 8],
                  [0, 0, 0.5, 0]], np.float32)
    XR = np.array([[0, 0, sx], [-sy, 0, 0], [0, -1, 0]], np.float32)
    return Q, XR, np.zeros(3, np.float32)


def scan_edge_thetas(sp, ulps: int = 8):
    """float32 angles within ``ulps`` ulps of every bin edge of sp: where
    (fov/2 - theta * 180/REF_PI) * ratio is an integer."""
    from jackal_tpu_torch.scan.obstacle import _bin_constants

    deg, half, ratio = _bin_constants(sp)
    out = []
    for m in range(sp.bin_size + 1):
        t0 = np.float32((half - m / ratio) / deg)
        for step in (-np.inf, np.inf):
            t = t0
            for _ in range(ulps):
                t = np.nextafter(t, np.float32(step))
                out.append(t)
        out.append(t0)
    return np.array(out, np.float32)


def scan_edge_case(name, dev):
    """One of SCAN_EDGE_CASES on dev, from a seed: {"sp", "gp" and either
    "points": (points [S, N, 3], valid [S, N]) or "maps": (u8 maps [..., H,
    W], u8 cache [H, W, 2], crop offset x, y, colour frames [..., H, W, 3]
    or None)}. Points: NaN and +-inf coordinates, accepted and not, among
    seeded ones; angles a few ulps either side of every bin edge at the
    presets' field and at two others; points on y = -x (bin 90, dropped);
    points on the ground threshold (Zr = the float64 threshold rounded);
    a set with no valid point and one whose points all lie under the
    ground beside a full one; the flush cases: a set a pair of operand
    classes (scan_classes) beside [2, 0.1, 0.5], and the ground gate at a
    zero threshold with x and z of the classes. Maps: seeded u8 maps with
    seeded caches at the node's shape, 8 frames with the node's
    channel-planar colour view, 32 frames, a width that is no multiple of
    32, crop offsets, a cache whose lower bound is 0 (w = 0 there:
    infinite and NaN points), and maps with their own calibration
    ("calib": tiny_calibration) whose reprojection flushes."""
    import torch
    from jackal_tpu_torch.config import GroundPlaneParams, ScanParams

    i = SCAN_EDGE_CASES.index(name)
    rng = np.random.default_rng(300 + i)
    sp, gp = ScanParams(), GroundPlaneParams()

    def points(pts, valid, sp=sp):
        return {"sp": sp, "gp": gp, "points": (
            torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev),
            torch.from_numpy(np.asarray(valid, bool)).to(dev))}

    if i == 0:
        S, N = 4, 500
        pts = np.stack([rng.uniform(-2, 8, (S, N)), rng.uniform(-8, 8, (S, N)),
                        rng.uniform(-0.5, 1.0, (S, N))], -1)
        hit = rng.random((S, N, 3)) < 0.05
        pts[hit] = rng.choice([np.nan, np.inf, -np.inf], int(hit.sum()))
        valid = rng.random((S, N)) < 0.8
        valid[3] = True                          # every NaN point accepted
        pts[3, 0] = (np.nan, 1.0, 0.5)
        return points(pts, valid)
    if i in (1, 2, 3):
        fov, bins = ((90.0, 90), (60.0, 90), (70.0, 45))[i - 1]
        spe = ScanParams(fov_deg=fov, bin_size=bins)
        th = scan_edge_thetas(spe).astype(np.float64)
        r = rng.uniform(0.5, 5.0, th.size)
        pts = np.stack([r * np.cos(th), r * np.sin(th), np.ones_like(r)], -1)
        # one point a set: each edge point fills its own bin
        return points(pts[:, None], np.ones((th.size, 1), bool), spe)
    if i == 4:
        x = rng.uniform(0.1, 6.0, 200)
        pts = np.stack([x, -x, rng.uniform(0.2, 1.0, 200)], -1)
        pts[:2] = ((1.0, -1.0, 0.5), (np.inf, -np.inf, 0.5))
        return points(pts[None], np.ones((1, 200), bool))
    if i == 5:
        S, N = 2, 4000
        Xr = rng.uniform(0.1, 6.0, (S, N))
        Zr = rng.uniform(-0.3, 0.8, (S, N))
        on = rng.random((S, N)) < 0.2
        thresh = np.where(Xr < gp.dist_thresh, gp.height_thresh,
                          gp.height_thresh + np.tan(gp.angle_thresh)
                          * (Xr - gp.dist_thresh))
        pts = np.stack([Xr, rng.uniform(-5, 5, (S, N)),
                        np.where(on, thresh, Zr)], -1)
        return points(pts, rng.random((S, N)) < 0.8)
    if i == 6:
        N = 1000
        pts = np.stack([rng.uniform(0.1, 6, (3, N)), rng.uniform(-5, 5, (3, N)),
                        rng.uniform(0.2, 1.0, (3, N))], -1)
        pts[1, :, 2] = -5.0                      # all under the ground
        valid = np.ones((3, N), bool)
        valid[0] = False                         # no valid point
        return points(pts, valid)
    if i in (13, 14):
        c = scan_classes()
        if i == 13:
            y, x = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
            z = np.full_like(x, 0.5)
        else:
            gp = GroundPlaneParams(height_thresh=0.0, dist_thresh=0.0)
            z, x = (a.ravel() for a in np.meshgrid(c[np.isfinite(c)], c,
                                                   indexing="ij"))
            y = np.full_like(x, 0.25)
        pts = np.stack([np.broadcast_to(np.float32([2.0, 0.1, 0.5]),
                                        (x.size, 3)),
                        np.stack([x, y, z], -1)], 1)
        return points(pts, np.ones((x.size, 2), bool))
    if i == 15:
        dm = rng.integers(0, 60, (4, 12, 16)).astype(np.uint8)
        lo = rng.integers(0, 4, (12, 16))
        vd = np.stack([lo, np.full_like(lo, 255)], -1).astype(np.uint8)
        col = rng.integers(0, 256, (4, 12, 16, 3)).astype(np.uint8)
        return {"sp": sp, "gp": gp, "maps": tuple(
            torch.from_numpy(a).to(dev) for a in (dm, vd)) + (0, 0, (
                torch.from_numpy(col).to(dev))), "calib": tuple(
            torch.from_numpy(a).to(dev)
            for a in tiny_calibration(2.0 ** -66, 2.0 ** -130))}
    lead, (H, W), ox, oy, colour = (
        ((1,), (480, 640), 0, 0, None), ((8,), (480, 640), 0, 0, "planar"),
        ((32,), (96, 128), 0, 0, "contiguous"), ((2,), (37, 101), 0, 0, None),
        ((2,), (150, 300), 8, 20, "planar"),
        ((2,), (120, 160), 0, 0, "contiguous"))[i - 7]
    dm = rng.integers(0, 120, (*lead, H, W)).astype(np.uint8)
    lo = rng.integers(0, 20, (H, W))
    if i == 12:
        lo[:] = 0
        dm[rng.random(dm.shape) < 0.05] = 0
    vd = np.stack([lo, np.minimum(lo + rng.integers(20, 200, (H, W)), 255)],
                  -1).astype(np.uint8)
    col = None
    if colour == "planar":
        col = torch.from_numpy(rng.integers(0, 256, (*lead, 3, H, W)).astype(
            np.uint8)).to(dev).movedim(-3, -1)
    elif colour == "contiguous":
        col = torch.from_numpy(rng.integers(0, 256, (*lead, H, W, 3)).astype(
            np.uint8)).to(dev)
    return {"sp": sp, "gp": gp, "maps": (
        torch.from_numpy(dm).to(dev), torch.from_numpy(vd).to(dev), ox, oy,
        col)}


def scan_same(kernel, name, got, want, hold):
    """hold() on float tensors that may hold NaN: the NaN masks equal, the
    rest torch.equal (so +0 equals -0, as the extrema's signed zeros may
    differ)."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{name}[{i}]: NaN masks differ")
    hold(kernel, name, [torch.nan_to_num(g, nan=0.0) for g in got],
         [torch.nan_to_num(w, nan=0.0) for w in want])


def scan_hold(case, calib, hold, label):
    """Kernels P1, P2, P3 and the fused cloud and scan against their plain
    versions on the card on one case of scan_edge_case (or a dict of its
    form; its own "calib" in place of calib where it has one): P1 on its
    maps; P2 and the fused kernel on its maps with its colour and without,
    the fused scan also against P3 on P2's cloud; P3 on its points or on
    P2's cloud of its maps. Scans: NaN masks equal, torch.equal otherwise
    (scan_same); clouds: points so, rgb bits and valid torch.equal.
    Raises unless each call launched its kernel once. Returns the
    ScanResult of P3 (P1's where the case has maps)."""
    import torch
    from jackal_tpu_torch.scan import obstacle as obs

    Q, XR, XT = case.get("calib", calib)
    sp, gp = case["sp"], case["gp"]
    fields = ("scan", "angle_min", "angle_max", "range_min", "range_max")
    n0 = scan_counts()
    calls = {k: 0 for k in SCAN_KERNELS}

    def cloud_same(kernel, name, got, want):
        scan_same(kernel, f"{name} points", [got[0]], [want[0]], hold)
        hold(kernel, f"{name} rgb bits and valid",
             [got[1].view(torch.int32), got[2]],
             [want[1].view(torch.int32), want[2]])

    if "maps" in case:
        dm, vd, ox, oy, col = case["maps"]
        got = obs.obstacle_scan_from_disparity(dm, vd, Q, XR, XT, sp, ox, oy)
        want = obs.obstacle_scan_from_disparity_plain(dm, vd, Q, XR, XT, sp,
                                                      ox, oy)
        scan_same("scan", f"P1 {label}", [getattr(got, f) for f in fields],
                  [getattr(want, f) for f in fields], hold)
        calls["scan"] += 1
        out = got
        for c in (col, None) if col is not None else (None,):
            tag = f"{label}, colour {c is not None}"
            cloud = obs.point_cloud_from_disparity(dm, c, Q, XR, XT, sp, ox,
                                                   oy)
            cloud_same("cloud", f"P2 {tag}", cloud,
                       obs.point_cloud_from_disparity_plain(
                           dm, c, Q, XR, XT, sp, ox, oy))
            fc, fs = obs.cloud_and_scan_from_disparity(dm, c, Q, XR, XT, sp,
                                                       gp, ox, oy)
            pc, ps = obs.cloud_and_scan_from_disparity_plain(
                dm, c, Q, XR, XT, sp, gp, ox, oy)
            cloud_same("cloud_scan", f"cloud_scan {tag}", fc, pc)
            scan_same("cloud_scan", f"cloud_scan {tag} scan",
                      [getattr(fs, f) for f in fields],
                      [getattr(ps, f) for f in fields], hold)
            p3 = obs.obstacle_scan_from_points(cloud[0], cloud[2], sp, gp)
            scan_same("cloud_scan", f"cloud_scan {tag} scan against P2 then "
                      f"P3", [getattr(fs, f) for f in fields],
                      [getattr(p3, f) for f in fields], hold)
            calls["cloud"] += 1
            calls["cloud_scan"] += 1
            calls["scan_points"] += 1
        pts, valid = cloud[0], cloud[2]
    else:
        pts, valid = case["points"]
    got = obs.obstacle_scan_from_points(pts, valid, sp, gp)
    want = obs.obstacle_scan_from_points_plain(pts, valid, sp, gp)
    scan_same("scan_points", f"P3 {label}", [getattr(got, f) for f in fields],
              [getattr(want, f) for f in fields], hold)
    calls["scan_points"] += 1
    grew = {k: v - n0[k] for k, v in scan_counts().items()}
    if grew != calls:
        raise AssertionError(f"scan {label}: launches {grew} for {calls} "
                             f"calls")
    return out if "maps" in case else got


def scratch_zero() -> int:
    """The entries of the scan kernels' cached scratch (scan/obstacle
    _scratch); raises unless every one is 0 (each launch's last blocks set
    it back)."""
    import torch
    from jackal_tpu_torch.scan import obstacle as obs

    torch.cuda.synchronize()
    bad = {k: int(t.count_nonzero()) for k, t in obs._scratch.items()
           if bool(t.any())}
    if bad:
        raise AssertionError(f"scan scratch not set back to 0: {bad}")
    return sum(t.numel() for t in obs._scratch.values())


def aten_ops_of_a_call(fn) -> list:
    """(name, launches no kernel on the card) of each ATen op that fn()
    dispatches: an op whose outputs lie on the host, a view or an
    allocation launches none; a kernel launched through ctypes is no ATen
    op."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    ops = []

    class _Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            on_card = any(isinstance(t, torch.Tensor) and t.is_cuda
                          for t in tree_leaves(out))
            ops.append((str(func), not on_card or func.is_view
                        or str(func).startswith("aten.empty")))
            return out

    with _Log():
        fn()
    return ops


def sass_by_function(path: str, prefix: str, names) -> dict:
    """{name: the count of SASS opcodes starting with prefix} for each of
    the kernel functions of a built library whose mangled name holds
    name (cuobjdump)."""
    import os
    import re

    from jackal_tpu_torch.ops import cuda_lib

    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split(None, 1)[0]
        for name in names:
            if name in fn:
                ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                                 r"([A-Z][A-Z0-9_.]*)", part)
                out[name] = sum(op.startswith(prefix) for op in ops)
    return out


def scan_probes(dev) -> dict:
    """What the card's plain torch does at the scan's hazards, beside the
    CPU's: scatter_reduce("amin") into a bin that takes a NaN range (the
    plain version marks such bins NaN itself), and the bin index at every
    bin edge of the presets (scan_edge_thetas) as the plain version
    computed it before (bin_size * (fov/2 - theta_deg) / fov with fov a
    Python float, which ATen's CUDA division by a CPU scalar turns into a
    product with its reciprocal) and as it does now (_bin_index: XLA's
    folded ratio and its one rounding). Raises if the new index differs
    between the card and the CPU."""
    import torch
    from jackal_tpu_torch.config import REF_PI, ScanParams
    from jackal_tpu_torch.scan import obstacle as obs

    r = torch.tensor([1.0, float("nan"), 2.0, 3.0])
    idx = torch.tensor([0, 0, 1, 1])
    amin = {d: torch.full((2,), 1e9, device=d).scatter_reduce(
        0, idx.to(d), r.to(d), "amin").cpu().tolist() for d in ("cpu", dev)}
    sp = ScanParams()
    th = torch.from_numpy(scan_edge_thetas(sp))

    def before(t):
        td = t * (180.0 / REF_PI)
        return torch.floor(sp.bin_size * (sp.fov_deg / 2.0 - td)
                           / sp.fov_deg).cpu()

    old_cpu, old_card = before(th), before(th.to(dev))
    new_cpu = obs._bin_index(th, sp)
    new_card = obs._bin_index(th.to(dev), sp).cpu()
    out = {"scatter_amin_nan": {str(k): v for k, v in amin.items()},
           "edge_angles": th.numel(),
           "before_card_vs_cpu": int((old_card != old_cpu).sum()),
           "before_cpu_vs_now": int((old_cpu.to(torch.int32)
                                     != new_cpu).sum()),
           "now_card_vs_cpu": int((new_card != new_cpu).sum())}
    print(f"14e. probes: scatter_reduce amin of [1, nan] into bin 0 and "
          f"[2, 3] into bin 1 (from 1e9): {out['scatter_amin_nan']}; bin "
          f"index at {th.numel()} angles a few ulps about every edge: the "
          f"division made before, card vs CPU, {out['before_card_vs_cpu']} "
          f"differ, CPU before vs now {out['before_cpu_vs_now']}; now, "
          f"card vs CPU, {out['now_card_vs_cpu']}")
    if out["now_card_vs_cpu"]:
        raise AssertionError(f"scan: the bin index differs between the card "
                             f"and the CPU: {out}")
    return out


def scan_phase(dev, hold, node_maps, node_pipe):
    """Phase 14: kernels P1 (scan from a map), P2 (the cloud), P3 (scan
    from points) and the fused cloud and scan (P2 with P3 as its epilogue)
    of csrc/scan_kernel.cu. (a) Each against its plain version on the card
    on SCAN_EDGE_CASES (scan_hold: NaN masks equal, torch.equal otherwise;
    one launch a call; the fused scan also against P3 on P2's cloud), on
    phase 4's 9 node maps (one call of 9 and each map alone) and on
    BASELINE config 5's batch of 32 maps with its colour frames and
    without; (b) the FFMAs of each kernel equal those of the same source
    built with -fmad=false (the written __fmaf_rn and the library's own:
    no contraction), and no DFMA; (c) a call reads nothing back to the
    host (torch.cuda.set_sync_debug_mode), is one kernel and no fill under
    torch.profiler, and leaves the cached scratch zero; (d) the kernels'
    times (CUDA events behind a spin, 50 calls) beside their plain
    versions' and their bounds (scan_work) at the node's shape (P1, B = 1
    and 8, and on a map whose every pixel is rejected: no angle, range or
    bin atomics) and
    config 5's (P2 with and without colour, P3, the fused kernel with and
    without colour), and the stage times (host clock) of the node's scan
    and config 5's fused cloud and scan beside the plain versions' and the
    standalone P2 and P3. node_maps: phase 4's u8 maps [9, H, W] on the
    card; node_pipe: phase 4's pipeline. Returns (the phase's JSON line,
    the kernels line's entries of P1-P3 and the fused kernel)."""
    import torch
    from jackal_tpu_torch.config import BMParams, PipelineParams
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.scan import obstacle as obs

    calib = (node_pipe.Q32, node_pipe.XR32, node_pipe.XT32)
    for name in SCAN_EDGE_CASES:
        scan_hold(scan_edge_case(name, dev), calib, hold, name)
    print(f"14a. kernels P1-P3 and cloud_scan == plain (NaN masks equal, "
          f"torch.equal otherwise; one launch a call): "
          f"{', '.join(SCAN_EDGE_CASES)}")
    sp, gp = node_pipe.sp, node_pipe.gp
    node_case = {"sp": sp, "gp": gp, "maps": (
        node_maps, node_pipe.valid_disp, node_pipe.p.crop_offset_x,
        node_pipe.p.crop_offset_y, None)}
    scan_hold(node_case, calib, hold, "phase 4's 9 node maps")
    for b in range(node_maps.shape[0]):
        scan_hold(dict(node_case, maps=(node_maps[b],) + node_case["maps"][1:]),
                  calib, hold, f"phase 4's node map {b}")
    size = dict(im_width=640, im_height=480, crop_im_width=640,
                crop_im_height=480)
    cfg5 = make_pipeline(engine="bm", bm_params=BMParams(disp_num=64),
                         params=PipelineParams(calib_im_size=(640, 360),
                                               gen_pcl=True, **size),
                         device=dev)
    scene = np.arange(CONFIG5_B) % len(GOLDEN)
    gold = [np.load(f"{FIX}/{f}.npz") for f in GOLDEN]
    l5 = torch.from_numpy(np.stack([gold[s]["left"] for s in scene])).to(dev)
    r5 = torch.from_numpy(np.stack([gold[s]["right"] for s in scene])).to(dev)
    dm5 = cfg5.process_batch_fused(l5, r5)[0]
    col5 = cfg5._rectify_crop_color(torch.from_numpy(
        np.random.default_rng(13).integers(
            0, 256, (CONFIG5_B, *l5.shape[-2:], 3)).astype(np.uint8)).to(dev))
    calib5 = (cfg5.Q32, cfg5.XR32, cfg5.XT32)
    scan_hold({"sp": cfg5.sp, "gp": cfg5.gp, "maps": (
        dm5, cfg5.valid_disp, cfg5.p.crop_offset_x, cfg5.p.crop_offset_y,
        col5)}, calib5, hold, f"config 5's {CONFIG5_B} maps")
    print(f"14a. kernels P1-P3 and cloud_scan == plain on phase 4's 9 node "
          f"maps (one call and each alone) and config 5's {CONFIG5_B} maps, "
          f"colour as the node's planar view and none; cloud_scan's scan == "
          f"P3 on P2's cloud")

    # (b) no contraction: the FFMAs are those the source writes and the
    # library functions' own, as in a build with -fmad=false
    fns = ("scan_from_disparity_kernel", "point_cloud_kernel",
           "scan_from_points_kernel", "cloud_scan_kernel")
    ffma = {lib: sass_by_function(cuda_lib.library(lib).path, "FFMA", fns)
            for lib in ("scan_kernel", "scan_kernel_nofmad")}
    dfma = sass_by_function(cuda_lib.library("scan_kernel").path, "DFMA", fns)
    print(f"14b. FFMA instructions a kernel (cuobjdump): {ffma['scan_kernel']}"
          f"; built with -fmad=false: {ffma['scan_kernel_nofmad']}; DFMA "
          f"{dfma}")
    if ffma["scan_kernel"] != ffma["scan_kernel_nofmad"] \
            or len(ffma["scan_kernel"]) != 4 or any(dfma.values()):
        raise AssertionError(f"scan kernels: FFMA {ffma}, DFMA {dfma}: "
                             f"contracted")

    # (c) no host read inside a call
    pts5, valid5 = obs.point_cloud_from_disparity(
        dm5, None, *calib5, cfg5.sp)[0::2]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        node_pipe._scan_stage(node_maps[0])
        cfg5._cloud_scan(dm5, None)
        obs.obstacle_scan_from_points(pts5, valid5, cfg5.sp, cfg5.gp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("14c. the node's scan stage, config 5's fused cloud and scan and "
          "P3 under torch.cuda.set_sync_debug_mode('error'): no host read")
    one_call = {}
    for k, fn in (("scan", lambda: node_pipe._scan_stage(node_maps[0])),
                  ("scan_points", lambda: obs.obstacle_scan_from_points(
                      pts5, valid5, cfg5.sp, cfg5.gp)),
                  ("cloud_scan", lambda: cfg5._cloud_scan(dm5))):
        n0 = scan_counts()
        ops = aten_ops_of_a_call(fn)
        grew = {c: v - n0[c] for c, v in scan_counts().items() if v != n0[c]}
        if grew != {k: 1} or not all(ok for _, ok in ops):
            raise AssertionError(f"{k}: a call launched {grew} and ran the "
                                 f"ATen ops {ops}: not one kernel alone")
        one_call[k] = sorted({name for name, _ in ops})
    print(f"14c. one call each: its kernel once, and no ATen op on the card "
          f"but views and allocations (no fill, no copy): {one_call}")
    cells = scratch_zero()
    print(f"14c. the scan kernels' cached scratch ({len(obs._scratch)} "
          f"buffers, {cells} entries) is all zero after the phase's calls")

    # (d) times at the main paths' shapes
    H, W = node_maps.shape[-2:]
    m1, m8 = node_maps[0], node_maps[:8]
    vd = node_pipe.valid_disp
    ox, oy = node_pipe.p.crop_offset_x, node_pipe.p.crop_offset_y
    # d = 2 lies below every cache entry's lower bound (d >= 3 there), and
    # its w is no 0 (d = 0 would send every division down its slow path)
    rejected1 = torch.full_like(m1, 2)
    if bool((obs.obstacle_scan_from_disparity_plain(
            rejected1, vd, *calib, sp, ox, oy).scan < obs.INF).any()):
        raise AssertionError("scan: the all-rejected map filled a bin")
    H5, W5 = dm5.shape[-2:]
    # the points each run's scan accepts: they alone take the range, the
    # angle and the bin (scan_work)
    acc1, acc8, acc0 = (scan_accepted(vd, m) for m in (m1, m8, rejected1))
    acc5 = scan_accepted(gp=cfg5.gp, pts=pts5, valid=valid5)
    print(f"14d. points accepted: {acc1} of {H * W} at B = 1, {acc8} of "
          f"{8 * H * W} at B = 8, {acc0} on the all-rejected map, {acc5} of "
          f"{CONFIG5_B * H5 * W5} at config 5")
    runs = [
        ("scan", lambda: obs.obstacle_scan_from_disparity(
            m1, vd, *calib, sp, ox, oy),
         lambda: obs.obstacle_scan_from_disparity_plain(
             m1, vd, *calib, sp, ox, oy),
         scan_work("scan", 1, H, W, sp.bin_size, accepted=acc1),
         f"{W}x{H}, B = 1"),
        ("scan", lambda: obs.obstacle_scan_from_disparity(
            m8, vd, *calib, sp, ox, oy),
         lambda: obs.obstacle_scan_from_disparity_plain(
             m8, vd, *calib, sp, ox, oy),
         scan_work("scan", 8, H, W, sp.bin_size, accepted=acc8),
         f"{W}x{H}, B = 8"),
        ("cloud", lambda: obs.point_cloud_from_disparity(
            dm5, None, *calib5, cfg5.sp),
         lambda: obs.point_cloud_from_disparity_plain(
             dm5, None, *calib5, cfg5.sp),
         scan_work("cloud", CONFIG5_B, H5, W5),
         f"config 5, B = {CONFIG5_B}, no colour"),
        ("cloud", lambda: obs.point_cloud_from_disparity(
            dm5, col5, *calib5, cfg5.sp),
         lambda: obs.point_cloud_from_disparity_plain(
             dm5, col5, *calib5, cfg5.sp),
         scan_work("cloud", CONFIG5_B, H5, W5, colour=True),
         f"config 5, B = {CONFIG5_B}, colour (planar view)"),
        ("scan_points", lambda: obs.obstacle_scan_from_points(
            pts5, valid5, cfg5.sp, cfg5.gp),
         lambda: obs.obstacle_scan_from_points_plain(
             pts5, valid5, cfg5.sp, cfg5.gp),
         scan_work("scan_points", CONFIG5_B, H5, W5, cfg5.sp.bin_size,
                   accepted=acc5),
         f"config 5, B = {CONFIG5_B}"),
        ("cloud_scan", lambda: obs.cloud_and_scan_from_disparity(
            dm5, None, *calib5, cfg5.sp, cfg5.gp),
         lambda: obs.cloud_and_scan_from_disparity_plain(
             dm5, None, *calib5, cfg5.sp, cfg5.gp),
         scan_work("cloud_scan", CONFIG5_B, H5, W5, cfg5.sp.bin_size,
                   accepted=acc5),
         f"config 5, B = {CONFIG5_B}, no colour"),
        ("cloud_scan", lambda: obs.cloud_and_scan_from_disparity(
            dm5, col5, *calib5, cfg5.sp, cfg5.gp),
         lambda: obs.cloud_and_scan_from_disparity_plain(
             dm5, col5, *calib5, cfg5.sp, cfg5.gp),
         scan_work("cloud_scan", CONFIG5_B, H5, W5, cfg5.sp.bin_size,
                   colour=True, accepted=acc5),
         f"config 5, B = {CONFIG5_B}, colour (planar view)"),
        # P1 with every pixel rejected: the reprojection and the blocks'
        # reduction alone (no angle, no range, no bin added to a set's
        # keys; the extrema's 4 still)
        ("scan", lambda: obs.obstacle_scan_from_disparity(
            rejected1, vd, *calib, sp, ox, oy),
         lambda: obs.obstacle_scan_from_disparity_plain(
             rejected1, vd, *calib, sp, ox, oy),
         scan_work("scan", 1, H, W, sp.bin_size, accepted=acc0),
         f"{W}x{H}, B = 1, every pixel rejected"),
    ]
    times, entries = {}, []
    replaces = {"scan": "jackal_tpu/scan/obstacle.py:105",
                "cloud": "jackal_tpu/scan/obstacle.py:150",
                "scan_points": "jackal_tpu/scan/obstacle.py:132",
                "cloud_scan": "jackal_tpu/scan/obstacle.py:150"}
    for k, kern_fn, plain, (nbytes, ops), label in runs:
        ms = events_ms(kern_fn, 50)
        pms = events_ms(plain, 3, spin=False)
        bms, by = bound_ms(nbytes, ops, PEAK_F32_OPS_PER_S)
        times[f"{k} {label}"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                                 "bound_by": by, "bytes": nbytes, "ops": ops}
        print(f"14d. {k} at {label}: {ms:.5f} ms a call (CUDA events behind "
              f"a spin; plain {pms:.3f}; bound {bms:.6f} by {by}: {nbytes} "
              f"bytes, {ops} f32 operations, {ms / bms:.1f}x)")
        if ms < bms:
            raise AssertionError(f"{k} {label}: {ms} ms is below its bound "
                                 f"{bms} ms")
        if not any(e["name"] == k for e in entries):
            entries.append({
                "name": k, "route": "cuda",
                "source": "jackal_tpu_torch/csrc/scan_kernel.cu",
                "replaces": replaces[k],
                "launches": SCAN_LAUNCHES["node" if k == "scan"
                                          else "config 5"][k],
                "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": None})
    stages = {
        "node scan (P1)": host_ms(lambda: node_pipe._scan_stage(m1), 5),
        "node scan, plain version": host_ms(
            lambda: obs.obstacle_scan_from_disparity_plain(
                m1, vd, *calib, sp, ox, oy), 5),
        "config 5 cloud and scan (fused kernel)": host_ms(
            lambda: cfg5._cloud_scan(dm5), 5),
        "config 5 cloud and scan, plain version": host_ms(
            lambda: obs.cloud_and_scan_from_disparity_plain(
                dm5, None, *calib5, cfg5.sp, cfg5.gp), 5),
        "config 5 cloud (P2 alone)": host_ms(
            lambda: obs.point_cloud_from_disparity(
                dm5, None, *calib5, cfg5.sp), 5),
        "config 5 scan from the points (P3 alone)": host_ms(
            lambda: obs.obstacle_scan_from_points(
                pts5, valid5, cfg5.sp, cfg5.gp), 5)}
    for k, v in stages.items():
        print(f"  14d. stage {k}: {v:.3f} ms (host clock, median of 5)")
    probes = scan_probes(dev)
    return {"scan": {"times": times, "stages_ms": stages, "ffma": ffma,
                     "launches": dict(SCAN_LAUNCHES), "one_call": one_call,
                     "probes": probes}}, entries


# ---- kernels R and Q: the ELAS front (phase 15) ----------------------------

# kernel R, kernel A's calls that wrote the candidate grid as their
# epilogue (Q's function) and Q's standalone launches, by their names in
# the kernels line
FRONT_KERNELS = ("descriptor", "support_fused", "support_epilogue")


def front_counts() -> dict:
    """The launch counters of kernel R (the descriptor), of kernel A's
    calls with Q's tests as the epilogue of their last launch, and of
    kernel Q alone (on no path)."""
    from jackal_tpu_torch.matching.elas import support
    from jackal_tpu_torch.ops import descriptor

    return {"descriptor": descriptor.launches,
            "support_fused": support.fused_launches,
            "support_epilogue": support.epilogue_launches}


def reset_front() -> None:
    from jackal_tpu_torch.matching.elas import support
    from jackal_tpu_torch.ops import descriptor

    descriptor.launches = support.fused_launches = 0
    support.epilogue_launches = 0


def pin_front(label: str, n: int) -> dict:
    """Raise unless kernel R and kernel A with its epilogue each launched n
    times since their counters were set to 0 (reset_front), and Q alone
    never."""
    got = front_counts()
    print(f"{label}: launches of R, A with Q's epilogue and Q alone {got}")
    if got != {"descriptor": n, "support_fused": n, "support_epilogue": 0}:
        raise AssertionError(f"{label}: R, A with its epilogue and Q alone "
                             f"launched {got}, not {n}, {n} and 0 times")
    return got


def epilogue_work(keys, desc1, desc2, params) -> int:
    """Bytes that one call of kernel Q on these key maps and descriptors
    must move, counted from this run's data: the grid [B, ncv, ncu]
    written once (2 bytes a point), and each view's test at a column that
    passes its static gates (5 <= vs <= H-6, 5 <= x <= W-6, min(x - 5,
    disp_max) - disp_min >= 10 left, min(W - x - 5, disp_max) - disp_min
    >= 10 right). Such a test needs the column's two keys (8 bytes) for
    the ratio test and its descriptor (16) for the texture test, but only
    one of them where that one rejects: the lesser of 8 + 16 where the
    ratio test passes and 16 + 8 where the texture test passes. The left
    view is tested at every grid point, the right view at u - dL wherever
    the left view accepts, whatever the check then decides."""
    import torch
    from jackal_tpu_torch.matching.elas import support as sm

    B, H, W, _ = desc1.shape
    step = sm.effective_stepsize(params)
    ncv, ncu = -(-H // step), -(-W // step)
    dev = desc1.device
    vs = torch.arange(1, ncv, device=dev) * step
    us = torch.arange(1, ncu, device=dev) * step
    thr = torch.full((), params.support_threshold, dtype=torch.float32,
                     device=dev)
    live = ((vs >= 5) & (vs <= H - 6))[None, :, None]

    def view(k1, k2, desc, x, dmax):
        """(bytes, accepted, k1) at columns x [B, nv, nu] of the grid
        rows: the bytes each point's test needs, 0 where a static gate
        fails."""
        gate = live & (x >= 5) & (x <= W - 6) & (dmax - params.disp_min
                                                 >= 10)
        a, b = torch.gather(k1, 2, x), torch.gather(k2, 2, x)
        ratio = (a < (1 << 24)) & ((a >> 9).to(torch.float32)
                                   < thr * (b >> 9).to(torch.float32))
        tex = (desc[:, vs].to(torch.int32) - 128).abs().sum(-1)
        tex_ok = torch.gather(tex, 2, x) >= params.support_texture
        need = torch.minimum(8 + 16 * ratio.long(), 16 + 8 * tex_ok.long())
        return torch.where(gate, need, 0), gate & ratio & tex_ok, a

    u = us.expand(B, ncv - 1, ncu - 1).contiguous()
    left, acc, k1 = view(keys[0], keys[1], desc1, u,
                         torch.clamp(u - 5, max=params.disp_max))
    back = torch.clamp(u - (k1 & 511), 0, W - 1)
    right, _, _ = view(keys[2], keys[3], desc2, back,
                       torch.clamp(W - back - 5, max=params.disp_max))
    return (2 * B * ncv * ncu + int(left.sum())
            + int(torch.where(acc, right, 0).sum()))


def front_phase(dev, hold, node, batches, launches):
    """Phase 15: the ELAS front as the nodes run it, kernel R (the
    descriptor, csrc/descriptor_kernel.cu, both views through its pair
    entry) and kernel A with Q's tests as the epilogue of its last launch
    (support.support_candidates, csrc/support_kernel.cu). (a) R, A's keys
    (grid_row_keys), A's grid and Q alone on A's keys against their plain
    versions (torch.equal) on the two 640x480 golden fixtures, phase 4's 9
    node frames (each as the per-frame node calls them, and all 9 in one
    call), the batched node's 48 frames (its 6 batches of 8), every
    SUPPORT_EDGE_CASES shape, FRONT_EDGE_CASES, R alone on
    DESCRIPTOR_EDGE_SHAPES (half resolution off and on), and the subsampled
    frames (half-resolution descriptors, the even step) of
    elas_stages_sub320 and the golden pairs, one at a time (A's plan R >
    1) and the golden pairs as a batch of 8 (R = 1); (b) each library's
    FFMA count a kernel equal to its -fmad=false build's, no DFMA; (c) the
    ATen ops of one create_descriptor_pair and one support_candidates call
    on the card, beside the kernels' calls: views and allocations only;
    (d) the device times of R's pair call, A with its epilogue, A alone, A
    then Q and Q alone beside their plain versions and bounds at the
    per-frame node's shape and the batched node's, a time of R or of A
    with its epilogue below its bound failing. node: phase 4's rectified
    (left, right) [9, H, W]; batches: the batched node's rectified batches
    [(left, right) [8, H, W]]; launches: R's, A-with-epilogue's and Q's
    launches on the per-frame node (phase 4). Returns (the phase's JSON
    line, the kernels line's entries)."""
    import torch
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import support as sm
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.ops import descriptor as dm

    plans = set()

    def held(label, left, right, p):
        """R's pair entry, A's keys, A's grid and Q alone on A's keys, each
        against its plain version; returns the descriptors, the keys and
        the grid."""
        half = p.subsampling
        desc = dm.create_descriptor_pair(left, right, half)
        hold("descriptor", f"descriptor pair {label}", [desc],
             [dm.create_descriptor_plain(torch.stack([left, right]), half)])
        d1, d2 = desc[0], desc[1]
        step = sm.effective_stepsize(p)
        keys = support_keys_held(
            hold, f"support from the descriptors' rows {label}", d1, d2,
            step, p.disp_min, p.disp_num)
        want = sm.support_epilogue_plain(keys, d1, d2, p)
        f0 = sm.fused_launches
        grid = sm.support_candidates(d1, d2, p)
        hold("support_fused", f"support with its epilogue {label}", [grid],
             [want])
        hold("support_epilogue", f"support epilogue alone {label}",
             [sm.support_epilogue(keys, d1, d2, p)], [want])
        B, H, W = left.shape
        nv = -(-H // step) - 1
        if nv > 0:
            plans.add((half, sm.plan(dev.index, B, nv, W, p.disp_min,
                                     p.disp_num)[0] > 1))
        if sm.fused_launches != f0 + (nv > 0):
            raise AssertionError(f"15a. {label}: support_candidates did "
                                 f"not launch A with its epilogue once")
        return d1, d2, keys, grid

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    params, sub = ElasParams(), ElasParams(subsampling=True)
    seen = []
    gold = {f: np.load(f"{FIX}/{f}.npz") for f in GOLDEN}
    for f, g in gold.items():
        held(f, on(g["left"][None]), on(g["right"][None]), params)
    seen.append("the golden pairs")
    L9, R9 = node
    for b in range(len(L9)):
        held(f"node frame {b}", L9[b:b + 1], R9[b:b + 1], params)
    held(f"node frames, {len(L9)} in one call", L9, R9, params)
    seen.append(f"phase 4's {len(L9)} node frames (each, and in one call)")
    for i, (lb, rb) in enumerate(batches):
        held(f"batched node batch {i}", lb, rb, params)
    seen.append(f"the batched node's {len(batches)} batches of "
                f"{len(batches[0][0])}")
    for name in SUPPORT_EDGE_CASES:
        left, right, lo, hi = support_edge_images(name)
        held(name, on(left), on(right),
             ElasParams(disp_min=lo, disp_max=hi - 1))
    seen.append(f"{len(SUPPORT_EDGE_CASES)} SUPPORT_EDGE_CASES")
    for name in FRONT_EDGE_CASES:
        left, right, kw = front_edge_images(name)
        held(name, on(left), on(right), ElasParams(**kw))
    seen.append(f"{len(FRONT_EDGE_CASES)} FRONT_EDGE_CASES")
    for shape in DESCRIPTOR_EDGE_SHAPES:
        rng = np.random.default_rng(sum(shape))
        left, right = (on(rng.integers(0, 256, shape).astype(np.uint8))
                       for _ in range(2))
        for half in (False, True):
            hold("descriptor", f"descriptor pair {shape}, half {half}",
                 [dm.create_descriptor_pair(left, right, half)],
                 [dm.create_descriptor_plain(torch.stack([left, right]),
                                             half)])
    seen.append(f"R on {len(DESCRIPTOR_EDGE_SHAPES)} DESCRIPTOR_EDGE_SHAPES,"
                f" half resolution off and on")
    st = np.load(f"{FIX}/elas_stages_sub320.npz")
    for name, g in [("elas_stages_sub320", st)] + list(gold.items()):
        held(f"subsampled {name}", on(g["left"][None]), on(g["right"][None]),
             sub)
    gl = np.stack([gold[GOLDEN[i % 2]]["left"] for i in range(8)])
    gr = np.stack([gold[GOLDEN[i % 2]]["right"] for i in range(8)])
    held("subsampled golden pairs, a batch of 8", on(gl), on(gr), sub)
    seen.append("the subsampled frames of elas_stages_sub320 and the golden "
                "pairs, one at a time and as a batch of 8")
    torch.cuda.synchronize()
    if not {(True, False), (True, True), (False, False),
            (False, True)} <= plans:
        raise AssertionError(f"15a. A's plans met (half resolution, R > 1):"
                             f" {sorted(plans)}; want R = 1 and R > 1 with "
                             f"and without subsampling")
    print(f"15a. kernel R (pair entry), A's keys, A with Q's epilogue and Q "
          f"alone == plain (torch.equal): {'; '.join(seen)}; A's plans met "
          f"(half resolution, R > 1): {sorted(plans)}")

    # (b) no contraction beyond what the source writes: the FFMA count a
    # kernel equals the -fmad=false build's, and no DFMA
    ffma = {}
    for lib, names in (("descriptor_kernel", ("descriptor_kernel",)),
                       ("support_kernel", ("support_keys_kernel",
                                           "support_merge_kernel",
                                           "support_epilogue_kernel"))):
        got, ref = (sass_by_function(cuda_lib.library(n).path, "FFMA", names)
                    for n in (lib, lib + "_nofmad"))
        dfma = sass_by_function(cuda_lib.library(lib).path, "DFMA", names)
        ffma[lib] = {"built": got, "fmad_false": ref, "dfma": dfma}
        print(f"15b. {lib}: FFMA by kernel {got}; the -fmad=false build "
              f"{ref}; DFMA {dfma}; sass "
              f"{sass_opcodes(cuda_lib.library(lib).path, top=12)}")
        if got != ref or set(got) != set(names) or any(dfma.values()):
            raise AssertionError(f"15b. {lib} contracts: FFMA {got} against "
                                 f"{ref} at -fmad=false, DFMA {dfma}")

    # (c) one call each, as the nodes make them: the kernels and
    # allocations, no eager op on the card
    lt, rt = L9[:1], R9[:1]
    desc = dm.create_descriptor_pair(lt, rt)
    d1, d2 = desc[0], desc[1]
    reset_front()
    a0 = sm.launches
    ops_r = aten_ops_of_a_call(lambda: dm.create_descriptor_pair(lt, rt))
    ops_s = aten_ops_of_a_call(
        lambda: sm.support_candidates(d1, d2, params))
    calls = dict(front_counts(), support=sm.launches - a0)
    H, W = lt.shape[1:]
    step = sm.effective_stepsize(params)
    plan = sm.plan(dev.index, 1, -(-H // step) - 1, W, params.disp_min,
                   params.disp_num)
    bad = [n for n, ok in ops_r + ops_s if not ok]
    print(f"15c. ATen ops of one create_descriptor_pair call {ops_r} and one "
          f"support_candidates call {ops_s}; the kernels' calls {calls} "
          f"(A's plan (R, DC) {plan}: "
          f"{'keys, then merge with the epilogue: 2 launches' if plan[0] > 1 else 'keys with the epilogue: 1 launch'})")
    if bad or calls != {"descriptor": 1, "support_fused": 1,
                        "support_epilogue": 0, "support": 1}:
        raise AssertionError(f"15c. a front call ran eager ops on the card "
                             f"{bad} or made the kernel calls {calls}")

    # (d) times at the nodes' shapes beside the plain versions and bounds
    times, entries = {}, []
    ops_rate = int_ops_rate(dev)
    lb, rb = batches[0]
    for label, (left, right) in (("node, B = 1", (L9[:1], R9[:1])),
                                 (f"batched node, B = {len(lb)}",
                                  (lb, rb))):
        B, H, W = left.shape
        d1, d2, keys, grid = held(label, left, right, params)
        ncv = -(-H // step)
        nbA, opsA, _ = support_work(B, ncv - 1, W, params.disp_min,
                                    params.disp_num)
        nbQ = epilogue_work(keys, d1, d2, params)
        bA = bound_ms(nbA, opsA, ops_rate)
        bQ = bound_ms(nbQ, 0, 1.0)
        # A's operation bound plus Q's bytes: the tests of a grid row wait
        # for its final keys
        fused_bound = (bA[0] + bQ[0], bA[1])
        x = torch.stack([left, right])

        def plain_front():
            ncv_ = -(-H // step)
            k = torch.stack(sm.support_keys_plain(
                sm.grid_row_blocks(d1, step, ncv_),
                sm.grid_row_blocks(d2, step, ncv_), params.disp_min,
                params.disp_num))
            return sm.support_epilogue_plain(k, d1, d2, params)

        runs = (("descriptor", lambda: dm.create_descriptor_pair(left, right),
                 lambda: dm.create_descriptor_plain(x),
                 bound_ms(x.numel() * 17, 0, 1.0), x.numel() * 17, True),
                ("support_fused",
                 lambda: sm.support_candidates(d1, d2, params), plain_front,
                 fused_bound, nbA + nbQ, True),
                ("support_epilogue",
                 lambda: sm.support_epilogue(keys, d1, d2, params),
                 lambda: sm.support_epilogue_plain(keys, d1, d2, params),
                 bQ, nbQ, False))
        for k, kern, plain, (bms, by), nbytes, gate in runs:
            ms = events_ms(kern, 50)
            pms = events_ms(plain, 3 if k != "support_fused" or B == 1
                            else 1, spin=False)
            times[f"{k} {label}"] = {"ms": ms, "plain_ms": pms,
                                     "bound_ms": bms, "bound_by": by,
                                     "bytes": nbytes}
            print(f"15d. {k} at {label}, {W}x{H}, both views: {ms:.5f} ms "
                  f"a call (CUDA events behind a spin; plain {pms:.3f}; "
                  f"bound {bms:.6f} by {by}: {nbytes} bytes, "
                  f"{ms / bms:.1f}x)")
            if gate and ms < bms:
                raise AssertionError(f"{k} {label}: {ms} ms is below its "
                                     f"bound {bms} ms")
        # the parent's path in the same call: A alone, then Q
        t = times[f"support_fused {label}"]
        t["a_alone_ms"] = events_ms(lambda: sm.grid_row_keys(
            d1, d2, step, params.disp_min, params.disp_num), 50)
        t["a_then_q_ms"] = events_ms(lambda: sm.support_epilogue(
            sm.grid_row_keys(d1, d2, step, params.disp_min,
                             params.disp_num), d1, d2, params), 50)
        t["descriptor_stack_ms"] = events_ms(
            lambda: dm.create_descriptor(torch.stack([left, right])), 50)
        print(f"15d. at {label}: A alone {t['a_alone_ms']:.5f} ms, A then Q "
              f"{t['a_then_q_ms']:.5f}, A with Q's epilogue {t['ms']:.5f}; "
              f"R after torch.stack {t['descriptor_stack_ms']:.5f}, R's "
              f"pair entry {times[f'descriptor {label}']['ms']:.5f}")
    node_t = {k: times[f"{k} node, B = 1"] for k in FRONT_KERNELS}
    for k, source, replaces, extra in (
            ("descriptor", "descriptor_kernel.cu",
             "jackal_tpu/ops/descriptor.py:74", {}),
            ("support_fused", "support_kernel.cu",
             "jackal_tpu/ops/pallas/support_kernel.py:61",
             {"fuses": "jackal_tpu/matching/elas/support.py:76"}),
            ("support_epilogue", "support_kernel.cu",
             "jackal_tpu/matching/elas/support.py:76",
             {"fused_into": "support_fused"})):
        entries.append({
            "name": k, "route": "cuda",
            "source": f"jackal_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[k],
            "ms": node_t[k]["ms"], "plain_ms": node_t[k]["plain_ms"],
            "bound_ms": node_t[k]["bound_ms"],
            "bound_by": node_t[k]["bound_by"], "library_ms": None, **extra})
    return {"front": {"times": times, "ffma": ffma, "launches": launches,
                      "plans_met": sorted(plans),
                      "aten_ops": {"create_descriptor_pair": ops_r,
                                   "support_candidates": ops_s}}}, entries


# ---- kernels M1 and M2: the batched prior's table and grids (phase 16) ----

# M1 and M2's one launch by its counter in device_prior.prior_launches (in
# the kernels line, M1's entry "coeff_table" is that launch, M2's
# "grid_words" its blocks alone)
PRIOR_LAUNCH = "coeff_grid"
# float64 operations (a DMUL, DSUB or DDIV as one; an FMA would count
# twice) at the H100's float64 rate outside the tensor cores
PEAK_F64_OPS_PER_S = 33.5e12
# M1's float64 operations a solve that passes its three pivots, as
# csrc/prior_kernel.cu writes them: at step k, 3 - k quotients for row k
# and, for each of the two other rows, 3 - k products and differences
SOLVE_OPS = sum(5 * (3 - k) for k in range(3))

# collinear, repeated and tied corners (tests/test_device_fit.py's cases)
PRIOR_DEG_SUPPORT = np.array([
    [100, 100, 10], [200, 100, 10], [300, 100, 10], [100, 200, 20],
    [100, 300, 30], [200, 200, 15], [200, 300, 15], [640, 480, 255],
    [0, 0, 0], [5, 7, 3]], np.int32)
PRIOR_DEG_TRI = np.array([
    [0, 1, 2], [0, 3, 4], [0, 1, 3], [1, 5, 6], [0, 5, 7], [8, 9, 7],
    [0, 3, 5], [3, 4, 0], [0, 0, 1]], np.int32)
# top-row triangles, d > u (negative right-image u), u <= 1
PRIOR_ADV_SUPPORT = np.array([[0, 0, 5], [1, 0, 1], [5, 9, 30],
                              [630, 3, 200], [639, 479, 2], [2, 478, 1],
                              [320, 240, 128]], np.int32)
# M1's and M2's edges (tests/test_torch_cuda.py runs them too; the CPU's
# tests/test_torch_prior_kernels.py holds the first five to the JAX
# package)
PRIOR_EDGE_CASES = ("degenerate and tied triangles", "d > u",
                    "seeded, pad rows", "D = 100, d up to 129",
                    "3 x 2 grid cells", "2 rows of grid cells",
                    "2112 grid cells a row (grid_size 1)",
                    "the batched node's chunk: CH 8, Np 1536, Tp 3072")


def prior_points(rng, n, W, H, dmax):
    """n support points at distinct (u, v) of a W x H image, d < dmax."""
    cells = rng.choice(W * H, n, replace=False)
    return np.stack([cells % W, cells // W, rng.integers(0, dmax, n)],
                    -1).astype(np.int32)


def prior_wire(support, W, H, tris=None):
    """One frame's wire tuple (pipeline._prior_tri_job's layout): the
    support, per side the sorted triangles and their paints, per side the
    tile lists; tris: (left, right) triangles, Delaunay's by default."""
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas.native_prior import (
        tri_wire_and_bin_native)
    from jackal_tpu_torch.matching.elas.prior import delaunay

    if tris is None:
        rp = np.stack([support[:, 0] - support[:, 2], support[:, 1]], -1)
        tris = (delaunay(support[:, :2].astype(np.float32)),
                delaunay(rp.astype(np.float32)))
    sp16 = support.astype(np.int16)
    a, b = (tri_wire_and_bin_native(sp16, t, W, H, dp._RASTER_SLAB,
                                    dp._RASTER_CTILE, right=r)
            for t, r in zip(tris, (False, True)))
    return (sp16, a[0], a[1], b[0], b[1], a[2], b[2])


def prior_edge_case(name):
    """(the frames' wire tuples, their supports, W, H, ElasParams) of one
    of PRIOR_EDGE_CASES."""
    from jackal_tpu_torch.config import ElasParams

    p = ElasParams()
    rng = np.random.default_rng(23 + PRIOR_EDGE_CASES.index(name))
    if name == "degenerate and tied triangles":
        return ([prior_wire(PRIOR_DEG_SUPPORT, 640, 480,
                            (PRIOR_DEG_TRI, PRIOR_DEG_TRI))],
                [PRIOR_DEG_SUPPORT], 640, 480, p)
    W, H = 640, 480
    if name == "d > u":
        sps = [PRIOR_ADV_SUPPORT]
    elif name == "seeded, pad rows":
        W, H = 200, 150
        sps = [prior_points(rng, 40, W, H, 60), prior_points(rng, 9, W, H,
                                                            60)]
    elif name == "D = 100, d up to 129":
        W, H, p = 320, 240, ElasParams(disp_max=99)
        sps = [prior_points(rng, 80, W, H, 130),
               prior_points(rng, 50, W, H, 130)]
    elif name == "3 x 2 grid cells":
        W, H = 40, 60
        sps = [prior_points(rng, 8, W, H, 20)]
    elif name == "2 rows of grid cells":
        W, H, p = 160, 40, ElasParams(disp_max=63)
        sps = [prior_points(rng, 12, W, H, 40)]
    elif name == "2112 grid cells a row (grid_size 1)":
        W, H, p = 2112, 24, ElasParams(grid_size=1)
        sps = [prior_points(rng, 300, W, H, 256)]
    elif name == "the batched node's chunk: CH 8, Np 1536, Tp 3072":
        sps = [prior_points(rng, 1530 - 7 * b, W, H, 256) for b in range(8)]
    else:
        raise KeyError(name)
    return [prior_wire(s, W, H) for s in sps], sps, W, H, p


def prior_chunk(wires, W, H):
    """(flat int32 wire on the host, CH, Np, Tp, Ts, SC) of a chunk of
    frames' wire tuples, as the batched path pads and flattens it."""
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep

    Np, Tp, Ts = ep._chunk_pads(wires)
    SC = -(-H // dp._RASTER_SLAB) * -(-W // dp._RASTER_CTILE)
    return (ep._flatten_chunk_wire(wires, Np, Tp, Ts), len(wires), Np, Tp,
            Ts, SC)


def prior_counts() -> dict:
    from jackal_tpu_torch.matching.elas import device_prior as dp

    return dict(dp.prior_launches)


def reset_prior() -> None:
    from jackal_tpu_torch.matching.elas import device_prior as dp

    for k in dp.prior_launches:
        dp.prior_launches[k] = 0


def pin_prior(label: str, n: int) -> dict:
    """Raise unless M1 and M2's one launch ran n times since its counter
    was set to 0 (reset_prior)."""
    got = prior_counts()
    print(f"{label}: launches of M1 and M2 (one launch) {got}")
    if got != {PRIOR_LAUNCH: n}:
        raise AssertionError(f"{label}: M1 and M2 launched {got}, not {n} "
                             f"times")
    return got


def prior_held(hold, label, flat, CH, Np, Tp, Ts, W, H, params):
    """M1 and M2's one launch on the card against their plain versions on
    the card (torch.equal) for one chunk wire (a CUDA tensor); returns the
    launch's (table, sels, words)."""
    from jackal_tpu_torch.matching.elas import device_prior as dp

    SC = -(-H // dp._RASTER_SLAB) * -(-W // dp._RASTER_CTILE)
    gs = params.grid_size
    grid = (gs, -(-H // gs), -(-W // gs), params.disp_num)
    table, sels, words = dp.coeff_grid(flat, CH, Np, Tp, SC, Ts, *grid)
    ptable, psels = dp.coeff_table_plain(flat, CH, Np, Tp, SC, Ts)
    hold("coeff_table", f"coeff_grid's table and tile lists {label}",
         [table, *sels], [ptable, *psels])
    hold("grid_words", f"coeff_grid's words {label}", [words],
         [dp.grid_words_plain(flat, CH, Np, *grid)])
    return table, sels, words


def prior_parts_call(flat, CH, Np, Tp, SC, Ts, gs, gh, gw, D, parts):
    """M1's blocks (parts 1), M2's (2) or both (3) of coeff_grid's one
    launch through the build variant prior_kernel_parts (to time them
    apart; no path runs it, no counter counts it): (table, sels, words),
    the outputs of a part not launched left as allocated."""
    import ctypes

    import torch
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.ops import cuda_lib

    dev = flat.device
    table = torch.empty((2 * CH * Tp, dp._TABLE_COLS), dtype=torch.int32,
                        device=dev)
    sels = tuple(torch.empty((CH, SC, Ts), dtype=torch.int32, device=dev)
                 for _ in range(2))
    words = torch.empty((2 * CH, gh, gw, -(-D // 32)), dtype=torch.int32,
                        device=dev)
    fn = cuda_lib.load("prior_kernel_parts").prior_coeff_grid_parts
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_lib.launch(fn, "prior_coeff_grid_parts", flat, flat.data_ptr(),
                    table.data_ptr(), sels[0].data_ptr(), sels[1].data_ptr(),
                    words.data_ptr(), CH, Np, Tp, CH * SC * Ts, gs, gh, gw, D,
                    parts)
    return table, sels, words


def prior_work(flat, table, CH, Np, Tp, SC, Ts, gh, gw, D):
    """(M1's (bytes, float64 operations, float32 operations), M2's bytes,
    the grid words' bytes) of one call on this chunk wire (a CUDA tensor)
    and M1's table from it. M1 reads the wire once (2 bytes an entry),
    writes 64 bytes a table row and widens the tile lists (4 bytes an entry
    out); its float64 operations are SOLVE_OPS for each of a row's two
    solves that passes its pivots (a singular solve counted at none: a
    lower bound), its float32 ones a division for each edge slope whose du
    is not 0. M2 reads the support triples once and writes the grid words.
    Their one launch reads the wire once: M1's bytes and the words'."""
    import torch
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas.device_fit import _gj_solve3

    K = CH * Tp
    nsel = 2 * CH * SC * Ts
    x = flat.view(torch.int16)
    sp = x[:CH * Np * 3].reshape(CH * Np, 3).to(torch.float64)
    at, tris = CH * Np * 3, []
    offs = torch.arange(CH, device=flat.device)[:, None, None] * Np
    for _ in range(2):
        tris.append((x[at:at + 3 * K].reshape(CH, Tp, 3).long() + offs)
                    .reshape(K, 3))
        at += 4 * K
    tri = torch.cat(tris)
    u, v, d = (sp[:, i][tri] for i in range(3))
    ok = 0
    for uu in (u, u - d):
        A = torch.stack([uu, v, torch.ones_like(u)], -1)
        ok += int(_gj_solve3(A, d)[1].sum())
    cu = table[:, 0:3]
    divs = int(((cu[:, 0] != cu[:, 2]).sum() + (cu[:, 0] != cu[:, 1]).sum()
                + (cu[:, 1] != cu[:, 2]).sum()))
    m1 = (2 * dp.wire_len16(CH, Np, Tp, SC, Ts) + 64 * 2 * K + 4 * nsel,
          SOLVE_OPS * ok, divs)
    words = 4 * 2 * CH * gh * gw * -(-D // 32)
    return m1, 2 * CH * Np * 3 + words, words


def prior_bound_ms(nbytes, f64_ops=0, f32_ops=0):
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM
    rate and the float64 operations at PEAK_F64_OPS_PER_S plus the
    float32 ones at PEAK_F32_OPS_PER_S (both counted as one an
    instruction; the f32 rate counts an FFMA as two, so a division as one
    is a lower bound)."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = (f64_ops / PEAK_F64_OPS_PER_S + f32_ops / PEAK_F32_OPS_PER_S) * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def prior_phase(dev, hold, chunks, launches):
    """Phase 16: kernels M1 (the coefficient table and tile lists) and M2
    (the candidate grids) in their one launch, csrc/prior_kernel.cu
    coeff_grid_kernel. (a) against their plain versions on the card
    (torch.equal) on phase 2b's chunks of the golden pair (chunks of 1 and
    2), phase 4b's batched node's chunks and PRIOR_EDGE_CASES; (b) the ATen
    ops of one _chunk_coeffs call on the card (allocations and views only)
    and its one launch; (c) the launch's FFMA and DFMA counts against the
    same source built with -fmad=false (no contraction: the FMAs left are
    those inside the divisions); (d) at the batched node's chunk its time
    against its bound and against M2's part of the work alone
    (prior_work), beside the plain versions' times, and M1's blocks (two
    lanes a table row) and M2's each launched alone through the
    build variant prior_kernel_parts (prior_parts_call, held to the plain
    versions first) against their bounds, a time below a bound failing;
    the kernels line's grid_words entry carries the launch's time
    (ms_of). chunks: [(label, flat on the card, CH,
    Np, Tp, Ts, W, H, params)], the batched node's first; launches: the
    launch's count on the batched node (phase 4b). Returns (the phase's
    JSON line, the kernels line's entries)."""
    import torch
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.ops import cuda_lib

    for c in chunks:
        prior_held(hold, *c)
    seen = [f"{len(chunks)} chunks of phases 2b and 4b"]
    for name in PRIOR_EDGE_CASES:
        wires, _, W, H, p = prior_edge_case(name)
        flat, CH, Np, Tp, Ts, _ = prior_chunk(wires, W, H)
        prior_held(hold, name, torch.from_numpy(flat).to(dev), CH, Np, Tp,
                   Ts, W, H, p)
    seen.append(f"{len(PRIOR_EDGE_CASES)} PRIOR_EDGE_CASES")
    torch.cuda.synchronize()
    print(f"16a. kernels M1 (table and tile lists) and M2 (grid words) in "
          f"one launch == plain (torch.equal): {'; '.join(seen)}")

    # (b) one call as the batched node makes it: one launch, no eager op
    label, flat, CH, Np, Tp, Ts, W, H, params = chunks[0]
    reset_prior()
    ops = aten_ops_of_a_call(lambda: ep._chunk_coeffs(flat, CH, Np, Tp, Ts,
                                                      W, H, params))
    calls = prior_counts()
    bad = [n for n, ok in ops if not ok]
    print(f"16b. ATen ops of one _chunk_coeffs call ({label}): {ops}; the "
          f"launches {calls}")
    if bad or calls != {PRIOR_LAUNCH: 1}:
        raise AssertionError(f"16b. _chunk_coeffs ran eager ops on the card "
                             f"{bad} or launched {calls}")

    # (c) no contraction beyond the divisions' own FMAs
    names = ("coeff_grid_kernel",)
    fmas = {}
    for op in ("FFMA", "DFMA"):
        got, ref = (sass_by_function(cuda_lib.library(lib).path, op, names)
                    for lib in ("prior_kernel", "prior_kernel_nofmad"))
        fmas[op] = {"built": got, "fmad_false": ref}
        print(f"16c. {op} by kernel: {got}; the -fmad=false build {ref}")
        if got != ref or set(got) != set(names):
            raise AssertionError(f"16c. prior_kernel contracts into {op}: "
                                 f"{got} against {ref} at -fmad=false")

    # (d) times at the batched node's chunk: the one launch, beside the
    # plain versions of its two halves
    gs = params.grid_size
    gh, gw = -(-H // gs), -(-W // gs)
    SC = -(-H // dp._RASTER_SLAB) * -(-W // dp._RASTER_CTILE)
    grid = (gs, gh, gw, params.disp_num)
    args = (flat, CH, Np, Tp, SC, Ts, *grid)
    (b1, f64, f32), b2, bw = prior_work(flat, dp.coeff_grid(*args)[0], CH,
                                        Np, Tp, SC, Ts, gh, gw,
                                        params.disp_num)
    ms = events_ms(lambda: dp.coeff_grid(*args), 50)
    # each part's blocks alone (the build variant), held first
    ptable, psels = dp.coeff_table_plain(flat, CH, Np, Tp, SC, Ts)
    t1, s1, _ = prior_parts_call(*args, 1)
    hold("coeff_table", f"M1's blocks alone {label}", [t1, *s1],
         [ptable, *psels])
    hold("grid_words", f"M2's blocks alone {label}",
         [prior_parts_call(*args, 2)[2]],
         [dp.grid_words_plain(flat, CH, Np, *grid)])
    parts = {k: events_ms(lambda: prior_parts_call(*args, n), 50)
             for k, n in (("m1_blocks_ms", 1), ("m2_blocks_ms", 2))}
    m1_bound = prior_bound_ms(b1, f64, f32)
    print(f"16d. at {label}: M1's blocks alone {parts['m1_blocks_ms']:.5f} "
          f"ms (bound {m1_bound[0]:.6f} by {m1_bound[1]}: {b1} bytes; "
          f"{parts['m1_blocks_ms'] / m1_bound[0]:.1f}x), M2's blocks alone "
          f"{parts['m2_blocks_ms']:.5f} (bound {prior_bound_ms(b2)[0]:.6f});"
          f" the launch {ms:.5f}")
    if parts["m1_blocks_ms"] < m1_bound[0] \
            or parts["m2_blocks_ms"] < prior_bound_ms(b2)[0]:
        raise AssertionError(f"16d. a part below its bound: {parts}")
    runs = (("coeff_table", lambda: dp.coeff_grid_plain(*args),
             prior_bound_ms(b1 + bw, f64, f32),
             f"{b1 + bw} bytes, {f64} float64 and {f32} float32 "
             f"operations"),
            ("grid_words", lambda: dp.grid_words_plain(flat, CH, Np, *grid),
             prior_bound_ms(b2), f"{b2} bytes"))
    times = {}
    for k, plain, (bms, by), work in runs:
        pms = events_ms(plain, 3, spin=False)
        times[k] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                    "bound_by": by, "work": work}
        if k == "coeff_table":
            times[k].update(m1_blocks_ms=parts["m1_blocks_ms"],
                            m1_bound_ms=m1_bound[0])
        else:
            times[k]["m2_blocks_ms"] = parts["m2_blocks_ms"]
        print(f"16d. {k} at {label} (Np {Np}, Tp {Tp}, Ts {Ts}): the one "
              f"launch {ms:.5f} ms a call (CUDA events behind a spin; plain"
              f" {pms:.3f}; bound {bms:.6f} by {by}: {work}; "
              f"{ms / bms:.1f}x)")
        if ms < bms:
            raise AssertionError(f"{k}: {ms} ms is below its bound {bms} ms")
    where = "jackal_tpu/matching/elas/device_prior.py"
    entries = []
    for k, replaces, extra in (
            ("coeff_table", f"{where}:522, jackal_tpu/matching/elas/"
                            f"device_fit.py:126", {"fuses": f"{where}:579"}),
            ("grid_words", f"{where}:579",
             {"fused_into": "coeff_table",
              "ms_of": "coeff_table's one launch"})):
        t = times[k]
        entries.append({
            "name": k, "route": "cuda",
            "source": "jackal_tpu_torch/csrc/prior_kernel.cu",
            "replaces": replaces,
            "launches": launches[PRIOR_LAUNCH] if k == "coeff_table" else 0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, **extra,
            **{m: t[m] for m in ("m1_blocks_ms", "m2_blocks_ms") if m in t}})
    stage = {"kernels": host_ms(lambda: ep._chunk_coeffs(
        flat, CH, Np, Tp, Ts, W, H, params), 21),
             "plain": host_ms(lambda: dp.coeff_grid_plain(*args), 5)}
    print(f"16d. the stage coefficients + grids (both sides) at {label}, "
          f"host clock: kernels M1 and M2 (one launch) "
          f"{stage['kernels']:.4f} ms (median of 21), plain versions "
          f"{stage['plain']:.3f} ms (median of 5)")
    return {"prior": {"times": times, "stage_ms": stage, "fma": fmas,
                      "launches": launches, "aten_ops": ops}}, entries


# ---- the ELAS paths without eager ops, and the ELAS options (phase 18) ------

# ATen ops that may launch work on the card on an ELAS path: the path's own
# host <-> card copies (the input frames, the per-frame prior's upload, the
# batched path's index tables) and, on the batched path, the index_selects
# of the content order (descriptors in, maps back out)
ELAS_COPY_OPS = ("aten._to_copy.default", "aten.copy_.default")
ELAS_ORDER_OPS = ("aten.index_select.default",)
# the card ops of one call, pinned: the frame uploads and the prior's 8
# (per frame), the content order's index tables and index_selects (the
# batched route; its wire uploads run on the pool's threads, which the
# dispatch mode does not see). The counts before kernel C decoded its maps
# and the tail's last kernel wrote the u8 map are in PERF.md section 3.
ELAS_EAGER_PINS = {
    "process_frame ROBOTICS": {"aten._to_copy.default": 10},
    "u8 route MIDDLEBURY": {"aten._to_copy.default": 8},
    "elas_match MIDDLEBURY": {"aten._to_copy.default": 8},
    "batched chunk of 8 with the u8 map": {},
    "batched u8 route, 8 frames": {"aten._to_copy.default": 2,
                                   "aten.index_select.default": 3}}


def elas_eager_phase(dev, hold, pipe, pairs, L9, R9):
    """Phase 18: (a) the ATen ops that one call of each ELAS path
    dispatches on the card (aten_ops_of_a_call): the ELAS node's
    process_frame (ROBOTICS), the per-frame u8 route and elas_match at
    MIDDLEBURY, one batched chunk of 8 (_chunk_tail with the node's u8
    sink) and the node's batched route over 8 frames; every op that
    launches work must be one of the path's copies (ELAS_COPY_OPS) or an
    index_select of the content order, and the counts are pinned
    (ELAS_EAGER_PINS); the calls' kernels counted (C once for both sides,
    elas_u8 never); (b) elas_match with use_native=False and with
    return_debug=True, and post.postprocess, on the card against the CPU
    on one 640x480 node frame (ROBOTICS; postprocess also MIDDLEBURY);
    (c) the node's u8 maps on the card against the CPU's: the per-frame
    route on one node frame at both presets, the batched route on two;
    the batched route of 8 frames against dmap_u8 of
    elas_match_batch_device's D1. pipe: phase 4's node; pairs: its raw
    pairs; L9, R9: their rectified frames. Returns the phase's JSON
    line."""
    import torch
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.matching.elas import post
    from jackal_tpu_torch.ops.convert import dmap_u8
    from jackal_tpu_torch.ops.transfer import HostCopy

    params, mb = ElasParams(), ElasParams.middlebury()
    lr, rr = pairs[-1]
    l1, r1 = L9[-1], R9[-1]
    B8 = 8
    L8, R8 = L9[:B8].contiguous(), R9[:B8].contiguous()
    H, W = l1.shape
    d1, d2, dcan_dev = ep._front(L8, R8, params)
    dcan = HostCopy(dcan_dev).numpy()
    wires = [ep._prior_tri_job(dcan[b], params, W, H) for b in range(B8)]
    Np, Tp, Ts = ep._chunk_pads(wires)
    lad = ep._lr_ladder(wires, params)
    flat = torch.from_numpy(ep._flatten_chunk_wire(wires, Np, Tp,
                                                   Ts)).to(dev)
    U8 = torch.empty((B8, H, W), dtype=torch.uint8, device=dev)
    node_params = ep._node_params(params, True)
    calls = {
        "process_frame ROBOTICS": lambda: pipe.process_frame(lr, rr),
        "u8 route MIDDLEBURY": lambda: ep._elas_match_u8(l1, r1, mb,
                                                         device=dev),
        "elas_match MIDDLEBURY": lambda: ep.elas_match(l1, r1, mb,
                                                       device=dev),
        "batched chunk of 8 with the u8 map": lambda: ep._chunk_tail(
            flat, d1, d2, B8, Np, Tp, Ts, W, H, node_params, lad, None, U8),
        "batched u8 route, 8 frames": lambda: ep._elas_match_batch_u8(
            L8, R8, params, chunk=B8, device=dev)}
    counts, kernels, bad = {}, {}, {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        dp.launches = 0
        for k in post.launches:
            post.launches[k] = 0
        ops = aten_ops_of_a_call(fn)
        torch.cuda.synchronize()
        card = [n for n, ok in ops if not ok]
        counts[name] = {n: card.count(n) for n in sorted(set(card))}
        kernels[name] = {"raster": dp.launches,
                         "elas_u8": post.launches["elas_u8"]}
        bad[name] = [n for n in card
                     if n not in ELAS_COPY_OPS + ELAS_ORDER_OPS
                     or (n in ELAS_ORDER_OPS and "batched" not in name)]
        print(f"18a. ATen ops of one call, {name}: {len(ops)}, of which "
              f"launch work on the card: {counts[name]}; kernels C and "
              f"elas_u8 launched {kernels[name]}")
    if any(bad.values()):
        raise AssertionError(f"18a. eager ops on an ELAS path: {bad}")
    if counts != ELAS_EAGER_PINS:
        raise AssertionError(f"18a. the ELAS paths' card ops {counts}, "
                             f"pinned {ELAS_EAGER_PINS}")
    if counts["batched chunk of 8 with the u8 map"] \
            or kernels["batched chunk of 8 with the u8 map"] \
            != {"raster": 1, "elas_u8": 0} \
            or any(k["elas_u8"] for k in kernels.values()):
        raise AssertionError(f"18a. the chunk's tail ran {counts} on the "
                             f"card, kernels {kernels}")

    # (b) the options on the card against the CPU, one node frame
    seen = []
    for use_native, debug in ((False, False), (None, True), (False, True)):
        got = ep.elas_match(l1, r1, params, return_debug=debug,
                            use_native=use_native, device=dev)
        want = ep.elas_match(l1.cpu(), r1.cpu(), params, return_debug=debug,
                             use_native=use_native, device="cpu")
        label = f"elas_match(use_native={use_native}, return_debug={debug})"
        for g, w in zip(got[:2], want[:2]):
            _same(label, g, w)
        if debug:
            _same(f"{label} dense_D1", got[2].dense_D1, want[2].dense_D1)
            _same(f"{label} dense_D2", got[2].dense_D2, want[2].dense_D2)
            if not np.array_equal(got[2].support, want[2].support):
                raise AssertionError(f"{label}: support differs")
        seen.append(label)
    dbg = ep.elas_match(l1, r1, params, return_debug=True, device=dev)[2]
    for p, name in ((params, "ROBOTICS"), (mb, "MIDDLEBURY")):
        got = post.postprocess(dbg.dense_D1, dbg.dense_D2, p)
        want = post.postprocess(dbg.dense_D1.cpu(), dbg.dense_D2.cpu(), p)
        for g, w in zip(got, want):
            _same(f"postprocess {name}", g, w)
        seen.append(f"post.postprocess {name}")
    print(f"18b. on the card == on the CPU, one 640x480 node frame: "
          f"{'; '.join(seen)}")

    # (c) the node's u8 maps, card against CPU
    for p, name in ((params, "ROBOTICS"), (mb, "MIDDLEBURY")):
        _same(f"per-frame u8 route {name}",
              ep._elas_match_u8(l1, r1, p, device=dev),
              ep._elas_match_u8(l1.cpu(), r1.cpu(), p, device="cpu"))
    _same("batched u8 route, 2 frames",
          ep._elas_match_batch_u8(L9[:2], R9[:2], params, device=dev),
          ep._elas_match_batch_u8(L9[:2].cpu(), R9[:2].cpu(), params,
                                  device="cpu"))
    _same("batched u8 route, 8 frames, vs dmap_u8 of D1",
          ep._elas_match_batch_u8(L8, R8, params, chunk=4, device=dev),
          dmap_u8(ep.elas_match_batch_device(L8, R8, params, chunk=4,
                                             device=dev)[0]))
    print("18c. the node's u8 maps on the card == the CPU's: per frame "
          "(ROBOTICS, MIDDLEBURY), batched on 2 frames; the batched route "
          "on 8 frames (chunk 4) == dmap_u8 of elas_match_batch_device's D1")
    return {"elas_eager": {"card_ops": counts, "kernels": kernels,
                           "options": seen}}


# ---- kernels O1, O2 and S: the SGM and BM tails (phase 17) -----------------

# kernels O1, O2 and S by their names in the kernels line and in their
# modules' launches (ops/sgm_kernel.launches, matching/bm.launches)
TAIL_KERNELS = ("sgm_cost", "sgm_epilogue", "bm_gate")
# O1's, O2's and S's edges (tests/test_torch_cuda.py runs them too; the
# CPU's tests/test_torch_sgm_bm_tail.py holds the plain versions to the JAX
# package on them)
TAIL_EDGE_CASES = (
    "cost D = 2, 5 x 64",
    "cost D = 3, W = 61, no multiple of 8",
    "cost D = 64, B = 2, 7 x 200, bit 23 set",
    "cost D = 257, 3 x 300",
    "cost D > W: D = 40, 6 x 24",
    "epilogue halves at even and odd best_d",
    "epilogue best_d at 0 and D - 1, den <= 0",
    "epilogue D = 3: second, cm, cp at 30000",
    "epilogue dL = -1, lookups past the row's ends, D > W",
    "epilogue true_right maps",
    "epilogue uniqueness 0.95 at the ratio's edge",
    "epilogue uniqueness 0.6 at the ratio's edge",
    "gate window 1, B = 3, odd W",
    "gate window 9, threshold 0",
    "gate window 255 on 300 x 640",
    "gate window 257",
    "gate window 2901, wider and taller than the frame",
    "gate flat frame",
)


def tail_codes(rng, B, H, W, bit23=False):
    """Seeded 24-bit census codes, int32 [B, H, W]; with bit23 that bit is
    set in about half of them."""
    c = rng.integers(0, 1 << 24, (B, H, W)).astype(np.int32)
    if bit23:
        c |= (rng.random((B, H, W)) < 0.5).astype(np.int32) << 23
    return c


def tail_maps(rng, B, H, W, D, d0, halves=0.0, edges=0.0, big=0.0,
              unique=0.7):
    """Seeded int16 WTA maps [B, H, 10, W] as kernel F lays them out, both
    views about disparity d0 (best_d = d0 -+ 1): best 0..59, second above
    it where ``unique`` (else at or below it), cm and cp near best (den <= 0
    possible); ``halves`` of the pixels with cp == best and cm above it
    (offs exactly 0.5), ``edges`` with best_d at 0 or D - 1, ``big`` with
    second, cm or cp at 30000 (_WTA_BIG)."""
    shape = (B, H, 2, W)
    best = rng.integers(0, 60, shape)
    bd = np.clip(d0 + rng.integers(-1, 2, shape), 0, D - 1)
    e = rng.random(shape) < edges
    bd = np.where(e, np.where(rng.random(shape) < 0.5, 0, D - 1), bd)
    second = np.where(rng.random(shape) < unique,
                      best + rng.integers(1, 40, shape),
                      best - rng.integers(0, 3, shape))
    cm = best + rng.integers(-3, 9, shape)
    cp = best + rng.integers(-3, 9, shape)
    h = rng.random(shape) < halves
    cp = np.where(h, best, cp)
    cm = np.where(h, best + rng.integers(1, 9, shape), cm)
    for a in (second, cm, cp):
        a[rng.random(shape) < big] = 30000
    m = np.stack([best, bd, second, cm, cp], 3)        # [B, H, 2, 5, W]
    return m.reshape(B, H, 10, W).astype(np.int16)


def tail_ratio_maps(D):
    """Maps whose left view sweeps best 0..100 down the rows and second
    0..110 along the columns (best_d 1, cm and cp at 30000): every pair
    about a uniqueness factor's edge, the right view unique at best_d 1."""
    H, W = 101, 111
    m = np.zeros((1, H, 10, W), np.int16)
    m[0, :, 0] = np.arange(H)[:, None]
    m[0, :, 2] = np.arange(W)[None, :]
    m[0, :, 1] = m[0, :, 6] = 1
    m[0, :, 3] = m[0, :, 4] = m[0, :, 8] = m[0, :, 9] = 30000
    m[0, :, 5], m[0, :, 7] = 3, 300
    return m


def tail_edge_case(name):
    """The numpy inputs of a TAIL_EDGE_CASES case: ("cost", codes_l,
    codes_r, D), ("epilogue", maps, maps_right or None, D, SGMParams
    fields) or ("gate", left, dL, BMParams fields)."""
    rng = np.random.default_rng(TAIL_EDGE_CASES.index(name) + 1700)
    if name.startswith("cost"):
        B, H, W, D = {"cost D = 2, 5 x 64": (1, 5, 64, 2),
                      "cost D = 3, W = 61, no multiple of 8": (2, 4, 61, 3),
                      "cost D = 64, B = 2, 7 x 200, bit 23 set":
                          (2, 7, 200, 64),
                      "cost D = 257, 3 x 300": (1, 3, 300, 257),
                      "cost D > W: D = 40, 6 x 24": (1, 6, 24, 40)}[name]
        bit23 = "bit 23" in name
        return ("cost", tail_codes(rng, B, H, W, bit23),
                tail_codes(rng, B, H, W, bit23), D)
    if name.startswith("epilogue"):
        kw = {"uniqueness": 0.95, "lr_threshold": 1}
        right = None
        if name == "epilogue halves at even and odd best_d":
            D, m = 64, tail_maps(rng, 2, 9, 96, 64, 20, halves=0.5)
            kw["lr_threshold"] = 1000
        elif name == "epilogue best_d at 0 and D - 1, den <= 0":
            D, m = 32, tail_maps(rng, 1, 12, 80, 32, 10, edges=0.4)
        elif name == "epilogue D = 3: second, cm, cp at 30000":
            D, m = 3, tail_maps(rng, 1, 10, 64, 3, 1, big=0.3)
        elif name == "epilogue dL = -1, lookups past the row's ends, D > W":
            D, m = 64, tail_maps(rng, 1, 8, 40, 64, 30, edges=0.2,
                                 unique=0.4)
            kw["lr_threshold"] = 3
        elif name == "epilogue true_right maps":
            D, m = 48, tail_maps(rng, 2, 6, 72, 48, 12, halves=0.2)
            right = tail_maps(rng, 2, 6, 72, 48, 12, halves=0.2)
        else:
            D, m = 8, tail_ratio_maps(8)
            kw["uniqueness"] = 0.95 if "0.95" in name else 0.6
            kw["lr_threshold"] = 1000
        return "epilogue", m, right, D, dict(kw, disp_num=D)
    B, H, W, window, thr = {
        "gate window 1, B = 3, odd W": (3, 11, 53, 1, 10),
        "gate window 9, threshold 0": (1, 30, 80, 9, 0),
        "gate window 255 on 300 x 640": (1, 300, 640, 255, 8300),
        "gate window 257": (1, 40, 300, 257, 1427),
        "gate window 2901, wider and taller than the frame":
            (2, 12, 50, 2901, 4),
        "gate flat frame": (1, 20, 70, 9, 10)}[name]
    # thresholds about the median texture: the gate keeps some, drops some
    if name == "gate flat frame":
        left = np.full((B, H, W), 77, np.uint8)
    else:
        # texture in patches: smooth rows, noisy rows, and steps
        left = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
        left[:, ::3] = (np.arange(W) // 7 * 9 % 256).astype(np.uint8)
        left[:, 1::5] = 128
        if W < window:
            # every box is the whole frame: a smooth second frame fails
            left[1] = left[1] // 16 + 100
    dL = rng.integers(-1, 70, (B, H, W)).astype(np.float32)
    frac = rng.choice(np.float32([0.0, 0.5, 0.25, -0.5]), (B, H, W))
    dL = np.where(dL >= 0, dL + frac, np.float32(-1)).astype(np.float32)
    dL.reshape(-1)[::17] = 255.5
    dL.reshape(-1)[::29] = 300.25
    return "gate", left, dL, {"disp_num": 64, "window": window,
                              "texture_threshold": thr}


# kernel G with S's gate folded in (ops/bm_kernel.bm_match_gated): its
# edges (tests/test_torch_cuda.py runs them too; the CPU's
# tests/test_torch_bm_gate_fold.py holds the plain twin to the JAX package's
# bm_match and u8 map on them). Pairs named "(G then S)" lie past G's strip
# and take G's path without shared memory, then S.
GATE_FOLD_CASES = (
    "window 1, D = 16, W = 65: a strip's tail",
    "window 3, D = 16, W = 97",
    "window 9, D = 64, a ramp: texture at the threshold",
    "window 15, D = 64, W = 100: flat areas",
    "constant frame, D = 16: texture 0 at threshold 0",
    "window 9, D = 256 (the strip)",
    "window 9, D = 257 (G then S)",
    "window 225, D = 64 (the strip)",
    "window 227, D = 64 (G then S)",
)


def gate_fold_case(name):
    """(left, right, BMParams fields) of a GATE_FOLD_CASES case: seeded
    uint8 [B, H, W] pairs, the right view the left shifted by a few
    columns."""
    rng = np.random.default_rng(GATE_FOLD_CASES.index(name) + 1900)
    B, H, W, D, window, tex = {
        GATE_FOLD_CASES[0]: (2, 17, 65, 16, 1, 10),
        GATE_FOLD_CASES[1]: (1, 23, 97, 16, 3, 210),
        GATE_FOLD_CASES[2]: (1, 30, 150, 64, 9, 36),
        GATE_FOLD_CASES[3]: (2, 40, 100, 64, 15, 10),
        GATE_FOLD_CASES[4]: (1, 12, 40, 16, 9, 0),
        GATE_FOLD_CASES[5]: (1, 20, 300, 256, 9, 700),
        GATE_FOLD_CASES[6]: (1, 20, 300, 257, 9, 700),
        GATE_FOLD_CASES[7]: (1, 30, 260, 64, 225, 2000),
        GATE_FOLD_CASES[8]: (1, 30, 260, 64, 227, 2000)}[name]
    # thresholds about the noisy frames' median texture: the gate keeps
    # some matched pixels and drops others
    shift = 5
    wide = W + 16 + shift
    if "ramp" in name:
        # g = 4 inside each run of the ramp: the texture of an inner pixel
        # is 4 * 81 = 324 = texture_threshold * window exactly; smaller by
        # the frame's edges, larger by the ramp's wrap
        frame = np.tile((2 * np.arange(wide) % 256).astype(np.uint8),
                        (B, H, 1))
    elif "constant" in name:
        frame = np.full((B, H, wide), 93, np.uint8)
    else:
        frame = rng.integers(0, 256, (B, H, wide)).astype(np.uint8)
        if "flat" in name:
            # flat rectangles whose boxes see no gradient, others in part
            frame[:, 5:25, 10:60] = 140
            frame[:, 28:, 70:] = 31
    # left(x) = right(x - shift): disparity shift
    return (np.ascontiguousarray(frame[:, :, 16:16 + W]),
            np.ascontiguousarray(frame[:, :, 16 + shift:16 + shift + W]),
            {"disp_num": D, "window": window, "texture_threshold": tex})


def tail_work(kernel: str, B: int, H: int, W: int, D: int = 0, r: int = 0):
    """(bytes, operations) kernel O1, O2 or S must do on [B, H, W] frames,
    each input read once and each output written once. O1 (sgm_cost, the
    left view as the default path launches it): both views' int32 codes in,
    the int16 volume out, 8 + 2 D bytes a pixel; an xor, a popc and a
    select a cell, 32-bit integer operations (popc counted at the integer
    rate, though the card issues it at a quarter of it: a lower bound). O2
    (sgm_epilogue, with the u8 map): the ten int16 maps in, dL, dR and the
    u8 map out, 29 bytes a pixel; float32 operations as written, 14 a
    pixel (a product, a product, a quotient and a sum for each of the
    three disparities a pixel computes, its own two and the lookup's; the
    two differences of the L/R check). S (bm_gate, the u8 map): the u8
    frame and dL in, the u8 map out, 6 bytes a pixel; 32-bit integer
    operations, at the least the horizontal box's 2r + 1 adds (clipped to
    the frame) and the vertical slide's 4 (two gradients in, two sums) a
    pixel."""
    px = B * H * W
    if kernel == "sgm_cost":
        return px * (8 + 2 * D), 3 * px * D
    if kernel == "sgm_epilogue":
        return 29 * px, 14 * px
    return 6 * px, px * (min(2 * r + 1, W) + 4)


def gated_work(B: int, H: int, W: int, D: int):
    """(bytes, 32-bit integer instructions) kernel G with S's texture gate
    and u8 map folded in must do on [B, H, W] pairs: G's (bm_work) plus
    the u8 map's byte a pixel out, and the texture's box, 4 operations a
    pixel counted as instructions (the gradient's absolute difference fused
    with the vertical add, the vertical subtract, the horizontal add and
    subtract), once a pixel and not a d."""
    nb, ops = bm_work(B, H, W, D)
    px = B * H * W
    return nb + px, ops + 4 * px


# F with O2 folded in (ops/sgm_kernel.sgm_wta_epilogue): its shapes
# (tests/test_torch_cuda.py runs them too; the CPU's
# tests/test_torch_sgm_fold.py holds the plain twin to the JAX package's
# sgm_match on them). (kind, B, H, W, D): "frames", a seeded pair whose
# volume kernels D, O1 and E make (their plain versions on the CPU), or
# "volume", a seeded volume of values 0..7 with ties (a disparity planted a
# row, its neighbour at best_d + 1 equal to it in half the columns: offsets
# of exactly 0.5). The "(F then O2)" shapes lie past the fold
# (sgm_tail_route).
FOLD_CASES = {
    "W = 300, D = 64: lookups across the tiles' edges":
        ("frames", 1, 6, 300, 64),
    "W = 301, D = 48: W % 8 != 0": ("frames", 2, 5, 301, 48),
    "W = 40 < D = 64": ("frames", 1, 7, 40, 64),
    "D = 2": ("frames", 2, 6, 50, 2),
    "ties and half-way offsets: values 0..7, D = 24":
        ("volume", 2, 5, 140, 24),
    "D = 96 (F then O2: the fold slower)": ("frames", 1, 4, 300, 96),
    "D = 200 (F then O2: the fold slower)": ("frames", 1, 4, 300, 200),
    "D = 256 (F then O2: the fold slower)": ("frames", 1, 4, 300, 256),
    "D = 320 (F then O2: F's second path)": ("frames", 1, 3, 300, 320),
}


def fold_inputs(name):
    """(kind, a, b, D) of a FOLD_CASES case: a seeded uint8 [B, H, W] pair
    (the right frame the left one shifted by D / 3 columns, its texture
    rows noisy and flat), or ("volume", S int16 [B, H, D, W], None, D)."""
    kind, B, H, W, D = FOLD_CASES[name]
    rng = np.random.default_rng(2700 + list(FOLD_CASES).index(name))
    if kind == "volume":
        # values 0..7, and a row's disparity planted at 0..2 in 80 % of
        # the columns, its neighbour at d + 1 equal to it in half of those
        S = rng.integers(3, 8, (B, H, D, W))
        d0 = rng.integers(1, D - 2, (B, H))
        bi, hi = np.meshgrid(np.arange(B), np.arange(H), indexing="ij")
        best = rng.integers(0, 3, (B, H, W))
        plant = rng.random((B, H, W)) < 0.8
        tie = plant & (rng.random((B, H, W)) < 0.5)
        for d, keep in ((d0, plant), (d0 + 1, tie)):
            cur = S[bi, hi, d]
            S[bi, hi, d] = np.where(keep, best, cur)
        return kind, S.astype(np.int16), None, D
    shift = max(D // 3, 1)
    frame = rng.integers(0, 256, (B, H, W + shift)).astype(np.uint8)
    frame[:, ::3] = (np.arange(W + shift) // 5 * 37 % 256).astype(np.uint8)
    return (kind, np.ascontiguousarray(frame[:, :, shift:]),
            np.ascontiguousarray(frame[:, :, :W]), D)


def fold_volume(left, right, p, true_right=False):
    """The aggregated volume S [B, H, D, W] (and, with true_right, the
    right view's) of uint8 [B, H, W] tensors on their device, as
    sgm_match_batch makes them: kernels D, O1, E (the plain versions on
    the CPU)."""
    from jackal_tpu_torch.ops import sgm_kernel as sk

    B, D = left.shape[0], p.disp_num
    codes = sk.census5x5_pair(left, right)
    costs = sk.sgm_cost_volume(codes[:B], codes[B:], D, true_right)
    if not true_right:
        return sk.aggregate_paths_bhdw(costs, p)
    return tuple(sk.aggregate_paths_bhdw(c, p) for c in costs)


def fold_held(hold, label, S, p, S_right=None):
    """sgm_wta_epilogue on the card against its plain twin on the card
    (torch.equal: dL, dR and the u8 map), with and without the u8 map; its
    launches pinned to the route sgm_tail_route names: F with O2 folded in
    once a call (O2 never), or F (twice a call for true_right) then O2.
    Returns the route."""
    from jackal_tpu_torch.ops import sgm_kernel as sk

    route = sk.sgm_tail_route(tuple(S.shape), S_right is not None)
    keys = ("sgm_wta", "sgm_epilogue")
    n0 = {k: sk.launches[k] for k in keys}
    for u8 in (False, True):
        hold("sgm_wta", f"sgm_wta_epilogue {label} u8={u8}",
             sk.sgm_wta_epilogue(S, p, u8, S_right),
             sk.sgm_wta_epilogue_plain(S, p, u8, S_right))
    got = {k: sk.launches[k] - n0[k] for k in keys}
    nF = 2 if S_right is None else 4
    want = ({"sgm_wta": 2, "sgm_epilogue": 0} if route == "fold" else
            {"sgm_wta": nF, "sgm_epilogue": 2})
    if got != want:
        raise AssertionError(f"sgm_wta_epilogue {label} ({route}): "
                             f"launches {got}, not {want}")
    return route


def fold_bound(B: int, H: int, W: int, D: int, int_rate: float):
    """(ms, "bytes" or "operations", bytes, integer and float32
    operations) of the least time F with O2 folded in can take on [B, H,
    W] frames: the volume read once, dL, dR and the u8 map written once,
    2 D + 9 bytes a pixel, over the HBM rate; or F's integer work
    (sgm_work) at the integer rate plus O2's 14 float32 operations a pixel
    (tail_work) at the float32 rate."""
    px = B * H * W
    nb, int_ops = sgm_work("sgm_wta", B, H, W, D)
    nb += (9 - 20) * px
    f32_ops = tail_work("sgm_epilogue", B, H, W)[1]
    tb = nb / PEAK_BYTES_PER_S * 1e3
    to = (int_ops / int_rate + f32_ops / PEAK_F32_OPS_PER_S) * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations", nb,
            int_ops, f32_ops)


def tail_phase(dev, hold, sgm_in, bm_in):
    """Phase 17: kernels O1 (the SGM cost volume), O2 (the SGM epilogue
    and u8 map) and S (the BM texture gate and u8 map). (a) each against
    its plain version on the card (torch.equal): O1 both views and the
    left alone, O2 with and without the u8 map (and on true_right's own
    right maps on the golden pair), D's pair entry against its batch
    entry, on phase 6's golden pair (D = 64 and 128), node frames and
    config 3's batch, S (the gated float map and the u8 map) on phase 7's
    golden pair, node frames, config 5's and bench_bm256's batches with
    kernel G's maps, and all on TAIL_EDGE_CASES; G with S's work folded in
    (bm_match_gated: the gated map, dR and the u8 map) against its plain
    twin on phase 7's golden pair, node frames, config 5's and
    bench_bm256's batches, GATE_FOLD_CASES and a 640x480 frame at D = 320,
    its launches of G (one) and S (none on G's strip, one past it) pinned
    a call; (b) the ATen ops of one sgm_match_batch call and one BM
    _match_batch call on the card (allocations and views only) with the
    kernels' launches (one each, S none); (c) O1's, O2's and G's FFMA
    counts against the -fmad=false builds (those inside IEEE division);
    (d) their times beside their plain versions' and their bounds
    (tail_work, gated_work) at the node's shape and at config 3's (O1, O2)
    or config 5's and bench_bm256's (G with the gate, beside G alone and
    G then S in the same run; S alone, also at D = 320), a time below its
    bound failing. F with O2 folded in (sgm_wta_epilogue, the SGM engine's
    tail on the card): (a) against its plain twin with its
    launches pinned (fold_held) on phase 6's golden pair (D = 64 and 128,
    true_right: F then O2), node frames, config 3's batch and FOLD_CASES;
    (b) one launch of F and none of O2 in the sgm_match_batch call; (c) its
    FFMA count against the sgm_wta_kernel_nofmad build; (d) its time at the
    node's shape and config 3's against its bound (fold_bound) beside F
    then O2 and F alone in the same run. sgm_in, bm_in: what phases
    6 and 7 return. Returns (the phase's JSON line, the kernels line's
    entries: O1, O2, S, and F and G as the node runs them, F with O2
    folded in and G with the gate)."""
    import torch
    from jackal_tpu_torch.config import BMParams, PipelineParams, SGMParams
    from jackal_tpu_torch.matching import bm, sgm
    from jackal_tpu_torch.ops import bm_kernel as bk
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.ops import sgm_kernel as sk
    from jackal_tpu_torch.pipeline.default import make_pipeline

    def sgm_held(label, left, right, p):
        B, D = left.shape[0], p.disp_num
        codes = sk.census5x5_pair(left, right)
        hold("census", f"census pair {label}", [codes],
             [sk.census5x5_batch(torch.cat([left, right]))])
        cl, cr = codes[:B], codes[B:]
        costs = sk.sgm_cost_volume(cl, cr, D, True)
        hold("sgm_cost", f"sgm_cost both views {label}", costs,
             sk.sgm_cost_volume_plain(cl, cr, D, True))
        hold("sgm_cost", f"sgm_cost {label}",
             [sk.sgm_cost_volume(cl, cr, D)], [costs[0]])
        Ss = [sk.aggregate_paths_bhdw(c, p)
              for c in costs[:2 if p.true_right else 1]]
        del costs
        maps = [sk.sgm_wta_maps(S) for S in Ss]
        mr = maps[1] if p.true_right else None
        for u8 in (False, True):
            hold("sgm_epilogue", f"sgm_epilogue {label} u8={u8}",
                 sk.sgm_epilogue(maps[0], mr, D, p, u8),
                 sk.sgm_epilogue_plain(maps[0], mr, D, p, u8))
        del maps
        routes[label] = fold_held(hold, label, Ss[0], p,
                                  Ss[1] if p.true_right else None)
        # the fold up to FOLD_MAX_D, where it was measured faster
        if routes[label] != ("F then O2" if p.true_right
                             or D > sk.FOLD_MAX_D else "fold"):
            raise AssertionError(f"17a. sgm_tail_route {label}: "
                                 f"{routes[label]}")

    def gate_held(label, left, dL, p):
        hold("bm_gate", f"bm_gate {label}",
             [bm.bm_texture_gate(left, dL, p), bm.bm_gate_u8(left, dL, p)],
             [bm.bm_texture_gate_plain(left, dL, p),
              bm.bm_gate_u8_plain(left, dL, p)])

    # (a) against the plain versions
    gl, gr = sgm_in["golden"]
    seen, routes = [], {}
    for D in (64, 128):
        for tr in (False, True):
            sgm_held(f"golden 640x480 D={D} true_right={tr}", gl, gr,
                     SGMParams(disp_num=D, true_right=tr))
    for key in ("node", "node batch", "config 3"):
        L, R = sgm_in[key]
        sgm_held(f"{key} B={L.shape[0]} {L.shape[1]}x{L.shape[2]}", L, R,
                 SGMParams())
        torch.cuda.empty_cache()
    seen.append("O1, O2, F with O2 folded in on the golden pair (D = 64, "
                "128, true_right), the node's frames and config 3's batch")
    for name, (kind, *_) in FOLD_CASES.items():
        _, a, b, D = fold_inputs(name)
        p = SGMParams(disp_num=D)
        if kind == "volume":
            S = torch.from_numpy(a).to(dev)
        else:
            S = fold_volume(torch.from_numpy(a).to(dev),
                            torch.from_numpy(b).to(dev), p)
        routes[name] = fold_held(hold, name, S, p)
        if (routes[name] == "F then O2") != ("(F then O2" in name):
            raise AssertionError(f"17a. sgm_tail_route {name}: "
                                 f"{routes[name]}")
    del S
    seen.append(f"F with O2 folded in on {len(FOLD_CASES)} FOLD_CASES, "
                f"routes {routes}")
    p64, p256 = BMParams(disp_num=64), BMParams(disp_num=256)
    for key, p in (("golden", p64), ("node", p64), ("node batch", p64),
                   ("config 5", p64), ("bm256", p256)):
        L, R = bm_in[key]
        gate_held(f"{key} B={L.shape[0]} D={p.disp_num}", L,
                  bk.bm_match_fused(L, R, p)[0], p)
    seen.append("S on the golden pair, the node's frames, config 5's and "
                "bench_bm256's batches")

    def gated_held(label, left, right, p, wide):
        """G with S's work folded in against its plain twin; one launch of
        G a call and of S none (G's strip) or one (past it, ``wide``)."""
        if (bk.strip_width(tuple(left.shape), p) == 0) != wide:
            raise AssertionError(f"bm_gated {label}: G's strip "
                                 f"{'takes' if wide else 'refuses'} it")
        n0, s0 = bk.launches["bm"], bm.launches["bm_gate"]
        got = bk.bm_match_gated(left, right, p)
        ng, ns = bk.launches["bm"] - n0, bm.launches["bm_gate"] - s0
        if ng != 1 or ns != int(wide):
            raise AssertionError(f"bm_gated {label}: G launched {ng} times "
                                 f"and S {ns}, not 1 and {int(wide)}")
        hold("bm", f"bm_gated {label}", got,
             bk.bm_match_gated_plain(left, right, p))

    for key, p in (("golden", p64), ("node", p64), ("node batch", p64),
                   ("config 5", p64), ("bm256", p256)):
        L, R = bm_in[key]
        gated_held(f"{key} B={L.shape[0]} D={p.disp_num}", L, R, p, False)
        torch.cuda.empty_cache()
    for name in GATE_FOLD_CASES:
        left, right, kw = gate_fold_case(name)
        gated_held(name, torch.from_numpy(left).to(dev),
                   torch.from_numpy(right).to(dev), BMParams(**kw),
                   "G then S" in name)
    p320 = BMParams(disp_num=320)
    gated_held("a node frame at D = 320 (G then S)", *bm_in["node"], p320,
               True)
    seen.append(f"G with the gate and u8 map on the golden pair, the node's "
                f"frames, config 5's and bench_bm256's batches, "
                f"{len(GATE_FOLD_CASES)} GATE_FOLD_CASES and a node frame at "
                f"D = 320 (G then S), its launches of G and S pinned")
    for name in TAIL_EDGE_CASES:
        kind, *args = tail_edge_case(name)
        if kind == "cost":
            cl, cr = (torch.from_numpy(a).to(dev) for a in args[:2])
            D = args[2]
            for right in (False, True):
                hold("sgm_cost", f"sgm_cost {name} right={right}",
                     list(sk.sgm_cost_volume(cl, cr, D, right)) if right
                     else [sk.sgm_cost_volume(cl, cr, D)],
                     list(sk.sgm_cost_volume_plain(cl, cr, D, right))
                     if right else [sk.sgm_cost_volume_plain(cl, cr, D)])
        elif kind == "epilogue":
            m, mr, D, kw = args
            m = torch.from_numpy(m).to(dev)
            mr = None if mr is None else torch.from_numpy(mr).to(dev)
            p = SGMParams(**kw)
            for u8 in (False, True):
                hold("sgm_epilogue", f"sgm_epilogue {name} u8={u8}",
                     sk.sgm_epilogue(m, mr, D, p, u8),
                     sk.sgm_epilogue_plain(m, mr, D, p, u8))
        else:
            left, dL, kw = args
            gate_held(name, torch.from_numpy(left).to(dev),
                      torch.from_numpy(dL).to(dev), BMParams(**kw))
    seen.append(f"{len(TAIL_EDGE_CASES)} TAIL_EDGE_CASES")
    torch.cuda.synchronize()
    print(f"17a. kernels O1 (cost volume), O2 (epilogue) and S (texture "
          f"gate) == plain (torch.equal): {'; '.join(seen)}")

    # (b) one call of each engine: its kernels, no eager op
    lt, rt = sgm_in["node"]
    calls = {}
    for k in sk.launches:
        sk.launches[k] = 0
    ops_sgm = aten_ops_of_a_call(lambda: sgm.sgm_match_batch(
        lt, rt, SGMParams(), device=dev, u8=True))
    calls["sgm_match_batch"] = dict(sk.launches)
    one_call = {k: 0 if k == "sgm_epilogue" else 1 for k in sk.launches}
    size = PipelineParams(im_width=640, im_height=480, crop_im_width=640,
                          crop_im_height=480)
    bmp = make_pipeline(engine="bm", bm_params=p64, params=size, device=dev)
    bl, br = bm_in["node"]
    bk.launches["bm"] = bm.launches["bm_gate"] = 0
    ops_bm = aten_ops_of_a_call(lambda: bmp._match_batch(bl, br))
    calls["bm _match_batch"] = {"bm": bk.launches["bm"],
                                "bm_gate": bm.launches["bm_gate"]}
    print(f"17b. ATen ops of one sgm_match_batch call on the node's frame: "
          f"{ops_sgm}; of one BM _match_batch call: {ops_bm}; launches "
          f"{calls}")
    bad = [n for n, ok in ops_sgm + ops_bm if not ok]
    if bad or calls["sgm_match_batch"] != one_call \
            or calls["bm _match_batch"] != {"bm": 1, "bm_gate": 0}:
        raise AssertionError(f"17b. the engines ran eager ops on the card "
                             f"{bad} or launched {calls}")

    # (c) no contraction in O1, O2, F with O2 and G beyond the division's
    # own FMAs
    fma = {}
    for lib, names in (("sgm_tail_kernel", ("sgm_cost_volume_kernel",
                                            "sgm_epilogue_kernel")),
                       ("sgm_wta_kernel", ("sgm_wta_epilogue_kernel",)),
                       ("bm_kernel", ("bm_strip_kernel", "lr_check_kernel",
                                      "bm_wta_wide_kernel"))):
        got, ref = (sass_by_function(cuda_lib.library(lb).path, "FFMA",
                                     names)
                    for lb in (lib, f"{lib}_nofmad"))
        fma[lib] = {"built": got, "fmad_false": ref}
        print(f"17c. FFMA by kernel of {lib}: {got}; the -fmad=false build "
              f"{ref}")
        if got != ref or set(got) != set(names):
            raise AssertionError(f"17c. {lib} contracts into FFMA: {got} "
                                 f"against {ref} at -fmad=false")

    # (d) times beside the plain versions' and the bounds
    ops_rate = int_ops_rate(dev)
    times, out, fold = {}, {}, {}

    def fold_timed(S, p, B, H, W, D, plain_reps):
        """F with O2 folded in: its time against its bound, beside F then
        O2 and F alone, each on CUDA events in this run."""
        t = {"ms": events_ms(lambda: sk.sgm_wta_epilogue(S, p, True), 20),
             "f_then_o2_ms": events_ms(lambda: sk.sgm_epilogue(
                 sk.sgm_wta_maps(S), None, D, p, True), 20),
             "f_alone_ms": events_ms(lambda: sk.sgm_wta_maps(S), 20),
             "plain_ms": events_ms(lambda: sk.sgm_wta_epilogue_plain(
                 S, p, True), plain_reps, spin=False)}
        bms, by, nb, iops, fops = fold_bound(B, H, W, D, ops_rate)
        t.update(bound_ms=bms, bound_by=by, bytes=nb, int_ops=iops,
                 f32_ops=fops)
        print(f"17d. F with O2 folded in at B={B}, {W}x{H}, D={D}: "
              f"{t['ms']:.5f} ms a call (CUDA events behind a spin; F then "
              f"O2 {t['f_then_o2_ms']:.5f}, F alone {t['f_alone_ms']:.5f}; plain"
              f" {t['plain_ms']:.3f}; bound {bms:.6f} by {by}: {nb} bytes, "
              f"{iops:.6g} integer and {fops:.6g} float32 operations; "
              f"{t['ms'] / bms:.1f}x)")
        if t["ms"] < bms:
            raise AssertionError(f"sgm_wta at {W}x{H} B={B}: {t['ms']} ms "
                                 f"is below its bound {bms} ms")
        t["out"] = (t["ms"], t["plain_ms"], bms, by)
        return t

    def timed(kname, label, fn, plain, work, rate, plain_reps):
        ms = events_ms(fn, 20)
        pms = events_ms(plain, plain_reps, spin=False)
        bms, by = bound_ms(*work, rate)
        times[f"{kname} {label}"] = {"ms": ms, "plain_ms": pms,
                                     "bound_ms": bms, "bound_by": by,
                                     "bytes": work[0], "ops": work[1]}
        print(f"17d. {kname} at {label}: {ms:.5f} ms a call (CUDA events "
              f"behind a spin; plain {pms:.3f}; bound {bms:.6f} by {by}: "
              f"{work[0]} bytes, {work[1]:.6g} operations; "
              f"{ms / bms:.1f}x)")
        if ms < bms:
            raise AssertionError(f"{kname} at {label}: {ms} ms is below its "
                                 f"bound {bms} ms")
        if label.startswith("node"):
            out[kname] = (ms, pms, bms, by)

    p = SGMParams()
    D = p.disp_num
    for key in ("node", "config 3"):
        L, R = sgm_in[key]
        B, H, W = L.shape
        label = f"{key} (B={B}, {W}x{H}, D={D})"
        codes = sk.census5x5_pair(L, R)
        cl, cr = codes[:B], codes[B:]
        reps = 3 if key == "node" else 1
        timed("sgm_cost", label, lambda: sk.sgm_cost_volume(cl, cr, D),
              lambda: sk.sgm_cost_volume_plain(cl, cr, D),
              tail_work("sgm_cost", B, H, W, D), ops_rate, reps)
        maps = sk.sgm_wta_maps(sk.aggregate_paths_bhdw(
            sk.sgm_cost_volume(cl, cr, D), p))
        timed("sgm_epilogue", label,
              lambda: sk.sgm_epilogue(maps, None, D, p, True),
              lambda: sk.sgm_epilogue_plain(maps, None, D, p, True),
              tail_work("sgm_epilogue", B, H, W), PEAK_F32_OPS_PER_S, 3)
        del maps
        S = sk.aggregate_paths_bhdw(sk.sgm_cost_volume(cl, cr, D), p)
        fold[label] = fold_timed(S, p, B, H, W, D, reps)
        if key == "node":
            out["sgm_wta"] = fold[label]["out"]
        del S
        torch.cuda.empty_cache()
    parent_path = {}
    for key, pb in (("node", p64), ("config 5", p64), ("bm256", p256)):
        L, R = bm_in[key]
        dL = bk.bm_match_fused(L, R, pb)[0]
        B, H, W = L.shape
        label = f"{key} (B={B}, {W}x{H}, D={pb.disp_num})"
        timed("bm", label, lambda: bk.bm_match_gated(L, R, pb),
              lambda: bk.bm_match_gated_plain(L, R, pb),
              gated_work(B, H, W, pb.disp_num), ops_rate,
              3 if B == 1 else 1)
        # the path before the fold, in the same run: G, then S
        t = times[f"bm {label}"]
        t["g_alone_ms"] = events_ms(lambda: bk.bm_match_fused(L, R, pb), 20)
        t["g_then_s_ms"] = events_ms(lambda: bm.bm_gate_u8(
            L, bk.bm_match_fused(L, R, pb)[0], pb), 20)
        parent_path[key] = t["g_then_s_ms"]
        print(f"17d. at {label}: G with the gate and u8 map {t['ms']:.5f} "
              f"ms, G alone {t['g_alone_ms']:.5f}, G then S "
              f"{t['g_then_s_ms']:.5f}")
        timed("bm_gate", label, lambda: bm.bm_gate_u8(L, dL, pb),
              lambda: bm.bm_gate_u8_plain(L, dL, pb),
              tail_work("bm_gate", B, H, W, r=pb.window // 2), ops_rate, 3)
        torch.cuda.empty_cache()
    # S alone where it stays on the path: past G's strip
    L, R = bm_in["node"]
    dL = bk.bm_match_fused(L, R, p320)[0]
    timed("bm_gate", "D = 320 at the node's shape (G then S)",
          lambda: bm.bm_gate_u8(L, dL, p320),
          lambda: bm.bm_gate_u8_plain(L, dL, p320),
          tail_work("bm_gate", *L.shape, r=p320.window // 2), ops_rate, 3)
    where = {"sgm_cost": ("jackal_tpu_torch/csrc/sgm_tail_kernel.cu",
                          "jackal_tpu/matching/sgm.py:98"),
             "sgm_epilogue": ("jackal_tpu_torch/csrc/sgm_tail_kernel.cu",
                              "jackal_tpu/matching/sgm.py:183"),
             "bm_gate": ("jackal_tpu_torch/csrc/bm_gate_kernel.cu",
                         "jackal_tpu/matching/bm.py:113")}
    # S on the BM node: none (phase 7b pins it); G's launches there
    launches = {"sgm_cost": sgm_in["node launches"]["sgm_cost"],
                "sgm_epilogue": sgm_in["node launches"]["sgm_epilogue"],
                "bm_gate": 0, "bm": bm_in["node launches"]}
    extra = {"bm_gate": {"fused_into": "bm"},
             "sgm_epilogue": {"fused_into": "sgm_wta"}}
    entries = [{"name": k, "route": "cuda", "source": where[k][0],
                "replaces": where[k][1], "launches": launches[k],
                "ms": out[k][0], "plain_ms": out[k][1],
                "bound_ms": out[k][2], "bound_by": out[k][3],
                "library_ms": None, **extra.get(k, {})}
               for k in TAIL_KERNELS]
    entries.append(dict(sgm_in["entry"], ms=out["sgm_wta"][0],
                        plain_ms=out["sgm_wta"][1],
                        bound_ms=out["sgm_wta"][2],
                        bound_by=out["sgm_wta"][3],
                        fuses="jackal_tpu/matching/sgm.py:183, :216"))
    entries.append(dict(bm_in["entry"], ms=out["bm"][0],
                        plain_ms=out["bm"][1], bound_ms=out["bm"][2],
                        bound_by=out["bm"][3],
                        fuses="jackal_tpu/matching/bm.py:113"))
    for t in fold.values():
        del t["out"]
    return {"tail": {"times": times, "fma": fma, "launches": launches,
                     "calls": calls, "g_then_s_ms": parent_path,
                     "fold": fold, "routes": routes,
                     "aten_ops": {"sgm_match_batch": ops_sgm,
                                  "bm _match_batch": ops_bm}}}, entries


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
    from jackal_tpu_torch.geometry import remap
    from jackal_tpu_torch.io_bus.camera import open_source
    from jackal_tpu_torch.matching.elas import dense as dense_mod
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import support as support_mod
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
    from jackal_tpu_torch.scan import obstacle

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
        remap.launches["remap"] = 0
        reset_scan()
        reset_front()
        reset_prior()
        torch.cuda.synchronize()
        with contextlib.redirect_stdout(out):
            rc = module.main(argv)
        torch.cuda.synchronize()
        counts = {"support": support_mod.launches,
                  "elas_dense": dense_mod.launches, "raster": dp.launches,
                  "remap": remap.launches["remap"],
                  **scan_counts(), **front_counts(), **prior_counts()}
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

    l1, r1 = (torch.from_numpy(x).to(dev) for x in pairs[0])
    result = {"rectify_ms": {
        "kernel": host_ms(lambda: pipe._rectify_crop(l1, r1), 5),
        "plain": host_ms(lambda: (remap.remap_bilinear_plain(l1, *pipe.lmap),
                                  remap.remap_bilinear_plain(r1, *pipe.rmap)),
                         5)}}
    print(f"9. the shell's rectify of one pair alone, host clock (median of "
          f"5): kernel N {result['rectify_ms']['kernel']:.3f} ms, plain "
          f"version {result['rectify_ms']['plain']:.3f} ms")
    for name, (src, frames) in sources.items():
        base = os.path.join(tmp, name)
        out, counts = run(pc_cli, [
            "--size", "640x480", "--engine", "elas", "--source", src,
            "--frames", "9", "-l", "-d", base + ".d", "-s", base + ".s",
            "--out", base + ".npz"])
        held(base + ".npz", frames, pipe, f"9a per frame, {name}")
        if counts["support"] != 9 or counts["remap"] != 9 \
                or [counts[k] for k in SCAN_KERNELS] != [9, 0, 0, 0] \
                or [counts[k] for k in FRONT_KERNELS] != [9, 9, 0] \
                or counts[PRIOR_LAUNCH] != 0:
            raise AssertionError(f"9a {name}: A called {counts['support']} "
                                 f"times, N {counts['remap']}, P1-P3 "
                                 f"{[counts[k] for k in SCAN_KERNELS]}, R, "
                                 f"A with Q's epilogue and Q alone "
                                 f"{[counts[k] for k in FRONT_KERNELS]}"
                                 f", M1 and M2 "
                                 f"{counts[PRIOR_LAUNCH]}"
                                 f" over 9 frames")
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
                "raster": batches, "remap": batches, "scan": batches,
                "cloud": 0, "scan_points": 0, "cloud_scan": 0,
                "descriptor": batches, "support_fused": batches,
                "support_epilogue": 0, "coeff_grid": batches}
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
    if counts["remap"] != 9 \
            or [counts[k] for k in SCAN_KERNELS] != [9, 0, 0, 0] \
            or [counts[k] for k in FRONT_KERNELS] != [9, 9, 0]:
        raise AssertionError(f"9c: N launched {counts['remap']} times, P1-P3"
                             f" {[counts[k] for k in SCAN_KERNELS]}, R, A "
                             f"with Q's epilogue and Q alone"
                             f" {[counts[k] for k in FRONT_KERNELS]} over 9 "
                             f"frames")
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
    from jackal_tpu_torch.ops.descriptor import (create_descriptor,
                                                 create_descriptor_pair)
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
        + ("bm_kernel_diag", "sad_rate", "scan_kernel_nofmad",
           "prior_kernel_nofmad", "sgm_tail_kernel_nofmad",
           "descriptor_kernel_nofmad", "support_kernel_nofmad",
           "bm_kernel_nofmad", "sgm_wta_kernel_nofmad",
           "prior_kernel_parts", "exact_scan_kernel_nofmad")])
    print(f"build: {time.perf_counter() - t:.1f} s (nvcc per kernel and "
          f"g++ in parallel)")
    for name in cuda_lib.KERNEL_SOURCES + ("bm_kernel_diag",):
        for line in buildmod.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ------------------------
    max_err = {"support": 0.0, "elas_dense": 0.0, "raster": 0.0,
               "census": 0.0, "sgm_paths": 0.0, "sgm_wta": 0.0, "bm": 0.0,
               "elas_lr": 0.0, "elas_gap": 0.0, "elas_mean": 0.0,
               "elas_median": 0.0, "elas_dense_lr": 0.0, "elas_speckle": 0.0,
               "remap": 0.0, "scan": 0.0, "cloud": 0.0, "scan_points": 0.0,
               "cloud_scan": 0.0, "descriptor": 0.0, "support_epilogue": 0.0,
               "support_fused": 0.0, "elas_u8": 0.0,
               "coeff_table": 0.0, "grid_words": 0.0, "sgm_cost": 0.0,
               "sgm_epilogue": 0.0, "bm_gate": 0.0, "exact_scan": 0.0,
               "bm_tp_partials": 0.0, "bm_tp_combine": 0.0}

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
        support_keys_held(hold, f"support {name}", d1, d2, step, 0, D)
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
        for smax in (-1, 0, 7):
            hold("elas_dense_lr", f"dense pair + L/R (smax {smax}) {name}",
                 dense_mod.dense_match_pair_lr(d1, d2, *views, params, smax),
                 dense_mod.dense_match_pair_lr_plain(d1, d2, *views, params,
                                                     smax))
        print(f"kernels == plain (torch.equal, both views; dense also both "
              f"views in one launch, and with the L/R epilogue at sweep "
              f"bounds disp_max, 0 and 7): {name}")
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
        d1e, d2e, lo, hi = support_edge_case(name, dev)
        support_keys_held(hold, f"support {name}", d1e, d2e, step, lo, hi)
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
    reset_prior()
    n_chunks = 0
    golden_chunks = []
    for chunk in (1, 2):
        for flat, Np, Tp, Ts, fr in batch_chunks(params, gold_l, gold_r,
                                                 chunk, dev):
            CH = len(fr)
            golden_chunks.append((f"golden pair, chunk {chunk}, #{n_chunks}",
                                  flat.to(dev), CH, Np, Tp, Ts, W, H,
                                  params))
            coeffs = ep._chunk_coeffs(flat.to(dev), CH, Np, Tp, Ts, W, H,
                                      params)
            coeffs_cpu = ep._chunk_coeffs(flat, CH, Np, Tp, Ts, W, H, params)
            # both sides in one launch, against the plain decode of each
            tables, sels, _ = zip(*coeffs)
            maps = dp.raster_maps(tables, sels, Tp, W, H)
            hold("raster", f"raster chunk {chunk}, both sides", maps,
                 dp.raster_maps_plain(tables, sels, Tp, W, H))
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
                dpl, valid, cov = (x[side * CH:(side + 1) * CH].cpu().numpy()
                                   for x in maps)
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
    print(f"raster kernel (both sides, one launch) == plain "
          f"(decode_win(raster_plain) a side, torch.equal) and device prior "
          f"== C++ host prior, planes == fit_planes_native, card "
          f"coefficients == CPU's: {n_chunks} chunks of the golden pair")
    pin_prior(f"2b. {n_chunks} card calls of _chunk_coeffs", n_chunks)
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
    tables, sels, _ = zip(*ep._chunk_coeffs(flat.to(dev), 1, Np, Tp, Ts, W,
                                            H, params))
    maps = dp.raster_maps(tables, sels, Tp, W, H)
    hold("raster", "raster wide triangles, both sides", maps,
         dp.raster_maps_plain(tables, sels, Tp, W, H))
    for side in range(2):
        c = host[side].tri_id >= 0
        dpl, _, cov = (x[side].cpu().numpy() for x in maps)
        if not (np.array_equal(cov, c)
                and np.array_equal(dpl[c], host[side].d_plane[c])):
            raise AssertionError("wide triangles: device prior != host")
    tab, sel = (x.to(dev) for x in raster_overflow_case(
        np.random.default_rng(5), 2, 300, W, H, 48))
    maps = dp.raster_maps((tab,), (sel,), 300, W, H)
    hold("raster", "raster overflowing planes", maps,
         dp.raster_maps_plain((tab,), (sel,), 300, W, H))
    dpl = maps[0].cpu().numpy()
    v, u = np.mgrid[0:H, 0:W]
    want = np.array([511, -512, 0])[((v // 16) * 5 + u // 128) % 3]
    if not np.array_equal(dpl[:, :, 1:], np.broadcast_to(want[:, 1:],
                                                         (2, H, W - 1))):
        raise AssertionError("overflowing planes: not XLA's saturation")
    for name in RASTER_EDGE_CASES:
        tab, sel, Tp_e, W_e, H_e = (x.to(dev) if torch.is_tensor(x) else x
                                    for x in raster_edge_case(name))
        for n in (1, 2):
            hold("raster", f"raster {name}, {n} side(s)",
                 dp.raster_maps((tab,) * n, (sel,) * n, Tp_e, W_e, H_e),
                 dp.raster_maps_plain((tab,) * n, (sel,) * n, Tp_e, W_e,
                                      H_e))
    print(f"raster kernel (decoded maps, one side and both in one launch) "
          f"== plain (torch.equal): {', '.join(RASTER_EDGE_CASES)}")
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
    from jackal_tpu_torch.geometry import remap as remap_mod
    from jackal_tpu_torch.matching.elas import post as post_mod
    support_mod.launches = dense_mod.launches = dense_mod.lr_launches = 0
    for k in post_mod.launches:
        post_mod.launches[k] = post_mod.device_launches[k] = 0
    for k in ep.speckle_routes:
        ep.speckle_routes[k] = 0
    remap_mod.launches["remap"] = 0
    reset_scan()
    reset_front()
    results, walls = [], []
    for i, (lr, rr) in enumerate(pairs):
        t = time.perf_counter()
        fr = pipe.process_frame(lr, rr, timing=True)
        walls.append(time.perf_counter() - t)
        results.append(fr)
    launches = {"support": support_mod.launches,
                "elas_dense": dense_mod.launches,
                "elas_dense_lr": dense_mod.lr_launches}
    node_post = dict(post_mod.launches)
    node_post_dev = dict(post_mod.device_launches)
    routes = dict(ep.speckle_routes)
    launches["remap"] = remap_mod.launches["remap"]
    pin_scan(f"4. the node over {len(pairs)} frames (P1 once a frame)",
             scan=len(pairs), key="node")
    launches.update(pin_front(f"4. the node over {len(pairs)} frames (R and"
                              f" A with Q's epilogue once a frame)",
                              len(pairs)))
    print(f"node launches over {len(pairs)} frames: {launches}, {node_post}"
          f" (their kernel launches {node_post_dev}); speckle routes "
          f"{routes}")
    if min(v for k, v in launches.items() if k != "support_epilogue") == 0:
        raise AssertionError(f"the node bypassed a kernel: {launches}")
    n9 = len(pairs)
    # the L/R check runs as kernel B's epilogue: H does not launch; the
    # speckle filter is kernel L (one cooperative launch a call), the BFS
    # hop never runs; rectify is one launch of kernel N a frame
    once = {"elas_lr": 0, "elas_gap": n9, "elas_mean": n9, "elas_median": 0,
            "elas_speckle": n9, "elas_u8": 0}
    if node_post != once or node_post_dev != dict(
            once, elas_speckle=SPECKLE_LAUNCHES * n9):
        raise AssertionError(f"the node called the postprocess kernels "
                             f"{node_post} times ({node_post_dev} kernel "
                             f"launches) over {n9} frames, not L, I and J "
                             f"once a frame (one launch each), H and K "
                             f"never")
    if routes != {"elas_speckle": n9, "bfs": 0} or launches["remap"] != n9:
        raise AssertionError(f"the node's speckle routes {routes} and "
                             f"rectify launches {launches['remap']} over "
                             f"{n9} frames: not kernel L and N once a "
                             f"frame, the BFS never")
    if launches["elas_dense_lr"] != n9:
        raise AssertionError(f"the node launched kernel B with the L/R "
                             f"epilogue {launches['elas_dense_lr']} times "
                             f"over {n9} frames, not once a frame")
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
    rl1, rr1 = (torch.from_numpy(x).to(dev) for x in pairs[-1])
    st["rectify (kernel N, both views, one launch)"] = host_ms(
        lambda: pipe._rectify_crop(rl1, rr1), 5)
    st["rectify, plain version"] = host_ms(
        lambda: (remap_mod.remap_bilinear_plain(rl1, *pipe.lmap),
                 remap_mod.remap_bilinear_plain(rr1, *pipe.rmap)), 5)
    desc = create_descriptor_pair(lt, rt)
    d1, d2 = desc[0:1], desc[1:2]
    st["descriptor"] = host_ms(lambda: create_descriptor_pair(lt, rt), 5)
    dc = support_mod.support_candidates(d1, d2, params)
    st["support (kernel A with Q's epilogue)"] = host_ms(
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
    st["dense + L/R, both views (kernel B with H's epilogue, one launch; "
       "the node's path)"] = host_ms(
        lambda: dense_mod.dense_match_pair_lr(d1, d2, v1, v2, params), 5)
    L1, L2 = (x[0] for x in dense_mod.dense_match_pair_lr(d1, d2, v1, v2,
                                                           params))
    _same("the node's fused L/R vs kernel H on B's maps", L1,
          left_right_consistency_check(Da, Db, params)[0])
    st["L/R check (kernel H alone, off the node's path)"] = host_ms(
        lambda: left_right_consistency_check(Da, Db, params), 5)
    st["L/R check, plain version"] = host_ms(
        lambda: post_mod.left_right_consistency_check_plain(Da, Db, params),
        5)
    st["speckle (kernel L, left view; the node's path)"] = host_ms(
        lambda: post_mod.remove_small_segments(L1, params), 5)
    st["speckle, plain version"] = host_ms(
        lambda: post_mod.remove_small_segments_plain(L1, params), 5)
    st["speckle hop (D1 to host, C++ BFS, back; the path L replaced)"] = \
        host_ms(lambda: ep._speckle(L1, params), 5)
    S1 = post_mod.remove_small_segments(L1, params)
    _same("kernel L vs the BFS hop on the node's frame", S1,
          ep._speckle(L1, params))
    st["tail (gap, adaptive mean: kernels I, J)"] = host_ms(
        lambda: post_tail(S1, L2, params), 5)
    st["tail, plain versions"] = host_ms(
        lambda: post_mod.adaptive_mean_plain(
            post_mod.gap_interpolation_plain(S1, params)), 5)
    for k, v in st.items():
        print(f"  stage {k}: {v:.3f} ms")
    print("stages: " + json.dumps({k: round(v, 4) for k, v in st.items()}))
    # the batched path on one frame at chunk 1 beside the per-frame path
    # (a measurement: the device prior, speckle and tail against the C++
    # prior and the speckle hop)
    one = {"elas_match": host_ms(
               lambda: elas_match(lt, rt, params, device=dev), 5),
           "elas_match_batch_device, B = 1, chunk 1": host_ms(
               lambda: elas_match_batch_device(lt[None], rt[None], params,
                                               chunk=1, device=dev), 5)}
    _same("elas_match_batch_device(chunk=1) vs elas_match", elas_match_batch_device(
        lt[None], rt[None], params, chunk=1, device=dev)[0][0],
        elas_match(lt, rt, params, device=dev)[0])
    print("one frame, host ms (median of 5): " + json.dumps(
        {k: round(v, 4) for k, v in one.items()}))

    # ---- 4b. the batched node ---------------------------------------------
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.ops.convert import dmap_u8
    from jackal_tpu_torch.matching.elas.post import (
        postprocess_after_lr, postprocess_batch, remove_small_segments_batch)
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
    support_mod.launches = dense_mod.launches = dense_mod.lr_launches = 0
    dp.launches = 0
    for k in post_mod.launches:
        post_mod.launches[k] = post_mod.device_launches[k] = 0
    reset_scan()
    reset_front()
    reset_prior()
    torch.cuda.synchronize()
    t = time.perf_counter()
    done = runner.run(iter(stream))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t
    launches_prior = pin_prior(
        f"4b. the batched node over {n_frames} frames (M1 and M2 in one "
        f"launch a chunk of {batch})", n_frames // batch)
    pin_scan(f"4b. the batched node over {n_frames} frames (P1 once a "
             f"batch)", scan=n_frames // batch, key="batched node")
    pin_front(f"4b. the batched node over {n_frames} frames (R and A with "
              f"Q's epilogue once a batch)", n_frames // batch)
    launches_b = {"support": support_mod.launches,
                  "elas_dense": dense_mod.launches,
                  "elas_dense_lr": dense_mod.lr_launches,
                  "raster": dp.launches}
    batch_post = dict(post_mod.launches)
    batch_post_dev = dict(post_mod.device_launches)
    print(f"batched node launches over {done} frames: {launches_b}, "
          f"{batch_post} (their kernel launches {batch_post_dev})")
    nb6 = n_frames // batch
    once = {"elas_lr": 0, "elas_gap": nb6, "elas_mean": nb6,
            "elas_median": 0, "elas_speckle": nb6, "elas_u8": 0}
    if batch_post != once or batch_post_dev != dict(
            once, elas_speckle=SPECKLE_LAUNCHES * nb6):
        raise AssertionError(f"the batched node called the postprocess "
                             f"kernels {batch_post} times ({batch_post_dev} "
                             f"kernel launches) over {nb6} batches, not L, I"
                             f" and J once a batch (one launch each), H and"
                             f" K never")
    if launches_b["elas_dense_lr"] != nb6:
        raise AssertionError(f"the batched node launched kernel B with the "
                             f"L/R epilogue {launches_b['elas_dense_lr']} "
                             f"times over {nb6} batches, not once a batch")
    if min(launches_b.values()) == 0:
        raise AssertionError(f"the batched node bypassed a kernel: "
                             f"{launches_b}")
    if launches_b["raster"] != nb6:
        raise AssertionError(f"the batched node launched kernel C "
                             f"{launches_b['raster']} times over {nb6} "
                             f"chunks, not once a chunk (both sides)")
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
    sb["raster (kernel C, both sides decoded, one launch)"] = host_ms(
        lambda: ep._chunk_raster(coeffs, Tp, W, H), 5)
    m1, m2 = ep._chunk_raster(coeffs, Tp, W, H)
    sb["dense, both views (kernel B, one launch)"] = host_ms(
        lambda: dense_mod.dense_match_pair(bd1, bd2, m1, m2, params), 5)
    BD1, BD2 = dense_mod.dense_match_pair(bd1, bd2, m1, m2, params)
    sb["dense + L/R, both views (kernel B with H's epilogue, one launch; "
       "the batched node's path)"] = host_ms(
        lambda: dense_mod.dense_match_pair_lr(bd1, bd2, m1, m2, params,
                                              lad), 5)
    BL1, BL2 = dense_mod.dense_match_pair_lr(bd1, bd2, m1, m2, params, lad)
    for x, y in zip((BL1, BL2),
                    left_right_consistency_check(BD1, BD2, params, lad)):
        _same("the batched node's fused L/R vs kernel H on B's maps", x, y)
    sb["postprocess after the L/R check (speckle, tail)"] = host_ms(
        lambda: postprocess_after_lr(BL1, BL2, params), 3)
    sb["postprocess with kernel H (L/R, speckle, tail)"] = host_ms(
        lambda: postprocess_batch(BD1, BD2, params, lad), 3)
    sb["  L/R check (kernel H alone, off the batched node's path)"] = host_ms(
        lambda: left_right_consistency_check(BD1, BD2, params, lad), 5)
    sb["  L/R check, plain version"] = host_ms(
        lambda: post_mod.left_right_consistency_check_plain(BD1, BD2, params,
                                                            lad), 5)
    sb["  of which the speckle filter (kernel L, left view)"] = host_ms(
        lambda: remove_small_segments_batch(BL1, params), 3)
    sb["  speckle filter, plain version"] = host_ms(
        lambda: post_mod.remove_small_segments_batch_plain(BL1, params), 3)
    BS1 = remove_small_segments_batch(BL1, params)
    sb["  tail (kernels I, J)"] = host_ms(
        lambda: post_tail(BS1, BL2, params), 5)
    U8b = torch.empty(tuple(BS1.shape), dtype=torch.uint8, device=dev)
    sb["  tail with the u8 map as J's epilogue (the node's route)"] = \
        host_ms(lambda: post_tail(BS1, BL2, params, u8=U8b), 5)
    sb["  tail, then dmap_u8 (three eager launches; the route before)"] = \
        host_ms(lambda: dmap_u8(post_tail(BS1, BL2, params)[0]), 5)
    sb["  tail, plain versions"] = host_ms(
        lambda: post_mod.adaptive_mean_plain(
            post_mod.gap_interpolation_plain(BS1, params)), 5)
    dmaps8 = dmap_u8(postprocess_after_lr(BL1, BL2, params)[0])
    _same("the batched node's u8 epilogue vs dmap_u8", U8b, dmaps8)
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
    for name, ops in (("raster_kernel", ("FFMA",)),
                      ("elas_post_kernel", ("FFMA", "DFMA")),
                      ("elas_dense_kernel", ("FFMA", "DFMA")),
                      ("speckle_kernel", ("FFMA", "DFMA")),
                      ("remap_kernel", ("FFMA", "DFMA"))):
        path = cuda_lib.library(name).path
        fma = ", ".join(x for x in (sass_opcodes(path, top=None, prefix=op)
                                    for op in ops) if x)
        print(f"  sass {name} {' and '.join(ops)} instructions: "
              f"{fma or 'none'}")
        if fma:
            raise AssertionError(f"{name} contracts into {' or '.join(ops)}")

    # kernel timing at the node's shapes, beside the plain versions
    ncv = -(-H // step)
    nb, opsA, sads = support_work(1, ncv - 1, W, params.disp_min, D)
    bA, byA = bound_ms(nb, opsA, int_ops_rate(dev))
    obA, obyA = bound_ms(nb, sads, rate)

    def sup():
        return support_mod.grid_row_keys(d1, d2, step, 0, D)

    def den():
        return dense_mod.dense_match_pair(d1, d2, v1, v2, params)

    # B at the batched node's shape: its chunk of 8 frames (phase 4b; int16
    # d_plane from the raster)
    hold("elas_dense", f"dense pair, the batched node's {batch} frames",
         dense_mod.dense_match_pair(bd1, bd2, m1, m2, params),
         dense_mod.dense_match_pair_plain(bd1, bd2, m1, m2, params))

    def den8():
        return dense_mod.dense_match_pair(bd1, bd2, m1, m2, params)

    # B past its unrolled plane radii (2 to 7): its instantiation that
    # takes the radius at run time, P from a table on the card
    for sradius in (8.0, 9.0):
        pr = dataclasses.replace(params, sradius=sradius)
        hold("elas_dense", f"dense pair at plane radius {pr.plane_radius}",
             dense_mod.dense_match_pair(d1, d2, v1, v2, pr),
             dense_mod.dense_match_pair_plain(d1, d2, v1, v2, pr))
        hold("elas_dense", f"dense pair at plane radius {pr.plane_radius}, "
             f"the batched node's {batch} frames",
             dense_mod.dense_match_pair(bd1, bd2, m1, m2, pr),
             dense_mod.dense_match_pair_plain(bd1, bd2, m1, m2, pr))
    print("5. dense kernel == plain (torch.equal, both views in one launch) "
          "at plane radius 8 and 9, the node's frame and the batched node's "
          f"{batch}")

    # A at the batched node's shape: its B = 8 descriptors (phase 4b)
    support_keys_held(hold, f"support, the batched node's {batch} frames",
                      bd1, bd2, step, 0, D)
    nb8, ops8, sads8 = support_work(batch, ncv - 1, W, params.disp_min, D)
    b8, by8 = bound_ms(nb8, ops8, int_ops_rate(dev))

    def sup8():
        return support_mod.grid_row_keys(bd1, bd2, step, 0, D)

    kA, kB, kA8 = events_ms(sup, 50), events_ms(den, 50), events_ms(sup8, 20)
    kB8 = events_ms(den8, 20)
    plans = {n: support_mod.plan(dev.index, n, ncv - 1, W, 0, D)
             for n in (1, batch)}
    lA, seenA = launch_ms(sup, 50, "support_keys_kernel")
    lM, seenM = (launch_ms(sup, 50, "support_merge_kernel")
                 if plans[1][0] > 1 else (0.0, 0))
    lB, seenB = launch_ms(den, 50, "elas_dense_kernel")
    pA = events_ms(lambda: support_mod.support_keys_plain(
        support_mod.grid_row_blocks(d1, step, ncv),
        support_mod.grid_row_blocks(d2, step, ncv), 0, D), 3, spin=False)
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

    tabsC, selsC, _ = zip(*coeffs)
    hold("raster", f"raster, both sides of a chunk of {batch} frames",
         dp.raster_maps(tabsC, selsC, Tp, W, H),
         dp.raster_maps_plain(tabsC, selsC, Tp, W, H))
    works = [raster_work(t, x, Tp, W, H) for t, x in zip(tabsC, selsC)]
    nbC = sum(w[0] for w in works)
    opsC = {k: sum(w[1][k] for w in works) for k in works[0][1]}
    oldC, liveC = sum(w[2] for w in works), sum(w[3] for w in works)
    bC, byC, typeC = raster_bound_ms(nbC, opsC, dev)
    obC, obyC = bound_ms(nbC, oldC, PEAK_F32_OPS_PER_S)
    kC = events_ms(lambda: dp.raster_maps(tabsC, selsC, Tp, W, H), 50)
    lC, seenC = launch_ms(lambda: dp.raster_maps(tabsC, selsC, Tp, W, H), 50,
                          "raster_kernel")
    pC = events_ms(lambda: dp.raster_maps_plain(tabsC, selsC, Tp, W, H), 3,
                   spin=False)
    print(f"device ms a call (CUDA events behind a spin): raster, both sides"
          f" of a chunk of {batch} frames decoded in one launch {kC:.4f} (its"
          f" kernel launch {lC:.4f}, {seenC} of 50 recorded; plain {pC:.3f};"
          f" bound {bC:.5f} by {byC}: {nbC} bytes, {liveC} live tile slots "
          f"of {sum(x.numel() for x in selsC)}, Ts {Ts}; operations f32 "
          f"{opsC['f32']}, integer {opsC['int']}, conversions "
          f"{opsC['cvt']}, ms at their rates "
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
         "fuses": "jackal_tpu/ops/pallas/raster_kernel.py:162",
         "launches": launches_b["raster"], "max_abs_err": max_err["raster"],
         "ms": kC, "plain_ms": pC, "bound_ms": bC, "bound_by": byC,
         "library_ms": None},
    ]

    # ---- 6. SGM: kernels D, E, F, the engine, the node, config 3 ---------
    entries, sgm_tail = sgm_phase(dev, hold)
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 7. BM and gen_pcl: kernel G, the BM node, configs 5 and bm256 ----
    # (G's entry in the kernels line comes from phase 17, with the times
    # of G as the node runs it: the texture gate and u8 map folded in)
    bm_tail = bm_phase(dev, hold)

    # ---- 9. the node shell: the point_cloud and navigate CLIs ------------
    print(json.dumps(shell_phase(dev)))

    # ---- 10. ELAS subsampling (A, B, H under it) and the exact scan -------
    sub_line, entries = subsampling_phase(dev, hold, pipe,
                                          [fr.dmap for fr in results])
    print(json.dumps(sub_line))
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 11. the multi-device paths and the last modules ------------------
    line, entries = multidevice_phase(dev, hold, pairs, L9, R9)
    print(json.dumps(line))
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 12. the ELAS postprocess kernels H-K ------------------------------
    line, entries = postprocess_phase(
        dev, hold, (Da, Db, S1), (BD1, BD2, lad), node_post,
        {"node": (d1, d2, v1, v2, -1, bB, byB),
         f"B = {batch}": (bd1, bd2, m1, m2, lad, b8B, by8B)},
        {"elas_lr": sub_line["subsampling"]["launches"]["elas_lr"],
         "elas_dense_lr": launches["elas_dense_lr"]})
    print(json.dumps(line))
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 13. the speckle filter (L) and rectify (N) -----------------------
    line, entries = speckle_remap_phase(
        dev, hold, (L1, L2), (BL1, BL2), pipe, (raw_l, raw_r),
        {"elas_speckle": node_post["elas_speckle"],
         "remap": launches["remap"]})
    print(json.dumps(line))
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 14. the scan and the cloud: kernels P1-P3 ------------------------
    node_maps = torch.from_numpy(np.stack([fr.dmap for fr in results])).to(dev)
    line, entries = scan_phase(dev, hold, node_maps, pipe)
    print(json.dumps(line))
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 15. the ELAS front: kernels R and Q -----------------------------
    line, entries = front_phase(
        dev, hold, (L9, R9), [pipe._rectify_crop(lb, rb) for lb, rb in raw_b],
        {k: launches[k] for k in FRONT_KERNELS})
    print(json.dumps(line))
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 16. the batched prior's table and grids: kernels M1 and M2 -------
    node_chunks = []
    for i, (lb, rb) in enumerate(raw_b):
        Lb, Rb = pipe._rectify_crop(lb, rb)
        dcb = HostCopy(ep._front(Lb, Rb, params)[2]).numpy()
        flb, CHb, Npb, Tpb, Tsb, _ = prior_chunk(
            [ep._prior_tri_job(dcb[b], params, W, H) for b in range(batch)],
            W, H)
        node_chunks.append((f"batched node batch {i}, CH {CHb}",
                            torch.from_numpy(flb).to(dev), CHb, Npb, Tpb,
                            Tsb, W, H, params))
    line, entries = prior_phase(dev, hold, node_chunks + golden_chunks,
                                launches_prior)
    print(json.dumps(line))
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 17. the SGM and BM tails: kernels O1, O2 and S --------------------
    line, entries = tail_phase(dev, hold, sgm_tail, bm_tail)
    print(json.dumps(line))
    for entry in entries:
        entry["max_abs_err"] = max_err[entry["name"]]
        kernels.append(entry)

    # ---- 18. the ELAS paths' eager ops and the ELAS options ---------------
    print(json.dumps(elas_eager_phase(dev, hold, pipe, pairs, L9, R9)))

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
