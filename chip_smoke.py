#!/usr/bin/env python3
"""Drive jackal_tpu_torch's main path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no success line):
  1. card: name and power limit, torch / CUDA / nvcc versions; build the
     CUDA kernels and the C++ prior in parallel from the sources;
  2. kernels against their plain PyTorch versions on the card, bit for bit:
     support and dense at 640x480, D = 256, on the two 640x480 golden
     fixtures, and on two seeded random frames at a width that is not a
     multiple of 32;
  2b. (a) the raster kernel against its plain version (torch.equal) on
     every chunk of the two 640x480 golden fixtures batched by chunks of 1
     and 2, on wide triangles and on planes that overflow int32; (b) the
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
     with the launch counters reset just before and read just after;
     per-stage medians, fps, the device's busy time under torch.profiler,
     a per-stage breakdown of one frame, and the kernels' and plain
     versions' device time per call under torch.profiler;
  4b. (d) the batched node: StreamingRunner at batch 8 over 48 frames with
     the launch counters reset just before and read just after; fps, the
     frames published, the device's busy time and idle share under
     torch.profiler beside process_batch's, and a per-stage breakdown of
     one batch;
  5. the roofline bound of each kernel from this run's inputs; the peak
     rate of its byte SADs is measured on the card (csrc/sad_rate.cu),
     and cuobjdump shows the instructions __vsadu4 became and that the
     raster kernel has no FFMA; (e) the raster kernel's device time, its
     plain version's and its bound from this run's live tile slots;
  6. a "kernels" JSON line, the card line, and the final JSON line.
"""
from __future__ import annotations

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
# float32 and integer operations outside the tensor cores (the same sheet);
# the raster's operations are of that kind
PEAK_F32_OPS_PER_S = 67e12
DEVICE = "cuda:0"


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


def device_busy(fn, name: str = "", host_ops: bool = True):
    """(wall ms, device-busy ms, ms of the kernels named ``name``) of fn()
    under torch.profiler: the union of the intervals in which a CUDA kernel
    or copy ran, and of those whose name contains ``name`` (None when no
    name is given). host_ops=False traces the card alone, which keeps the
    profiler's own host cost out of a multi-threaded run's wall time.
    Raises if the profiler recorded no device activity, or none in a
    kernel of that name: there is no other yardstick."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    named = [e for e in dev if name and name in e.name]
    if name and not named:
        raise RuntimeError(f"torch.profiler recorded no kernel named {name}")
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    return (wall, _union_ms(spans), _union_ms(
        (e.time_range.start, e.time_range.end) for e in named)
        if name else None)


def device_ms(fn, reps: int, name: str = ""):
    """(ms, kernel ms): device time per call of fn() after two warm-up
    calls, the busy time under torch.profiler over reps calls divided by
    reps, so host gaps between launches do not count; kernel ms is the part
    spent in the kernels named ``name`` (None when no name is given)."""
    for _ in range(2):
        fn()
    _, busy, named = device_busy(lambda: [fn() for _ in range(reps)], name)
    return busy / reps, (named / reps if name else None)


def sad_rate(dev) -> float:
    """Byte SADs per second that __vsadu4 sustains on the card, from the
    microbenchmark csrc/sad_rate.cu: 8 resident blocks of 256 threads on
    every SM, device time under torch.profiler."""
    import ctypes

    import torch
    from jackal_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load("sad_rate")
    lib.sad_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_uint32, ctypes.c_void_p]
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    threads, iters = 256, 16384
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)

    def run():
        cuda_lib.check(lib.sad_rate(out.data_ptr(), blocks, threads, iters,
                                    12345, cuda_lib.stream_ptr(out)),
                       "sad_rate")
    _, ms = device_ms(run, 5, "sad_rate_kernel")
    sads = blocks * threads * iters * lib.sad_rate_chains() * 4
    return sads / (ms * 1e-3)


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
    """(bytes, byte SADs) the support function needs: inputs read once,
    the four key maps written once; the 64-byte SAD of every live
    (column, d) of both views."""
    B, nv, W, _ = Q.shape
    c = np.arange(W)
    live_l = np.clip(np.minimum(D - 1, c - 5) - disp_min + 1, 0, None)
    live_l[(c > W - 6) | (c < 5 + disp_min)] = 0
    live_r = np.clip(np.minimum(D - 1, W - 5 - c) - disp_min + 1, 0, None)
    live_r[(c < 5) | (c > W - 5 - disp_min)] = 0
    pairs = B * nv * int(live_l.sum() + live_r.sum())
    nbytes = 2 * Q.numel() + 4 * 4 * B * nv * W
    return nbytes, pairs * 64


def dense_work(desc1, desc2, d_plane, valid, covered, words, params, right):
    """(bytes, candidates per pixel) of one dense view on these inputs;
    the operations are the 16 byte SADs of every candidate this run's
    data visits at a matched pixel."""
    import torch

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
    sign = 1 if right else -1
    for d in range(D):
        warp = u + sign * d
        in_grid = ((words[:, rows, cols, d // 32] >> (d % 32)) & 1) > 0
        count += (in_grid | ((d >= lo) & (d <= hi))) \
            & (warp >= 2) & (warp < W - 2) & pixel_ok
    nbytes = (2 * desc1.numel() + 4 * d_plane.numel() + valid.numel()
              + covered.numel() + 4 * words.numel() + 4 * B * H * W)
    return nbytes, count


def raster_work(table, sel, Tp, W, H):
    """(bytes, operations, live slots) of one raster call on these inputs:
    the table, the tile lists and the key map each moved once. Per live
    tile slot, the columns of the tile inside the triangle's span [A_u,
    C_u) need 17 float and integer operations each (two scanline bounds
    with their intercepts, the span test, pa*u) and 11 per row (the plane
    value's two adds, truncation, clamp, key, the row test, the maximum),
    and each row 2 (pb*v); columns outside the span and pad slots need
    nothing."""
    from jackal_tpu_torch.matching.elas import device_prior as dp

    CH, SC, _ = sel.shape
    tab = table.cpu().numpy().reshape(CH, Tp, -1).astype(np.int64)
    sl = sel.cpu().numpy()
    rows = tab[np.arange(CH)[:, None, None], sl]          # [CH, SC, Ts, 16]
    live = (sl != Tp - 1) & (rows[..., 12] >= 0)
    s, c = np.divmod(np.arange(SC), -(-W // dp._RASTER_CTILE))
    c0 = (c * dp._RASTER_CTILE)[None, :, None]
    c1 = np.minimum(c0 + dp._RASTER_CTILE, W)
    nr = np.minimum(dp._RASTER_SLAB, H - s * dp._RASTER_SLAB)[None, :, None]
    ncols = np.clip(np.minimum(rows[..., 2], c1)
                    - np.maximum(rows[..., 0], c0), 0, None)
    ops = int((live * (ncols * (17 + 11 * nr) + 2 * nr)).sum())
    nbytes = 4 * (table.numel() + sel.numel() + CH * H * W)
    return nbytes, ops, int(live.sum())


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


def bound_ms(nbytes, ops, ops_per_s):
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


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
        cuda_lib.library(n) for n in cuda_lib.KERNEL_SOURCES + ("sad_rate",)])
    print(f"build: {time.perf_counter() - t:.1f} s (nvcc per kernel and "
          f"g++ in parallel)")
    for name in cuda_lib.KERNEL_SOURCES:
        for line in buildmod.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ------------------------
    max_err = {"support": 0.0, "elas_dense": 0.0, "raster": 0.0}

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
        print(f"kernels == plain (torch.equal, both views): {name}")
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
    wall_p, busy, _ = device_busy(
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
    st["dense, both views"] = host_ms(lambda: (
        dense_mod.dense_match(d1, d2, *v1, params, False),
        dense_mod.dense_match(d1, d2, *v2, params, True)), 5)
    Da = dense_mod.dense_match(d1, d2, *v1, params, False)[0]
    Db = dense_mod.dense_match(d1, d2, *v2, params, True)[0]
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
        wall_s, busy_s, _ = device_busy(lambda: runner.run(iter(stream)),
                                        host_ops=host_ops)
        wall_b, busy_b, _ = device_busy(batches, host_ops=host_ops)
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
    sb["dense, both views (2 x kernel B)"] = host_ms(lambda: (
        dense_mod.dense_match(bd1, bd2, *m1, params, False),
        dense_mod.dense_match(bd1, bd2, *m2, params, True)), 5)
    BD1 = dense_mod.dense_match(bd1, bd2, *m1, params, False)
    BD2 = dense_mod.dense_match(bd1, bd2, *m2, params, True)
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
    rate = sad_rate(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True).stdout)
    print(f"byte SAD rate (csrc/sad_rate.cu, measured): {rate:.6g} /s = "
          f"{rate / 4 / (sms * mhz * 1e6):.2f} __vsadu4 a clock per SM at "
          f"the {mhz:.0f} MHz max SM clock, {sms} SMs")
    for name in cuda_lib.KERNEL_SOURCES + ("sad_rate",):
        print(f"  sass {name}: "
              f"{sass_opcodes(cuda_lib.library(name).path)}")
    ffma = sass_opcodes(cuda_lib.library("raster_kernel").path, top=None,
                        prefix="FFMA")
    print(f"  sass raster_kernel FFMA instructions: {ffma or 'none'}")
    if ffma:
        raise AssertionError("the raster kernel contracts into FFMA")

    # kernel timing at the node's shapes, beside the plain versions
    ncv = -(-H // step)
    Q = support_mod.grid_row_blocks(d1, step, ncv)
    T = support_mod.grid_row_blocks(d2, step, ncv)
    nb, sads = support_work(Q, params.disp_min, D)
    bA, byA = bound_ms(nb, sads, rate)

    def sup():
        return support_mod.support_keys(Q, T, 0, D)

    def den():
        return dense_mod.dense_match(d1, d2, *v1, params, False)

    kA, kA_only = device_ms(sup, 50, "support_keys_kernel")
    pA, _ = device_ms(
        lambda: support_mod.support_keys_plain(Q, T, 0, D), 3)
    nbB, count = dense_work(d1, d2, *v1, params, False)
    bB, byB = bound_ms(nbB, int(count.sum()) * 16, rate)
    kB, kB_only = device_ms(den, 50, "elas_dense_kernel")
    pB, _ = device_ms(lambda: dense_mod.dense_match_plain(
        d1, d2, *v1, params, False), 3)
    print(f"device ms a call under torch.profiler: support {kA:.4f} "
          f"(kernel alone {kA_only:.4f}; plain {pA:.3f}; bound {bA:.5f} by "
          f"{byA}: {nb} bytes, {sads} byte SADs); dense, left view "
          f"{kB:.4f} (kernel alone {kB_only:.4f}; plain {pB:.3f}; bound "
          f"{bB:.5f} by {byB}: {nbB} bytes, {float(count.float().mean()):.2f}"
          f" candidates a pixel)")

    tabC, selC, _ = coeffs[0]
    nbC, opsC, liveC = raster_work(tabC, selC, Tp, W, H)
    bC, byC = bound_ms(nbC, opsC, PEAK_F32_OPS_PER_S)
    kC, kC_only = device_ms(lambda: dp.raster(tabC, selC, Tp, W, H), 50,
                            "raster_kernel")
    pC, _ = device_ms(lambda: dp.raster_plain(tabC, selC, Tp, W, H), 3)
    print(f"device ms a call under torch.profiler: raster, left side of a "
          f"chunk of {batch} frames {kC:.4f} (kernel alone {kC_only:.4f}; "
          f"plain {pC:.3f}; bound {bC:.5f} by {byC}: {nbC} bytes, {opsC} "
          f"operations over {liveC} live tile slots of "
          f"{selC.numel()}, Ts {Ts})")

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
