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
  3. ELAS on the card against libelas: D1/D2 of both 640x480 fixtures;
  4. the node: make_pipeline(engine="elas") at 640x480 and process_frame on
     seeded raw 640x360 pairs of a known scene (pipeline/synthetic.py),
     with the launch counters reset just before and read just after;
     per-stage medians, fps, the device's busy time under torch.profiler,
     a per-stage breakdown of one frame, and the kernels' and plain
     versions' device time per call under torch.profiler;
  5. the roofline bound of each kernel from this run's inputs; the peak
     rate of its byte SADs is measured on the card (csrc/sad_rate.cu),
     and cuobjdump shows the instructions __vsadu4 became;
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


def device_busy(fn, name: str = ""):
    """(wall ms, device-busy ms, ms of the kernels named ``name``) of fn()
    under torch.profiler: the union of the intervals in which a CUDA kernel
    or copy ran, and of those whose name contains ``name`` (None when no
    name is given). Raises if the profiler recorded no device activity, or
    none in a kernel of that name: there is no other yardstick."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def sass_opcodes(path: str, top: int = 8) -> str:
    """The most frequent SASS opcodes of a built library (cuobjdump)."""
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
    return ", ".join(f"{op} {n}" for op, n in ops.most_common(top))


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
    from jackal_tpu_torch.matching.elas import support as support_mod
    from jackal_tpu_torch.matching.elas.pipeline import elas_match
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
    max_err = {"support": 0.0, "elas_dense": 0.0}

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

    # ---- 4. the node -----------------------------------------------------
    pipe = make_pipeline(engine="elas", params=PipelineParams(
        im_width=640, im_height=480, crop_im_width=640, crop_im_height=480),
        device=dev)
    # seeded raw 640x360 pairs: walls and slanted surfaces (synthetic.py)
    pairs = [synthetic_raw_pair(pipe, seed, 8.0 + 6 * seed, 0.03 * (seed % 3))
             for seed in range(9)]
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
