"""Time a CUDA kernel of a checkout of jackal_tpu_torch on the card: the ELAS
support kernel (A), the ELAS dense kernel (B, alone, then the L/R check H,
and with H as its epilogue), the SGM census (D), the BM kernel (G), the
ELAS postprocess kernels (H, I, J, K), the speckle filter (L), rectify
(N), the scan and the cloud (P1, P2, P3 and the fused cloud and scan),
the ELAS front (the descriptor R, then A with the support epilogue Q,
fused or after it), the
batched ELAS prior's coefficients and grids (M1, M2) or the SGM and BM
tails (the cost volume O1, the epilogue O2, the texture gate S); or the
per-frame ELAS node routed per frame and through the batched path at
B = 1; or the BM and SGM nodes' streams (--kernel stream).

    python3 tools/time_support_kernel.py --repo DIR [--kernel support]
                                         [--reps 50]

DIR is the root of the checkout whose jackal_tpu_torch is imported (its
csrc/ kernel is built there). Inputs, from this repository's
tests/fixtures and a seed:
- support, dense: the golden 640x480 pairs at the default ElasParams
  (D = 256), at the per-frame node's shape (B = 1; dense: each pair) and
  the batched node's (B = 8: the two pairs alternated). support times A
  as the checkout's main path calls it: from the descriptors' rows
  (grid_row_keys), or on grid-row blocks built before the timing in a
  checkout from before that entry. dense times both
  views: one dense_match_pair call where the checkout has it, else two
  dense_match calls (a checkout from before the pair call); then B
  followed by the L/R check (kernel H, sweep bound disp_max), H alone on
  B's maps and, where the checkout has dense_match_pair_lr, B with the
  check as its epilogue; its priors are the native prior's of each frame
  (chip_smoke.prior_inputs);
- census: the SGM node's batch (the first golden pair's two images,
  2 x 480 x 640), the node's at batch 2 (both golden pairs, 4 x 480 x
  640) and BASELINE config 3's (8 seeded 960 x 1280 images);
- bm: the golden 640x480 pairs at the BM node's shape (B = 1, D = 64),
  at D = 256 (B = 1), at BASELINE config 5's (B = 32, D = 64) and at
  bench_bm256's (B = 16, D = 256), the pairs alternated;
- post: the golden 640x480 maps: H on D1 and D2 (B = 1), I at ROBOTICS
  (B = 1), I at MIDDLEBURY on both views (B = 2), J with 8 taps and with
  4 (B = 1), K on D1 (B = 1) and on both views (B = 2);
- speckle: at ROBOTICS (t = 1), the golden D1 (B = 1), the golden maps
  alternated (B = 8), and chip_smoke's "B = 8 at 640x480" and "B = 16"
  speckle fields;
- remap: both views of a seeded 640x360 raw pair to 640x480 with the
  per-frame node's maps (B = 1, one pair call), BASELINE config 5's 32
  golden frames with its maps (one pair call) and 32 seeded colour frames
  of 3 channels on its left maps (F = 96, one view);
- front: the golden 640x480 pairs at the default ElasParams, B = 1 and 8
  (the pairs alternated), the front as the checkout's nodes run it: the
  descriptors of both views (R's pair entry where the checkout has it,
  else create_descriptor after torch.stack), then support_candidates (A
  with Q's tests as its epilogue where the checkout has them fused, else
  A then Q). On CUDA events: R as the path calls it, R alone on the
  stacked views (create_descriptor) and, where the checkout builds them
  (ops/cuda_lib.VARIANTS), R's variants at bands of 4, 16 and 32 rows
  (the path's R slides down 8) on both views, support_candidates,
  the two together, A alone as the path launches it (grid_row_keys) and,
  where the checkout has it, Q alone on the plain keys; on the host clock
  (a synchronize after each call, median of 21) the descriptor stage, the
  support stage and the two together. Each held equal to its plain
  version;
- coeffs: the chunk wire of the golden pairs at the default ElasParams
  (B = 8, the pairs alternated, and the first frame alone), built as the
  batched path builds it (pipeline._front, _prior_tri_job, _chunk_pads,
  _flatten_chunk_wire), and chip_smoke's seeded chunk at the batched
  node's size (CH 8, Np 1536, Tp 3072): on the host clock (a synchronize
  after each call, median of 21) the stage pipeline._chunk_coeffs, as the
  checkout's batched path runs it (eager torch in a checkout from before
  kernels M1 and M2); on CUDA events, where the checkout has them as two
  launches, M1 (coeff_table) and M2 (grid_words) alone and one after the
  other, and where it has their one launch (coeff_grid), that launch and,
  where it builds the variant prior_kernel_parts, M1's blocks and M2's
  each launched alone, each held equal to its plain version;
- route: the per-frame ELAS node's 9 frames (chip_smoke phase 4's seeded
  raw pairs, make_pipeline(engine="elas") at 640x480), host clock a frame
  (a synchronize after each call; 3 rounds after a warm-up round, the
  median and range of the 27): process_frame; its ELAS stage alone,
  elas_match on the rectified pair; and the batched device path on the
  same pair, elas_match_batch_device at B = 1, chunk 1 (held equal to
  elas_match);
- scan: BASELINE config 5's 32 golden u8 maps (BM, D = 64): P1 on the
  first (B = 1, the per-frame node's shape) and on the first 8; P2, P3 on
  P2's cloud and the gen-pcl tail (the pipeline's _cloud_scan: the fused
  kernel where the checkout has it, else P2 then P3) on all 32. Also, on
  the host clock, the per-frame ELAS node's scan stage (_scan_stage on
  the first map, a synchronize after each call, median of 201) and its
  host cost a call (1000 calls queued without a synchronize), and the
  gen-pcl tail's stage (median of 51). Where the checkout has the fused
  kernel, tools/scan_store_variants.cu is built against its csrc/ and P2
  and the fused kernel with their points staged in shared memory and
  written with 16-byte stores (a block's, a warp's) are held equal to the
  kernels bit for bit and timed beside them;
- stream: the BM node (D = 64) and the SGM node at 640x480 on chip_smoke
  phase 7b's and 6c's nine seeded raw pairs, on the host clock (a
  synchronize around each run): StreamingRunner over 48 frames, at batch
  8 (BM) and 4 (SGM), --reps runs after a warm-up, each run's depth maps
  held equal to process_frame's; process_frame over the nine pairs thrice
  (median) and process_batch_fused at the stream's batch (median of 21);
  on the rectified batch, the node's match step (_match_batch) on CUDA
  events and the host ms a call takes to queue it (behind a spin, median
  of 5 rounds of 20 calls);
- tail: the first golden pair at the SGM node's shape (B = 1, D = 64) and
  BASELINE config 3's seeded batch (B = 4, 1280x960), census codes from
  kernel D: on the host clock (a synchronize after each call, median of
  21) the cost-volume stage and the epilogue stage with the u8 map as the
  checkout's sgm_match_batch runs them (eager torch in a checkout from
  before kernels O1 and O2) and, on CUDA events, F alone, F then O2 and,
  where the checkout has it, F with O2 folded in (sgm_wta_epilogue), each
  held equal to its plain version, and the fold's launch against F then
  O2 at the node's shape at D = 32 to 176; the golden pairs alternated at
  the BM node's shape (B = 1), config 5's (B = 32) and bench_bm256's
  (B = 16, D = 256) with kernel G's maps: the texture gate + u8 stage as
  the checkout's
  _match_batch runs it (eager torch before kernel S); where the checkout
  has them, O1, O2 and S alone on CUDA events, each held equal to its
  plain version; G then S on CUDA events (G's maps, then the gate's u8
  map) and, where the checkout has it, G with S's work folded in
  (bm_match_gated), held equal to its plain twin.
Each call is held equal to its plain version on those inputs (post: bit
for bit, as int32). Run it on
two checkouts in one call, in the order A, B, B, A, to compare two
versions of a kernel on one card. Prints one JSON line: the card, DIR,
the kernel and the device ms a call at each shape (chip_smoke.events_ms:
CUDA events around calls queued behind a spin).
"""
import argparse
import ctypes
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import (CONFIG3, FIX, GOLDEN, card_line,  # noqa: E402
                        events_ms, host_ms, prior_inputs)


def _held(name, got, want):
    import torch

    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel != plain")


def _a_call(sm, d1, d2, step, disp_min, D):
    """Kernel A as the checkout's main path calls it: from the
    descriptors' rows where the checkout has grid_row_keys, else on the
    grid-row blocks (a checkout from before the rows entry), built once
    here and not timed."""
    if hasattr(sm, "grid_row_keys"):
        return lambda: tuple(sm.grid_row_keys(d1, d2, step, disp_min, D))
    ncv = -(-d1.shape[1] // step)
    Q = sm.grid_row_blocks(d1, step, ncv)
    T = sm.grid_row_blocks(d2, step, ncv)
    return lambda: sm.support_keys(Q, T, disp_min, D)


def time_support(d1, d2, params, reps):
    from jackal_tpu_torch.matching.elas import support as sm

    D = params.disp_num
    step = sm.effective_stepsize(params)
    ncv = -(-d1.shape[1] // step)
    res = {"rows_entry": hasattr(sm, "grid_row_keys")}
    for B in (1, 8):
        q1, q2 = d1[:B].contiguous(), d2[:B].contiguous()
        call = _a_call(sm, q1, q2, step, params.disp_min, D)
        _held(f"support B = {B}", call(), sm.support_keys_plain(
            sm.grid_row_blocks(q1, step, ncv),
            sm.grid_row_blocks(q2, step, ncv), params.disp_min, D))
        res[f"ms_B{B}"] = events_ms(call, reps)
    return res


def time_front(left, right, params, reps):
    import torch
    from jackal_tpu_torch.matching.elas import support as sm
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.ops import descriptor as dm

    dev = torch.device("cuda", 0)
    D = params.disp_num
    step = sm.effective_stepsize(params)
    pair = hasattr(dm, "create_descriptor_pair")
    res = {"pair_entry": pair, "fused_epilogue": hasattr(sm,
                                                         "fused_launches")}
    for B in (1, 8):
        lt = torch.from_numpy(left[:B]).to(dev)
        rt = torch.from_numpy(right[:B]).to(dev)
        if pair:
            def r_path():
                return dm.create_descriptor_pair(lt, rt)
        else:
            def r_path():
                return dm.create_descriptor(torch.stack([lt, rt]))
        desc = r_path()
        d1, d2 = desc[0], desc[1]
        _held(f"R B = {B}", [desc],
              [dm.create_descriptor_plain(torch.stack([lt, rt]))])
        ncv = -(-d1.shape[1] // step)
        keys = torch.stack(sm.support_keys_plain(
            sm.grid_row_blocks(d1, step, ncv),
            sm.grid_row_blocks(d2, step, ncv), params.disp_min, D))
        _held(f"A B = {B}", _a_call(sm, d1, d2, step, params.disp_min, D)(),
              tuple(keys))
        grid = sm.support_epilogue_plain(keys, d1, d2, params)
        _held(f"support_candidates B = {B}",
              [sm.support_candidates(d1, d2, params)], [grid])

        def front():
            x = r_path()
            return sm.support_candidates(x[0], x[1], params)

        res[f"r_ms_B{B}"] = events_ms(r_path, reps)
        imgs = torch.stack([lt, rt])
        res[f"r_kernel_ms_B{B}"] = events_ms(
            lambda: dm.create_descriptor(imgs), reps)
        for band in (4, 16, 32):      # R's band variants, where it has them
            lib = f"descriptor_kernel_band{band}"
            if lib not in cuda_lib.VARIANTS:
                continue
            fn = cuda_lib.load(lib).elas_descriptor_pair
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def r_band():
                out = torch.empty_like(desc)
                cuda_lib.launch(fn, lib, lt, lt.data_ptr(), rt.data_ptr(),
                                out.data_ptr(), B, 2 * B, *lt.shape[1:], 0)
                return out
            _held(f"R band {band} B = {B}", [r_band()], [desc])
            res[f"r_band{band}_ms_B{B}"] = events_ms(r_band, reps)
        res[f"support_ms_B{B}"] = events_ms(
            lambda: sm.support_candidates(d1, d2, params), reps)
        res[f"front_ms_B{B}"] = events_ms(front, reps)
        res[f"a_path_ms_B{B}"] = events_ms(
            _a_call(sm, d1, d2, step, params.disp_min, D), reps)
        if hasattr(sm, "support_epilogue"):
            _held(f"Q B = {B}", [sm.support_epilogue(keys, d1, d2, params)],
                  [grid])
            res[f"q_ms_B{B}"] = events_ms(
                lambda: sm.support_epilogue(keys, d1, d2, params), reps)
        res[f"descriptor_stage_ms_B{B}"] = host_ms(r_path, 21)
        res[f"support_stage_ms_B{B}"] = host_ms(
            lambda: sm.support_candidates(d1, d2, params), 21)
        res[f"front_stage_ms_B{B}"] = host_ms(front, 21)
    return res


def time_coeffs(left, right, params, reps):
    import torch
    from chip_smoke import prior_chunk, prior_edge_case, prior_parts_call
    from jackal_tpu_torch.matching.elas import device_prior as dp
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.ops.transfer import to_device

    dev = torch.device("cuda", 0)
    _, H, W = left.shape
    fused = hasattr(dp, "coeff_grid")
    parts = "prior_kernel_parts" in cuda_lib.VARIANTS
    kernels = fused or hasattr(dp, "coeff_table")
    res = {"kernels_m1_m2": kernels, "one_launch": fused}
    _, _, dc = ep._front(torch.from_numpy(left).to(dev),
                         torch.from_numpy(right).to(dev), params)
    dcan = dc.cpu().numpy()
    wires = [ep._prior_tri_job(dcan[b], params, W, H)
             for b in range(len(left))]
    node = prior_edge_case("the batched node's chunk: CH 8, Np 1536, "
                           "Tp 3072")
    cases = (("golden_B8", wires, W, H, params),
             ("golden_B1", wires[:1], W, H, params),
             ("seeded_node_chunk", node[0], node[2], node[3], node[4]))
    for label, ws, Wc, Hc, p in cases:
        Np, Tp, Ts = ep._chunk_pads(ws)
        flat = to_device(ep._flatten_chunk_wire(ws, Np, Tp, Ts), dev)[0]
        CH = len(ws)
        res[f"{label}_pads"] = [Np, Tp, Ts]
        res[f"{label}_stage_ms"] = host_ms(
            lambda: ep._chunk_coeffs(flat, CH, Np, Tp, Ts, Wc, Hc, p), 21)
        if not kernels:
            continue
        SC = prior_chunk(ws, Wc, Hc)[5]
        gs = p.grid_size
        grid = (gs, -(-Hc // gs), -(-Wc // gs), p.disp_num)
        want = dp.coeff_table_plain(flat, CH, Np, Tp, SC, Ts)
        want = [want[0], *want[1], dp.grid_words_plain(flat, CH, Np, *grid)]
        if fused:
            args = (flat, CH, Np, Tp, SC, Ts, *grid)
            table, sels, words = dp.coeff_grid(*args)
            _held(f"M1 and M2 {label}", [table, *sels, words], want)
            res[f"{label}_m1m2_ms"] = events_ms(lambda: dp.coeff_grid(*args),
                                                reps)
            if parts:
                # each part's blocks alone (the build variant), held first
                got = (prior_parts_call(*args, 1), prior_parts_call(*args, 2))
                _held(f"M1's and M2's blocks alone {label}",
                      [got[0][0], *got[0][1], got[1][2]], want)
                for k, n in (("m1", 1), ("m2", 2)):
                    res[f"{label}_{k}_blocks_ms"] = events_ms(
                        lambda: prior_parts_call(*args, n), reps)
            continue
        table, sels = dp.coeff_table(flat, CH, Np, Tp, SC, Ts)
        words = dp.grid_words(flat, CH, Np, *grid)

        def m1():
            return dp.coeff_table(flat, CH, Np, Tp, SC, Ts)

        def m2():
            return dp.grid_words(flat, CH, Np, *grid)

        _held(f"M1 and M2 {label}", [table, *sels, words], want)
        res[f"{label}_m1_ms"] = events_ms(m1, reps)
        res[f"{label}_m2_ms"] = events_ms(m2, reps)
        res[f"{label}_m1_then_m2_ms"] = events_ms(lambda: (m1(), m2()), reps)
    return res


def time_route():
    import statistics

    import torch
    from jackal_tpu_torch.config import ElasParams, PipelineParams
    from jackal_tpu_torch.matching.elas.pipeline import (
        elas_match, elas_match_batch_device)
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    dev = torch.device("cuda", 0)
    params = ElasParams()
    pipe = make_pipeline(engine="elas", params=PipelineParams(
        im_width=640, im_height=480, crop_im_width=640, crop_im_height=480),
        device=dev)
    pairs = [synthetic_raw_pair(pipe, seed, 8.0 + 6 * seed, 0.03 * (seed % 3))
             for seed in range(9)]
    rect = [pipe._rectify_crop(torch.from_numpy(lr).to(dev),
                               torch.from_numpy(rr).to(dev))
            for lr, rr in pairs]
    for L, R in rect:
        D1, D2 = elas_match(L, R, params, device=dev)
        B1, B2 = elas_match_batch_device(L[None], R[None], params, chunk=1,
                                         device=dev)
        _held("batched path at B = 1 against elas_match", [B1[0], B2[0]],
              [D1, D2])
    runs = {"process_frame": [lambda lr=lr, rr=rr: pipe.process_frame(lr, rr)
                              for lr, rr in pairs],
            "elas_match": [lambda L=L, R=R: elas_match(L, R, params,
                                                       device=dev)
                           for L, R in rect],
            "elas_match_batch_device_B1_chunk1": [
                lambda L=L, R=R: elas_match_batch_device(
                    L[None], R[None], params, chunk=1, device=dev)
                for L, R in rect]}
    res = {}
    for name, calls in runs.items():
        for fn in calls:                                    # warm-up round
            host_ms(fn, 1)
        times = [host_ms(fn, 1) for _ in range(3) for fn in calls]
        res[name] = {"median_ms": statistics.median(times),
                     "min_ms": min(times), "max_ms": max(times),
                     "n": len(times)}
    return res


def _queue_ms(fn, reps):
    """Host ms a call of fn() takes to queue its work: reps calls queued
    behind a spin kernel of about 50 ms, so that no call waits on the
    card."""
    import time

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def time_stream(rounds):
    import statistics
    import time

    import torch
    from jackal_tpu_torch.config import BMParams, PipelineParams
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.runner import TOPIC_DEPTH, StreamingRunner
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    dev = torch.device("cuda", 0)
    size = dict(im_width=640, im_height=480, crop_im_width=640,
                crop_im_height=480)
    res = {}
    n_frames = 48
    for engine, batch, every in (("bm", 8, 3), ("sgm", 4, 4)):
        kw = {"bm_params": BMParams(disp_num=64)} if engine == "bm" else {}
        pipe = make_pipeline(engine=engine, params=PipelineParams(**size),
                             device=dev, **kw)
        pairs = [synthetic_raw_pair(pipe, s, 8.0 + 5 * s, 0.03 * (s % 3))
                 for s in range(9)]
        pipe.process_frame(*pairs[0])                   # warm-up
        want = [pipe.process_frame(lr, rr).dmap for lr, rr in pairs]
        stream = [pairs[i % len(pairs)] for i in range(n_frames)]
        bus = TopicBus()
        depth = []
        bus.subscribe(TOPIC_DEPTH, depth.append)
        runner = StreamingRunner(pipe, bus, batch_size=batch,
                                 stage_sample_every=every)
        runner.run(iter(stream[:2 * batch]))            # warm-up
        fps = []
        for _ in range(rounds):
            depth.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            n = runner.run(iter(stream))
            torch.cuda.synchronize()
            fps.append(n / (time.perf_counter() - t))
            if n != n_frames or len(depth) != n_frames or not all(
                    np.array_equal(m.data, want[i % len(pairs)])
                    for i, m in enumerate(depth)):
                raise AssertionError(f"{engine} stream != process_frame")
        lb = np.stack([pairs[i % len(pairs)][0] for i in range(batch)])
        rb = np.stack([pairs[i % len(pairs)][1] for i in range(batch)])
        frame = [host_ms(lambda lr=lr, rr=rr: pipe.process_frame(lr, rr), 1)
                 for _ in range(3) for lr, rr in pairs]
        lt, rt = pipe._rectify_crop(torch.from_numpy(lb).to(dev),
                                    torch.from_numpy(rb).to(dev))

        def match():
            return pipe._match_batch(lt, rt)
        res[engine] = {
            "batch": batch, "frames": n_frames, "stream_fps": fps,
            "stream_fps_median": statistics.median(fps),
            "frame_ms_median": statistics.median(frame),
            "batch_ms_median": host_ms(
                lambda: pipe.process_batch_fused(lb, rb), 21),
            "match_device_ms": events_ms(match, 20),
            "match_queue_ms": statistics.median(
                _queue_ms(match, 20) for _ in range(5))}
        del pipe, runner
        torch.cuda.empty_cache()
    return res


def time_dense(d1, d2, params, reps):
    import torch
    from jackal_tpu_torch.matching.elas import dense as dm

    from jackal_tpu_torch.matching.elas import post

    per_frame = [prior_inputs(d1[b:b + 1], d2[b:b + 1], params, d1.device)
                 for b in range(2)]
    res = {"pair_call": hasattr(dm, "dense_match_pair"),
           "lr_epilogue": hasattr(dm, "dense_match_pair_lr")}
    # (label, first frame, frames): each pair at B = 1, the batch of 8
    for label, b0, B in (("B1", 0, 1), ("B1_pair2", 1, 1), ("B8", 0, 8)):
        ml, mr = ([torch.cat([per_frame[b % 2][v][i]
                              for b in range(b0, b0 + B)])
                   for i in range(4)] for v in (0, 1))
        q1, q2 = d1[b0:b0 + B].contiguous(), d2[b0:b0 + B].contiguous()
        want = (dm.dense_match_plain(q1, q2, *ml, params, False),
                dm.dense_match_plain(q1, q2, *mr, params, True))
        if res["pair_call"]:
            def call():
                return dm.dense_match_pair(q1, q2, ml, mr, params)
        else:
            def call():
                return (dm.dense_match(q1, q2, *ml, params, False),
                        dm.dense_match(q1, q2, *mr, params, True))
        _held(f"dense {label}", call(), want)
        res[f"ms_{label}"] = events_ms(call, reps)
        lr_want = post.left_right_consistency_check_plain(*want, params)

        def b_then_h():
            return post.left_right_consistency_check(*call(), params)
        _held(f"dense then L/R {label}", b_then_h(), lr_want)
        res[f"ms_then_lr_{label}"] = events_ms(b_then_h, reps)
        got = call()
        res[f"ms_lr_alone_{label}"] = events_ms(
            lambda: post.left_right_consistency_check(*got, params), reps)
        if res["lr_epilogue"]:
            def fused():
                return dm.dense_match_pair_lr(q1, q2, ml, mr, params)
            _held(f"dense with the L/R epilogue {label}", fused(), lr_want)
            res[f"ms_fused_{label}"] = events_ms(fused, reps)
    return res


def time_census(left, right, reps):
    import torch
    from jackal_tpu_torch.ops import sgm_kernel as sk

    dev = torch.device("cuda", 0)
    node = torch.from_numpy(np.stack([left[0], right[0]])).to(dev)
    b2 = torch.from_numpy(np.concatenate([left[:2], right[:2]])).to(dev)
    cfg3 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2 * CONFIG3[0],) + CONFIG3[1:]).astype(np.uint8)).to(dev)
    res = {}
    for label, imgs in (("node", node), ("b2", b2), ("config3", cfg3)):
        _held(f"census {label}", [sk.census5x5_batch(imgs)],
              [sk.census5x5_batch_plain(imgs)])
        res[f"ms_{label}"] = events_ms(lambda: sk.census5x5_batch(imgs),
                                       reps)
    return res


def time_bm(left, right, reps):
    import torch
    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.ops import bm_kernel as bk

    dev = torch.device("cuda", 0)
    lt, rt = (torch.from_numpy(np.stack([x[i % 2] for i in range(32)])).to(dev)
              for x in (left, right))
    res = {}
    for label, B, D in (("node", 1, 64), ("D256", 1, 256), ("config5", 32, 64),
                        ("bm256", 16, 256)):
        p = BMParams(disp_num=D)
        li, ri = lt[:B].contiguous(), rt[:B].contiguous()
        _held(f"bm {label}", bk.bm_match_fused(li, ri, p),
              bk.bm_match_fused_plain(li, ri, p))
        res[f"ms_{label}"] = events_ms(lambda: bk.bm_match_fused(li, ri, p),
                                       reps)
    return res


def time_tail(left, right, reps):
    import torch
    from jackal_tpu_torch.config import BMParams, SGMParams
    from jackal_tpu_torch.matching import bm, sgm
    from jackal_tpu_torch.ops import bm_kernel as bk
    from jackal_tpu_torch.ops import sgm_kernel as sk

    dev = torch.device("cuda", 0)
    res = {}
    p = SGMParams()
    D = p.disp_num
    rng = np.random.default_rng(0)
    cfg3 = [torch.from_numpy(rng.integers(0, 256, CONFIG3).astype(
        np.uint8)).to(dev) for _ in range(2)]
    node = [torch.from_numpy(x[:1]).to(dev) for x in (left, right)]
    kernels = hasattr(sk, "sgm_epilogue")
    fold = hasattr(sk, "sgm_wta_epilogue")
    for label, (lt, rt) in (("node", node), ("config3", cfg3)):
        B = lt.shape[0]
        codes = sk.census5x5_batch(torch.cat([lt, rt]))
        cl, cr = codes[:B], codes[B:]
        cost = sgm.census_cost_volume_hdw(cl, cr, D)
        S = sk.aggregate_paths_bhdw(cost, p)
        m = sk.sgm_wta_maps(S)
        if kernels:
            # the SGM tail as the parent runs it (F then O2), and F with O2
            # folded in where the checkout has it
            def f_then_o2():
                return sk.sgm_epilogue(sk.sgm_wta_maps(S), None, D, p, True)

            res[f"F_ms_{label}"] = events_ms(lambda: sk.sgm_wta_maps(S),
                                             reps)
            res[f"F_then_O2_ms_{label}"] = events_ms(f_then_o2, reps)
        if fold:
            want = sk.sgm_wta_epilogue_plain(S, p, True)
            _held(f"F with O2 folded in {label}",
                  sk.sgm_wta_epilogue(S, p, True), want)
            res[f"fold_ms_{label}"] = events_ms(
                lambda: sk.sgm_wta_epilogue(S, p, True), reps)
        del S
        if kernels:
            def cost_stage():
                return sk.sgm_cost_volume(cl, cr, D)

            def epi_stage():
                return sk.sgm_epilogue(m, None, D, p, True)

            _held(f"O1 {label}", [cost_stage()], [cost])
            _held(f"O2 {label}", epi_stage(),
                  sk.sgm_epilogue_plain(m, None, D, p, True))
            res[f"O1_ms_{label}"] = events_ms(cost_stage, reps)
            res[f"O2_ms_{label}"] = events_ms(epi_stage, reps)
        else:
            def cost_stage():
                return sgm.census_cost_volume_hdw(cl, cr, D)

            def epi_stage():
                mi = m.to(torch.int32)
                dL = sgm._wta_from_maps(*mi[:, :, 0:5].unbind(2), D, p)
                dR = sgm._wta_from_maps(*mi[:, :, 5:10].unbind(2), D, p)
                return torch.clamp(torch.round(sgm._lr_tail(dL, dR, D, p)[0]),
                                   0, 255).to(torch.uint8)
        res[f"cost_stage_ms_{label}"] = host_ms(cost_stage, 21)
        res[f"epilogue_stage_ms_{label}"] = host_ms(epi_stage, 21)
        del cost, m
        torch.cuda.empty_cache()
    if fold:
        # the fold's launch against F then O2 at the node's shape as D
        # grows (the halo the right view walks grows with it)
        lt, rt = node
        for Dx in (32, 48, 72, 80, 96, 128, 176):
            px = SGMParams(disp_num=Dx)
            codes = sk.census5x5_pair(lt, rt)
            S = sk.aggregate_paths_bhdw(sk.sgm_cost_volume(
                codes[:1], codes[1:], Dx), px)
            want = sk.sgm_wta_epilogue_plain(S, px, True)
            _held(f"F with O2 folded in at D = {Dx}",
                  sk._fold_cuda(S, px, True), want)
            res[f"fold_ms_node_D{Dx}"] = events_ms(
                lambda: sk._fold_cuda(S, px, True), reps)
            res[f"F_then_O2_ms_node_D{Dx}"] = events_ms(
                lambda: sk.sgm_epilogue(sk.sgm_wta_maps(S), None, Dx, px,
                                        True), reps)
            del S
    lt, rt = (torch.from_numpy(np.stack([x[i % 2] for i in range(32)])).to(dev)
              for x in (left, right))
    gate = hasattr(bm, "bm_gate_u8")
    for label, B, Dg in (("node", 1, 64), ("config5", 32, 64),
                         ("bm256", 16, 256)):
        pb = BMParams(disp_num=Dg)
        li, ri = lt[:B].contiguous(), rt[:B].contiguous()
        dL = bk.bm_match_fused(li, ri, pb)[0]
        if gate:
            def stage():
                return bm.bm_gate_u8(li, dL, pb)

            _held(f"S {label}", [stage(), bm.bm_texture_gate(li, dL, pb)],
                  [bm.bm_gate_u8_plain(li, dL, pb),
                   bm.bm_texture_gate_plain(li, dL, pb)])
            res[f"S_ms_{label}"] = events_ms(stage, reps)
            res[f"G_then_S_ms_{label}"] = events_ms(lambda: bm.bm_gate_u8(
                li, bk.bm_match_fused(li, ri, pb)[0], pb), reps)
        else:
            def stage():
                return torch.clamp(torch.round(bm.bm_texture_gate(
                    li, dL, pb)), 0, 255).to(torch.uint8)
        res[f"gate_stage_ms_{label}"] = host_ms(stage, 21)
        if hasattr(bk, "bm_match_gated"):
            _held(f"G with the gate {label}", bk.bm_match_gated(li, ri, pb),
                  bk.bm_match_gated_plain(li, ri, pb))
            res[f"G_gated_ms_{label}"] = events_ms(
                lambda: bk.bm_match_gated(li, ri, pb), reps)
        torch.cuda.empty_cache()
    return res


def _maps(out):
    """A call's maps as a tuple (the L/R check returns two)."""
    return out if isinstance(out, tuple) else (out,)


def time_post(maps, reps):
    import torch
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import post

    dev = torch.device("cuda", 0)
    D1, D2 = (torch.from_numpy(m).to(dev) for m in maps[:2])
    X2 = torch.from_numpy(np.stack(maps[:2])).to(dev)
    rob, mb = ElasParams(), ElasParams.middlebury()
    res = {}
    for label, call, plain in (
            ("lr_B1", lambda: post.left_right_consistency_check(D1, D2, rob),
             lambda: post.left_right_consistency_check_plain(D1, D2, rob)),
            ("gap_robotics_B1", lambda: post.gap_interpolation(D1, rob),
             lambda: post.gap_interpolation_plain(D1, rob)),
            ("gap_middlebury_B2", lambda: post.gap_interpolation(X2, mb),
             lambda: post.gap_interpolation_plain(X2, mb)),
            ("mean8_B1", lambda: post.adaptive_mean(D1),
             lambda: post.adaptive_mean_plain(D1)),
            ("mean4_B1", lambda: post.adaptive_mean_sub(D1),
             lambda: post.adaptive_mean_sub_plain(D1)),
            ("median_B1", lambda: post.median_filter(D1),
             lambda: post.median_filter_plain(D1)),
            ("median_B2", lambda: post.median_filter(X2),
             lambda: post.median_filter_plain(X2))):
        _held(label, [x.view(torch.int32) for x in _maps(call())],
              [x.view(torch.int32) for x in _maps(plain())])
        res[f"ms_{label}"] = events_ms(call, reps)
    return res


def time_speckle(maps, reps):
    import torch
    from chip_smoke import SPECKLE_EDGE_CASES, speckle_edge_case
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import post

    dev = torch.device("cuda", 0)
    p = ElasParams()
    X1 = torch.from_numpy(maps[0]).to(dev)
    X8 = torch.from_numpy(np.stack([maps[i % 4] for i in range(8)])).to(dev)
    F8 = speckle_edge_case(SPECKLE_EDGE_CASES[16], dev)[0]
    F16 = speckle_edge_case(SPECKLE_EDGE_CASES[20], dev)[0]
    res = {}
    for label, X in (("golden_B1", X1), ("golden_B8", X8),
                     ("field_B8", F8), ("field_B16", F16)):
        _held(f"speckle {label}",
              [post.remove_small_segments_batch(X, p).view(torch.int32)],
              [post.remove_small_segments_batch_plain(X, p).view(
                  torch.int32)])
        res[f"ms_{label}"] = events_ms(
            lambda: post.remove_small_segments_batch(X, p), reps)
    return res


def time_remap(left, right, reps):
    import torch
    from jackal_tpu_torch.config import BMParams, PipelineParams
    from jackal_tpu_torch.geometry import remap
    from jackal_tpu_torch.pipeline.default import make_pipeline

    dev = torch.device("cuda", 0)
    size = dict(im_width=640, im_height=480, crop_im_width=640,
                crop_im_height=480)
    node = make_pipeline(engine="elas", params=PipelineParams(**size),
                         device=dev)
    cfg5 = make_pipeline(engine="bm", bm_params=BMParams(disp_num=64),
                         params=PipelineParams(calib_im_size=(640, 360),
                                               gen_pcl=True, **size),
                         device=dev)
    rng = np.random.default_rng(18)
    raw_l, raw_r = (torch.from_numpy(rng.integers(
        0, 256, (1, 360, 640)).astype(np.uint8)).to(dev) for _ in range(2))
    l5, r5 = (torch.from_numpy(np.stack([x[i % 2] for i in range(32)])).to(
        dev) for x in (left, right))
    col = torch.from_numpy(rng.integers(0, 256, (32, 3, 480, 640)).astype(
        np.uint8)).to(dev)
    res = {}
    for label, call, plain in (
            ("pair_B1", lambda: remap.remap_bilinear_pair(
                raw_l, raw_r, node.lmap, node.rmap),
             lambda: (remap.remap_bilinear_plain(raw_l, *node.lmap),
                      remap.remap_bilinear_plain(raw_r, *node.rmap))),
            ("config5_B32", lambda: remap.remap_bilinear_pair(
                l5, r5, cfg5.lmap, cfg5.rmap),
             lambda: (remap.remap_bilinear_plain(l5, *cfg5.lmap),
                      remap.remap_bilinear_plain(r5, *cfg5.rmap))),
            ("colour_F96", lambda: (remap.remap_bilinear(col, *cfg5.lmap),),
             lambda: (remap.remap_bilinear_plain(col, *cfg5.lmap),))):
        _held(f"remap {label}", call(), plain())
        res[f"ms_{label}"] = events_ms(call, reps)
    return res


def _same_bits(name, got, want):
    """float tensors equal bit for bit (NaN payloads included)."""
    import torch

    for g, w in zip(got, want):
        if not torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32)):
            raise AssertionError(f"{name}: kernel != reference")


def _same_scan(name, got, want):
    """Two ScanResults: NaN masks equal, the rest torch.equal (as
    chip_smoke.scan_same holds them)."""
    import torch

    for f in _FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if not (torch.equal(torch.isnan(g), torch.isnan(w))
                and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))):
            raise AssertionError(f"{name}: {f} differs")


def _staged_variants(obs, dm, sp, gp, ox, oy, calib, reps):
    """P2 and the fused cloud and scan with their points staged in shared
    memory (tools/scan_store_variants.cu, modes 1: a block's, 2: a
    warp's), each held equal to the kernel's own outputs; device ms a
    call."""
    import ctypes

    import torch
    from jackal_tpu_torch.build import Library, build
    from jackal_tpu_torch.ops import cuda_lib

    csrc = cuda_lib.CSRC
    lib = Library(name="scan_store_variants", compiler=cuda_lib._nvcc(),
                  flags=cuda_lib.NVCC_FLAGS + ("-I", csrc),
                  sources=(os.path.join(HERE, "tools",
                                        "scan_store_variants.cu"),),
                  headers=(os.path.join(csrc, "scan_kernel.cu"),))
    fn = ctypes.CDLL(build([lib])[0]).cloud_staged
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    fn.argtypes = [I, I] + [P] * 10 + [L] * 4 + [I] * 7 + [F] * 6 + [P]
    fn.restype = ctypes.c_int
    want_cloud, want_scan = obs.cloud_and_scan_from_disparity(
        dm, None, *calib, sp, gp, ox, oy)
    res = {}
    for mode, how in ((1, "block"), (2, "warp")):
        for scan in (0, 1):
            def call():
                _, B, H, W, d, cloud, ptrs, strides = obs._cloud_args(
                    "staged", dm, None, *calib)
                out, scratch, key = obs._scan_outputs(sp, B, d.device)
                cuda_lib.launch(
                    fn, "staged", d, mode, scan, *ptrs, scratch.data_ptr(),
                    out.data_ptr(), *strides, B, H, W, ox, oy,
                    sp.min_pcl_disp, sp.bin_size, *obs._bin_constants(sp),
                    *obs._ground_constants(gp))
                return cloud, obs._scan_result(out, dm.shape[:-2], sp, B)

            cloud, got = call()
            label = f"{'cloud_scan' if scan else 'cloud'}_{how}_staged"
            _same_bits(label, [cloud[0], cloud[1]],
                       [want_cloud[0], want_cloud[1]])
            if not torch.equal(cloud[2], want_cloud[2]):
                raise AssertionError(f"{label}: valid != kernel's")
            if scan:
                _same_scan(label, got, want_scan)
            res[f"ms_{label}_config5_B32"] = events_ms(call, reps)
    return res


_FIELDS = ("scan", "angle_min", "angle_max", "range_min", "range_max")


def time_scan(left, right, reps):
    import time

    import torch
    from jackal_tpu_torch.config import BMParams, PipelineParams
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.scan import obstacle as obs

    dev = torch.device("cuda", 0)
    size = dict(im_width=640, im_height=480, crop_im_width=640,
                crop_im_height=480)
    node = make_pipeline(engine="elas", params=PipelineParams(**size),
                         device=dev)
    cfg5 = make_pipeline(engine="bm", bm_params=BMParams(disp_num=64),
                         params=PipelineParams(calib_im_size=(640, 360),
                                               gen_pcl=True, **size),
                         device=dev)
    l5, r5 = (torch.from_numpy(np.stack([x[i % 2] for i in range(32)])).to(
        dev) for x in (left, right))
    dm5 = cfg5.process_batch_fused(l5, r5)[0]
    calib = (node.Q32, node.XR32, node.XT32)
    calib5 = (cfg5.Q32, cfg5.XR32, cfg5.XT32)
    ox, oy = node.p.crop_offset_x, node.p.crop_offset_y
    ox5, oy5 = cfg5.p.crop_offset_x, cfg5.p.crop_offset_y
    res = {}
    for B in (1, 8):
        m = dm5[:B] if B > 1 else dm5[0]

        def p1():
            return obs.obstacle_scan_from_disparity(
                m, node.valid_disp, *calib, node.sp, ox, oy)

        want = obs.obstacle_scan_from_disparity_plain(
            m, node.valid_disp, *calib, node.sp, ox, oy)
        _same_scan(f"P1 B = {B}", p1(), want)
        res[f"ms_P1_B{B}"] = events_ms(p1, reps)
    pts, _, valid = obs.point_cloud_from_disparity(
        dm5, None, *calib5, cfg5.sp, ox5, oy5)
    res["ms_P2_config5_B32"] = events_ms(
        lambda: obs.point_cloud_from_disparity(
            dm5, None, *calib5, cfg5.sp, ox5, oy5), reps)
    res["ms_P3_config5_B32"] = events_ms(
        lambda: obs.obstacle_scan_from_points(pts, valid, cfg5.sp, cfg5.gp),
        reps)
    res["ms_tail_config5_B32"] = events_ms(lambda: cfg5._cloud_scan(dm5),
                                           reps)
    m1 = dm5[0]
    res["stage_ms_node_scan"] = host_ms(lambda: node._scan_stage(m1), 201)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(1000):
        node._scan_stage(m1)
    res["host_us_node_scan_a_call"] = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    res["stage_ms_config5_tail"] = host_ms(lambda: cfg5._cloud_scan(dm5), 51)
    if hasattr(obs, "cloud_and_scan_from_disparity"):
        res.update(_staged_variants(obs, dm5, cfg5.sp, cfg5.gp, ox5, oy5,
                                    calib5, reps))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True)
    ap.add_argument("--kernel", default="support",
                    choices=("support", "dense", "census", "bm", "post",
                             "speckle", "remap", "scan", "front",
                             "coeffs", "route", "tail", "stream"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        print("time_support_kernel: no CUDA device", file=sys.stderr)
        return 2
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.ops.descriptor import create_descriptor

    dev = torch.device("cuda", 0)
    params = ElasParams()
    gold = [np.load(os.path.join(HERE, FIX, f"{g}.npz")) for g in GOLDEN]
    left = np.stack([gold[i % 2]["left"] for i in range(8)])
    right = np.stack([gold[i % 2]["right"] for i in range(8)])
    res = {"card": card_line(), "repo": args.repo, "kernel": args.kernel}
    if args.kernel == "census":
        res.update(time_census(left, right, args.reps))
    elif args.kernel == "bm":
        res.update(time_bm(left, right, args.reps))
    elif args.kernel == "speckle":
        res.update(time_speckle([g[k] for g in gold for k in ("D1", "D2")],
                                args.reps))
    elif args.kernel == "remap":
        res.update(time_remap(left, right, args.reps))
    elif args.kernel == "scan":
        res.update(time_scan(left, right, args.reps))
    elif args.kernel == "front":
        res.update(time_front(left, right, params, args.reps))
    elif args.kernel == "coeffs":
        res.update(time_coeffs(left, right, params, args.reps))
    elif args.kernel == "route":
        res.update(time_route())
    elif args.kernel == "stream":
        res.update(time_stream(args.reps))
    elif args.kernel == "tail":
        res.update(time_tail(left, right, args.reps))
    elif args.kernel == "post":
        res.update(time_post([g[k] for g in gold for k in ("D1", "D2")],
                             args.reps))
    else:
        d1 = create_descriptor(torch.from_numpy(left).to(dev))
        d2 = create_descriptor(torch.from_numpy(right).to(dev))
        fn = time_support if args.kernel == "support" else time_dense
        res.update(fn(d1, d2, params, args.reps))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
