"""Count the ATen ops that the ELAS paths of a checkout of jackal_tpu_torch
dispatch on the card, and time its batched raster stage, the tail and the
node's u8 map.

    python3 tools/elas_eager_ops.py --repo DIR [--reps 20]

DIR is the root of the checkout whose jackal_tpu_torch is imported. The
frames are chip_smoke's node frames: seeded raw 640x360 pairs
(pipeline.synthetic.synthetic_raw_pair, seeds 0-8) rectified to 640x480.
Op counts (chip_smoke.aten_ops_of_a_call: each ATen op a call dispatches,
and whether it launches a kernel on the card) of one call each of
- the ELAS node's process_frame (ROBOTICS, the default preset);
- elas_match at MIDDLEBURY on that frame's rectified pair, and, where the
  checkout has it, the node's per-frame u8 route at MIDDLEBURY;
- one batched chunk of 8 frames (seeds 0-7): _chunk_tail (coefficients,
  raster, dense, postprocess) and the node's u8 map, dmap_u8 of D1 in a
  checkout without the u8 routes, the tail's u8 sink in one with them
  (with D2 left after the L/R check, as the node's route leaves it).
Times of that chunk, in ms: CUDA events behind a spin (chip_smoke.
events_ms) and the host clock with a synchronize (chip_smoke.host_ms, as
chip_smoke.py's batch stage table reads it) of the raster stage
(_chunk_raster), the tail (post_tail after the speckle filter) with the
node's u8 map and without it and the u8 map alone (dmap_u8, three eager
launches); on the host clock also the chunk's whole tail with the u8
map. Prints one JSON
line. Run two checkouts in one call (parent, change, change, parent) to
compare them on one card.
"""
import argparse
import collections
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import (aten_ops_of_a_call, card_line, events_ms,  # noqa: E402
                        host_ms)


def summary(ops) -> dict:
    """The ops that launch a kernel on the card, by name, and the count of
    those that launch none."""
    launching = collections.Counter(n for n, ok in ops if not ok)
    return {"launching": dict(sorted(launching.items())),
            "launching_total": sum(launching.values()),
            "no_kernel": sum(ok for _, ok in ops)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        print("elas_eager_ops: no CUDA device", file=sys.stderr)
        return 2
    from jackal_tpu_torch.config import ElasParams, PipelineParams
    from jackal_tpu_torch.matching.elas import dense
    from jackal_tpu_torch.matching.elas import pipeline as ep
    from jackal_tpu_torch.matching.elas import post
    from jackal_tpu_torch.ops.convert import dmap_u8
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    dev = torch.device("cuda", 0)
    routes = hasattr(ep, "_elas_match_u8")
    pipe = make_pipeline(engine="elas", params=PipelineParams(
        im_width=640, im_height=480, crop_im_width=640, crop_im_height=480),
        device=dev)
    pairs = [synthetic_raw_pair(pipe, seed, 8.0 + 6 * seed, 0.03 * (seed % 3))
             for seed in range(9)]
    res = {"card": card_line(), "repo": args.repo, "u8_routes": routes}
    ops = {}

    lr, rr = pairs[8]
    pipe.process_frame(lr, rr)
    ops["process_frame ROBOTICS"] = summary(aten_ops_of_a_call(
        lambda: pipe.process_frame(lr, rr)))
    L, R = pipe._rectify_crop(torch.from_numpy(lr).to(dev),
                              torch.from_numpy(rr).to(dev))
    mb = ElasParams.middlebury()
    ep.elas_match(L, R, mb, device=dev)
    ops["elas_match MIDDLEBURY"] = summary(aten_ops_of_a_call(
        lambda: ep.elas_match(L, R, mb, device=dev)))
    if routes:
        ops["u8 route MIDDLEBURY"] = summary(aten_ops_of_a_call(
            lambda: ep._elas_match_u8(L, R, mb, device=dev)))

    params = ElasParams()
    L8, R8 = pipe._rectify_crop(
        torch.from_numpy(np.stack([p[0] for p in pairs[:8]])).to(dev),
        torch.from_numpy(np.stack([p[1] for p in pairs[:8]])).to(dev))
    B, H, W = L8.shape
    d1, d2, dcan_dev = ep._front(L8, R8, params)
    dcan = dcan_dev.cpu().numpy()
    wires = [ep._prior_tri_job(dcan[b], params, W, H) for b in range(B)]
    Np, Tp, Ts = ep._chunk_pads(wires)
    lad = ep._lr_ladder(wires, params)
    flat = torch.from_numpy(ep._flatten_chunk_wire(wires, Np, Tp,
                                                   Ts)).to(dev)
    if routes:
        node_params = ep._node_params(params, True)
        U8 = torch.empty((B, H, W), dtype=torch.uint8, device=dev)

        def chunk():
            ep._chunk_tail(flat, d1, d2, B, Np, Tp, Ts, W, H, node_params,
                           lad, None, U8)
            return U8
    else:
        def chunk():
            return dmap_u8(ep._chunk_tail(flat, d1, d2, B, Np, Tp, Ts, W, H,
                                          params, lad)[0])
    chunk()
    ops["batched chunk of 8 with the u8 map"] = summary(
        aten_ops_of_a_call(chunk))
    res["ops"] = ops

    coeffs = ep._chunk_coeffs(flat, B, Np, Tp, Ts, W, H, params)
    m1, m2 = ep._chunk_raster(coeffs, Tp, W, H)
    D1, D2 = dense.dense_match_pair_lr(d1, d2, m1, m2, params, lad)
    S1 = post.remove_small_segments_batch(D1, params)
    Fin = post.post_tail(S1, D2, params)[0]
    U = torch.empty(tuple(S1.shape), dtype=torch.uint8, device=dev)
    if routes:
        post.post_tail(S1, D2, params, u8=U)
        if not torch.equal(U, dmap_u8(Fin)):
            raise AssertionError("the tail's u8 map != dmap_u8")

        def tail_u8():
            return post.post_tail(S1, D2, params, u8=U)
    else:
        def tail_u8():
            return dmap_u8(post.post_tail(S1, D2, params)[0])
    if not torch.equal(chunk(), dmap_u8(Fin)):
        raise AssertionError("the chunk's u8 map != dmap_u8 of its tail")
    calls = {"raster stage": lambda: ep._chunk_raster(coeffs, Tp, W, H),
             "tail": lambda: post.post_tail(S1, D2, params),
             "tail with the u8 map": tail_u8,
             "dmap_u8 alone": lambda: dmap_u8(Fin)}
    res["events_ms"] = {k: events_ms(f, args.reps) for k, f in calls.items()}
    calls["chunk tail with the u8 map"] = chunk
    res["host_ms"] = {k: host_ms(f, 21) for k, f in calls.items()}
    res["chunk"] = {"B": B, "Np": Np, "Tp": Tp, "Ts": Ts, "lr_smax": lad}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
