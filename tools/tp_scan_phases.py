"""Run chip_smoke.py's phases 10c (the exact scan, kernel V) and 11b (TP BM,
kernels T1 and T2) alone on the card, in seconds instead of the whole
script's minutes.

    python3 tools/tp_scan_phases.py

Inputs: the BM node at 640x480 (make_pipeline(engine="bm")) on 4 seeded
raw pairs (pipeline.synthetic.synthetic_raw_pair, seeds 0-3): its u8 maps
for 10c (with chip_smoke.EXACT_SCAN_EDGE_CASES), its rectified frames for
11b (chip_smoke.TP_CARD_CASES). Each phase checks and prints what it does
in chip_smoke.py (kernels against their plain versions, launch pins, ATen
ops a call, times against bounds) and raises on a failure; then one JSON
line with the phases' numbers and the card line.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_scan_phases: no CUDA device", file=sys.stderr)
        return 2
    from jackal_tpu_torch import build as buildmod
    from jackal_tpu_torch.config import PipelineParams
    from jackal_tpu_torch.ops import cuda_lib
    from jackal_tpu_torch.pipeline.default import make_pipeline
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    dev = torch.device("cuda", 0)
    buildmod.build([cuda_lib.library(n) for n in (
        "bm_tp_kernel", "exact_scan_kernel", "exact_scan_kernel_nofmad",
        "bm_gate_kernel", "bm_kernel")])
    pipe = make_pipeline(engine="bm", device=dev, params=PipelineParams(
        im_width=640, im_height=480, crop_im_width=640, crop_im_height=480))
    dmaps, rect_l, rect_r = [], [], []
    for s in range(4):
        left, right = synthetic_raw_pair(pipe, s, 8.0 + 6 * s, 0.03 * (s % 3))
        dmaps.append(np.asarray(pipe.process_frame(left, right).dmap))
        L, R = pipe._rectify_crop(torch.from_numpy(left).to(dev),
                                  torch.from_numpy(right).to(dev))
        rect_l.append(L)
        rect_r.append(R)

    def hold(kernel, name, got, want):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: {int((g != w).sum())} "
                                     f"elements differ")

    scan, v_entry = cs.exact_scan_phase(dev, hold, pipe, dmaps)
    tp = {}
    t_entries = cs.tp_phase(dev, hold, torch.stack(rect_l),
                            torch.stack(rect_r), tp)
    print(json.dumps({"exact_scan": scan, "tp": tp,
                      "kernels": [v_entry] + t_entries}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
