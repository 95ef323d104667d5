"""Time the ELAS support kernel (A) of a checkout of jackal_tpu_torch on the
card, at the per-frame node's shape (B = 1) and the batched node's (B = 8).

    python3 tools/time_support_kernel.py --repo DIR [--reps 50]

DIR is the root of the checkout whose jackal_tpu_torch is imported (its
csrc/support_kernel.cu is built there); the inputs are the golden 640x480
pairs of this repository's tests/fixtures (B = 8: the two alternated), at
the default ElasParams (D = 256), and the kernel is held equal to its
plain version on them. Run it on two checkouts in one call, in the order
A, B, B, A, to compare two versions of the kernel on one card. Prints one
JSON line: the card, DIR, and the device ms a call at each shape
(chip_smoke.events_ms: CUDA events around calls queued behind a spin).
"""
import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import FIX, GOLDEN, card_line, events_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        print("time_support_kernel: no CUDA device", file=sys.stderr)
        return 2
    from jackal_tpu_torch.config import ElasParams
    from jackal_tpu_torch.matching.elas import support as sm
    from jackal_tpu_torch.ops.descriptor import create_descriptor

    dev = torch.device("cuda", 0)
    params = ElasParams()
    D = params.disp_num
    gold = [np.load(os.path.join(HERE, FIX, f"{g}.npz")) for g in GOLDEN]
    left = np.stack([gold[i % 2]["left"] for i in range(8)])
    right = np.stack([gold[i % 2]["right"] for i in range(8)])
    d1 = create_descriptor(torch.from_numpy(left).to(dev))
    d2 = create_descriptor(torch.from_numpy(right).to(dev))
    step = sm.effective_stepsize(params)
    ncv = -(-left.shape[1] // step)
    res = {"card": card_line(), "repo": args.repo}
    for B in (1, 8):
        Q = sm.grid_row_blocks(d1[:B], step, ncv)
        T = sm.grid_row_blocks(d2[:B], step, ncv)
        got = sm.support_keys(Q, T, params.disp_min, D)
        want = sm.support_keys_plain(Q, T, params.disp_min, D)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{args.repo}: kernel != plain at B = {B}")
        res[f"ms_B{B}"] = events_ms(
            lambda: sm.support_keys(Q, T, params.disp_min, D), args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
