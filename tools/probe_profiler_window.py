"""Which kernel launches torch.profiler records in a short window on the card.

chip_smoke.device_busy traces one call of a step in a torch.profiler window
and reads the device's busy time from the kernels the profiler records. A
step whose kernels are all launched through ctypes (the port's hand-written
kernels) and that dispatches no ATen kernel can come back with no device
activity at all. This probe traces windows of n calls of kernel S
(matching/bm.bm_gate_u8 at BASELINE config 5's shape, 32 x 640x480), each
window optionally padded before and after the calls with torch's spin
kernel (torch.cuda._sleep), and prints, for each window, how many of the
calls' launches, of the padding's and of anything else the profiler
recorded, and the padding kernel's name. With --late, a profiler window
is opened and closed before kernel S's library is first loaded and
launched, as chip_smoke.py's phase 4 windows come before the libraries
that phases 6 and 7 load first.

    python3 tools/probe_profiler_window.py [--late]

Needs the card. Prints one JSON line a window configuration.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jackal_tpu_torch.config import BMParams
    from jackal_tpu_torch.matching import bm

    if not torch.cuda.is_available():
        print("probe_profiler_window: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    late = "--late" in sys.argv[1:]
    if late:
        x = torch.ones(16, device=dev)
        with profile(activities=[ProfilerActivity.CUDA,
                                 ProfilerActivity.CPU]):
            x.add_(1)
            torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.integers(0, 256, (32, 480, 640)).astype(
        np.uint8)).to(dev)
    dl = torch.from_numpy(rng.random((32, 480, 640)).astype(np.float32)
                          * 64).to(dev)
    p = BMParams()
    for _ in range(3):
        bm.bm_gate_u8(left, dl, p)
    torch.cuda.synchronize()

    def window(n, head, tail, host_ops, head_ms):
        acts = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])
        with profile(activities=acts) as prof:
            for _ in range(head):
                torch.cuda._sleep(1)
            if head_ms:
                torch.cuda._sleep(int(head_ms * 2e6))
            torch.cuda.synchronize()
            for _ in range(n):
                bm.bm_gate_u8(left, dl, p)
            torch.cuda.synchronize()
            for _ in range(tail):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        gate = sum("bm_gate" in x for x in names)
        spin = [x for x in names if "spin" in x]
        return gate, len(spin), len(names) - gate - len(spin), sorted(
            set(spin))

    for n, head, tail, host_ops, head_ms in (
            (1, 0, 0, True, 0), (5, 0, 0, True, 0), (20, 0, 0, True, 0),
            (5, 0, 32, True, 0), (5, 32, 0, True, 0), (5, 32, 32, True, 0),
            (5, 0, 0, False, 0), (5, 32, 0, True, 1.0),
            (5, 32, 32, True, 1.0)):
        got = [window(n, head, tail, host_ops, head_ms) for _ in range(5)]
        print(json.dumps({
            "late": late, "calls": n, "head_pad": head, "tail_pad": tail,
            "host_ops": host_ops, "head_spin_ms": head_ms,
            "gate_recorded": [g[0] for g in got],
            "pad_recorded": [g[1] for g in got],
            "other_recorded": [g[2] for g in got],
            "pad_names": sorted({x for g in got for x in g[3]})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
