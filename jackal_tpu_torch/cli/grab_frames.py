"""grab_frames CLI: calibration-image capture tool (grab_frames.cpp port).

The reference shows live views and saves left%d.jpg/right%d.jpg on
keypress (grab_frames.cpp:17-67). Headless equivalent: pull frames from a
replay/camera source and save numbered pairs; -w/--height set the size of
synthetic frames.

    python -m jackal_tpu_torch.cli.grab_frames --source v4l2:... --count 5
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m jackal_tpu_torch.cli.grab_frames")
    ap.add_argument("-w", "--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--source", default="synthetic")
    ap.add_argument("--count", type=int, default=5)
    ap.add_argument("--outdir", default="calib_frames")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..io_bus.camera import open_source
    from ..io_bus.replay import synthetic_stream
    from ..io_bus.pgm import save_pgm

    os.makedirs(args.outdir, exist_ok=True)
    if args.source == "synthetic":
        # non-default sizes only exist on the synthetic generator
        stream = synthetic_stream(args.count, args.height, args.width)
    else:
        stream = iter(open_source(args.source, n_synthetic=args.count))

    saved = 0
    for i, (left, right) in enumerate(stream):
        if i >= args.count:
            break
        try:
            import cv2
            cv2.imwrite(os.path.join(args.outdir, f"left{i}.jpg"), left)
            cv2.imwrite(os.path.join(args.outdir, f"right{i}.jpg"), right)
        except ImportError:
            save_pgm(os.path.join(args.outdir, f"left{i}.pgm"), left)
            save_pgm(os.path.join(args.outdir, f"right{i}.pgm"), right)
        saved += 1
        print(f"saved pair {i}")
    print(f"{saved} pairs in {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
