"""The flagship step as one callable: rectify -> SGM (64 levels) -> scan.

The port's counterpart of the reference package's `__graft_entry__.entry`: a
(fn, example_args) pair whose fn is the SGM node's batched step at 640x480,
batch 1, with seeded random frames. Run it with

    fn, args = entry()
    dmaps, scan = fn(*args)
"""
from __future__ import annotations

import numpy as np
import torch

from .config import PipelineParams
from .device import DeviceLike
from .pipeline.default import default_calibration
from .pipeline.frame_pipeline import StereoPipeline


def entry(device: DeviceLike = None):
    """(fn, (left, right)): fn(left_b, right_b) -> (u8 disparity maps
    [1, 480, 640], scan bins [1, 90]) on ``device`` (the card unless
    "cpu"); left and right are seeded uint8 [1, 480, 640] frames there."""
    params = PipelineParams(
        calib_im_size=(640, 360), im_width=640, im_height=480,
        crop_im_width=640, crop_im_height=480)
    pipe = StereoPipeline(default_calibration(), params, engine="sgm",
                          device=device)

    def fn(left_b, right_b):
        dmaps, scans = pipe.process_batch_fused(left_b, right_b)
        return dmaps, scans.scan

    rng = np.random.default_rng(0)
    left, right = (torch.from_numpy((rng.random((1, 480, 640)) * 255)
                                    .astype(np.uint8)).to(pipe.device)
                   for _ in range(2))
    return fn, (left, right)
