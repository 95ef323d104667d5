"""The flagship step as one callable, and a dry run of the multi-device
paths.

The port's counterparts of the reference package's `__graft_entry__`:
entry() is a (fn, example_args) pair whose fn is the SGM node's batched
step (rectify -> SGM, 64 levels -> scan) at 640x480, batch 1, with seeded
random frames; dryrun_multichip(n) runs one step of each multi-device path
(parallel/mesh.py, elas_match_batch_multichip) on an n-rank mesh at tiny
shapes. Run them with

    fn, args = entry()
    dmaps, scan = fn(*args)
    dryrun_multichip(8)             # or device="cpu"
"""
from __future__ import annotations

import numpy as np
import torch

from .config import PipelineParams
from .device import DeviceLike, resolve_device
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


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """One step of each multi-device path on a mesh of n_devices ranks, each
    ``device`` (the card unless "cpu"): data parallelism over the SGM and
    the BM fused steps, BM with the disparity axis over 4, 2 or 1 ranks
    (the largest that divides n_devices) and the rest over the data rows,
    and ELAS replicas on distinct frames, held equal to the single-device
    batched path. Raises if a shape or a map is not as the reference's dry
    run asserts."""
    from .config import BMParams, SGMParams
    from .matching.elas.pipeline import (elas_match_batch,
                                         elas_match_batch_multichip)
    from .parallel.mesh import (bm_match_tp, dp_sharded_step, gather,
                                make_mesh)

    dev = resolve_device(device)
    disp_par = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    devs = [dev] * n_devices
    mesh = make_mesh(n_devices, disp_parallel=disp_par, devices=devs)

    calib = default_calibration()
    H, W = 64, 96
    params = PipelineParams(
        calib_im_size=(640, 360), im_width=W, im_height=H,
        crop_im_width=W, crop_im_height=H)
    B = max(n_devices // disp_par, 1) * 2
    rng = np.random.default_rng(0)
    lb = (rng.random((B, H, W)) * 255).astype(np.uint8)
    rb = (rng.random((B, H, W)) * 255).astype(np.uint8)

    # the SGM fused step over the data rows at 128x160, D = 32
    Hs, Ws = 128, 160
    params_sgm = PipelineParams(
        calib_im_size=(640, 360), im_width=Ws, im_height=Hs,
        crop_im_width=Ws, crop_im_height=Hs)
    lbs = (rng.random((B, Hs, Ws)) * 255).astype(np.uint8)
    rbs = (rng.random((B, Hs, Ws)) * 255).astype(np.uint8)
    pipe_sgm = StereoPipeline(calib, params_sgm, engine="sgm",
                              sgm_params=SGMParams(disp_num=32), device=dev)
    dmaps, scans, _ = dp_sharded_step(pipe_sgm, mesh)(lbs, rbs)
    if gather(dmaps).shape != (B, Hs, Ws) or \
            gather(scans).scan.shape[0] != B:
        raise AssertionError("DP SGM: wrong output shapes")

    # the BM fused step over the data rows
    pipe_bm = StereoPipeline(calib, params, engine="bm",
                             bm_params=BMParams(disp_num=16), device=dev)
    dp_sharded_step(pipe_bm, mesh)(lb, rb)

    # BM with the disparity axis over the mesh's "disp" ranks
    dl_tp, _ = bm_match_tp(mesh, BMParams(disp_num=16))(lb, rb)
    if gather(dl_tp).shape != (B, H, W):
        raise AssertionError("TP BM: wrong output shape")

    # ELAS replicas on distinct frames == the single-device batched path
    lbe = np.stack([np.roll(lb[0], 3 * i, axis=1) for i in range(n_devices)])
    rbe = np.stack([np.roll(rb[0], 3 * i, axis=1) for i in range(n_devices)])
    D1, D2 = elas_match_batch_multichip(lbe, rbe, devices=devs)
    if D1.shape != (n_devices, H, W):
        raise AssertionError("ELAS replicas: wrong output shape")
    D1s, D2s = elas_match_batch(lbe, rbe, device=dev)
    np.testing.assert_array_equal(D1, D1s)
    np.testing.assert_array_equal(D2, D2s)
