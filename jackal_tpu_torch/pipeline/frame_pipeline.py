"""The point_cloud node: rectify -> ELAS -> scan, per frame or per batch.

Equivalent of point_cloud.cpp:431-471 + 213-296: one startup precompute
(rectification maps and the valid-disparity cache, point_cloud.cpp:543-558)
and a per-frame function, process_frame, whose ELAS host prior and speckle
filter run in C++. process_batch is the node's --batch > 1 step: the
batched ELAS path (matching/elas/pipeline.elas_match_batch_device), which
keeps only pruning and triangulation on the host.

Per-stage wall-clock times mirror the -l/-d/-s hooks (point_cloud.cpp:
446-462); with ``timing=True`` each stage ends in a device synchronize.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..calib import StereoCalibration
from ..config import ElasParams, GroundPlaneParams, PipelineParams, ScanParams
from ..device import DeviceLike, resolve_device
from ..geometry.rectify import init_undistort_rectify_map, stereo_rectify
from ..geometry.remap import remap_bilinear
from ..matching.elas.pipeline import elas_match, elas_match_batch_device
from ..scan.obstacle import ScanResult, obstacle_scan_from_disparity
from ..scan.valid_disp import cache_disparity_values


@dataclasses.dataclass
class FrameResult:
    dmap: np.ndarray                 # [H, W] uint8 disparity (mono8 topic)
    scan: ScanResult                 # obstacle scan payload
    dmap_time: float = 0.0
    scan_time: float = 0.0
    rect_time: float = 0.0


class StereoPipeline:
    """Owns the calibration-derived constants on the device."""

    def __init__(
        self,
        calib: StereoCalibration,
        params: PipelineParams = PipelineParams(),
        engine: str = "elas",
        elas_params: ElasParams = ElasParams(),
        gp_params: GroundPlaneParams = GroundPlaneParams(),
        scan_params: ScanParams = ScanParams(),
        device: DeviceLike = None,
    ):
        if engine in ("bm", "sgm"):
            raise NotImplementedError(
                f"engine={engine!r} waits for a later slice of the port "
                f"(ROADMAP Queue 1, items 2-3); use engine='elas'")
        if engine != "elas":
            raise ValueError(f"unknown engine {engine!r}")
        if params.gen_pcl:
            raise NotImplementedError(
                "gen_pcl waits for a later slice of the port "
                "(ROADMAP Queue 1, item 4)")
        self.device = dev = resolve_device(device)
        self.engine = engine
        self.calib = calib
        self.p = params
        self.elas_params = elas_params
        self.sp = scan_params

        size = (params.im_width, params.im_height)
        rect = stereo_rectify(
            calib.K1, calib.D1, calib.K2, calib.D2, params.calib_im_size,
            calib.R, calib.T, zero_disparity=True, alpha=0.0,
            new_image_size=size)
        self.rect = rect

        def maps(K, D, R, P):
            mx, my = init_undistort_rectify_map(K, D, R, P, size)
            return (torch.from_numpy(mx).to(dev), torch.from_numpy(my).to(dev))

        self.lmap = maps(calib.K1, calib.D1, rect.R1, rect.P1)
        self.rmap = maps(calib.K2, calib.D2, rect.R2, rect.P2)
        XR = calib.XR if calib.XR is not None else np.eye(3)
        XT = calib.XT if calib.XT is not None else np.zeros(3)
        f32 = torch.float32
        self.Q32 = torch.as_tensor(rect.Q, dtype=f32).to(dev)
        self.XR32 = torch.as_tensor(XR, dtype=f32).to(dev)
        self.XT32 = torch.as_tensor(XT, dtype=f32).to(dev)
        self.valid_disp = torch.from_numpy(cache_disparity_values(
            rect.Q, XR, XT, params.crop_im_width, params.crop_im_height,
            params.crop_offset_x, params.crop_offset_y, gp_params,
            scan_params)).to(dev)

    def _rectify_crop(self, left_raw: torch.Tensor, right_raw: torch.Tensor):
        """Rectify and crop uint8 [..., H, W] raw frames on the device."""
        p = self.p
        left = remap_bilinear(left_raw, *self.lmap)
        right = remap_bilinear(right_raw, *self.rmap)
        sl = (Ellipsis,
              slice(p.crop_offset_y, p.crop_offset_y + p.crop_im_height),
              slice(p.crop_offset_x, p.crop_offset_x + p.crop_im_width))
        return left[sl], right[sl]

    @staticmethod
    def _dmap_u8(D1: torch.Tensor) -> torch.Tensor:
        """The published mono8 disparity: round, clip to [0, 255]."""
        return torch.clamp(torch.round(D1), 0, 255).to(torch.uint8)

    def _scan_stage(self, dmap_u8: torch.Tensor) -> ScanResult:
        return obstacle_scan_from_disparity(
            dmap_u8, self.valid_disp, self.Q32, self.XR32, self.XT32,
            self.sp, self.p.crop_offset_x, self.p.crop_offset_y)

    def _sync(self, timing: bool) -> float:
        if timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def process_frame(
        self, left_raw: np.ndarray, right_raw: np.ndarray,
        timing: bool = False,
    ) -> FrameResult:
        """One raw uint8 stereo pair [H, W] -> u8 disparity map + scan."""
        dev = self.device
        tr = self._sync(timing)
        left, right = self._rectify_crop(torch.as_tensor(left_raw).to(dev),
                                         torch.as_tensor(right_raw).to(dev))
        t0 = self._sync(timing)
        D1, _ = elas_match(left, right, self.elas_params, device=dev)
        dmap_t = self._dmap_u8(D1)
        dmap = dmap_t.cpu().numpy()
        t1 = time.perf_counter()
        scan = self._scan_stage(dmap_t)
        t2 = self._sync(timing)
        return FrameResult(dmap=dmap, scan=scan, dmap_time=t1 - t0,
                           scan_time=t2 - t1, rect_time=t0 - tr)

    def process_batch(self, left_raw_b, right_raw_b):
        """Raw uint8 [B, H, W] stereo batches -> (u8 disparity maps
        [B, h, w] and a ScanResult of [B, bins] / [B] tensors), both on the
        device; each frame equal to process_frame's. ELAS runs batched in
        chunks of the largest of 1, 2, 4, 8 that divides B."""
        dev = self.device
        left_b, right_b = self._rectify_crop(
            torch.as_tensor(left_raw_b).to(dev),
            torch.as_tensor(right_raw_b).to(dev))
        B = left_b.shape[0]
        chunk = max(c for c in (1, 2, 4, 8) if B % c == 0 and c <= B)
        D1, _ = elas_match_batch_device(left_b, right_b, self.elas_params,
                                        chunk=chunk, device=dev)
        dmaps = self._dmap_u8(D1)
        return dmaps, self._scan_stage(dmaps)

    def process_batch_fused(self, left_raw_b, right_raw_b):
        raise NotImplementedError(
            "the fused batch step is the BM/SGM engines' and waits for "
            "their slice of the port (ROADMAP Queue 1, items 2-3)")

    def process_batch_pcl(self, left_raw_b, right_raw_b, color_bgr_b=None):
        raise NotImplementedError(
            "gen_pcl waits for a later slice of the port "
            "(ROADMAP Queue 1, item 4)")

    process_batch_fused_pcl = process_batch_pcl
