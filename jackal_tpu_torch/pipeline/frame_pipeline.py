"""The point_cloud node: rectify -> disparity -> [cloud ->] scan, per frame
or batch.

Equivalent of point_cloud.cpp:431-471 + 213-404: one startup precompute
(rectification maps and the valid-disparity cache, point_cloud.cpp:543-558)
and a per-frame function, process_frame. Three engines:

  - "elas": process_frame's ELAS host prior and speckle filter run in C++;
    process_batch, the node's --batch > 1 step, is the batched ELAS path
    (matching/elas/pipeline.elas_match_batch_device), which keeps only
    pruning and triangulation on the host;
  - "sgm": every stage on the device (matching/sgm.sgm_match_batch,
    kernels D, E, F); process_frame runs it on a batch of one, and
    process_batch is process_batch_fused, rectify -> SGM -> scan on the
    whole batch;
  - "bm": the same on block matching (kernel G, then the texture gate).

With PipelineParams(gen_pcl=True) the node exports the point cloud (every
pixel with d >= 2 as a robot-frame point with its packed colour) and builds
the scan from its points with ground rejection: process_frame with a
colour frame, process_batch_fused_pcl (BM, SGM) and process_batch_pcl
(every engine).

Per-stage wall-clock times mirror the -l/-d/-s hooks (point_cloud.cpp:
446-462); with ``timing=True`` each stage ends in a device synchronize.
update_extrinsics is the live camera->robot recalibration of -m.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..calib import StereoCalibration
from ..config import (BMParams, ElasParams, GroundPlaneParams,
                      PipelineParams, ScanParams, SGMParams)
from ..device import DeviceLike, resolve_device
from ..geometry.rectify import init_undistort_rectify_map, stereo_rectify
from ..geometry.remap import remap_bilinear
from ..geometry.reproject import (compose_rotation_cam_to_robot,
                                  compose_translation_cam_to_robot)
from ..matching.bm import bm_texture_gate
from ..matching.elas.pipeline import elas_match, elas_match_batch_device
from ..matching.sgm import sgm_match_batch
from ..ops.bm_kernel import bm_match_fused
from ..scan.obstacle import (ScanResult, obstacle_scan_from_disparity,
                             obstacle_scan_from_points,
                             point_cloud_from_disparity)
from ..scan.valid_disp import cache_disparity_values


@dataclasses.dataclass
class FrameResult:
    dmap: np.ndarray                 # [H, W] uint8 disparity (mono8 topic)
    scan: ScanResult                 # obstacle scan payload
    dmap_time: float = 0.0
    scan_time: float = 0.0
    rect_time: float = 0.0
    cloud: Optional[Tuple] = None    # (points, rgb, valid) if gen_pcl
    pcl_time: float = 0.0


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
        sgm_params: SGMParams = SGMParams(),
        device: DeviceLike = None,
        bm_params: BMParams = BMParams(),
    ):
        if engine not in ("elas", "sgm", "bm"):
            raise ValueError(f"unknown engine {engine!r}")
        self.device = dev = resolve_device(device)
        self.engine = engine
        self.calib = calib
        self.p = params
        self.elas_params = elas_params
        self.sgm_params = sgm_params
        self.bm_params = bm_params
        self.gp = gp_params
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
        self.Q32 = torch.as_tensor(rect.Q, dtype=torch.float32).to(dev)
        self._set_extrinsics(
            calib.XR if calib.XR is not None else np.eye(3),
            calib.XT if calib.XT is not None else np.zeros(3))

    def _set_extrinsics(self, XR: np.ndarray, XT: np.ndarray) -> None:
        """The camera->robot transform on the device and the
        valid-disparity cache built from it (point_cloud.cpp:543-558)."""
        p, dev, f32 = self.p, self.device, torch.float32
        self.XR32 = torch.as_tensor(XR, dtype=f32).to(dev)
        self.XT32 = torch.as_tensor(XT, dtype=f32).to(dev)
        self.valid_disp = torch.from_numpy(cache_disparity_values(
            self.rect.Q, XR, XT, p.crop_im_width, p.crop_im_height,
            p.crop_offset_x, p.crop_offset_y, self.gp, self.sp)).to(dev)

    def update_extrinsics(self, phi_xyz, trans_xyz) -> None:
        """Live camera->robot recalibration (-m, the dynamic_reconfigure
        sliders PHI_* and TRANS_*, point_cloud.cpp:305-311, 492-495):
        recompose XR and XT and rebuild the valid-disparity cache. The
        stages read these attributes at call time, so the next frame or
        batch of every path uses them."""
        self._set_extrinsics(compose_rotation_cam_to_robot(*phi_xyz),
                             compose_translation_cam_to_robot(*trans_xyz))

    def _rectify_crop(self, left_raw: torch.Tensor, right_raw: torch.Tensor):
        """Rectify and crop uint8 [..., H, W] raw frames on the device."""
        p = self.p
        left = remap_bilinear(left_raw, *self.lmap)
        right = remap_bilinear(right_raw, *self.rmap)
        sl = (Ellipsis,
              slice(p.crop_offset_y, p.crop_offset_y + p.crop_im_height),
              slice(p.crop_offset_x, p.crop_offset_x + p.crop_im_width))
        return left[sl], right[sl]

    def _rectify_crop_color(self, color_raw: torch.Tensor) -> torch.Tensor:
        """Rectify and crop uint8 colour frames [..., H, W, 3] with the left
        maps: the cloud's colour comes from the rectified, cropped left
        image (point_cloud.cpp:440-442, 356-383). The channels ride the
        batch axis of the remap."""
        p = self.p
        rect = remap_bilinear(color_raw.movedim(-1, -3), *self.lmap)
        rect = rect[..., p.crop_offset_y:p.crop_offset_y + p.crop_im_height,
                    p.crop_offset_x:p.crop_offset_x + p.crop_im_width]
        return rect.movedim(-3, -1)

    @staticmethod
    def _dmap_u8(D1: torch.Tensor) -> torch.Tensor:
        """The published mono8 disparity: round, clip to [0, 255]."""
        return torch.clamp(torch.round(D1), 0, 255).to(torch.uint8)

    def _scan_stage(self, dmap_u8: torch.Tensor) -> ScanResult:
        return obstacle_scan_from_disparity(
            dmap_u8, self.valid_disp, self.Q32, self.XR32, self.XT32,
            self.sp, self.p.crop_offset_x, self.p.crop_offset_y)

    def _cloud_stage(self, dmaps: torch.Tensor, color=None):
        """(points, rgb, valid) of u8 maps [..., h, w]; color: raw uint8
        [..., H, W, 3] frames (host or device), or None."""
        col = None if color is None else self._rectify_crop_color(
            torch.as_tensor(color).to(self.device))
        return point_cloud_from_disparity(
            dmaps, col, self.Q32, self.XR32, self.XT32, self.sp,
            self.p.crop_offset_x, self.p.crop_offset_y)

    def _points_scan(self, cloud) -> ScanResult:
        pts, _, valid = cloud
        return obstacle_scan_from_points(pts, valid, self.sp, self.gp)

    def _cloud_scan(self, dmaps: torch.Tensor, color=None):
        """The gen-pcl tail of u8 maps: (cloud, scan from its points)."""
        cloud = self._cloud_stage(dmaps, color)
        return cloud, self._points_scan(cloud)

    def _sync(self, timing: bool) -> float:
        if timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def process_frame(
        self, left_raw: np.ndarray, right_raw: np.ndarray,
        color_bgr: Optional[np.ndarray] = None, timing: bool = False,
    ) -> FrameResult:
        """One raw uint8 stereo pair [H, W] -> u8 disparity map + scan; with
        gen_pcl also the cloud (colours from color_bgr [H, W, 3], or zero)
        and a scan built from its points."""
        dev = self.device
        tr = self._sync(timing)
        left, right = self._rectify_crop(torch.as_tensor(left_raw).to(dev),
                                         torch.as_tensor(right_raw).to(dev))
        t0 = self._sync(timing)
        if self.engine == "elas":
            D1, _ = elas_match(left, right, self.elas_params, device=dev)
            dmap_t = self._dmap_u8(D1)
        else:
            dmap_t = self._match_batch(left[None], right[None])[0]
        dmap = dmap_t.cpu().numpy()
        t1 = tc = time.perf_counter()
        cloud = None
        if self.p.gen_pcl:
            cloud = self._cloud_stage(dmap_t, color_bgr)
            tc = self._sync(timing)
            scan = self._points_scan(cloud)
        else:
            scan = self._scan_stage(dmap_t)
        t2 = self._sync(timing)
        return FrameResult(dmap=dmap, scan=scan, dmap_time=t1 - t0,
                           scan_time=t2 - tc, rect_time=t0 - tr,
                           cloud=cloud, pcl_time=tc - t1)

    def process_batch(self, left_raw_b, right_raw_b):
        """Raw uint8 [B, H, W] stereo batches -> (u8 disparity maps
        [B, h, w] and a ScanResult of [B, bins] / [B] tensors), both on the
        device; each frame equal to process_frame's. SGM and BM run
        process_batch_fused; ELAS runs batched in chunks of the largest of
        1, 2, 4, 8 that divides B."""
        if self.engine != "elas":
            return self.process_batch_fused(left_raw_b, right_raw_b)
        dmaps = self._elas_batch(left_raw_b, right_raw_b)
        return dmaps, self._scan_stage(dmaps)

    def _elas_batch(self, left_raw_b, right_raw_b) -> torch.Tensor:
        """u8 ELAS maps of raw [B, H, W] batches, in chunks of the largest
        of 1, 2, 4, 8 that divides B."""
        dev = self.device
        left_b, right_b = self._rectify_crop(
            torch.as_tensor(left_raw_b).to(dev),
            torch.as_tensor(right_raw_b).to(dev))
        B = left_b.shape[0]
        chunk = max(c for c in (1, 2, 4, 8) if B % c == 0 and c <= B)
        D1, _ = elas_match_batch_device(left_b, right_b, self.elas_params,
                                        chunk=chunk, device=dev)
        return self._dmap_u8(D1)

    def process_batch_fused(self, left_raw_b, right_raw_b,
                            timing: bool = False):
        """The SGM and BM engines' batched step: raw uint8 [B, H, W] stereo
        batches -> (u8 disparity maps, ScanResult of the batch), device
        tensors; rectify, match and scan of the whole batch at once. With
        ``timing``, each stage ends in a device synchronize and a third
        item follows: (dmap_time, scan_time) per frame, in seconds."""
        dmaps, t0, t1 = self._fused_maps(left_raw_b, right_raw_b, timing)
        scans = self._scan_stage(dmaps)
        if not timing:
            return dmaps, scans
        n = dmaps.shape[0]
        return dmaps, scans, ((t1 - t0) / n, (self._sync(True) - t1) / n)

    def _fused_maps(self, left_raw_b, right_raw_b, timing: bool):
        """(u8 maps, time before and after the match) of raw batches."""
        if self.engine == "elas":
            raise ValueError("the fused batch path needs engine='sgm' or "
                             "'bm'")
        dev = self.device
        left_b, right_b = self._rectify_crop(
            torch.as_tensor(left_raw_b).to(dev),
            torch.as_tensor(right_raw_b).to(dev))
        t0 = self._sync(timing)
        dmaps = self._match_batch(left_b, right_b)
        return dmaps, t0, self._sync(timing)

    def _match_batch(self, left_b: torch.Tensor, right_b: torch.Tensor
                     ) -> torch.Tensor:
        """Disparity of rectified uint8 [B, h, w] batches as u8 maps: SGM
        (kernels D, E and F on the card) or BM (kernel G, whose left map
        has had its L/R check, then the texture gate)."""
        if self.engine == "bm":
            dL, _ = bm_match_fused(left_b, right_b, self.bm_params)
            dL = bm_texture_gate(left_b, dL, self.bm_params)
        else:
            dL, _ = sgm_match_batch(left_b, right_b, self.sgm_params,
                                    device=self.device)
        return self._dmap_u8(dL)

    def process_batch_fused_pcl(self, left_raw_b, right_raw_b,
                                color_bgr_b=None, timing: bool = False):
        """The SGM and BM engines' batched gen-pcl step, BASELINE config 5
        on BM: raw uint8 [B, H, W] stereo batches (and colour frames [B, H,
        W, 3] or None) -> (u8 maps, cloud (points [B, h*w, 3], rgb [B,
        h*w], valid [B, h*w]), ScanResult from the points), device
        tensors. With ``timing``, each stage ends in a device synchronize
        and a fourth item follows: (dmap_time, pcl_time, scan_time) per
        frame, in seconds."""
        dmaps, t0, t1 = self._fused_maps(left_raw_b, right_raw_b, timing)
        cloud = self._cloud_stage(dmaps, color_bgr_b)
        t2 = self._sync(timing)
        scans = self._points_scan(cloud)
        if not timing:
            return dmaps, cloud, scans
        n = dmaps.shape[0]
        return dmaps, cloud, scans, ((t1 - t0) / n, (t2 - t1) / n,
                                     (self._sync(True) - t2) / n)

    def process_batch_pcl(self, left_raw_b, right_raw_b, color_bgr_b=None):
        """Every engine's batched gen-pcl step: (u8 maps, cloud, scan from
        the points), device tensors. SGM and BM run
        process_batch_fused_pcl; ELAS its batched path, then the cloud and
        the scan."""
        if self.engine != "elas":
            return self.process_batch_fused_pcl(left_raw_b, right_raw_b,
                                                color_bgr_b)
        dmaps = self._elas_batch(left_raw_b, right_raw_b)
        return (dmaps,) + self._cloud_scan(dmaps, color_bgr_b)
