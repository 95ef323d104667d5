"""Obstacle laser scan from the u8 disparity map.

Equivalent of publishObstacleScan(Mat&, seq) (point_cloud.cpp:213-296):
per pixel the valid-range check, Q reprojection, camera->robot transform,
polar binning and a per-bin minimum range.

Scan conventions preserved from the reference:
  - bin k = floor(bin_size * (fov/2 - theta_deg) / fov), theta_deg uses
    pi = 3.1415 (point_cloud.cpp:256,264);
  - LaserScan.ranges is emitted from bin 89 down to 0, skipping empty bins
    (278-282);
  - angle_min/max and range_min/max are the extrema over accepted points.
Bins outside [0, bin_size) are dropped (the reference writes scan[90]
when theta == -fov/2 exactly, past its buffer).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import REF_PI, ScanParams
from ..geometry.reproject import reproject_disparity_to_robot

INF = 1e9  # const int INF = 1e9 (point_cloud.cpp:55)


@dataclasses.dataclass
class ScanResult:
    """LaserScan payload as tensors on the device (the host formats the
    message)."""

    scan: torch.Tensor        # [bin_size] min range per bin, INF if empty
    angle_min: torch.Tensor   # [] radians (400 / -400 if no point)
    angle_max: torch.Tensor
    range_min: torch.Tensor
    range_max: torch.Tensor


def _bin_and_reduce(Xr, Yr, accept, sp: ScanParams) -> ScanResult:
    """Polar binning + per-bin minimum range over accepted points."""
    theta = torch.atan2(Yr, Xr)
    theta_deg = theta * (180.0 / REF_PI)
    r = torch.sqrt(Xr * Xr + Yr * Yr)
    k = torch.floor(sp.bin_size * (sp.fov_deg / 2.0 - theta_deg)
                    / sp.fov_deg).to(torch.int64)
    use = accept & (k >= 0) & (k < sp.bin_size)
    scan = torch.full((sp.bin_size,), INF, dtype=r.dtype, device=r.device)
    scan = scan.scatter_reduce(0, k[use], r[use], "amin")
    return ScanResult(
        scan,
        torch.where(accept, theta, 400.0).min(),
        torch.where(accept, theta, -400.0).max(),
        torch.where(accept, r, INF).min(),
        torch.where(accept, r, -500.0).max())


def obstacle_scan_from_disparity(
    dmap_u8: torch.Tensor, valid_disp: torch.Tensor, Q: torch.Tensor,
    XR: torch.Tensor, XT: torch.Tensor, sp: ScanParams = ScanParams(),
    crop_offset_x: int = 0, crop_offset_y: int = 0,
) -> ScanResult:
    """Scan from a uint8 [H, W] disparity map with the valid-range cache
    valid_disp [H, W, 2] uint8 (dmin, dmax): accept iff
    dmin <= d <= dmax; no ground-plane re-check."""
    d = dmap_u8.to(torch.int32)
    accept = ((d >= valid_disp[..., 0].to(torch.int32))
              & (d <= valid_disp[..., 1].to(torch.int32)))
    Xr, Yr, _ = reproject_disparity_to_robot(
        dmap_u8, Q, XR, XT, crop_offset_x, crop_offset_y)
    return _bin_and_reduce(Xr, Yr, accept, sp)


def format_laser_scan_ranges(scan) -> np.ndarray:
    """Compact bins to the published LaserScan.ranges array: bin 89 down
    to 0, skipping bins still at INF (point_cloud.cpp:278-282)."""
    scan = torch.as_tensor(scan).cpu().numpy()
    out = [scan[i] for i in range(len(scan) - 1, -1, -1) if scan[i] < INF - 1]
    return np.asarray(out, dtype=np.float64)
