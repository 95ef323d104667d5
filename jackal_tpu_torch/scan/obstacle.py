"""Obstacle laser scan and point-cloud export.

  - obstacle_scan_from_disparity == publishObstacleScan(Mat&, seq)
    (point_cloud.cpp:213-296): per pixel the valid-range check, Q
    reprojection, camera->robot transform, polar binning and a per-bin
    minimum range;
  - point_cloud_from_disparity == publishPointCloud (298-404): every pixel
    with d >= 2 as a robot-frame point with a packed-RGB channel, and
    obstacle_scan_from_points == publishObstacleScan(vector<Point3d>, seq)
    (149-211): the scan of those points with scan-time ground rejection.

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
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import REF_PI, GroundPlaneParams, ScanParams
from ..geometry.reproject import reproject_disparity_to_robot

INF = 1e9  # const int INF = 1e9 (point_cloud.cpp:55)


@dataclasses.dataclass
class ScanResult:
    """LaserScan payload as tensors on the device (the host formats the
    message)."""

    scan: torch.Tensor        # [..., bin_size] min range per bin, INF if empty
    angle_min: torch.Tensor   # [...] radians (400 / -400 if no point)
    angle_max: torch.Tensor
    range_min: torch.Tensor
    range_max: torch.Tensor


def _bin_and_reduce(Xr, Yr, accept, sp: ScanParams) -> ScanResult:
    """Polar binning + per-bin minimum range over the accepted points of
    [..., N] point sets; each set of a leading batch axis is scanned on its
    own, giving [B, bins] and [B]."""
    theta = torch.atan2(Yr, Xr)
    theta_deg = theta * (180.0 / REF_PI)
    r = torch.sqrt(Xr * Xr + Yr * Yr)
    k = torch.floor(sp.bin_size * (sp.fov_deg / 2.0 - theta_deg)
                    / sp.fov_deg).to(torch.int64)
    use = accept & (k >= 0) & (k < sp.bin_size)
    batch = accept.shape[:-1]
    nb = int(np.prod(batch, dtype=np.int64))
    frame = torch.arange(nb, device=r.device).reshape(*batch, 1)
    slot = (frame * sp.bin_size + k).expand(accept.shape)
    scan = torch.full((nb * sp.bin_size,), INF, dtype=r.dtype,
                      device=r.device)
    scan = scan.scatter_reduce(0, slot[use], r[use], "amin")

    def over_set(x, fill, fn):
        return fn(torch.where(accept, x, fill), dim=-1).values

    return ScanResult(
        scan.reshape(*batch, sp.bin_size),
        over_set(theta, 400.0, torch.min),
        over_set(theta, -400.0, torch.max),
        over_set(r, INF, torch.min),
        over_set(r, -500.0, torch.max))


def fma_f32(a, x: torch.Tensor, c) -> torch.Tensor:
    """f32(a * x + c) with one rounding, the same on every device (a fused
    multiply-add; neither torch.addcmul nor a compiler's contraction
    promises one). x is a float32 tensor; a and c are float32 tensors or
    Python floats that hold float32 values. The product of two float32
    values is exact in float64; the float64 sum is made round-to-odd (the
    TwoSum error says whether it was inexact, and an inexact sum with an
    even last bit moves one ulp toward the error), and a round-to-odd
    value with 53 >= 24 + 2 bits rounds to float32 as the exact value
    does."""
    p = x.double() * a
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, err * float("inf")), s)
    return s.float()


def _ground_mask(Xr, Zr, gp: GroundPlaneParams) -> torch.Tensor:
    """Points under the ground plane's height threshold, which rises at
    angle_thresh beyond dist_thresh (point_cloud.cpp:160-170). As the
    reference package ships it (under jit, whose compiler fuses the
    threshold's product and sum): the tangent taken in float32 and
    height + tan * (Xr - dist) rounded once (fma_f32)."""
    f32 = torch.float32
    tan = torch.tan(torch.tensor(gp.angle_thresh, dtype=f32)).item()
    height = torch.tensor(gp.height_thresh, dtype=f32).item()
    rising = fma_f32(tan, Xr - gp.dist_thresh, height)
    thresh = torch.where(Xr < gp.dist_thresh, height, rising)
    return Zr < thresh


def obstacle_scan_from_disparity(
    dmap_u8: torch.Tensor, valid_disp: torch.Tensor, Q: torch.Tensor,
    XR: torch.Tensor, XT: torch.Tensor, sp: ScanParams = ScanParams(),
    crop_offset_x: int = 0, crop_offset_y: int = 0,
) -> ScanResult:
    """Scan from a uint8 [..., H, W] disparity map (one frame, or a batch
    whose frames are scanned each as on its own) with the valid-range cache
    valid_disp [H, W, 2] uint8 (dmin, dmax): accept iff dmin <= d <= dmax;
    no ground-plane re-check."""
    d = dmap_u8.to(torch.int32)
    accept = ((d >= valid_disp[..., 0].to(torch.int32))
              & (d <= valid_disp[..., 1].to(torch.int32)))
    Xr, Yr, _ = reproject_disparity_to_robot(
        dmap_u8, Q, XR, XT, crop_offset_x, crop_offset_y)
    return _bin_and_reduce(Xr.flatten(-2), Yr.flatten(-2),
                           accept.flatten(-2), sp)


def obstacle_scan_from_points(
    pts_robot: torch.Tensor, point_valid: torch.Tensor,
    sp: ScanParams = ScanParams(),
    gp: GroundPlaneParams = GroundPlaneParams(),
) -> ScanResult:
    """Scan of robot-frame points [..., N, 3] with the mask point_valid
    [..., N] (a fixed shape standing in for the reference's vector),
    rejecting the ground at scan time; each set of a batch on its own."""
    Xr, Yr, Zr = pts_robot.unbind(-1)
    accept = point_valid & ~_ground_mask(Xr, Zr, gp)
    return _bin_and_reduce(Xr, Yr, accept, sp)


def point_cloud_from_disparity(
    dmap_u8: torch.Tensor, color_bgr: Optional[torch.Tensor],
    Q: torch.Tensor, XR: torch.Tensor, XT: torch.Tensor,
    sp: ScanParams = ScanParams(), crop_offset_x: int = 0,
    crop_offset_y: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full cloud of uint8 disparity maps [..., H, W]: (points [..., H*W,
    3] in the robot frame, rgb [..., H*W] float32 whose bits are the int32
    r<<16 | g<<8 | b, valid [..., H*W] where d >= min_pcl_disp). color_bgr
    [..., H, W, 3] uint8 in OpenCV's channel order, or None for zero
    colours: the reference's last assignment gives every point the image's
    colour (point_cloud.cpp:379-382). Fixed shape; compact_cloud_msg keeps
    the valid points."""
    valid = (dmap_u8.to(torch.int32) >= sp.min_pcl_disp).flatten(-2)
    Xr, Yr, Zr = reproject_disparity_to_robot(
        dmap_u8, Q, XR, XT, crop_offset_x, crop_offset_y)
    pts = torch.stack([Xr, Yr, Zr], -1).flatten(-3, -2)
    if color_bgr is None:
        rgb = torch.zeros(dmap_u8.shape, dtype=torch.int32,
                          device=dmap_u8.device)
    else:
        b, g, r = color_bgr.to(torch.int32).unbind(-1)
        rgb = (r << 16) | (g << 8) | b
    return pts, rgb.view(torch.float32).flatten(-2), valid


def format_laser_scan_ranges(scan) -> np.ndarray:
    """Compact bins to the published LaserScan.ranges array: bin 89 down
    to 0, skipping bins still at INF (point_cloud.cpp:278-282)."""
    scan = torch.as_tensor(scan).cpu().numpy()
    out = [scan[i] for i in range(len(scan) - 1, -1, -1) if scan[i] < INF - 1]
    return np.asarray(out, dtype=np.float64)


def compact_cloud_msg(header, cloud):
    """The published PointCloud of one frame's fixed-shape cloud (points
    [N, 3], rgb [N], valid [N], tensors or arrays): the valid points as
    float32 [n, 3] and their rgb channel (point_cloud.cpp:312-388)."""
    from ..io_bus.messages import ChannelFloat32, PointCloud

    pts, rgb_f, valid = (torch.as_tensor(x).cpu().numpy() for x in cloud)
    v = valid.reshape(-1)
    return PointCloud(header, pts.reshape(-1, 3)[v].astype(np.float32),
                      [ChannelFloat32("rgb", rgb_f.reshape(-1)[v]
                                      .astype(np.float32))])
