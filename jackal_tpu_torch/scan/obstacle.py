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
    pi = 3.1415 (point_cloud.cpp:256,264), computed as the reference
    package computes it under jit (_bin_index);
  - LaserScan.ranges is emitted from bin 89 down to 0, skipping empty bins
    (278-282);
  - angle_min/max and range_min/max are the extrema over accepted points.
Bins outside [0, bin_size) are dropped (the reference writes scan[90]
when theta == -fov/2 exactly, past its buffer). A NaN point lands in bin
0 (its index converts as XLA converts, NaN -> 0) and makes that bin NaN,
as NaN makes every minimum and maximum it enters NaN.

The three public functions are wrappers: on CUDA tensors they launch
kernels P1 (scan from a disparity map), P2 (the cloud) and P3 (scan from
points) of csrc/scan_kernel.cu, on CPU tensors they run the plain
versions (``*_plain``), which the kernels equal bit for bit. P1 and P3
are one launch each after one fill of their int32 scratch; P2 is one
launch. None of them reads anything back to the host. ``launches``
counts the calls that launched each kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import REF_PI, GroundPlaneParams, ScanParams
from ..geometry.reproject import reproject_disparity_to_robot
from ..ops import cuda_lib
from ..ops.convert import to_int32

INF = 1e9  # const int INF = 1e9 (point_cloud.cpp:55)

launches = {"scan": 0, "cloud": 0, "scan_points": 0}


@dataclasses.dataclass
class ScanResult:
    """LaserScan payload as tensors on the device (the host formats the
    message)."""

    scan: torch.Tensor        # [..., bin_size] min range per bin, INF if empty
    angle_min: torch.Tensor   # [...] radians (400 / -400 if no point)
    angle_max: torch.Tensor
    range_min: torch.Tensor
    range_max: torch.Tensor


def _bin_constants(sp: ScanParams) -> Tuple[float, float, float]:
    """(180 / REF_PI, fov / 2, bins / fov) as the float32 values the jitted
    reference computes with. XLA folds bin_size * (fov/2 - theta_deg) /
    fov into (fov/2 - theta_deg) * (bin_size * (1 / fov)), the constant
    folded in float32 (1.0 at the presets, where the product drops out)."""
    f32 = np.float32
    ratio = f32(sp.bin_size) * (f32(1.0) / f32(sp.fov_deg))
    return (float(f32(180.0 / REF_PI)), float(f32(sp.fov_deg / 2.0)),
            float(ratio))


def _bin_index(theta: torch.Tensor, sp: ScanParams) -> torch.Tensor:
    """int32 bin of each angle: floor((fov/2 - theta * 180/REF_PI) *
    ratio) with fov/2 - theta * 180/REF_PI rounded once, as XLA:CPU
    contracts it into a fused multiply-add, and converted as XLA converts
    (to_int32: NaN -> 0, saturating)."""
    deg, half, ratio = _bin_constants(sp)
    return to_int32(torch.floor(fma_f32(-deg, theta, half) * ratio))


def _bin_and_reduce(Xr, Yr, accept, sp: ScanParams) -> ScanResult:
    """Polar binning + per-bin minimum range over the accepted points of
    [..., N] point sets; each set of a leading batch axis is scanned on its
    own, giving [B, bins] and [B]. Unused points go to a dump slot past
    the bins, so nothing is read back to the host; scatter_reduce's
    minimum carries a NaN range into its bin on the CPU and on the card
    (chip_smoke.scan_probes)."""
    theta = torch.atan2(Yr, Xr)
    r = torch.sqrt(Xr * Xr + Yr * Yr)
    k = _bin_index(theta, sp)
    use = accept & (k >= 0) & (k < sp.bin_size)
    batch = accept.shape[:-1]
    nb = int(np.prod(batch, dtype=np.int64))
    dump = nb * sp.bin_size
    frame = torch.arange(nb, device=r.device).reshape(*batch, 1)
    slot = torch.where(use, frame * sp.bin_size + k, dump)
    scan = torch.full((dump + 1,), INF, dtype=r.dtype, device=r.device)
    scan = scan.scatter_reduce(0, slot.reshape(-1), r.reshape(-1),
                               "amin")[:dump]

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
    does. An infinite or NaN sum is the result as it is (its TwoSum error
    is NaN)."""
    p = x.double() * a
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, err * float("inf")), s)
    return s.float()


def _ground_constants(gp: GroundPlaneParams) -> Tuple[float, float, float]:
    """(tan(angle_thresh), height_thresh, dist_thresh) as float32 values:
    the tangent taken in float32, as the reference package's is."""
    f32 = torch.float32
    tan = torch.tan(torch.tensor(gp.angle_thresh, dtype=f32)).item()
    height = torch.tensor(gp.height_thresh, dtype=f32).item()
    return tan, height, float(np.float32(gp.dist_thresh))


def _ground_mask(Xr, Zr, gp: GroundPlaneParams) -> torch.Tensor:
    """Points under the ground plane's height threshold, which rises at
    angle_thresh beyond dist_thresh (point_cloud.cpp:160-170). As the
    reference package ships it (under jit, whose compiler fuses the
    threshold's product and sum): the tangent taken in float32 and
    height + tan * (Xr - dist) rounded once (fma_f32)."""
    tan, height, dist = _ground_constants(gp)
    rising = fma_f32(tan, Xr - dist, height)
    thresh = torch.where(Xr < dist, height, rising)
    return Zr < thresh


def obstacle_scan_from_disparity_plain(
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


def obstacle_scan_from_points_plain(
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


def point_cloud_from_disparity_plain(
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


# ---- kernels P1-P3 (csrc/scan_kernel.cu) -------------------------------

# the most bins kernels P1 and P3 keep in shared memory (csrc/scan_kernel.cu
# kMaxBins)
_MAX_BINS = 4096
_EXTREMA = 4     # angle_min, angle_max, range_min, range_max


def _calib(t, shape, dev) -> torch.Tensor:
    """A calibration constant as a contiguous float32 tensor on dev (no
    copy where it already is one)."""
    t = torch.as_tensor(t).to(device=dev, dtype=torch.float32).contiguous()
    if tuple(t.shape) != shape:
        raise ValueError(f"expected a calibration constant of shape {shape},"
                         f" got {tuple(t.shape)}")
    return t


def _check_sizes(kernel: str, B: int, N: int) -> None:
    if N == 0 or B * N >= 2 ** 31 or B >= 65536:
        raise ValueError(f"kernel {kernel} takes 1 to 65535 sets of 1 to "
                         f"2^31 points in all, got {B} sets of {N}")


def _scan_outputs(sp: ScanParams, B: int, dev):
    """(float32 output buffer [B * (bins + 4)] whose slices are the
    ScanResult, zeroed int32 scratch [B * (bins + 4) + B]: the sets'
    reduction keys and block counters; the one fill of a call)."""
    if not 1 <= sp.bin_size <= _MAX_BINS:
        raise ValueError(f"the scan kernels take 1 to {_MAX_BINS} bins, got "
                         f"{sp.bin_size}")
    out = torch.empty(B * (sp.bin_size + _EXTREMA), dtype=torch.float32,
                      device=dev)
    scratch = torch.zeros(B * (sp.bin_size + _EXTREMA) + B,
                          dtype=torch.int32, device=dev)
    return out, scratch


def _scan_result(out: torch.Tensor, lead, sp: ScanParams, B: int
                 ) -> ScanResult:
    nb = B * sp.bin_size
    ext = [out[nb + i * B:nb + (i + 1) * B].reshape(lead)
           for i in range(_EXTREMA)]
    return ScanResult(out[:nb].reshape(*lead, sp.bin_size), *ext)


def _entry(name: str, argtypes):
    fn = getattr(cuda_lib.load("scan_kernel"), name)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _scan_cuda(dmap_u8, valid_disp, Q, XR, XT, sp, ox, oy) -> ScanResult:
    """Kernel P1: one fill of its scratch, one launch."""
    dev = dmap_u8.device
    if dmap_u8.dtype != torch.uint8 or dmap_u8.dim() < 2:
        raise ValueError(f"kernel P1 takes uint8 [..., H, W] maps, got "
                         f"{dmap_u8.dtype} {tuple(dmap_u8.shape)}")
    lead, (H, W) = dmap_u8.shape[:-2], dmap_u8.shape[-2:]
    B = math.prod(lead)
    _check_sizes("P1", B, H * W)
    if valid_disp.dtype != torch.uint8 or valid_disp.device != dev \
            or tuple(valid_disp.shape) != (H, W, 2):
        raise ValueError(f"kernel P1: expected a uint8 ({H}, {W}, 2) valid "
                         f"range cache on {dev}, got {valid_disp.dtype} "
                         f"{tuple(valid_disp.shape)} on {valid_disp.device}")
    dm, vd = dmap_u8.contiguous(), valid_disp.contiguous()
    q, xr, xt = (_calib(Q, (4, 4), dev), _calib(XR, (3, 3), dev),
                 _calib(XT, (3,), dev))
    out, scratch = _scan_outputs(sp, B, dev)
    deg, half, ratio = _bin_constants(sp)
    fn = _entry("scan_from_disparity", [_P] * 7 + [_I] * 6 + [_F] * 3)
    cuda_lib.launch(fn, "scan", dm, dm.data_ptr(), vd.data_ptr(),
                    q.data_ptr(), xr.data_ptr(), xt.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), B, H, W, ox, oy,
                    sp.bin_size, deg, half, ratio)
    launches["scan"] += 1
    return _scan_result(out, lead, sp, B)


def _scan_points_cuda(pts, valid, sp, gp) -> ScanResult:
    """Kernel P3: one fill of its scratch, one launch."""
    dev = pts.device
    if pts.dtype != torch.float32 or pts.dim() < 2 or pts.shape[-1] != 3:
        raise ValueError(f"kernel P3 takes float32 [..., N, 3] points, got "
                         f"{pts.dtype} {tuple(pts.shape)}")
    lead, N = pts.shape[:-2], pts.shape[-2]
    if valid.dtype != torch.bool or valid.device != dev \
            or tuple(valid.shape) != tuple(pts.shape[:-1]):
        raise ValueError(f"kernel P3: expected a bool {tuple(pts.shape[:-1])}"
                         f" mask on {dev}, got {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    B = math.prod(lead)
    _check_sizes("P3", B, N)
    p, v = pts.contiguous(), valid.contiguous()
    out, scratch = _scan_outputs(sp, B, dev)
    deg, half, ratio = _bin_constants(sp)
    tan, height, dist = _ground_constants(gp)
    fn = _entry("scan_from_points", [_P] * 4 + [_I] * 3 + [_F] * 6)
    cuda_lib.launch(fn, "scan_points", p, p.data_ptr(), v.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), B, N, sp.bin_size,
                    deg, half, ratio, tan, height, dist)
    launches["scan_points"] += 1
    return _scan_result(out, lead, sp, B)


def _cloud_cuda(dmap_u8, color_bgr, Q, XR, XT, sp, ox, oy):
    """Kernel P2: one launch, no fill (it writes every output). The colour
    frames are read through their strides (the node's rectified colour is
    a channel-planar view)."""
    dev = dmap_u8.device
    if dmap_u8.dtype != torch.uint8 or dmap_u8.dim() < 2:
        raise ValueError(f"kernel P2 takes uint8 [..., H, W] maps, got "
                         f"{dmap_u8.dtype} {tuple(dmap_u8.shape)}")
    lead, (H, W) = dmap_u8.shape[:-2], dmap_u8.shape[-2:]
    B = math.prod(lead)
    _check_sizes("P2", B, H * W)
    dm = dmap_u8.contiguous()
    strides = [0, 0, 0, 0]
    col = None
    if color_bgr is not None:
        if color_bgr.dtype != torch.uint8 or color_bgr.device != dev \
                or tuple(color_bgr.shape) != (*lead, H, W, 3):
            raise ValueError(f"kernel P2: expected uint8 colour frames "
                             f"{(*lead, H, W, 3)} on {dev}, got "
                             f"{color_bgr.dtype} {tuple(color_bgr.shape)} "
                             f"on {color_bgr.device}")
        col = color_bgr.reshape(B, H, W, 3)
        strides = list(col.stride())
    q, xr, xt = (_calib(Q, (4, 4), dev), _calib(XR, (3, 3), dev),
                 _calib(XT, (3,), dev))
    pts = torch.empty((*lead, H * W, 3), dtype=torch.float32, device=dev)
    rgb = torch.empty((*lead, H * W), dtype=torch.float32, device=dev)
    valid = torch.empty((*lead, H * W), dtype=torch.bool, device=dev)
    fn = _entry("point_cloud", [_P] * 8 + [ctypes.c_longlong] * 4
                + [_I] * 6)
    cuda_lib.launch(fn, "cloud", dm, dm.data_ptr(),
                    None if col is None else col.data_ptr(), q.data_ptr(),
                    xr.data_ptr(), xt.data_ptr(), pts.data_ptr(),
                    rgb.data_ptr(), valid.data_ptr(), *strides, B, H, W, ox,
                    oy, sp.min_pcl_disp)
    launches["cloud"] += 1
    return pts, rgb, valid


def obstacle_scan_from_disparity(
    dmap_u8: torch.Tensor, valid_disp: torch.Tensor, Q: torch.Tensor,
    XR: torch.Tensor, XT: torch.Tensor, sp: ScanParams = ScanParams(),
    crop_offset_x: int = 0, crop_offset_y: int = 0,
) -> ScanResult:
    """obstacle_scan_from_disparity_plain's contract: kernel P1 on a CUDA
    map, the plain version on a CPU one."""
    if dmap_u8.is_cuda:
        return _scan_cuda(dmap_u8, valid_disp, Q, XR, XT, sp,
                          crop_offset_x, crop_offset_y)
    return obstacle_scan_from_disparity_plain(
        dmap_u8, valid_disp, Q, XR, XT, sp, crop_offset_x, crop_offset_y)


def obstacle_scan_from_points(
    pts_robot: torch.Tensor, point_valid: torch.Tensor,
    sp: ScanParams = ScanParams(),
    gp: GroundPlaneParams = GroundPlaneParams(),
) -> ScanResult:
    """obstacle_scan_from_points_plain's contract: kernel P3 on CUDA
    points, the plain version on CPU ones."""
    if pts_robot.is_cuda:
        return _scan_points_cuda(pts_robot, point_valid, sp, gp)
    return obstacle_scan_from_points_plain(pts_robot, point_valid, sp, gp)


def point_cloud_from_disparity(
    dmap_u8: torch.Tensor, color_bgr: Optional[torch.Tensor],
    Q: torch.Tensor, XR: torch.Tensor, XT: torch.Tensor,
    sp: ScanParams = ScanParams(), crop_offset_x: int = 0,
    crop_offset_y: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """point_cloud_from_disparity_plain's contract: kernel P2 on a CUDA
    map, the plain version on a CPU one."""
    if dmap_u8.is_cuda:
        return _cloud_cuda(dmap_u8, color_bgr, Q, XR, XT, sp, crop_offset_x,
                           crop_offset_y)
    return point_cloud_from_disparity_plain(
        dmap_u8, color_bgr, Q, XR, XT, sp, crop_offset_x, crop_offset_y)


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
