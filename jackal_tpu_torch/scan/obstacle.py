"""Obstacle laser scan and point-cloud export.

  - obstacle_scan_from_disparity == publishObstacleScan(Mat&, seq)
    (point_cloud.cpp:213-296): per pixel the valid-range check, Q
    reprojection, camera->robot transform, polar binning and a per-bin
    minimum range;
  - point_cloud_from_disparity == publishPointCloud (298-404): every pixel
    with d >= 2 as a robot-frame point with a packed-RGB channel, and
    obstacle_scan_from_points == publishObstacleScan(vector<Point3d>, seq)
    (149-211): the scan of those points with scan-time ground rejection;
    cloud_and_scan_from_disparity is the two in one call (the gen-pcl
    tail).

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

The scan computes what the jitted reference computes on XLA:CPU, bit for
bit (tools/probe_scan_flush.py characterises it):
  - subnormals flush (ops/convert.ftz): an operand reads as a zero of its
    sign, a result that would be subnormal is one; comparisons read
    flushed operands too. The scan from a map flushes its reprojection
    as well; the cloud does not (its points keep IEEE subnormals, and P3
    flushes them as it reads them, as the reference's scan does);
  - the angle is glibc's atan2f (XLA:CPU calls the C library's), run
    under those flushes (_atan2_xla): torch.atan2 differs from it by an
    ulp on about one pair of normal floats in eight, and it is NaN where
    both operands are nonzero subnormals;
  - the range is sqrt(fma(x, x, y * y)) (XLA:CPU contracts it);
  - the angle extrema take flushed angles, with -0 below +0.

The four public functions are wrappers: on CUDA tensors they launch
kernels P1 (scan from a disparity map), P2 (the cloud), P3 (scan from
points) and the fused cloud and scan ("cloud_scan": P2 with P3 as its
epilogue) of csrc/scan_kernel.cu, on CPU tensors they run the plain
versions (``*_plain``), which the kernels equal bit for bit. Each is one
launch: the scans' int32 scratch is zeroed once, kept by (device, stream,
sets, bins), and set back to zero by the kernel's last block. None of them
reads anything back to the host. ``launches`` counts the calls that
launched each of P1-P3, ``launches_fused`` the fused kernel's.
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
from ..ops.convert import FLT_MIN, ftz, to_int32

INF = 1e9  # const int INF = 1e9 (point_cloud.cpp:55)

launches = {"scan": 0, "cloud": 0, "scan_points": 0}
# the fused cloud and scan (P2 with P3 as its epilogue), counted apart
launches_fused = {"cloud_scan": 0}


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


def _f32(*v) -> Tuple[float, ...]:
    return tuple(float(x) for x in np.float32(v))


# glibc 2.36's atanf and atan2f (sysdeps/ieee754/flt-32/s_atanf.c,
# e_atan2f.c): their float constants, as the C source's decimal literals
# round them
_AT = _f32(3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
           -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
           6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
           -3.6531571299e-02, 1.6285819933e-02)
_ATANHI = _f32(4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
               1.5707962513e+00)
_ATANLO = _f32(5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
               7.5497894159e-08)
_PI, _PI_LO = _f32(3.1415927410e+00, -8.7422776573e-08)
# atan(+inf) = atanhi[3] + atanlo[3]; pi/2, pi/4 and 3pi/4 (+ tiny) as
# float32 sums round them
_ATAN_INF, _PI_O_2, _PI_O_4, _3PI_O_4 = _f32(
    np.float32(_ATANHI[3]) + np.float32(_ATANLO[3]), 1.5707963705e+00,
    7.8539818525e-01, np.float32(3.0) * np.float32(7.8539818525e-01))


def _pick(i: torch.Tensor, values):
    """values[i] elementwise (tensors or floats) for i in range(len)."""
    out = values[-1]
    for j in range(len(values) - 2, -1, -1):
        out = torch.where(i == j, values[j], out)
    return out


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's atanf of float32 x, each operation rounded on its own: the
    argument reduced about 0, 0.5, 1, 1.5 or infinity, then an odd
    polynomial. |x| < 2^-29 gives x itself (a subnormal too), |x| >= 2^25
    +-atan(inf). No intermediate of a normal x underflows, so the flushes
    change nothing here."""
    ix = x.view(torch.int32) & 0x7FFFFFFF
    red = sum((ix >= b).to(torch.int32) for b in
              (0x3EE00000, 0x3F300000, 0x3F980000, 0x401C0000)) - 1
    a = x.abs()
    num = _pick(red, ((a + a) - 1.0, a - 1.0, a - 1.5, -torch.ones_like(a)))
    den = _pick(red, (a + 2.0, a + 1.0, a * 1.5 + 1.0, a))
    t = torch.where(red < 0, x, num / den)
    z = t * t
    w = z * z
    s1 = z * (_AT[0] + w * (_AT[2] + w * (_AT[4] + w * (
        _AT[6] + w * (_AT[8] + w * _AT[10])))))
    s2 = w * (_AT[1] + w * (_AT[3] + w * (_AT[5] + w * (
        _AT[7] + w * _AT[9]))))
    p = t * (s1 + s2)
    i = red.clamp(min=0)
    z = _pick(i, _ATANHI) - ((p - _pick(i, _ATANLO)) - t)
    neg = x.view(torch.int32) < 0
    r = torch.where(red < 0, t - p, torch.where(neg, -z, z))
    r = torch.where(ix < 0x31000000, x, r)
    r = torch.where(ix >= 0x4C000000,
                    torch.where(neg, -_ATAN_INF, _ATAN_INF), r)
    return torch.where(ix > 0x7F800000, x + x, r)


def _atan2_xla(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2(y, x) of float32 tensors as the jitted reference computes it:
    glibc's atan2f with denormals-are-zero and flush-to-zero, its special
    cases decided on the operands' bits (so a subnormal is not a zero
    there) and its quotient y / x on flushed operands. x == 1 gives atanf(y)
    (a subnormal y itself); two nonzero subnormals give 0 / 0 = NaN."""
    hy, hx = y.view(torch.int32), x.view(torch.int32)
    iy, ix = hy & 0x7FFFFFFF, hx & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)     # 2 * sign(x) + sign(y)
    k = (iy - ix) >> 23
    one = hx == 0x3F800000
    atan = _atanf(torch.where(one, y, ftz(ftz(y) / ftz(x)).abs()))
    z = torch.where(k > 60, _PI_O_2,
                    torch.where((hx < 0) & (k < -60), 0.0, atan))
    r = _pick(m, (z, -z, _PI - (z - _PI_LO), (z - _PI_LO) - _PI))
    half_pi = torch.where(hy < 0, -_PI_O_2, _PI_O_2)
    r = torch.where(iy == 0x7F800000, half_pi, r)
    r = torch.where(ix == 0x7F800000, torch.where(
        iy == 0x7F800000, _pick(m, (_PI_O_4, -_PI_O_4, _3PI_O_4, -_3PI_O_4)),
        _pick(m, (0.0, -0.0, _PI, -_PI))), r)
    r = torch.where(ix == 0, half_pi, r)
    r = torch.where(iy == 0, _pick(m, (y, y, _PI, -_PI)), r)
    r = torch.where(one, atan, r)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, r)


def _extremum(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """The minimum (maximum) over the last axis as XLA's reduction takes
    it: NaN if any, and of two zeros -0 below +0."""
    out = (x.max(-1) if largest else x.min(-1)).values
    zero = (x == 0) & (torch.signbit(x) != largest)
    signed = torch.where(zero.any(-1), 0.0, -0.0)
    return torch.where(out == 0, signed if largest else -signed, out)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root, correctly rounded on every device: the
    card's torch.sqrt is; the CPU's vectorised one is an ulp off on some
    inputs (tools/probe_scan_flush.py), numpy's is not."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _bin_and_reduce(Xr, Yr, accept, sp: ScanParams) -> ScanResult:
    """Polar binning + per-bin minimum range over the accepted points of
    [..., N] point sets, with the reference's flushes, its atan2 and its
    contracted range; each set of a leading batch axis is scanned on its
    own, giving [B, bins] and [B]. Unused points go to a dump slot past
    the bins, so nothing is read back to the host; scatter_reduce's
    minimum carries a NaN range into its bin on the CPU and on the card
    (chip_smoke.scan_probes)."""
    theta = _atan2_xla(Yr, Xr)
    X, Y = ftz(Xr), ftz(Yr)
    r = _sqrt_rn(ftz(fma_f32(X, X, ftz(Y * Y))))
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
    theta = ftz(theta)

    def over_set(x, fill, largest):
        return _extremum(torch.where(accept, x, fill), largest)

    return ScanResult(
        scan.reshape(*batch, sp.bin_size),
        over_set(theta, 400.0, False),
        over_set(theta, -400.0, True),
        over_set(r, INF, False),
        over_set(r, -500.0, True))


def fma_f32(a, x: torch.Tensor, c) -> torch.Tensor:
    """f32(a * x + c) with one rounding, the same on every device (a fused
    multiply-add; neither torch.addcmul nor a compiler's contraction
    promises one). x is a float32 tensor; a and c are float32 tensors or
    Python floats that hold float32 values. A subnormal result is IEEE's
    (the caller flushes it where the reference does). The product of two
    float32 values is exact in float64; the float64 sum is made
    round-to-odd (the TwoSum error says whether it was inexact, and an
    inexact sum with an even last bit moves one ulp toward the error), and
    a round-to-odd value with 53 >= 24 + 2 bits rounds to float32 as the
    exact value does. An infinite or NaN sum is the result as it is (its
    TwoSum error is NaN)."""
    p = x.double() * a
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, err * float("inf")), s)
    return s.float()


def _flushed(v: float) -> float:
    """A float32 constant as a flushed operand reads it."""
    return math.copysign(0.0, v) if abs(v) < FLT_MIN else v


def _ground_constants(gp: GroundPlaneParams) -> Tuple[float, float, float]:
    """(tan(angle_thresh), height_thresh, dist_thresh) as float32 values:
    the tangent taken in float32, as the reference package's is; each read
    as a flushed operand."""
    f32 = torch.float32
    tan = torch.tan(torch.tensor(gp.angle_thresh, dtype=f32)).item()
    height = torch.tensor(gp.height_thresh, dtype=f32).item()
    return tuple(_flushed(v) for v in
                 (tan, height, float(np.float32(gp.dist_thresh))))


def _ground_mask(Xr, Zr, gp: GroundPlaneParams) -> torch.Tensor:
    """Points under the ground plane's height threshold, which rises at
    angle_thresh beyond dist_thresh (point_cloud.cpp:160-170). As the
    reference package ships it (under jit, whose compiler fuses the
    threshold's product and sum): the tangent taken in float32 and
    height + tan * (Xr - dist) rounded once (fma_f32), every operand,
    difference and comparison on flushed values."""
    tan, height, dist = _ground_constants(gp)
    X = ftz(Xr)
    rising = ftz(fma_f32(tan, ftz(X - dist), height))
    thresh = torch.where(X < dist, height, rising)
    return ftz(Zr) < thresh


def obstacle_scan_from_disparity_plain(
    dmap_u8: torch.Tensor, valid_disp: torch.Tensor, Q: torch.Tensor,
    XR: torch.Tensor, XT: torch.Tensor, sp: ScanParams = ScanParams(),
    crop_offset_x: int = 0, crop_offset_y: int = 0,
) -> ScanResult:
    """Scan from a uint8 [..., H, W] disparity map (one frame, or a batch
    whose frames are scanned each as on its own) with the valid-range cache
    valid_disp [H, W, 2] uint8 (dmin, dmax): accept iff dmin <= d <= dmax;
    no ground-plane re-check. The reprojection flushes as the jitted
    reference's does."""
    d = dmap_u8.to(torch.int32)
    accept = ((d >= valid_disp[..., 0].to(torch.int32))
              & (d <= valid_disp[..., 1].to(torch.int32)))
    Xr, Yr, _ = reproject_disparity_to_robot(
        dmap_u8, Q, XR, XT, crop_offset_x, crop_offset_y, ftz)
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


def cloud_and_scan_from_disparity_plain(
    dmap_u8: torch.Tensor, color_bgr: Optional[torch.Tensor],
    Q: torch.Tensor, XR: torch.Tensor, XT: torch.Tensor,
    sp: ScanParams = ScanParams(),
    gp: GroundPlaneParams = GroundPlaneParams(), crop_offset_x: int = 0,
    crop_offset_y: int = 0,
):
    """The gen-pcl tail: (point_cloud_from_disparity_plain's cloud, the
    obstacle_scan_from_points_plain scan of its points)."""
    cloud = point_cloud_from_disparity_plain(
        dmap_u8, color_bgr, Q, XR, XT, sp, crop_offset_x, crop_offset_y)
    return cloud, obstacle_scan_from_points_plain(cloud[0], cloud[2], sp, gp)


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


# zeroed int32 scratch of the scan kernels by (device, stream, sets, bins):
# the sets' reduction keys and block counters, which each launch's last
# blocks set back to zero; a stream of its own, since launches on two
# streams may overlap
_scratch = {}


def _scan_outputs(sp: ScanParams, B: int, dev):
    """(float32 output buffer [B * (bins + 4)] whose slices are the
    ScanResult, the zeroed int32 scratch [B * (bins + 4) + B] of this
    stream, its key in _scratch)."""
    if not 1 <= sp.bin_size <= _MAX_BINS:
        raise ValueError(f"the scan kernels take 1 to {_MAX_BINS} bins, got "
                         f"{sp.bin_size}")
    out = torch.empty(B * (sp.bin_size + _EXTREMA), dtype=torch.float32,
                      device=dev)
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, B,
           sp.bin_size)
    if key not in _scratch:
        _scratch[key] = torch.zeros(B * (sp.bin_size + _EXTREMA) + B,
                                    dtype=torch.int32, device=dev)
    return out, _scratch[key], key


def _launch_scan(fn, kernel: str, t: torch.Tensor, key, *args) -> None:
    """cuda_lib.launch, dropping the scratch under key if the launch fails
    (a kernel that did not run to its end may leave it dirty)."""
    try:
        cuda_lib.launch(fn, kernel, t, *args)
    except RuntimeError:
        _scratch.pop(key, None)
        raise


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


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong


def _maps(kernel: str, dmap_u8):
    """(leading shape, B, H, W, contiguous maps) of u8 maps [..., H, W]."""
    if dmap_u8.dtype != torch.uint8 or dmap_u8.dim() < 2:
        raise ValueError(f"kernel {kernel} takes uint8 [..., H, W] maps, got "
                         f"{dmap_u8.dtype} {tuple(dmap_u8.shape)}")
    lead, (H, W) = dmap_u8.shape[:-2], dmap_u8.shape[-2:]
    B = math.prod(lead)
    _check_sizes(kernel, B, H * W)
    return lead, B, H, W, dmap_u8.contiguous()


def _calib3(Q, XR, XT, dev):
    return (_calib(Q, (4, 4), dev), _calib(XR, (3, 3), dev),
            _calib(XT, (3,), dev))


def _scan_cuda(dmap_u8, valid_disp, Q, XR, XT, sp, ox, oy) -> ScanResult:
    """Kernel P1: one launch."""
    dev = dmap_u8.device
    lead, B, H, W, dm = _maps("P1", dmap_u8)
    if valid_disp.dtype != torch.uint8 or valid_disp.device != dev \
            or tuple(valid_disp.shape) != (H, W, 2):
        raise ValueError(f"kernel P1: expected a uint8 ({H}, {W}, 2) valid "
                         f"range cache on {dev}, got {valid_disp.dtype} "
                         f"{tuple(valid_disp.shape)} on {valid_disp.device}")
    vd = valid_disp.contiguous()
    q, xr, xt = _calib3(Q, XR, XT, dev)
    out, scratch, key = _scan_outputs(sp, B, dev)
    deg, half, ratio = _bin_constants(sp)
    fn = _entry("scan_from_disparity", [_P] * 7 + [_I] * 6 + [_F] * 3)
    _launch_scan(fn, "scan", dm, key, dm.data_ptr(), vd.data_ptr(),
                 q.data_ptr(), xr.data_ptr(), xt.data_ptr(),
                 scratch.data_ptr(), out.data_ptr(), B, H, W, ox, oy,
                 sp.bin_size, deg, half, ratio)
    launches["scan"] += 1
    return _scan_result(out, lead, sp, B)


def _scan_points_cuda(pts, valid, sp, gp) -> ScanResult:
    """Kernel P3: one launch."""
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
    out, scratch, key = _scan_outputs(sp, B, dev)
    fn = _entry("scan_from_points", [_P] * 4 + [_I] * 3 + [_F] * 6)
    _launch_scan(fn, "scan_points", p, key, p.data_ptr(), v.data_ptr(),
                 scratch.data_ptr(), out.data_ptr(), B, N, sp.bin_size,
                 *_bin_constants(sp), *_ground_constants(gp))
    launches["scan_points"] += 1
    return _scan_result(out, lead, sp, B)


def _cloud_args(kernel, dmap_u8, color_bgr, Q, XR, XT):
    """(lead, B, H, W, the cloud's outputs (points, rgb, valid), the
    pointer and stride arguments the cloud kernels share). The colour
    frames are read through their strides (the node's rectified colour is
    a channel-planar view)."""
    dev = dmap_u8.device
    lead, B, H, W, dm = _maps(kernel, dmap_u8)
    strides = [0, 0, 0, 0]
    col = None
    if color_bgr is not None:
        if color_bgr.dtype != torch.uint8 or color_bgr.device != dev \
                or tuple(color_bgr.shape) != (*lead, H, W, 3):
            raise ValueError(f"kernel {kernel}: expected uint8 colour frames "
                             f"{(*lead, H, W, 3)} on {dev}, got "
                             f"{color_bgr.dtype} {tuple(color_bgr.shape)} "
                             f"on {color_bgr.device}")
        col = color_bgr.reshape(B, H, W, 3)
        strides = list(col.stride())
    q, xr, xt = _calib3(Q, XR, XT, dev)
    pts = torch.empty((*lead, H * W, 3), dtype=torch.float32, device=dev)
    rgb = torch.empty((*lead, H * W), dtype=torch.float32, device=dev)
    valid = torch.empty((*lead, H * W), dtype=torch.bool, device=dev)
    ptrs = (dm.data_ptr(), None if col is None else col.data_ptr(),
            q.data_ptr(), xr.data_ptr(), xt.data_ptr(), pts.data_ptr(),
            rgb.data_ptr(), valid.data_ptr())
    return lead, B, H, W, dm, (pts, rgb, valid), ptrs, strides


def _cloud_cuda(dmap_u8, color_bgr, Q, XR, XT, sp, ox, oy):
    """Kernel P2: one launch, no fill (it writes every output)."""
    lead, B, H, W, dm, cloud, ptrs, strides = _cloud_args(
        "P2", dmap_u8, color_bgr, Q, XR, XT)
    fn = _entry("point_cloud", [_P] * 8 + [_L] * 4 + [_I] * 6)
    cuda_lib.launch(fn, "cloud", dm, *ptrs, *strides, B, H, W, ox, oy,
                    sp.min_pcl_disp)
    launches["cloud"] += 1
    return cloud


def _cloud_scan_cuda(dmap_u8, color_bgr, Q, XR, XT, sp, gp, ox, oy):
    """The fused cloud and scan: one launch of P2 with P3 as its
    epilogue."""
    lead, B, H, W, dm, cloud, ptrs, strides = _cloud_args(
        "cloud_scan", dmap_u8, color_bgr, Q, XR, XT)
    out, scratch, key = _scan_outputs(sp, B, dm.device)
    fn = _entry("cloud_scan", [_P] * 10 + [_L] * 4 + [_I] * 7 + [_F] * 6)
    _launch_scan(fn, "cloud_scan", dm, key, *ptrs, scratch.data_ptr(),
                 out.data_ptr(), *strides, B, H, W, ox, oy, sp.min_pcl_disp,
                 sp.bin_size, *_bin_constants(sp), *_ground_constants(gp))
    launches_fused["cloud_scan"] += 1
    return cloud, _scan_result(out, lead, sp, B)


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


def cloud_and_scan_from_disparity(
    dmap_u8: torch.Tensor, color_bgr: Optional[torch.Tensor],
    Q: torch.Tensor, XR: torch.Tensor, XT: torch.Tensor,
    sp: ScanParams = ScanParams(),
    gp: GroundPlaneParams = GroundPlaneParams(), crop_offset_x: int = 0,
    crop_offset_y: int = 0,
):
    """cloud_and_scan_from_disparity_plain's contract: the fused kernel (P2
    with P3 as its epilogue, one launch) on a CUDA map, the plain version
    on a CPU one. Its scan equals P3's of P2's cloud bit for bit."""
    if dmap_u8.is_cuda:
        return _cloud_scan_cuda(dmap_u8, color_bgr, Q, XR, XT, sp, gp,
                                crop_offset_x, crop_offset_y)
    return cloud_and_scan_from_disparity_plain(
        dmap_u8, color_bgr, Q, XR, XT, sp, gp, crop_offset_x, crop_offset_y)


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
