"""Bit-exact obstacle scan (publishObstacleScan(Mat&) in float64).

The scan of scan/obstacle.py computes in float32: fast, but a pixel's bin
can flip against the reference's float64 loop at a bin boundary. This
module reproduces point_cloud.cpp:213-296 exactly, in torch.float64 on
the device:

  - the Q reprojection, camera->robot transform and r = sqrt(Y*Y + X*X)
    follow the reference's operation order (left-associated gemv rows,
    then the XT add), one eager op each: no multiply is fused into an
    add, and float64 division and square root are correctly rounded
    (_sqrt_rn) on the CPU and on the card;
  - the bin index k = floor(90*(45 - theta_deg)/90), theta_deg =
    (atan2(Y,X)*180)/3.1415, is decided without computing atan2 in
    float64: the host bit-searches the 92 float64 angle boundaries T_j of
    the composed expression (_K), and the device compares the true angle
    against the rounding midpoints M_j by the exact sign of
    Y*cos(M) - X*sin(M), with Dekker's error-free products in double-
    double. A float32 atan2 picks the candidate bin; the two midpoint
    tests correct it by at most +/-1;
  - per-bin minima and range extrema reduce over the float64 bit patterns
    through the monotone total-order map (_ord: the int64 bit view with
    the sign fix), so the winners are exact;
  - angle_min/angle_max: the device finds the extremal-angle pixels by
    (quadrant band, exact float64 ratio Y/X) lexicographic order, which is
    monotone in atan2, and the host evaluates math.atan2 (the libm double
    the reference calls) on those two pixels' recomputed X, Y.

Assumptions (probabilistically negligible): the platform libm's atan2 is
correctly rounded at the <= 92 bin-boundary midpoints, and no two
accepted pixels share a band with an angle gap below ~2^-104 while
competing for an extremum.

On the card the per-pixel work and its reductions are kernel V
(csrc/exact_scan_kernel.cu, _device_scan_cuda: the same operations in
the same order, the card's atan2f as the candidate, two launches), read
with one copy to the host; _device_scan, one eager op a step, is the CPU
path and V's plain version (obstacle_scan_from_disparity_exact_plain runs
it on any device). ``launches`` counts V's calls.

This is the verification path, with the reference's constants (90 bins
over +/-45 degrees); scan/obstacle.py stays the node's scan.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..config import REF_PI
from ..device import DeviceLike, resolve_device
from ..ops import cuda_lib
from .obstacle import INF, ScanResult

_BINS = 90
_NJ = _BINS + 2          # boundary tables for j = 0..91
_MAG = 0x7FFFFFFFFFFFFFFF
_I64_MIN = -(1 << 63)


# ---------------------------------------------------------------------------
# host: boundary tables
# ---------------------------------------------------------------------------

def _K(th: float) -> int:
    """The reference's composed bin expression on an f64 angle
    (point_cloud.cpp:255-264): theta_deg = theta*180/3.1415 (two
    roundings), k = floor(90*(45 - theta_deg)/90). Python floats are
    IEEE binary64 with correct rounding — identical to the C++ doubles."""
    thd = th * 180.0 / REF_PI
    return math.floor((90.0 * (45.0 - thd)) / 90.0)


def _ord_f64(x: float) -> int:
    """Host twin of _ord (signed int64 total order)."""
    b = np.array(x, np.float64).view(np.int64).item()
    if b >= 0:
        return b
    u = ((~b) ^ (1 << 63)) & 0xFFFFFFFFFFFFFFFF
    return u - (1 << 64)          # reinterpret as signed (bit 63 is set)


def _from_ord(o: int) -> float:
    """Inverse of _ord_f64 (o as a signed python int)."""
    if o >= 0:
        b = o
    else:
        b = (~((o + (1 << 64)) ^ (1 << 63))) & 0xFFFFFFFFFFFFFFFF
    return np.array(np.uint64(b), np.uint64).view(np.float64).item()


@lru_cache(maxsize=1)
def _boundary_tables() -> Tuple[np.ndarray, ...]:
    """Per j in 0..91: T_j = smallest f64 theta with K(theta) <= j-1
    (K is nonincreasing), the rounding midpoint M_j = (pred(T_j)+T_j)/2
    as a double-double, and cos/sin of M_j as double-doubles (np.float128
    = x86 80-bit extended gives ~2^-63 relative accuracy — far below the
    decision margin). Row j = 91 is a sentinel (forced 'below')."""
    c_hi = np.zeros(_NJ)
    c_lo = np.zeros(_NJ)
    s_hi = np.zeros(_NJ)
    s_lo = np.zeros(_NJ)
    for j in range(_BINS + 1):                    # j = 0..90
        lo, hi = _ord_f64(-0.8), _ord_f64(0.8)
        # invariant: K(from_ord(hi)) <= j-1 < K(from_ord(lo))
        assert _K(_from_ord(hi)) <= j - 1 < _K(_from_ord(lo))
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if _K(_from_ord(mid)) <= j - 1:
                hi = mid
            else:
                lo = mid
        T = _from_ord(hi)
        Tp = np.nextafter(np.float64(T), np.float64(-np.inf))
        m_hi = np.float64(T)
        m_lo = (Tp - np.float64(T)) / 2.0         # exact: half an ulp
        M = np.float128(m_hi) + np.float128(m_lo)
        c = np.cos(M)
        s = np.sin(M)
        c_hi[j] = np.float64(c)
        c_lo[j] = np.float64(c - np.float128(c_hi[j]))
        s_hi[j] = np.float64(s)
        s_lo[j] = np.float64(s - np.float128(s_hi[j]))
    return (c_hi.view(np.int64), c_lo.view(np.int64),
            s_hi.view(np.int64), s_lo.view(np.int64))


# ---------------------------------------------------------------------------
# device: float64, one eager op per step
# ---------------------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int64)


def _ord(x: torch.Tensor) -> torch.Tensor:
    """The monotone total order of float64 values as int64: the bit view,
    with the magnitude bits of negative values flipped."""
    b = _bits(x)
    return torch.where(b >= 0, b, (~b) ^ _I64_MIN)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root. The card's double sqrt is;
    PyTorch's vectorised CPU sqrt is not on every build (on an AVX-512
    build about 0.9 % of random doubles come out one ulp off), so CPU
    tensors take numpy's, which is the IEEE instruction."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def _split(a: torch.Tensor):
    """Dekker's split (exact with a correctly rounded multiply; magnitudes
    here << 2^996)."""
    c = a * 134217729.0                           # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    p = a * b
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    e = (((a1 * b1 - p) + a1 * b2) + a2 * b1) + a2 * b2
    return p, e


def _gt_mid(Yb, Xb, ch, cl, sh, sl) -> torch.Tensor:
    """True iff the atan2 angle of (Y, X) exceeds M, where (ch+cl, sh+sl)
    are cos/sin M in double-double: the sign of Y*cosM - X*sinM, with
    error-free products."""
    p1, e1 = _two_prod(Yb, ch)
    p2, e2 = _two_prod(Xb, sh)
    s0 = p1 - p2
    bb = s0 - p1
    err0 = (p1 - (s0 - bb)) + (-p2 - bb)
    tail = (e1 - e2) + (Yb * cl - Xb * sl)
    tot = s0 + (err0 + tail)
    return _bits(tot) > 0                         # > +0, by its bits


def _scale_pair(Xb: torch.Tensor, Yb: torch.Tensor):
    """Rescale (X, Y) by one power of two, on the bits, so that float32
    casts cannot underflow: the angle, the double-double signs and the
    ratio's order do not change."""
    bx, by = _bits(Xb), _bits(Yb)
    ex, ey = (bx >> 52) & 0x7FF, (by >> 52) & 0x7FF
    zx, zy = (bx & _MAG) == 0, (by & _MAG) == 0
    emax = torch.maximum(torch.where(zx, 0, ex), torch.where(zy, 0, ey))
    shift = (1023 - emax) << 52

    def adj(b, z):
        return torch.where(z, b, b + shift).view(torch.float64)
    return adj(bx, zx), adj(by, zy)


def _device_scan(dmap_u8, vlo, vhi, Q, XR, XT, ox: int, oy: int):
    """The per-pixel float64 work and its reductions: (per-bin ord minima
    [90], ord of the least and the greatest range, flat indices of the
    least- and greatest-angle pixels, accepted pixel count)."""
    dev = dmap_u8.device
    f64 = torch.float64
    H, W = dmap_u8.shape
    d_i = dmap_u8.to(torch.int32)
    accept = (d_i >= vlo.to(torch.int32)) & (d_i <= vhi.to(torch.int32))
    ub = (torch.arange(W, device=dev, dtype=f64) + ox).expand(H, W)
    vb = (torch.arange(H, device=dev, dtype=f64) + oy)[:, None].expand(H, W)
    db = d_i.to(f64)

    def gemv_row(q):
        t = q[0] * ub + q[1] * vb
        t = t + q[2] * db
        return t + q[3]

    r0, r1, r2, r3 = (gemv_row(Q[i]) for i in range(4))
    X, Y, Z = r0 / r3, r1 / r3, r2 / r3

    def rot_row(rr, t):
        s = rr[0] * X + rr[1] * Y
        s = s + rr[2] * Z
        return s + t

    Xr, Yr = rot_row(XR[0], XT[0]), rot_row(XR[1], XT[1])
    rb = _sqrt_rn(Yr * Yr + Xr * Xr)

    # --- the bin: a float32 candidate, corrected by the midpoint tests ---
    Xs, Ys = _scale_pair(Xr, Yr)
    th32 = torch.atan2(Ys.to(torch.float32), Xs.to(torch.float32))
    thd32 = th32 * float(np.float32(180.0 / REF_PI))
    khat = torch.floor(90.0 * (45.0 - thd32) / 90.0).to(torch.int32)

    bx, by = _bits(Xr), _bits(Yr)
    x_zero, y_zero = (bx & _MAG) == 0, (by & _MAG) == 0
    x_pos = (bx >= 0) & ~x_zero
    cand = x_pos & (khat >= -1) & (khat <= _BINS)
    tabs = [torch.from_numpy(t.view(np.float64)).to(dev)
            for t in _boundary_tables()]
    jj_a = khat.clamp(0, _NJ - 1).long()
    jj_b = (khat + 1).clamp(0, _NJ - 1).long()
    a = cand & (khat >= 0) & (khat <= _BINS) \
        & _gt_mid(Ys, Xs, *(t[jj_a] for t in tabs))
    b = (khat + 1 > _BINS) | _gt_mid(Ys, Xs, *(t[jj_b] for t in tabs))
    k = torch.where(a, khat - 1, torch.where(~b, khat + 1, khat))
    use = cand & (k >= 0) & (k < _BINS) & accept
    # atan2(0, 0) = 0 -> bin 45, r = 0 (the reference bins it)
    origin = x_zero & y_zero & accept
    k = torch.where(origin, 45, k)
    use = use | origin

    # --- per-bin minima over exact float64 keys ---
    big = torch.iinfo(torch.int64).max
    rkey = _ord(rb)
    scan_ord = torch.full((_BINS,), big, dtype=torch.int64, device=dev)
    scan_ord = scan_ord.scatter_reduce(0, k[use].long(), rkey[use], "amin")
    rmin_ord = torch.where(accept, rkey, big).min()
    rmax_ord = torch.where(accept, rkey, _I64_MIN).max()

    # --- angle extrema: (band, ratio ord) lexicographic ---
    y_neg = by < 0
    band = torch.where(
        x_pos | (x_zero & y_zero), 2,
        torch.where(x_zero & y_neg, 1,
                    torch.where(x_zero, 3, torch.where(y_neg, 0, 4))))
    ratio = torch.where(x_zero, 0.0, Ys / torch.where(x_zero, 1.0, Xs))
    rato = _ord(ratio)
    in_min = accept & (band == torch.where(accept, band, 9).min())
    in_max = accept & (band == torch.where(accept, band, -9).max())
    ord_min = torch.where(in_min, rato, big).min()
    ord_max = torch.where(in_max, rato, _I64_MIN).max()
    flat = torch.arange(H * W, device=dev).reshape(H, W)

    def first(mask):
        return torch.where(mask, flat, H * W).min()
    return (scan_ord, rmin_ord, rmax_ord, first(in_min & (rato == ord_min)),
            first(in_max & (rato == ord_max)), accept.sum())


def _host64(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float64)


# ---------------------------------------------------------------------------
# card: kernel V
# ---------------------------------------------------------------------------

launches = {"exact_scan": 0}
# V's int64 output: the bins' least range ords [90], the least and greatest
# range ord, the flat indices of the least- and greatest-angle pixels, the
# accepted count, those two pixels' d, the pixels that ran the midpoint
# tests (csrc/exact_scan_kernel.cu)
N_OUT = _BINS + 8
OUT_RMIN, OUT_RMAX, OUT_AMIN, OUT_AMAX, OUT_N, OUT_DMIN, OUT_DMAX, OUT_MID = \
    range(_BINS, N_OUT)


@lru_cache(maxsize=1)
def _tables_f64() -> np.ndarray:
    return np.ascontiguousarray(np.concatenate(
        [t.view(np.float64) for t in _boundary_tables()]))


def _device_scan_cuda(dmap: torch.Tensor, valid: torch.Tensor, Q64, XR64,
                      XT64, ox: int, oy: int) -> torch.Tensor:
    """Kernel V on a card map: uint8 dmap [H, W] and valid [H, W, 2] ->
    int64 [N_OUT] on the card, two launches (the blocks' records, their
    reduction), no other op."""
    dmap, valid = dmap.contiguous(), valid.contiguous()
    H, W = dmap.shape
    dev = dmap.device
    cuda_lib.expect(dmap, "dmap", torch.uint8, (H, W), dev, 1)
    cuda_lib.expect(valid, "valid_disp", torch.uint8, (H, W, 2), dev, 1)
    lib = cuda_lib.load("exact_scan_kernel")
    nrec = lib.exact_scan_records
    nrec.argtypes = [ctypes.c_int] * 2
    nrec.restype = ctypes.c_longlong
    rec = torch.empty(nrec(H, W), dtype=torch.int64, device=dev)
    out = torch.empty(N_OUT, dtype=torch.int64, device=dev)
    coef = np.ascontiguousarray(np.concatenate(
        [Q64.reshape(16), XR64[:2].reshape(6), XT64[:2]]), np.float64)
    fn = lib.exact_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_lib.launch(fn, "exact_scan", dmap, dmap.data_ptr(), valid.data_ptr(),
                    rec.data_ptr(), out.data_ptr(), H, W, int(ox), int(oy),
                    coef.ctypes.data, float(np.float32(180.0 / REF_PI)),
                    _tables_f64().ctypes.data)
    launches["exact_scan"] += 1
    return out


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

def _result(vals, Q64, XR64, XT64, W: int, ox: int, oy: int,
            dev) -> ScanResult:
    """The ScanResult of V's N_OUT values (python ints), float64 on dev in
    one upload: the host's math.atan2 at the two extremal pixels."""
    scan = [_from_ord(o) if o != _MAG else INF for o in vals[:_BINS]]
    if vals[OUT_N] == 0:
        host = scan + [400.0, -400.0, INF, -500.0]
    else:
        def host_theta(flat_idx, d):
            j, i = divmod(flat_idx, W)
            u = float(i + ox)
            v = float(j + oy)
            row = [None] * 4
            for r in range(4):
                t = Q64[r, 0] * u + Q64[r, 1] * v
                t = t + Q64[r, 2] * float(d)
                row[r] = t + Q64[r, 3]
            X = row[0] / row[3]
            Y = row[1] / row[3]
            Z = row[2] / row[3]
            Xr = (XR64[0, 0] * X + XR64[0, 1] * Y) + XR64[0, 2] * Z + XT64[0]
            Yr = (XR64[1, 0] * X + XR64[1, 1] * Y) + XR64[1, 2] * Z + XT64[1]
            return math.atan2(Yr, Xr)

        host = scan + [host_theta(vals[OUT_AMIN], vals[OUT_DMIN]),
                       host_theta(vals[OUT_AMAX], vals[OUT_DMAX]),
                       _from_ord(vals[OUT_RMIN]), _from_ord(vals[OUT_RMAX])]
    t = torch.tensor(host, dtype=torch.float64, device=dev)
    return ScanResult(t[:_BINS], t[_BINS], t[_BINS + 1], t[_BINS + 2],
                      t[_BINS + 3])


def _inputs(dmap_u8, valid_disp, Q, XR, XT, device):
    dev = resolve_device(device)
    return (dev, torch.as_tensor(dmap_u8).to(dev),
            torch.as_tensor(valid_disp).to(dev), _host64(Q), _host64(XR),
            _host64(XT).reshape(3))


def obstacle_scan_from_disparity_exact(
    dmap_u8, valid_disp, Q, XR, XT,
    crop_offset_x: int = 0, crop_offset_y: int = 0,
    device: DeviceLike = None,
) -> ScanResult:
    """Bit-exact twin of the reference publishObstacleScan(Mat&) loop
    (point_cloud.cpp:213-296) for a uint8 [H, W] map and its [H, W, 2]
    valid range: the float64 arithmetic on ``device`` (the card unless
    "cpu"), host atan2 only at the two extremal pixels. The ScanResult's
    fields are float64 tensors on ``device``. On the card kernel V, its
    results read with one copy to the host; on the CPU _device_scan."""
    dev, dmap, valid, Q64, XR64, XT64 = _inputs(dmap_u8, valid_disp, Q, XR,
                                                XT, device)
    if not dmap.is_cuda:
        return _scan_eager(dmap, valid, Q64, XR64, XT64, crop_offset_x,
                           crop_offset_y, dev)
    out = _device_scan_cuda(dmap, valid, Q64, XR64, XT64, crop_offset_x,
                            crop_offset_y)
    return _result(out.cpu().tolist(), Q64, XR64, XT64, dmap.shape[1],
                   crop_offset_x, crop_offset_y, dev)


def _scan_eager(dmap, valid, Q64, XR64, XT64, ox, oy, dev) -> ScanResult:
    out = _device_scan(dmap, valid[..., 0], valid[..., 1], Q64.tolist(),
                       XR64.tolist(), XT64.tolist(), ox, oy)
    scan_ord, rmin_o, rmax_o, ai, ax, n_acc = (x.cpu().numpy() for x in out)
    dmap_h = dmap.cpu().numpy()
    ai, ax = int(ai), int(ax)
    vals = [int(o) for o in scan_ord] + [0] * (N_OUT - _BINS)
    vals[OUT_RMIN], vals[OUT_RMAX] = int(rmin_o), int(rmax_o)
    vals[OUT_AMIN], vals[OUT_AMAX], vals[OUT_N] = ai, ax, int(n_acc)
    if int(n_acc):
        vals[OUT_DMIN] = int(dmap_h.flat[ai])
        vals[OUT_DMAX] = int(dmap_h.flat[ax])
    return _result(vals, Q64, XR64, XT64, dmap.shape[1], ox, oy, dev)


def obstacle_scan_from_disparity_exact_plain(
    dmap_u8, valid_disp, Q, XR, XT,
    crop_offset_x: int = 0, crop_offset_y: int = 0,
    device: DeviceLike = None,
) -> ScanResult:
    """obstacle_scan_from_disparity_exact through _device_scan on any
    device, one eager op a step (on the card, the yardstick V is held to
    and timed against)."""
    dev, dmap, valid, Q64, XR64, XT64 = _inputs(dmap_u8, valid_disp, Q, XR,
                                                XT, device)
    return _scan_eager(dmap, valid, Q64, XR64, XT64, crop_offset_x,
                       crop_offset_y, dev)
