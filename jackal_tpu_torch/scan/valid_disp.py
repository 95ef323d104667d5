"""Valid-disparity cache (vectorized cacheDisparityValues).

The reference's O(W*H*253) triple loop with a 4x4 double matmul per step
(point_cloud.cpp:104-147) becomes one broadcast over d=3..255 plus a
first-True argmax. Runs once at startup, on the host in float64 so the
ground-plane threshold comparisons match the reference bit-for-bit.
"""
from __future__ import annotations

import math
import numpy as np

from ..config import GroundPlaneParams, ScanParams


def ground_plane_mask(
    X: np.ndarray, Z: np.ndarray, gp: GroundPlaneParams
) -> np.ndarray:
    """True where a robot-frame point is ON/BELOW the ground-plane model
    (i.e. rejected as ground). point_cloud.cpp:133-139,166-172.

    The threshold height rises at GP_ANGLE_THRESH past GP_DIST_THRESH.
    """
    thresh = np.where(
        X < gp.dist_thresh,
        gp.height_thresh,
        gp.height_thresh + math.tan(gp.angle_thresh) * (X - gp.dist_thresh),
    )
    return Z < thresh


def cache_disparity_values(
    Q: np.ndarray,
    XR: np.ndarray,
    XT: np.ndarray,
    crop_im_width: int,
    crop_im_height: int,
    crop_offset_x: int = 0,
    crop_offset_y: int = 0,
    gp: GroundPlaneParams = GroundPlaneParams(),
    scan: ScanParams = ScanParams(),
) -> np.ndarray:
    """Per-pixel [dmin, dmax] valid disparity range, uint8 [H, W, 2].

    dmin = smallest d in [3,255] whose robot-frame point has Z >= 0 and
    clears the ground plane; dmax = 255. If no d qualifies the loop in the
    reference leaves d = 256 which is stored into a uint8 as 0
    (point_cloud.cpp:142, Vec2b overflow) -- making every disparity "valid"
    for that pixel. We reproduce that wraparound exactly.
    """
    H, W = crop_im_height, crop_im_width
    u = (np.arange(W, dtype=np.float64) + crop_offset_x)[None, :]
    v = (np.arange(H, dtype=np.float64) + crop_offset_y)[:, None]
    Q = np.asarray(Q, np.float64)
    XR = np.asarray(XR, np.float64)
    XT = np.asarray(XT, np.float64).reshape(3)
    # d-invariant prefix of each row's multiply-add chain, hoisted WITHOUT
    # reassociating: the full chain stays ((Qi0*u + Qi1*v) + Qi2*d) + Qi3,
    # the reference's left-to-right order, so every f64 rounding matches
    w0 = Q[3, 0] * u + Q[3, 1] * v
    X0 = Q[0, 0] * u + Q[0, 1] * v
    Y0 = Q[1, 0] * u + Q[1, 1] * v
    Z0 = Q[2, 0] * u + Q[2, 1] * v

    # STREAM over d with a running first-match: one [H, W] slab per d
    # instead of [H, W, 253] float64 intermediates (at 1280x960 the
    # broadcast form materializes ~20 GB of temporaries — minutes of
    # page-fault stalls on this 1-core host; the stream is seconds).
    # Identical per-element arithmetic -> bit-equal dmin.
    dmin_i = np.full((H, W), 256, np.int32)
    found = np.zeros((H, W), bool)
    for dv in range(scan.cache_disp_lo, scan.cache_disp_hi + 1):
        d = np.float64(dv)
        w = (w0 + Q[3, 2] * d) + Q[3, 3]
        Xc = ((X0 + Q[0, 2] * d) + Q[0, 3]) / w
        Yc = ((Y0 + Q[1, 2] * d) + Q[1, 3]) / w
        Zc = ((Z0 + Q[2, 2] * d) + Q[2, 3]) / w
        Xr = XR[0, 0] * Xc + XR[0, 1] * Yc + XR[0, 2] * Zc + XT[0]
        Zr = XR[2, 0] * Xc + XR[2, 1] * Yc + XR[2, 2] * Zc + XT[2]
        ok = (Zr >= 0.0) & ~ground_plane_mask(Xr, Zr, gp)
        new = ok & ~found
        if new.any():
            dmin_i[new] = dv
            found |= new
        if found.all():
            break
    # no valid d -> d ends at 256 -> uint8 wraparound to 0
    dmin = dmin_i.astype(np.uint8)
    dmax = np.full((H, W), 255, dtype=np.uint8)
    return np.stack([dmin, dmax], axis=-1)
