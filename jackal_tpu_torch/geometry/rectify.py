"""Stereo rectification (Bouguet's algorithm) and undistort-rectify maps.

Standalone float64 numpy re-implementation of the OpenCV calib3d entry points
the reference uses at startup (point_cloud.cpp:543-554):

  - ``stereo_rectify``           == cv::stereoRectify(CALIB_ZERO_DISPARITY, alpha)
  - ``init_undistort_rectify_map`` == cv::initUndistortRectifyMap (CV_32F maps)

This is cold-path host code (runs once per calibration); the per-frame remap
consuming the maps lives in ``jackal_tpu.geometry.remap`` and runs on TPU.

The distortion model is OpenCV's radial-tangential with up to 8 coefficients
(k1,k2,p1,p2,k3[,k4,k5,k6]); the reference calibration uses 5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation vector <-> matrix (both directions), float64."""
    r = np.asarray(r, dtype=np.float64)
    if r.shape == (3, 3):
        # matrix -> vector
        R = r
        rv = np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
            dtype=np.float64,
        )
        s = np.linalg.norm(rv) * 0.5
        c = (np.trace(R) - 1.0) * 0.5
        c = min(max(c, -1.0), 1.0)
        theta = np.arccos(c)
        if s < 1e-5:
            if c > 0:
                return np.zeros(3)
            # theta ~ pi
            t = (R + np.eye(3)) * 0.5
            v = np.sqrt(np.maximum(np.diag(t), 0.0))
            # fix signs using off-diagonals
            if v[0] >= v[1] and v[0] >= v[2]:
                v[1] = np.copysign(v[1], t[0, 1])
                v[2] = np.copysign(v[2], t[0, 2])
            elif v[1] >= v[2]:
                v[0] = np.copysign(v[0], t[0, 1])
                v[2] = np.copysign(v[2], t[1, 2])
            else:
                v[0] = np.copysign(v[0], t[0, 2])
                v[1] = np.copysign(v[1], t[1, 2])
            return v / max(np.linalg.norm(v), 1e-30) * theta
        return rv * (theta / (2.0 * s))
    # vector -> matrix
    rv = r.reshape(3)
    theta = np.linalg.norm(rv)
    if theta < 1e-30:
        return np.eye(3)
    k = rv / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
        dtype=np.float64,
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _dist8(D: np.ndarray) -> np.ndarray:
    """Pad distortion coefficients to (k1,k2,p1,p2,k3,k4,k5,k6)."""
    D = np.zeros(8) if D is None else np.asarray(D, dtype=np.float64).ravel()
    out = np.zeros(8, dtype=np.float64)
    out[: min(len(D), 8)] = D[:8]
    return out


def distort_normalized(xy: np.ndarray, D: np.ndarray) -> np.ndarray:
    """Apply the radial-tangential model to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(D)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    kr = num / den
    xd = x * kr + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * kr + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_points(
    pts: np.ndarray,
    K: np.ndarray,
    D: np.ndarray,
    R: Optional[np.ndarray] = None,
    P: Optional[np.ndarray] = None,
    iters: int = 5,
) -> np.ndarray:
    """cv::undistortPoints equivalent (fixed-point iteration, 5 iters).

    pts: (..., 2) pixel coords. Returns (..., 2): normalized coords, or pixel
    coords under P if P is given; rotated by R if given.
    """
    K = np.asarray(K, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(D)
    x0 = (pts[..., 0] - cx) / fx
    y0 = (pts[..., 1] - cy) / fy
    x, y = x0.copy(), y0.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))) / (
            1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        )
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    out = np.stack([x, y, np.ones_like(x)], axis=-1)
    if R is not None:
        out = out @ np.asarray(R, dtype=np.float64).T
    if P is not None:
        P = np.asarray(P, dtype=np.float64)
        A = P[:3, :3]
        out = out @ A.T
        out = out[..., :2] / out[..., 2:3]
        return out
    return out[..., :2] / out[..., 2:3]


def _get_rectangles(
    K: np.ndarray, D: np.ndarray, R: np.ndarray, newK: np.ndarray,
    img_size: Tuple[int, int],
) -> Tuple[Tuple[float, float, float, float], Tuple[float, float, float, float]]:
    """icvGetRectangles: inner/outer rects of the undistorted-rectified image.

    img_size is (width, height). Returns (inner, outer) as (x, y, w, h).
    Uses the same 9x9 sample grid as OpenCV.
    """
    # Classic OpenCV grid: x*w/(N-1) spans [0, w] inclusive (one px beyond the
    # image), matching the OpenCV generation the reference ran. OpenCV 5.x
    # changed the inner-rect estimate slightly (~1% on the alpha=0 scale);
    # we keep the historical behavior and test against cv2 with tolerance.
    N = 9
    w, h = img_size
    xs = np.arange(N, dtype=np.float32) * w / (N - 1)
    ys = np.arange(N, dtype=np.float32) * h / (N - 1)
    gx, gy = np.meshgrid(xs, ys)  # [N(y), N(x)]
    pts = np.stack([gx, gy], axis=-1).astype(np.float32).astype(np.float64)
    und = undistort_points(pts, K, D, R=R, P=newK).astype(np.float32)
    px, py = und[..., 0], und[..., 1]
    oX0, oX1 = px.min(), px.max()
    oY0, oY1 = py.min(), py.max()
    iX0 = px[:, 0].max()
    iX1 = px[:, -1].min()
    iY0 = py[0, :].max()
    iY1 = py[-1, :].min()
    inner = (float(iX0), float(iY0), float(iX1 - iX0), float(iY1 - iY0))
    outer = (float(oX0), float(oY0), float(oX1 - oX0), float(oY1 - oY0))
    return inner, outer


@dataclasses.dataclass
class RectifyResult:
    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    Q: np.ndarray


def stereo_rectify(
    K1: np.ndarray, D1: np.ndarray, K2: np.ndarray, D2: np.ndarray,
    image_size: Tuple[int, int], R: np.ndarray, T: np.ndarray,
    zero_disparity: bool = True,
    alpha: float = 0.0,
    new_image_size: Optional[Tuple[int, int]] = None,
) -> RectifyResult:
    """cv::stereoRectify equivalent (Bouguet). Sizes are (width, height).

    Matches point_cloud.cpp:543-544: CV_CALIB_ZERO_DISPARITY, alpha=0,
    newsize=(320,180) with calib size (640,360).
    """
    K1 = np.asarray(K1, np.float64); K2 = np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64); T = np.asarray(T, np.float64).reshape(3)
    nx, ny = image_size

    om = rodrigues(R) * -0.5
    r_r = rodrigues(om)              # rotate cameras to same orientation
    t = r_r @ T

    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0

    # global Z rotation aligning the baseline with the image x (or y) axis
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww *= np.arccos(min(abs(c) / nt, 1.0)) / nw
    wR = rodrigues(ww)

    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    # new intrinsics
    if new_image_size is None or new_image_size[0] * new_image_size[1] == 0:
        new_image_size = image_size
    ratio_x = new_image_size[0] / nx / 2.0
    ratio_y = new_image_size[1] / ny / 2.0
    ratio = ratio_x if idx == 1 else ratio_y
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio

    cc_new = np.zeros((2, 2), dtype=np.float64)
    for k, (A, Dk, Rk) in enumerate(((K1, D1, R1), (K2, D2, R2))):
        # image corners, undistorted, projected with fc_new and cc=0
        pts = np.array(
            [[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]],
            dtype=np.float32,
        ).astype(np.float64)
        newA = np.array(
            [[fc_new, 0, 0], [0, fc_new, 0], [0, 0, 1]], dtype=np.float64
        )
        proj = undistort_points(pts, A, Dk, R=Rk, P=newA).astype(np.float32)
        avg = proj.mean(axis=0, dtype=np.float64)
        cc_new[k, 0] = (nx - 1) / 2.0 - avg[0]
        cc_new[k, 1] = (ny - 1) / 2.0 - avg[1]

    if zero_disparity:
        cc_new[:, 0] = cc_new[:, 0].mean()
        cc_new[:, 1] = cc_new[:, 1].mean()
    elif idx == 0:
        cc_new[:, 1] = cc_new[:, 1].mean()
    else:
        cc_new[:, 0] = cc_new[:, 0].mean()

    P1 = np.zeros((3, 4), dtype=np.float64)
    P1[0, 0] = P1[1, 1] = fc_new
    P1[0, 2] = cc_new[0, 0]
    P1[1, 2] = cc_new[0, 1]
    P1[2, 2] = 1.0
    P2 = P1.copy()
    P2[0, 2] = cc_new[1, 0]
    P2[1, 2] = cc_new[1, 1]
    P2[idx, 3] = t[idx] * fc_new  # baseline * focal

    alpha = min(alpha, 1.0)
    cx1_0, cy1_0 = cc_new[0]
    cx2_0, cy2_0 = cc_new[1]
    cx1 = new_image_size[0] * cx1_0 / nx
    cy1 = new_image_size[1] * cy1_0 / ny
    cx2 = new_image_size[0] * cx2_0 / nx
    cy2 = new_image_size[1] * cy2_0 / ny
    nw_, nh_ = new_image_size
    s = 1.0

    if alpha >= 0:
        inner1, outer1 = _get_rectangles(K1, D1, R1, P1[:, :3], image_size)
        inner2, outer2 = _get_rectangles(K2, D2, R2, P2[:, :3], image_size)

        s0 = max(
            cx1 / (cx1_0 - inner1[0]),
            cy1 / (cy1_0 - inner1[1]),
            (nw_ - cx1) / (inner1[0] + inner1[2] - cx1_0),
            (nh_ - cy1) / (inner1[1] + inner1[3] - cy1_0),
        )
        s0 = max(
            s0,
            cx2 / (cx2_0 - inner2[0]),
            cy2 / (cy2_0 - inner2[1]),
            (nw_ - cx2) / (inner2[0] + inner2[2] - cx2_0),
            (nh_ - cy2) / (inner2[1] + inner2[3] - cy2_0),
        )
        s1 = min(
            cx1 / (cx1_0 - outer1[0]),
            cy1 / (cy1_0 - outer1[1]),
            (nw_ - cx1) / (outer1[0] + outer1[2] - cx1_0),
            (nh_ - cy1) / (outer1[1] + outer1[3] - cy1_0),
        )
        s1 = min(
            s1,
            cx2 / (cx2_0 - outer2[0]),
            cy2 / (cy2_0 - outer2[1]),
            (nw_ - cx2) / (outer2[0] + outer2[2] - cx2_0),
            (nh_ - cy2) / (outer2[1] + outer2[3] - cy2_0),
        )
        s = s0 * (1 - alpha) + s1 * alpha

    fc_new *= s
    cc_new = np.array([[cx1, cy1], [cx2, cy2]], dtype=np.float64)
    P1[0, 0] = P1[1, 1] = fc_new
    P1[0, 2] = cc_new[0, 0]
    P1[1, 2] = cc_new[0, 1]
    P2[0, 0] = P2[1, 1] = fc_new
    P2[0, 2] = cc_new[1, 0]
    P2[1, 2] = cc_new[1, 1]
    P2[idx, 3] = t[idx] * fc_new

    Q = np.zeros((4, 4), dtype=np.float64)
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -cc_new[0, 0]
    Q[1, 3] = -cc_new[0, 1]
    Q[2, 3] = fc_new
    Q[3, 2] = -1.0 / t[idx]
    Q[3, 3] = (cc_new[0, 0] - cc_new[1, 0]) / t[idx] if idx == 0 else (
        (cc_new[0, 1] - cc_new[1, 1]) / t[idx]
    )
    return RectifyResult(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q)


def init_undistort_rectify_map(
    K: np.ndarray, D: np.ndarray, R: np.ndarray, P: np.ndarray,
    size: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """cv::initUndistortRectifyMap equivalent (CV_32F maps).

    size is (width, height). Returns (mapx, mapy), each [H, W] float32, such
    that dst(u,v) = src(mapx[v,u], mapy[v,u]).
    """
    K = np.asarray(K, np.float64)
    P = np.asarray(P, np.float64)
    A = P[:3, :3] if P.shape == (3, 4) else P
    iR = np.linalg.inv(A @ np.asarray(R, np.float64))
    w, h = size
    u = np.arange(w, dtype=np.float64)
    v = np.arange(h, dtype=np.float64)
    uu, vv = np.meshgrid(u, v)
    ones = np.ones_like(uu)
    xyz = np.stack([uu, vv, ones], axis=-1) @ iR.T
    x = xyz[..., 0] / xyz[..., 2]
    y = xyz[..., 1] / xyz[..., 2]
    xy = distort_normalized(np.stack([x, y], axis=-1), D)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    mapx = (xy[..., 0] * fx + cx).astype(np.float32)
    mapy = (xy[..., 1] * fy + cy).astype(np.float32)
    return mapx, mapy
