"""Disparity -> 3D reprojection and the camera->robot transform.

The per-pixel Q-matrix math of point_cloud.cpp:213-296 (scan straight from
the disparity map): (X, Y, Z) = dehomogenized Q @ [u, v, d, 1], then
XR @ p + XT, in float32, each product and sum rounded on its own. The
live-extrinsics mode (-m) composes XR and XT on the host in float64, and
the confidence experiment projects robot points to pixels there
(robot_to_cam_pixel).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def compose_rotation_cam_to_robot(x: float, y: float, z: float) -> np.ndarray:
    """Euler XYZ -> rotation, Z*Y*X composition (point_cloud.cpp:77-98),
    for the live-extrinsics mode's PHI_X/Y/Z sliders. Each elementary
    matrix is built from the float32-cast angle, as the reference does."""
    x, y, z = np.float32(x), np.float32(y), np.float32(z)
    cx, sx = math.cos(x), math.sin(x)
    cy, sy = math.cos(y), math.sin(y)
    cz, sz = math.cos(z), math.sin(z)
    X = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float64)
    Y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float64)
    Z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float64)
    return Z @ Y @ X


def compose_translation_cam_to_robot(x: float, y: float, z: float
                                     ) -> np.ndarray:
    """point_cloud.cpp:100-102: the float32-cast translation, as float64."""
    return np.array([np.float32(x), np.float32(y), np.float32(z)],
                    dtype=np.float64)


def _keep(t):
    return t


def _row(M, i, a, b, c, e, f=_keep):
    """M[i, 0] * a + M[i, 1] * b + M[i, 2] * c + e, each product and sum
    passed through f."""
    return f(f(f(f(M[i, 0] * a) + f(M[i, 1] * b)) + f(M[i, 2] * c)) + e)


def reproject_Q(u, v, d, Q, f=_keep) -> Tuple[torch.Tensor, ...]:
    """(X,Y,Z) = dehomogenized Q @ [u,v,d,1] (point_cloud.cpp:237-244);
    f is applied to Q and to every product, sum and quotient (the identity,
    or ops/convert.ftz)."""
    Q = f(Q)
    w = _row(Q, 3, u, v, d, Q[3, 3], f)
    return tuple(f(_row(Q, i, u, v, d, Q[i, 3], f) / w) for i in range(3))


def cam_to_robot(X, Y, Z, XR, XT, f=_keep) -> Tuple[torch.Tensor, ...]:
    """point3d_robot = XR @ point3d_cam + XT (point_cloud.cpp:123,250);
    f as reproject_Q's."""
    XR, XT = f(XR), f(XT)
    return tuple(_row(XR, i, X, Y, Z, XT[i], f) for i in range(3))


def robot_to_cam_pixel(pts_robot: np.ndarray, XR: np.ndarray, XT: np.ndarray,
                       P: np.ndarray) -> np.ndarray:
    """Forward projection robot -> camera -> pixel in float64 on the host
    (confidence_checks.cpp:122-132). pts_robot: [..., 3]. Returns int64
    pixel coordinates [..., 2], truncated like the reference's int cast."""
    XR = np.asarray(XR, np.float64)
    XT = np.asarray(XT, np.float64).reshape(3)
    P = np.asarray(P, np.float64)
    cam = (np.asarray(pts_robot, np.float64) - XT) @ np.linalg.inv(XR).T
    hom = np.concatenate([cam, np.ones_like(cam[..., :1])], axis=-1)
    img = hom @ P.T
    return (img[..., :2] / img[..., 2:3]).astype(np.int64)


def reproject_disparity_to_robot(
    disp: torch.Tensor, Q: torch.Tensor, XR: torch.Tensor, XT: torch.Tensor,
    crop_offset_x: int = 0, crop_offset_y: int = 0, f=_keep,
) -> Tuple[torch.Tensor, ...]:
    """Robot-frame (X, Y, Z) float32 [..., H, W] of every pixel of a
    disparity map; pixel coordinates are offset by the crop origin like
    point_cloud.cpp:237-239. f as reproject_Q's: ops/convert.ftz computes
    the jitted reference's flushes (the scan from a map), the identity
    IEEE subnormals (the cloud)."""
    H, W = disp.shape[-2:]
    dev = disp.device
    f32 = torch.float32
    u = (torch.arange(W, dtype=f32, device=dev) + crop_offset_x)[None, :]
    v = (torch.arange(H, dtype=f32, device=dev) + crop_offset_y)[:, None]
    X, Y, Z = reproject_Q(u, v, disp.to(f32), Q.to(f32), f)
    return cam_to_robot(X, Y, Z, XR.to(f32), XT.to(f32), f)
