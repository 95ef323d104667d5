"""Disparity -> 3D reprojection and the camera->robot transform.

The per-pixel Q-matrix math of point_cloud.cpp:213-296 (scan straight from
the disparity map): (X, Y, Z) = dehomogenized Q @ [u, v, d, 1], then
XR @ p + XT, in float32, each product and sum rounded on its own.
"""
from __future__ import annotations

from typing import Tuple

import torch


def reproject_Q(u, v, d, Q) -> Tuple[torch.Tensor, ...]:
    """(X,Y,Z) = dehomogenized Q @ [u,v,d,1] (point_cloud.cpp:237-244)."""
    w = Q[3, 0] * u + Q[3, 1] * v + Q[3, 2] * d + Q[3, 3]
    X = (Q[0, 0] * u + Q[0, 1] * v + Q[0, 2] * d + Q[0, 3]) / w
    Y = (Q[1, 0] * u + Q[1, 1] * v + Q[1, 2] * d + Q[1, 3]) / w
    Z = (Q[2, 0] * u + Q[2, 1] * v + Q[2, 2] * d + Q[2, 3]) / w
    return X, Y, Z


def cam_to_robot(X, Y, Z, XR, XT) -> Tuple[torch.Tensor, ...]:
    """point3d_robot = XR @ point3d_cam + XT (point_cloud.cpp:123,250)."""
    Xr = XR[0, 0] * X + XR[0, 1] * Y + XR[0, 2] * Z + XT[0]
    Yr = XR[1, 0] * X + XR[1, 1] * Y + XR[1, 2] * Z + XT[1]
    Zr = XR[2, 0] * X + XR[2, 1] * Y + XR[2, 2] * Z + XT[2]
    return Xr, Yr, Zr


def reproject_disparity_to_robot(
    disp: torch.Tensor, Q: torch.Tensor, XR: torch.Tensor, XT: torch.Tensor,
    crop_offset_x: int = 0, crop_offset_y: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Robot-frame (X, Y, Z) float32 [..., H, W] of every pixel of a
    disparity map; pixel coordinates are offset by the crop origin like
    point_cloud.cpp:237-239."""
    H, W = disp.shape[-2:]
    dev = disp.device
    f32 = torch.float32
    u = (torch.arange(W, dtype=f32, device=dev) + crop_offset_x)[None, :]
    v = (torch.arange(H, dtype=f32, device=dev) + crop_offset_y)[:, None]
    X, Y, Z = reproject_Q(u, v, disp.to(f32), Q.to(f32))
    return cam_to_robot(X, Y, Z, XR.to(f32), XT.to(f32))
