"""Stereo match confidence experiment (confidence_checks.cpp's
counterpart).

The reference (confidence_checks.cpp, commented out of its build) computes
dense descriptors and the window-averaged L1 descriptor cost between the
projections of candidate waypoints into the left and right images, and
flags the low-confidence ones. As in the reference package, the
descriptor is ELAS's 16-channel one (ops/descriptor.py) and the cost a
batched gather and reduction on the images' device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..geometry.reproject import robot_to_cam_pixel
from ..ops.descriptor import create_descriptor


def desc_cost(desc_left: torch.Tensor, desc_right: torch.Tensor,
              pts_left: np.ndarray, pts_right: np.ndarray, w: int = 1
              ) -> np.ndarray:
    """Window-averaged L1 descriptor cost of each point pair
    (confidence_checks.cpp:77-96): descriptors [H, W, C], points [N, 2]
    (u, v). Returns int32 [N] on the host."""
    dev = desc_left.device
    H, W, _ = desc_left.shape
    rows = torch.clamp(torch.arange(-w, H + w, device=dev), 0, H - 1)
    cols = torch.clamp(torch.arange(-w, W + w, device=dev), 0, W - 1)
    dl = desc_left.to(torch.int32)[rows][:, cols]
    dr = desc_right.to(torch.int32)[rows][:, cols]
    ul, vl, ur, vr = (torch.as_tensor(np.asarray(a), dtype=torch.int64
                                      ).to(dev) + w
                      for a in (pts_left[:, 0], pts_left[:, 1],
                                pts_right[:, 0], pts_right[:, 1]))
    total = torch.zeros(len(pts_left), dtype=torch.int32, device=dev)
    for dv in range(-w, w + 1):
        for du in range(-w, w + 1):
            a = dl[vl + dv, ul + du]
            b = dr[vr + dv, ur + du]
            total = total + (a - b).abs().sum(-1, dtype=torch.int32)
    return (total // ((2 * w + 1) ** 2)).cpu().numpy()


def cache_waypoint_coords(XR: np.ndarray, XT: np.ndarray, P1: np.ndarray,
                          P2: np.ndarray, x_range=(0.6, 1.8, 0.03),
                          y_range=(-0.2, 0.2, 0.03)
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """A ground grid of candidate waypoints projected into both cameras
    (confidence_checks.cpp:168-177), on the host in float64."""
    xs = np.arange(x_range[0], x_range[1] + 1e-9, x_range[2])
    ys = np.arange(y_range[0], y_range[1] + 1e-9, y_range[2])
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=-1)
    return (robot_to_cam_pixel(pts, XR, XT, P1),
            robot_to_cam_pixel(pts, XR, XT, P2))


def confidence_check(left_u8, right_u8, pts_left: np.ndarray,
                     pts_right: np.ndarray, w: int = 1,
                     threshold: int = 400, device: DeviceLike = None
                     ) -> np.ndarray:
    """Low-confidence flags of point pairs (cost >= threshold; False out
    of the frame), on ``device`` (the card unless "cpu"). The reference
    used 2000 on 32-byte ORB rows (confidence_checks.cpp:141); 400 is the
    reference package's equivalent for the 16-channel descriptor."""
    dev = resolve_device(device)
    H, W = np.shape(left_u8)
    desc = create_descriptor(torch.stack([torch.as_tensor(left_u8),
                                          torch.as_tensor(right_u8)]).to(dev))
    inb = ((pts_left[:, 0] >= 0) & (pts_left[:, 0] < W)
           & (pts_left[:, 1] >= 0) & (pts_left[:, 1] < H)
           & (pts_right[:, 0] >= 0) & (pts_right[:, 0] < W)
           & (pts_right[:, 1] >= 0) & (pts_right[:, 1] < H))
    pl = np.where(inb[:, None], pts_left, 0)
    pr = np.where(inb[:, None], pts_right, 0)
    return inb & (desc_cost(desc[0], desc[1], pl, pr, w) >= threshold)
