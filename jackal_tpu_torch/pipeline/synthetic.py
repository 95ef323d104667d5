"""Seeded raw stereo pairs of a known scene, for smoke runs and tests.

The scene is a textured surface whose disparity in the rectified images is
d(v) = disparity + slope * v (a ground-like slant; slope 0 is a
fronto-parallel wall). Each raw pixel is mapped to its rectified position
with the calibration (undistort + R_i + P_i), and the texture is sampled
there: the left view at (u, v), the right view at (u + d(v), v). So the
pipeline's rectification brings the pair back to a row-aligned stereo
pair with that disparity, as a real camera pair would give.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..geometry.rectify import undistort_points


def _value_noise(grid: np.ndarray, x: np.ndarray, y: np.ndarray,
                 cell: float) -> np.ndarray:
    """Bilinear interpolation of a random grid at continuous (x, y)."""
    gx = np.clip(x / cell, 0, grid.shape[1] - 1.001)
    gy = np.clip(y / cell, 0, grid.shape[0] - 1.001)
    x0, y0 = gx.astype(np.int64), gy.astype(np.int64)
    fx, fy = gx - x0, gy - y0
    top = grid[y0, x0] * (1 - fx) + grid[y0, x0 + 1] * fx
    bot = grid[y0 + 1, x0] * (1 - fx) + grid[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def synthetic_raw_pair(pipe, seed: int, disparity: float,
                       slope: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Raw uint8 [H, W] left/right frames at the calibration's image size
    for StereoPipeline ``pipe``."""
    rng = np.random.default_rng(seed)
    W, H = pipe.p.calib_im_size
    Wr, Hr = pipe.p.im_width, pipe.p.im_height
    cell = max(Wr / 200.0, 1.0)       # texture scale in rectified pixels
    margin = 4 * Wr
    grid = rng.random((int((3 * Hr) / cell) + 4, int((Wr + 2 * margin) / cell) + 4))
    fine = rng.random((int((3 * Hr) / cell * 4) + 4,
                       int((Wr + 2 * margin) / cell * 4) + 4))
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    raw = np.stack([xs, ys], -1)
    c, r = pipe.calib, pipe.rect
    out = []
    for K, Dc, R, P, right in ((c.K1, c.D1, r.R1, r.P1, False),
                               (c.K2, c.D2, r.R2, r.P2, True)):
        uv = undistort_points(raw, K, Dc, R, P)
        u, v = uv[..., 0], uv[..., 1]
        if right:
            u = u + disparity + slope * v
        x, y = u + margin, v + Hr
        tex = (0.6 * _value_noise(grid, x, y, cell)
               + 0.4 * _value_noise(fine, x, y, cell / 4))
        out.append(np.clip(tex * 255.0, 0, 255).astype(np.uint8))
    return out[0], out[1]
