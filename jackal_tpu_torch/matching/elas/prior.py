"""ELAS prior: Delaunay triangulation and the dense plane maps (host side).

Reference: computeDelaunayTriangulation (elas.cpp:445-505, Shewchuk
"triangle" with switches "zQB") and the scanline rasterization inside
computeDisparity (813-904). Support points are ~100-2000 per frame;
triangulation and rasterization are irregular work that stays on the host
in the C++ engine (native/), whose dense outputs feed the dense kernel.

Delaunay: the first-party native triangulator (native/delaunay_engine.cpp,
Guibas-Stolfi divide-and-conquer with Dwyer alternating cuts and EXACT
integer predicates) is the default. Its triangle SETS match the reference
triangulator's, including on co-circular 5-px support lattices. scipy
(Qhull) remains for non-integral coordinates, where Qhull's co-circular
diagonal choices can differ from the reference.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
from scipy.spatial import Delaunay as _SciDelaunay
from scipy.spatial import QhullError

from ...native import load as load_native


def _delaunay_native(pts_f32: np.ndarray):
    """Exact-arithmetic native triangulation; None if not applicable
    (non-integral coords fall back to Qhull)."""
    lib = load_native()
    pts = np.ascontiguousarray(pts_f32, np.float32)
    max_tri = 3 * len(pts) + 16
    out = np.zeros((max_tri, 3), np.int32)
    n = lib.delaunay_exact(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_tri, 1)
    if n < 0:
        return None
    return out[:n]


def delaunay(points_uv: np.ndarray) -> np.ndarray:
    """Triangle index list [T, 3] over 2D points (float32 coords like the
    reference, elas.cpp:453-465)."""
    pts = np.asarray(points_uv, dtype=np.float32)
    if len(pts) < 3:
        return np.zeros((0, 3), np.int32)
    tri = _delaunay_native(pts)
    if tri is not None:
        return tri
    try:
        tri = _SciDelaunay(pts.astype(np.float64))
    except QhullError:
        return np.zeros((0, 3), np.int32)
    return tri.simplices.astype(np.int32)


def compute_disparity_planes(support: np.ndarray, tri: np.ndarray
                             ) -> np.ndarray:
    """Per-triangle plane params [T, 6] float32 (t1a, t1b, t1c, t2a, t2b,
    t2c) by numpy's float64 solve: t1 fitted on the left coordinates, t2
    on the right ones (u - d); singular systems give zeros (elas.cpp:
    543-547). The batched path and the C++ prior fit by full pivoting
    instead (native_prior.fit_planes_native), which rounds differently."""
    if len(tri) == 0:
        return np.zeros((0, 6), np.float32)
    s = support.astype(np.float64)
    out = np.zeros((len(tri), 6), np.float32)
    for k, right in ((0, False), (3, True)):
        u = s[tri, 0] - (s[tri, 2] if right else 0.0)      # [T, 3]
        v = s[tri, 1]
        b = s[tri, 2]
        A = np.stack([u, v, np.ones_like(u)], axis=-1)      # [T, 3, 3]
        ok = np.abs(np.linalg.det(A)) > 1e-12
        sol = np.zeros((len(tri), 3))
        if ok.any():
            sol[ok] = np.linalg.solve(A[ok], b[ok][..., None])[..., 0]
        out[:, k:k + 3] = sol.astype(np.float32)
    return out


@dataclasses.dataclass
class PlaneMaps:
    """Dense per-pixel prior for the dense matcher."""

    tri_id: np.ndarray    # [H, W] int32, -1 where no triangle rasterized
    d_plane: np.ndarray   # [H, W] int16, (int)(a*u + b*v + c) clipped
    valid: np.ndarray     # [H, W] bool: |a|<0.7 and |a_other|<0.7
