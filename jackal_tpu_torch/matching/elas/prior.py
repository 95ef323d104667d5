"""ELAS prior: Delaunay triangulation and the dense plane maps (host side).

Reference: computeDelaunayTriangulation (elas.cpp:445-505, Shewchuk
"triangle" with switches "zQB"), computeDisparityPlanes (507-577),
createGrid (579-659) and the scanline rasterization inside
computeDisparity (813-904). Support points are ~100-2000 per frame;
triangulation and rasterization are irregular work that stays on the host
in the C++ engine (native/), whose dense outputs feed the dense kernel.
build_priors and its parts (compute_disparity_planes, rasterize_planes,
create_grid) are the reference package's numpy prior, copied:
elas_match(..., use_native=False) runs them instead of the C++ engine.

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
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay as _SciDelaunay
from scipy.spatial import QhullError

from ...config import ElasParams
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


def create_grid(
    support: np.ndarray, width: int, height: int, right_image: bool,
    params: ElasParams = ElasParams(),
) -> np.ndarray:
    """createGrid (elas.cpp:579-659): the candidate disparities of each
    grid cell, bool [gh, gw, disp_max+1]: each support point marks d-1..d+1
    in its cell, then a 3x3 OR over the flat cell array (stride gw, so it
    wraps across grid rows, as the reference's does) fills cells
    [gw+1, gw*gh-gw-1)."""
    gs = params.grid_size
    gw = int(np.ceil(width / gs))
    gh = int(np.ceil(height / gs))
    D = params.disp_max + 1
    temp1 = np.zeros((gh * gw, D), dtype=bool)
    for u, v, d in support:
        d_min = max(d - 1, 0)
        d_max = min(d + 1, params.disp_max)
        if right_image:
            x = int(np.floor(float(u - d) / gs))
        else:
            x = int(np.floor(float(int(u) // gs)))
        y = int(np.floor(float(v) / gs))
        if 0 <= x < gw and 0 <= y < gh:
            temp1[y * gw + x, d_min:d_max + 1] = True
    temp2 = np.zeros_like(temp1)
    n = gh * gw
    acc = np.zeros((n - 2 * gw - 2, D), dtype=bool)
    for off in (0, 1, 2, gw, gw + 1, gw + 2, 2 * gw, 2 * gw + 1, 2 * gw + 2):
        acc |= temp1[off:off + n - 2 * gw - 2]
    temp2[gw + 1:n - gw - 1] = acc
    return temp2.reshape(gh, gw, D)


def grid_mask_to_reference_lists(mask: np.ndarray) -> np.ndarray:
    """A [gh, gw, D] candidate mask in the reference's int32 layout
    [gh, gw, D+1]: the count, then the candidates ascending, zero-padded."""
    gh, gw, D = mask.shape
    out = np.zeros((gh, gw, D + 1), np.int32)
    for y in range(gh):
        for x in range(gw):
            ds = np.nonzero(mask[y, x])[0]
            out[y, x, 0] = len(ds)
            out[y, x, 1:1 + len(ds)] = ds
    return out


def _u32_trunc(x: np.ndarray) -> np.ndarray:
    """The (int32)(uint32)(float) casts of the scanline v bounds
    (elas.cpp:878-879): truncation, then the uint32 wrap."""
    t = np.trunc(np.asarray(x, np.float64)).astype(np.int64)
    return (t & 0xFFFFFFFF).astype(np.uint32).astype(np.int64)


def pack_prior_wire(maps: PlaneMaps, grid: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One int16 word a pixel, d_plane + 512 in bits 0-9, plane valid in
    bit 10, covered in bit 11, and the candidate grid packed 8 disparities
    a byte (little bit order): the reference package's upload format."""
    dp = np.asarray(maps.d_plane, np.int16).astype(np.int32)
    wire = (dp + 512) & 0x3FF
    wire |= maps.valid.astype(np.int32) << 10
    wire |= (np.asarray(maps.tri_id) >= 0).astype(np.int32) << 11
    gridp = np.packbits(np.asarray(grid, bool), axis=-1, bitorder="little")
    return wire.astype(np.int16), gridp


def _plane_d(pa, pb, pc, H: int, W: int) -> np.ndarray:
    """(int)(a*u + b*v + c) per pixel in float32, each product and sum
    rounded on its own, clipped to the int16 wire's [-512, 511]."""
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    f = (pa * u).astype(np.float32) + (pb * v).astype(np.float32)
    dp = (f + pc).astype(np.float32).astype(np.int64)
    return np.clip(dp, -512, 511).astype(np.int16)


def rasterize_planes(
    support: np.ndarray, tri: np.ndarray, planes: np.ndarray,
    width: int, height: int, right_image: bool,
) -> PlaneMaps:
    """The scanline rasterization of computeDisparity (elas.cpp:813-904):
    triangles in order, a later one overwriting shared pixels, with the
    reference's float32 line arithmetic, its literal corner sort and its
    (uint32)(float) v bounds. d_plane is the covering triangle's plane
    (columns 3-5 of ``planes`` for the right image) evaluated as
    _plane_d does, 0 where no triangle covers the pixel."""
    tri_id = np.full((height, width), -1, np.int32)
    s = support.astype(np.float32)
    for i in range(len(tri)):
        c1, c2, c3 = tri[i]
        if right_image:
            tu = [s[c1, 0] - s[c1, 2], s[c2, 0] - s[c2, 2],
                  s[c3, 0] - s[c3, 2]]
        else:
            tu = [s[c1, 0], s[c2, 0], s[c3, 0]]
        tu = [np.float32(x) for x in tu]
        tv = [s[c1, 1], s[c2, 1], s[c3, 1]]
        # elas.cpp:847-854: pairwise strict-> swaps, not a stable sort
        for j in range(3):
            for k in range(j):
                if tu[k] > tu[j]:
                    tu[j], tu[k] = tu[k], tu[j]
                    tv[j], tv[k] = tv[k], tv[j]
        A_u, B_u, C_u = float(tu[0]), float(tu[1]), float(tu[2])
        A_v, B_v, C_v = float(tv[0]), float(tv[1]), float(tv[2])
        AB_a = np.float32(0.0)
        AC_a = np.float32(0.0)
        BC_a = np.float32(0.0)
        if int(A_u) != int(B_u):
            AB_a = np.float32(A_v - B_v) / np.float32(A_u - B_u)
        if int(A_u) != int(C_u):
            AC_a = np.float32(A_v - C_v) / np.float32(A_u - C_u)
        if int(B_u) != int(C_u):
            BC_a = np.float32(B_v - C_v) / np.float32(B_u - C_u)
        AB_b = np.float32(A_v) - AB_a * np.float32(A_u)
        AC_b = np.float32(A_v) - AC_a * np.float32(A_u)
        BC_b = np.float32(B_v) - BC_a * np.float32(B_u)
        for u0, u1, a2, b2 in ((int(A_u), int(B_u), AB_a, AB_b),
                               (int(B_u), int(C_u), BC_a, BC_b)):
            if u0 == u1:
                continue
            us = np.arange(max(u0, 0), min(u1, width))
            if len(us) == 0:
                continue
            usf = us.astype(np.float32)
            v1 = _u32_trunc(AC_a * usf + AC_b)
            v2 = _u32_trunc(a2 * usf + b2)
            lo = np.clip(np.minimum(v1, v2), 0, height)
            hi = np.clip(np.maximum(v1, v2), 0, height)
            for j, u in enumerate(us):
                if hi[j] > lo[j]:
                    tri_id[lo[j]:hi[j], u] = i
    if len(tri) == 0:
        return PlaneMaps(tri_id, np.zeros((height, width), np.int16),
                         np.zeros((height, width), bool))
    k = 3 if right_image else 0
    pa, pb, pc = planes[:, k], planes[:, k + 1], planes[:, k + 2]
    pother = planes[:, 3 - k]
    tid = np.clip(tri_id, 0, None)
    covered = tri_id >= 0
    valid_tri = (np.abs(pa) < 0.7) & (np.abs(pother) < 0.7)  # elas.cpp:872

    def at(x):
        return np.where(covered, x[tid], 0).astype(np.float32)
    return PlaneMaps(tri_id=tri_id,
                     d_plane=_plane_d(at(pa), at(pb), at(pc), height, width),
                     valid=covered & valid_tri[tid])


def build_priors(
    support: np.ndarray, width: int, height: int,
    params: ElasParams = ElasParams(),
    tri_left: Optional[np.ndarray] = None,
    tri_right: Optional[np.ndarray] = None,
) -> Tuple[PlaneMaps, PlaneMaps, np.ndarray, np.ndarray]:
    """The numpy host prior of one frame, build_priors_native's contract:
    plane maps and candidate grids of both images. tri_left / tri_right
    override the triangulation."""
    left_pts = support[:, :2].astype(np.float32)
    right_pts = np.stack([support[:, 0] - support[:, 2], support[:, 1]],
                         axis=-1).astype(np.float32)
    t1 = delaunay(left_pts) if tri_left is None else tri_left
    t2 = delaunay(right_pts) if tri_right is None else tri_right
    maps1 = rasterize_planes(support, t1, compute_disparity_planes(
        support, t1), width, height, False)
    maps2 = rasterize_planes(support, t2, compute_disparity_planes(
        support, t2), width, height, True)
    return (maps1, maps2, create_grid(support, width, height, False, params),
            create_grid(support, width, height, True, params))
