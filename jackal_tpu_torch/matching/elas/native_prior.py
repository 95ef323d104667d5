"""Host prior in C++: support pruning, plane fit, raster, grid, speckle.

Same contract as the reference's elas.cpp host stages, with the sequential
pruning, plane fit, rasterization, plane-map evaluation, candidate-grid
build and BFS speckle removal in C++ (native/prior_engine.cpp), reached
through ctypes. Triangulation is prior.delaunay. The batched path uses
only the pruning, the triangulation and the triangle wire
(native/wire_engine.cpp); build_grid_native and fit_planes_native are
the references its device grid and plane fit are held to.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ...config import ElasParams
from ...native import load as load_native
from .post import speckle_size_eff
from .prior import PlaneMaps, delaunay
from .support import add_corner_support_points, effective_stepsize


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def remove_small_segments_native(
    D: np.ndarray, params: ElasParams = ElasParams()
) -> np.ndarray:
    """Exact BFS speckle removal (elas.cpp:981-1099) in C++."""
    lib = load_native()
    a = np.ascontiguousarray(D, np.float32).copy()
    H, W = a.shape
    lib.remove_small_segments_native(
        _ptr(a, ctypes.c_float), W, H,
        ctypes.c_float(params.speckle_sim_threshold),
        speckle_size_eff(params))
    return a


def collect_support_points_native(
    D_can: np.ndarray, params: ElasParams = ElasParams(),
    width: int = 0, height: int = 0,
) -> np.ndarray:
    """Prune the candidate grid in scan order (elas.cpp:153-235) and
    collect (u, v, d) support points in reference vector order."""
    lib = load_native()
    D = np.ascontiguousarray(D_can, dtype=np.int16).copy()
    ncv, ncu = D.shape
    lib.prune_support(
        _ptr(D, ctypes.c_int16), ncv, ncu,
        params.incon_window_size, params.incon_threshold,
        params.incon_min_support, 5, 1)
    out = np.zeros((ncv * ncu, 3), np.int32)
    n = lib.collect_support(
        _ptr(D, ctypes.c_int16), ncv, ncu, effective_stepsize(params),
        _ptr(out, ctypes.c_int32), ncv * ncu)
    sp = out[:n]
    if params.add_corners and width and height:
        sp = add_corner_support_points(sp, width, height)
    return np.ascontiguousarray(sp, np.int32)


def build_grid_native(
    support: np.ndarray, width: int, height: int, right: bool,
    params: ElasParams = ElasParams(),
) -> np.ndarray:
    """Candidate grid (createGrid, elas.cpp:579-659) alone, bool
    [gh, gw, disp_max+1]."""
    lib = load_native()
    sp = np.ascontiguousarray(support, np.int32)
    gs = params.grid_size
    gw = -(-width // gs)
    gh = -(-height // gs)
    grid = np.zeros((gh, gw, params.disp_max + 1), np.uint8)
    lib.build_grid(_ptr(sp, ctypes.c_int32), len(sp), width, height,
                   int(right), gs, params.disp_max,
                   _ptr(grid, ctypes.c_uint8))
    return grid.astype(bool)


def tri_wire_and_bin_native(
    support: np.ndarray, tri: np.ndarray, W: int, H: int,
    slab: int, ctile: int, right: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """device_prior.tri_wire + slab_select in one C++ pass
    (native/wire_engine.cpp): (tri_sorted int16 [T, 3], paint int16 [T],
    sel int16 [S*C, Ts], -1 padded)."""
    lib = load_native()
    T = len(tri)
    S = -(-H // slab)
    C = -(-W // ctile)
    if T == 0:
        return (np.zeros((0, 3), np.int16), np.zeros((0,), np.int16),
                np.full((S * C, 1), -1, np.int16))
    sp = np.ascontiguousarray(support, np.int16)
    tr = np.ascontiguousarray(tri, np.int32)
    tri_out = np.empty((T, 3), np.int16)
    paint = np.empty((T,), np.int16)
    cap = 48
    while True:
        sel = np.empty((S * C, cap), np.int16)
        got = lib.tri_wire_and_bin(
            _ptr(sp, ctypes.c_int16), len(sp), _ptr(tr, ctypes.c_int32), T,
            W, H, slab, ctile, int(right), cap,
            _ptr(tri_out, ctypes.c_int16), _ptr(paint, ctypes.c_int16),
            _ptr(sel, ctypes.c_int16))
        if got <= cap:
            return tri_out, paint, sel[:, :max(got, 1)]
        cap = got


def fit_planes_native(support: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Per-triangle plane fit [T, 6] float32 (t1a, t1b, t1c, t2a, t2b,
    t2c) by the C++ full-pivot solve (prior_engine.cpp fit_planes)."""
    lib = load_native()
    sp = np.ascontiguousarray(support, np.int32)
    tri = np.ascontiguousarray(tri, np.int32)
    t = len(tri)
    planes = np.zeros((max(t, 1), 6), np.float32)
    if t:
        lib.fit_planes(_ptr(sp, ctypes.c_int32), len(sp),
                       _ptr(tri, ctypes.c_int32), t,
                       _ptr(planes, ctypes.c_float))
    return planes[:t]


def build_priors_native(
    support: np.ndarray, width: int, height: int,
    params: ElasParams = ElasParams(),
    tri_left: Optional[np.ndarray] = None,
    tri_right: Optional[np.ndarray] = None,
) -> Tuple[PlaneMaps, PlaneMaps, np.ndarray, np.ndarray]:
    """Plane maps + candidate grids [gh, gw, disp_max+1] for both images.

    d_plane is clipped to int16 [-512, 511]: values outside behave
    identically in the matcher (the +/-plane_radius window and the prior
    selects saturate)."""
    lib = load_native()
    sp = np.ascontiguousarray(support, np.int32)
    n = len(sp)
    left_pts = sp[:, :2].astype(np.float32)
    right_pts = np.stack([sp[:, 0] - sp[:, 2], sp[:, 1]], -1).astype(np.float32)
    t1 = (delaunay(left_pts) if tri_left is None else tri_left)
    t2 = (delaunay(right_pts) if tri_right is None else tri_right)
    t1 = np.ascontiguousarray(t1, np.int32)
    t2 = np.ascontiguousarray(t2, np.int32)

    gs = params.grid_size
    gw = -(-width // gs)
    gh = -(-height // gs)
    D = params.disp_max + 1

    results = []
    for tri, right in ((t1, 0), (t2, 1)):
        t = len(tri)
        planes = np.zeros((max(t, 1), 6), np.float32)
        if t:
            lib.fit_planes(_ptr(sp, ctypes.c_int32), n,
                           _ptr(tri, ctypes.c_int32), t,
                           _ptr(planes, ctypes.c_float))
        tri_id = np.empty((height, width), np.int32)
        lib.rasterize(_ptr(sp, ctypes.c_int32), n,
                      _ptr(tri, ctypes.c_int32), t,
                      width, height, right, _ptr(tri_id, ctypes.c_int32))
        d_plane = np.empty((height, width), np.int32)
        valid = np.empty((height, width), np.uint8)
        covered = np.empty((height, width), np.uint8)
        lib.plane_maps(_ptr(tri_id, ctypes.c_int32),
                       _ptr(planes, ctypes.c_float), t,
                       width, height, right,
                       _ptr(d_plane, ctypes.c_int32),
                       _ptr(valid, ctypes.c_uint8),
                       _ptr(covered, ctypes.c_uint8))
        grid = np.zeros((gh, gw, D), np.uint8)
        lib.build_grid(_ptr(sp, ctypes.c_int32), n, width, height, right,
                       gs, params.disp_max, _ptr(grid, ctypes.c_uint8))
        maps = PlaneMaps(
            tri_id=tri_id,
            d_plane=np.clip(d_plane, -512, 511).astype(np.int16),
            valid=valid.astype(bool))
        results.append((maps, grid.astype(bool)))
    (m1, g1), (m2, g2) = results
    return m1, m2, g1, g2
