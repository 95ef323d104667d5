"""Native (C++) host prior engine, loaded through ctypes.

The library builds at first use with g++ into the package's _build/
(see build.py), named by a hash of its sources. -ffp-contract=off keeps
the float32 plane evaluation and raster tie-breaks equal to the reference.

The library is built from the same three sources as the reference's.
wire_engine.cpp (tri_wire_and_bin, flatten_chunk_wire) serves the batched
path: the per-frame triangle wire with its slab binning, and one chunk's
flat int32 wire (matching/elas/pipeline.py).
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

from ..build import Library, build

_DIR = os.path.dirname(os.path.abspath(__file__))
LIBRARY = Library(
    name="jackal_prior",
    compiler="g++",
    flags=("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"),
    sources=tuple(os.path.join(_DIR, f) for f in (
        "prior_engine.cpp", "delaunay_engine.cpp", "wire_engine.cpp")),
)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native prior engine."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build([LIBRARY])[0])
        c_i16p = ctypes.POINTER(ctypes.c_int16)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        i = ctypes.c_int
        lib.prune_support.argtypes = [c_i16p, i, i, i, i, i, i, i]
        lib.collect_support.argtypes = [c_i16p, i, i, i, c_i32p, i]
        lib.collect_support.restype = i
        lib.fit_planes.argtypes = [c_i32p, i, c_i32p, i, c_f32p]
        lib.rasterize.argtypes = [c_i32p, i, c_i32p, i, i, i, i, c_i32p]
        lib.plane_maps.argtypes = [c_i32p, c_f32p, i, i, i, i,
                                   c_i32p, c_u8p, c_u8p]
        lib.build_grid.argtypes = [c_i32p, i, i, i, i, i, i, c_u8p]
        lib.remove_small_segments_native.argtypes = [
            c_f32p, i, i, ctypes.c_float, i]
        lib.delaunay_exact.argtypes = [c_f32p, i, c_i32p, i, i]
        lib.delaunay_exact.restype = i
        lib.tri_wire_and_bin.argtypes = [
            c_i16p, i, c_i32p, i, i, i, i, i, i, i,
            c_i16p, c_i16p, c_i16p]
        lib.tri_wire_and_bin.restype = i
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        lib.flatten_chunk_wire.argtypes = [
            c_i64p, c_i32p, c_i64p, c_i64p, c_i32p, c_i64p, c_i32p,
            i, i, i, i, i, c_i16p]
        _lib = lib
        return lib
