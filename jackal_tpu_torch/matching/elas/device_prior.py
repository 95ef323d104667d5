"""ELAS prior maps on the device: coefficients, candidate grids, raster.

The batched path sends the card only the support points, the triangles'
vertex indices and each image tile's triangle list (the chunk wire,
pipeline.py). From those the device computes, bit-equal to the C++ host
prior (native/prior_engine.cpp) and to the reference's elas.cpp:

  _tri_coeffs_impl  per triangle: the reference's corner sort, the three
                    edge slopes (float32 quotients of small integers,
                    correctly rounded on the CPU and the card), the plane
                    fit in float64 (device_fit.py) and the plane-valid flag;
  _grid_impl        createGrid (elas.cpp:579-659): candidate marking, the
                    d+/-1 marks and the flat 3x3 OR diffusion;
  coeff_grid        kernels M1 and M2 (csrc/prior_kernel.cu) in one
                    launch on a chunk wire: M1's _tri_coeffs_impl of both
                    sides' triangles packed as pack_table rows and the tile
                    lists widened to int32 (coeff_table_plain), M2's
                    _grid_impl of both sides packed as pack_grid_device
                    words (grid_words_plain); coeff_grid_plain, the two
                    plain versions, on CPU tensors;
  raster_maps       the scanline rasterization of computeDisparity
                    (elas.cpp:813-904) as a slab raster: per 16-row x
                    128-column tile, the maximum over the tile's triangles
                    of the packed winner key
                        (paint << 11) | ((trunc(f) + 512) << 1) | pvalid,
                    f = (pa*u + pb*v) + pc, so the last-painted triangle
                    wins and carries its plane value (raster_plain), decoded
                    into the dense matcher's (d_plane, valid, covered)
                    maps (decode_win). raster_maps() launches the CUDA
                    kernel (csrc/raster_kernel.cu) once for both sides of a
                    chunk on CUDA tensors; raster_maps_plain() runs
                    decode_win(raster_plain()) a side at a time on CPU
                    tensors.

Every float multiply, add and subtract of the raster is its own eager op
in the plain version and an __fmul_rn/__fadd_rn/__fsub_rn in the kernel,
so nothing is fused into an FMA. Float-to-int conversions that can leave
the int32 range follow XLA's rule (ops/convert.to_int32).

The host side (slab_select, tri_wire, pad_tri_wire) is a numpy copy of
the reference package's; native_prior.tri_wire_and_bin_native is its C++
twin.

The reference package's older coefficient-wire raster is here too, which
no path of either package runs: prior_coeff_wire computes each triangle's
coefficients on the host (numpy), and prior_maps_device rasterizes them
in eager float32 ops, its multiplies (_raster_mul_impl) apart from its
adds (_raster_add_impl), bit-equal to the host rasterizer.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ...device import DeviceLike, as_input
from ...ops import cuda_lib
from ...ops.convert import to_int32
from .prior import compute_disparity_planes

_RASTER_SLAB = 16       # rows of a raster tile
_RASTER_CTILE = 128     # columns of a raster tile
_PAINT_SHIFT = 11       # key's low bits: trunc(f)+512 (10), pvalid (1)
_TABLE_COLS = 16        # pack_table row: A_u B_u C_u A_v B_v, slope bits x3,
#                         plane bits x3, pvalid, paint, 3 zero words

launches = 0            # raster kernel launches (raster_maps calls that
                        # launched it) since the last reset
# launches of kernels M1 and M2's one launch (coeff_grid) since the last
# reset
prior_launches = {"coeff_grid": 0}


# ---------------------------------------------------------------------------
# host: the triangle wire
# ---------------------------------------------------------------------------

def slab_select(support: np.ndarray, tri: np.ndarray, W: int, H: int,
                slab: int, ctile: int, right: bool = False) -> np.ndarray:
    """Bin triangles into (slab-row x ctile-column) tiles: [S*C, Ts] int32
    indices into the triangle wire, -1 padded, band-major (band = s*C + c).

    A triangle's painted rows lie in [vmin, vmax-1]; the bin range starts
    one row above vmin to absorb the slopes' float32 rounding. Columns
    are exact: the raster covers u in [min corner u, max corner u) (right
    image: u - d)."""
    S = -(-H // slab)
    C = -(-W // ctile)
    if len(tri) == 0:
        return np.full((S * C, 1), -1, np.int32)
    v = support[tri, 1].astype(np.int32)
    u = support[tri, 0].astype(np.int32)
    if right:
        u = u - support[tri, 2].astype(np.int32)
    s0 = np.clip((v.min(axis=1) - 1) // slab, 0, S - 1)
    s1 = np.clip(v.max(axis=1) // slab, 0, S - 1)
    c0 = np.clip(u.min(axis=1) // ctile, 0, C - 1)
    c1 = np.clip((np.maximum(u.max(axis=1), 1) - 1) // ctile, 0, C - 1)
    nr = s1 - s0 + 1
    nc = c1 - c0 + 1
    n = nr * nc
    total = int(n.sum())
    tid = np.repeat(np.arange(len(tri), dtype=np.int32), n)
    off = np.repeat(np.cumsum(n) - n, n)
    k = np.arange(total, dtype=np.int32) - off
    ncr = nc[tid]
    band = ((s0[tid] + k // ncr) * C) + (c0[tid] + k % ncr)
    order = np.argsort(band, kind="stable")
    bands = band[order]
    tids = tid[order]
    counts = np.bincount(bands, minlength=S * C)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(total, dtype=np.int64) - starts[bands]
    sel = np.full((S * C, max(int(counts.max()), 1)), -1, np.int32)
    sel[bands, rank] = tids
    return sel


def tri_wire(support: np.ndarray, tri: np.ndarray):
    """Triangle rows ordered by top image row (stable), and each row's
    original index, which is its paint order."""
    if len(tri) == 0:
        return np.zeros((0, 3), np.int16), np.zeros((0,), np.int16)
    vmin = support[tri, 1].min(axis=1)
    o = np.argsort(vmin, kind="stable")
    return (np.ascontiguousarray(tri[o], np.int16), o.astype(np.int16))


def pad_tri_wire(tri: np.ndarray, paint: np.ndarray, Tp: int):
    """Pad to Tp rows. Padded rows index support[0] three times (an empty
    column span) and paint -1, so they never rasterize."""
    T = len(tri)
    if T >= Tp:
        return tri, paint
    return (np.pad(tri, ((0, Tp - T), (0, 0))),
            np.pad(paint, (0, Tp - T), constant_values=-1))


# ---------------------------------------------------------------------------
# device: per-triangle coefficients and candidate grids
# ---------------------------------------------------------------------------

def _corner_sort_dev(tu: torch.Tensor, tv: torch.Tensor):
    """The reference's pairwise swap sequence (elas.cpp:847-854) on integer
    corner coordinates [T, 3]; not a stable sort on ties."""
    cu = [tu[:, 0], tu[:, 1], tu[:, 2]]
    cv = [tv[:, 0], tv[:, 1], tv[:, 2]]
    for j, k in ((1, 0), (2, 0), (2, 1)):
        sw = cu[k] > cu[j]
        for cols in (cu, cv):
            a, b = cols[k], cols[j]
            cols[k] = torch.where(sw, b, a)
            cols[j] = torch.where(sw, a, b)
    return torch.stack(cu, 1), torch.stack(cv, 1)


def _tri_coeffs_impl(support: torch.Tensor, tri: torch.Tensor, right):
    """support [N, 3] int32, tri [T, 3] int32 -> (corners_u [T, 3] int32,
    corners_v [T, 2] int32, slope_bits [T, 3] int32, plane_bits [T, 3]
    int32, pvalid [T] bool). ``right`` is a bool or a per-row bool [T]
    (the batched path computes both images' triangles in one call)."""
    from .device_fit import _fit_planes_impl

    t = tri.long()
    u, v, d = support[:, 0][t], support[:, 1][t], support[:, 2][t]
    if isinstance(right, bool):
        right = torch.full((len(t),), right, dtype=torch.bool,
                           device=support.device)
    tu = torch.where(right[:, None], u - d, u)
    tu, tv = _corner_sort_dev(tu.to(torch.int32), v.to(torch.int32))
    A_u, B_u, C_u = tu[:, 0], tu[:, 1], tu[:, 2]
    A_v, B_v, C_v = tv[:, 0], tv[:, 1], tv[:, 2]

    def slope(dv, du):
        den = torch.where(du == 0, 1, du).to(torch.float32)
        q = dv.to(torch.float32) / den
        return torch.where(du != 0, q, 0.0)

    AC_a = slope(A_v - C_v, A_u - C_u)
    AB_a = slope(A_v - B_v, A_u - B_u)
    BC_a = slope(B_v - C_v, B_u - C_u)

    planes = _fit_planes_impl(support, tri)                  # [T, 6] f32
    pa = torch.where(right, planes[:, 3], planes[:, 0])
    pb = torch.where(right, planes[:, 4], planes[:, 1])
    pc = torch.where(right, planes[:, 5], planes[:, 2])
    pother = torch.where(right, planes[:, 0], planes[:, 3])
    pvalid = (pa.abs() < 0.7) & (pother.abs() < 0.7)
    sbits = torch.stack([AC_a, AB_a, BC_a], 1).view(torch.int32)
    pbits = torch.stack([pa, pb, pc], 1).view(torch.int32)
    return (torch.stack([A_u, B_u, C_u], 1), torch.stack([A_v, B_v], 1),
            sbits, pbits, pvalid)


def _grid_impl(support: torch.Tensor, right: torch.Tensor, *, gs: int,
               gh: int, gw: int, disp_max: int) -> torch.Tensor:
    """createGrid (elas.cpp:579-659) for a batch: support [B, N, 3] int32,
    right [B] bool -> bool [B, gh, gw, disp_max+1]. Rows with d = -1
    (padding) mark nothing. The 3x3 OR diffusion runs over the flat cell
    array with stride gw, so it wraps across grid rows as the reference's
    loop does; border cells stay empty."""
    Bn = support.shape[0]
    D = disp_max + 1
    G = gh * gw
    dev = support.device
    u, v, d = (support[..., i].to(torch.int64) for i in range(3))
    x = torch.div(torch.where(right[:, None], u - d, u), gs,
                  rounding_mode="floor")
    y = torch.div(v, gs, rounding_mode="floor")
    ok = (x >= 0) & (x < gw) & (y >= 0) & (y < gh) & (d >= 0) & (d < D)
    frame = torch.arange(Bn, device=dev)[:, None].expand_as(d)
    # rows that mark nothing go to a spare cell G: a boolean-mask index
    # would read the count back to the host and stall the stream
    base = torch.zeros((Bn, G + 1, D), dtype=torch.bool, device=dev)
    base[frame, torch.where(ok, y * gw + x, G), torch.where(ok, d, 0)] = True
    base = base[:, :G]
    t1 = base.clone()
    t1[..., :-1] |= base[..., 1:]
    t1[..., 1:] |= base[..., :-1]
    m = G - 2 * gw - 2
    out = torch.zeros_like(base)
    if m > 0:
        acc = torch.zeros((Bn, m, D), dtype=torch.bool, device=dev)
        for off in (0, 1, 2, gw, gw + 1, gw + 2,
                    2 * gw, 2 * gw + 1, 2 * gw + 2):
            acc |= t1[:, off:off + m]
        out[:, gw + 1:G - gw - 1] = acc
    return out.reshape(Bn, gh, gw, D)


def pack_grid_device(grid: torch.Tensor) -> torch.Tensor:
    """[..., D] bool candidate sets -> [..., ceil(D/32)] int32 bit words on
    the grid's device (bit k of word w is d = 32w + k; bit 31 is the int32
    sign bit), equal to dense.pack_grid."""
    D = grid.shape[-1]
    nw = -(-D // 32)
    g = torch.nn.functional.pad(grid.to(torch.int64), (0, nw * 32 - D))
    g = g.reshape(*grid.shape[:-1], nw, 32)
    bits = torch.arange(32, device=grid.device, dtype=torch.int64)
    words = (g << bits).sum(-1)                       # [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)


# ---------------------------------------------------------------------------
# device: one chunk's coefficient table and grids from its wire (kernels M1
# and M2, csrc/prior_kernel.cu, and their plain versions)
# ---------------------------------------------------------------------------

def wire_len16(CH: int, Np: int, Tp: int, SC: int, Ts: int) -> int:
    """int16 entries of a chunk wire (pipeline._flatten_chunk_wire):
    support [CH, Np, 3], per side triangles [CH, Tp, 3] and paints
    [CH, Tp], per side tile lists [CH, SC, Ts]."""
    return CH * Np * 3 + 2 * CH * Tp * 4 + 2 * CH * SC * Ts


def _wire16(flat: torch.Tensor, n16: int, what: str) -> torch.Tensor:
    """The wire's first n16 int16 entries; raises unless the int32 wire
    holds them."""
    if flat.dtype != torch.int32 or flat.dim() != 1 \
            or not flat.is_contiguous() or 2 * flat.numel() < n16:
        raise ValueError(f"{what}: expected a contiguous int32 wire of at "
                         f"least {n16} int16 entries, got {flat.dtype} "
                         f"{tuple(flat.shape)} (contiguous="
                         f"{flat.is_contiguous()})")
    return flat.view(torch.int16)[:n16]


def coeff_table_plain(flat: torch.Tensor, CH: int, Np: int, Tp: int,
                      SC: int, Ts: int):
    """Kernel M1's function in plain PyTorch: (table [2*CH*Tp, 16] int32,
    the pack_table rows of both sides' triangles, the left side's CH*Tp
    rows first; (sel_left, sel_right), the tile lists [CH, SC, Ts] int32)
    of the chunk wire ``flat``."""
    x = _wire16(flat, wire_len16(CH, Np, Tp, SC, Ts), "coeff_table")
    K = CH * Tp
    sp = x[:CH * Np * 3].reshape(CH * Np, 3).to(torch.int32)
    at = CH * Np * 3
    tris, paints = [], []
    offs = torch.arange(CH, dtype=torch.int32, device=flat.device) * Np
    for _ in range(2):
        tri = x[at:at + 3 * K].reshape(CH, Tp, 3).to(torch.int32)
        tris.append((tri + offs[:, None, None]).reshape(K, 3))
        paints.append(x[at + 3 * K:at + 4 * K])
        at += 4 * K
    n = CH * SC * Ts
    sels = tuple(x[at + i * n:at + (i + 1) * n].reshape(CH, SC, Ts)
                 .to(torch.int32) for i in range(2))
    rflags = torch.arange(2 * K, device=flat.device) >= K
    cu, cv, sb, pb, pv = _tri_coeffs_impl(sp, torch.cat(tris), rflags)
    return pack_table(cu, cv, sb, pb, pv, torch.cat(paints)), sels


def grid_words_plain(flat: torch.Tensor, CH: int, Np: int, gs: int, gh: int,
                     gw: int, D: int) -> torch.Tensor:
    """Kernel M2's function in plain PyTorch: both sides' candidate grids
    [2*CH, gh, gw, ceil(D/32)] int32 (pack_grid_device of _grid_impl, the
    left grids first) of the chunk wire's support points."""
    x = _wire16(flat, CH * Np * 3, "grid_words")
    sp = x.reshape(CH, Np, 3).to(torch.int32)
    grids = _grid_impl(torch.cat([sp, sp]),
                       torch.arange(2 * CH, device=flat.device) >= CH,
                       gs=gs, gh=gh, gw=gw, disp_max=D - 1)
    return pack_grid_device(grids)


def coeff_grid_plain(flat: torch.Tensor, CH: int, Np: int, Tp: int,
                     SC: int, Ts: int, gs: int, gh: int, gw: int, D: int):
    """The one launch of kernels M1 and M2 in plain PyTorch: (table,
    (sel_left, sel_right), words) = coeff_table_plain and
    grid_words_plain of the chunk wire."""
    table, sels = coeff_table_plain(flat, CH, Np, Tp, SC, Ts)
    return table, sels, grid_words_plain(flat, CH, Np, gs, gh, gw, D)


def _coeff_grid_cuda(flat, CH, Np, Tp, SC, Ts, gs, gh, gw, D):
    """One launch of coeff_grid_kernel: (table, sels, words)."""
    _wire16(flat, wire_len16(CH, Np, Tp, SC, Ts), "coeff_grid")
    if gs < 1 or D < 1:
        raise ValueError(f"coeff_grid: grid_size {gs} and D {D} must be "
                         f"positive")
    dev = flat.device
    table = torch.empty((2 * CH * Tp, _TABLE_COLS), dtype=torch.int32,
                        device=dev)
    sels = tuple(torch.empty((CH, SC, Ts), dtype=torch.int32, device=dev)
                 for _ in range(2))
    words = torch.empty((2 * CH, gh, gw, -(-D // 32)), dtype=torch.int32,
                        device=dev)
    fn = cuda_lib.load("prior_kernel").prior_coeff_grid
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_lib.launch(fn, "coeff_grid", flat, flat.data_ptr(),
                    table.data_ptr(), sels[0].data_ptr(), sels[1].data_ptr(),
                    words.data_ptr(), CH, Np, Tp, CH * SC * Ts, gs, gh, gw,
                    D)
    prior_launches["coeff_grid"] += 1
    return table, sels, words


def coeff_grid(flat: torch.Tensor, CH: int, Np: int, Tp: int, SC: int,
               Ts: int, gs: int, gh: int, gw: int, D: int):
    """(table, (sel_left, sel_right), words) of a chunk wire
    (coeff_grid_plain's contract): kernels M1 and M2 in one launch on a
    CUDA wire; the plain versions on a CPU wire."""
    if flat.is_cuda:
        return _coeff_grid_cuda(flat, CH, Np, Tp, SC, Ts, gs, gh, gw, D)
    return coeff_grid_plain(flat, CH, Np, Tp, SC, Ts, gs, gh, gw, D)


# ---------------------------------------------------------------------------
# device: the slab raster (kernel C and its plain version)
# ---------------------------------------------------------------------------

def pack_table(corners_u, corners_v, slope_bits, plane_bits, pvalid, paint):
    """Per-triangle coefficient rows [T, 16] int32, the raster's input:
    A_u, B_u, C_u, A_v, B_v, the three slopes' and the three plane
    coefficients' float32 bits, pvalid, paint, and three zero words."""
    T = corners_u.shape[0]
    return torch.cat([
        corners_u.to(torch.int32), corners_v.to(torch.int32),
        slope_bits.to(torch.int32), plane_bits.to(torch.int32),
        pvalid.to(torch.int32)[:, None], paint.to(torch.int32)[:, None],
        torch.zeros((T, 3), dtype=torch.int32, device=corners_u.device),
    ], dim=1).contiguous()


def decode_win(win: torch.Tensor):
    """Winner key map -> (d_plane int16, valid bool, covered bool)."""
    covered = win >= 0
    dp = (((win >> 1) & 1023) - 512).to(torch.int16)
    dp = torch.where(covered, dp, 0)
    valid = covered & ((win & 1) == 1)
    return dp, valid, covered


def _slab_products_impl(sel_flat, row0, col0, corners_u, slope_bits,
                        plane_bits, *, CT: int, slab: int):
    """Every float32 multiply of the slab raster, each its own op.
    sel_flat [R] indexes the coefficient rows; row0/col0 [R] are each
    entry's tile origin."""
    dev = sel_flat.device
    cu = corners_u[sel_flat]                                 # [R, 3]
    slopes = slope_bits[sel_flat].view(torch.float32)
    planes = plane_bits[sel_flat].view(torch.float32)
    u_f = (col0[:, None] + torch.arange(CT, device=dev)[None, :]) \
        .to(torch.float32)                                   # [R, CT]
    rows_f = (row0[:, None] + torch.arange(slab, device=dev)[None, :]) \
        .to(torch.float32)                                   # [R, slab]
    A_u_f = cu[:, 0:1].to(torch.float32)
    B_u_f = cu[:, 1:2].to(torch.float32)
    m_ac = slopes[:, 0:1] * u_f
    m_ab = slopes[:, 1:2] * u_f
    m_bc = slopes[:, 2:3] * u_f
    s_ac = slopes[:, 0:1] * A_u_f                            # [R, 1]
    s_ab = slopes[:, 1:2] * A_u_f
    s_bc = slopes[:, 2:3] * B_u_f
    au = planes[:, 0:1] * u_f                                # [R, CT]
    bv = planes[:, 1:2] * rows_f                             # [R, slab]
    return m_ac, m_ab, m_bc, s_ac, s_ab, s_bc, au, bv


def _slab_raster_impl(sel_flat, row0, col0, corners_u, corners_v,
                      plane_bits, pvalid, paint_idx,
                      m_ac, m_ab, m_bc, s_ac, s_ab, s_bc, au, bv,
                      *, CH: int, S: int, C: int, Ts: int, W: int, H: int,
                      slab: int, CT: int) -> torch.Tensor:
    """Adds, compares and the winner max (the products come from
    _slab_products_impl). Returns the winner key map [CH, H, W] int32, -1
    where no triangle covers the pixel (decode_win decodes it).

    Scanline bounds: line value = (m + b), b = A_v - s (one rounding
    each), truncated to int32 and read as uint32, so a negative bound
    wraps to a large one; min(., H) then clips both."""
    dev = sel_flat.device
    cu = corners_u[sel_flat]
    cv = corners_v[sel_flat]
    planes = plane_bits[sel_flat].view(torch.float32)
    pv = pvalid[sel_flat].to(torch.int32)                     # [R]
    paint = paint_idx[sel_flat].to(torch.int32)               # [R]

    u_i = col0[:, None] + torch.arange(CT, device=dev)[None, :]
    A = cu[:, 0:1]
    B = cu[:, 1:2]
    Cc = cu[:, 2:3]
    A_v_f = cv[:, 0:1].to(torch.float32)
    B_v_f = cv[:, 1:2].to(torch.float32)
    seg1 = (u_i >= A) & (u_i < B)
    cover = (u_i >= A) & (u_i < Cc)                           # A <= B <= C

    def line_u32(m, b):
        return to_int32(m + b).to(torch.int64) & 0xFFFFFFFF

    v1 = line_u32(m_ac, A_v_f - s_ac)                         # [R, CT]
    v2 = torch.where(seg1, line_u32(m_ab, A_v_f - s_ab),
                     line_u32(m_bc, B_v_f - s_bc))
    lo = torch.clamp(torch.minimum(v1, v2), max=H)
    hi = torch.clamp(torch.maximum(v1, v2), max=H)
    lo = torch.where(cover, lo, 0)
    hi = torch.where(cover, hi, 0)

    f = (au[:, None, :] + bv[:, :, None]) + planes[:, 2:3, None]
    dt = torch.clamp(to_int32(f), -512, 511)                  # [R, slab, CT]
    key = ((paint[:, None, None] << _PAINT_SHIFT)
           | ((dt + 512) << 1) | pv[:, None, None])
    r = (row0[:, None] + torch.arange(slab, device=dev))[:, :, None]
    covered = (r >= lo[:, None, :]) & (r < hi[:, None, :])
    key = torch.where(covered & (paint[:, None, None] >= 0), key, -1)

    win = key.reshape(CH * S * C, Ts, slab, CT).amax(dim=1)
    return win.reshape(CH, S, C, slab, CT).permute(0, 1, 3, 2, 4) \
        .reshape(CH, S * slab, C * CT)[:, :H, :W].contiguous()


def _tiles(sel: torch.Tensor, W: int, H: int):
    """(S, C) raster tiles of an H x W image; raises unless sel has S*C."""
    S, C = -(-H // _RASTER_SLAB), -(-W // _RASTER_CTILE)
    if sel.dim() != 3 or sel.shape[1] != S * C:
        raise ValueError(f"sel {tuple(sel.shape)} does not fit the {S}x{C} "
                         f"tiles of a {H}x{W} image")
    return S, C


def raster_plain(table: torch.Tensor, sel: torch.Tensor, Tp: int, W: int,
                 H: int) -> torch.Tensor:
    """The raster kernel's function in plain PyTorch. table [CH*Tp, 16]
    int32 (pack_table of CH frames' Tp-row triangle wires); sel [CH, S*C,
    Ts] int32 per-tile slot lists of frame-local rows, padded with the
    degenerate row Tp-1. Returns the winner key map [CH, H, W] int32."""
    S, C = _tiles(sel, W, H)
    CH, _, Ts = sel.shape
    dev = sel.device
    toffs = torch.arange(CH, device=dev, dtype=torch.int64) * Tp
    sel_flat = (sel.to(torch.int64) + toffs[:, None, None]).reshape(-1)
    band = torch.arange(S * C, device=dev)[None, :, None].expand(CH, S * C, Ts)
    row0 = ((band // C) * _RASTER_SLAB).reshape(-1)
    col0 = ((band % C) * _RASTER_CTILE).reshape(-1)
    cu, cv = table[:, 0:3], table[:, 3:5]
    sb, pb = table[:, 5:8], table[:, 8:11]
    pv, paint = table[:, 11], table[:, 12]
    prods = _slab_products_impl(sel_flat, row0, col0, cu, sb, pb,
                                CT=_RASTER_CTILE, slab=_RASTER_SLAB)
    return _slab_raster_impl(sel_flat, row0, col0, cu, cv, pb, pv, paint,
                             *prods, CH=CH, S=S, C=C, Ts=Ts, W=W, H=H,
                             slab=_RASTER_SLAB, CT=_RASTER_CTILE)


def raster_maps_plain(tables, sels, Tp: int, W: int, H: int):
    """The raster kernel's function in plain PyTorch: (d_plane int16,
    valid bool, covered bool), each [n * CH, H, W], of the n sides
    (tables[i] [CH*Tp, 16], sels[i] [CH, S*C, Ts]), side 0's frames first:
    decode_win of raster_plain, a side at a time."""
    maps = [decode_win(raster_plain(t, s, Tp, W, H))
            for t, s in zip(tables, sels)]
    return tuple(torch.cat(m) for m in zip(*maps))


def _raster_maps_cuda(tables, sels, Tp: int, W: int, H: int):
    global launches
    n = len(sels)
    S, C = _tiles(sels[0], W, H)
    CH, SC, Ts = sels[0].shape
    dev = tables[0].device
    if n not in (1, 2) or len(tables) != n:
        raise ValueError(f"raster_maps takes one or two sides, got "
                         f"{len(tables)} tables and {n} tile lists")
    for i in range(n):
        cuda_lib.expect(tables[i], f"table {i}", torch.int32,
                        (CH * Tp, _TABLE_COLS), dev)
        cuda_lib.expect(sels[i], f"sel {i}", torch.int32, (CH, SC, Ts), dev)
    fn = cuda_lib.load("raster_kernel").raster_maps
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    d_plane = torch.empty((n * CH, H, W), dtype=torch.int16, device=dev)
    valid, covered = (torch.empty((n * CH, H, W), dtype=torch.bool,
                                  device=dev) for _ in range(2))
    last = n - 1
    cuda_lib.launch(fn, "raster", tables[0], tables[0].data_ptr(),
                    sels[0].data_ptr(), tables[last].data_ptr(),
                    sels[last].data_ptr(), d_plane.data_ptr(),
                    valid.data_ptr(), covered.data_ptr(), n, CH, Tp, S, C,
                    Ts, W, H)
    launches += 1
    return d_plane, valid, covered


def raster_maps(tables, sels, Tp: int, W: int, H: int):
    """The dense matcher's prior maps (d_plane int16, valid bool, covered
    bool), each [n * CH, H, W], of n = 1 or 2 sides (raster_maps_plain's
    contract): one launch of the CUDA kernel for every side on CUDA
    tensors, the plain version on CPU tensors."""
    if tables[0].is_cuda:
        return _raster_maps_cuda(tables, sels, Tp, W, H)
    return raster_maps_plain(tables, sels, Tp, W, H)



# ---------------------------------------------------------------------------
# the coefficient-wire raster: host coefficients, eager device raster
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PriorCoeffWire:
    """Per-triangle coefficients of one image side (numpy; padded by
    pad_coeff_wire). Line intercepts are not sent: the device recomputes
    b = A_v - a * A_u from the slope and the integer corner."""
    corners_u: np.ndarray   # [T, 3] int16: int(A_u), int(B_u), int(C_u)
    corners_v: np.ndarray   # [T, 2] int16: int(A_v), int(B_v)
    slope_bits: np.ndarray  # [T, 3] int32: f32 bits of AC_a, AB_a, BC_a
    plane_bits: np.ndarray  # [T, 3] int32: f32 bits of pa, pb, pc
    pvalid: np.ndarray      # [T] uint8: |a| < 0.7 on both images
    paint_idx: np.ndarray   # [T] int16: the row's paint order, which the
    #                         raster's last-painted winner compares
    vmin: np.ndarray        # [T] int16: the top corner row (sort key)


def sort_wire_rows(w: PriorCoeffWire) -> PriorCoeffWire:
    """The rows stably sorted by top row; paint_idx keeps the painted
    result independent of the order."""
    o = np.argsort(w.vmin, kind="stable")
    return PriorCoeffWire(
        w.corners_u[o], w.corners_v[o], w.slope_bits[o],
        w.plane_bits[o], w.pvalid[o], w.paint_idx[o], w.vmin[o])


def _corner_sort_f32(tu: np.ndarray, tv: np.ndarray):
    """The reference's pairwise swap sequence (elas.cpp:847-854) on float32
    corners [T, 3]; not a stable sort on ties."""
    tu = tu.astype(np.float32).copy()
    tv = tv.astype(np.float32).copy()
    for j, k in ((1, 0), (2, 0), (2, 1)):
        sw = tu[:, k] > tu[:, j]
        for arr in (tu, tv):
            a, b = arr[:, k].copy(), arr[:, j].copy()
            arr[:, k] = np.where(sw, b, a)
            arr[:, j] = np.where(sw, a, b)
    return tu, tv


def prior_coeff_wire(support: np.ndarray, tri: np.ndarray,
                     right_image: bool, fit_fn=None) -> PriorCoeffWire:
    """Each triangle's raster coefficients on the host, as the host
    rasterizer computes them: sorted corners, the three edge slopes
    (float32 divisions) and the plane. fit_fn(support, tri) -> [T, 6]
    float32 planes; by default numpy's (prior.compute_disparity_planes);
    native_prior.fit_planes_native gives the C++ prior's."""
    T = len(tri)
    if T == 0:
        return PriorCoeffWire(
            np.zeros((0, 3), np.int16), np.zeros((0, 2), np.int16),
            np.zeros((0, 3), np.int32), np.zeros((0, 3), np.int32),
            np.zeros((0,), np.uint8), np.zeros((0,), np.int16),
            np.zeros((0,), np.int16))
    s = support.astype(np.float32)
    if right_image:
        tu = (s[tri, 0] - s[tri, 2]).astype(np.float32)
    else:
        tu = s[tri, 0].astype(np.float32)
    tv = s[tri, 1].astype(np.float32)
    tu, tv = _corner_sort_f32(tu, tv)
    A_u, B_u, C_u = tu[:, 0], tu[:, 1], tu[:, 2]
    A_v, B_v, C_v = tv[:, 0], tv[:, 1], tv[:, 2]
    iA, iB, iC = (x.astype(np.int64) for x in (A_u, B_u, C_u))

    def slope(v0, v1, u0, u1, i0, i1):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(i0 != i1,
                            (v0 - v1).astype(np.float32)
                            / (u0 - u1).astype(np.float32),
                            np.float32(0.0)).astype(np.float32)

    AB_a = slope(A_v, B_v, A_u, B_u, iA, iB)
    AC_a = slope(A_v, C_v, A_u, C_u, iA, iC)
    BC_a = slope(B_v, C_v, B_u, C_u, iB, iC)

    planes = (fit_fn or compute_disparity_planes)(support, tri)
    if right_image:
        pa, pb, pc, pother = (planes[:, 3], planes[:, 4], planes[:, 5],
                              planes[:, 0])
    else:
        pa, pb, pc, pother = (planes[:, 0], planes[:, 1], planes[:, 2],
                              planes[:, 3])
    pvalid = (np.abs(pa) < 0.7) & (np.abs(pother) < 0.7)
    return PriorCoeffWire(
        np.stack([iA, iB, iC], axis=1).astype(np.int16),
        np.stack([A_v, B_v], axis=1).astype(np.int16),
        np.stack([AC_a, AB_a, BC_a], axis=1).view(np.int32),
        np.stack([pa, pb, pc], axis=1).view(np.int32),
        pvalid.astype(np.uint8), np.arange(T, dtype=np.int16),
        np.minimum(np.minimum(A_v, B_v), C_v).astype(np.int16))


def pad_coeff_wire(w: PriorCoeffWire, T_pad: int) -> PriorCoeffWire:
    """Pad to T_pad rows of zeros: an empty column span (A = B = C = 0),
    so a pad row never rasterizes."""
    p = T_pad - len(w.corners_u)
    if p <= 0:
        return w
    return PriorCoeffWire(*(
        np.pad(getattr(w, f.name), ((0, p),) + ((0, 0),) * (
            getattr(w, f.name).ndim - 1))
        for f in dataclasses.fields(w)))


def _raster_mul_impl(corners_u, slope_bits, plane_bits, *, W: int, H: int):
    """Every float32 multiply of the raster of one frame's rows [T, ...],
    each its own op, so none is fused with an add into an FMA: the line
    terms a * u [T, W] and a * A_u [T, 1] of the three edges, and the
    plane terms pa * u [T, W] and pb * v [T, H]."""
    f32 = torch.float32
    dev = corners_u.device
    slopes = slope_bits.to(torch.int32).contiguous().view(f32)   # [T, 3]
    planes = plane_bits.to(torch.int32).contiguous().view(f32)
    u_f = torch.arange(W, dtype=f32, device=dev)[None, :]
    v_f = torch.arange(H, dtype=f32, device=dev)[None, :]
    A_u_f = corners_u[:, 0:1].to(f32)
    B_u_f = corners_u[:, 1:2].to(f32)
    return (slopes[:, 0:1] * u_f, slopes[:, 1:2] * u_f,
            slopes[:, 2:3] * u_f, slopes[:, 0:1] * A_u_f,
            slopes[:, 1:2] * A_u_f, slopes[:, 2:3] * B_u_f,
            planes[:, 0:1] * u_f, planes[:, 1:2] * v_f)


def _line_trunc(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The scanline bound (uint32)(int)(m + b) of elas.cpp:878-879, as an
    int64 in [0, 2^32): a float32 add, truncation toward zero, and the
    uint32 wrap of a negative value."""
    return to_int32(m + b).to(torch.int64) & 0xFFFFFFFF


def _raster_add_impl(corners_u, corners_v, plane_bits, pvalid, paint_idx,
                     m_ac, m_ab, m_bc, s_ac, s_ab, s_bc, au, bv,
                     *, W: int, H: int, chunk: int = 64, slab: int = 48):
    """The scanline raster of one frame's rows from _raster_mul_impl's
    products: float32 adds, compares and truncations only. Each pixel
    takes the covering row of the largest paint_idx (the last painted)
    and its plane value f = (pa*u + pb*v) + pc. Rows go in chunks of
    ``chunk``; a chunk whose rows lie in one band of ``slab`` image rows
    paints that band alone, else the whole height. Returns (d_plane int16,
    valid, covered) [H, W]: d_plane = clip(trunc(f), -512, 511) where
    covered, else 0."""
    f32 = torch.float32
    dev = corners_u.device
    T = corners_u.shape[0]
    u_i = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    A, B, C = (corners_u[:, i:i + 1].to(torch.int32) for i in range(3))
    A_v_f = corners_v[:, 0:1].to(f32)
    B_v_f = corners_v[:, 1:2].to(f32)
    planes = plane_bits.to(torch.int32).contiguous().view(f32)
    seg1 = (u_i >= A) & (u_i < B)
    cover = (u_i >= A) & (u_i < C)                 # A <= B <= C (sorted)
    v1 = _line_trunc(m_ac, A_v_f - s_ac)                       # AC line
    v2 = torch.where(seg1, _line_trunc(m_ab, A_v_f - s_ab),    # AB line
                     _line_trunc(m_bc, B_v_f - s_bc))          # BC line
    lo = torch.clamp_max(torch.minimum(v1, v2), H)
    hi = torch.clamp_max(torch.maximum(v1, v2), H)
    lo = torch.where(cover, lo, 0).to(torch.int32)
    hi = torch.where(cover, hi, 0).to(torch.int32)

    pvi = pvalid.to(torch.bool)
    pidx = paint_idx.to(torch.int32)
    BH = min(slab, H)
    tid = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    fmap = torch.zeros((H, W), dtype=f32, device=dev)
    pvmap = torch.zeros((H, W), dtype=torch.bool, device=dev)
    n = min(chunk, T)
    for ci in range(-(-T // chunk)):
        # a chunk past the end starts earlier, as a clamped dynamic slice
        sl = slice(min(ci * chunk, T - n), min(ci * chunk, T - n) + n)
        lo_c, hi_c, au_c = lo[sl, None], hi[sl, None], au[sl, None]
        bv_c = bv[sl]
        pc_c = planes[sl, 2][:, None, None]
        pv_c = pvi[sl, None, None]
        idx = pidx[sl, None, None]
        rlo = int(torch.where(hi_c > lo_c, lo_c, H).min())
        rhi = int(hi_c.max())
        r0 = min(max((rlo // 8) * 8, 0), max(H - BH, 0))
        if rhi > r0 + BH:
            r0, nrows = 0, H
        else:
            nrows = BH
        rows = torch.arange(r0, r0 + nrows, dtype=torch.int32,
                            device=dev)[None, :, None]
        covered = (rows >= lo_c) & (rows < hi_c)       # [n, nrows, W]
        best = torch.where(covered, idx, -1).amax(0)
        win = covered & (idx == best[None])            # one row a pixel
        f_c = (au_c + bv_c[:, r0:r0 + nrows, None]) + pc_c   # adds only
        f_best = torch.where(win, f_c, 0.0).sum(0)
        pv_best = (win & pv_c).any(0)
        band = slice(r0, r0 + nrows)
        upd = best > tid[band]
        tid[band] = torch.maximum(tid[band], best)
        fmap[band] = torch.where(upd, f_best, fmap[band])
        pvmap[band] = torch.where(upd, pv_best, pvmap[band])

    covered_px = tid >= 0
    d_plane = torch.clamp(to_int32(fmap), -512, 511).to(torch.int16)
    d_plane = torch.where(covered_px, d_plane, 0)
    return d_plane, covered_px & pvmap, covered_px


def prior_maps_device(corners_u, corners_v, slope_bits, plane_bits, pvalid,
                      paint_idx, W: int, H: int, device: DeviceLike = None):
    """Padded coefficient rows [B, T, ...] -> (d_plane int16, valid,
    covered) [B, H, W], bit-equal to the host rasterizer's PlaneMaps
    (d_plane where covered). Runs on ``device``; by default on the device
    of corners_u when it is a tensor, else on the card. Every multiply is
    done, for every frame, before any add."""
    cu = as_input(corners_u, device)
    cv, sb, pb, pv, pidx = (torch.as_tensor(x).to(cu.device) for x in (
        corners_v, slope_bits, plane_bits, pvalid, paint_idx))
    prods = [_raster_mul_impl(cu[b], sb[b], pb[b], W=W, H=H)
             for b in range(cu.shape[0])]
    maps = [_raster_add_impl(cu[b], cv[b], pb[b], pv[b], pidx[b], *prods[b],
                             W=W, H=H) for b in range(cu.shape[0])]
    return tuple(torch.stack(m) for m in zip(*maps))
