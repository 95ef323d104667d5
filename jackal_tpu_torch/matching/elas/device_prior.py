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
  raster            the scanline rasterization of computeDisparity
                    (elas.cpp:813-904) as a slab raster: per 16-row x
                    128-column tile, the maximum over the tile's triangles
                    of the packed winner key
                        (paint << 11) | ((trunc(f) + 512) << 1) | pvalid,
                    f = (pa*u + pb*v) + pc, so the last-painted triangle
                    wins and carries its plane value. raster() launches the
                    CUDA kernel (csrc/raster_kernel.cu) on CUDA tensors and
                    runs raster_plain() on CPU tensors.

Every float multiply, add and subtract of the raster is its own eager op
in the plain version and an __fmul_rn/__fadd_rn/__fsub_rn in the kernel,
so nothing is fused into an FMA. Float-to-int conversions that can leave
the int32 range follow XLA's rule (ops/convert.to_int32).

The host side (slab_select, tri_wire, pad_tri_wire) is a numpy copy of
the reference package's; native_prior.tri_wire_and_bin_native is its C++
twin.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...ops import cuda_lib
from ...ops.convert import to_int32

_RASTER_SLAB = 16       # rows of a raster tile
_RASTER_CTILE = 128     # columns of a raster tile
_PAINT_SHIFT = 11       # key's low bits: trunc(f)+512 (10), pvalid (1)
_TABLE_COLS = 16        # pack_table row: A_u B_u C_u A_v B_v, slope bits x3,
#                         plane bits x3, pvalid, paint, 3 zero words

launches = 0            # raster kernel launches since the last reset


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


def _raster_cuda(table: torch.Tensor, sel: torch.Tensor, Tp: int, W: int,
                 H: int) -> torch.Tensor:
    global launches
    S, C = _tiles(sel, W, H)
    CH, SC, Ts = sel.shape
    dev = table.device
    cuda_lib.expect(table, "table", torch.int32, (CH * Tp, _TABLE_COLS), dev)
    cuda_lib.expect(sel, "sel", torch.int32, (CH, SC, Ts), dev)
    lib = cuda_lib.load("raster_kernel")
    fn = lib.raster_win
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    win = torch.empty((CH, H, W), dtype=torch.int32, device=dev)
    err = fn(table.data_ptr(), sel.data_ptr(), win.data_ptr(),
             CH, Tp, S, C, Ts, W, H, cuda_lib.stream_ptr(table))
    cuda_lib.check(err, "raster")
    launches += 1
    return win


def raster(table: torch.Tensor, sel: torch.Tensor, Tp: int, W: int,
           H: int) -> torch.Tensor:
    """Winner key map [CH, H, W] int32 of the slab raster (raster_plain's
    contract): the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if table.is_cuda:
        return _raster_cuda(table, sel, Tp, W, H)
    return raster_plain(table, sel, Tp, W, H)

