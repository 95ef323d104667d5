"""The slab raster (kernel C's plain version) and one chunk's device prior
== jackal_tpu's, bit for bit: the maps and grids of the reference's
_raster_chunk for the same flat wire, the reference's slab raster on
wide triangles, odd image sizes and overflowing planes, and the C++ host
prior (the per-frame path's, equal to libelas).

The reference package never runs raster_pallas (the Pallas kernel) in its
CPU tests; its XLA twin _slab_products_impl + _slab_raster_impl is what
_raster_chunk runs off the TPU, so that twin is the reference here. The
JAX functions run eagerly, one op at a time, so XLA fuses no multiply into
an add."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.matching.elas import device_prior as jdp
from jackal_tpu.matching.elas import pipeline as jpl
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import device_prior as dp
from jackal_tpu_torch.matching.elas import pipeline as pl
from jackal_tpu_torch.matching.elas.dense import pack_grid
from jackal_tpu_torch.matching.elas.native_prior import build_priors_native
from jackal_tpu_torch.matching.elas.prior import delaunay


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SLAB, CTILE = dp._RASTER_SLAB, dp._RASTER_CTILE


def _tris(support):
    lp = support[:, :2].astype(np.float32)
    rp = np.stack([support[:, 0] - support[:, 2], support[:, 1]],
                  -1).astype(np.float32)
    return delaunay(lp), delaunay(rp)


def _wire(support, W, H):
    from jackal_tpu_torch.matching.elas.native_prior import (
        tri_wire_and_bin_native)
    sp16 = support.astype(np.int16)
    t1, t2 = _tris(support)
    a = tri_wire_and_bin_native(sp16, t1, W, H, SLAB, CTILE)
    b = tri_wire_and_bin_native(sp16, t2, W, H, SLAB, CTILE, right=True)
    return (sp16, a[0], a[1], b[0], b[1], a[2], b[2]), (t1, t2)


def _port_chunk(wires, W, H, params=ElasParams()):
    Np, Tp, Ts = pl._chunk_pads(wires)
    flat = pl._flatten_chunk_wire(wires, Np, Tp, Ts)
    coeffs = pl._chunk_coeffs(torch.from_numpy(flat), len(wires), Np, Tp, Ts,
                              W, H, params)
    return flat, (Np, Tp, Ts), coeffs, pl._chunk_raster(coeffs, Tp, W, H)


def _jax_slab(table, sel, Tp, W, H):
    """The reference's slab raster on the same coefficient table."""
    CH, SC, Ts = sel.shape
    S, C = -(-H // SLAB), -(-W // CTILE)
    tab = jnp.asarray(table.numpy())
    sel_flat = jnp.asarray((sel.numpy().astype(np.int64)
                            + np.arange(CH)[:, None, None] * Tp).reshape(-1))
    band = np.broadcast_to(np.arange(SC)[None, :, None], (CH, SC, Ts))
    row0 = jnp.asarray(((band // C) * SLAB).reshape(-1).astype(np.int32))
    col0 = jnp.asarray(((band % C) * CTILE).reshape(-1).astype(np.int32))
    cu, cv, sb, pb = tab[:, 0:3], tab[:, 3:5], tab[:, 5:8], tab[:, 8:11]
    prods = jdp._slab_products_impl(sel_flat, row0, col0, cu, sb, pb,
                                    CT=CTILE, slab=SLAB)
    out = jdp._slab_raster_impl(sel_flat, row0, col0, cu, cv, pb,
                                tab[:, 11], tab[:, 12], *prods, CH=CH, S=S,
                                C=C, Ts=Ts, W=W, H=H, slab=SLAB, CT=CTILE)
    return [np.asarray(x) for x in out]


def _assert_maps(got, want):
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def st320_chunk():
    z = np.load("tests/fixtures/elas_stages_st320.npz")
    support = z["support"].astype(np.int32)
    H, W = z["left"].shape
    w1, tris1 = _wire(support, W, H)
    w2, tris2 = _wire(support[::2], W, H)
    return W, H, [w1, w2], [(support, tris1), (support[::2], tris2)]


def test_chunk_prior_equals_jax_raster_chunk(st320_chunk):
    """Coefficients, grids and the raster of both sides of a two-frame
    chunk against the reference's _raster_chunk on the same flat wire."""
    W, H, wires, _ = st320_chunk
    p = ElasParams()
    flat, (Np, Tp, Ts), _, maps = _port_chunk(wires, W, H, p)
    gs = p.grid_size
    m1, m2, g1, g2 = jpl._raster_chunk(
        jnp.asarray(flat), len(wires), Np, Tp, Ts, -(-H // gs), -(-W // gs),
        p.disp_max + 1, W, H, gs)
    for got, want, grid in ((maps[0], m1, g1), (maps[1], m2, g2)):
        _assert_maps(got, [np.asarray(x) for x in want])
        assert got[2].any()
        np.testing.assert_array_equal(got[3].numpy(),
                                      pack_grid(np.asarray(grid)))


def test_chunk_prior_equals_host_prior(st320_chunk):
    """The same maps against the C++ host prior of the per-frame path."""
    W, H, wires, frames = st320_chunk
    p = ElasParams()
    _, _, _, maps = _port_chunk(wires, W, H, p)
    for f, (support, (t1, t2)) in enumerate(frames):
        host = build_priors_native(support, W, H, p, tri_left=t1,
                                   tri_right=t2)
        for side, (m, g) in enumerate(((host[0], host[2]),
                                       (host[1], host[3]))):
            dpl, valid, cov, words = (x[f].numpy() for x in maps[side])
            np.testing.assert_array_equal(cov, m.tri_id >= 0)
            np.testing.assert_array_equal(valid, m.valid)
            np.testing.assert_array_equal(dpl[cov], m.d_plane[cov])
            np.testing.assert_array_equal(words, pack_grid(g))


def test_wide_triangles_640x480():
    """Sparse support: every triangle spans many 16x128 tiles (the golden
    scenes' triangles never cross one). Against the reference's slab
    raster and the C++ host prior."""
    W, H = 640, 480
    rng = np.random.default_rng(11)
    support = np.stack([rng.choice(np.arange(8, W - 8), 14, replace=False),
                        rng.choice(np.arange(8, H - 8), 14, replace=False),
                        rng.integers(6, 120, 14)], -1).astype(np.int32)
    wire, (t1, t2) = _wire(support, W, H)
    _, (_, Tp, _), coeffs, maps = _port_chunk([wire], W, H)
    host = build_priors_native(support, W, H, ElasParams(), tri_left=t1,
                               tri_right=t2)
    for side in range(2):
        table, sel, _ = coeffs[side]
        assert int((sel != Tp - 1).sum(-1).max()) >= 2   # multi-tile
        _assert_maps(maps[side], _jax_slab(table, sel, Tp, W, H))
        cov = host[side].tri_id >= 0
        np.testing.assert_array_equal(maps[side][2][0].numpy(), cov)
        np.testing.assert_array_equal(maps[side][0][0].numpy()[cov],
                                      host[side].d_plane[cov])


def _synthetic_table(rng, CH, T, W, H):
    """Random triangles with the reference's sorted corners and sensible
    slopes; the plane bits are set by the caller."""
    u = np.sort(rng.integers(-20, W + 20, (CH, T, 3)), -1)
    v = rng.integers(-10, H + 10, (CH, T, 3))
    du = [u[..., 0] - u[..., 2], u[..., 0] - u[..., 1], u[..., 1] - u[..., 2]]
    dv = [v[..., 0] - v[..., 2], v[..., 0] - v[..., 1], v[..., 1] - v[..., 2]]
    slopes = np.stack([np.where(a != 0, b / np.where(a == 0, 1, a), 0)
                       for a, b in zip(du, dv)], -1).astype(np.float32)
    planes = np.stack([rng.uniform(-0.6, 0.6, (CH, T)),
                       rng.uniform(-0.3, 0.3, (CH, T)),
                       rng.uniform(-50, 300, (CH, T))], -1).astype(np.float32)
    tab = np.zeros((CH, T, 16), np.int32)
    tab[..., 0:3] = u
    tab[..., 3:5] = v[..., :2]
    tab[..., 5:8] = slopes.view(np.int32)
    tab[..., 8:11] = planes.view(np.int32)
    tab[..., 11] = rng.random((CH, T)) < 0.7
    tab[..., 12] = np.arange(T)
    tab[:, -1] = 0
    tab[:, -1, 12] = -1                     # the degenerate pad row Tp-1
    return tab


def _tile_lists(rng, CH, T, W, H, Ts):
    SC = -(-H // SLAB) * -(-W // CTILE)
    sel = rng.integers(3, T - 1, (CH, SC, Ts))      # rows 0-2 set below
    sel[rng.random(sel.shape) < 0.3] = T - 1
    return torch.from_numpy(sel.astype(np.int32))


@pytest.mark.parametrize("CH,T,W,H,Ts", [(2, 40, 150, 37, 16),
                                         (1, 25, 333, 70, 32)])
def test_raster_odd_shapes_and_overflow_equal_jax(CH, T, W, H, Ts):
    """Random triangles at image sizes that are not multiples of the tile,
    and three top-painted triangles whose planes leave the int32 range:
    pa = +1e17 must give trunc(f) = INT32_MAX -> d_plane 511 (XLA's rule,
    where a plain cast on x86 gives INT32_MIN -> -512), pa = -1e17 gives
    -512 and NaN gives 0. Each of the three is listed first in every third
    tile and covers all of it but column 0 (its AB edge falls below row 0,
    and the negative bound wraps to a large one)."""
    rng = np.random.default_rng(W)
    tab = _synthetic_table(rng, CH, T, W, H)
    big = np.array([1e17, -1e17, np.nan], np.float32).view(np.int32)
    tab[:, 0:3, 0:3] = [[0, W // 2, W]]
    tab[:, 0:3, 3:5] = [[0, -1]]
    tab[:, 0:3, 5:8] = np.array([0.0, -1.0, 0.0], np.float32).view(np.int32)
    tab[:, 0:3, 8] = big[:, None].T
    tab[:, 0:3, 9] = 0
    tab[:, 0:3, 10] = big[:, None].T
    tab[:, 0:3, 12] = T + 1
    table = torch.from_numpy(tab.reshape(CH * T, 16))
    sel = _tile_lists(rng, CH, T, W, H, Ts)
    tile = torch.arange(sel.shape[1])
    sel[:, :, 0] = (tile % 3).to(torch.int32)
    maps = dp.decode_win(dp.raster(table, sel, T, W, H))
    assert maps[0].shape == (CH, H, W)
    _assert_maps(maps, _jax_slab(table, sel, T, W, H))
    dpl, _, cov = maps
    C = -(-W // CTILE)
    v, u = np.mgrid[0:H, 0:W]
    want = np.array([511, -512, 0])[((v // SLAB) * C + u // CTILE) % 3]
    assert bool(cov[..., 1:].all())
    np.testing.assert_array_equal(dpl[..., 1:].numpy(),
                                  np.broadcast_to(want[:, 1:], (CH, H, W - 1)))
