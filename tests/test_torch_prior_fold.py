"""Kernels M1 and M2 of the batched ELAS prior in one launch
(device_prior.coeff_grid): the plain twin it is held to on the card,
coeff_grid_plain (coeff_table_plain, then grid_words_plain), on the CPU ==
the reference's coeffs program (jackal_tpu/matching/elas/pipeline.py
_raster_chunk, its jitted _tri_coeffs_impl and _grid_impl under x64) bit
for bit, as tests/test_torch_prior_kernels.py holds the two alone.

The launch's M2 blocks each own a tile of 1024 / ceil(D / 32) grid cells,
so the cases put support points in the cells on both sides of a tile's
edge and in the rows above and below it (whose flat 3 x 3 neighbourhoods
cross the edge), for the left grids and, a chunk frame later, the right
ones (cell of u - d), at d = 0 and d = D - 1 (the dilated bits d - 1 and
d + 1 clipped) and at word edges (31, 32): D = 256 at the batched node's
640 x 480 (6 tiles of 128 cells), D = 100 (3 tiles of 256) and D = 33 at
grid_size 7 (2 tiles of 512)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import prior_chunk, prior_points, prior_wire
from jackal_tpu.matching.elas import pipeline as jpl
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import device_prior as dp
from jackal_tpu_torch.matching.elas import pipeline as pl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (W, H, ElasParams) of each case
CASES = {
    "D = 256, 640 x 480: tiles of 128 cells": (640, 480, ElasParams()),
    "D = 100, 640 x 480: tiles of 256 cells": (640, 480,
                                               ElasParams(disp_max=99)),
    "D = 33, grid_size 7, 200 x 150: tiles of 512 cells": (
        200, 150, ElasParams(disp_max=32, grid_size=7)),
}


def _tile_edge_support(W, H, p, right, seed):
    """Support points (u, v, d) int32 in the cells about every edge of M2's
    cell tiles (the left grid's cells, or the right grid's: u - d), with d
    cycling through 0, D - 1 and the word edges, and seeded points
    elsewhere; distinct in (u, v) and in (u - d, v)."""
    gs, D = p.grid_size, p.disp_num
    gh, gw = -(-H // gs), -(-W // gs)
    G, tile = gh * gw, 1024 // -(-D // 32)
    ds = [0, D - 1, min(31, D - 1), min(32, D - 1), D // 2]
    pts = []
    for c in range(tile, G, tile):
        for s in (c - 1, c, c + 1, c - gw, c - gw - 1, c + gw - 1, c + gw):
            if not 0 <= s < G:
                continue
            y, x = divmod(s, gw)
            d = ds[len(pts) % len(ds)]
            k = len(pts)
            v = y * gs + (3 * k) % gs
            u = x * gs + (7 * k) % gs + (d if right else 0)
            if u < W and v < H:
                pts.append((u, v, d))
    rng = np.random.default_rng(seed)
    pts += [tuple(x) for x in prior_points(rng, 60, W, H, D)]
    out, seen_l, seen_r = [], set(), set()
    for u, v, d in pts:
        if (u, v) not in seen_l and (u - d, v) not in seen_r:
            seen_l.add((u, v))
            seen_r.add((u - d, v))
            out.append((u, v, d))
    return np.array(out, np.int32)


def _jax_coeffs(flat, CH, Np, Tp, Ts, W, H, p):
    """The reference's coeffs program on the wire: per side (the table
    after the port's pack_table, the tile lists [CH, SC, Ts], the grid
    words after pack_grid_device)."""
    gs = p.grid_size
    gh, gw = -(-H // gs), -(-W // gs)
    key = (CH, Np, Tp, Ts, gh, gw, p.disp_max + 1, W, H, gs)
    jpl._raster_chunk(jnp.asarray(flat), CH, Np, Tp, Ts, gh, gw,
                      p.disp_max + 1, W, H, gs)
    with jax.enable_x64(True):
        sides = jpl._RASTER_JITS[key][0](jnp.asarray(flat))
    SC = -(-H // dp._RASTER_SLAB) * -(-W // dp._RASTER_CTILE)
    toffs = np.arange(CH, dtype=np.int32)[:, None, None] * Tp
    out = []
    for cu, cv, sb, pb, pv, paint, grid, sel in sides:
        t = [torch.from_numpy(np.array(x)) for x in (cu, cv, sb, pb, pv,
                                                     paint)]
        sel = np.asarray(sel).reshape(CH, SC, Ts) - toffs
        out.append((dp.pack_table(*t), torch.from_numpy(sel),
                    dp.pack_grid_device(torch.from_numpy(np.array(grid)))))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_fused_twin_equals_jax_at_tile_edges(name):
    W, H, p = CASES[name]
    sps = [_tile_edge_support(W, H, p, right, 31 + i)
           for i, right in enumerate((False, True))]
    flat, CH, Np, Tp, Ts, SC = prior_chunk([prior_wire(s, W, H)
                                            for s in sps], W, H)
    gs, D = p.grid_size, p.disp_num
    gh, gw = -(-H // gs), -(-W // gs)
    ft = torch.from_numpy(flat)
    n0 = dict(dp.prior_launches)
    table, sels, words = dp.coeff_grid(ft, CH, Np, Tp, SC, Ts, gs, gh, gw,
                                       D)
    assert dp.prior_launches == n0            # a CPU wire: the plain twin
    assert all(torch.equal(a, b) for a, b in zip(
        (table, *sels, words),
        (dp.coeff_table_plain(ft, CH, Np, Tp, SC, Ts)[0],
         *dp.coeff_table_plain(ft, CH, Np, Tp, SC, Ts)[1],
         dp.grid_words_plain(ft, CH, Np, gs, gh, gw, D))))
    want = _jax_coeffs(flat, CH, Np, Tp, Ts, W, H, p)
    chunk = pl._chunk_coeffs(ft, CH, Np, Tp, Ts, W, H, p)
    K = CH * Tp
    for side in range(2):
        got = (table[side * K:(side + 1) * K], sels[side],
               words[side * CH:(side + 1) * CH])
        for g, c, w in zip(got, chunk[side], want[side]):
            assert torch.equal(g, w) and torch.equal(c, w)
    # the cases reach what they are about: marks on both sides of every
    # tile edge, bit 0 (from d = 0) and bit D - 1 (from d = D - 1)
    w = words.numpy().view(np.uint32).reshape(2 * CH, gh * gw, -1)
    tile = 1024 // w.shape[2]
    for c in range(tile, gh * gw - gw - 1, tile):
        assert w[:, c - 1].any() and w[:, c].any()
    assert (w[..., 0] & 1).any()
    assert ((w[..., (D - 1) // 32] >> np.uint32((D - 1) % 32)) & 1).any()
