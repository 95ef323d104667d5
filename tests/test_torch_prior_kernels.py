"""Kernels M1 and M2 of the batched ELAS prior (csrc/prior_kernel.cu, one
launch): their plain versions, device_prior.coeff_table_plain and
grid_words_plain (together coeff_grid on a CPU wire), and
the chunk tail's _chunk_coeffs on a CPU wire == the reference's coeffs
program (jackal_tpu/matching/elas/pipeline.py _raster_chunk, its jitted
coeffs under x64) bit for bit: the coefficient table after the port's
pack_table, the tile lists, and the grids after pack_grid_device.

Inputs: elas_stages_st320's chunk at CH = 1 and 2 (D = 256) and the
first five of chip_smoke.PRIOR_EDGE_CASES, which the card's tests and
chip_smoke.py phase 16 also hold the kernels to: degenerate and tied
triangles (collinear, repeated and tied corners), d > u, a seeded chunk
with pad support rows and pad triangle rows, D = 100 with d up to 129,
a 3 x 2 grid (G - 2gw - 2 = 0); and their 2-row grid (G - 2gw - 2 < 0:
the reference raises, the port gives empty grids, as createGrid does). Numpy models of the kernels'
designs (M1's solve computing only b and the trailing columns, and
stopping at a singular pivot; M2's tile-by-tile scatter of dilated marks)
are held to the plain versions on the same inputs and on grids wider than
a windowed design could hold in shared memory."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.matching.elas import pipeline as jpl
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import device_prior as dp
from jackal_tpu_torch.matching.elas import pipeline as pl
from jackal_tpu_torch.matching.elas.device_fit import _gj_solve3
from jackal_tpu_torch.matching.elas.native_prior import build_grid_native
from jackal_tpu_torch.matching.elas.prior import delaunay

from chip_smoke import (PRIOR_DEG_SUPPORT, PRIOR_DEG_TRI, PRIOR_EDGE_CASES,
                        prior_chunk, prior_edge_case, prior_points,
                        prior_wire)


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
# the edge cases chip_smoke.py and the card's tests hold the kernels to,
# those the reference can take: degenerate and tied triangles, d > u, pad
# rows, D = 100, a 3 x 2 grid
JAX_CASES = PRIOR_EDGE_CASES[:5]


def _case(name):
    """(frames' wire tuples, their supports, W, H, ElasParams) of a named
    chunk: elas_stages_st320's (one frame, or it and every other of its
    points) or one of chip_smoke.PRIOR_EDGE_CASES."""
    if not name.startswith("st320"):
        return prior_edge_case(name)
    z = np.load("tests/fixtures/elas_stages_st320.npz")
    sp = z["support"].astype(np.int32)
    H, W = z["left"].shape
    sps = [sp, sp[::2]] if name.endswith("CH=2") else [sp]
    return [prior_wire(s, W, H) for s in sps], sps, W, H, ElasParams()


def _jax_coeffs(flat, CH, Np, Tp, Ts, W, H, p):
    """The reference's coeffs program on the same wire: per side (table
    after the port's pack_table, the tile lists [CH, SC, Ts], the grid
    words after pack_grid_device)."""
    gs = p.grid_size
    gh, gw = -(-H // gs), -(-W // gs)
    key = (CH, Np, Tp, Ts, gh, gw, p.disp_max + 1, W, H, gs)
    jpl._raster_chunk(jnp.asarray(flat), CH, Np, Tp, Ts, gh, gw,
                      p.disp_max + 1, W, H, gs)
    with jax.enable_x64(True):
        sides = jpl._RASTER_JITS[key][0](jnp.asarray(flat))
    SC = -(-H // SLAB) * -(-W // CTILE)
    toffs = np.arange(CH, dtype=np.int32)[:, None, None] * Tp
    out = []
    for cu, cv, sb, pb, pv, paint, grid, sel in sides:
        t = [torch.from_numpy(np.array(x)) for x in (cu, cv, sb, pb, pv,
                                                     paint)]
        sel = np.asarray(sel).reshape(CH, SC, Ts) - toffs
        out.append((dp.pack_table(*t), torch.from_numpy(sel),
                    dp.pack_grid_device(torch.from_numpy(np.array(grid)))))
    return out


@pytest.mark.parametrize("name", ("st320 CH=1", "st320 CH=2") + JAX_CASES)
def test_plain_kernels_and_chunk_coeffs_equal_jax(name):
    wires, sps, W, H, p = _case(name)
    flat, CH, Np, Tp, Ts, SC = prior_chunk(wires, W, H)
    if name == "seeded, pad rows":        # pad support and triangle rows
        assert len(sps[1]) < Np and max(len(w[1]) for w in wires) < Tp
    want = _jax_coeffs(flat, CH, Np, Tp, Ts, W, H, p)
    ft = torch.from_numpy(flat)
    gs = p.grid_size
    gh, gw = -(-H // gs), -(-W // gs)
    n0 = dict(dp.prior_launches)
    table, sels, words = dp.coeff_grid(ft, CH, Np, Tp, SC, Ts, gs, gh, gw,
                                       p.disp_num)
    assert dp.prior_launches == n0          # CPU tensors: the plain versions
    assert table.dtype == torch.int32 and table.shape == (2 * CH * Tp, 16)
    assert words.shape == (2 * CH, gh, gw, -(-p.disp_num // 32))
    K = CH * Tp
    got = [(table[i * K:(i + 1) * K], sels[i], words[i * CH:(i + 1) * CH])
           for i in range(2)]
    chunk = pl._chunk_coeffs(ft, CH, Np, Tp, Ts, W, H, p)
    for side in range(2):
        for g, c, w in zip(got[side], chunk[side], want[side]):
            assert torch.equal(g, w) and torch.equal(c, w)
    # the pad rows: paint -1, and singular (planes +0, pvalid 1)
    pad = table[Tp - 1]
    assert int(pad[12]) == -1 and pad[8:11].tolist() == [0, 0, 0]
    assert int(pad[11]) == 1
    # the 3 x 2 grid has no interior cell
    assert bool(words.any()) == (name != "3 x 2 grid cells")
    if name.startswith("st320 CH"):
        assert bool((words < 0).any())          # bit 31: negative words


def test_two_row_grid_is_empty_where_the_reference_raises():
    """gh = 2: G - 2gw - 2 < 0. The reference's _grid_impl cannot build the
    empty interior (TypeError); createGrid (C++) and the port give grids
    with no candidate."""
    wires, sps, W, H, p = prior_edge_case("2 rows of grid cells")
    flat, CH, Np, Tp, Ts, SC = prior_chunk(wires, W, H)
    gs = p.grid_size
    assert (-(-H // gs), -(-W // gs)) == (2, 8)
    words = dp.coeff_grid(torch.from_numpy(flat), CH, Np, Tp, SC, Ts, gs,
                          2, 8, p.disp_num)[2]
    assert words.shape == (2, 2, 8, 2) and not bool(words.any())
    for right in (False, True):
        assert not build_grid_native(sps[0], W, H, right, p).any()
    with pytest.raises(TypeError):
        _jax_coeffs(flat, CH, Np, Tp, Ts, W, H, p)


# ---- numpy models of the kernels' designs --------------------------------

def _gj_model(A, b):
    """csrc/prior_kernel.cu gj_solve3 in float64 scalars: only b and the
    trailing columns computed, and +0 thrice at the first pivot below
    1e-20."""
    A = [[np.float64(x) for x in row] for row in A]
    b = [np.float64(x) for x in b]
    col = [0, 1, 2]
    for k in range(3):
        best, pr, pc = np.float64(-1.0), k, k
        for i in range(k, 3):
            for j in range(k, 3):
                if abs(A[i][j]) > best:
                    best, pr, pc = abs(A[i][j]), i, j
        if not best >= 1e-20:
            return np.zeros(3, np.float32)
        A[k], A[pr] = A[pr], A[k]
        b[k], b[pr] = b[pr], b[k]
        for row in A:
            row[k], row[pc] = row[pc], row[k]
        col[k], col[pc] = col[pc], col[k]
        piv = A[k][k]
        for j in range(k + 1, 3):
            A[k][j] = A[k][j] / piv
        b[k] = b[k] / piv
        for i in range(3):
            if i != k:
                f = A[i][k]
                for j in range(k + 1, 3):
                    A[i][j] = A[i][j] - f * A[k][j]
                b[i] = b[i] - f * b[k]
    out = np.zeros(3, np.float64)
    for k in range(3):
        out[col[k]] = b[k]
    return out.astype(np.float32)


def test_solve_model_equals_plain_solve():
    """M1's solve, which skips the entries that feed nothing and stops at a
    singular pivot, == device_fit._gj_solve3 bit for bit: st320's
    triangles of both sides, the degenerate triangles, tied pivots and
    random integer systems."""
    z = np.load("tests/fixtures/elas_stages_st320.npz")
    sp = z["support"].astype(np.int64)
    t1, t2 = (delaunay(np.stack([sp[:, 0] - r * sp[:, 2], sp[:, 1]], -1)
                       .astype(np.float32)) for r in (0, 1))
    systems = []
    for s, tri in ((sp, t1), (sp, t2), (PRIOR_DEG_SUPPORT.astype(np.int64),
                                        PRIOR_DEG_TRI)):
        u, v, d = (s[tri, i] for i in range(3))
        for uu in (u, u - d):
            systems += [(np.stack([uu[t], v[t], np.ones(3)], -1), d[t])
                        for t in range(len(tri))]
    rng = np.random.default_rng(9)
    for _ in range(300):
        A = rng.integers(-4, 5, (3, 3)).astype(np.float64)
        systems.append((A, rng.integers(-9, 10, 3)))
    systems.append((np.array([[2.0, -2.0, 1.0], [-2.0, 2.0, 1.0],
                              [1.0, 1.0, 2.0]]), np.array([1, 2, 3])))
    A = torch.tensor(np.stack([a for a, _ in systems]), dtype=torch.float64)
    b = torch.tensor(np.stack([bb for _, bb in systems]), dtype=torch.float64)
    want = _gj_solve3(A, b)[0].to(torch.float32).numpy().view(np.int32)
    got = np.stack([_gj_model(a, bb) for a, bb in systems]).view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert (want == 0).all(axis=1).sum() > 10       # singular systems seen


def _grid_model(flat, CH, Np, gs, gh, gw, D):
    """M2's design: a block a (frame and side, tile of 1024 // nw cells)
    ORs the bits d-1, d, d+1 of every point whose cell lies in an output
    cell's flat neighbourhood into that cell's words."""
    nw = -(-D // 32)
    G = gh * gw
    tile = 1024 // nw
    sp = np.asarray(flat).view(np.int16)[:CH * Np * 3].reshape(CH, Np, 3) \
        .astype(np.int64)
    out = np.zeros((2 * CH, G, nw), np.uint32)
    offs = (-gw - 1, -gw, -gw + 1, -1, 0, 1, gw - 1, gw, gw + 1)
    for fs in range(2 * CH):
        right = fs >= CH
        u, v, d = sp[fs % CH].T
        x = ((u - d) if right else u) // gs
        y = v // gs
        ok = (d >= 0) & (d < D) & (x >= 0) & (x < gw) & (y >= 0) & (y < gh)
        for c0 in range(0, G, tile):
            n = min(tile, G - c0)
            words = np.zeros((n, nw), np.uint32)
            lo, hi = max(c0, gw + 1), min(c0 + n, G - gw - 1)
            for p in np.nonzero(ok)[0]:
                s = int(y[p] * gw + x[p])
                for dd in (d[p] - 1, d[p], d[p] + 1):
                    if not 0 <= dd < D:
                        continue
                    for o in offs:
                        if lo <= s + o < hi:
                            words[s + o - c0, dd // 32] |= np.uint32(
                                1 << (dd % 32))
            out[fs, c0:c0 + n] = words
    return out.view(np.int32).reshape(2 * CH, gh, gw, nw)


@pytest.mark.parametrize("W,H,gs,D,n", [
    (320, 184, 20, 256, 60),    # st320's grid
    (200, 150, 20, 100, 40),    # D = 100: a partial last word
    (200, 150, 7, 33, 40),      # two words, the second with one bit
    (200, 150, 20, 1, 40),      # D = 1
    (40, 60, 20, 64, 8),        # 3 x 2 cells, G - 2gw - 2 = 0
    (160, 40, 20, 64, 12),      # 2 rows, G - 2gw - 2 < 0
    (2112, 6, 1, 256, 100),     # 2112 cells a row: past a window in
                                # shared memory (tiles of 128 cells)
])
def test_grid_scatter_model_equals_plain(W, H, gs, D, n):
    rng = np.random.default_rng(W + D)
    sps = [prior_points(rng, n, W, H, min(D + 3, 250)),
           prior_points(rng, n // 2, W, H, 40)]
    sps[1][:, 0] = np.minimum(sps[1][:, 0], 30)       # d > u: u - d < 0
    CH, Np = 2, 512
    sp = np.zeros((CH, Np, 3), np.int16)
    sp[:, :, 2] = -1                                  # pad rows
    for i, s in enumerate(sps):
        sp[i, :len(s)] = s
    flat = sp.reshape(-1).view(np.int32)
    gh, gw = -(-H // gs), -(-W // gs)
    want = dp.grid_words_plain(torch.from_numpy(flat), CH, Np, gs, gh, gw, D)
    np.testing.assert_array_equal(_grid_model(flat, CH, Np, gs, gh, gw, D),
                                  want.numpy())
    if gh > 3 or gw > 2:
        assert bool(want.any()) == (gh > 2)
