"""The ELAS paths' last eager ops, as their plain versions run them on the
CPU: the raster decoded for both sides in one call (kernel C's function),
the u8 map from the tail's last step (the epilogue of kernels I, J, K),
the tail writing into given output rows, and the node's u8 routes; each
against jackal_tpu or numpy on the same inputs, bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas import device_prior as jdp
from jackal_tpu.matching.elas import pipeline as jpl
from jackal_tpu.matching.elas import post as jpost
from jackal_tpu.ops.pallas.raster_kernel import decode_win as jax_decode_win
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import device_prior as dp
from jackal_tpu_torch.matching.elas import pipeline as pl
from jackal_tpu_torch.matching.elas import post
from jackal_tpu_torch.matching.elas.native_prior import (
    tri_wire_and_bin_native)
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


FIX = "tests/fixtures"
SLAB, CTILE = dp._RASTER_SLAB, dp._RASTER_CTILE
PRESETS = ("robotics", "middlebury")


def _u8(D: np.ndarray) -> np.ndarray:
    return np.clip(np.round(D), 0, 255).astype(np.uint8)


def _wire(support, W, H):
    sp16 = support.astype(np.int16)
    lp = support[:, :2].astype(np.float32)
    rp = np.stack([support[:, 0] - support[:, 2], support[:, 1]],
                  -1).astype(np.float32)
    a = tri_wire_and_bin_native(sp16, delaunay(lp), W, H, SLAB, CTILE)
    b = tri_wire_and_bin_native(sp16, delaunay(rp), W, H, SLAB, CTILE,
                                right=True)
    return sp16, a[0], a[1], b[0], b[1], a[2], b[2]


def _jax_slab(table, sel, Tp, W, H):
    """The reference's XLA slab raster (with its decode) of one side."""
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


def test_raster_maps_both_sides_equal_jax_decode():
    """raster_maps on a chunk of two frames, both sides in one call: side
    i's frames are the reference's decode_win of the side's winner keys,
    and the reference's XLA raster's maps."""
    z = np.load(f"{FIX}/elas_stages_st160.npz")
    H, W = z["left"].shape
    sp = z["support"].astype(np.int32)
    wires = [_wire(sp, W, H), _wire(sp[::2], W, H)]
    Np, Tp, Ts = pl._chunk_pads(wires)
    flat = torch.from_numpy(pl._flatten_chunk_wire(wires, Np, Tp, Ts))
    coeffs = pl._chunk_coeffs(flat, 2, Np, Tp, Ts, W, H, ElasParams())
    tables, sels, _ = zip(*coeffs)
    n0 = dp.launches
    maps = dp.raster_maps(tables, sels, Tp, W, H)
    assert dp.launches == n0            # the plain version on CPU tensors
    assert [tuple(m.shape) for m in maps] == [(4, H, W)] * 3
    assert [m.dtype for m in maps] == [torch.int16, torch.bool, torch.bool]
    for side in range(2):
        keys = dp.raster_plain(tables[side], sels[side], Tp, W, H)
        want = [np.asarray(x) for x in jax_decode_win(jnp.asarray(
            keys.numpy()))]
        got = [m[2 * side:2 * side + 2].numpy() for m in maps]
        for g, w, x in zip(got, want, _jax_slab(tables[side], sels[side],
                                                Tp, W, H)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, x)
        assert got[2].mean() > 0.5 and got[1].any()
    one = dp.raster_maps(tables[1:], sels[1:], Tp, W, H)
    for m, o in zip(maps, one):
        assert torch.equal(m[2:], o)
    sides = pl._chunk_raster(coeffs, Tp, W, H)
    for side, (dpl, valid, cov, words) in enumerate(sides):
        for g, m in zip((dpl, valid, cov), maps):
            assert torch.equal(g, m[2 * side:2 * side + 2])
        assert words is coeffs[side][2]


def _tail_maps(seed, H=48, W=70):
    """Maps a tail may be handed, with the values the u8 map has to round
    and clip: x.5 (both parities), -1 (holes), -10 (L/R rejects), and
    values above 255."""
    rng = np.random.default_rng(seed)
    D = rng.integers(0, 60, (H, W)).astype(np.float32)
    D[:, ::5] += 0.5
    D[::7, :] = rng.choice([255.5, 256.0, 300.25, 1e6, 254.5], (W,))
    D[rng.random((H, W)) < 0.15] = -1.0
    D[rng.random((H, W)) < 0.05] = -10.0
    D[3, 3:9] = [0.5, 1.5, 2.5, -0.5, -0.4, 0.49]
    D[20:30, 10:30] = -1.0          # runs past ROBOTICS' gap width
    D[35:40, 40:60] = -10.0
    return D


def _variants(preset):
    p = getattr(ElasParams, preset)()
    return {"filters on": p,
            "gap only": dataclasses.replace(p, filter_adaptive_mean=False,
                                            filter_median=False)}


@pytest.mark.parametrize("preset", PRESETS)
def test_tail_u8_and_out_sinks(preset):
    """post_tail with a u8 sink (and with out rows): the u8 map ==
    numpy's clip(round(D1), 0, 255) of the tail's D1, the maps == the
    tail's without sinks == the JAX post_tail's; with the filters off the
    final D1 still holds x.5, -1, -10 and values past 255."""
    for name, p in _variants(preset).items():
        jp = JaxElasParams(**dataclasses.asdict(p))
        D1, D2 = _tail_maps(1), _tail_maps(2)
        t1, t2 = torch.from_numpy(D1), torch.from_numpy(D2)
        F1, F2 = post.post_tail(t1, t2, p)
        W1, W2 = jpost.post_tail(D1, D2, jp)
        np.testing.assert_array_equal(F1.numpy(), np.asarray(W1))
        np.testing.assert_array_equal(F2.numpy(), np.asarray(W2))
        U = torch.empty(D1.shape, dtype=torch.uint8)
        G1, G2 = post.post_tail(t1, t2, p, u8=U)
        assert torch.equal(G1, F1) and torch.equal(G2, F2)
        np.testing.assert_array_equal(U.numpy(), _u8(F1.numpy()))
        rows = torch.empty((2, *D1.shape))
        out = (rows[0],) if p.postprocess_only_left else (rows[0], rows[1])
        V = torch.empty_like(U)
        H1, H2 = post.post_tail(t1, t2, p, out=out, u8=V)
        assert H1.data_ptr() == rows[0].data_ptr()
        assert torch.equal(H1, F1) and torch.equal(H2, F2)
        assert torch.equal(V, U)
        if name == "gap only":
            f = F1.numpy()
            assert ((f % 1) == 0.5).any() and (f > 255).any()
            if preset == "robotics":       # MIDDLEBURY fills every gap
                assert (f == -1).any() and (f == -10).any()


def test_u8_map_and_dmap_u8_equal_numpy():
    D = torch.from_numpy(_tail_maps(3))
    np.testing.assert_array_equal(post.u8_map(D).numpy(), _u8(D.numpy()))
    U = torch.zeros(D.shape, dtype=torch.uint8)
    assert post.u8_map(D, U) is U
    np.testing.assert_array_equal(U.numpy(), _u8(D.numpy()))


def test_pair_is_a_view_of_one_storage():
    """Both views that lie one after the other in one storage are taken as
    one [2, ...] tensor (no copy); any other pair is stacked."""
    both = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    X = post._pair(both[0], both[1])
    assert X.data_ptr() == both.data_ptr() and torch.equal(X, both)
    for a, b in ((both[1], both[0]), (both[0], both[0]),
                 (both[0].clone(), both[1]),
                 (both[0][:, :2], both[1][:, :2])):
        Y = post._pair(a, b)
        assert Y.data_ptr() != both.data_ptr()
        assert torch.equal(Y, torch.stack([a, b]))


def test_dense_pair_lr_out_rows():
    """dense_match_pair_lr with out rows (the batched path under
    postprocess_only_left: D2 straight into its rows) == without."""
    from jackal_tpu_torch.matching.elas import dense
    from jackal_tpu_torch.ops.descriptor import create_descriptor
    z = np.load(f"{FIX}/elas_stages_st160.npz")
    H, W = z["left"].shape
    p = ElasParams()
    desc = create_descriptor(torch.from_numpy(np.stack([z["left"],
                                                        z["right"]])))
    sp = z["support"]
    from jackal_tpu_torch.matching.elas.native_prior import (
        build_priors_native)
    m1, m2, g1, g2 = build_priors_native(sp, W, H, p, tri_left=z["tri1"],
                                         tri_right=z["tri2"])

    def view(m, g):
        return [torch.from_numpy(np.ascontiguousarray(a))[None]
                for a in (m.d_plane, m.valid, m.tri_id >= 0,
                          dense.pack_grid(g))]
    args = (desc[0:1], desc[1:2], view(m1, g1), view(m2, g2), p)
    A1, A2 = dense.dense_match_pair_lr(*args)
    rows = torch.full((2, 1, H, W), 7.0)
    B1, B2 = dense.dense_match_pair_lr(*args, out=(None, rows[1]))
    assert B2.data_ptr() == rows[1].data_ptr()
    assert torch.equal(A1, B1) and torch.equal(A2, B2)
    np.testing.assert_array_equal(A1[0].numpy(), z["lr_D1"])


@pytest.mark.parametrize("preset", PRESETS)
def test_node_u8_routes_equal_jax(preset):
    """The node's routes on the stage fixture and its 8-pixel shift: per
    frame (_elas_match_u8), batched (_elas_match_batch_u8, chunk 1) and
    streamed (_elas_stream_u8) == numpy's u8 of the JAX elas_match D1."""
    p = getattr(ElasParams, preset)()
    jp = getattr(JaxElasParams, preset)()
    z = np.load(f"{FIX}/elas_stages_st160.npz")
    lb = np.stack([z["left"], np.roll(z["left"], 8, 1)])
    rb = np.stack([z["right"], np.roll(z["right"], 8, 1)])
    want = np.stack([_u8(np.asarray(jpl.elas_match(lb[b], rb[b], jp)[0]))
                     for b in range(2)])
    for b in range(2):
        got = pl._elas_match_u8(lb[b], rb[b], p, device="cpu")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want[b])
    np.testing.assert_array_equal(
        pl._elas_match_batch_u8(lb, rb, p, chunk=1, device="cpu").numpy(),
        want)
    streamed = list(pl._elas_stream_u8(iter([(lb, rb)]), p, chunk=2,
                                       device="cpu"))
    np.testing.assert_array_equal(streamed[0].numpy(), want)
    assert (want > 0).mean() > 0.3


def test_node_u8_route_bail_out():
    flat = np.full((40, 64), 128, np.uint8)
    got = pl._elas_match_u8(flat, flat, ElasParams(), device="cpu")
    assert got.dtype == torch.uint8 and not got.any()
