"""Port device prior == jackal_tpu's, bit for bit: the triangle wire and the
chunk wire (byte-equal), the float64 plane fit (equal to the x64 softfloat
fit and to the C++ fit), the per-triangle coefficients, the candidate
grids (padded rows included) and the device grid packing; and the
saturating float -> int32 conversion (equal to XLA's)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas import device_prior as jdp
from jackal_tpu.matching.elas import pipeline as jpl
from jackal_tpu.matching.elas.device_fit import _fit_planes_impl as jax_fit
from jackal_tpu.matching.elas.native_prior import (
    fit_planes_native as jax_fit_native)
from jackal_tpu.matching.elas.native_prior import (
    tri_wire_and_bin_native as jax_wire_native)
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import device_prior as dp
from jackal_tpu_torch.matching.elas import pipeline as pl
from jackal_tpu_torch.matching.elas.dense import pack_grid
from jackal_tpu_torch.matching.elas.device_fit import (_fit_planes_impl,
                                                       fit_planes_device)
from jackal_tpu_torch.matching.elas.native_prior import (
    build_grid_native, fit_planes_native, tri_wire_and_bin_native)
from jackal_tpu_torch.matching.elas.prior import delaunay
from jackal_tpu_torch.ops.convert import to_int32


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

# collinear, repeated and tied corners (tests/test_device_fit.py's cases)
DEG_SUPPORT = np.array([
    [100, 100, 10], [200, 100, 10], [300, 100, 10], [100, 200, 20],
    [100, 300, 30], [200, 200, 15], [200, 300, 15], [640, 480, 255],
    [0, 0, 0], [5, 7, 3]], np.int32)
DEG_TRI = np.array([
    [0, 1, 2], [0, 3, 4], [0, 1, 3], [1, 5, 6], [0, 5, 7], [8, 9, 7],
    [0, 3, 5], [3, 4, 0], [0, 0, 1]], np.int32)
# top-row triangles, d > u (negative right-image u), u <= 1
ADV_SUPPORT = np.array([[0, 0, 5], [1, 0, 1], [5, 9, 30], [630, 3, 200],
                        [639, 479, 2], [2, 478, 1], [320, 240, 128]],
                       np.int32)


def _tris(support):
    lp = support[:, :2].astype(np.float32)
    rp = np.stack([support[:, 0] - support[:, 2], support[:, 1]],
                  -1).astype(np.float32)
    return {False: delaunay(lp), True: delaunay(rp)}


@pytest.fixture(scope="module")
def st320():
    z = np.load("tests/fixtures/elas_stages_st320.npz")
    support = z["support"].astype(np.int32)
    H, W = z["left"].shape
    return support, W, H, _tris(support)


def _wire(support, tris, W, H):
    sp16 = support.astype(np.int16)
    t1, p1, s1 = tri_wire_and_bin_native(sp16, tris[False], W, H, SLAB, CTILE)
    t2, p2, s2 = tri_wire_and_bin_native(sp16, tris[True], W, H, SLAB, CTILE,
                                         right=True)
    return sp16, t1, p1, t2, p2, s1, s2


@pytest.mark.parametrize("case", ["st320", "adversarial"])
@pytest.mark.parametrize("right", [False, True])
def test_triangle_wire_equals_jax(st320, case, right):
    """tri_wire/slab_select (numpy) and the C++ tri_wire_and_bin equal the
    reference package's, and each other."""
    if case == "st320":
        support, W, H, tris = st320
        tri = tris[right]
    else:
        support, W, H = ADV_SUPPORT, 640, 480
        tri = _tris(support)[right]
    t_np, p_np = dp.tri_wire(support, tri)
    jt, jp = jdp.tri_wire(support, tri)
    np.testing.assert_array_equal(t_np, jt)
    np.testing.assert_array_equal(p_np, jp)
    s_np = dp.slab_select(support, t_np, W, H, SLAB, CTILE, right=right)
    np.testing.assert_array_equal(
        s_np, jdp.slab_select(support, jt, W, H, SLAB, CTILE, right=right))
    got = tri_wire_and_bin_native(support.astype(np.int16), tri, W, H, SLAB,
                                  CTILE, right=right)
    want = jax_wire_native(support.astype(np.int16), tri, W, H, SLAB, CTILE,
                           right=right)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], t_np)
    np.testing.assert_array_equal(got[2][:, :s_np.shape[1]], s_np)


def test_chunk_wire_byte_equal(st320):
    """The C++ flatten, the numpy flatten and the reference's, byte for
    byte, on two frames and the empty-support wire."""
    support, W, H, tris = st320
    S = -(-H // SLAB) * -(-W // CTILE)
    e3, e1 = np.zeros((0, 3), np.int16), np.zeros((0,), np.int16)
    es = np.full((S, 1), -1, np.int32)
    empty = (e3.copy(), e3, e1, e3.copy(), e1.copy(), es, es.copy())
    wires = [_wire(support, tris, W, H),
             _wire(support[::2], _tris(support[::2]), W, H), empty]
    Np, Tp, Ts = pl._chunk_pads(wires)
    assert (Np, Tp, Ts) == jpl._chunk_pads(wires)
    assert pl._lr_ladder(wires, ElasParams()) == \
        jpl._lr_ladder(wires, JaxElasParams())
    flat = pl._flatten_chunk_wire(wires, Np, Tp, Ts)
    assert flat.dtype == np.int32
    np.testing.assert_array_equal(flat, pl._flatten_chunk_wire_np(
        wires, Np, Tp, Ts))
    np.testing.assert_array_equal(flat, jpl._flatten_chunk_wire_np(
        wires, Np, Tp, Ts))
    np.testing.assert_array_equal(flat, jpl._flatten_chunk_wire_native(
        wires, Np, Tp, Ts))


@pytest.fixture(scope="module")
def fit_case(st320):
    """st320's triangles of both images and the degenerate cases, on one
    support array; the reference package's x64 softfloat fit of them."""
    support, _, _, tris = st320
    sp = np.concatenate([support, DEG_SUPPORT])
    tri = np.concatenate([tris[False], tris[True],
                          DEG_TRI + len(support)]).astype(np.int32)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jax_fit)(jnp.asarray(sp), jnp.asarray(tri)))
    return sp, tri, want


def test_fit_bit_equal_softfloat_and_native(fit_case):
    sp, tri, want = fit_case
    got = _fit_planes_impl(torch.from_numpy(sp), torch.from_numpy(tri))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(
        want.view(np.int32), fit_planes_native(sp, tri).view(np.int32))
    np.testing.assert_array_equal(
        want.view(np.int32), jax_fit_native(sp, tri).view(np.int32))
    deg = got.numpy()[-len(DEG_TRI):]
    assert np.all(deg[-1] == 0.0)              # exact zero pivot: singular
    assert deg[0, 0] != 0.0                    # collinear: passes the gate


def test_fit_random_equals_native():
    rng = np.random.default_rng(7)
    n = 500
    sp = np.stack([rng.integers(0, 640, n), rng.integers(0, 480, n),
                   rng.integers(0, 256, n)], -1).astype(np.int32)
    tri = rng.integers(0, n, (4000, 3)).astype(np.int32)
    got = fit_planes_device(sp, tri, device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  fit_planes_native(sp, tri).view(np.int32))


@pytest.mark.parametrize("right", [False, True])
def test_tri_coeffs_equal_host_wire(st320, right):
    """_tri_coeffs_impl == the reference's host coefficient wire (C++ fit,
    f32 slopes by x86 division) for one image side."""
    support, _, _, tris = st320
    tri = tris[right]
    want = jdp.prior_coeff_wire(support, tri, right, jax_fit_native)
    cu, cv, sb, pb, pv = dp._tri_coeffs_impl(
        torch.from_numpy(support), torch.from_numpy(tri.astype(np.int32)),
        right)
    np.testing.assert_array_equal(cu.numpy(), want.corners_u.astype(np.int32))
    np.testing.assert_array_equal(cv.numpy(), want.corners_v.astype(np.int32))
    np.testing.assert_array_equal(sb.numpy(), want.slope_bits)
    np.testing.assert_array_equal(pb.numpy(), want.plane_bits)
    np.testing.assert_array_equal(pv.numpy(), want.pvalid.astype(bool))


def test_tri_coeffs_both_sides_equal_jax(fit_case):
    """Both sides in one call with per-row flags, as the chunk tail does,
    against the reference package's softfloat _tri_coeffs_impl."""
    sp, tri, _ = fit_case
    T = len(tri)
    tri2 = np.concatenate([tri, tri])
    flags = np.arange(2 * T) >= T

    def traced(s, t, r):
        with jax.enable_x64(True):
            return jdp._tri_coeffs_impl(s, t, r)
    with jax.enable_x64(True):
        want = jax.jit(traced)(jnp.asarray(sp), jnp.asarray(tri2),
                               jnp.asarray(flags))
    got = dp._tri_coeffs_impl(torch.from_numpy(sp), torch.from_numpy(tri2),
                              torch.from_numpy(flags))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grids_equal_jax_and_native(st320):
    """_grid_impl for a batch of both sides, support padded with d = -1
    rows: equal to the reference's device grid and to createGrid (C++)."""
    support, W, H, _ = st320
    p = ElasParams()
    gs = p.grid_size
    gh, gw = -(-H // gs), -(-W // gs)
    n = len(support) + 7
    sp = [support, support[::3]]
    sp = [np.concatenate([s, np.tile([[0, 0, -1]], (n - len(s), 1))])
          .astype(np.int32) for s in sp]
    batch = np.stack(sp + sp)
    right = np.array([False, False, True, True])
    got = dp._grid_impl(torch.from_numpy(batch), torch.from_numpy(right),
                        gs=gs, gh=gh, gw=gw, disp_max=p.disp_max)
    want = jax.jit(jax.vmap(partial(jdp._grid_impl, gs=gs, gh=gh, gw=gw,
                                    disp_max=p.disp_max)))(
        jnp.asarray(batch), jnp.asarray(right))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(4):
        real = batch[b][batch[b][:, 2] >= 0]
        np.testing.assert_array_equal(
            got[b].numpy(), build_grid_native(real, W, H, bool(right[b]), p))
    words = dp.pack_grid_device(got)
    assert words.dtype == torch.int32 and (words < 0).any()
    np.testing.assert_array_equal(words.numpy(), pack_grid(got.numpy()))


def test_pack_grid_device_sign_bit():
    g = np.zeros((1, 2, 70), bool)
    g[0, 0, 31] = g[0, 1, 63] = g[0, 1, 64] = True
    w = dp.pack_grid_device(torch.from_numpy(g))
    assert w.shape == (1, 2, 3)
    assert int(w[0, 0, 0]) == -2 ** 31 and int(w[0, 1, 2]) == 1
    np.testing.assert_array_equal(w.numpy(), pack_grid(g))


def test_to_int32_saturates_like_xla():
    x = np.array([3e9, -3e9, np.nan, np.inf, -np.inf, 2147483520.0,
                  2147483648.0, -2147483648.0, -2147483904.0, 1e17, -1e17,
                  511.9, -512.7, -0.5, 0.0], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(to_int32(torch.from_numpy(x)).numpy(), want)
    assert list(want[:3]) == [2 ** 31 - 1, -2 ** 31, 0]
