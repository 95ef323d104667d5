"""The ELAS options the port carries beside its C++ engine, against
jackal_tpu on the same seeded inputs, bit for bit: the numpy host prior
(support pruning and collection, build_priors and its parts), the
per-frame postprocess, and elas_match / the batched entries with
use_native=False and return_debug=True.

The numpy pruning walks the candidate grid in Python loops, so the frames
here are the small stage fixture (120 x 160) and grids of a few hundred
cells."""
import dataclasses

import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas import pipeline as jpl
from jackal_tpu.matching.elas import post as jpost
from jackal_tpu.matching.elas import prior as jprior
from jackal_tpu.matching.elas import support as jsupport
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import pipeline as pl
from jackal_tpu_torch.matching.elas import post
from jackal_tpu_torch.matching.elas import prior
from jackal_tpu_torch.matching.elas import support
from jackal_tpu_torch.matching.elas.native_prior import (
    build_priors_native, collect_support_points_native)
from jackal_tpu_torch.ops.descriptor import create_descriptor


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
PRESETS = ("robotics", "middlebury")


def _params(preset: str):
    return getattr(ElasParams, preset)(), getattr(JaxElasParams, preset)()


@pytest.fixture(scope="module")
def stages():
    return dict(np.load(f"{FIX}/elas_stages_st160.npz"))


def _candidates(left, right, params):
    desc = create_descriptor(torch.from_numpy(np.stack([left, right])))
    return support.support_candidates(desc[0:1], desc[1:2],
                                       params)[0].numpy()


def _seeded_grid(seed, ncv=24, ncu=32, dmax=60):
    """Candidate grids with runs of equal and near-equal disparities (so
    both prunings keep and drop points), -1 elsewhere, the calloc-0
    border row and column."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, dmax, (ncv // 4 + 1, ncu // 4 + 1))
    g = np.kron(base, np.ones((4, 4), np.int64))[:ncv, :ncu]
    g = g + rng.integers(-2, 3, (ncv, ncu))
    g[rng.random((ncv, ncu)) < 0.35] = -1
    g = np.clip(g, -1, dmax).astype(np.int16)
    g[0, :] = 0
    g[:, 0] = 0
    return g


@pytest.mark.parametrize("add_corners", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collect_support_points_equals_jax(seed, add_corners):
    """The pruning in scan order and the collection on seeded grids: the
    port's numpy copy == the reference's numpy == the C++ engine."""
    g = _seeded_grid(seed)
    tp = dataclasses.replace(ElasParams(), add_corners=add_corners)
    jp = dataclasses.replace(JaxElasParams(), add_corners=add_corners)
    got = support.collect_support_points(g, tp, 160, 120)
    want = jsupport.collect_support_points(g, jp, 160, 120)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, collect_support_points_native(g, tp, 160, 120))
    assert got.dtype == want.dtype and 10 < len(got) < 24 * 32


@pytest.mark.parametrize("seed", [3, 4])
def test_prunings_in_place_equal_jax(seed):
    """Each pruning alone, in place, in the order collect runs them (and
    the redundancy test at other reaches): == the reference's."""
    g = _seeded_grid(seed)
    a, b = g.copy(), g.copy()
    for port_fn, jax_fn, args in (
            (support.remove_inconsistent_support_points,
             jsupport.remove_inconsistent_support_points, None),
            (support.remove_redundant_support_points,
             jsupport.remove_redundant_support_points, (5, 1, True)),
            (support.remove_redundant_support_points,
             jsupport.remove_redundant_support_points, (4, 2, False)),
            (support.remove_redundant_support_points,
             jsupport.remove_redundant_support_points, (2, 0, True))):
        assert port_fn(a, *(args or (ElasParams(),))) is a
        jax_fn(b, *(args or (JaxElasParams(),)))
        np.testing.assert_array_equal(a, b)
    assert (a != g).sum() > 10 and (a >= 0).sum() > 10


@pytest.mark.parametrize("preset", PRESETS)
def test_collect_support_points_on_the_stage_fixture(stages, preset):
    """On the fixture's candidate grid (the port's support_candidates of
    its images): the port's numpy collection == the reference's == the
    C++ engine's, and without corners the fixture's libelas support."""
    tp, jp = _params(preset)
    dcan = _candidates(stages["left"], stages["right"], tp)
    H, W = stages["left"].shape
    got = support.collect_support_points(dcan, tp, W, H)
    np.testing.assert_array_equal(
        got, jsupport.collect_support_points(dcan, jp, W, H))
    np.testing.assert_array_equal(
        got, collect_support_points_native(dcan, tp, W, H))
    if preset == "robotics":
        np.testing.assert_array_equal(got, stages["support"])


def test_prune_support_parallel_equals_jax():
    for seed in (5, 6):
        g = _seeded_grid(seed)
        got = support.prune_support_parallel(torch.from_numpy(g))
        want = np.asarray(jsupport.prune_support_parallel(g))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)


def test_build_priors_and_parts_equal_jax(stages):
    """rasterize_planes, create_grid, grid_mask_to_reference_lists,
    pack_prior_wire and build_priors on the fixture's support and
    triangles: == the reference's numpy prior; the grids == the
    fixture's libelas lists."""
    sp = stages["support"]
    H, W = stages["left"].shape
    tp, jp = ElasParams(), JaxElasParams()
    t1, t2 = stages["tri1"], stages["tri2"]
    got = prior.build_priors(sp, W, H, tp, tri_left=t1, tri_right=t2)
    want = jprior.build_priors(sp, W, H, jp, tri_left=t1, tri_right=t2)
    for side in range(2):
        g, w = got[side], want[side]
        np.testing.assert_array_equal(g.tri_id, w.tri_id)
        np.testing.assert_array_equal(g.d_plane, w.d_plane)
        np.testing.assert_array_equal(g.valid, w.valid)
        assert g.d_plane.dtype == np.int16 and (g.tri_id >= 0).mean() > 0.5
        np.testing.assert_array_equal(got[2 + side], want[2 + side])
        lists = prior.grid_mask_to_reference_lists(got[2 + side])
        np.testing.assert_array_equal(
            lists, jprior.grid_mask_to_reference_lists(want[2 + side]))
        np.testing.assert_array_equal(lists, stages[f"grid{side + 1}"])
        for a, b in zip(prior.pack_prior_wire(g, got[2 + side]),
                        jprior.pack_prior_wire(w, want[2 + side])):
            np.testing.assert_array_equal(a, b)
    planes = prior.compute_disparity_planes(sp, t1)
    for right in (False, True):
        g = prior.rasterize_planes(sp, t1, planes, W, H, right)
        w = jprior.rasterize_planes(sp, t1, planes, W, H, right)
        np.testing.assert_array_equal(g.tri_id, w.tri_id)
        np.testing.assert_array_equal(g.d_plane, w.d_plane)
        np.testing.assert_array_equal(g.valid, w.valid)
        np.testing.assert_array_equal(
            prior.create_grid(sp, W, H, right, tp),
            jprior.create_grid(sp, W, H, right, jp))
    empty = prior.rasterize_planes(sp, np.zeros((0, 3), np.int32),
                                   np.zeros((0, 6), np.float32), W, H, False)
    assert (empty.tri_id == -1).all() and not empty.valid.any()


def test_u32_trunc_equals_jax():
    x = np.array([-3.5, -1.0, -0.5, 0.0, 0.99, 7.7, 2 ** 31 + 5.0, -2 ** 31,
                  1e9], np.float32)
    np.testing.assert_array_equal(prior._u32_trunc(x), jprior._u32_trunc(x))


@pytest.mark.parametrize("preset", PRESETS)
def test_build_priors_equal_the_cpp_engine(stages, preset):
    """The numpy prior and the C++ engine on the fixture's support, both
    triangulating: the same maps and grids."""
    tp, _ = _params(preset)
    H, W = stages["left"].shape
    sp = support.collect_support_points(
        _candidates(stages["left"], stages["right"], tp), tp, W, H)
    a = prior.build_priors(sp, W, H, tp)
    b = build_priors_native(sp, W, H, tp)
    for side in range(2):
        np.testing.assert_array_equal(a[side].tri_id, b[side].tri_id)
        cov = a[side].tri_id >= 0
        np.testing.assert_array_equal(a[side].valid, b[side].valid)
        np.testing.assert_array_equal(a[side].d_plane[cov],
                                      b[side].d_plane[cov])
        np.testing.assert_array_equal(a[2 + side], b[2 + side])


def _map_pair(seed, H=60, W=96):
    """Seeded dense maps of both views as kernel B leaves them: a scene of
    fronto-parallel blocks (disparity 2 to 12), each right-view pixel the
    disparity of the left pixel that lands on it, a few pixels off by one
    or two, and holes of -1 in both."""
    rng = np.random.default_rng(seed)
    base = rng.integers(2, 13, (H // 20 + 1, W // 24 + 1))
    D1 = np.kron(base, np.ones((20, 24)))[:H, :W]
    D2 = np.full((H, W), -1.0)
    for v in range(H):
        for u in range(W):
            d = int(D1[v, u])
            if u - d >= 0:
                D2[v, u - d] = max(D2[v, u - d], d)
    for D in (D1, D2):
        D += rng.integers(-2, 3, D.shape) * (rng.random(D.shape) < 0.1)
        D[rng.random(D.shape) < 0.08] = -1
    return D1.astype(np.float32), D2.astype(np.float32)


@pytest.mark.parametrize("preset", PRESETS)
def test_postprocess_equals_jax(preset):
    """post.postprocess of one frame (L/R check, device speckle, gaps,
    adaptive mean, median) == the JAX postprocess; a batch of two frames
    == each frame alone."""
    tp, jp = _params(preset)
    pairs = [_map_pair(s) for s in range(2)]
    for D1, D2 in pairs:
        g1, g2 = post.postprocess(torch.from_numpy(D1), torch.from_numpy(D2),
                                  tp)
        w1, w2 = jpost.postprocess(D1, D2, jp)
        np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))
        assert (g1.numpy() >= 0).mean() > 0.2
        assert not np.array_equal(g1.numpy(), D1)
    b1, b2 = post.postprocess(
        torch.from_numpy(np.stack([p[0] for p in pairs])),
        torch.from_numpy(np.stack([p[1] for p in pairs])), tp)
    for i, (D1, D2) in enumerate(pairs):
        g1, g2 = post.postprocess(torch.from_numpy(D1), torch.from_numpy(D2),
                                  tp)
        assert torch.equal(b1[i], g1) and torch.equal(b2[i], g2)


@pytest.mark.parametrize("preset", PRESETS)
def test_elas_match_use_native_false_and_debug_equal_jax(stages, preset):
    """elas_match on the stage fixture with use_native=False and with
    return_debug=True (both, and each alone): D1, D2 and every field of
    ElasDebug == the JAX elas_match's, and the native route's maps are
    the same."""
    tp, jp = _params(preset)
    left, right = stages["left"], stages["right"]
    W1, W2, jdbg = jpl.elas_match(left, right, jp, return_debug=True,
                                  use_native=False)
    D1, D2, dbg = pl.elas_match(left, right, tp, return_debug=True,
                                use_native=False, device="cpu")
    for got, want in ((D1, W1), (D2, W2), (dbg.dense_D1, jdbg.dense_D1),
                      (dbg.dense_D2, jdbg.dense_D2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dbg.support, jdbg.support)
    assert (np.asarray(W1) >= 0).mean() > 0.3
    N1, N2 = pl.elas_match(left, right, tp, use_native=False, device="cpu")
    assert torch.equal(N1, D1) and torch.equal(N2, D2)
    C1, C2, cdbg = pl.elas_match(left, right, tp, return_debug=True,
                                 device="cpu")
    assert torch.equal(C1, D1) and torch.equal(C2, D2)
    assert torch.equal(cdbg.dense_D1, dbg.dense_D1)
    if preset == "robotics":
        np.testing.assert_array_equal(dbg.dense_D1.numpy(),
                                      stages["dense_D1"])
        np.testing.assert_array_equal(D1.numpy(), stages["final_D1"])


def test_elas_match_bail_out_matches_jax():
    """Fewer than 3 support points: the -10 maps, without the debug item,
    as the reference returns them."""
    flat = np.full((40, 64), 128, np.uint8)
    got = pl.elas_match(flat, flat, ElasParams(), return_debug=True,
                        use_native=False, device="cpu")
    want = jpl.elas_match(flat, flat, JaxElasParams(), return_debug=True,
                          use_native=False)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_prior_tri_job_numpy_equals_cpp(stages):
    """_prior_tri_job's numpy branch (tri_wire, slab_select) == its C++
    branch, entry by entry once widened to the chunk wire."""
    tp = ElasParams()
    H, W = stages["left"].shape
    dcan = _candidates(stages["left"], stages["right"], tp)
    a = pl._prior_tri_job(dcan, tp, W, H, use_native=False)
    b = pl._prior_tri_job(dcan, tp, W, H)
    assert pl._chunk_pads([a]) == pl._chunk_pads([b])
    Np, Tp, Ts = pl._chunk_pads([a])
    np.testing.assert_array_equal(pl._flatten_chunk_wire([a], Np, Tp, Ts),
                                  pl._flatten_chunk_wire([b], Np, Tp, Ts))
