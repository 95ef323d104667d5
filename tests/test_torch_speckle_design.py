"""A numpy model of kernel L's union order against the speckle filter's
plain versions, on the CPU.

Kernel L (jackal_tpu_torch/csrc/speckle_kernel.cu) builds each tile's
parts from its row runs and the column pairs its skip rule keeps (a pair
whose left neighbours are joined to each other and each to it is
skipped), unites the border parts across tile edges where the pair
before it along the edge does not already join both sides, adds each
tile part's valid count to its component's root (the least flat index)
and kills the components below speckle_size. The model keeps exactly
those edges, with the tile size as a parameter; its labels and kill must
equal _connected_component_labels and remove_small_segments_batch_plain,
so a logic error in the skip rules or in the split into tile parts shows
here before the card runs.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import post


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _joined(a, b, t):
    return (a >= 0) & (b >= 0) & (np.abs(a - b) <= t)


def _least_index_components(n, edges_from, edges_to):
    """Each node's component's least index over the undirected edges."""
    g = coo_matrix((np.ones(len(edges_from), np.int8),
                    (edges_from, edges_to)), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    least = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(least, comp, np.arange(n))
    return least[comp]


def union_plan(X, t, tile):
    """(horizontal, vertical) masks of the edges kernel L joins on
    [B, H, W] maps at tiles of ``tile`` = (rows, columns) (the kernel's:
    (32, 32)): a horizontal edge (y, x)-(y, x+1)
    and a vertical one (y, x)-(y+1, x) where the two pixels are joined,
    less the skipped ones. Inside a tile every joined horizontal pair
    joins through its row run. A vertical pair, inside a tile or across a
    row of tile edges, is skipped where x is not a tile's first column and
    its left neighbours are joined to each other and each to it; a
    horizontal pair across a column of tile edges where y is not a tile's
    first row and the pair above is."""
    B, H, W = X.shape
    th, tw = tile
    t = np.float32(t)
    hj = _joined(X[:, :, :-1], X[:, :, 1:], t)        # [B, H, W - 1]
    vj = _joined(X[:, :-1, :], X[:, 1:, :], t)        # [B, H - 1, W]
    y, x = np.arange(H), np.arange(W)
    red_h = np.zeros_like(hj)
    red_h[:, 1:, :] = hj[:, :-1, :] & vj[:, :, :-1] & vj[:, :, 1:]
    red_h &= (y % th > 0)[None, :, None]
    red_h &= (x[:-1] % tw == tw - 1)[None, None, :]
    red_v = np.zeros_like(vj)
    red_v[:, :, 1:] = vj[:, :, :-1] & hj[:, :-1, :] & hj[:, 1:, :]
    red_v &= (x % tw > 0)[None, None, :]
    return hj & ~red_h, vj & ~red_v


def kernel_l_model(X, t, size, tile):
    """Kernel L's phases on [B, H, W] float32 maps in numpy, at tiles of
    ``tile`` = (rows, columns): (out,
    labels). (a) tile parts over the edges inside a tile, each with its
    valid count at its least index; (b) the border edges unite the parts;
    (c) each part's count is added at its component's least index; (d)
    the kill and each pixel's label (an invalid pixel's own index)."""
    B, H, W = X.shape
    n = B * H * W
    h, v = union_plan(X, t, tile)
    th, tw = tile
    idx = np.arange(n).reshape(B, H, W)
    y, x = np.arange(H), np.arange(W)
    h_in = h & (x[:-1] % tw != tw - 1)[None, None, :]
    v_in = v & (y[:-1] % th != th - 1)[None, :, None]
    fr = [idx[:, :, :-1][h_in], idx[:, :-1, :][v_in]]
    to = [idx[:, :, 1:][h_in], idx[:, 1:, :][v_in]]
    part = _least_index_components(n, np.concatenate(fr), np.concatenate(to))
    valid = (X >= 0).reshape(-1)
    part_count = np.bincount(part[valid], minlength=n)
    # (b): the border edges, on the parts' roots
    fr = [part[idx[:, :, :-1][h & ~h_in]], part[idx[:, :-1, :][v & ~v_in]]]
    to = [part[idx[:, :, 1:][h & ~h_in]], part[idx[:, 1:, :][v & ~v_in]]]
    root = _least_index_components(n, np.concatenate(fr),
                                   np.concatenate(to))[part]
    # (c): one add a tile part
    parts = np.flatnonzero(valid & (part == np.arange(n)))
    count = np.zeros(n, np.int64)
    np.add.at(count, root[parts], part_count[parts])
    kill = valid & (count[root] < size)
    out = np.where(kill.reshape(X.shape), np.float32(-10.0), X)
    labels = np.where(valid, root, np.arange(n)) - (np.arange(n) // (H * W)
                                                    ) * (H * W)
    return out, labels.reshape(X.shape)


def _hold(D, params, tiles):
    """The model at each tile size against the plain versions."""
    X = D.reshape(-1, *D.shape[-2:])
    want_lbl = post._connected_component_labels(X,
                                                params.speckle_sim_threshold)
    kill = post._small_segment_kill_batch(want_lbl, X >= 0,
                                          post.speckle_size_eff(params))
    # remove_small_segments_batch_plain's own body, on labels computed
    # once; held against the function itself where that is quick
    want = torch.where(kill, -10.0, X)
    if X.numel() <= 1_000_000:
        assert torch.equal(want.view(torch.int32),
                           post.remove_small_segments_batch_plain(
                               X, params).view(torch.int32))
    for tile in tiles:
        out, lbl = kernel_l_model(X.numpy(), params.speckle_sim_threshold,
                                  post.speckle_size_eff(params), tile)
        assert np.array_equal(lbl, want_lbl.numpy()), tile
        assert np.array_equal(out.view(np.int32),
                              want.numpy().view(np.int32)), tile


@pytest.mark.parametrize("t", [0.0, 1.0, 12.0, 100.0])
def test_union_plan_on_seeded_maps(t):
    """Seeded integer, quarter-step and smooth maps with holes (-10, NaN)
    at thresholds 0, 1, 12 and 100, at the kernel's tile of 32 x 32 and
    at tiles of 16 x 32, 7 x 7 and 4 x 5 (many borders, corners and
    partial tiles)."""
    rng = np.random.default_rng(int(t))
    maps = [rng.integers(-3, 20, (3, 70, 101)).astype(np.float32),
            np.round(rng.random((2, 64, 96)) * 24) / 4,
            np.round(rng.random((2, 45, 77)) * 3
                     + np.linspace(0, 60, 77)).astype(np.float32)]
    for D in maps:
        D = D.astype(np.float32)
        D[D < 0] = -10.0
        D[rng.random(D.shape) < 0.03] = np.nan
        D[rng.random(D.shape) < 0.03] = -10.0
        p = dataclasses.replace(ElasParams(), speckle_sim_threshold=t,
                                speckle_size=int(rng.integers(1, 40)))
        _hold(torch.from_numpy(D), p, ((32, 32), (16, 32), (7, 7), (4, 5)))


@pytest.mark.parametrize("case", range(23))
def test_union_plan_on_the_kernel_edge_cases(case):
    """chip_smoke.SPECKLE_EDGE_CASES, as the card holds kernel L on them:
    the model at the kernel's tile of 32 x 32 and at tiles of 5 x 5."""
    from chip_smoke import SPECKLE_EDGE_CASES, speckle_edge_case

    assert len(SPECKLE_EDGE_CASES) == 23
    D, p = speckle_edge_case(SPECKLE_EDGE_CASES[case], "cpu")
    _hold(D, p, ((32, 32), (5, 5)))


def test_union_plan_skips_the_redundant_unites():
    """On one smooth component the skip rules leave one column unite a
    pair of rows of a tile and one unite a tile edge, where every joined
    pair would unite without them."""
    X = np.full((1, 64, 64), 3.0, np.float32)
    h, v = union_plan(X, 1.0, (32, 32))
    assert int(v.sum()) == 2 * 63            # a tile's row pair: x = 0, 32
    assert int(h[:, :, 31].sum()) == 2       # the column of edges: y = 0, 32
    assert int(h.sum()) == 64 * 62 + 2       # every in-tile pair, joined
