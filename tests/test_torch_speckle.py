"""The device speckle filter and the batched postprocess == jackal_tpu's,
bit for bit, and the speckle filter == the C++ BFS of the per-frame path:
component labels, remove_small_segments, remove_small_segments_batch in
both branches (run compaction, and the per-frame sort when a row holds
more runs than the compact slots), the int64 run scan for frames too
large for int32 keys, and postprocess_batch with the L/R sweep bound."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas import post as jpost
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import post
from jackal_tpu_torch.matching.elas.native_prior import (
    remove_small_segments_native)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(seed, shape, smooth):
    """Disparities with holes: piecewise-smooth (few runs per row) or
    random integers (a run every pixel or two)."""
    rng = np.random.default_rng(seed)
    if smooth:
        D = np.round(rng.random(shape) * 1.5 + np.linspace(5, 40, shape[-1]))
        D[rng.random(shape) < 0.08] = -10.0
        D[..., 5:9, :] = -10.0
    else:
        D = rng.integers(-1, 8, shape).astype(np.float64)
        D[D < 0] = -10.0
    return D.astype(np.float32)


def _spiral(n=60):
    d = np.full((n, n), -10.0, np.float32)
    x, y, dx, dy = 0, 0, 1, 0
    for s in [n - 1 - q // 2 for q in range(2 * n)]:
        if s <= 0:
            break
        for _ in range(s):
            d[y, x] = 7.0
            x, y = x + dx, y + dy
        dx, dy = -dy, dx
    return d


def test_component_labels_equal_jax():
    D = np.stack([_field(0, (50, 70), False), _spiral(70)[:50],
                  _field(1, (50, 70), True)])
    want = jax.jit(jax.vmap(lambda d: jpost._connected_component_labels(
        d, 1.0)))(jnp.asarray(D))
    got = post._connected_component_labels(torch.from_numpy(D), 1.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["random", "spiral", "threshold_edges"])
def test_remove_small_segments_equals_jax_and_bfs(case):
    if case == "random":
        D = _field(2, (60, 80), False)
    elif case == "spiral":
        D = _spiral()
    else:
        D = np.full((40, 200), -10.0, np.float32)
        D[10, :] = np.round(np.linspace(5, 25, 200))
        D[20, 0:150] = 7.0
        D[30, :] = np.where(np.arange(200) % 50 < 25, 3.0, 4.0)
    got = post.remove_small_segments(torch.from_numpy(D), ElasParams())
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jpost.remove_small_segments(jnp.asarray(D),
                                               JaxElasParams())))
    np.testing.assert_array_equal(
        got.numpy(), remove_small_segments_native(D, ElasParams()))


@pytest.mark.parametrize("branch", ["compact", "fallback"])
def test_remove_small_segments_batch_equals_jax(branch):
    """Compact: every row has at most min(128, W) runs. Fallback: random
    integer disparities give rows of more than 128 runs at W = 320."""
    if branch == "compact":
        D = np.stack([_field(3, (40, 90), True), _field(4, (40, 90), True),
                      _spiral(90)[:40]])
    else:
        D = np.stack([_field(5, (30, 320), False),
                      _field(6, (30, 320), True)])
    lbl = post._connected_component_labels(torch.from_numpy(D), 1.0)
    _, _, nruns = post._runs_along_rows(
        lbl.reshape(-1, D.shape[-1]), torch.from_numpy(D >= 0).reshape(
            -1, D.shape[-1]))
    assert (int(nruns) > min(post._RUN_CAP, D.shape[-1])) == \
        (branch == "fallback")
    got = post.remove_small_segments_batch(torch.from_numpy(D), ElasParams())
    want = jpost.remove_small_segments_batch(jnp.asarray(D), JaxElasParams())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(len(D)):
        np.testing.assert_array_equal(
            got[b].numpy(), remove_small_segments_native(D[b], ElasParams()))
    assert (got.numpy() != D).any()


def test_int64_run_scan_equals_jax_tuple_scan():
    """The run minimum that frames too large for int32 keys take, against
    the reference's segmented associative scan and the int32 form."""
    rng = np.random.default_rng(8)
    D = _field(9, (2, 24, 40), True)
    lbl = rng.integers(0, 24 * 40, D.shape).astype(np.int32)
    valid = D >= 0
    for dim, axis in ((-1, 2), (-2, 1)):
        conn = valid & np.roll(valid, 1, axis) & (
            np.abs(D - np.roll(D, 1, axis)) <= 1.0)
        if axis == 2:
            conn[:, :, 0] = False
        else:
            conn[:, 0, :] = False
        want = jax.jit(jax.vmap(lambda l, c: jpost._run_min_scan_tuple(
            l, c, axis - 1)))(jnp.asarray(lbl), jnp.asarray(conn))
        tl, tc = torch.from_numpy(lbl), torch.from_numpy(conn)
        got = post._run_min_scan_tuple(tl, tc, dim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        k = post._label_bits(24 * 40)
        packed = post._run_min_scan_packed(
            tl, post._seg_terms(tc, dim, k), dim, k)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(want))


def _dense_pair(seed, B, H, W):
    """Dense-matcher-like views: nearly fronto-parallel (D2(u - d) agrees
    with D1(u) within a pixel), with holes, -1 and -10 codes, and a band at
    d = 45 that only a sweep past 45 finds consistent."""
    rng = np.random.default_rng(seed)
    base = np.linspace(4, 12, W)
    D1 = np.round(rng.random((B, H, W)) + base)
    D2 = np.round(rng.random((B, H, W)) + base)
    D1[:, :, 60:70] = 45.0
    D2[:, :, 15:25] = 45.0
    for D in (D1, D2):
        D[rng.random(D.shape) < 0.1] = -10.0
        D[rng.random(D.shape) < 0.05] = -1.0
    return D1.astype(np.float32), D2.astype(np.float32)


@pytest.mark.parametrize("preset,lr_smax", [("robotics", 32),
                                            ("middlebury", -1)])
def test_postprocess_batch_equals_jax(preset, lr_smax):
    """The whole batched postprocess; ROBOTICS with a sweep bound below the
    largest disparity (shifts past it clamp, as the reference's), and
    MIDDLEBURY (both views, median, corner extrapolation) with the full
    sweep."""
    jp = getattr(JaxElasParams, preset)()
    tp = getattr(ElasParams, preset)()
    if preset == "robotics":
        jp = dataclasses.replace(jp, speckle_size=20)
        tp = dataclasses.replace(tp, speckle_size=20)
    D1, D2 = _dense_pair(len(preset), 2, 40, 96)
    W1, W2 = jpost.postprocess_batch(jnp.asarray(D1), jnp.asarray(D2), jp,
                                     lr_smax)
    G1, G2 = post.postprocess_batch(torch.from_numpy(D1),
                                    torch.from_numpy(D2), tp, lr_smax)
    np.testing.assert_array_equal(G1.numpy(), np.asarray(W1))
    np.testing.assert_array_equal(G2.numpy(), np.asarray(W2))
    assert (np.asarray(W1) >= 0).mean() > 0.2
    if lr_smax >= 0:
        L1, _ = post.left_right_consistency_check(
            torch.from_numpy(D1), torch.from_numpy(D2), tp)
        S1, _ = post.left_right_consistency_check(
            torch.from_numpy(D1), torch.from_numpy(D2), tp, lr_smax)
        assert not torch.equal(L1, S1)     # the bound changes the result
