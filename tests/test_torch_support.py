"""Port support search (the support kernel's plain version + epilogue) ==
JAX support_candidates == libelas stage fixture."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas.support import support_candidates as jax_support
from jackal_tpu.ops.descriptor import create_descriptor as jax_descriptor
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import support as sm
from jackal_tpu_torch.matching.elas.native_prior import (
    collect_support_points_native)
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


def _pair(seed, H, W, shift):
    rng = np.random.default_rng(seed)
    l = (rng.random((2, H, W)) * 255).astype(np.uint8)
    r = np.stack([np.roll(l[0], shift, axis=1),
                  (rng.random((H, W)) * 255).astype(np.uint8)])
    return l, r


@pytest.mark.parametrize("H,W,disp_max,disp_min", [
    (60, 160, 47, 0),     # the Pallas kernel test's shapes, B = 2
    (43, 101, 30, 4),     # odd sizes, nonzero disp_min
])
def test_support_candidates_match_jax(H, W, disp_max, disp_min):
    l, r = _pair(4, H, W, -9)     # frame 0: right(u - 9) = left(u)
    kw = dict(disp_max=disp_max, disp_min=disp_min)
    d1 = jax.vmap(jax_descriptor)(jnp.asarray(l))
    d2 = jax.vmap(jax_descriptor)(jnp.asarray(r))
    want = np.asarray(jax.vmap(
        lambda a, b: jax_support(a, b, JaxElasParams(**kw)))(d1, d2))
    got = sm.support_candidates(create_descriptor(torch.from_numpy(l)),
                                create_descriptor(torch.from_numpy(r)),
                                ElasParams(**kw))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((want[0] == 9).sum() > 20) and (want[1] > 0).sum() < 5


def test_support_points_match_stage_fixture():
    z = np.load(f"{FIX}/elas_stages_st160.npz")
    d1 = create_descriptor(torch.from_numpy(z["left"]))[None]
    d2 = create_descriptor(torch.from_numpy(z["right"]))[None]
    dcan = sm.support_candidates(d1, d2)[0].numpy()
    H, W = z["left"].shape
    sp = collect_support_points_native(dcan, ElasParams(), W, H)
    np.testing.assert_array_equal(sp, z["support"])


def test_key_maps_follow_the_sequential_best_two_rule():
    """The four key maps equal a direct best-two over the full cost volume
    (keys unique in d, dead keys _KBIG)."""
    rng = np.random.default_rng(11)
    B, nv, W, D = 2, 3, 40, 24
    Q = torch.from_numpy(rng.integers(0, 256, (B, nv, W, 32)).astype(np.uint8))
    T = torch.from_numpy(rng.integers(0, 256, (B, nv, W, 32)).astype(np.uint8))
    l1, l2, r1, r2 = sm.support_keys_plain(Q, T, 2, D)
    q, t = Q.numpy().astype(np.int64), T.numpy().astype(np.int64)

    def S(x, y):
        return np.abs(q[:, :, x] - t[:, :, y]).sum(-1)

    for c in range(W):
        kl = [S(c - 2, c - 2 - d) + S(c + 2, c + 2 - d)
              for d in range(2, D) if d + 5 <= c <= W - 6]
        kr = [S(c + d - 2, c - 2) + S(c + d + 2, c + 2)
              for d in range(2, D) if 5 <= c <= W - 5 - d]
        dl = [d for d in range(2, D) if d + 5 <= c <= W - 6]
        dr = [d for d in range(2, D) if 5 <= c <= W - 5 - d]
        for keys, ds, k1, k2 in ((kl, dl, l1, l2), (kr, dr, r1, r2)):
            stack = np.full((B * nv, len(ds) + 2), sm._KBIG, np.int64)
            for i, (k, d) in enumerate(zip(keys, ds)):
                stack[:, i] = k.reshape(-1) * 512 + d
            stack.sort(axis=1)
            np.testing.assert_array_equal(k1[:, :, c].reshape(-1), stack[:, 0])
            np.testing.assert_array_equal(k2[:, :, c].reshape(-1), stack[:, 1])


def _merge(a, b):
    """The CUDA kernel's merge of two d ranges' best-two pairs."""
    (a1, a2), (b1, b2) = a, b
    return (torch.minimum(a1, b1),
            torch.minimum(torch.maximum(a1, b1), torch.minimum(a2, b2)))


@pytest.mark.parametrize("case,B,nv,W,cuts", [
    ("random", 2, 3, 48, (0, 8, 16, 24)),
    ("constant", 1, 2, 40, (0, 5, 10, 15, 20)),       # every cost ties
    ("random", 2, 2, 50, (3, 4, 13, 29)),             # disp_min > 0, uneven
    ("random", 1, 3, 20, (0, 7, 16, 32)),             # W < D: dead ranges
])
def test_key_maps_merge_over_d_ranges(case, B, nv, W, cuts):
    """The key maps over [disp_min, D) equal the merge of the key maps over
    sub-ranges [lo, hi): the CUDA kernel's blocks own d ranges and a second
    launch merges their best-two pairs this way. The live masks do not
    depend on D, so each sub-range's plain maps are a block's partial."""
    rng = np.random.default_rng(W)
    shape = (B, nv, W, 32)
    if case == "constant":
        Q = torch.full(shape, 7, dtype=torch.uint8)
        T = Q.clone()
    else:
        Q = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
        T = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    want = sm.support_keys_plain(Q, T, cuts[0], cuts[-1])
    parts = [sm.support_keys_plain(Q, T, lo, hi)
             for lo, hi in zip(cuts[:-1], cuts[1:])]
    left, right = parts[0][:2], parts[0][2:]
    for p in parts[1:]:
        left, right = _merge(left, p[:2]), _merge(right, p[2:])
    for got, w in zip(left + right, want):
        assert torch.equal(got, w)
    if case == "constant":          # all ties: the lowest two d win
        assert bool((want[0][:, :, 20:35] == cuts[0]).all())
        assert bool((want[1][:, :, 20:35] == cuts[0] + 1).all())
    if W < cuts[-1]:                # no live key in the top range
        assert bool((torch.stack(parts[-1]) == sm._KBIG).all())
