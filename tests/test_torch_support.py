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
    l1, l2, r1, r2 = sm.support_keys(Q, T, 2, D)
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
