"""The port's rectify warp (geometry/remap.remap_bilinear, kernel N's plain
version on the CPU) == jackal_tpu's remap_bilinear and remap_bilinear_batch,
bit for bit, where the map leaves the int32 range of 2^15 * coordinate:
NaN coordinates (XLA's convert gives 0), +-70000 and +-2e9 (it saturates).
torch's own float -> int32 cast gives INT32_MIN for all of them on x86."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.geometry.remap import remap_bilinear as jax_remap
from jackal_tpu.geometry.remap import remap_bilinear_batch as jax_remap_batch
from jackal_tpu_torch.geometry.remap import (remap_bilinear,
                                             remap_bilinear_pair)

SPECIALS = np.array([np.nan, 70000.0, -70000.0, 2e9, -2e9, np.inf, -np.inf,
                     0.5, -0.5, -1.0, 3.25], np.float32)


def _maps(seed, Ho, Wo, H, W):
    """Seeded coordinates over the frame and a pixel past each border,
    with SPECIALS in either map at random places."""
    rng = np.random.default_rng(seed)
    mx = (rng.random((Ho, Wo)) * (W + 2) - 1).astype(np.float32)
    my = (rng.random((Ho, Wo)) * (H + 2) - 1).astype(np.float32)
    for m in (mx, my):
        hit = rng.random((Ho, Wo)) < 0.2
        m[hit] = rng.choice(SPECIALS, int(hit.sum()))
    return mx, my


def test_nan_and_out_of_range_coordinates_equal_jax():
    """The input that first showed the fault: the port gave 0 at [0, 3]
    (mapx NaN) where the reference reads img[1, 0]."""
    img = np.random.default_rng(0).integers(0, 256, (8, 10)).astype(np.uint8)
    mx = np.array([[0.5, 70000, -70000, np.nan, 3.25, 2e9]], np.float32)
    my = np.array([[0.5, 1, 1, 1, np.nan, 1]], np.float32)
    want = np.asarray(jax_remap(jnp.asarray(img), jnp.asarray(mx),
                                jnp.asarray(my)))
    np.testing.assert_array_equal(
        want, np.asarray(jax_remap_batch(jnp.asarray(img[None]),
                                         jnp.asarray(mx), jnp.asarray(my)))[0])
    got = remap_bilinear(torch.from_numpy(img), torch.from_numpy(mx),
                         torch.from_numpy(my)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 3] == img[1, 0]


@pytest.mark.parametrize("Ho,Wo", [(7, 9), (23, 31)],
                         ids=["map inside the frame", "map larger than it"])
def test_batch_and_colour_equal_jax(Ho, Wo):
    """A batch of 3 against remap_bilinear_batch, colour [H, W, 3] (its
    channels on the port's batch axis) against remap_bilinear, and the
    pair call against two calls; the maps hold SPECIALS."""
    H, W = 12, 17
    rng = np.random.default_rng(Ho)
    imgs = rng.integers(0, 256, (3, H, W)).astype(np.uint8)
    col = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    mx, my = _maps(Wo, Ho, Wo, H, W)
    jm = (jnp.asarray(mx), jnp.asarray(my))
    tm = (torch.from_numpy(mx), torch.from_numpy(my))
    want = np.asarray(jax_remap_batch(jnp.asarray(imgs), *jm))
    got = remap_bilinear(torch.from_numpy(imgs), *tm).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b], np.asarray(jax_remap(jnp.asarray(imgs[b]), *jm)))
    want_c = np.asarray(jax_remap(jnp.asarray(col), *jm))
    got_c = remap_bilinear(torch.from_numpy(col).movedim(-1, -3), *tm)
    np.testing.assert_array_equal(got_c.movedim(-3, -1).numpy(), want_c)
    rmap = tuple(torch.from_numpy(m) for m in _maps(Wo + 1, Ho, Wo, H, W))
    pl, pr = remap_bilinear_pair(torch.from_numpy(imgs),
                                 torch.from_numpy(imgs[::-1].copy()), tm,
                                 rmap)
    assert torch.equal(pl, torch.from_numpy(got))
    assert torch.equal(pr, remap_bilinear(torch.from_numpy(imgs[::-1].copy()),
                                          *rmap))
    assert (got > 0).any() and (got == 0).any()
