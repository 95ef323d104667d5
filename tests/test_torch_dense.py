"""Port dense matching (the dense kernel's plain version) == JAX
dense_match == libelas stage fixture, both views."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas.dense import dense_match as jax_dense
from jackal_tpu.matching.elas.prior import create_grid, rasterize_planes
from jackal_tpu.ops.descriptor import create_descriptor as jax_descriptor
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import dense as dm
from jackal_tpu_torch.ops.descriptor import create_descriptor

FIX = "tests/fixtures"


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a))[None] for a in arrays]


@pytest.mark.parametrize("right_image", [False, True])
@pytest.mark.parametrize("H,W,preset", [
    (40, 128, "robotics"),     # the Pallas kernel test's shapes
    (33, 75, "middlebury"),    # odd sizes, plane radius 3, no texture gate
])
def test_dense_matches_jax(H, W, preset, right_image):
    rng = np.random.default_rng(H * W)
    jp = dataclasses.replace(getattr(JaxElasParams, preset)(), disp_max=63)
    tp = dataclasses.replace(getattr(ElasParams, preset)(), disp_max=63)
    left = (rng.random((H, W)) * 255).astype(np.uint8)
    right = np.roll(left, 7, axis=1)
    d_plane = rng.integers(-3, 40, (H, W)).astype(np.int32)
    valid = rng.random((H, W)) < 0.7
    covered = rng.random((H, W)) < 0.9
    grid = rng.random((-(-H // 20), -(-W // 20), tp.disp_num)) < 0.1
    d1, d2 = jax_descriptor(jnp.asarray(left)), jax_descriptor(jnp.asarray(right))
    want = np.asarray(jax_dense(d1, d2, jnp.asarray(d_plane),
                                jnp.asarray(valid), jnp.asarray(covered),
                                jnp.asarray(grid), jp, right_image))
    t1 = create_descriptor(torch.from_numpy(np.stack([left])))
    t2 = create_descriptor(torch.from_numpy(np.stack([right])))
    got = dm.dense_match(t1, t2, *_t(d_plane, valid, covered,
                                     dm.pack_grid(grid)), tp,
                         right_image)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).mean() > 0.3


@pytest.mark.parametrize("right", [False, True])
def test_dense_matches_stage_fixture(right):
    z = np.load(f"{FIX}/elas_stages_st160.npz")
    sp = z["support"]
    H, W = z["left"].shape
    maps = rasterize_planes(sp, z["tri2" if right else "tri1"],
                            z["planes2" if right else "planes1"], W, H, right)
    grid = create_grid(sp, W, H, right)
    t1 = create_descriptor(torch.from_numpy(z["left"]))[None]
    t2 = create_descriptor(torch.from_numpy(z["right"]))[None]
    got = dm.dense_match(t1, t2, *_t(maps.d_plane, maps.valid,
                                     maps.tri_id >= 0, dm.pack_grid(grid)),
                         ElasParams(), right)[0].numpy()
    np.testing.assert_array_equal(got, z["dense_D2" if right else "dense_D1"])


def test_pack_grid_bits():
    rng = np.random.default_rng(3)
    g = rng.random((2, 3, 4, 70)) < 0.5
    words = dm.pack_grid(g).view(np.uint32)
    assert words.shape == (2, 3, 4, 3)
    d = np.arange(96)
    bits = (words[..., d // 32] >> (d % 32)) & 1
    np.testing.assert_array_equal(bits[..., :70].astype(bool), g)
    assert not bits[..., 70:].any()
