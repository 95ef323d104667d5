"""Port dense matching (the dense kernel's plain version) == JAX
dense_match == libelas stage fixture, both views; the pair wrapper
(dense_match_pair, one kernel launch for both views on the card) == two
JAX calls and the fixture."""
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


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a))[None] for a in arrays]


def _presets(preset):
    """(JAX, port) ElasParams of a preset at D = 64. "robotics_r9" is
    ROBOTICS with sradius 9: plane radius ceil(sigma * sradius) = 9, past
    the card kernel's unrolled radii (2 to 7)."""
    name, _, sradius = preset.partition("_r")
    kw = dict(disp_max=63, **({"sradius": float(sradius)} if sradius else {}))
    jp = dataclasses.replace(getattr(JaxElasParams, name)(), **kw)
    tp = dataclasses.replace(getattr(ElasParams, name)(), **kw)
    assert jp.plane_radius == tp.plane_radius == (int(sradius) if sradius
                                                  else tp.plane_radius)
    return jp, tp


@pytest.mark.parametrize("right_image", [False, True])
@pytest.mark.parametrize("H,W,preset", [
    (40, 128, "robotics"),     # the Pallas kernel test's shapes
    (33, 75, "middlebury"),    # odd sizes, plane radius 3, no texture gate
    (40, 128, "robotics_r9"),  # plane radius 9
])
def test_dense_matches_jax(H, W, preset, right_image):
    rng = np.random.default_rng(H * W)
    jp, tp = _presets(preset)
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


@pytest.mark.parametrize("H,W,preset", [(40, 128, "robotics"),
                                         (33, 75, "middlebury"),
                                         (33, 75, "robotics_r9")])
def test_dense_pair_matches_jax(H, W, preset):
    """dense_match_pair on CPU tensors == the JAX package's dense_match of
    each view, each view with its own prior maps (also at plane radius 9)."""
    rng = np.random.default_rng(H + W)
    jp, tp = _presets(preset)
    left = (rng.random((H, W)) * 255).astype(np.uint8)
    right = np.roll(left, 7, axis=1)
    maps = [(rng.integers(-3, 40, (H, W)).astype(np.int32),
             rng.random((H, W)) < 0.7, rng.random((H, W)) < 0.9,
             rng.random((-(-H // 20), -(-W // 20), tp.disp_num)) < 0.1)
            for _ in range(2)]
    d1, d2 = jax_descriptor(jnp.asarray(left)), jax_descriptor(jnp.asarray(right))
    want = [np.asarray(jax_dense(d1, d2, *(jnp.asarray(a) for a in m), jp,
                                 right_image))
            for m, right_image in zip(maps, (False, True))]
    t1 = create_descriptor(torch.from_numpy(np.stack([left])))
    t2 = create_descriptor(torch.from_numpy(np.stack([right])))
    got = dm.dense_match_pair(
        t1, t2, *(_t(*m[:3], dm.pack_grid(m[3])) for m in maps), tp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w)
        assert (w >= 0).mean() > 0.3


def test_dense_pair_matches_stage_fixture():
    z = np.load(f"{FIX}/elas_stages_st160.npz")
    sp = z["support"]
    H, W = z["left"].shape
    views = []
    for right in (False, True):
        maps = rasterize_planes(sp, z["tri2" if right else "tri1"],
                                z["planes2" if right else "planes1"], W, H,
                                right)
        views.append(_t(maps.d_plane, maps.valid, maps.tri_id >= 0,
                        dm.pack_grid(create_grid(sp, W, H, right))))
    t1 = create_descriptor(torch.from_numpy(z["left"]))[None]
    t2 = create_descriptor(torch.from_numpy(z["right"]))[None]
    D1, D2 = dm.dense_match_pair(t1, t2, *views, ElasParams())
    np.testing.assert_array_equal(D1[0].numpy(), z["dense_D1"])
    np.testing.assert_array_equal(D2[0].numpy(), z["dense_D2"])


def test_pack_grid_bits():
    rng = np.random.default_rng(3)
    g = rng.random((2, 3, 4, 70)) < 0.5
    words = dm.pack_grid(g).view(np.uint32)
    assert words.shape == (2, 3, 4, 3)
    d = np.arange(96)
    bits = (words[..., d // 32] >> (d % 32)) & 1
    np.testing.assert_array_equal(bits[..., :70].astype(bool), g)
    assert not bits[..., 70:].any()
