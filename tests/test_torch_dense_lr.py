"""Dense matching with the L/R check (dense_match_pair_lr: on the card one
launch of the dense kernel with the check as its row epilogue) and the
postprocess split after the check (postprocess_after_lr), on the CPU,
where they run their plain versions, held exactly against the JAX
package: its dense_match of both views then its L/R check, and its
postprocess_batch."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas import post as jpost
from jackal_tpu.matching.elas.dense import dense_match as jax_dense
from jackal_tpu.matching.elas.prior import create_grid, rasterize_planes
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import dense as dm
from jackal_tpu_torch.matching.elas import post
from jackal_tpu_torch.ops.descriptor import create_descriptor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops (test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIX = "tests/fixtures"


def _params(preset: str, **kw):
    """(port, JAX) ElasParams of a preset name with the fields kw;
    "subsampling" is ROBOTICS with half-resolution maps."""
    if preset == "subsampling":
        preset, kw = "robotics", dict(kw, subsampling=True)
    return (dataclasses.replace(getattr(ElasParams, preset)(), **kw),
            dataclasses.replace(getattr(JaxElasParams, preset)(), **kw))


@functools.lru_cache(maxsize=None)
def _stage_views(fixture: str):
    """The stage fixture's descriptors and each view's prior maps
    (d_plane, plane_valid, covered, candidate grid), rasterised by the JAX
    package from libelas's support points, triangles and planes."""
    z = np.load(f"{FIX}/{fixture}.npz")
    sp = z["support"]
    H, W = z["left"].shape
    views = []
    for right in (False, True):
        maps = rasterize_planes(sp, z["tri2" if right else "tri1"],
                                z["planes2" if right else "planes1"], W, H,
                                right)
        views.append((np.asarray(maps.d_plane), np.asarray(maps.valid),
                      np.asarray(maps.tri_id) >= 0,
                      np.asarray(create_grid(sp, W, H, right))))
    return z, views


@functools.lru_cache(maxsize=None)
def _jax_dense(fixture: str, preset: str):
    """The JAX package's dense_match of both views on the stage fixture."""
    z, views = _stage_views(fixture)
    _, jp = _params(preset)
    d1, d2 = jnp.asarray(z["desc1"]), jnp.asarray(z["desc2"])
    return tuple(np.asarray(jax_dense(d1, d2, *(jnp.asarray(a) for a in v),
                                      jp, right))
                 for v, right in zip(views, (False, True)))


@pytest.mark.parametrize("smax", [-1, 0, 7])
@pytest.mark.parametrize("preset", ["robotics", "middlebury"])
def test_dense_match_pair_lr_equals_jax(preset, smax):
    """dense_match_pair_lr on CPU tensors == the JAX dense_match of both
    views followed by its left_right_consistency_check, on the libelas
    stage fixture's priors, at sweep bounds disp_max (-1), 0 and 7; at
    ROBOTICS and disp_max it is libelas's own L/R stage."""
    tp, jp = _params(preset)
    z, views = _stage_views("elas_stages_st160")
    J1, J2 = _jax_dense("elas_stages_st160", preset)
    want = jpost.left_right_consistency_check(jnp.asarray(J1),
                                              jnp.asarray(J2), jp, smax)
    t1, t2 = (create_descriptor(torch.from_numpy(z[k]))[None]
              for k in ("left", "right"))
    maps = [[torch.from_numpy(np.ascontiguousarray(a))[None]
             for a in (*v[:3], dm.pack_grid(v[3]))] for v in views]
    got = dm.dense_match_pair_lr(t1, t2, *maps, tp, smax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    if preset == "robotics" and smax == -1:
        np.testing.assert_array_equal(got[0][0].numpy(), z["lr_D1"])
        np.testing.assert_array_equal(got[1][0].numpy(), z["lr_D2"])
    assert (got[0] >= 0).float().mean() > 0.1


def _noisy_disparity(seed, H, W):
    """Piecewise-smooth disparities with holes, speckles and fractions."""
    rng = np.random.default_rng(seed)
    D = (rng.random((H, W)) * 4 + np.linspace(5, 60, W)[None, :])
    D = np.round(D * 2) / 2
    D[rng.random((H, W)) < 0.25] = -10.0
    D[rng.random((H, W)) < 0.05] = -1.0
    D[:, :3] = -10.0
    return D.astype(np.float32)


@pytest.mark.parametrize("lr_smax", [-1, 32])
@pytest.mark.parametrize("preset", ["robotics", "middlebury", "subsampling"])
def test_postprocess_split_equals_jax_postprocess_batch(preset, lr_smax):
    """On a batch of two: postprocess_batch, and the L/R check followed by
    postprocess_after_lr (the batched path's split after
    dense_match_pair_lr), each == the JAX package's postprocess_batch."""
    tp, jp = _params(preset)
    D1 = np.stack([_noisy_disparity(s, 41, 67) for s in (21, 22)])
    D2 = np.stack([_noisy_disparity(s, 41, 67) for s in (23, 24)])
    # a blob smaller than the speckle size, which the filter removes
    D1[1, 10:14, 40:44] = 70.0
    want = jpost.postprocess_batch(jnp.asarray(D1), jnp.asarray(D2), jp,
                                   lr_smax)
    T1, T2 = torch.from_numpy(D1), torch.from_numpy(D2)
    whole = post.postprocess_batch(T1, T2, tp, lr_smax)
    split = post.postprocess_after_lr(
        *post.left_right_consistency_check(T1, T2, tp, lr_smax), tp)
    for got in (whole, split):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
