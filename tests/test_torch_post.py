"""Port postprocess == JAX post.py == libelas stage fixture."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas import post as jpost
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import post
from jackal_tpu_torch.matching.elas.native_prior import (
    remove_small_segments_native)

FIX = "tests/fixtures"


@pytest.fixture(scope="module")
def st160():
    return np.load(f"{FIX}/elas_stages_st160.npz")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_stage_chain_matches_fixture(st160):
    """L/R check -> native speckle -> gap fill -> adaptive mean, each
    stage bit-equal to the reference build's dump of that stage."""
    z = st160
    L1, L2 = post.left_right_consistency_check(_t(z["dense_D1"]),
                                               _t(z["dense_D2"]))
    np.testing.assert_array_equal(L1.numpy(), z["lr_D1"])
    np.testing.assert_array_equal(L2.numpy(), z["lr_D2"])
    S1 = remove_small_segments_native(z["lr_D1"], ElasParams())
    np.testing.assert_array_equal(S1, z["speckle_D1"])
    G1 = post.gap_interpolation(_t(z["speckle_D1"]))
    np.testing.assert_array_equal(G1.numpy(), z["gap_D1"])
    A1 = post.adaptive_mean(_t(z["gap_D1"]))
    np.testing.assert_array_equal(A1.numpy(), z["final_D1"])


def _noisy_disparity(seed, H, W):
    """Piecewise-smooth disparities with holes, speckles and fractions."""
    rng = np.random.default_rng(seed)
    D = (rng.random((H, W)) * 4 + np.linspace(5, 60, W)[None, :])
    D = np.round(D * 2) / 2
    D[rng.random((H, W)) < 0.25] = -10.0
    D[rng.random((H, W)) < 0.05] = -1.0
    D[:, :3] = -10.0
    return D.astype(np.float32)


@pytest.mark.parametrize("preset", ["robotics", "middlebury"])
def test_post_matches_jax(preset):
    """The device tail under both presets: ROBOTICS (3-px gaps, adaptive
    mean) and MIDDLEBURY (5000-px gaps, corner extrapolation, median, both
    views)."""
    jp = getattr(JaxElasParams, preset)()
    tp = getattr(ElasParams, preset)()
    D1 = _noisy_disparity(1, 47, 83)
    D2 = _noisy_disparity(2, 47, 83)
    jL1, jL2 = jpost.left_right_consistency_check(jnp.asarray(D1),
                                                  jnp.asarray(D2), jp)
    L1, L2 = post.left_right_consistency_check(_t(D1), _t(D2), tp)
    np.testing.assert_array_equal(L1.numpy(), np.asarray(jL1))
    np.testing.assert_array_equal(L2.numpy(), np.asarray(jL2))
    # the tail on the raw maps (more holes than after an L/R check)
    jT1, jT2 = jpost.post_tail(jnp.asarray(D1), jnp.asarray(D2), jp)
    T1, T2 = post.post_tail(_t(D1), _t(D2), tp)
    np.testing.assert_array_equal(T1.numpy(), np.asarray(jT1))
    np.testing.assert_array_equal(T2.numpy(), np.asarray(jT2))


@pytest.mark.parametrize("name", ["median_filter", "adaptive_mean",
                                  "gap_wide"])
def test_filters_match_jax(name):
    D = _noisy_disparity(5, 30, 41)
    if name == "gap_wide":
        p = dataclasses.replace(ElasParams(), ipol_gap_width=40)
        jp = dataclasses.replace(JaxElasParams(), ipol_gap_width=40)
        got = post.gap_interpolation(_t(D), p)
        want = jpost.gap_interpolation(jnp.asarray(D), jp)
    else:
        got = getattr(post, name)(_t(D))
        want = getattr(jpost, name)(jnp.asarray(D))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
