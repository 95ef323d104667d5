"""The port's ELAS postprocess chain on the CPU (the plain versions the card's
kernels H-K equal bit for bit), held against the JAX package: the whole
chain of one frame, the tail with one view or both, and the L/R check's
sweep bound. Every comparison is exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import ElasParams as JaxElasParams
from jackal_tpu.matching.elas import post as jpost
from jackal_tpu_torch.config import ElasParams
from jackal_tpu_torch.matching.elas import post


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops (test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(preset: str, **kw):
    """(port, JAX) ElasParams of a preset name with the fields kw;
    "subsampling" is ROBOTICS with half-resolution maps."""
    if preset == "subsampling":
        tp, jp = ElasParams(), JaxElasParams()
        kw = dict(kw, subsampling=True)
    else:
        tp, jp = getattr(ElasParams, preset)(), getattr(JaxElasParams, preset)()
    return dataclasses.replace(tp, **kw), dataclasses.replace(jp, **kw)


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
def test_postprocess_batch_of_one_equals_jax_postprocess(preset, lr_smax):
    """postprocess_batch on one frame is the JAX package's per-frame
    postprocess: L/R check, device speckle, gaps, adaptive mean (the 4-tap
    one under subsampling), median and postprocess_only_left."""
    tp, jp = _params(preset)
    D1 = _noisy_disparity(3, 48, 83)
    D2 = _noisy_disparity(4, 48, 83)
    # a blob smaller than the speckle size, which the filter removes
    D1[10:14, 40:44] = 70.0
    want = jpost.postprocess(jnp.asarray(D1), jnp.asarray(D2), jp, lr_smax)
    got = post.postprocess_batch(torch.from_numpy(D1)[None],
                                 torch.from_numpy(D2)[None], tp, lr_smax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("only_left", [True, False])
@pytest.mark.parametrize("preset", ["robotics", "middlebury", "subsampling"])
def test_post_tail_equals_jax(preset, only_left):
    """post_tail takes both views through each step together; on one frame
    and on a batch of two it equals the JAX package's per-frame post_tail,
    and with postprocess_only_left D2 comes back untouched."""
    tp, jp = _params(preset, postprocess_only_left=only_left)
    D1 = np.stack([_noisy_disparity(s, 37, 50) for s in (5, 6)])
    D2 = np.stack([_noisy_disparity(s, 37, 50) for s in (7, 8)])
    want = [jpost.post_tail(jnp.asarray(D1[b]), jnp.asarray(D2[b]), jp)
            for b in range(2)]
    T1, T2 = torch.from_numpy(D1), torch.from_numpy(D2)
    one = post.post_tail(T1[0], T2[0], tp)
    both = post.post_tail(T1, T2, tp)
    for v in (0, 1):
        np.testing.assert_array_equal(one[v].numpy(), np.asarray(want[0][v]))
        for b in range(2):
            np.testing.assert_array_equal(both[v][b].numpy(),
                                          np.asarray(want[b][v]))
    if only_left:
        assert both[1] is T2


@pytest.mark.parametrize("smax", [0, 7, 300])
def test_lr_check_sweep_bound_equals_jax(smax):
    """The L/R check's sweep bound at 0, inside the disparity range and
    past disp_max (where it is disp_max), on a batch of two frames."""
    tp, jp = _params("robotics")
    D1 = np.stack([_noisy_disparity(s, 29, 71) for s in (9, 10)])
    D2 = np.stack([_noisy_disparity(s, 29, 71) for s in (11, 12)])
    got = post.left_right_consistency_check(torch.from_numpy(D1),
                                            torch.from_numpy(D2), tp, smax)
    for b in range(2):
        want = jpost.left_right_consistency_check(
            jnp.asarray(D1[b]), jnp.asarray(D2[b]), jp, smax)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
