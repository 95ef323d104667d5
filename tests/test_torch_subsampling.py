"""ELAS subsampling (ElasParams.subsampling, elas.h:82-84) in the port on
the CPU == libelas's stage fixtures and jackal_tpu's, bit for bit.

The half-resolution descriptor against the JAX function and the fixture's
desc1/desc2; the support points against the fixture's; elas_match with the
fixture's triangulations against libelas's final_D1 (as
tests/test_elas.py does for the reference); elas_match end to end against
jackal_tpu's on elas_golden_sub320; the subsampled adaptive mean and L/R
check against the JAX functions on seeded maps; the batched entry points'
refusal; and the node's process_frame, which fails in its scan in both
packages (half-size maps against the full-size valid-disparity cache).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu import config as jconfig
from jackal_tpu.matching.elas import pipeline as jpipe
from jackal_tpu.matching.elas import post as jpost
from jackal_tpu.ops.descriptor import create_descriptor as jax_descriptor
from jackal_tpu.pipeline.default import default_calibration as jax_calib
from jackal_tpu.pipeline.frame_pipeline import StereoPipeline as JaxPipeline
from jackal_tpu_torch.config import ElasParams, PipelineParams
from jackal_tpu_torch.matching.elas import post
from jackal_tpu_torch.matching.elas.native_prior import (
    collect_support_points_native)
from jackal_tpu_torch.matching.elas.pipeline import (
    elas_match, elas_match_batch, elas_match_batch_device, elas_match_stream)
from jackal_tpu_torch.matching.elas.support import support_candidates
from jackal_tpu_torch.ops.descriptor import create_descriptor
from jackal_tpu_torch.pipeline.default import default_calibration
from jackal_tpu_torch.pipeline.frame_pipeline import StereoPipeline
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

FIX = "tests/fixtures"
SUB = ElasParams(subsampling=True)
JSUB = jconfig.ElasParams(subsampling=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops (workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stages():
    return np.load(f"{FIX}/elas_stages_sub320.npz")


@pytest.mark.parametrize("side", ["left", "right"])
def test_half_resolution_descriptor(stages, side):
    img = stages[side]
    got = create_descriptor(torch.from_numpy(img), True).numpy()
    np.testing.assert_array_equal(got, stages["desc1" if side == "left"
                                              else "desc2"])
    np.testing.assert_array_equal(
        got, np.asarray(jax_descriptor(jnp.asarray(img), True)))
    # odd shapes: the kept rows are the even 4 <= v <= H-4
    odd = np.random.default_rng(9).integers(0, 256, (11, 13)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        create_descriptor(torch.from_numpy(odd), True).numpy(),
        np.asarray(jax_descriptor(jnp.asarray(odd), True)))


def test_support_points(stages):
    d1 = create_descriptor(torch.from_numpy(stages["left"]), True)[None]
    d2 = create_descriptor(torch.from_numpy(stages["right"]), True)[None]
    H, W = stages["left"].shape
    dcan = support_candidates(d1, d2, SUB)[0].numpy()
    np.testing.assert_array_equal(
        collect_support_points_native(dcan, SUB, W, H), stages["support"])


def test_elas_match_with_reference_triangulation(stages):
    D1, D2 = elas_match(stages["left"], stages["right"], SUB,
                        tri_left=stages["tri1"], tri_right=stages["tri2"],
                        device="cpu")
    assert D1.shape == stages["final_D1"].shape == (92, 160)
    np.testing.assert_array_equal(D1.numpy(), stages["final_D1"])
    assert D2.shape == (92, 160)


def test_elas_match_equals_jax_on_the_golden_scene():
    g = np.load(f"{FIX}/elas_golden_sub320.npz")
    W1, W2 = jpipe.elas_match(g["left"], g["right"], JSUB)
    D1, D2 = elas_match(g["left"], g["right"], SUB, device="cpu")
    np.testing.assert_array_equal(D1.numpy(), W1)
    np.testing.assert_array_equal(D2.numpy(), W2)
    both = (g["D1"] >= 0) & (W1 >= 0)
    assert both.mean() > 0.5


def _seeded_map(seed, H=46, W=80):
    rng = np.random.default_rng(seed)
    D = rng.integers(0, 60, (H, W)).astype(np.float32)
    D += rng.choice([0.0, 0.5], (H, W)).astype(np.float32)
    D[rng.random((H, W)) < 0.2] = -10.0
    D[rng.random((H, W)) < 0.05] = -1.0
    return D


@pytest.mark.parametrize("seed", [1, 2])
def test_adaptive_mean_sub_equals_jax(seed):
    D = _seeded_map(seed)
    want = np.asarray(jpost.adaptive_mean_sub(jnp.asarray(D)))
    got = post.adaptive_mean_sub(torch.from_numpy(D)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != D).any()
    # post_tail selects it under subsampling
    t1, _ = post.post_tail(torch.from_numpy(D), torch.from_numpy(D), SUB)
    w1, _ = jpost.post_tail(jnp.asarray(D), jnp.asarray(D), JSUB)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(w1))


@pytest.mark.parametrize("seed", [3, 4])
def test_subsampled_lr_check_equals_jax(seed):
    D1 = _seeded_map(seed)
    D2 = np.roll(D1, -4, axis=1) + np.float32(0.5)
    w1, w2 = jpost.left_right_consistency_check(jnp.asarray(D1),
                                                jnp.asarray(D2), JSUB)
    g1, g2 = post.left_right_consistency_check(torch.from_numpy(D1),
                                               torch.from_numpy(D2), SUB)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))
    # the half warp differs from the full one
    f1, _ = post.left_right_consistency_check(
        torch.from_numpy(D1), torch.from_numpy(D2), ElasParams())
    assert (f1 != g1).any()


def test_batched_paths_raise_the_reference_error():
    img = np.zeros((1, 40, 64), np.uint8)
    msg = "batched path does not support subsampling; use elas_match"
    for call in (lambda: elas_match_batch_device(img, img, SUB, device="cpu"),
                 lambda: elas_match_batch(img, img, SUB, device="cpu"),
                 lambda: next(elas_match_stream(iter([(img, img)]), SUB,
                                                device="cpu"))):
        with pytest.raises(ValueError, match=msg):
            call()
    with pytest.raises(ValueError, match=msg):
        jpipe.elas_match_batch(img, img, JSUB)


def test_process_frame_fails_in_the_scan_as_the_reference_does():
    """The node's process_frame under subsampling: the maps are
    [H/2, W/2] and the scan's valid-disparity cache [H, W], so the scan's
    range check cannot broadcast. The reference raises there (jnp:
    TypeError), and so does the port (torch: RuntimeError); neither
    package handles the case."""
    size = dict(im_width=192, im_height=108, crop_im_width=192,
                crop_im_height=108)
    port = StereoPipeline(default_calibration(), PipelineParams(**size),
                          engine="elas", elas_params=SUB, device="cpu")
    ref = JaxPipeline(jax_calib(), jconfig.PipelineParams(**size),
                      engine="elas", elas_params=JSUB)
    left, right = synthetic_raw_pair(port, 0, 8, 0.0)
    with pytest.raises(TypeError, match=r"\(54, 96\), \(108, 192\)"):
        ref.process_frame(left, right)
    with pytest.raises(RuntimeError, match="96.*192"):
        port.process_frame(left, right)
    # the map that reaches the scan is half-size
    lt, rt = port._rectify_crop(torch.from_numpy(left),
                                torch.from_numpy(right))
    D1, _ = elas_match(lt, rt, SUB, device="cpu")
    assert D1.shape == (54, 96) and (D1 >= 0).any()
