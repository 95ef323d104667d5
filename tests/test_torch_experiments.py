"""The port's experiments on the CPU == jackal_tpu's: feature matching
(Harris corners, BRIEF descriptors, 2-NN Hamming matching) and the
confidence check, bit for bit, on elas_golden_s320_flat.npz and on a
tie-heavy frame; the waypoint projection with the bundled calibration
(the port's default_calibration and the reference package's, equal)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jackal_tpu.experiments import confidence as jc
from jackal_tpu.experiments import feature_matching as jfm
from jackal_tpu.geometry.rectify import stereo_rectify as jax_rectify
from jackal_tpu.geometry.reproject import (
    robot_to_cam_pixel as jax_robot_to_cam_pixel)
from jackal_tpu.matching.sgm import _popcount as jax_popcount
from jackal_tpu.ops.descriptor import create_descriptor as jdesc
from jackal_tpu.pipeline.default import default_calibration as jax_calib
from jackal_tpu_torch.experiments import confidence as pc
from jackal_tpu_torch.experiments import feature_matching as pfm
from jackal_tpu_torch.geometry.rectify import stereo_rectify
from jackal_tpu_torch.geometry.reproject import robot_to_cam_pixel
from jackal_tpu_torch.matching.sgm import _popcount
from jackal_tpu_torch.ops.descriptor import create_descriptor
from jackal_tpu_torch.pipeline.default import default_calibration


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flat():
    return np.load("tests/fixtures/elas_golden_s320_flat.npz")


def _tie_heavy():
    """A flat frame with a few corners: fewer corners than max_corners,
    so most scores tie at -1 and the order of the ties decides uv."""
    img = np.full((60, 80), 40, np.uint8)
    img[10:20, 10:22] = 200
    img[35:50, 50:58] = 120
    img[44:52, 12:16] = 250
    return img


@pytest.mark.parametrize("case", ["left", "right", "tie_heavy"])
def test_harris_and_brief_equal_jax(flat, case):
    img = _tie_heavy() if case == "tie_heavy" else flat[case]
    uv, s = pfm.harris_corners(torch.from_numpy(img), 300)
    juv, js = jfm.harris_corners(jnp.asarray(img), 300)
    assert uv.dtype == torch.int32 and uv.shape == (300, 2)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
    d = pfm.brief_descriptors(torch.from_numpy(img), uv)
    jd = jfm.brief_descriptors(jnp.asarray(img), juv)
    assert d.dtype == torch.int32 and d.shape == (300, 8)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    if case == "tie_heavy":
        assert 0 < int((s > 0).sum()) < 30 and (s == -1).sum() > 270
    else:
        assert (d < 0).any()            # bit 31 set: words wrap negative


def test_popcount_equal_jax_on_negative_words():
    x = np.random.default_rng(3).integers(-2**31, 2**31, 4096,
                                          dtype=np.int64).astype(np.int32)
    x[:4] = [-1, -2**31, 2**31 - 1, 0]
    got = _popcount(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_popcount(
        jnp.asarray(x))))
    np.testing.assert_array_equal(got[:4], [32, 1, 31, 0])


def test_knn_and_match_features_equal_jax(flat):
    left, right = flat["left"], flat["right"]
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    uv1, s1 = pfm.harris_corners(l, 300)
    uv2, s2 = pfm.harris_corners(r, 300)
    d1, d2 = pfm.brief_descriptors(l, uv1), pfm.brief_descriptors(r, uv2)
    idx, ok = pfm.knn_hamming_match(d1, d2, s1 > 0, s2 > 0)
    jidx, jok = jfm.knn_hamming_match(jnp.asarray(d1.numpy()),
                                      jnp.asarray(d2.numpy()),
                                      jnp.asarray((s1 > 0).numpy()),
                                      jnp.asarray((s2 > 0).numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    pl, pr = pfm.match_features(left, right, 300, device="cpu")
    jpl, jpr = jfm.match_features(left, right, 300)
    np.testing.assert_array_equal(pl, jpl)
    np.testing.assert_array_equal(pr, jpr)
    # the reference's own check: a translated pair matches on epipolar
    # lines with positive disparity
    good = (np.abs(pl[:, 1] - pr[:, 1]) <= 1) & (pl[:, 0] - pr[:, 0] > 0) \
        & (pl[:, 0] - pr[:, 0] < 80)
    assert len(pl) > 30 and good.mean() > 0.7


def test_waypoint_projection_with_the_bundled_calibration():
    c, jcal = default_calibration(), jax_calib()
    np.testing.assert_array_equal(c.XR, jcal.XR)
    r = stereo_rectify(c.K1, c.D1, c.K2, c.D2, (640, 360), c.R, c.T, True,
                       0.0, (320, 180))
    jr = jax_rectify(jcal.K1, jcal.D1, jcal.K2, jcal.D2, (640, 360), jcal.R,
                     jcal.T, True, 0.0, (320, 180))
    pl, pr = pc.cache_waypoint_coords(c.XR, c.XT, r.P1, r.P2)
    jpl, jpr = jc.cache_waypoint_coords(jcal.XR, jcal.XT, jr.P1, jr.P2)
    assert pl.dtype == np.int64 and pl.shape == pr.shape and pl.shape[1] == 2
    np.testing.assert_array_equal(pl, jpl)
    np.testing.assert_array_equal(pr, jpr)
    pts = np.random.default_rng(4).uniform(-2, 2, (5, 7, 3))
    np.testing.assert_array_equal(
        robot_to_cam_pixel(pts, c.XR, c.XT, r.P1),
        jax_robot_to_cam_pixel(pts, jcal.XR, jcal.XT, jr.P1))
    inb = ((pl[:, 0] >= 0) & (pl[:, 0] < 320)
           & (pl[:, 1] >= 0) & (pl[:, 1] < 180))
    assert inb.mean() > 0.5


def test_confidence_check_equal_jax(flat):
    left, right = flat["left"], flat["right"]
    H, W = left.shape
    rng = np.random.default_rng(0)
    n = 50
    pts_l = np.stack([rng.integers(20, W - 20, n),
                      rng.integers(20, H - 20, n)], axis=-1)
    d_true = flat["d_true"][pts_l[:, 1], pts_l[:, 0]].round().astype(int)
    pts_r_good = pts_l - np.stack([d_true, np.zeros(n, int)], axis=-1)
    pts_r_bad = pts_l - np.stack([d_true + 25, np.zeros(n, int)], axis=-1)
    pts_r_bad[:3] = [[-5, 10], [W, 3], [4, H + 2]]        # out of frame
    flags = {}
    for name, pr in (("good", pts_r_good), ("bad", pts_r_bad)):
        got = pc.confidence_check(left, right, pts_l, pr, device="cpu")
        want = jc.confidence_check(left, right, pts_l, pr)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)
        flags[name] = got
    for w in (1, 2):
        dl, dr = (create_descriptor(torch.from_numpy(x))
                  for x in (left, right))
        got = pc.desc_cost(dl, dr, pts_l, np.clip(pts_r_good, 0, None), w)
        want = jc.desc_cost(jdesc(jnp.asarray(left)),
                            jdesc(jnp.asarray(right)), pts_l,
                            np.clip(pts_r_good, 0, None), w)
        np.testing.assert_array_equal(got, want)
    assert flags["good"].mean() < 0.3
    assert flags["bad"].mean() > flags["good"].mean() + 0.3
