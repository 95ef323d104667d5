"""The port's gen-pcl export on the CPU against jackal_tpu's.

point_cloud_from_disparity (with and without colour), the ground mask and
obstacle_scan_from_points, the colour rectification, and the gen-pcl paths
of the node: process_frame (BM), process_batch_fused_pcl (BM, SGM),
process_batch_pcl (ELAS) and StreamingRunner's published clouds.

Exact: the u8 maps, every cloud's packed-RGB bits and its valid mask, the
published point count. Points: relative 1e-5 with an absolute 1e-6 m floor
on the valid (published) points. The float32 reprojection is the same
sequence of products, sums and quotients on both sides, but XLA:CPU may
contract a product and a sum into one fused multiply-add where PyTorch
rounds both, an ulp or two at these magnitudes. Scans: relative 1e-5 per
filled bin with the same filled bins, as in tests/test_torch_pipeline.py.
"""
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import (GroundPlaneParams as JaxGP,
                               PipelineParams as JaxPP, ScanParams as JaxSP)
from jackal_tpu.pipeline.default import make_pipeline as jax_make_pipeline
from jackal_tpu.scan import obstacle as jobs
from jackal_tpu_torch.config import (GroundPlaneParams, PipelineParams,
                                     ScanParams)
from jackal_tpu_torch.io_bus.bus import TopicBus
from jackal_tpu_torch.io_bus.messages import Header
from jackal_tpu_torch.pipeline.default import make_pipeline
from jackal_tpu_torch.pipeline.runner import (TOPIC_DEPTH, TOPIC_PCL,
                                              StreamingRunner)
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
from jackal_tpu_torch.scan import obstacle as obs

SCAN_RTOL = 1e-5
PTS_RTOL, PTS_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: when test workers
    share the cores, torch's thread pool spends its time waiting on itself
    (a file ran over 20x slower on 4 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _consts(pipe):
    return pipe.Q32, pipe.XR32, pipe.XT32


def _clouds_close(got, want):
    """got: the port's (points, rgb, valid); want: the reference's."""
    gp, gr, gv = (torch.as_tensor(x).numpy() for x in got)
    wp, wr, wv = (np.asarray(x) for x in want)
    assert gp.shape == wp.shape and gr.dtype == np.float32
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gr.view(np.int32), wr.view(np.int32))
    assert wv.sum() > 100
    np.testing.assert_allclose(gp[wv], wp[wv], rtol=PTS_RTOL, atol=PTS_ATOL)


def _scans_close(got, want):
    ws, gs = np.asarray(want.scan), got.scan.numpy()
    filled = ws < 1e9 - 1
    assert filled.sum() >= 5
    np.testing.assert_array_equal(gs < 1e9 - 1, filled)
    np.testing.assert_allclose(gs[filled], ws[filled], rtol=SCAN_RTOL)
    for key in ("angle_min", "angle_max", "range_min", "range_max"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   rtol=SCAN_RTOL)


@pytest.fixture(scope="module")
def refs():
    port = make_pipeline(engine="elas", device="cpu")
    return port, jax_make_pipeline(engine="elas")


@pytest.mark.parametrize("colour", [False, True])
def test_point_cloud_equals_jax(refs, colour):
    port, ref = refs
    rng = np.random.default_rng(int(colour))
    dmap = rng.integers(0, 90, (180, 320)).astype(np.uint8)
    col = rng.integers(0, 256, (180, 320, 3)).astype(np.uint8) \
        if colour else None
    want = jobs.point_cloud_from_disparity(
        jnp.asarray(dmap), None if col is None else jnp.asarray(col),
        *_consts(ref), JaxSP(), 0, 0)
    got = obs.point_cloud_from_disparity(
        torch.from_numpy(dmap), None if col is None else torch.from_numpy(col),
        *_consts(port), ScanParams(), 0, 0)
    assert got[0].shape == (180 * 320, 3) and got[2].dtype == torch.bool
    _clouds_close(got, want)
    if colour:
        assert (got[1].numpy().view(np.int32) != 0).mean() > 0.9
    # a batch of two maps: each frame its own cloud
    both = obs.point_cloud_from_disparity(
        torch.from_numpy(np.stack([dmap, dmap[::-1]])), None, *_consts(port))
    assert both[0].shape == (2, 180 * 320, 3)
    assert torch.equal(both[2][0], got[2])


def test_ground_mask_and_points_scan_equal_jax():
    """Seeded robot-frame points in front of the robot, a fifth of them
    placed on the ground threshold (Zr = thresh(Xr) in float64, rounded to
    float32), where the mask is decided by an ulp. The reference package
    ships obstacle_scan_from_points under jit, where XLA:CPU contracts the
    threshold's product and sum into one fused multiply-add; the port
    rounds the threshold once as well, so its mask equals the jitted
    reference's on every point, and the scans agree on every valid point,
    the threshold's included."""
    rng = np.random.default_rng(3)
    B, N = 2, 4000
    Xr = rng.uniform(0.1, 6.0, (B, N))
    Yr = rng.uniform(-5.0, 5.0, (B, N))
    Zr = rng.uniform(-0.3, 0.8, (B, N))
    gp = GroundPlaneParams()
    on = rng.random((B, N)) < 0.2
    thresh = np.where(Xr < gp.dist_thresh, gp.height_thresh,
                      gp.height_thresh + np.tan(gp.angle_thresh)
                      * (Xr - gp.dist_thresh))
    Zr = np.where(on, thresh, Zr)
    pts = np.stack([Xr, Yr, Zr], -1).astype(np.float32)
    valid = rng.random((B, N)) < 0.8
    tan32 = np.float32(np.asarray(jnp.tan(JaxGP().angle_thresh)))
    assert torch.tan(torch.tensor(gp.angle_thresh, dtype=torch.float32)
                     ).item() == tan32
    X, Z = (jnp.asarray(pts[..., i]) for i in (0, 2))
    got_g = obs._ground_mask(torch.from_numpy(pts[..., 0]),
                             torch.from_numpy(pts[..., 2]), gp).numpy()
    fused = np.asarray(jax.jit(jobs._ground_mask_jnp, static_argnums=2)(
        X, Z, JaxGP()))
    np.testing.assert_array_equal(got_g, fused)
    assert 0.2 < got_g.mean() < 0.8
    # the points on the threshold do decide by an ulp: rounding the
    # product and the sum apart flips some of them, and only them
    split = np.asarray(jobs._ground_mask_jnp(X, Z, JaxGP()))
    assert (split != got_g).any() and on[split != got_g].all()
    got = obs.obstacle_scan_from_points(torch.from_numpy(pts),
                                        torch.from_numpy(valid), ScanParams(),
                                        gp)
    assert got.scan.shape == (B, 90) and got.range_min.shape == (B,)
    for b in range(B):
        want = jobs.obstacle_scan_from_points(jnp.asarray(pts[b]),
                                              jnp.asarray(valid[b]), JaxSP(),
                                              JaxGP())
        one = obs.obstacle_scan_from_points(torch.from_numpy(pts[b]),
                                            torch.from_numpy(valid[b]))
        _scans_close(one, want)
        assert torch.equal(one.scan, got.scan[b])


def _f32_round(q: Fraction) -> np.float32:
    """The float32 nearest to the exact q, ties to even."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(dist)
    near = [c for c, e in zip(cands, dist) if e == best]
    return min(near, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """obstacle.fma_f32 against an exact reference (fractions.Fraction) on
    seeded inputs and on sums that land on a float32 halfway point in
    float64, where rounding twice goes the wrong way."""
    rng = np.random.default_rng(11)
    a = rng.uniform(-4, 4, 2000).astype(np.float32)
    x = rng.uniform(-8, 8, 2000).astype(np.float32)
    c = (rng.uniform(-2, 2, 2000) * 10.0 ** rng.integers(-3, 3, 2000)
         ).astype(np.float32)
    # halfway cases: c odd in its last bit, a * x = +-ulp(c) / 2 * (1 - 2^-46)
    for k in rng.integers(-20, 20, 64):
        cc = np.float32((1 + 2.0 ** -23) * 2.0 ** k)
        for sign in (1, -1):
            a = np.append(a, np.float32(sign * 2.0 ** (k - 24)
                                        * (1 + 2.0 ** -23)))
            x = np.append(x, np.float32(1 - 2.0 ** -23))
            c = np.append(c, cc)
    got = obs.fma_f32(torch.from_numpy(a), torch.from_numpy(x),
                      torch.from_numpy(c)).numpy()
    want = np.array([_f32_round(Fraction(float(ai)) * Fraction(float(xi))
                                + Fraction(float(ci)))
                     for ai, xi, ci in zip(a, x, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    twice = (a.astype(np.float64) * x + c).astype(np.float32)
    assert (twice[-128:] != want[-128:]).all()


def test_rectify_crop_color_equals_jax():
    pp = PipelineParams(gen_pcl=True, crop_offset_x=8, crop_offset_y=20,
                        crop_im_width=300, crop_im_height=150)
    jpp = JaxPP(**dataclasses.asdict(pp))
    port = make_pipeline(engine="bm", device="cpu", params=pp)
    ref = jax_make_pipeline(engine="bm", params=jpp)
    col = np.random.default_rng(7).integers(0, 256, (2, 360, 640, 3)).astype(
        np.uint8)
    want = np.asarray(ref._rectify_crop_color(jnp.asarray(col)))
    got = port._rectify_crop_color(torch.from_numpy(col))
    assert got.shape == (2, 150, 300, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port._rectify_crop_color(torch.from_numpy(col[1])).numpy(),
        np.asarray(ref._rectify_crop_color(jnp.asarray(col[1]))))


@pytest.fixture(scope="module")
def frames():
    """Two raw pairs of known scenes with seeded colour frames."""
    pipe = make_pipeline(engine="bm", device="cpu")
    rng = np.random.default_rng(11)
    return [synthetic_raw_pair(pipe, s, 12 - 5 * s, 0.12 * s)
            + (rng.integers(0, 256, (360, 640, 3)).astype(np.uint8),)
            for s in range(2)]


def _pcl_nodes(engine):
    return (make_pipeline(engine=engine, device="cpu",
                          params=PipelineParams(gen_pcl=True)),
            jax_make_pipeline(engine=engine, params=JaxPP(gen_pcl=True)))


@pytest.mark.parametrize("colour", [True, False])
def test_process_frame_gen_pcl_matches_jax(frames, colour):
    port, ref = _pcl_nodes("bm")
    left, right, col = frames[0]
    col = col if colour else None
    want = ref.process_frame(left, right, color_bgr=col)
    got = port.process_frame(left, right, color_bgr=col, timing=True)
    np.testing.assert_array_equal(got.dmap, want.dmap)
    _clouds_close(got.cloud, want.cloud)
    _scans_close(got.scan, want.scan)
    assert got.pcl_time > 0 and got.scan_time > 0


@pytest.mark.parametrize("engine", ["bm", "sgm"])
def test_process_batch_fused_pcl_matches_jax(frames, engine):
    port, ref = _pcl_nodes(engine)
    lb, rb, cb = (np.stack([f[i] for f in frames]) for i in range(3))
    wd, wc, ws = ref.process_batch_fused_pcl(jnp.asarray(lb), jnp.asarray(rb),
                                             jnp.asarray(cb))
    dmaps, cloud, scans = port.process_batch_fused_pcl(lb, rb, cb)
    np.testing.assert_array_equal(dmaps.numpy(), np.asarray(wd))
    for b in range(2):
        _clouds_close([c[b] for c in cloud], [np.asarray(c)[b] for c in wc])
    _scans_close(scans, ws)
    # the maps are process_batch_fused's; the timed call gives the same
    d2, _ = port.process_batch_fused(lb, rb)
    assert torch.equal(d2, dmaps)
    d3, c3, s3, times = port.process_batch_fused_pcl(lb, rb, cb, timing=True)
    assert torch.equal(d3, dmaps) and torch.equal(c3[2], cloud[2])
    torch.testing.assert_close(c3[0], cloud[0], rtol=0, atol=0,
                               equal_nan=True)
    assert len(times) == 3 and min(times) > 0
    assert port.process_batch_pcl(lb, rb, cb)[1][1].equal(cloud[1])


def test_process_batch_pcl_elas_matches_jax(frames):
    port, ref = _pcl_nodes("elas")
    lb, rb, cb = (np.stack([f[i] for f in frames]) for i in range(3))
    wd, wc, ws = ref.process_batch_pcl(lb, rb, cb)
    dmaps, cloud, scans = port.process_batch_pcl(lb, rb, cb)
    np.testing.assert_array_equal(dmaps.numpy(), np.asarray(wd))
    for b in range(2):
        _clouds_close([c[b] for c in cloud], [np.asarray(c)[b] for c in wc])
    _scans_close(scans, ws)
    with pytest.raises(ValueError, match="engine='sgm'"):
        port.process_batch_fused_pcl(lb, rb, cb)


@pytest.mark.parametrize("engine", ["bm", "elas"])
def test_runner_publishes_clouds(frames, engine):
    """StreamingRunner with gen_pcl: every frame's map, and its cloud
    equal to the reference's compact_cloud_msg of the same frame."""
    port, ref = _pcl_nodes(engine)
    bus = TopicBus()
    depth, clouds = [], []
    bus.subscribe(TOPIC_DEPTH, depth.append)
    bus.subscribe(TOPIC_PCL, clouds.append)
    runner = StreamingRunner(port, bus, batch_size=2, stage_sample_every=2)
    order = [0, 1, 1]
    assert runner.run(iter([frames[k] for k in order])) == 3
    assert [m.header.seq for m in clouds] == [0, 1, 2]
    for i, k in enumerate(order):
        want = ref.process_frame(*frames[k][:2], color_bgr=frames[k][2])
        np.testing.assert_array_equal(depth[i].data, want.dmap)
        msg = jobs.compact_cloud_msg(Header.now(i, "jackal"), want.cloud)
        got = clouds[i]
        assert got.points.shape == msg.points.shape
        assert got.channels[0].name == "rgb"
        np.testing.assert_array_equal(got.channels[0].values.view(np.int32),
                                      msg.channels[0].values.view(np.int32))
        np.testing.assert_allclose(got.points, msg.points, rtol=PTS_RTOL,
                                   atol=PTS_ATOL)
    # frames without colour give zero colours
    runner.run(iter([frames[0][:2]]))
    assert (clouds[-1].channels[0].values.view(np.int32) == 0).all()
    assert len(clouds[-1].points) == len(clouds[0].points)
