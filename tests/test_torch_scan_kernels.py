"""The scan and the cloud (kernels P1-P3's plain versions) on the CPU
against jackal_tpu's jitted functions.

  - a NaN point lands in bin 0 and makes it NaN, as XLA's float -> int32
    conversion sends NaN to 0 (the port converted with .to(int64), which
    dropped the point): the scan's bits with NaN compared as NaN, the four
    extrema and the published LaserScan ranges;
  - a point at x = +inf is ground, as the reference's fused threshold
    height + tan * (x - dist) = inf finds (fma_f32 gave NaN at infinity);
  - seeded point sets with NaN and +-inf among their points, on
    Pythagorean triples so that every range is exact on both sides: the
    scan's bits, the extrema's bits, the published ranges;
  - the bin index at bin edges: the port's _bin_index of the angle the
    jitted reference computed is the bin that reference filled, at the
    presets' 90 bins over 90 degrees and at two other fields of view;
  - on the CPU the wrappers run the plain versions and count no launch;
  - chip_smoke.scan_work's bytes against a hand count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jackal_tpu.config import GroundPlaneParams as JaxGP
from jackal_tpu.config import ScanParams as JaxSP
from jackal_tpu.scan import obstacle as jobs
from jackal_tpu_torch.config import GroundPlaneParams, ScanParams
from jackal_tpu_torch.scan import obstacle as obs

FIELDS = ("scan", "angle_min", "angle_max", "range_min", "range_max")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU ops: when test workers share
    the cores, torch's thread pool spends its time waiting on itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(got, want):
    """float32 arrays equal bit for bit, any NaN equal to any NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  want[ok].view(np.int32))


def _scan_equals_jax(got, want):
    for f in FIELDS:
        _same_bits(getattr(got, f).numpy(), getattr(want, f))
    np.testing.assert_array_equal(
        obs.format_laser_scan_ranges(got.scan),
        jobs.format_laser_scan_ranges(np.asarray(want.scan)))


def _points_scans(pts, valid, sp=ScanParams(), gp=GroundPlaneParams()):
    port = obs.obstacle_scan_from_points(torch.from_numpy(pts),
                                         torch.from_numpy(valid), sp, gp)
    ref = jobs.obstacle_scan_from_points(jnp.asarray(pts), jnp.asarray(valid),
                                         JaxSP(**sp.__dict__),
                                         JaxGP(**gp.__dict__))
    return port, ref


def test_nan_point_lands_in_bin_zero_as_the_reference():
    pts = np.array([[2.0, 0.1, 0.5], [np.nan, 0.1, 0.5], [1.0, 0.99, 0.5]],
                   np.float32)
    got, want = _points_scans(pts, np.ones(3, bool))
    _scan_equals_jax(got, want)
    assert np.isnan(float(got.scan[0]))
    np.testing.assert_array_equal(obs.format_laser_scan_ranges(got.scan),
                                  np.float32([2.0024984]))


def test_infinite_point_is_ground_as_the_reference():
    """x = +inf: the threshold height + tan * (x - dist) is +inf, so the
    point is ground; fma_f32 gave NaN there and accepted it."""
    pts = np.array([[np.inf, 0.5, 0.3], [2.0, 0.1, 0.5]], np.float32)
    got, want = _points_scans(pts, np.ones(2, bool))
    _scan_equals_jax(got, want)
    assert float(got.range_max) == np.float32(np.hypot(2.0, 0.1))
    x = torch.tensor([np.inf, -np.inf, np.nan, 1.5], dtype=torch.float32)
    np.testing.assert_array_equal(obs.fma_f32(0.25, x, 0.5).numpy(),
                                  np.float32([np.inf, -np.inf, np.nan, 0.875]))


# (a, b) with a^2 + b^2 a square: every point's range is exact in float32
TRIPLES = np.array([(3, 4), (5, 12), (8, 15), (7, 24), (20, 21), (12, 35),
                    (9, 40), (28, 45), (11, 60), (33, 56), (16, 63),
                    (48, 55), (13, 84), (36, 77), (39, 80), (65, 72),
                    (1, 0)], np.float64)


def _point_set(seed, N=500, nan_accepted=False):
    """N seeded points in front of the robot on Pythagorean triples scaled
    by powers of two, 12 coordinates set to NaN or +-inf (a NaN point
    valid where nan_accepted, else not), and two accepted points on the
    y axis, whose angles +-pi/2 are the angle extrema."""
    rng = np.random.default_rng(seed)
    t = TRIPLES[rng.integers(0, len(TRIPLES), N)]
    swap = rng.random(N) < 0.5
    x = np.where(swap, t[:, 1], t[:, 0])
    y = np.where(swap, t[:, 0], t[:, 1]) * rng.choice([-1, 1], N)
    s = 2.0 ** rng.integers(-4, 2, N)
    pts = np.stack([x * s, y * s, rng.integers(-8, 9, N) / 8.0],
                   -1).astype(np.float32)
    valid = rng.random(N) < 0.9
    for _ in range(12):
        i, c = rng.integers(N), rng.integers(0, 2)
        pts[i, c] = rng.choice(np.float32([np.nan, np.inf, -np.inf]))
        if c == 0 and np.isinf(pts[i, 0]):
            pts[i, 0] = np.inf
        if np.isnan(pts[i]).any():
            valid[i] = nan_accepted
    pts[0], pts[1] = (0.0, 2.0, 0.0), (0.0, -2.0, 0.0)
    pts[2] = (np.nan, 1.0, 0.5)     # never ground: its threshold is NaN
    valid[:2], valid[2] = True, nan_accepted
    return pts, valid


@pytest.mark.parametrize("seed", range(8))
def test_nan_and_inf_point_sets_equal_jax(seed):
    sets = [_point_set(seed * 4 + i, nan_accepted=i == 3) for i in range(4)]
    pts = np.stack([p for p, _ in sets])
    valid = np.stack([v for _, v in sets])
    batch = obs.obstacle_scan_from_points(torch.from_numpy(pts),
                                          torch.from_numpy(valid))
    for i, (p, v) in enumerate(sets):
        got, want = _points_scans(p, v)
        _scan_equals_jax(got, want)
        for f in FIELDS:
            _same_bits(getattr(batch, f)[i].numpy(), getattr(got, f).numpy())
        if i == 3:
            assert np.isnan(want.scan[0]) and np.isnan(want.range_min)
        else:
            assert not np.isnan(np.asarray(want.scan)).any()
    assert (np.asarray(want.scan) < 1e9 - 1).sum() >= 10


def test_nan_pixels_of_a_map_equal_jax():
    """The scan from a disparity map whose cache accepts d = 0, where w =
    0 makes the reprojected points infinite or NaN: the same bins and
    extrema are NaN as in the reference, and the finite ones agree within
    PERF.md's scan tolerance (XLA:CPU contracts the reprojection's
    products and sums where the port rounds each)."""
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pipe = make_pipeline(engine="elas", device="cpu")
    rng = np.random.default_rng(4)
    H, W = pipe.valid_disp.shape[:2]
    dmaps = rng.integers(20, 90, (2, H, W)).astype(np.uint8)
    dmaps[0][rng.random((H, W)) < 0.01] = 0
    vd = np.stack([np.zeros((H, W)), np.full((H, W), 255)], -1).astype(
        np.uint8)
    consts = (pipe.Q32, pipe.XR32, pipe.XT32)
    got = obs.obstacle_scan_from_disparity(torch.from_numpy(dmaps),
                                           torch.from_numpy(vd), *consts)
    for b in range(2):
        want = jobs.obstacle_scan_from_disparity(
            jnp.asarray(dmaps[b]), jnp.asarray(vd),
            *(jnp.asarray(c.numpy()) for c in consts))
        for f in FIELDS:
            g, w = getattr(got, f)[b].numpy(), np.asarray(getattr(want, f))
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            ok = ~np.isnan(w)
            np.testing.assert_array_equal(g[ok] < 1e9 - 1, w[ok] < 1e9 - 1)
            np.testing.assert_allclose(g[ok], w[ok], rtol=1e-5)
        assert np.isnan(want.scan[0]) == (b == 0)


def _edge_thetas(sp: ScanParams, ulps=8):
    """float32 angles within ``ulps`` ulps of every bin edge: where
    (fov/2 - theta * 180/REF_PI) * ratio is an integer."""
    deg, half, ratio = obs._bin_constants(sp)
    out = []
    for m in range(sp.bin_size + 1):
        t0 = np.float32((half - m / ratio) / deg)
        for step in (-np.inf, np.inf):
            t = t0
            for _ in range(ulps):
                t = np.nextafter(t, np.float32(step))
                out.append(t)
        out.append(t0)
    return np.array(out, np.float32)


@pytest.mark.parametrize("fov,bins", [(90.0, 90), (60.0, 90), (70.0, 45)])
def test_bin_index_at_the_edges_equals_jitted_jax(fov, bins):
    """Points at angles a few ulps either side of every bin edge, one a
    call of the jitted reference: the bin it filled is the port's
    _bin_index of the angle it computed (its angle_min), -1 where it
    filled none. Where torch.atan2 gives the reference's angle, the port's
    scan fills that bin. At the presets the division the port made before
    (bin_size * (fov/2 - theta_deg) / fov, each step rounded) misses the
    reference's bin at some edges, which its fused rounding decides."""
    sp, jsp = ScanParams(fov_deg=fov, bin_size=bins), JaxSP(fov_deg=fov,
                                                            bin_size=bins)
    th = _edge_thetas(sp)
    r = np.random.default_rng(bins).uniform(0.5, 5.0, th.size)
    pts = np.stack([r * np.cos(th.astype(np.float64)),
                    r * np.sin(th.astype(np.float64)), np.ones_like(r)],
                   -1).astype(np.float32)
    theta_ref, k_ref = [], []
    one = jnp.ones((1,), bool)
    for p in pts:
        out = jobs.obstacle_scan_from_points(jnp.asarray(p[None]), one, jsp,
                                             JaxGP())
        filled = np.nonzero(np.asarray(out.scan) < 1e9 - 1)[0]
        assert len(filled) <= 1
        k_ref.append(int(filled[0]) if len(filled) else -1)
        theta_ref.append(np.float32(out.angle_min))
    theta_ref, k_ref = np.array(theta_ref, np.float32), np.array(k_ref)
    k = obs._bin_index(torch.from_numpy(theta_ref), sp).numpy()
    k = np.where((k >= 0) & (k < bins), k, -1)
    np.testing.assert_array_equal(k, k_ref)
    assert len(set(k_ref.tolist())) >= bins - 1
    # the port end to end where its angle is the reference's
    same = torch.atan2(torch.from_numpy(pts[:, 1]),
                       torch.from_numpy(pts[:, 0])).numpy() == theta_ref
    assert same.mean() > 0.5
    got = obs.obstacle_scan_from_points(
        torch.from_numpy(pts[same][:, None]),
        torch.ones((int(same.sum()), 1), dtype=torch.bool), sp)
    filled = got.scan.numpy() < 1e9 - 1
    port_k = np.where(filled.any(1), filled.argmax(1), -1)
    np.testing.assert_array_equal(port_k, k_ref[same])
    if fov == bins:
        deg, half, _ = obs._bin_constants(sp)
        td = theta_ref * np.float32(deg)
        q = np.float32(bins) * (np.float32(half) - td)
        before = np.floor(q / np.float32(fov)).astype(np.int64)
        before = np.where((before >= 0) & (before < bins), before, -1)
        assert (before != k_ref).sum() >= 5


def test_wrappers_run_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors the wrappers take the plain versions and count no
    launch; the kernels' entry points are never reached."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA path ran on CPU tensors")

    for name in ("_scan_cuda", "_cloud_cuda", "_scan_points_cuda"):
        monkeypatch.setattr(obs, name, refuse)
    for k in obs.launches:
        obs.launches[k] = 0
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pipe = make_pipeline(engine="elas", device="cpu")
    H, W = pipe.valid_disp.shape[:2]
    rng = np.random.default_rng(9)
    dm = torch.from_numpy(rng.integers(0, 90, (2, H, W)).astype(np.uint8))
    col = torch.from_numpy(rng.integers(0, 256, (2, H, W, 3)).astype(
        np.uint8))
    consts = (pipe.Q32, pipe.XR32, pipe.XT32)
    a = obs.obstacle_scan_from_disparity(dm, pipe.valid_disp, *consts)
    b = obs.obstacle_scan_from_disparity_plain(dm, pipe.valid_disp, *consts)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
    cloud = obs.point_cloud_from_disparity(dm, col, *consts)
    plain = obs.point_cloud_from_disparity_plain(dm, col, *consts)
    assert all(torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y)
               for x, y in zip(cloud, plain))
    c = obs.obstacle_scan_from_points(cloud[0], cloud[2])
    d = obs.obstacle_scan_from_points_plain(cloud[0], cloud[2])
    for f in FIELDS:
        assert torch.equal(getattr(c, f), getattr(d, f))
    assert obs.launches == {"scan": 0, "cloud": 0, "scan_points": 0}
    assert a.scan.shape == (2, 90) and c.range_min.shape == (2,)


def test_scan_work_counts_bytes_once():
    """chip_smoke.scan_work: each input byte read once, each output byte
    written once (P1 at the node's 640x480 map with its cache and the
    calibration; P2 and P3 at BASELINE config 5's 32 frames)."""
    from chip_smoke import scan_work

    calib = (16 + 9 + 3) * 4
    assert scan_work("scan", 1, 480, 640)[0] == (
        640 * 480 + 2 * 640 * 480 + calib + (90 + 4) * 4) == 922088
    n5 = 32 * 480 * 640
    assert scan_work("cloud", 32, 480, 640)[0] == n5 * (1 + 12 + 4 + 1) \
        + calib == 176947312
    assert scan_work("cloud", 32, 480, 640, colour=True)[0] \
        == n5 * (1 + 3 + 12 + 4 + 1) + calib
    assert scan_work("scan_points", 32, 480, 640)[0] == n5 * 13 \
        + 32 * (90 + 4) * 4 == 127807232
    for k in ("scan", "cloud", "scan_points"):
        assert scan_work(k, 2, 10, 10)[1] == 2 * scan_work(k, 1, 10, 10)[1]
