"""The scan's arithmetic against the jitted jackal_tpu functions on the CPU,
where XLA:CPU flushes subnormals (denormals-are-zero, flush-to-zero) and
calls glibc's atan2f:

  - the angle (scan/obstacle._atan2_xla) against the jitted jnp.arctan2,
    bit for bit, on a grid of operand classes (+-0, subnormals down to
    1.4e-45, the least normal, tiny and unit normals, +-inf, NaN, seeded
    subnormals) and on seeded normal pairs, where torch.atan2 differs by
    an ulp on about one pair in eight;
  - the range, the flushes and the comparisons as the scan combines them;
  - obstacle_scan_from_points on the class grid, the fault's three probes
    and seeded normal sets, and its ground gate at zero thresholds: all
    five ScanResult fields bit for bit (any NaN equal to any NaN) and the
    published ranges;
  - obstacle_scan_from_disparity on maps whose calibration makes Xr and Yr
    tiny or subnormal (exact products and sums, so that XLA's contraction
    of the reprojection cannot differ from the port's);
  - the fused cloud and scan's plain version against P2 then P3 plain and
    against the JAX cloud then scan, with colour and without;
  - the CPU wrappers count no launch;
  - chip_smoke.scan_work counts the range, the angle and the bin only on
    the points a scan accepts (scan_accepted), as the kernels compute them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S, bound_ms,
                        scan_accepted, scan_classes, scan_work,
                        tiny_calibration)
from jackal_tpu.config import GroundPlaneParams as JaxGP
from jackal_tpu.config import ScanParams as JaxSP
from jackal_tpu.scan import obstacle as jobs
from jackal_tpu_torch.config import GroundPlaneParams, ScanParams
from jackal_tpu_torch.ops.convert import ftz
from jackal_tpu_torch.scan import obstacle as obs

FIELDS = ("scan", "angle_min", "angle_max", "range_min", "range_max")


# The operand classes of the flush probes: +-0, the least subnormal, 1e-40,
# 1.17e-38 and the largest subnormal, the least normal, normals whose
# squares underflow (1e-20, 1e-30), +-1, +-2, +-inf, seeded subnormal
# magnitudes and NaN
CLASSES = scan_classes()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU ops: when test workers share
    the cores, torch's thread pool spends its time waiting on itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(got, want, what=""):
    """float32 arrays equal bit for bit, any NaN equal to any NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  want[ok].view(np.int32), what)


def _scan_equals_jax(got, want, what=""):
    for f in FIELDS:
        _same_bits(getattr(got, f).numpy(), getattr(want, f), f"{what} {f}")
    np.testing.assert_array_equal(
        obs.format_laser_scan_ranges(got.scan),
        jobs.format_laser_scan_ranges(np.asarray(want.scan)), what)


def _points_scans(pts, valid=None, sp=ScanParams(), gp=GroundPlaneParams()):
    pts = np.asarray(pts, np.float32)
    valid = np.ones(pts.shape[:-1], bool) if valid is None else valid
    port = obs.obstacle_scan_from_points(torch.from_numpy(pts),
                                         torch.from_numpy(valid), sp, gp)
    ref = jobs.obstacle_scan_from_points(jnp.asarray(pts), jnp.asarray(valid),
                                         JaxSP(**sp.__dict__),
                                         JaxGP(**gp.__dict__))
    return port, ref


def _pairs():
    y, x = np.meshgrid(CLASSES, CLASSES, indexing="ij")
    return y.ravel(), x.ravel()


def test_atan2_equals_jitted_arctan2_on_the_class_grid():
    """Every (y, x) pair of the classes: glibc's atan2f under the flushes,
    bit for bit, where torch.atan2 differs (NaN for two nonzero
    subnormals, 0 where the quotient underflows, pi/2 - 1 ulp for a
    normal y over a negative subnormal x)."""
    y, x = _pairs()
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = obs._atan2_xla(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    _same_bits(got, want)
    plain = torch.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert not np.array_equal(np.isnan(plain), np.isnan(want))


def test_atan2_equals_jitted_arctan2_on_seeded_normal_pairs():
    """Normal operands over 2^-12 .. 2^12 and every quadrant, with a fifth
    of the x exactly 1 (glibc's atanf(y) path): the port's angle equals
    the reference on every pair; torch.atan2 does not."""
    rng = np.random.default_rng(22)
    n = 40000
    y = (rng.standard_normal(n) * np.exp2(rng.uniform(-12, 12, n))
         ).astype(np.float32)
    x = (rng.standard_normal(n) * np.exp2(rng.uniform(-12, 12, n))
         ).astype(np.float32)
    x[rng.random(n) < 0.2] = 1.0
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = obs._atan2_xla(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    _same_bits(got, want)
    plain = torch.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert (plain.view(np.int32) != want.view(np.int32)).sum() > n // 20


@pytest.mark.parametrize("op", ["product", "sum", "range", "less"])
def test_flushes_as_the_scan_combines_them(op):
    """On the class grid: the product and the sum read subnormal operands
    as zeros and flush subnormal results; the range sqrt(x * x + y * y) is
    sqrt(fma(x, x, y * y)) on flushed operands; x < y compares flushed
    values (-1e-40 < 0 is False)."""
    y, x = _pairs()
    Y, X = torch.from_numpy(y), torch.from_numpy(x)
    if op == "less":
        want = np.asarray(jax.jit(lambda a, b: a < b)(x, y))
        np.testing.assert_array_equal((ftz(X) < ftz(Y)).numpy(), want)
        assert not np.array_equal((X < Y).numpy(), want)
        return
    ref = {"product": lambda a, b: a * b, "sum": lambda a, b: a + b,
           "range": lambda a, b: jnp.sqrt(a * a + b * b)}[op]
    want = np.asarray(jax.jit(ref)(x, y))
    if op == "product":
        got = ftz(ftz(X) * ftz(Y))
    elif op == "sum":
        got = ftz(ftz(X) + ftz(Y))
    else:
        fx, fy = ftz(X), ftz(Y)
        got = obs._sqrt_rn(ftz(obs.fma_f32(fx, fx, ftz(fy * fy))))
    _same_bits(got.numpy(), want)


@pytest.mark.parametrize("xi", range(len(CLASSES)))
def test_points_scan_on_the_class_grid_equals_reference(xi):
    """The sets [[2, 0.1, 0.5], [x, y, 0.5]], both valid, for this x and
    every y of the classes: all five fields bit for bit and the published
    ranges."""
    x = CLASSES[xi]
    for y in CLASSES:
        got, want = _points_scans([[2.0, 0.1, 0.5], [x, y, 0.5]])
        _scan_equals_jax(got, want, f"x={x!r} y={y!r}")


PROBES = {
    # two nonzero subnormals: atan2 NaN (bin 0), the range 0
    "both coordinates subnormal": (
        [1e-40, 1e-40, 0.5], {"scan0": 0.0, "angle_min": np.nan}),
    # normal coordinates whose squares underflow: the range flushes to 0
    "squares underflow": ([1e-20, 1e-20, 0.5], {"range_min": 0.0}),
    # x * x = 9e-40 flushes, y * y underflows: the range 0 in bin 45
    "a subnormal square": ([3e-20, -1e-30, 0.5], {"scan45": 0.0,
                                                   "range_min": 0.0}),
}


@pytest.mark.parametrize("name", PROBES)
def test_the_three_probes_equal_reference(name):
    """The probes of the fault's report, [[2.0, 0.1, 0.5], p], default
    parameters: the port now gives the reference's values (scan[0] 0.0
    with NaN angles; range_min 0.0; scan[45] and range_min 0.0)."""
    p, expect = PROBES[name]
    got, want = _points_scans([[2.0, 0.1, 0.5], p])
    _scan_equals_jax(got, want, name)
    for k, v in expect.items():
        val = (float(got.scan[int(k[4:])]) if k.startswith("scan")
               else float(getattr(got, k)))
        assert (np.isnan(val) if np.isnan(v) else val == v), (k, val)


GROUNDS = {"presets": GroundPlaneParams(),
           "zero height and distance": GroundPlaneParams(
               height_thresh=0.0, dist_thresh=0.0),
           "subnormal height": GroundPlaneParams(height_thresh=1e-40,
                                                 dist_thresh=0.0)}


@pytest.mark.parametrize("ground", GROUNDS)
def test_ground_gate_on_flushed_operands_equals_reference(ground):
    """The ground gate with x and z from the classes: Xr < dist and
    Zr < thresh compare flushed values, the rising threshold is one
    flushed FMA; at a zero threshold a point at z = -1e-40 is no ground."""
    gp = GROUNDS[ground]
    z = CLASSES[np.isfinite(CLASSES)]
    for x in CLASSES:
        pts = np.stack([np.full_like(z, x), np.full_like(z, 0.25), z], -1)
        for i in range(len(z)):
            got, want = _points_scans(
                np.stack([[2.0, 0.1, 0.5], pts[i]]), gp=gp)
            _scan_equals_jax(got, want, f"{ground} x={x!r} z={z[i]!r}")


def test_points_scan_on_seeded_normal_sets_equals_reference():
    """Seeded sets of 64 normal points (a tenth not valid): before the
    repair about one field in forty differed by an ulp (torch.atan2,
    torch's CPU sqrt, the uncontracted range)."""
    rng = np.random.default_rng(23)
    for s in range(40):
        pts = np.stack([rng.uniform(-3, 6, 64), rng.uniform(-5, 5, 64),
                        rng.uniform(-0.3, 1.0, 64)], -1)
        got, want = _points_scans(pts, rng.random(64) < 0.9)
        _scan_equals_jax(got, want, f"set {s}")


@pytest.mark.parametrize("scales", [
    (2.0 ** -66, 2.0 ** -130), (2.0 ** -60, 2.0 ** -64),
    (2.0 ** -140, 1.0), (1.0, 2.0 ** -127), (2.0 ** -63, 2.0 ** -63)],
    ids=["squares underflow, Yr subnormal", "tiny normal Xr and Yr",
         "subnormal XR entry", "Yr subnormal products",
         "squares near the least normal"])
def test_map_scan_with_tiny_coordinates_equals_reference(scales):
    """obstacle_scan_from_disparity on a seeded 12 x 16 map whose
    calibration makes Xr and Yr tiny: the reprojection's flushes (a
    subnormal product or constant reads as zero) and the scan's, all five
    fields bit for bit."""
    Q, XR, XT = tiny_calibration(*scales)
    rng = np.random.default_rng(24)
    dm = rng.integers(0, 60, (12, 16)).astype(np.uint8)
    lo = rng.integers(0, 4, (12, 16))
    vd = np.stack([lo, np.full_like(lo, 255)], -1).astype(np.uint8)
    t = torch.from_numpy
    got = obs.obstacle_scan_from_disparity(t(dm), t(vd), t(Q), t(XR), t(XT))
    want = jobs.obstacle_scan_from_disparity(
        jnp.asarray(dm), jnp.asarray(vd), jnp.asarray(Q), jnp.asarray(XR),
        jnp.asarray(XT))
    _scan_equals_jax(got, want)


@pytest.mark.parametrize("colour", [False, True])
def test_fused_cloud_and_scan_equals_p2_then_p3_and_jax(colour):
    """cloud_and_scan_from_disparity_plain on two seeded 24 x 32 maps of the
    default calibration: the cloud and scan bit for bit those of P2 then
    P3 plain; against the JAX package, rgb bits and the valid mask equal,
    points within PERF.md's cloud tolerance (XLA contracts the
    reprojection), and the port's scan of the JAX points equal to the JAX
    scan bit for bit."""
    from jackal_tpu.scan.obstacle import point_cloud_from_disparity
    from jackal_tpu_torch.pipeline.default import make_pipeline

    pipe = make_pipeline(engine="bm", device="cpu")
    consts = (pipe.Q32, pipe.XR32, pipe.XT32)
    rng = np.random.default_rng(25)
    dm = torch.from_numpy(rng.integers(0, 90, (2, 24, 32)).astype(np.uint8))
    col = torch.from_numpy(rng.integers(0, 256, (2, 24, 32, 3)).astype(
        np.uint8)) if colour else None
    sp, gp = ScanParams(), GroundPlaneParams()
    cloud, scan = obs.cloud_and_scan_from_disparity(dm, col, *consts, sp, gp)
    p2 = obs.point_cloud_from_disparity_plain(dm, col, *consts, sp)
    p3 = obs.obstacle_scan_from_points_plain(p2[0], p2[2], sp, gp)
    for a, b in zip(cloud, p2):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    for f in FIELDS:
        _same_bits(getattr(scan, f).numpy(), getattr(p3, f).numpy(), f)
    for b in range(2):
        jpts, jrgb, jvalid = point_cloud_from_disparity(
            jnp.asarray(dm[b].numpy()),
            None if col is None else jnp.asarray(col[b].numpy()),
            *(jnp.asarray(c.numpy()) for c in consts), JaxSP())
        np.testing.assert_array_equal(cloud[1][b].numpy().view(np.int32),
                                      np.asarray(jrgb).view(np.int32))
        np.testing.assert_array_equal(cloud[2][b].numpy(), np.asarray(jvalid))
        np.testing.assert_allclose(cloud[0][b].numpy(), np.asarray(jpts),
                                   rtol=1e-5, atol=1e-6)
        got, want = _points_scans(np.array(jpts), np.array(jvalid))
        _scan_equals_jax(got, want, f"frame {b}")


def test_cpu_wrappers_count_no_launch(monkeypatch):
    """On CPU tensors the four wrappers run their plain versions: no
    kernel entry is reached and no counter moves."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA path ran on CPU tensors")

    for name in ("_scan_cuda", "_cloud_cuda", "_scan_points_cuda",
                 "_cloud_scan_cuda"):
        monkeypatch.setattr(obs, name, refuse)
    before = (dict(obs.launches), dict(obs.launches_fused))
    Q, XR, XT = (torch.from_numpy(c) for c in tiny_calibration(1.0, 1.0))
    dm = torch.from_numpy(np.random.default_rng(26).integers(
        0, 60, (3, 8, 10)).astype(np.uint8))
    vd = torch.zeros((8, 10, 2), dtype=torch.uint8)
    vd[..., 1] = 255
    obs.obstacle_scan_from_disparity(dm, vd, Q, XR, XT)
    cloud = obs.point_cloud_from_disparity(dm, None, Q, XR, XT)
    obs.obstacle_scan_from_points(cloud[0], cloud[2])
    _, scan = obs.cloud_and_scan_from_disparity(dm, None, Q, XR, XT)
    assert scan.scan.shape == (3, 90)
    assert (dict(obs.launches), dict(obs.launches_fused)) == before


@pytest.mark.parametrize("kernel", ["scan", "scan_points", "cloud_scan"])
def test_scan_work_counts_the_angle_on_accepted_points(kernel):
    """scan_work: every point pays its reprojection (or its ground gate),
    only an accepted one the range, the angle and the bin; with no count
    given, every point is taken as accepted."""
    n = 32 * 480 * 640
    always = scan_work(kernel, 32, 480, 640, accepted=0)[1]
    assert scan_work(kernel, 32, 480, 640)[1] == always + 34 * n
    assert scan_work(kernel, 32, 480, 640, accepted=1000)[1] \
        == always + 34 * 1000
    assert scan_work(kernel, 32, 480, 640, accepted=1000)[0] \
        == scan_work(kernel, 32, 480, 640)[0]
    assert always == n * {"scan": 41, "scan_points": 3, "cloud_scan": 50}[
        kernel]
    assert scan_work("cloud", 32, 480, 640, accepted=1000) \
        == scan_work("cloud", 32, 480, 640)


def test_scan_bound_by_bytes_below_the_accepted_share():
    """P1 at the node's 640x480 map: its bound is the bytes' while fewer
    than (bytes / byte rate * op rate / pixels - 41) / 34 of the pixels
    are accepted (about 56 %), the operations' above that."""
    n = 480 * 640
    nbytes = scan_work("scan", 1, 480, 640)[0]
    share = (nbytes / PEAK_BYTES_PER_S * PEAK_F32_OPS_PER_S / n - 41) / 34
    assert 0.5 < share < 0.6
    below, above = int(share * n) - 1, int(share * n) + 2
    assert bound_ms(*scan_work("scan", 1, 480, 640, accepted=below),
                    PEAK_F32_OPS_PER_S)[1] == "bytes"
    assert bound_ms(*scan_work("scan", 1, 480, 640, accepted=above),
                    PEAK_F32_OPS_PER_S)[1] == "operations"


def test_scan_accepted_counts_the_plain_versions_accept():
    """scan_accepted: P1's maps within the valid-range cache; P3's points
    under their mask that the ground gate keeps."""
    rng = np.random.default_rng(27)
    dm = torch.from_numpy(rng.integers(0, 60, (3, 8, 10)).astype(np.uint8))
    vd = torch.from_numpy(np.sort(rng.integers(0, 60, (8, 10, 2)), -1)
                          .astype(np.uint8))
    d, lo, hi = dm.numpy(), vd[..., 0].numpy(), vd[..., 1].numpy()
    assert scan_accepted(vd, dm) == int(((d >= lo) & (d <= hi)).sum())
    gp = GroundPlaneParams()
    pts = rng.normal(0.0, 1.0, (2, 50, 3)).astype(np.float32)
    valid = rng.random((2, 50)) < 0.7
    thresh = np.where(pts[..., 0] < gp.dist_thresh, gp.height_thresh,
                      gp.height_thresh + np.tan(gp.angle_thresh)
                      * (pts[..., 0] - gp.dist_thresh))
    want = int((valid & ~(pts[..., 2] < thresh)).sum())
    assert scan_accepted(gp=gp, pts=torch.from_numpy(pts),
                         valid=torch.from_numpy(valid)) == want
