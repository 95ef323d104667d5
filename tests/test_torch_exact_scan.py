"""The port's exact float64 scan on the CPU == jackal_tpu's, bit for bit.

jackal_tpu_torch.scan.exact_scan against jackal_tpu.scan.exact_scan (its
softfloat float64 on XLA:CPU) and against a literal float64 host loop of
publishObstacleScan(Mat&) with the C++ gemm's sequential accumulation
(a copy of tests/test_scan.py:_scan_reference_loop_seq), on the bundled
calibration at 40x64 with crop offsets (120, 70); the empty case; and the
host boundary tables against the JAX module's. The JAX function runs op by
op (jax.disable_jit, ~10 s a call): XLA:CPU's compile of its whole
softfloat program as one jit took over 5 minutes and 14 GiB on the build
host.
"""
import math

import jax
import numpy as np
import pytest
import torch

from jackal_tpu.calib import load_calibration as jax_load_calibration
from jackal_tpu.geometry.rectify import stereo_rectify
from jackal_tpu.scan import exact_scan as jexact
from jackal_tpu.scan.valid_disp import cache_disparity_values
from jackal_tpu_torch.config import REF_PI
from jackal_tpu_torch.pipeline.default import default_calibration
from jackal_tpu_torch.scan import exact_scan
from jackal_tpu_torch.scan.obstacle import INF

JAX_CALIB = "jackal_tpu/data/default_calib.yml"
H, W, OX, OY = 40, 64, 120, 70


@pytest.fixture(scope="module")
def setup():
    c = jax_load_calibration(JAX_CALIB)
    mine = default_calibration()
    for name in ("K1", "D1", "K2", "D2", "R", "T", "XR", "XT"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(c, name))
    r = stereo_rectify(c.K1, c.D1, c.K2, c.D2, (640, 360), c.R, c.T,
                       True, 0.0, (320, 180))
    valid = cache_disparity_values(r.Q, c.XR, c.XT, W, H, OX, OY)
    return c, r, valid


def _scan_reference_loop_seq(dmap, valid, Q, XR, XT, ox, oy):
    """Literal publishObstacleScan(Mat&) port with the C++ gemm's
    SEQUENTIAL left-associated accumulation (cv::Mat's small-matrix
    multiply sums k = 0..3 in order)."""
    Q = np.asarray(Q, np.float64)
    XR = np.asarray(XR, np.float64)
    XT = np.asarray(XT, np.float64).reshape(3)
    H, W = dmap.shape
    scan = np.full(90, INF)
    mn_a, mx_a = 400.0, -400.0
    mn_r, mx_r = INF, -500.0
    n = 0
    for i in range(W):
        for j in range(H):
            d = int(dmap[j, i])
            if d < valid[j, i, 0] or d > valid[j, i, 1]:
                continue
            n += 1
            u, v = float(i + ox), float(j + oy)
            row = []
            for rr in range(4):
                t = Q[rr, 0] * u + Q[rr, 1] * v
                t = t + Q[rr, 2] * d
                row.append(t + Q[rr, 3])
            X = row[0] / row[3]
            Y = row[1] / row[3]
            Z = row[2] / row[3]
            Xr = (XR[0, 0] * X + XR[0, 1] * Y) + XR[0, 2] * Z + XT[0]
            Yr = (XR[1, 0] * X + XR[1, 1] * Y) + XR[1, 2] * Z + XT[1]
            th = math.atan2(Yr, Xr)
            thd = th * 180.0 / REF_PI
            mn_a, mx_a = min(mn_a, th), max(mx_a, th)
            r_ = math.sqrt(Yr * Yr + Xr * Xr)
            mn_r, mx_r = min(mn_r, r_), max(mx_r, r_)
            k = int(math.floor((90.0 * (45.0 - thd)) / 90.0))
            if 0 <= k < 90 and r_ < scan[k]:
                scan[k] = r_
    return scan, mn_a, mx_a, mn_r, mx_r


def _fields(res):
    return [np.asarray(torch.as_tensor(getattr(res, k)).cpu().numpy()
                       if torch.is_tensor(getattr(res, k))
                       else getattr(res, k), np.float64)
            for k in ("scan", "angle_min", "angle_max", "range_min",
                      "range_max")]


@pytest.mark.parametrize("seed", [3, 7])
def test_exact_scan_equals_jax_and_the_host_loop(setup, seed):
    c, r, valid = setup
    dmap = np.random.RandomState(seed).randint(0, 256, size=(H, W)).astype(
        np.uint8)
    got = exact_scan.obstacle_scan_from_disparity_exact(
        dmap, valid, r.Q, c.XR, c.XT, OX, OY, device="cpu")
    assert got.scan.dtype == torch.float64 and got.scan.shape == (90,)
    with jax.disable_jit():
        want = jexact.obstacle_scan_from_disparity_exact(
            dmap, valid, r.Q, c.XR, c.XT, OX, OY)
    loop = _scan_reference_loop_seq(dmap, valid, r.Q, c.XR, c.XT, OX, OY)
    for g, w, lp in zip(_fields(got), _fields(want), loop):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.asarray(lp, np.float64))
    assert (_fields(got)[0] < INF - 1).sum() >= 10


def test_exact_scan_empty(setup):
    """Nothing accepted (lo > hi everywhere), at the shape above: the
    reference's initial extrema and an empty scan."""
    c, r, _ = setup
    valid = np.zeros((H, W, 2), np.uint8)
    valid[..., 0] = 255
    dmap = np.full((H, W), 50, np.uint8)
    got = exact_scan.obstacle_scan_from_disparity_exact(
        dmap, valid, r.Q, c.XR, c.XT, OX, OY, device="cpu")
    with jax.disable_jit():
        want = jexact.obstacle_scan_from_disparity_exact(
            dmap, valid, r.Q, c.XR, c.XT, OX, OY)
    for g, wv in zip(_fields(got), _fields(want)):
        np.testing.assert_array_equal(g, wv)
    assert bool((got.scan >= INF - 1).all())
    assert float(got.angle_min) == 400.0 and float(got.angle_max) == -400.0


def test_boundary_tables_equal_jax():
    for a, b in zip(exact_scan._boundary_tables(),
                    jexact._boundary_tables()):
        np.testing.assert_array_equal(a, b)
    for x in (0.0, -0.0, 1.5, -2.25, 1e-300, -1e300):
        o = exact_scan._ord_f64(x)
        assert o == jexact._ord_f64(x)
        assert exact_scan._from_ord(o) == x
        assert int(exact_scan._ord(torch.tensor([x], dtype=torch.float64))
                   ) == o
