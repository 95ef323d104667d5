"""The port's exact float64 scan on the CPU at its edges == jackal_tpu's,
and its bins do not depend on the float32 angle's last bits.

jackal_tpu_torch.scan.exact_scan against jackal_tpu.scan.exact_scan (op by
op under jax.disable_jit, as tests/test_torch_exact_scan.py runs it) on
chip_smoke.EXACT_SCAN_EDGE_CASES: the origin pixel (X = Y = 0, bin 45,
range 0), pixels at X <= 0 (the angle's other bands), two pairs of pixels
tied on (band, ratio) whose atan2 values differ by an ulp (the first flat
index must win), and a map with nothing accepted. Then _device_scan with
its float32 angle moved up to 4096 ulps either way (torch.atan2 replaced
for the call): every field stays as it was. The bin's float32 candidate
is corrected by the exact midpoint tests, so the card's atan2f, which
kernel V calls, may stand in for the CPU's.
"""
import math

import jax
import numpy as np
import pytest
import torch

from chip_smoke import (EXACT_SCAN_EDGE_CASES, EXACT_SCAN_TIES,
                        exact_scan_edge_case)
from jackal_tpu.calib import load_calibration as jax_load_calibration
from jackal_tpu.geometry.rectify import stereo_rectify
from jackal_tpu.scan import exact_scan as jexact
from jackal_tpu.scan.valid_disp import cache_disparity_values
from jackal_tpu_torch.scan import exact_scan
from jackal_tpu_torch.scan.obstacle import INF

FIELDS = ("scan", "angle_min", "angle_max", "range_min", "range_max")
SHIFTS = (-4096, -4, -1, 1, 4, 4096)   # ulps of the float32 angle


def _fields(res):
    return [np.asarray(torch.as_tensor(getattr(res, f)), np.float64)
            for f in FIELDS]


def _port(case):
    dmap, valid, Q, XR, XT, ox, oy = case
    return exact_scan.obstacle_scan_from_disparity_exact(
        dmap, valid, Q, XR, XT, ox, oy, device="cpu")


@pytest.mark.parametrize("name", EXACT_SCAN_EDGE_CASES)
def test_exact_scan_edges_equal_jax(name):
    case = exact_scan_edge_case(name)
    got = _fields(_port(case))
    with jax.disable_jit():
        want = _fields(jexact.obstacle_scan_from_disparity_exact(*case))
    for f, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=f)
    scan, amin, amax, rmin, _ = got
    if name == "origin pixel":
        assert scan[45] == 0.0 and rmin == 0.0
    if name == "X <= 0":                # the least angle lies at X < 0
        assert amin < -np.pi / 2 and amax > np.pi / 2
    if name == "tied extrema":
        # each pair's first pixel by flat index, not its least or
        # greatest atan2: the pairs' other pixels are an ulp below / above
        th = [math.atan2(dy / d, dx / d) for dx, dy, d in EXACT_SCAN_TIES]
        assert amin == th[0] and th[1] < th[0]
        assert amax == th[2] and th[3] > th[2]
    if name == "nothing accepted":
        assert (scan >= INF - 1).all() and (amin, amax) == (400.0, -400.0)


@pytest.fixture(scope="module")
def calibrated_maps():
    """Two seeded 40x64 maps on the bundled calibration, as
    tests/test_torch_exact_scan.py builds them."""
    c = jax_load_calibration("jackal_tpu/data/default_calib.yml")
    r = stereo_rectify(c.K1, c.D1, c.K2, c.D2, (640, 360), c.R, c.T, True,
                       0.0, (320, 180))
    valid = cache_disparity_values(r.Q, c.XR, c.XT, 64, 40, 120, 70)
    return {seed: (np.random.RandomState(seed).randint(0, 256, (40, 64))
                   .astype(np.uint8), valid, r.Q, c.XR, c.XT, 120, 70)
            for seed in (3, 7)}


def _shifted_atan2(orig, ulps):
    def atan2(y, x):
        th = orig(y, x)
        spacing = torch.from_numpy(np.spacing(np.abs(th.numpy())))
        return th + ulps * spacing
    return atan2


@pytest.mark.parametrize("name", ["seed 3", "seed 7"]
                         + list(EXACT_SCAN_EDGE_CASES[:3]))
def test_exact_scan_bins_survive_a_shifted_angle(name, calibrated_maps,
                                                 monkeypatch):
    case = (calibrated_maps[int(name[5:])] if name.startswith("seed")
            else exact_scan_edge_case(name))
    floors = []
    orig_floor, orig_atan2 = torch.floor, torch.atan2

    def spy_floor(x):               # the candidate bin, before its tests
        out = orig_floor(x)
        floors.append(out.clone())
        return out

    monkeypatch.setattr(torch, "floor", spy_floor)
    want = _fields(_port(case))
    base = floors[-1]
    moved = 0
    for ulps in SHIFTS:
        monkeypatch.setattr(torch, "atan2", _shifted_atan2(orig_atan2, ulps))
        got = _fields(_port(case))
        for f, g, w in zip(FIELDS, got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{f}, {ulps} ulps")
        moved += int((floors[-1] != base).sum())
    monkeypatch.setattr(torch, "atan2", orig_atan2)
    if name.startswith("seed"):     # the shifts moved some candidates
        assert moved > 0
