"""The port's node on the CPU == jackal_tpu's node: remap bit for bit,
process_frame's u8 disparity bit for bit, the scan within tolerance.

Scan tolerance: the scan's reprojection, atan2 and sqrt run in float32.
XLA:CPU may contract a multiply into an add and its atan2 differs from
PyTorch's by up to an ulp, so per-bin ranges are held to a relative
1e-5 (tens of ulp at the ranges seen). A point within an ulp of a bin
edge could also change bin; the seeded frames below have none, so the
set of filled bins must be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jackal_tpu import config as jconfig
from jackal_tpu.geometry.remap import remap_bilinear as jax_remap
from jackal_tpu.pipeline.default import default_calibration as jax_calib
from jackal_tpu.pipeline.default import make_pipeline as jax_make_pipeline
from jackal_tpu.scan.obstacle import format_laser_scan_ranges as jax_ranges
from jackal_tpu_torch.compat import state_from_numpy
from jackal_tpu_torch.geometry.rectify import init_undistort_rectify_map
from jackal_tpu_torch.geometry.remap import remap_bilinear
from jackal_tpu_torch.pipeline.default import (default_calibration,
                                               make_pipeline)
from jackal_tpu_torch.pipeline.frame_pipeline import StereoPipeline
from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
from jackal_tpu_torch.scan.obstacle import format_laser_scan_ranges

SCAN_RTOL = 1e-5


def _jax_state():
    c = jax_calib()
    params = {"elas": dataclasses.asdict(jconfig.ElasParams()),
              "pipeline": dataclasses.asdict(jconfig.PipelineParams()),
              "scan": dataclasses.asdict(jconfig.ScanParams()),
              "ground_plane": dataclasses.asdict(jconfig.GroundPlaneParams())}
    return c, params


def test_state_from_numpy():
    c, params = _jax_state()
    st = state_from_numpy(dataclasses.asdict(c), params)
    mine = default_calibration()
    for f in dataclasses.fields(c):
        a, b, m = getattr(c, f.name), getattr(st.calib, f.name), \
            getattr(mine, f.name)
        if a is None:
            assert b is None and m is None
        else:
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(m, a)
    for group in ("elas", "pipeline", "scan", "ground_plane"):
        assert dataclasses.asdict(getattr(st, group)) == params[group]
    st2 = state_from_numpy(dataclasses.asdict(c),
                           {"elas": dataclasses.asdict(
                               jconfig.ElasParams.middlebury())})
    assert st2.elas.filter_median and st2.pipeline.im_width == 320
    with pytest.raises(ValueError):
        state_from_numpy(dataclasses.asdict(c), {"elas": {"nope": 1}})


@pytest.mark.parametrize("side", ["left", "right"])
def test_remap_matches_jax(side):
    c = default_calibration()
    pipe_maps = StereoPipeline(c, engine="elas", device="cpu")
    mx, my = pipe_maps.lmap if side == "left" else pipe_maps.rmap
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (360, 640)).astype(np.uint8)
    want = np.asarray(jax_remap(jnp.asarray(raw), jnp.asarray(mx.numpy()),
                                jnp.asarray(my.numpy())))
    got = remap_bilinear(torch.from_numpy(raw), mx, my).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).mean() < 0.5
    # the maps themselves come from the port's copy of rectify
    K, D = (c.K1, c.D1) if side == "left" else (c.K2, c.D2)
    R = pipe_maps.rect.R1 if side == "left" else pipe_maps.rect.R2
    P = pipe_maps.rect.P1 if side == "left" else pipe_maps.rect.P2
    mx2, _ = init_undistort_rectify_map(K, D, R, P, (320, 180))
    np.testing.assert_array_equal(mx.numpy(), mx2)


@pytest.fixture(scope="module")
def nodes():
    c, params = _jax_state()
    st = state_from_numpy(dataclasses.asdict(c), params)
    port = StereoPipeline(st.calib, st.pipeline, "elas", st.elas,
                          st.ground_plane, st.scan, device="cpu")
    return port, jax_make_pipeline(engine="elas")


@pytest.mark.parametrize("seed,disparity,slope", [(0, 12, 0.0),
                                                   (1, 6, 0.15)])
def test_process_frame_matches_jax(nodes, seed, disparity, slope):
    """Seeded raw 640x360 pairs of a wall and of a slanted surface."""
    port, ref = nodes
    left, right = synthetic_raw_pair(port, seed, disparity, slope)
    assert left.shape == (360, 640) and left.dtype == np.uint8
    want = ref.process_frame(left, right)
    got = port.process_frame(left, right)
    assert got.dmap.dtype == np.uint8 and got.dmap.shape == (180, 320)
    np.testing.assert_array_equal(got.dmap, want.dmap)
    assert (want.dmap > 0).mean() > 0.6
    ws, gs = np.asarray(want.scan.scan), got.scan.scan.numpy()
    filled = ws < 1e9 - 1
    assert filled.sum() >= 10
    np.testing.assert_array_equal(gs < 1e9 - 1, filled)
    np.testing.assert_allclose(gs[filled], ws[filled], rtol=SCAN_RTOL)
    np.testing.assert_allclose(format_laser_scan_ranges(got.scan.scan),
                               jax_ranges(want.scan.scan), rtol=SCAN_RTOL)
    for k in ("angle_min", "angle_max", "range_min", "range_max"):
        np.testing.assert_allclose(float(getattr(got.scan, k)),
                                   float(getattr(want.scan, k)),
                                   rtol=SCAN_RTOL)


def test_make_pipeline_runs_on_cpu_when_asked():
    pipe = make_pipeline(engine="elas", device="cpu")
    assert pipe.device.type == "cpu" and pipe.valid_disp.shape == (180, 320, 2)
