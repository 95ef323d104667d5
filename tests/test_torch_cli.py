"""The port's point_cloud CLI on the CPU == jackal_tpu's CLI, and live
extrinsics reach every path of the port's pipeline.

Both CLIs run in this process on the same frames (the synthetic stream,
or an NPZ replay of seeded calibrated pairs, on which ELAS finds
disparity): the u8 maps of --out are bit-equal and the scans are within
the port's scan tolerance (PERF.md section 2): relative 1e-5 per filled
bin, the same filled bins. The two-process broker runs are marked slow,
as the reference package's are.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jackal_tpu.cli.point_cloud as ref_cli
import jackal_tpu_torch.cli.point_cloud as port_cli
from jackal_tpu.pipeline.default import make_pipeline as ref_make_pipeline
from jackal_tpu_torch.config import PipelineParams
from jackal_tpu_torch.pipeline.default import make_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_RTOL = 1e-5
PHI, TRANS = (0.6, -2.5, 1.0), (0.0, 0.0, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_scans_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    filled = want < 1e9 - 1
    np.testing.assert_array_equal(got < 1e9 - 1, filled)
    np.testing.assert_allclose(got[filled], want[filled], rtol=SCAN_RTOL,
                               atol=0)
    np.testing.assert_array_equal(got[~filled], want[~filled])


def run_cli(cli, argv):
    """(rc, stdout) of an in-process CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def run_both(tmp_path, argv):
    """--out of the port's CLI (on the CPU) and the reference's."""
    outs = []
    for name, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                             ("ref", ref_cli, [])):
        out = str(tmp_path / f"{name}.npz")
        rc, stdout = run_cli(cli, argv + extra + ["--out", out])
        assert rc == 0, stdout
        with np.load(out) as z:
            outs.append(({k: z[k] for k in z.files}, stdout))
    return outs


@pytest.fixture(scope="module")
def calibrated_npz(tmp_path_factory):
    """Two raw 640x360 pairs of a known scene through the default
    calibration (pipeline/synthetic.py), as an NPZ replay source. The
    synthetic stream's frames are not camera frames: after rectification
    ELAS finds no support points in them, in both packages."""
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair
    pipe = make_pipeline(engine="bm", device="cpu")
    pairs = [synthetic_raw_pair(pipe, s, 10.0 + 4 * s, 0.03 * s)
             for s in range(2)]
    path = str(tmp_path_factory.mktemp("replay") / "pairs.npz")
    np.savez(path, left=np.stack([p[0] for p in pairs]),
             right=np.stack([p[1] for p in pairs]))
    return path


@pytest.mark.parametrize("engine,source", [
    ("elas", "synthetic"), ("elas", "calibrated"), ("bm", "synthetic"),
    ("sgm", "synthetic")])
def test_point_cloud_cli_equals_reference(engine, source, tmp_path,
                                          calibrated_npz):
    src = calibrated_npz if source == "calibrated" else "synthetic"
    (p, p_out), (r, r_out) = run_both(tmp_path, [
        "--engine", engine, "--source", src, "--frames", "2", "-l"])
    assert p["dmaps"].dtype == r["dmaps"].dtype == np.uint8
    assert p["dmaps"].shape == r["dmaps"].shape == (2, 180, 320)
    np.testing.assert_array_equal(p["dmaps"], r["dmaps"])
    assert p["scans"].shape == r["scans"].shape == (2, 90)
    assert_scans_close(p["scans"], r["scans"])
    assert "processed 2 frames" in p_out and "frame 1: dmap=" in p_out
    if source == "calibrated":
        assert (p["dmaps"] > 0).mean() > 0.3
        assert (p["scans"] < 1e9 - 1).sum() > 20


def test_point_cloud_cli_gen_pcl_equals_reference(tmp_path):
    """-g: the scan comes from the cloud's points."""
    (p, _), (r, _) = run_both(tmp_path, [
        "--engine", "bm", "--source", "synthetic", "--frames", "2", "-g"])
    np.testing.assert_array_equal(p["dmaps"], r["dmaps"])
    assert_scans_close(p["scans"], r["scans"])


def test_point_cloud_cli_live_extrinsics(tmp_path):
    """-m --phi --trans: both CLIs print the same XR/XT, their scans match
    and move from the default extrinsics'."""
    argv = ["--engine", "bm", "--source", "synthetic", "--frames", "2"]
    (p0, _), _ = run_both(tmp_path, argv)
    (p, p_out), (r, r_out) = run_both(tmp_path, argv + [
        "-m", "--phi", *map(str, PHI), "--trans", *map(str, TRANS)])
    rot = [line for line in p_out.splitlines() if "matrix" in line]
    assert rot and rot == [line for line in r_out.splitlines()
                           if "matrix" in line]
    np.testing.assert_array_equal(p["dmaps"], p0["dmaps"])
    assert_scans_close(p["scans"], r["scans"])
    assert not np.array_equal(p["scans"], p0["scans"])


def test_point_cloud_cli_batch(tmp_path):
    """--batch > 1: the streaming runner, ELAS on its stream scheduler."""
    for engine, path in (("elas", "elas_match_stream"),
                         ("bm", "double-buffered")):
        rc, out = run_cli(port_cli, [
            "--device", "cpu", "--engine", engine, "--source", "synthetic",
            "--size", "160x96", "--frames", "3", "--batch", "2", "-l", "-d",
            str(tmp_path / f"{engine}.d")])
        assert rc == 0, out
        assert "processed 3 frames" in out and path in out, out
        logged = open(tmp_path / f"{engine}.d").read().split()
        assert logged and all(float(x) >= 0 for x in logged)


def test_point_cloud_cli_needs_the_card(tmp_path, monkeypatch, capsys):
    """No card and no --device: a non-zero exit with resolve_device's
    message, and no map written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.npz"
    rc = port_cli.main(["--engine", "bm", "--frames", "1",
                        "--out", str(out)])
    assert rc != 0 and not out.exists()
    assert "device='cpu'" in capsys.readouterr().err


def test_live_extrinsic_update_reaches_every_path():
    """update_extrinsics (tests/test_io_and_pipeline.py:106-124 on the
    port): XR, XT and the valid-disparity cache equal the reference's
    after the update, the scan changes, and process_frame, process_batch,
    process_batch_fused and StreamingRunner all see the new extrinsics."""
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.pipeline.runner import TOPIC_SCAN, StreamingRunner

    pipe = make_pipeline(None, "bm", device="cpu")
    rng = np.random.default_rng(7)
    lraw = (rng.random((360, 640)) * 255).astype(np.uint8)
    rraw = np.roll(lraw, 5, axis=1)
    fr1 = pipe.process_frame(lraw, rraw)
    pipe.update_extrinsics(PHI, TRANS)
    ref = ref_make_pipeline(None, "bm")
    ref.update_extrinsics(PHI, TRANS)
    for name in ("XR32", "XT32", "valid_disp"):
        got = getattr(pipe, name).numpy()
        want = np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    fr2 = pipe.process_frame(lraw, rraw)
    s2 = fr2.scan.scan.numpy()
    assert not np.array_equal(fr1.scan.scan.numpy(), s2)
    assert_scans_close(s2, np.asarray(ref.process_frame(lraw, rraw).scan.scan))
    _, sc = pipe.process_batch_fused(lraw[None], rraw[None])
    np.testing.assert_array_equal(sc.scan[0].numpy(), s2)
    _, sc = pipe.process_batch(lraw[None], rraw[None])
    np.testing.assert_array_equal(sc.scan[0].numpy(), s2)
    bus = TopicBus()
    got = []
    bus.subscribe(TOPIC_SCAN, got.append)
    StreamingRunner(pipe, bus, batch_size=2).run(iter([(lraw, rraw)] * 2))
    from jackal_tpu_torch.scan.obstacle import format_laser_scan_ranges
    assert len(got) == 2
    assert got[1].ranges == format_laser_scan_ranges(s2).tolist()


def test_live_extrinsic_update_reaches_the_cloud():
    """With gen_pcl the cloud's points and the scan from them follow the
    update in process_frame, process_batch_fused_pcl and
    process_batch_pcl."""
    pipe = make_pipeline(None, "bm", PipelineParams(gen_pcl=True),
                         device="cpu")
    rng = np.random.default_rng(7)
    lraw = (rng.random((360, 640)) * 255).astype(np.uint8)
    rraw = np.roll(lraw, 5, axis=1)
    before = pipe.process_frame(lraw, rraw)
    pipe.update_extrinsics(PHI, TRANS)
    after = pipe.process_frame(lraw, rraw)
    def bits(points):   # points of invalid pixels are NaN
        return points.view(torch.int32)

    assert not torch.equal(bits(before.cloud[0]), bits(after.cloud[0]))
    for call in (pipe.process_batch_fused_pcl, pipe.process_batch_pcl):
        _, cloud, scans = call(lraw[None], rraw[None])
        assert torch.equal(bits(cloud[0][0]), bits(after.cloud[0]))
        assert torch.equal(cloud[2][0], after.cloud[2])
        assert torch.equal(scans.scan[0], after.scan.scan)


def test_runner_elas_stream_switch():
    """StreamingRunner(elas_stream=False) runs ELAS through the batch loop
    and publishes what the stream scheduler publishes (at 160x96: batched
    ELAS is slow on the CPU)."""
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.pipeline.runner import TOPIC_DEPTH, StreamingRunner
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    pipe = make_pipeline(engine="elas", device="cpu", params=PipelineParams(
        im_width=160, im_height=96, crop_im_width=160, crop_im_height=96))
    frames = [synthetic_raw_pair(pipe, s, 10.0 + 4 * s, 0.03 * s)
              for s in range(3)]
    maps = {}
    for stream in (True, False):
        bus = TopicBus()
        got = []
        bus.subscribe(TOPIC_DEPTH, got.append)
        runner = StreamingRunner(pipe, bus, batch_size=2,
                                 elas_stream=stream)
        assert not runner.used_elas_stream
        assert runner.run(iter(frames)) == 3
        assert runner.used_elas_stream == stream
        maps[stream] = np.stack([m.data for m in got])
    np.testing.assert_array_equal(maps[True], maps[False])
    assert (maps[True] > 0).mean() > 0.3


def test_runner_elas_stream_switch_gen_pcl():
    """With gen_pcl, StreamingRunner(elas_stream=False) publishes the maps,
    clouds and scans that the stream scheduler publishes."""
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.pipeline.runner import (
        TOPIC_DEPTH, TOPIC_PCL, TOPIC_SCAN, StreamingRunner)
    from jackal_tpu_torch.pipeline.synthetic import synthetic_raw_pair

    pipe = make_pipeline(engine="elas", device="cpu", params=PipelineParams(
        im_width=160, im_height=96, crop_im_width=160, crop_im_height=96,
        gen_pcl=True))
    frames = [synthetic_raw_pair(pipe, s, 10.0 + 4 * s, 0.03 * s)
              for s in range(2)]
    got = {}
    for stream in (True, False):
        bus = TopicBus()
        msgs = {t: [] for t in (TOPIC_DEPTH, TOPIC_PCL, TOPIC_SCAN)}
        for topic, out in msgs.items():
            bus.subscribe(topic, out.append)
        runner = StreamingRunner(pipe, bus, batch_size=2,
                                 elas_stream=stream)
        assert runner.run(iter(frames)) == 2
        assert runner.used_elas_stream == stream
        got[stream] = (
            np.stack([m.data for m in msgs[TOPIC_DEPTH]]),
            [np.asarray(m.points) for m in msgs[TOPIC_PCL]],
            [m.ranges for m in msgs[TOPIC_SCAN]])
    np.testing.assert_array_equal(got[True][0], got[False][0])
    for points, points_batched in zip(got[True][1], got[False][1]):
        np.testing.assert_array_equal(points, points_batched)
    assert got[True][2] == got[False][2]
    assert min(len(points) for points in got[True][1]) > 100


def test_cli_reconfig_poll_applies_live(tmp_path):
    """--reconfig JSON edits apply between frames in -m mode
    (tests/test_io_and_pipeline.py:127-142 on the port)."""
    cfg = tmp_path / "ext.json"
    cfg.write_text(json.dumps(
        {"phi": [1.3, -3.14, 1.57], "trans": [0.0, 0.0, 0.28]}))
    out = subprocess.run(
        [sys.executable, "-m", "jackal_tpu_torch.cli.point_cloud",
         "--device", "cpu", "--engine", "bm", "--frames", "2",
         "--source", "synthetic", "-m", "--reconfig", str(cfg)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    # the -m defaults, then the file's values on the first frame
    assert out.stdout.count("Rotation matrix") == 2, out.stdout


def _wait_for_bridge(proc, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError("node exited before bridging")
        if "bridged to broker" in line:
            time.sleep(0.3)
            return
    raise AssertionError("node never bridged to the broker")


@pytest.mark.slow
def test_point_cloud_and_navigate_as_two_processes():
    """The port's point_cloud publishes scans over the port's broker, its
    navigate consumes them and emits Twist commands and Markers."""
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.io_bus.socket_bus import BusBridge, BusBroker

    broker = BusBroker()
    addr = f"{broker.host}:{broker.port}"
    obs_bus = TopicBus()
    twists, markers, scans = [], [], []
    obs_bus.subscribe("/jackal_velocity_controller/cmd_vel", twists.append)
    obs_bus.subscribe("/visualize_laser", markers.append)
    obs_bus.subscribe("/webcam/left/obstacle_scan", scans.append)
    obs = BusBridge(obs_bus, addr,
                    subscribe_topics=("/jackal_velocity_controller/cmd_vel",
                                      "/visualize_laser",
                                      "/webcam/left/obstacle_scan"))
    try:
        nav = subprocess.Popen(
            [sys.executable, "-m", "jackal_tpu_torch.cli.navigate",
             "--bus", addr, "--mode", "stop", "--ticks", "3",
             "--bus-timeout", "240"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        _wait_for_bridge(nav)
        pc = subprocess.run(
            [sys.executable, "-m", "jackal_tpu_torch.cli.point_cloud",
             "--device", "cpu", "--bus", addr, "--engine", "bm",
             "--frames", "3", "--source", "synthetic", "--delay", "0.1"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert pc.returncode == 0, pc.stdout + pc.stderr
        out, _ = nav.communicate(timeout=300)
        assert nav.returncode == 0 and "cmd_vel" in out, out
        deadline = time.time() + 10
        while (not twists or not markers) and time.time() < deadline:
            time.sleep(0.05)
        assert scans and twists
        assert markers and markers[0].ns == "jackal_navigation"
    finally:
        obs.close()
        broker.close()


@pytest.mark.slow
def test_point_cloud_gen_pcl_publishes_cloud_over_broker():
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.io_bus.socket_bus import BusBridge, BusBroker

    broker = BusBroker()
    addr = f"{broker.host}:{broker.port}"
    obs_bus = TopicBus()
    clouds = []
    obs_bus.subscribe("/webcam/left/point_cloud", clouds.append)
    obs = BusBridge(obs_bus, addr,
                    subscribe_topics=("/webcam/left/point_cloud",))
    try:
        pc = subprocess.run(
            [sys.executable, "-m", "jackal_tpu_torch.cli.point_cloud",
             "--device", "cpu", "--bus", addr, "--engine", "bm",
             "--frames", "2", "-g", "--source", "synthetic",
             "--delay", "0.1"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert pc.returncode == 0, pc.stdout + pc.stderr
        deadline = time.time() + 10
        while len(clouds) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(clouds) >= 2
        pts = np.asarray(clouds[0].points)
        assert pts.ndim == 2 and pts.shape[1] == 3 and len(pts) > 0
        assert clouds[0].channels[0].name == "rgb"
        assert np.isfinite(pts).all()
    finally:
        obs.close()
        broker.close()
