"""The port's frame sources and cross-process bus == jackal_tpu's.

The camera cases of tests/test_camera.py run on both camera modules as
cases of one parametrised test; PGM files, NPZ and directory replay and
the synthetic stream give arrays equal to the reference's; the broker
routes the port's messages between two bridges in one process.
"""
import ctypes
import io
import time

import numpy as np
import pytest

from jackal_tpu.io_bus import camera as ref_camera
from jackal_tpu.io_bus import pgm as ref_pgm
from jackal_tpu.io_bus import replay as ref_replay
from jackal_tpu_torch.io_bus import camera as port_camera
from jackal_tpu_torch.io_bus import pgm as port_pgm
from jackal_tpu_torch.io_bus import replay as port_replay

CAMERAS = {"port": port_camera, "reference": ref_camera}


def _ioctl_numbers(cam, tmp_path):
    # documented 64-bit videodev2.h values
    assert cam.VIDIOC_S_FMT == 0xC0D05605
    assert cam.VIDIOC_REQBUFS == 0xC0145608
    assert cam.VIDIOC_QUERYBUF == 0xC0585609
    assert cam.VIDIOC_QBUF == 0xC058560F
    assert cam.VIDIOC_DQBUF == 0xC0585611
    assert cam.VIDIOC_STREAMON == 0x40045612
    assert cam.VIDIOC_STREAMOFF == 0x40045613
    assert cam.VIDIOC_S_PARM == 0xC0CC5616


def _fourcc(cam, tmp_path):
    assert cam.PIXFMT_YUYV == 0x56595559
    assert cam.PIXFMT_MJPG == 0x47504A4D
    assert cam.fourcc("GREY") == cam.PIXFMT_GREY == 0x59455247


def _parse_v4l2_spec(cam, tmp_path):
    dl, dr, o = cam.parse_v4l2_spec("v4l2:/dev/video1,/dev/video2")
    assert (dl, dr) == ("/dev/video1", "/dev/video2")
    assert o == {"width": 640, "height": 360, "fps": 60, "pixfmt": "YUYV"}
    dl, dr, o = cam.parse_v4l2_spec(
        "v4l2:/dev/video0,/dev/video4?1280x720@30,MJPG")
    assert o == {"width": 1280, "height": 720, "fps": 30, "pixfmt": "MJPG"}
    with pytest.raises(ValueError):
        cam.parse_v4l2_spec("v4l2:/dev/video1")


def _open_source_dispatch(cam, tmp_path):
    frames = list(cam.open_source("synthetic:2"))
    assert len(frames) == 2 and frames[0][0].shape == (360, 640)
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    np.savez(tmp_path / "s.npz", left=img, right=img)
    assert len(list(cam.open_source(str(tmp_path / "s.npz")))) == 1
    # the live device path raises cleanly when the devices are absent
    with pytest.raises(Exception):
        cam.open_source("v4l2:/dev/nonexistent0,/dev/nonexistent1")


def _yuyv_decode(cam, tmp_path):
    class FakeCam:
        width, height, pixfmt = 4, 2, "YUYV"
    y = np.arange(8, dtype=np.uint8)
    raw = np.stack([y, np.full(8, 128, np.uint8)], -1).tobytes()
    assert np.array_equal(cam.V4L2Camera._decode(FakeCam(), raw),
                          y.reshape(2, 4))


def _mjpeg_decode(cam, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = (np.random.default_rng(0).random((16, 16)) * 255).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", quality=95)

    class FakeCam:
        width, height, pixfmt = 16, 16, "MJPG"
    out = cam.V4L2Camera._decode(FakeCam(), b.getvalue())
    assert out is not None and out.shape == (16, 16)
    assert float(np.mean(np.abs(out.astype(int) - img.astype(int)))) < 8.0


CAMERA_CASES = {f.__name__.lstrip("_"): f for f in (
    _ioctl_numbers, _fourcc, _parse_v4l2_spec, _open_source_dispatch,
    _yuyv_decode, _mjpeg_decode)}


@pytest.mark.parametrize("module", sorted(CAMERAS))
@pytest.mark.parametrize("case", sorted(CAMERA_CASES))
def test_camera(case, module, tmp_path):
    CAMERA_CASES[case](CAMERAS[module], tmp_path)


def test_camera_structs_match_reference():
    """Every V4L2 structure has the reference's size and field offsets."""
    for name in ("v4l2_pix_format", "v4l2_format", "v4l2_requestbuffers",
                 "v4l2_timecode", "v4l2_buffer", "v4l2_streamparm"):
        a, b = getattr(port_camera, name), getattr(ref_camera, name)
        assert ctypes.sizeof(a) == ctypes.sizeof(b), name
        assert [(f[0], getattr(a, f[0]).offset) for f in a._fields_] == \
            [(f[0], getattr(b, f[0]).offset) for f in b._fields_], name


@pytest.mark.parametrize("want_color", [False, True])
def test_synthetic_stream_equals_reference(want_color):
    """The CLIs of both packages run on the same synthetic frames."""
    port = list(port_replay.synthetic_stream(3, want_color=want_color))
    ref = list(ref_replay.synthetic_stream(3, want_color=want_color))
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert len(p) == len(r) == (3 if want_color else 2)
        for a, b in zip(p, r):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    seeded = [list(m.synthetic_stream(1, 90, 200, 12.0, seed=5))[0]
              for m in (port_replay, ref_replay)]
    for a, b in zip(*seeded):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["boxes", "flat"])
def test_make_scene_equals_fixture_generator(kind, monkeypatch):
    """replay.make_scene is the golden fixtures' generator, disparity
    field included."""
    import os
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    from make_golden_fixtures import make_scene

    a = port_replay.make_scene(np.random.default_rng(3), 120, 256, 20.0,
                               kind)
    b = make_scene(np.random.default_rng(3), 120, 256, 20.0, kind)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_pgm_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img8 = rng.integers(0, 256, (7, 13)).astype(np.uint8)
    img16 = rng.integers(0, 65536, (5, 9)).astype(np.uint16)
    for img in (img8, img16):
        for save, load in ((port_pgm.save_pgm, ref_pgm.load_pgm),
                           (ref_pgm.save_pgm, port_pgm.load_pgm),
                           (port_pgm.save_pgm, port_pgm.load_pgm)):
            path = str(tmp_path / "x.pgm")
            save(path, img)
            out = load(path)
            assert out.dtype == img.dtype
            np.testing.assert_array_equal(out, img)
        files = [str(tmp_path / f"{m}.pgm") for m in ("port", "ref")]
        port_pgm.save_pgm(files[0], img)
        ref_pgm.save_pgm(files[1], img)
        assert open(files[0], "rb").read() == open(files[1], "rb").read()
    # ascii P2 with a comment line
    path = tmp_path / "a.pgm"
    path.write_bytes(b"P2\n# comment\n3 2\n255\n1 2 3\n4 5 255\n")
    for load in (port_pgm.load_pgm, ref_pgm.load_pgm):
        np.testing.assert_array_equal(
            load(str(path)), np.array([[1, 2, 3], [4, 5, 255]], np.uint8))
    path.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(ValueError):
        port_pgm.load_pgm(str(path))


@pytest.mark.parametrize("want_color", [False, True])
def test_replay_sources_equal_reference(tmp_path, want_color):
    """NPZ replay (a stack with and without colour frames, one pair) and a
    directory of PGM pairs yield the reference's frames; loop cycles."""
    rng = np.random.default_rng(1)
    left = rng.integers(0, 256, (3, 12, 20)).astype(np.uint8)
    right = rng.integers(0, 256, (3, 12, 20)).astype(np.uint8)
    color = rng.integers(0, 256, (3, 12, 20, 3)).astype(np.uint8)
    np.savez(tmp_path / "plain.npz", left=left, right=right)
    np.savez(tmp_path / "color.npz", left=left, right=right, color=color)
    np.savez(tmp_path / "one.npz", left=left[0], right=right[0])
    d = tmp_path / "dir"
    d.mkdir()
    for i in range(2):
        port_pgm.save_pgm(str(d / f"left{i}.pgm"), left[i])
        port_pgm.save_pgm(str(d / f"right{i}.pgm"), right[i])
    for src in ("plain.npz", "color.npz", "one.npz", "dir"):
        path = str(tmp_path / src)
        p = port_replay.StereoReplaySource(path, want_color=want_color)
        r = ref_replay.StereoReplaySource(path, want_color=want_color)
        assert len(p) == len(r) > 0
        for a, b in zip(p, r):
            assert len(a) == len(b) == (3 if want_color else 2)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    looped = port_replay.StereoReplaySource(str(tmp_path / "plain.npz"),
                                            loop=True)
    it = iter(looped)
    frames = [next(it) for _ in range(7)]
    np.testing.assert_array_equal(frames[6][0], left[0])
    np.savez(tmp_path / "bad.npz", x=left)
    with pytest.raises(ValueError, match="stereo NPZ"):
        port_replay.StereoReplaySource(str(tmp_path / "bad.npz"))


def test_jpeg_decode_equals_reference():
    Image = pytest.importorskip("PIL.Image")
    img = (np.random.default_rng(2).random((16, 24, 3)) * 255).astype(
        np.uint8)
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", quality=90)
    data = b.getvalue()
    for name in ("decode_jpeg_gray", "decode_jpeg_bgr"):
        a = getattr(port_replay, name)(data)
        r = getattr(ref_replay, name)(data)
        assert a is not None
        np.testing.assert_array_equal(a, r)
    assert port_replay.decode_jpeg_gray(b"not a jpeg") is None


def test_broker_routes_between_bridges():
    """tests/test_socket_bus.py's in-process routing test on the port's
    broker, bridges and messages."""
    from jackal_tpu_torch.io_bus.bus import TopicBus
    from jackal_tpu_torch.io_bus.messages import Header, LaserScan
    from jackal_tpu_torch.io_bus.socket_bus import BusBridge, BusBroker

    broker = BusBroker()
    try:
        bus_a, bus_b = TopicBus(), TopicBus()
        got, echoed, other = [], [], []
        bus_b.subscribe("/t", got.append)
        bus_b.subscribe("/u", other.append)
        bus_a.subscribe("/t", echoed.append)
        addr = f"{broker.host}:{broker.port}"
        br_b = BusBridge(bus_b, addr, subscribe_topics=("/t",))
        br_a = BusBridge(bus_a, addr, publish_topics=("/t", "/u"),
                         subscribe_topics=("/t",))
        time.sleep(0.2)   # let the broker register the subscriptions
        msg = LaserScan(Header.now(0, "jackal"), -0.5, 0.5, 0.03, 0.1,
                        0.001, 0.3, 3.0, [1.0, 2.0])
        bus_a.publish("/t", msg)
        bus_a.publish("/u", msg)
        deadline = time.time() + 5
        while not got and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert len(got) == 1 and got[0].ranges == [1.0, 2.0]
        assert type(got[0]) is LaserScan and got[0].header.seq == 0
        # no echo back to the sender, and unsubscribed topics not routed
        assert len(echoed) == 1 and not other
        br_a.close()
        br_b.close()
    finally:
        broker.close()
