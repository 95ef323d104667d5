"""Camera-source abstraction: live V4L2 capture + replay/synthetic sources
behind one interface.

The reference's camera tier is uvc_stereo_node: two UVC webcams at 640x360
@ 60 fps on /dev/video1 + /dev/video2 (launch/stereo.launch:4-11,
launch/webcam_left.launch). Here the equivalent is `V4L2StereoCamera`, a
dependency-free V4L2 capture client (ctypes ioctl + mmap streaming I/O on
the kernel's videodev2 UAPI — no OpenCV, no libuvc): negotiates YUYV or
MJPEG at the requested size/rate, mmaps a small ring of kernel buffers and
yields synchronized grayscale pairs (YUYV -> Y plane directly; MJPEG ->
PIL decode, mirroring the compressed-topic decode point_cloud.cpp:436).

`open_source()` is the single entry point used by the CLIs:
    synthetic[:n]          deterministic synthetic stream
    path.npz | directory   recorded replay (io_bus/replay.py)
    v4l2:/dev/video1,/dev/video2[?640x360@60[,fmt]]   live cameras

Struct layouts are validated against the kernel's documented ioctl numbers
(tests/test_torch_io_bus.py) so layout drift fails loudly rather than
corrupting ioctl calls.
"""
from __future__ import annotations

import ctypes
import fcntl
import mmap
import os
import select
from typing import Iterator, Optional, Tuple

import numpy as np

u32 = ctypes.c_uint32
s32 = ctypes.c_int32


# ---- videodev2 UAPI structs (64-bit layout) --------------------------------

class v4l2_pix_format(ctypes.Structure):
    _fields_ = [("width", u32), ("height", u32), ("pixelformat", u32),
                ("field", u32), ("bytesperline", u32), ("sizeimage", u32),
                ("colorspace", u32), ("priv", u32), ("flags", u32),
                ("ycbcr_enc", u32), ("quantization", u32),
                ("xfer_func", u32)]


class _fmt_union(ctypes.Union):
    # the kernel union includes pointer-bearing members (v4l2_window), so
    # its alignment is 8; the c_void_p member reproduces that
    _fields_ = [("pix", v4l2_pix_format), ("_align", ctypes.c_void_p),
                ("raw_data", ctypes.c_ubyte * 200)]


class v4l2_format(ctypes.Structure):
    _fields_ = [("type", u32), ("fmt", _fmt_union)]


class v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [("count", u32), ("type", u32), ("memory", u32),
                ("capabilities", u32), ("flags", ctypes.c_uint8),
                ("reserved", ctypes.c_uint8 * 3)]


class v4l2_timecode(ctypes.Structure):
    _fields_ = [("type", u32), ("flags", u32), ("frames", ctypes.c_uint8),
                ("seconds", ctypes.c_uint8), ("minutes", ctypes.c_uint8),
                ("hours", ctypes.c_uint8), ("userbits", ctypes.c_uint8 * 4)]


class _timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _buf_m_union(ctypes.Union):
    _fields_ = [("offset", u32), ("userptr", ctypes.c_ulong),
                ("planes", ctypes.c_void_p), ("fd", s32)]


class v4l2_buffer(ctypes.Structure):
    _fields_ = [("index", u32), ("type", u32), ("bytesused", u32),
                ("flags", u32), ("field", u32), ("timestamp", _timeval),
                ("timecode", v4l2_timecode), ("sequence", u32),
                ("memory", u32), ("m", _buf_m_union), ("length", u32),
                ("reserved2", u32), ("request_fd", s32)]


class v4l2_streamparm_capture(ctypes.Structure):
    _fields_ = [("capability", u32), ("capturemode", u32),
                ("timeperframe_num", u32), ("timeperframe_den", u32),
                ("extendedmode", u32), ("readbuffers", u32),
                ("reserved", u32 * 4)]


class _parm_union(ctypes.Union):
    _fields_ = [("capture", v4l2_streamparm_capture),
                ("raw_data", ctypes.c_ubyte * 200)]


class v4l2_streamparm(ctypes.Structure):
    _fields_ = [("type", u32), ("parm", _parm_union)]


def _IOC(direction: int, nr: int, size: int) -> int:
    return (direction << 30) | (size << 16) | (ord("V") << 8) | nr


def _IOW(nr, struct):
    return _IOC(1, nr, ctypes.sizeof(struct))


def _IOWR(nr, struct):
    return _IOC(3, nr, ctypes.sizeof(struct))


VIDIOC_S_FMT = _IOWR(5, v4l2_format)
VIDIOC_REQBUFS = _IOWR(8, v4l2_requestbuffers)
VIDIOC_QUERYBUF = _IOWR(9, v4l2_buffer)
VIDIOC_QBUF = _IOWR(15, v4l2_buffer)
VIDIOC_DQBUF = _IOWR(17, v4l2_buffer)
VIDIOC_STREAMON = _IOW(18, s32)
VIDIOC_STREAMOFF = _IOW(19, s32)
VIDIOC_S_PARM = _IOWR(22, v4l2_streamparm)

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_FIELD_NONE = 1


def fourcc(code: str) -> int:
    a, b, c, d = (ord(ch) for ch in code)
    return a | (b << 8) | (c << 16) | (d << 24)


PIXFMT_YUYV = fourcc("YUYV")
PIXFMT_MJPG = fourcc("MJPG")
PIXFMT_GREY = fourcc("GREY")


class V4L2Camera:
    """Single V4L2 capture device with mmap streaming I/O."""

    def __init__(self, device: str, width: int = 640, height: int = 360,
                 fps: int = 60, pixfmt: str = "YUYV", n_buffers: int = 4):
        self.device = device
        self.pixfmt = pixfmt.upper()
        self.fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        self.buffers = []
        try:
            fmt = v4l2_format()
            fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            fmt.fmt.pix.width = width
            fmt.fmt.pix.height = height
            fmt.fmt.pix.pixelformat = fourcc(self.pixfmt)
            fmt.fmt.pix.field = V4L2_FIELD_NONE
            fcntl.ioctl(self.fd, VIDIOC_S_FMT, fmt)
            # driver may adjust: record what it actually granted
            self.width = int(fmt.fmt.pix.width)
            self.height = int(fmt.fmt.pix.height)
            self.bytesperline = int(fmt.fmt.pix.bytesperline)
            got = int(fmt.fmt.pix.pixelformat)
            for name, code in (("YUYV", PIXFMT_YUYV), ("MJPG", PIXFMT_MJPG),
                               ("GREY", PIXFMT_GREY)):
                if got == code:
                    self.pixfmt = name
                    break
            else:
                raise RuntimeError(
                    f"{device}: driver negotiated unsupported pixel format "
                    f"0x{got:08x}")

            parm = v4l2_streamparm()
            parm.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            parm.parm.capture.timeperframe_num = 1
            parm.parm.capture.timeperframe_den = max(fps, 1)
            try:
                fcntl.ioctl(self.fd, VIDIOC_S_PARM, parm)
            except OSError:
                pass  # fixed-rate drivers reject S_PARM; keep their rate

            req = v4l2_requestbuffers()
            req.count = n_buffers
            req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            req.memory = V4L2_MEMORY_MMAP
            fcntl.ioctl(self.fd, VIDIOC_REQBUFS, req)
            if req.count < 2:
                raise RuntimeError(f"{device}: insufficient buffer memory")

            for i in range(req.count):
                buf = v4l2_buffer()
                buf.index = i
                buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
                buf.memory = V4L2_MEMORY_MMAP
                fcntl.ioctl(self.fd, VIDIOC_QUERYBUF, buf)
                mm = mmap.mmap(self.fd, buf.length,
                               flags=mmap.MAP_SHARED,
                               prot=mmap.PROT_READ | mmap.PROT_WRITE,
                               offset=buf.m.offset)
                self.buffers.append(mm)
                fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)

            fcntl.ioctl(self.fd, VIDIOC_STREAMON, s32(
                V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except Exception:
            self.close()
            raise

    def read_gray(self, timeout: float = 2.0) -> Optional[np.ndarray]:
        """Dequeue one frame as grayscale [H, W] uint8; None on timeout or
        decode failure (the reference swallows decode errors the same way,
        point_cloud.cpp:467-469)."""
        r, _, _ = select.select([self.fd], [], [], timeout)
        if not r:
            return None
        buf = v4l2_buffer()
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = V4L2_MEMORY_MMAP
        try:
            fcntl.ioctl(self.fd, VIDIOC_DQBUF, buf)
        except OSError:
            return None
        try:
            raw = self.buffers[buf.index][:buf.bytesused]
            return self._decode(raw)
        finally:
            fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)

    def _decode(self, raw: bytes) -> Optional[np.ndarray]:
        H, W = self.height, self.width
        if self.pixfmt == "YUYV":
            if len(raw) < W * H * 2:
                return None
            arr = np.frombuffer(raw, np.uint8, count=W * H * 2)
            return arr.reshape(H, W, 2)[:, :, 0].copy()  # Y plane
        if self.pixfmt == "GREY":
            if len(raw) < W * H:
                return None
            return np.frombuffer(raw, np.uint8, count=W * H) \
                .reshape(H, W).copy()
        # MJPG
        from .replay import decode_jpeg_gray
        return decode_jpeg_gray(bytes(raw))

    def read_gray_bgr(self, timeout: float = 2.0):
        """Dequeue one frame as (gray [H,W], bgr [H,W,3]) uint8 — the
        color plane feeds the gen-pcl cloud's packed-RGB channel. YUYV is
        converted with integer BT.601 (the uvc webcam wire format); GREY
        replicates; MJPG decodes color."""
        r, _, _ = select.select([self.fd], [], [], timeout)
        if not r:
            return None
        buf = v4l2_buffer()
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = V4L2_MEMORY_MMAP
        try:
            fcntl.ioctl(self.fd, VIDIOC_DQBUF, buf)
        except OSError:
            return None
        try:
            raw = bytes(self.buffers[buf.index][:buf.bytesused])
        finally:
            fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
        H, W = self.height, self.width
        if self.pixfmt == "YUYV":
            if len(raw) < W * H * 2:
                return None
            arr = np.frombuffer(raw, np.uint8, count=W * H * 2) \
                .reshape(H, W, 2)
            y = arr[:, :, 0].astype(np.int32)
            uv = arr[:, :, 1].reshape(H, W // 2, 2).astype(np.int32) - 128
            u = np.repeat(uv[:, :, 0], 2, axis=1)
            v = np.repeat(uv[:, :, 1], 2, axis=1)
            # integer BT.601 (x256 fixed point)
            r_ = y + ((359 * v) >> 8)
            g_ = y - ((88 * u + 183 * v) >> 8)
            b_ = y + ((454 * u) >> 8)
            bgr = np.stack([b_, g_, r_], axis=-1)
            return (arr[:, :, 0].copy(),
                    np.clip(bgr, 0, 255).astype(np.uint8))
        if self.pixfmt == "GREY":
            if len(raw) < W * H:
                return None
            g = np.frombuffer(raw, np.uint8, count=W * H).reshape(H, W) \
                .copy()
            return g, np.repeat(g[..., None], 3, axis=-1)
        from .replay import decode_jpeg_bgr, decode_jpeg_gray
        g = decode_jpeg_gray(raw)
        c = decode_jpeg_bgr(raw)
        if g is None or c is None:
            return None
        return g, c

    def close(self) -> None:
        try:
            fcntl.ioctl(self.fd, VIDIOC_STREAMOFF, s32(
                V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for mm in self.buffers:
            try:
                mm.close()
            except Exception:
                pass
        self.buffers = []
        try:
            os.close(self.fd)
        except OSError:
            pass


class V4L2StereoCamera:
    """Synchronized stereo pair of V4L2 cameras (uvc_stereo_node
    equivalent). Pairing policy is latest-per-device, like the reference's
    unsynchronized latest-right-frame behavior."""

    def __init__(self, dev_left: str, dev_right: str, width: int = 640,
                 height: int = 360, fps: int = 60, pixfmt: str = "YUYV",
                 want_color: bool = False):
        self.want_color = want_color
        self.left = V4L2Camera(dev_left, width, height, fps, pixfmt)
        try:
            self.right = V4L2Camera(dev_right, width, height, fps, pixfmt)
        except Exception:
            self.left.close()
            raise

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        while True:
            if self.want_color:
                lc = self.left.read_gray_bgr()
                rf = self.right.read_gray()
                if lc is None or rf is None:
                    return
                yield lc[0], rf, lc[1]
                continue
            lf = self.left.read_gray()
            rf = self.right.read_gray()
            if lf is None or rf is None:
                return
            yield lf, rf

    def close(self) -> None:
        self.left.close()
        self.right.close()


def parse_v4l2_spec(spec: str):
    """'v4l2:/dev/video1,/dev/video2[?640x360@60[,YUYV]]' -> kwargs."""
    body = spec[len("v4l2:"):]
    opts = {"width": 640, "height": 360, "fps": 60, "pixfmt": "YUYV"}
    if "?" in body:
        body, q = body.split("?", 1)
        if "," in q:
            q, fmt = q.split(",", 1)
            opts["pixfmt"] = fmt
        size, _, rate = q.partition("@")
        w, _, h = size.partition("x")
        opts["width"], opts["height"] = int(w), int(h)
        if rate:
            opts["fps"] = int(rate)
    devs = body.split(",")
    if len(devs) != 2:
        raise ValueError(f"v4l2 source needs two devices, got {spec!r}")
    return devs[0], devs[1], opts


def open_source(spec: str, n_synthetic: int = 64,
                want_color: bool = False, loop: bool = False):
    """Resolve a --source spec to an iterable of (left, right) pairs, or
    (left, right, color_bgr) triples when want_color (gen-pcl mode feeds
    the left color frame into the cloud RGB channel). loop: replay
    sources cycle forever (bounded by the caller's frame limit)."""
    from .replay import StereoReplaySource, synthetic_stream

    if spec.startswith("synthetic"):
        _, _, n = spec.partition(":")
        return synthetic_stream(int(n) if n else n_synthetic,
                                want_color=want_color)
    if spec.startswith("v4l2:"):
        dl, dr, opts = parse_v4l2_spec(spec)
        return V4L2StereoCamera(dl, dr, want_color=want_color, **opts)
    return StereoReplaySource(spec, want_color=want_color, loop=loop)
