"""Frame sources: NPZ/image-directory replay and synthetic generation.

Stands in for the reference's camera topics (uvc_stereo_node at 640x360
@60fps, launch/stereo.launch) for offline and benchmark runs. JPEG topics
are decoded with cv2 when available (the reference wire format,
point_cloud.cpp:436), else PIL; PGM and NPZ arrays need neither.
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .pgm import load_pgm


def _imread_gray(path: str) -> np.ndarray:
    if path.endswith(".pgm"):
        return load_pgm(path)
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError(f"cannot read {path}")
        return img
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert("L"))


def _imread_bgr(path: str) -> np.ndarray:
    """Color read in OpenCV BGR channel order (like leftim_res,
    point_cloud.cpp:356-383). PGM has no color: replicate gray."""
    if path.endswith(".pgm"):
        g = load_pgm(path)
        return np.repeat(g[..., None], 3, axis=-1)
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"cannot read {path}")
        return img
    except ImportError:
        from PIL import Image
        rgb = np.asarray(Image.open(path).convert("RGB"))
        return rgb[..., ::-1].copy()


def decode_jpeg_gray(data: bytes) -> Optional[np.ndarray]:
    """cv::imdecode(..., GRAYSCALE) equivalent (point_cloud.cpp:436).
    Returns None on decode failure, like the reference's empty-Mat check.
    cv2 when present; PIL otherwise (this image ships PIL, not cv2)."""
    try:
        import cv2
        arr = np.frombuffer(data, np.uint8)
        return cv2.imdecode(arr, cv2.IMREAD_GRAYSCALE)
    except ImportError:
        pass
    except Exception:
        return None
    try:
        import io
        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    except Exception:
        return None


def decode_jpeg_bgr(data: bytes) -> Optional[np.ndarray]:
    """cv::imdecode(..., COLOR) equivalent: [H, W, 3] uint8 BGR."""
    try:
        import cv2
        arr = np.frombuffer(data, np.uint8)
        return cv2.imdecode(arr, cv2.IMREAD_COLOR)
    except ImportError:
        pass
    except Exception:
        return None
    try:
        import io
        from PIL import Image
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        return rgb[..., ::-1].copy()
    except Exception:
        return None


class StereoReplaySource:
    """Iterates (left, right) uint8 frame pairs from an NPZ file or a
    directory of left*/right* images; with want_color, yields
    (left, right, color_bgr) triples — the left COLOR frame feeds the
    gen-pcl cloud's packed-RGB channel (point_cloud.cpp:356-383). NPZ
    sources use a bundled 'color' array when present, else replicate the
    left gray frame."""

    def __init__(self, path: str, loop: bool = False,
                 want_color: bool = False):
        self.loop = loop
        self.want_color = want_color
        self.pairs = []
        if path.endswith(".npz"):
            z = np.load(path)
            if "left" not in z or "right" not in z:
                raise ValueError(
                    f"{path} is not a stereo NPZ (needs 'left' and 'right' "
                    f"arrays; has {sorted(z.files)})")
            left, right = z["left"], z["right"]
            color = z["color"] if "color" in z else None
            if left.ndim == 2:
                cols = [color]
                left, right = left[None], right[None]
            else:
                cols = (color if color is not None
                        else [None] * len(left))
            for i in range(len(left)):
                c = cols[i]
                if want_color and c is None:
                    c = np.repeat(left[i][..., None], 3, axis=-1)
                self.pairs.append(
                    (left[i], right[i], c) if want_color
                    else (left[i], right[i]))
        elif os.path.isdir(path):
            lefts = sorted(glob.glob(os.path.join(path, "left*")))
            for lf in lefts:
                rf = lf.replace("left", "right")
                if os.path.exists(rf):
                    if want_color:
                        self.pairs.append((_imread_gray(lf),
                                           _imread_gray(rf),
                                           _imread_bgr(lf)))
                    else:
                        self.pairs.append(
                            (_imread_gray(lf), _imread_gray(rf)))
        else:
            raise ValueError(f"unsupported replay source: {path}")
        if not self.pairs:
            raise ValueError(f"no stereo pairs found in {path}")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        while True:
            for p in self.pairs:
                yield p
            if not self.loop:
                return

    def __len__(self):
        return len(self.pairs)


def smooth_noise(rng, H, W, sigma_px: float, amp: float) -> np.ndarray:
    """Band-limited noise via Fourier low-pass (no scipy dependency)."""
    n = rng.standard_normal((H, W))
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    filt = np.exp(-((fx ** 2 + fy ** 2) * (2 * np.pi * sigma_px) ** 2) / 2)
    s = np.fft.ifft2(np.fft.fft2(n) * filt).real
    s = (s - s.mean()) / (s.std() + 1e-9)
    return s * amp


def make_scene(rng, H, W, d_base: float, seed_kind: str):
    """Synthetic scene: world texture + smooth disparity field (+ boxes).
    Returns (left, right, disparity); the golden fixtures' generator
    (tools/make_golden_fixtures.py) draws the same scene from the same
    generator state."""
    # fine but band-limited texture so Sobel gradients are informative
    pad = 320
    tex = smooth_noise(rng, H, W + pad, 1.5, 60.0) + \
        smooth_noise(rng, H, W + pad, 6.0, 40.0) + 128.0
    tex = np.clip(tex, 0, 255)

    d = np.full((H, W), d_base, dtype=np.float64)
    d += smooth_noise(rng, H, W, 30.0, 3.0)
    # vertical slant (like a ground plane receding upward)
    d += np.linspace(6, -6, H)[:, None]
    if seed_kind == "boxes":
        for _ in range(4):
            bw = rng.integers(30, 80)
            bh = rng.integers(25, 60)
            y0 = rng.integers(0, H - bh)
            x0 = rng.integers(0, W - bw)
            d[y0:y0 + bh, x0:x0 + bw] = d_base + rng.uniform(15, 45)
    d = np.clip(d, 2.0, 120.0)

    # left[v,u] = W(v, u-d); right[v,u] = W(v,u)  (left pixel u matches
    # right pixel u-d). Offset world coords by pad so indices stay positive.
    u = np.arange(W)[None, :] + pad
    src = u - d
    i0 = np.floor(src).astype(int)
    fr = src - i0
    vi = np.arange(H)[:, None]
    left = tex[vi, i0] * (1 - fr) + tex[vi, i0 + 1] * fr
    right = tex[:, pad:pad + W]
    return (np.clip(left, 0, 255).astype(np.uint8),
            np.clip(right, 0, 255).astype(np.uint8),
            d)


def synthetic_stream(
    n_frames: int, height: int = 360, width: int = 640,
    d_base: float = 30.0, seed: int = 0, want_color: bool = False,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Deterministic synthetic stereo stream (bench/test input). The
    synthetic scene is grayscale; want_color replicates the left frame
    into BGR so the gen-pcl RGB packing path is exercised end to end."""
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        left, right, _ = make_scene(rng, height, width, d_base, "boxes")
        if want_color:
            yield left, right, np.repeat(left[..., None], 3, axis=-1)
        else:
            yield left, right
