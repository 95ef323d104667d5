"""Stereo calibration loading (OpenCV-YAML format).

Parses the reference's calibration artifact
(the amrl_jackal_webcam_stereo.yml of the reference stack, consumed at
point_cloud.cpp:530-538) without depending on OpenCV: the `%YAML:1.0` header
and `!!opencv-matrix` tags are normalized and parsed with a small hand-rolled
reader so the framework stays standalone.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class StereoCalibration:
    """Calibration consumed by the perception pipeline.

    K1,K2: 3x3 intrinsics; D1,D2: distortion (radial-tangential, up to 5 or 8
    coeffs); R,T: left->right extrinsics; XR,XT: camera->robot extrinsics.
    """

    K1: np.ndarray
    K2: np.ndarray
    D1: np.ndarray
    D2: np.ndarray
    R: np.ndarray
    T: np.ndarray
    XR: Optional[np.ndarray] = None
    XT: Optional[np.ndarray] = None
    # Optional precomputed rectification (confidence_checks.cpp:248-252 reads
    # these from the YAML when present).
    R1: Optional[np.ndarray] = None
    R2: Optional[np.ndarray] = None
    P1: Optional[np.ndarray] = None
    P2: Optional[np.ndarray] = None
    Q: Optional[np.ndarray] = None

    def __post_init__(self):
        self.K1 = np.asarray(self.K1, dtype=np.float64).reshape(3, 3)
        self.K2 = np.asarray(self.K2, dtype=np.float64).reshape(3, 3)
        self.D1 = np.asarray(self.D1, dtype=np.float64).reshape(-1)
        self.D2 = np.asarray(self.D2, dtype=np.float64).reshape(-1)
        self.R = np.asarray(self.R, dtype=np.float64).reshape(3, 3)
        self.T = np.asarray(self.T, dtype=np.float64).reshape(3)
        if self.XR is not None:
            self.XR = np.asarray(self.XR, dtype=np.float64).reshape(3, 3)
        if self.XT is not None:
            self.XT = np.asarray(self.XT, dtype=np.float64).reshape(3)


_NUM_RE = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _parse_opencv_yaml(text: str) -> Dict[str, np.ndarray]:
    """Minimal parser for OpenCV FileStorage YAML holding matrices/sequences.

    Handles entries of the form::

        K1: !!opencv-matrix
           rows: 3
           cols: 3
           dt: d
           data: [ ... ]
        T: [ v1, v2, v3 ]
    """
    # Strip the OpenCV YAML directive and matrix tags.
    entries: Dict[str, np.ndarray] = {}
    # Tokenize into top-level "name:" blocks.
    block_re = re.compile(r"^(\w+):", re.M)
    matches = list(block_re.finditer(text))
    for i, m in enumerate(matches):
        name = m.group(1)
        end = matches[i + 1].start() if i + 1 < len(matches) else len(text)
        body = text[m.end():end]
        if "opencv-matrix" in body:
            rows_m = re.search(r"rows:\s*(\d+)", body)
            cols_m = re.search(r"cols:\s*(\d+)", body)
            data_m = re.search(r"data:\s*\[(.*?)\]", body, re.S)
            if not (rows_m and cols_m and data_m):
                continue
            vals = [float(x) for x in _NUM_RE.findall(data_m.group(1))]
            arr = np.array(vals, dtype=np.float64).reshape(
                int(rows_m.group(1)), int(cols_m.group(1))
            )
            entries[name] = arr
        else:
            seq_m = re.search(r"\[(.*?)\]", body, re.S)
            if seq_m:
                vals = [float(x) for x in _NUM_RE.findall(seq_m.group(1))]
                entries[name] = np.array(vals, dtype=np.float64)
    return entries


def load_calibration(path: str) -> StereoCalibration:
    """Load an OpenCV-style stereo calibration YAML (point_cloud.cpp:530-538)."""
    with open(path) as f:
        text = f.read()
    d = _parse_opencv_yaml(text)
    required = ["K1", "K2", "D1", "D2", "R", "T"]
    missing = [k for k in required if k not in d]
    if missing:
        raise ValueError(f"calibration file {path} missing entries: {missing}")
    return StereoCalibration(
        K1=d["K1"], K2=d["K2"], D1=d["D1"], D2=d["D2"], R=d["R"], T=d["T"],
        XR=d.get("XR"), XT=d.get("XT"),
        R1=d.get("R1"), R2=d.get("R2"), P1=d.get("P1"), P2=d.get("P2"),
        Q=d.get("Q"),
    )


def save_calibration(path: str, calib: StereoCalibration) -> None:
    """Write calibration in OpenCV FileStorage YAML format (round-trips with
    load_calibration and with cv2.FileStorage)."""

    def mat(name: str, a: np.ndarray) -> str:
        a = np.asarray(a, dtype=np.float64)
        if a.ndim == 1:
            a = a.reshape(-1, 1) if name == "XT" else a.reshape(1, -1)
        data = ", ".join(repr(float(x)) for x in a.ravel())
        return (
            f"{name}: !!opencv-matrix\n   rows: {a.shape[0]}\n"
            f"   cols: {a.shape[1]}\n   dt: d\n   data: [ {data} ]\n"
        )

    parts = ["%YAML:1.0\n---\n"]
    parts.append(mat("K1", calib.K1))
    parts.append(mat("K2", calib.K2))
    parts.append(mat("D1", calib.D1))
    parts.append(mat("D2", calib.D2))
    parts.append(mat("R", calib.R))
    parts.append(mat("T", calib.T.reshape(3, 1)))
    for name in ["XR", "XT", "R1", "R2", "P1", "P2", "Q"]:
        v = getattr(calib, name)
        if v is not None:
            parts.append(mat(name, v))
    with open(path, "w") as f:
        f.write("".join(parts))
