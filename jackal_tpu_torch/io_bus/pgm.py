"""PGM image IO (image.h parity: loadPGM/savePGM, image.h:129-165).

The reference bundles a templated PGM loader with libelas; here it is two
plain numpy functions (P5 binary and P2 ascii, 8- and 16-bit)."""
from __future__ import annotations

import re

import numpy as np


def load_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, whitespace/comments, width, height, maxval
    tokens = []
    pos = 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[pos:])
        if m is None:
            raise ValueError(f"bad PGM header in {path}")
        tok = m.group(1)
        pos += m.end()
        if not tok.startswith(b"#"):
            tokens.append(tok)
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), \
        int(tokens[3])
    if magic == b"P5":
        dt = np.dtype(">u2") if maxval > 255 else np.uint8
        # exactly one whitespace byte separates the header from the raster
        arr = np.frombuffer(data, dt, count=w * h, offset=pos + 1)
        return arr.reshape(h, w).astype(
            np.uint16 if maxval > 255 else np.uint8)
    if magic == b"P2":
        vals = [int(t) for t in data[pos:].split()]
        return np.array(vals, dtype=np.uint16 if maxval > 255
                        else np.uint8).reshape(h, w)
    raise ValueError(f"unsupported PGM magic {magic!r} in {path}")


def save_pgm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        maxval, out = 255, img
    else:
        maxval, out = 65535, img.astype(">u2")
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n{maxval}\n".encode())
        f.write(out.tobytes())
