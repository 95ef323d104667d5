"""Sparse feature matching experiment (disparity_map.cpp's counterpart).

The reference's offline experiment (disparity_map.cpp:51-117, commented out
of its build) detects ORB keypoints, kNN-matches binary descriptors with a
FLANN LSH index and keeps matches that pass an NNDR 0.9 ratio test. As in
the reference package: Harris corners with local non-maximum suppression,
BRIEF-like 256-bit descriptors, and brute-force 2-NN Hamming matching as
one XOR-popcount matrix, all as batched tensor ops on the image's device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..matching.sgm import _popcount


def _edge_cols(n: int, pad: int, dev) -> torch.Tensor:
    """Indices of an edge-padded axis of length n + 2 * pad."""
    return torch.clamp(torch.arange(-pad, n + pad, device=dev), 0, n - 1)


def harris_corners(img_u8: torch.Tensor, max_corners: int = 500,
                   k: float = 0.04, nms_radius: int = 7
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Harris response and its top max_corners after local non-maximum
    suppression: (uv [K, 2] int32, score [K] float32), score <= 0 for
    the padding entries. Every float32 op is its own eager op, in the
    reference's order (25 adds from 0, then / 25; det - (k * tr) * tr).
    Ties in the score keep the lower flat index first, as lax.top_k
    does."""
    x = img_u8.to(torch.float32)
    H, W = x.shape
    dev = x.device
    xc = x[:, _edge_cols(W, 1, dev)]
    xr = x[_edge_cols(H, 1, dev)]
    gx = xc[:, 2:] - xc[:, :-2]
    gy = xr[2:] - xr[:-2]

    def blur(a):
        a = a[_edge_cols(H, 2, dev)][:, _edge_cols(W, 2, dev)]
        out = torch.zeros_like(x)
        for dv in range(5):
            for du in range(5):
                out = out + a[dv:dv + H, du:du + W]
        return out / 25.0

    sxx, syy, sxy = blur(gx * gx), blur(gy * gy), blur(gx * gy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    r = det - torch.full((), k, dtype=torch.float32, device=dev) * tr * tr
    R = nms_radius
    p = torch.nn.functional.pad(r, (R, R, R, R), value=-float("inf"))
    mx = r
    for dv in range(-R, R + 1):
        for du in range(-R, R + 1):
            mx = torch.maximum(mx, p[R + dv:R + dv + H, R + du:R + du + W])
    keep = (r >= mx) & (r > 0)
    score = torch.where(keep, r, -1.0).reshape(-1)
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:max_corners], idx[:max_corners]
    uv = torch.stack([idx % W, idx // W], dim=-1)
    return uv.to(torch.int32), vals


# the pseudo-random BRIEF sampling pattern (fixed seed, 256 bits)
_BRIEF_RNG = np.random.RandomState(7)
_BRIEF_A = _BRIEF_RNG.randint(-12, 13, size=(256, 2)).astype(np.int32)
_BRIEF_B = _BRIEF_RNG.randint(-12, 13, size=(256, 2)).astype(np.int32)


def brief_descriptors(img_u8: torch.Tensor, uv: torch.Tensor
                      ) -> torch.Tensor:
    """256-bit binary descriptors of the points uv [K, 2], packed as
    [K, 8] int32: bit i of word w is pixel a < pixel b of pair 32 w + i
    (so bit 31 makes a word negative, as the reference's int32 sum
    wraps)."""
    H, W = img_u8.shape
    dev = img_u8.device
    img = img_u8.to(torch.int32)[_edge_cols(H, 16, dev)][
        :, _edge_cols(W, 16, dev)]
    u = uv[:, 0:1].to(torch.int64) + 16
    v = uv[:, 1:2].to(torch.int64) + 16
    A = torch.from_numpy(_BRIEF_A).to(dev)
    B = torch.from_numpy(_BRIEF_B).to(dev)
    pa = img[v + A[:, 1], u + A[:, 0]]                       # [K, 256]
    pb = img[v + B[:, 1], u + B[:, 0]]
    words = (pa < pb).to(torch.int32).reshape(-1, 8, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    return (words << shifts).sum(-1, dtype=torch.int32)


def knn_hamming_match(desc1: torch.Tensor, desc2: torch.Tensor,
                      valid1: torch.Tensor, valid2: torch.Tensor,
                      nndr: float = 0.9
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force 2-NN Hamming matching with the NNDR ratio test
    (disparity_map.cpp:96-108): (match_idx [N] int32, the first nearest
    desc2 index; ok [N] bool)."""
    dist = _popcount(desc1[:, None, :] ^ desc2[None, :, :]).sum(
        -1, dtype=torch.int32)                               # [N, M]
    big = 1 << 20
    dist = torch.where(valid2[None, :], dist, big)
    best = dist.argmin(1)
    d1 = dist.amin(1)
    hit = torch.arange(dist.shape[1], device=dist.device)[None] == best[:, None]
    d2 = torch.where(hit, big, dist).amin(1)
    ratio = torch.full((), nndr, dtype=torch.float32, device=dist.device)
    ok = valid1 & (d1.to(torch.float32) <= ratio * d2.to(torch.float32)) \
        & (d2 < big)
    return best.to(torch.int32), ok


def match_features(left_u8, right_u8, max_corners: int = 500,
                   nndr: float = 0.9, device: DeviceLike = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The whole experiment on ``device`` (the card unless "cpu"):
    corners, descriptors and ratio-tested matches of a uint8 [H, W] pair.
    Returns the matched pixel coordinates (pts_left [K, 2], pts_right
    [K, 2]) on the host."""
    dev = resolve_device(device)
    l = torch.as_tensor(left_u8).to(dev)
    r = torch.as_tensor(right_u8).to(dev)
    uv1, s1 = harris_corners(l, max_corners)
    uv2, s2 = harris_corners(r, max_corners)
    idx, ok = knn_hamming_match(brief_descriptors(l, uv1),
                                brief_descriptors(r, uv2), s1 > 0, s2 > 0,
                                nndr)
    okn = ok.cpu().numpy()
    return (uv1.cpu().numpy()[okn],
            uv2.cpu().numpy()[idx.cpu().numpy()[okn]])
