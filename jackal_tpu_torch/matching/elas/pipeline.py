"""ELAS per-frame matching (Elas::process, elas.cpp:32-151) on the card.

Stage by stage:

  1. descriptors                    device (ops/descriptor.py)
  2. support search                 device, CUDA kernel (support.py)
  3. pruning, exact Delaunay,       host, C++ (native_prior.py)
     plane fit, raster, grids
  4. dense MAP matching, both views device, CUDA kernel (dense.py)
  5. L/R check                      device (post.py)
  6. speckle filter                 host, C++ BFS (native_prior.py)
  7. gap fill, adaptive mean,       device (post.py)
     median

The frame crosses to the host twice: the int16 candidate grid before
stage 3, and the int16 left (and, when both views are postprocessed, right)
disparity before stage 6. Every stage is bit-equal to the reference build,
so D1/D2 equal libelas's.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ...config import ElasParams
from ...device import DeviceLike, resolve_device
from ...ops.descriptor import create_descriptor
from .dense import dense_match, pack_grid
from .native_prior import (build_priors_native, collect_support_points_native,
                           remove_small_segments_native)
from .post import left_right_consistency_check, post_tail
from .support import support_candidates

Image = Union[np.ndarray, torch.Tensor]


def _speckle(D: torch.Tensor, params: ElasParams) -> torch.Tensor:
    """Native BFS speckle filter; disparities are integers here, so the
    int16 round trip is exact."""
    Dh = D.to(torch.int16).cpu().numpy().astype(np.float32)
    out = remove_small_segments_native(Dh, params).astype(np.int16)
    return torch.from_numpy(out).to(D.device).to(torch.float32)


def elas_match(
    left_u8: Image,
    right_u8: Image,
    params: ElasParams = ElasParams(),
    tri_left: Optional[np.ndarray] = None,
    tri_right: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense stereo: two uint8 [H, W] images -> two float32 [H, W]
    disparity maps on ``device`` (the card unless ``device="cpu"``).

    Invalid pixels are negative (-1 / -10), matching libelas encodings.
    tri_left/tri_right override the Delaunay triangulation (tests)."""
    if params.subsampling:
        raise NotImplementedError(
            "ELAS subsampling waits for a later slice of the port "
            "(ROADMAP Queue 1, item 6)")
    if tuple(left_u8.shape) != tuple(right_u8.shape):
        raise ValueError(
            f"left/right shape mismatch: {left_u8.shape} vs {right_u8.shape}")
    dev = resolve_device(device)
    H, W = left_u8.shape
    imgs = torch.stack([torch.as_tensor(left_u8), torch.as_tensor(right_u8)])
    desc = create_descriptor(imgs.to(dev))                # [2, H, W, 16]
    desc1, desc2 = desc[0:1], desc[1:2]

    dcan = support_candidates(desc1, desc2, params)[0].cpu().numpy()
    support = collect_support_points_native(dcan, params, W, H)
    if len(support) < 3:
        bad = torch.full((H, W), -10.0, device=dev)
        return bad, bad.clone()
    maps1, maps2, grid1, grid2 = build_priors_native(
        support, W, H, params, tri_left=tri_left, tri_right=tri_right)

    def upload(maps, grid):
        host = (maps.d_plane, maps.valid, maps.tri_id >= 0, pack_grid(grid))
        return [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
                for a in host]

    D1 = dense_match(desc1, desc2, *upload(maps1, grid1), params, False)[0]
    D2 = dense_match(desc1, desc2, *upload(maps2, grid2), params, True)[0]

    D1, D2 = left_right_consistency_check(D1, D2, params)
    D1 = _speckle(D1, params)
    if not params.postprocess_only_left:
        D2 = _speckle(D2, params)
    return post_tail(D1, D2, params)
