"""The rest of libelas's filter kernels (filter.cpp:418-467) in PyTorch
integer ops.

The ELAS pipeline uses only sobel3x3 (ops/descriptor.py); these are the
rest of the reference's filter surface: sobel5x5, checkerboard5x5,
blob5x5 and the integral image they build on. Each takes a uint8 [H, W]
image and returns tensors on ``device``: a tensor stays on its own device
unless one is named, a numpy image goes to the card unless
``device="cpu"``.

Numeric contracts of the SSE code, as the reference package keeps them:

  - sobel5x5 (filter.cpp:418-426): column pass [1,4,6,4,1] (smooth) /
    [1,2,0,-2,-1] (diff), then row pass [1,2,0,-2,-1] (du) /
    [1,4,6,4,1] (dv), arithmetic >> 7, + 128, uint8 saturation: the
    bias-128 gradient encoding of sobel3x3 (filter.cpp:78, 88).
  - checkerboard5x5 (filter.cpp:433-438): [1,1,0,-1,-1] columns, then
    rows; raw int16 (no scale, no offset).
  - blob5x5 (filter.cpp:445-467): -1 outer ring, +1 inner ring, +8
    centre, evaluated as -(5x5 sum) + 2 * (3x3 sum) + 7 * centre from the
    integral image; int16 truncation of the int32 result.

The SSE row passes walk the image as one flat buffer, so each row's first
two outputs read the previous row's tail (row wrap), as createGrid's flat
diffusion does (elas.cpp:631). The reference leaves borders uninitialized
(malloc); here, as in the reference package, they are 128 for the uint8
outputs and 0 for the int16 ones, and the last flat window's reads past
the buffer are zeros.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, as_input

i32 = torch.int32


def integral_image(img_u8, device: DeviceLike = None) -> torch.Tensor:
    """Inclusive 2D integral image, int32 (filter.cpp:48-65)."""
    x = as_input(img_u8, device).to(i32)
    return torch.cumsum(torch.cumsum(x, 0, dtype=i32), 1, dtype=i32)


def _flat_row_conv(temp: torch.Tensor, taps) -> torch.Tensor:
    """out[j + 2] = sum_k taps[k] * temp_flat[j + k] over the flat buffer
    (row wrap), reads past the end 0; out[0:2] = 0. Flat int32."""
    flat = temp.reshape(-1)
    n = flat.shape[0]
    fp = F.pad(flat, (0, 4))
    acc = torch.zeros(n - 2, dtype=i32, device=flat.device)
    for k, t in enumerate(taps):
        if t:
            acc = acc + t * fp[k:k + n - 2]
    return F.pad(acc, (2, 0))


def _col_conv(img: torch.Tensor, taps) -> torch.Tensor:
    """int32 column convolution into rows [2, H - 2), as the SSE column
    passes write them (output row = window start + 2); other rows 0."""
    H = img.shape[0]
    x = img.to(i32)
    m = H - len(taps) + 1
    acc = torch.zeros((m, img.shape[1]), dtype=i32, device=img.device)
    for k, t in enumerate(taps):
        if t:
            acc = acc + t * x[k:k + m]
    return F.pad(acc, (0, 0, 2, H - m - 2))


def _unwritten(H: int, W: int, dev) -> torch.Tensor:
    """The pixels the SSE passes leave unwritten: rows 0, 1, H-2, H-1 and
    the flat buffer's first two entries."""
    rows = torch.arange(H, device=dev)
    mask = ((rows < 2) | (rows >= H - 2))[:, None].expand(H, W).clone()
    mask.view(-1)[:2] = True
    return mask


def _sat_u8_biased(flat: torch.Tensor, shape) -> torch.Tensor:
    return torch.clamp((flat >> 7) + 128, 0, 255).to(torch.uint8
                                                      ).reshape(shape)


def sobel5x5(img_u8, device: DeviceLike = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bias-128 uint8 5x5 Sobel gradients (du, dv), each [H, W]: du the
    [1,2,0,-2,-1] rows of the [1,4,6,4,1]-smoothed columns, dv the
    [1,4,6,4,1] rows of the [1,2,0,-2,-1]-differenced columns, >> 7, +
    128, saturated (filter.cpp:418-426, 95-199)."""
    img = as_input(img_u8, device)
    H, W = img.shape
    du = _sat_u8_biased(_flat_row_conv(_col_conv(img, (1, 4, 6, 4, 1)),
                                       (1, 2, 0, -2, -1)), (H, W))
    dv = _sat_u8_biased(_flat_row_conv(_col_conv(img, (1, 2, 0, -2, -1)),
                                       (1, 4, 6, 4, 1)), (H, W))
    mask = _unwritten(H, W, img.device)
    bias = torch.full((), 128, dtype=torch.uint8, device=img.device)
    return torch.where(mask, bias, du), torch.where(mask, bias, dv)


def checkerboard5x5(img_u8, device: DeviceLike = None) -> torch.Tensor:
    """int16 checkerboard response (filter.cpp:428-438): [1,1,0,-1,-1]
    columns, then rows; raw."""
    img = as_input(img_u8, device)
    H, W = img.shape
    out = _flat_row_conv(_col_conv(img, (1, 1, 0, -1, -1)),
                         (1, 1, 0, -1, -1)).reshape(H, W)
    return torch.where(_unwritten(H, W, img.device), 0, out).to(torch.int16)


def blob5x5(img_u8, device: DeviceLike = None) -> torch.Tensor:
    """int16 blob response (filter.cpp:440-467): -1 outer ring, +1 inner
    ring, +8 centre from integral-image box sums along the flat buffer."""
    img = as_input(img_u8, device)
    H, W = img.shape
    I = integral_image(img).reshape(-1)
    x = img.to(i32).reshape(-1)
    n = H * W
    start, stop = 3 + 3 * W, n - 2 - 2 * W
    m = stop - start
    # the integral reads relative to the output at start + j: I[j],
    # I[j + 5], I[j + 5W], I[j + 5 + 5W]; I[j + 1 + W], I[j + 4 + W],
    # I[j + 1 + 4W], I[j + 4 + 4W]
    outer = -(I[5 + 5 * W:][:m] - I[5:][:m] - I[5 * W:][:m] + I[:m])
    inner = 2 * (I[4 + 4 * W:][:m] - I[4 + W:][:m]
                 - I[1 + 4 * W:][:m] + I[1 + W:][:m])
    res = outer + inner + 7 * x[start:stop]
    return F.pad(res, (start, n - stop)).reshape(H, W).to(torch.int16)
