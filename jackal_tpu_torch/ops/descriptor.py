"""ELAS Sobel descriptor in PyTorch integer ops.

Reproduces the reference's uint8 gradient encoding and 16-byte per-pixel
feature exactly on the interior (the SSE code leaves image borders
uninitialized; they are defined deterministically):

  - filter::sobel3x3 (filter.cpp:408-416): column pass [1,2,1]/[1,0,-1],
    row pass with arithmetic >>2, +128 offset, uint8 saturation.
    Gradient sign convention: du(u) ~ smooth_v(u-1) - smooth_v(u+1).
  - Descriptor::createDescriptor (descriptor.cpp:42-114): 16 samples from a
    5x5 neighborhood of (du, dv) — 12 from du (center duplicated), 4 from dv.

Valid region: u in [3, W-4], v in [3, H-4] (descriptor.cpp:84,92); outside
is 0, the reference's fresh-page contents.

create_descriptor is a wrapper: on a CUDA tensor it launches kernel R
(csrc/descriptor_kernel.cu, one launch for all frames), on a CPU tensor it
runs the plain version, create_descriptor_plain, which the kernel equals
bit for bit (integer arithmetic only). create_descriptor_pair does both
views in one launch, each read where it lies (the nodes' entry).
``launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib

launches = 0

# (dy, dx, use_dv) sample offsets, in reference channel order
# (descriptor.cpp:94-109)
DESC_OFFSETS = (
    (-2, 0, 0),
    (-1, -2, 0),
    (-1, 0, 0),
    (-1, 2, 0),
    (0, -1, 0),
    (0, 0, 0),
    (0, 0, 0),
    (0, 1, 0),
    (1, -2, 0),
    (1, 0, 0),
    (1, 2, 0),
    (2, 0, 0),
    (-1, 0, 1),
    (0, -1, 1),
    (0, 1, 1),
    (1, 0, 1),
)


def _sat_u8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255).to(torch.uint8)


def sobel3x3(img_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bias-128 uint8 Sobel gradients (du, dv), each [..., H, W].

    Interior exact vs filter::sobel3x3; 1-px border fixed to 128."""
    im = img_u8.to(torch.int32)
    # column pass (convolve_cols_3x3): smooth [1,2,1] and diff [1,0,-1]
    tv = im[..., :-2, :] + 2 * im[..., 1:-1, :] + im[..., 2:, :]
    th = im[..., :-2, :] - im[..., 2:, :]
    # row pass: du = (tv[u-1]-tv[u+1])>>2 + 128 ; dv = (th[u-1]+2th[u]+th[u+1])>>2 + 128
    du_i = ((tv[..., :-2] - tv[..., 2:]) >> 2) + 128
    dv_i = ((th[..., :-2] + 2 * th[..., 1:-1] + th[..., 2:]) >> 2) + 128
    du = F.pad(_sat_u8(du_i), (1, 1, 1, 1), value=128)
    dv = F.pad(_sat_u8(dv_i), (1, 1, 1, 1), value=128)
    return du, dv


def create_descriptor_plain(img_u8: torch.Tensor,
                            half_resolution: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the 16-channel uint8
    descriptor [..., H, W, 16] of u8 images [..., H, W].

    half_resolution=True (the ELAS subsampling path, descriptor.cpp:48-78)
    keeps only even rows 4 <= v <= H-4 and columns 3 <= u <= W-4; every
    other pixel is 0, the reference's fresh-page contents."""
    du, dv = sobel3x3(img_u8)
    H, W = img_u8.shape[-2:]
    dup = F.pad(du, (2, 2, 2, 2), value=128)
    dvp = F.pad(dv, (2, 2, 2, 2), value=128)
    desc = torch.stack(
        [(dvp if use_dv else dup)[..., 2 + dy:2 + dy + H, 2 + dx:2 + dx + W]
         for dy, dx, use_dv in DESC_OFFSETS], dim=-1)
    out = torch.zeros_like(desc)
    if half_resolution:
        out[..., 4:H - 3:2, 3:W - 3, :] = desc[..., 4:H - 3:2, 3:W - 3, :]
    else:
        out[..., 3:H - 3, 3:W - 3, :] = desc[..., 3:H - 3, 3:W - 3, :]
    return out


def _fn():
    fn = cuda_lib.load("descriptor_kernel").elas_descriptor_pair
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(img_u8: torch.Tensor, name: str) -> None:
    if img_u8.dtype != torch.uint8 or img_u8.dim() < 2 \
            or not img_u8.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous uint8 "
                         f"[..., H, W] tensor, got {img_u8.dtype} "
                         f"{tuple(img_u8.shape)} (contiguous="
                         f"{img_u8.is_contiguous()})")


def _descriptor_cuda(left: torch.Tensor, right: torch.Tensor, pair: bool,
                     half_resolution: bool) -> torch.Tensor:
    """Kernel R, one launch: u8 [..., H, W, 16] of the frames of left, or
    with pair u8 [2, ..., H, W, 16] of the frames of left, then those of
    right (right may be left: the kernel only reads them)."""
    global launches
    H, W = left.shape[-2:]
    n1 = left.numel() // max(H * W, 1)
    N = 2 * n1 if pair else n1
    out_shape = (2,) * pair + tuple(left.shape) + (16,)
    out = torch.empty(out_shape, dtype=torch.uint8, device=left.device)
    if out.numel() == 0:
        return out
    if N > 65535 or -(-H // 8) > 65535:          # a block a frame and 8 rows
        raise ValueError(f"create_descriptor: the kernel takes up to 65535 "
                         f"frames of up to 524280 rows, got {N} of {H}")
    cuda_lib.launch(_fn(), "elas_descriptor", left, left.data_ptr(),
                    right.data_ptr(), out.data_ptr(), n1, N, H, W,
                    int(half_resolution))
    launches += 1
    return out


def create_descriptor(img_u8: torch.Tensor,
                      half_resolution: bool = False) -> torch.Tensor:
    """16-channel uint8 descriptor [..., H, W, 16] of u8 images [..., H, W]
    (create_descriptor_plain's function): kernel R, one launch for every
    frame, on a CUDA tensor; the plain version on a CPU tensor."""
    if not img_u8.is_cuda:
        return create_descriptor_plain(img_u8, half_resolution)
    _check(img_u8, "create_descriptor")
    return _descriptor_cuda(img_u8, img_u8, False, half_resolution)


def create_descriptor_pair(left_u8: torch.Tensor, right_u8: torch.Tensor,
                           half_resolution: bool = False) -> torch.Tensor:
    """The descriptors of both views, u8 [2, ..., H, W, 16] from two u8
    images (or batches) [..., H, W] of one shape: [0] the left's, [1] the
    right's, as create_descriptor of their stack. On CUDA tensors kernel R
    reads both where they lie (one launch, no copy; a view that is not
    contiguous is copied first); on CPU tensors the plain version."""
    if left_u8.shape != right_u8.shape:
        raise ValueError(f"create_descriptor_pair: the views differ in "
                         f"shape, {tuple(left_u8.shape)} and "
                         f"{tuple(right_u8.shape)}")
    if not left_u8.is_cuda:
        return create_descriptor_plain(torch.stack([left_u8, right_u8]),
                                       half_resolution)
    left_u8, right_u8 = left_u8.contiguous(), right_u8.contiguous()
    _check(left_u8, "create_descriptor_pair: left")
    _check(right_u8, "create_descriptor_pair: right")
    if right_u8.device != left_u8.device:
        raise ValueError(f"create_descriptor_pair: right is on "
                         f"{right_u8.device}, left on {left_u8.device}")
    return _descriptor_cuda(left_u8, right_u8, True, half_resolution)
