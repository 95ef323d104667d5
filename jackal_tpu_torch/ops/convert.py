"""float32 -> int32, and float32 subnormals, with the reference's rules on
every device.

XLA converts a float to int32 by truncating toward zero and saturating:
values at or above 2^31 give INT32_MAX, values below -2^31 give INT32_MIN,
and NaN gives 0. PyTorch's ``.to(torch.int32)`` leaves out-of-range values
to the hardware: on x86 every one of them becomes INT32_MIN. The port
converts with ``to_int32`` wherever a float can leave the int32 range
(a near-singular plane fit gives plane values of 1e17), so both devices
give XLA's result. The raster kernel (csrc/raster_kernel.cu) applies the
same rule in its own ``sat_i32``.

XLA:CPU runs its programs with denormals-are-zero and flush-to-zero set:
a float32 subnormal operand reads as a zero of its sign, and a result
that would be subnormal is one. PyTorch keeps IEEE subnormals on both
devices; ``ftz`` applies XLA's rule where the port must compute what the
jitted reference computes (the scan, scan/obstacle.py; the scan kernels do
the same in their own ``ftz``).

The node publishes its disparity as u8, ``clip(round(d), 0, 255)`` with
half to even (``jnp.round`` and ``torch.round`` both): ``dmap_u8``, which
kernels O2 and S compute with ``rintf``.
"""
from __future__ import annotations

import torch

_TWO31 = 2147483648.0             # 2^31, exact in float32
_BELOW_TWO31 = 2147483520.0       # the largest float32 below 2^31
FLT_MIN = 2.0 ** -126             # the least normal float32


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Truncate float32 ``x`` toward zero into int32, saturating, NaN -> 0."""
    t = torch.nan_to_num(x, nan=0.0, posinf=_TWO31, neginf=-_TWO31)
    t = torch.clamp(t, -_TWO31, _BELOW_TWO31).to(torch.int32)
    return torch.where(x >= _TWO31, torch.iinfo(torch.int32).max, t)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with each subnormal made a zero of its sign (NaN and
    infinities kept)."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def dmap_u8(d: torch.Tensor) -> torch.Tensor:
    """The published mono8 disparity of float32 ``d``: round half to even,
    clip to [0, 255]."""
    return torch.clamp(torch.round(d), 0, 255).to(torch.uint8)
