"""float32 -> int32 with the reference's rule on every device.

XLA converts a float to int32 by truncating toward zero and saturating:
values at or above 2^31 give INT32_MAX, values below -2^31 give INT32_MIN,
and NaN gives 0. PyTorch's ``.to(torch.int32)`` leaves out-of-range values
to the hardware: on x86 every one of them becomes INT32_MIN. The port
converts with ``to_int32`` wherever a float can leave the int32 range
(a near-singular plane fit gives plane values of 1e17), so both devices
give XLA's result. The raster kernel (csrc/raster_kernel.cu) applies the
same rule in its own ``sat_i32``.
"""
from __future__ import annotations

import torch

_TWO31 = 2147483648.0             # 2^31, exact in float32
_BELOW_TWO31 = 2147483520.0       # the largest float32 below 2^31


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Truncate float32 ``x`` toward zero into int32, saturating, NaN -> 0."""
    t = torch.nan_to_num(x, nan=0.0, posinf=_TWO31, neginf=-_TWO31)
    t = torch.clamp(t, -_TWO31, _BELOW_TWO31).to(torch.int32)
    return torch.where(x >= _TWO31, torch.iinfo(torch.int32).max, t)
