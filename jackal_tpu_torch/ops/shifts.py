"""Per-pixel row lookups with a bounded shift.

``out[..., v, u] = arr[..., v, u + sign*s[..., v, u]]`` with ``fill`` where
the lookup leaves the row. The reference package sweeps the shift range
with a select per shift, a workaround for slow gathers on its hardware; a
``torch.gather`` of the row is the idiom here, with the same contract.
"""
from __future__ import annotations

import torch


def shifted_row_lookup(arr: torch.Tensor, s: torch.Tensor, smax: int,
                       sign: int = -1, fill: float = -1e9) -> torch.Tensor:
    """out[..., v, u] = arr[..., v, u + sign*s[..., v, u]].

    s: integer in [0, smax]; a shift outside that range, or a lookup
    outside [0, W), returns ``fill`` (callers mask them). arr and s
    broadcast against each other ([H, W] or batched [..., H, W])."""
    arr, s = torch.broadcast_tensors(arr, s)
    W = arr.shape[-1]
    idx = torch.arange(W, device=arr.device) + sign * s.to(torch.int64)
    ok = (s >= 0) & (s <= smax) & (idx >= 0) & (idx < W)
    got = torch.gather(arr.contiguous(), -1, idx.clamp(0, W - 1))
    return torch.where(ok, got, torch.full((), fill, dtype=arr.dtype,
                                           device=arr.device))
