"""Device choice for the port's entry points: the card unless asked.

Entry points take ``device=None`` and run on ``cuda``. With no card they
raise; they never move to the CPU on their own. The tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "jackal_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def as_input(x, device: DeviceLike = None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` when one is named; else a tensor
    keeps its own device and a host array goes to the card (with none,
    resolve_device's error)."""
    if device is None and isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x).to(resolve_device(device))


def device_list(devices: Optional[Sequence[DeviceLike]] = None
                ) -> List[torch.device]:
    """Devices for the multi-device paths: each of ``devices`` with its
    card index explicit (so "cuda" and "cuda:0" name one device), or by
    default every visible card; with none, resolve_device's error."""
    if devices is None:
        resolve_device(None)
        devices = range(torch.cuda.device_count())
    out = []
    for d in devices:
        dev = torch.device("cuda", d) if isinstance(d, int) else \
            torch.device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return out
