"""Device choice for the port's entry points: the card unless asked.

Entry points take ``device=None`` and run on ``cuda``. With no card they
raise; they never move to the CPU on their own. The tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

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
