"""Host <-> device copies that block only what needs their data.

On the card a plain ``.cpu()`` or a copy from pageable memory runs on the
default stream and waits for all work queued before it. The batched path
keeps several batches in flight, so its copies go through pinned memory
without blocking: a download records an event that only its reader waits
for, and an upload may run on a side stream whose event the consumer's
stream waits for. Each copy and event is made with its tensor's card
current, so any thread may copy to and from any card. On the CPU these
are plain tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class HostCopy:
    """A device -> host copy of ``t`` started now; numpy() waits for it."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.device(t.device):
                self.host.copy_(t, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def to_device(arr: np.ndarray, dev: torch.device,
              stream: Optional["torch.cuda.Stream"] = None
              ) -> Tuple[torch.Tensor, Optional["torch.cuda.Event"]]:
    """Host -> device copy of ``arr``: (tensor, event or None). On the card
    the copy leaves pinned memory without blocking the host; on ``stream``
    when one is given, and then ready() must see the event before use."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cuda":
        return t.to(dev), None
    t = t.pin_memory()
    with torch.cuda.device(dev):
        if stream is None:
            return t.to(dev, non_blocking=True), None
        with torch.cuda.stream(stream):
            out = t.to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
    return out, ev


def ready(t: torch.Tensor, event) -> torch.Tensor:
    """Make the current stream wait for ``t``'s upload event."""
    if event is not None:
        cur = torch.cuda.current_stream(t.device)
        cur.wait_event(event)
        t.record_stream(cur)
    return t
