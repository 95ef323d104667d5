"""Scale-out over several devices: the mesh, the data-parallel step and
disparity-parallel block matching.

The counterpart of the reference package's parallel/mesh.py, which shards
over a jax.sharding mesh. One process drives every device, as JAX's single
controller does; there is no torch.distributed:

  - Mesh / make_mesh: a [n_data, n_disp] grid of torch devices with the
    axes ("data", "disp"). A device may stand in the grid several times
    (["cpu"] * 8, or one card eight times), the counterpart of XLA's
    virtual host devices.
  - dp_sharded_step: the fused BM or SGM step with the batch split over
    "data", a replica of the pipeline on each row's device, and the
    closest obstacle as a min over the shards.
  - bm_match_tp: BM with the disparity axis of its cost volume split over
    "disp"; the ranks combine by keyed min all-reduces (pmin), then the
    texture gate and the L/R check. Equal to matching.bm.bm_match. On a
    mesh of cards each rank launches kernel T1 (its box and partial WTA,
    ops/bm_tp_kernel.tp_partials), each data row kernel T2 (the combine
    and the L/R check, tp_combine) and kernel S (the gate); on a CPU mesh
    the reference's eager program runs (bm_match_tp_plain, which also
    runs it on cards, for comparison).

A collective takes one tensor per rank: pmin reduces on the axis's first
device and sends the result back to each rank's device. Nothing else
moves between devices: each shard's outputs stay on its row's first
device (gather puts them in one place for a caller that wants that). The
ranks of a "disp" row hold the same maps after the collectives, so the
row's tail (the WTA tail, the texture gate, the L/R check) runs once, on
its first device; a "disp" column of the data-parallel step likewise runs
its shard once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import BMParams
from ..device import DeviceLike, device_list
from ..matching.bm import (_BIG, bm_finalize, bm_texture_gate,
                           wta_disparity)
from ..ops import bm_tp_kernel as tpk

AXES = ("data", "disp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices[i][k]: the device of data row i and disparity rank k."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "disp": len(self.devices[0])}

    def rows(self) -> List[torch.device]:
        """Each data row's first device, where its shard runs."""
        return [row[0] for row in self.devices]


def make_mesh(n_devices: Optional[int] = None, disp_parallel: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A 2D mesh ("data", "disp") of the first n_devices of ``devices``
    (every visible card by default; with none, resolve_device's error).
    disp_parallel = 1 is pure data parallelism."""
    devs = device_list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or n % disp_parallel:
        raise ValueError(f"{n} devices not divisible by disp={disp_parallel}")
    return Mesh(tuple(tuple(devs[i:i + disp_parallel])
                      for i in range(0, n, disp_parallel)))


# ---------------------------------------------------------------------------
# collectives and shard outputs
# ---------------------------------------------------------------------------

def pmin(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce min of one tensor per rank: reduced on the first rank's
    device, the result sent back to each rank's device."""
    m = xs[0]
    for x in xs[1:]:
        m = torch.minimum(m, x.to(m.device))
    return [m.to(x.device) for x in xs]


def gather(shards: Sequence, device: DeviceLike = None):
    """Per-shard tensors, or dataclasses of tensors (ScanResult),
    concatenated in shard order on ``device`` (the first shard's)."""
    first = shards[0]
    if isinstance(first, torch.Tensor):
        dev = torch.device(device) if device is not None else first.device
        return torch.cat([s.to(dev) for s in shards])
    return type(first)(**{
        f.name: gather([getattr(s, f.name) for s in shards], device)
        for f in dataclasses.fields(first)})


# ---------------------------------------------------------------------------
# data parallelism over the fused step
# ---------------------------------------------------------------------------

def _follow_extrinsics(rep, pipeline) -> None:
    if rep is not pipeline and not (np.array_equal(rep.XR, pipeline.XR)
                                    and np.array_equal(rep.XT, pipeline.XT)):
        rep._set_extrinsics(pipeline.XR, pipeline.XT)


def replica(pipeline, device: DeviceLike):
    """The pipeline on ``device``: the pipeline itself when it lives there,
    else one built from its constructor arguments, with its current
    extrinsics."""
    from ..pipeline.frame_pipeline import StereoPipeline

    dev = device_list([device])[0]
    if dev == pipeline.device:
        return pipeline
    rep = StereoPipeline(pipeline.calib, pipeline.p, pipeline.engine,
                         pipeline.elas_params, pipeline.gp, pipeline.sp,
                         pipeline.sgm_params, dev, pipeline.bm_params)
    _follow_extrinsics(rep, pipeline)
    return rep


def dp_sharded_step(pipeline, mesh: Mesh):
    """The fused batched step of a BM or SGM pipeline with the batch split
    over "data" (each "disp" column replicates it). Returns

        step(left_b, right_b) -> (dmaps, scans, closest)

    for raw uint8 [B, H, W] batches, B a multiple of the data rows: dmaps
    a list of each row's u8 maps [B / n_data, h, w] and scans a list of
    its ScanResult, on the row's first device, in shard order (gather
    concatenates them); closest the least scan range of the whole batch,
    a 0-d tensor on the mesh's first device. Each distinct device holds
    one replica of the pipeline, which takes up the pipeline's extrinsics
    at every call, so update_extrinsics reaches every shard."""
    if pipeline.engine not in ("sgm", "bm"):
        raise ValueError("the fused batch path needs engine='sgm' or 'bm'")
    rows = mesh.rows()
    reps = {}
    for dev in rows:
        if dev not in reps:
            reps[dev] = replica(pipeline, dev)

    def step(left_b, right_b):
        left, right = torch.as_tensor(left_b), torch.as_tensor(right_b)
        B = left.shape[0]
        if B % len(rows):
            raise ValueError(f"batch {B} not divisible by the {len(rows)} "
                             f"rows of 'data'")
        Bs = B // len(rows)
        dmaps, scans = [], []
        for i, dev in enumerate(rows):
            rep = reps[dev]
            _follow_extrinsics(rep, pipeline)
            sl = slice(i * Bs, (i + 1) * Bs)
            dm, sc = rep.process_batch_fused(left[sl], right[sl])
            dmaps.append(dm)
            scans.append(sc)
        closest = torch.stack([s.scan.min().to(rows[0]) for s in scans]
                              ).min()
        return dmaps, scans, closest

    return step


# ---------------------------------------------------------------------------
# block matching with the disparity axis split over "disp"
# ---------------------------------------------------------------------------

def _at(local_d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """local_d [Dl] shaped to broadcast against a volume [Dl, ...]."""
    return local_d.view(-1, *([1] * (like.dim() - 1)))


def _tp_wta(costs: Sequence[torch.Tensor], local_d: Sequence[torch.Tensor],
            D: int, params: BMParams) -> torch.Tensor:
    """The WTA disparity of a volume whose d axis is split over ranks:
    costs[k] int32 [Dl, ..., H, W] and local_d[k] int32 [Dl] on rank k's
    device. Keyed pmins give the best d (ties to the smaller d); the best
    cost, the second best outside best_d +- 1 and the costs at best_d +- 1
    are read back from the volume by masked pmins (a d no rank holds reads
    the 1 << 24 sentinel), so they equal bm_match's. Returns float32
    [..., H, W] on the first rank's device, -1 where not unique."""
    kclamp = tpk.invalid_cost(D)
    best_key = pmin([(torch.clamp_max(c, kclamp) * D + _at(ld, c)).amin(0)
                     for c, ld in zip(costs, local_d)])
    best_d = [k % D for k in best_key]

    def masked(keep):
        return pmin([torch.where(keep(_at(ld, c), q), c, _BIG).amin(0)
                     for c, ld, q in zip(costs, local_d, best_d)])

    best_c = masked(lambda d, q: d == q)[0]
    second = masked(lambda d, q: (d - q).abs() > 1)[0]
    cm = masked(lambda d, q: d == q - 1)[0]
    cp = masked(lambda d, q: d == q + 1)[0]
    return wta_disparity(best_d[0], best_c, second, cm, cp, D, params)


def _bm_tp_shard_plain(left: torch.Tensor, right: torch.Tensor,
                       params: BMParams, devs: Sequence[torch.device]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One data row: uint8 [..., H, W] frames, the row's ranks ``devs``.
    Rank k scores d in [k * Dl, (k + 1) * Dl), Dl = D // ranks, on its
    device; the disparities from ranks * Dl to D - 1 (D % ranks of them)
    no rank scores, as in the reference. Both views' keyed WTA, then
    bm_finalize on the row's first device: the reference's program, one
    eager op at a time."""
    D = params.disp_num
    Dl = D // len(devs)
    costs, costs_r, local_d = [], [], []
    for k, dev in enumerate(devs):
        cl, cr = tpk.rank_costs(left.to(dev), right.to(dev), k * Dl, Dl, D,
                                params.window // 2)
        costs.append(cl)
        costs_r.append(cr)
        local_d.append(torch.arange(k * Dl, (k + 1) * Dl, dtype=torch.int32,
                                    device=dev))
    dL = _tp_wta(costs, local_d, D, params)
    dR = _tp_wta(costs_r, local_d, D, params)
    return bm_finalize(left.to(devs[0]), dL, dR, params)


def _bm_tp_shard_cuda(left: torch.Tensor, right: torch.Tensor,
                      params: BMParams, devs: Sequence[torch.device]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same on cards: T1 a rank, T2 and S on the row's first card."""
    D = params.disp_num
    Dl = D // len(devs)
    if Dl < 1:
        raise ValueError(f"D = {D} over {len(devs)} ranks leaves none a d")
    parts = tpk.rank_partials(left, right, D, params.window // 2, devs)
    dl, dr = tpk.tp_combine(parts, D, Dl, params)
    return bm_texture_gate(left.to(devs[0]), dl, params), dr


def _bm_tp_shard(left, right, params, devs):
    kinds = {dev.type == "cuda" for dev in devs}
    if kinds == {True}:
        return _bm_tp_shard_cuda(left, right, params, devs)
    if kinds == {False}:
        return _bm_tp_shard_plain(left, right, params, devs)
    raise ValueError(f"a row of 'disp' mixes cards and other devices: "
                     f"{list(devs)}")


def _tp_fn(mesh: Mesh, params: BMParams, shard):
    def fn(left_b, right_b):
        left, right = torch.as_tensor(left_b), torch.as_tensor(right_b)
        n = len(mesh.devices)
        B = left.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by the {n} rows of "
                             f"'data'")
        Bs = B // n
        outs = [shard(left[i * Bs:(i + 1) * Bs], right[i * Bs:(i + 1) * Bs],
                      params, row)
                for i, row in enumerate(mesh.devices)]
        return [o[0] for o in outs], [o[1] for o in outs]

    return fn


def bm_match_tp(mesh: Mesh, params: BMParams = BMParams()):
    """Block matching with the disparity axis over "disp" and the batch
    over "data". Returns fn(left_b, right_b) -> (dl, dr): for uint8
    [B, H, W] batches (B a multiple of the data rows), lists of each
    row's float32 maps [B / n_data, H, W] on its first device, in shard
    order, left finalized (texture gate, L/R check) and right, each equal
    to bm_match of its frames when the ranks divide D. On cards: kernel T1
    once a rank, T2 and S once a row, no other op that launches work."""
    return _tp_fn(mesh, params, _bm_tp_shard)


def bm_match_tp_plain(mesh: Mesh, params: BMParams = BMParams()):
    """bm_match_tp as the reference's eager program on any mesh (on cards,
    the yardstick T1 and T2 are held to)."""
    return _tp_fn(mesh, params, _bm_tp_shard_plain)
