"""Carry the reference package's state across to the port.

The system has no weights: its state is the stereo calibration and the
parameter dataclasses. ``state_from_numpy`` rebuilds them from plain
values (numpy arrays, and the dicts ``dataclasses.asdict`` gives), so the
same settings can be handed to both packages without the port importing
the other one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np

from .calib import StereoCalibration
from .config import ElasParams, GroundPlaneParams, PipelineParams, ScanParams

_PARAM_TYPES = {
    "elas": ElasParams,
    "pipeline": PipelineParams,
    "scan": ScanParams,
    "ground_plane": GroundPlaneParams,
}


@dataclasses.dataclass
class PortState:
    calib: StereoCalibration
    elas: ElasParams
    pipeline: PipelineParams
    scan: ScanParams
    ground_plane: GroundPlaneParams


def _params(cls, fields: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {k: (tuple(v) if isinstance(v, (list, np.ndarray)) else v)
          for k, v in fields.items()}
    return cls(**kw)


def state_from_numpy(calib_arrays: Mapping[str, Any],
                     params: Mapping[str, Dict[str, Any]]) -> PortState:
    """calib_arrays: StereoCalibration fields as arrays (None or absent
    for optional ones). params: {"elas" | "pipeline" | "scan" |
    "ground_plane": dataclasses.asdict(...)}; absent keys take defaults."""
    unknown = set(params) - set(_PARAM_TYPES)
    if unknown:
        raise ValueError(f"unknown parameter groups {sorted(unknown)}")
    calib = StereoCalibration(**{
        k: (None if v is None else np.asarray(v, np.float64))
        for k, v in calib_arrays.items()})
    groups = {k: _params(cls, params.get(k, {}))
              for k, cls in _PARAM_TYPES.items()}
    return PortState(calib=calib, **groups)
