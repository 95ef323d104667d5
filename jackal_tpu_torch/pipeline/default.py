"""Default pipeline construction (the bundled calibration)."""
from __future__ import annotations

import os
from typing import Optional

from ..calib import StereoCalibration, load_calibration
from ..config import PipelineParams
from ..device import DeviceLike
from .frame_pipeline import StereoPipeline

DEFAULT_CALIB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "default_calib.yml")


def default_calibration() -> StereoCalibration:
    return load_calibration(DEFAULT_CALIB)


def make_pipeline(
    calib_file: Optional[str] = None,
    engine: str = "sgm",
    params: Optional[PipelineParams] = None,
    device: DeviceLike = None,
    **kw,
) -> StereoPipeline:
    """StereoPipeline on ``device`` (the card unless ``device="cpu"``).
    The default engine is "sgm", as in the reference package."""
    calib = load_calibration(calib_file) if calib_file \
        else default_calibration()
    return StereoPipeline(calib, params or PipelineParams(), engine,
                          device=device, **kw)
