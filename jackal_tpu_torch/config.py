"""Typed configuration for the whole framework.

Unifies the reference's four config tiers (popt CLI flags, calibration YAML,
dynamic_reconfigure, compile-time constants) into dataclasses carrying the
same names and defaults.

Reference provenance:
  - ELAS parameter presets: libelas elas.h:87-144
  - ground-plane / scan constants: src/obstacle_avoidance/point_cloud.cpp:38-69,151-152,217-218
  - navigate constants: src/obstacle_avoidance/navigate.cpp:29-42
  - dynamic_reconfigure extrinsic sliders: cfg/CamToRobotCalibParams.cfg:8-13
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# The reference consistently uses 3.1415 (not math.pi) for degree conversions
# (point_cloud.cpp:67,174,256; navigate's prints). Keep it for bit-parity.
REF_PI = 3.1415


@dataclasses.dataclass(frozen=True)
class ElasParams:
    """ELAS stereo-matching parameters (elas.h:59-145).

    Defaults are the ROBOTICS preset (elas.h:92-115), which is what the
    point_cloud node runs (point_cloud.cpp:416-417 additionally forces
    postprocess_only_left=True, already true in ROBOTICS).
    """

    disp_min: int = 0
    disp_max: int = 255
    support_threshold: float = 0.85
    support_texture: int = 10
    candidate_stepsize: int = 5
    incon_window_size: int = 5
    incon_threshold: int = 5
    incon_min_support: int = 5
    add_corners: bool = False
    grid_size: int = 20
    beta: float = 0.02
    gamma: float = 3.0
    sigma: float = 1.0
    sradius: float = 2.0
    match_texture: int = 1
    lr_threshold: int = 2
    speckle_sim_threshold: float = 1.0
    speckle_size: int = 200
    ipol_gap_width: int = 3
    filter_median: bool = False
    filter_adaptive_mean: bool = True
    postprocess_only_left: bool = True
    subsampling: bool = False

    @staticmethod
    def robotics() -> "ElasParams":
        return ElasParams()

    @staticmethod
    def middlebury() -> "ElasParams":
        """MIDDLEBURY preset (elas.h:119-143)."""
        return ElasParams(
            support_threshold=0.95,
            add_corners=True,
            gamma=5.0,
            sradius=3.0,
            match_texture=0,
            ipol_gap_width=5000,
            filter_median=True,
            filter_adaptive_mean=False,
            postprocess_only_left=False,
        )

    @property
    def disp_num(self) -> int:
        # grid_dims[0]-1 in the reference (elas.cpp:92, 688)
        return self.disp_max + 1

    @property
    def plane_radius(self) -> int:
        # elas.cpp:806
        return int(max(math.ceil(self.sigma * self.sradius), 2.0))


@dataclasses.dataclass(frozen=True)
class GroundPlaneParams:
    """Ground-plane rejection model (point_cloud.cpp:66-69)."""

    height_thresh: float = 0.05   # GP_HEIGHT_THRESH
    angle_thresh: float = 4.0 * REF_PI / 180.0  # GP_ANGLE_THRESH
    dist_thresh: float = 1.0      # GP_DIST_THRESH
    robot_height: float = 0.34    # ROBOT_HEIGHT (unused in reference hot path)


@dataclasses.dataclass(frozen=True)
class ScanParams:
    """Obstacle-scan geometry (point_cloud.cpp:151-152,217-218,275)."""

    fov_deg: float = 90.0
    bin_size: int = 90
    angle_increment: float = REF_PI / 180.0
    scan_time: float = 0.001
    time_increment: float = 0.1
    min_pcl_disp: int = 2         # point_cloud.cpp:325 (d < 2 ignored)
    cache_disp_lo: int = 3        # cacheDisparityValues scans d=3..255 (point_cloud.cpp:110)
    cache_disp_hi: int = 255


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    """point_cloud node configuration (point_cloud.cpp:38-64, CLI 502-514)."""

    calib_im_size: Tuple[int, int] = (640, 360)   # (width, height) point_cloud.cpp:38
    im_width: int = 320                           # rectified output size
    im_height: int = 180
    crop_offset_x: int = 0
    crop_offset_y: int = 0
    crop_im_width: int = 320
    crop_im_height: int = 180                     # CLI -h overrides (partial-height mode)
    gen_pcl: bool = False                         # -g
    logging: bool = False                         # -l
    calib_robot_to_cam: bool = False              # -m
    batch_size: int = 1


@dataclasses.dataclass(frozen=True)
class ExtrinsicCalibParams:
    """dynamic_reconfigure live extrinsics (cfg/CamToRobotCalibParams.cfg:8-13)."""

    phi_x: float = 1.3
    phi_y: float = -3.14
    phi_z: float = 1.57
    trans_x: float = 0.0
    trans_y: float = 0.0
    trans_z: float = 0.28


@dataclasses.dataclass
class NavParams:
    """navigate node constants and CLI flags (navigate.cpp:29-47,422-429)."""

    trans_accel: float = 0.025
    trans_decel: float = 0.1
    rot_accel: float = 0.05
    max_forward_vel: float = 0.6    # -f
    max_rot_vel: float = 1.3
    clear_front: float = 0.24 + 0.8  # -c
    clear_side: float = 0.3
    laser_pt_thresh: int = 8        # -l
    temporal_window: int = 20       # deque length (navigate.cpp:130)
    temporal_votes: int = 2         # "if (one > 2)" (navigate.cpp:146)
    hard_stop_dist: float = 0.5     # navigate.cpp:126
    hysteresis_margin: float = 0.5  # chooseDirection (navigate.cpp:177,187)
    waypoint_reached_dist: float = 3.0  # goToWayPoint (navigate.cpp:260)
    cmd_rate: float = 8.0           # getCurrentPose (navigate.cpp:383)


@dataclasses.dataclass(frozen=True)
class SGMParams:
    """Semi-global matching engine (TPU-native alternative engine; BASELINE config 3)."""

    disp_num: int = 64
    p1: int = 7           # small-jump penalty (census-5x5 scaled)
    p2: int = 86          # large-jump penalty
    num_paths: int = 8    # 4 straight + 4 diagonal
    uniqueness: float = 0.95
    lr_threshold: int = 1
    # Reference-grade right-image aggregation: run the full 8-path DP over
    # the right-view cost volume instead of deriving S_R(u,d) = S_L(u+d,d)
    # (exact for raw cost, approximate for the aggregated sum — the
    # approximation only feeds the L/R consistency threshold). Doubles the
    # aggregation work; measured effect on the fixture scene is in
    # docs/parity.md.
    true_right: bool = False


@dataclasses.dataclass(frozen=True)
class BMParams:
    """Block-matching engine parameters."""

    disp_num: int = 64
    window: int = 9           # SAD window
    texture_threshold: int = 10
    uniqueness: float = 0.85
    lr_threshold: int = 1
