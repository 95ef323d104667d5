"""Message dataclasses mirroring the reference's ROS message surface.

Topic payloads keep the reference's field names and quirks so downstream
consumers (the navigate node, rviz-style visualizers, the plot scripts) can
be ported unchanged:

  - LaserScan mirrors sensor_msgs/LaserScan as published by
    publishObstacleScan (point_cloud.cpp:270-283): ranges are compacted
    (empty bins skipped) from bin 89 down to 0.
  - JackalTimeLog mirrors msg/JackalTimeLog.msg (header + three float32
    stage times).
  - JackalPose mirrors msg/JackalPose.msg.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple


@dataclasses.dataclass
class Header:
    seq: int = 0
    stamp: float = 0.0
    frame_id: str = ""

    @staticmethod
    def now(seq: int = 0, frame_id: str = "") -> "Header":
        return Header(seq=seq, stamp=time.time(), frame_id=frame_id)


@dataclasses.dataclass
class Image:
    header: Header
    height: int
    width: int
    encoding: str     # "mono8" | "bgr8"
    data: "object"    # ndarray


@dataclasses.dataclass
class CompressedImage:
    header: Header
    format: str       # "jpeg"
    data: bytes


@dataclasses.dataclass
class LaserScan:
    header: Header
    angle_min: float
    angle_max: float
    angle_increment: float
    time_increment: float
    scan_time: float
    range_min: float
    range_max: float
    ranges: List[float]


@dataclasses.dataclass
class Point32:
    x: float
    y: float
    z: float


@dataclasses.dataclass
class ChannelFloat32:
    name: str
    values: List[float]


@dataclasses.dataclass
class PointCloud:
    header: Header
    points: List[Point32]
    channels: List[ChannelFloat32]


@dataclasses.dataclass
class TwistMsg:
    linear_x: float = 0.0
    angular_z: float = 0.0


@dataclasses.dataclass
class Joy:
    header: Header
    axes: List[float]
    buttons: List[int]


@dataclasses.dataclass
class JackalTimeLog:
    header: Header
    pcl_time: float = 0.0
    obstacle_scan_time: float = 0.0
    dmap_time: float = 0.0


@dataclasses.dataclass
class JackalPose:
    x: float = 0.0
    y: float = 0.0
    theta: float = 0.0


@dataclasses.dataclass
class Marker:
    header: Header
    ns: str = ""
    id: int = 0
    type: int = 8          # POINTS
    action: int = 0        # ADD
    points: List[Point32] = dataclasses.field(default_factory=list)
    scale_x: float = 0.02
    color_rgba: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
