"""Safe-navigation control logic (navigate.cpp port, host-side by design).

The reference's navigate node (navigate.cpp:1-442) is scalar, stateful
control flow — deque temporal filters, hysteresis, velocity ramps — which
belongs on the host, consuming the point_cloud node's LaserScan output
unchanged. Pure Python, deterministic; the tests hold it equal to the
JAX package's navigator tick by tick.

Cited behaviors:
  - laserScanCallback angle reconstruction (navigate.cpp:344-363) including
    the approximate angular indexing over compacted ranges;
  - checkObstacle (101-153): clearance-box count, <0.5 m hard stop,
    20-frame temporal vote;
  - chooseDirection (155-197): left/right confidence + hysteresis;
  - stopInFront / obstacleAvoid / autoNavigate modes (208-300);
  - velocity ramping with accel/decel limits (328-337);
  - getCurrentPose waypoint heading correction (365-392);
  - read_waypoints file format (394-416).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

from ..config import NavParams

INF = 1e9


@dataclasses.dataclass
class Pose:
    x: float = 0.0
    y: float = 0.0
    theta: float = 0.0

    def dist(self, p: "Pose") -> float:
        return math.hypot(self.x - p.x, self.y - p.y)


@dataclasses.dataclass
class Twist:
    linear_x: float = 0.0
    angular_z: float = 0.0


@dataclasses.dataclass
class JoyState:
    """Joystick decode (navigate.cpp:304-310): PS3-style mapping."""

    r2: bool = False        # buttons[9]
    r1: bool = False        # buttons[11]
    x: bool = False         # buttons[14]
    o: bool = False         # buttons[13]
    triangle: bool = False  # buttons[12]
    side: float = 0.0       # axes[0]
    front: float = 0.0      # axes[1]


def joy_state_from_msg(msg) -> "JoyState":
    """Decode a /bluetooth_teleop/joy message with the reference's PS3
    mapping (navigate.cpp:304-310): buttons[9]=R2, [11]=R1, [14]=X,
    [13]=O, [12]=triangle; axes[0]=side, axes[1]=front. Short arrays
    read as unpressed/centered."""
    def btn(i):
        return bool(msg.buttons[i]) if i < len(msg.buttons) else False

    def ax(i):
        return float(msg.axes[i]) if i < len(msg.axes) else 0.0

    return JoyState(r2=btn(9), r1=btn(11), x=btn(14), o=btn(13),
                    triangle=btn(12), side=ax(0), front=ax(1))


class Navigator:
    """Stateful controller; call laser_scan() then drive() per tick."""

    def __init__(self, params: Optional[NavParams] = None):
        self.p = params or NavParams()
        self.laser_points: List[Tuple[float, float]] = []
        self.laser_scan: List[float] = []
        self.commands: Deque[int] = deque()
        self.last_dir = 0
        self.forward_vel = 0.0
        self.rot_vel = 0.0
        # waypoint state
        self.jackal_pos = Pose()
        self.last_jackal_pos = Pose()
        self.current_waypoint = Pose()
        self.reached_waypoint = False
        self.path: Deque[Pose] = deque()
        self.pose_update_counter = 0
        self.rot_frames = 0
        self.last_obstacle_stats: Tuple[int, int, str, float, float] = (
            0, 0, "N", INF, 0.0)

    # ---- laser input (navigate.cpp:344-363) ----
    def on_laser_scan(self, ranges: Sequence[float], angle_min: float,
                      angle_max: float) -> None:
        n = len(ranges)
        self.laser_points = []
        self.laser_scan = list(ranges)
        for i in range(n):
            ang = i * (angle_max - angle_min) / n + angle_min if n else 0.0
            self.laser_points.append(
                (ranges[i] * math.cos(ang), ranges[i] * math.sin(ang)))

    # ---- laser-point Marker visualization (navigate.cpp:78-99) ----
    def visualize_laser_points(self, seq: int = 0):
        """Marker POINTS message of the current laser points (z=0, blue,
        0.02 scale, ns jackal_navigation), published by the reference on
        the 'visualize_laser' topic each scan (navigate.cpp:362,438)."""
        from ..io_bus.messages import Header, Marker, Point32

        return Marker(
            header=Header.now(seq, "jackal"),
            ns="jackal_navigation",
            id=0,
            type=8,      # POINTS
            action=0,    # ADD
            points=[Point32(x, y, 0.0) for (x, y) in self.laser_points],
            scale_x=0.02,
            color_rgba=(0.0, 0.0, 1.0, 1.0),
        )

    # ---- obstacle detection (navigate.cpp:101-153) ----
    def check_obstacle(self) -> int:
        p = self.p
        count = 0
        closest = INF
        for (x, y) in self.laser_points:
            dist = math.hypot(x, y)
            closest = min(closest, dist)
            if 0.0 < x < p.clear_front and -p.clear_side < y < p.clear_side:
                count += 1
        is_obstacle = 1 if count > p.laser_pt_thresh else 0
        if closest < p.hard_stop_dist:
            is_obstacle = 1
        if len(self.commands) >= p.temporal_window:
            self.commands.popleft()
        self.commands.append(is_obstacle)
        one = sum(self.commands)
        zero = len(self.commands) - one
        if one > p.temporal_votes:
            is_obstacle = 1
        conf = one / max(one + zero, 1)
        self.last_obstacle_stats = (
            count, len(self.laser_points), "Y" if is_obstacle else "N",
            closest, conf)
        return is_obstacle

    # ---- direction choice (navigate.cpp:155-197) ----
    def choose_direction(self) -> int:
        p = self.p
        left_count = right_count = 0
        for (x, y) in self.laser_points:
            if 0.0 < x < p.clear_front:
                if y < 0:
                    right_count += 1
                else:
                    left_count += 1
        total = left_count + right_count
        if total < 2:
            return 0
        conf_left = 2.0 * right_count / total
        conf_right = 2.0 * left_count / total
        if conf_left > conf_right:
            if self.last_dir != 1:
                return 1 if conf_left - conf_right > p.hysteresis_margin \
                    else self.last_dir
            return 1
        if self.last_dir != 2:
            return 2 if conf_right - conf_left > p.hysteresis_margin \
                else self.last_dir
        return 2

    def get_safe_vel(self, trans_accel: float) -> float:
        """navigate.cpp:199-206 (including its buggy loop bound, fixed:
        the reference iterates `i < laserScan[i]` — we scan all points)."""
        min_dist = min(self.laser_scan, default=INF)
        return math.sqrt(2 * trans_accel * min_dist)

    # ---- modes (navigate.cpp:208-300) ----
    def stop_in_front_mode(self, side: Optional[float] = None,
                           front: Optional[float] = None
                           ) -> Tuple[float, float]:
        p = self.p
        if side is None:
            desired_fwd = p.max_forward_vel * 1.0
            desired_rot = 0.0
        else:
            desired_fwd = p.max_forward_vel * front
            desired_rot = p.max_rot_vel * side
        if self.check_obstacle() == 1:
            desired_fwd = min(desired_fwd, 0.0)
        return desired_fwd, desired_rot

    def obstacle_avoid_mode(self, front: float) -> Tuple[float, float]:
        p = self.p
        if self.check_obstacle():
            d = self.choose_direction()
            self.last_dir = d
            rot = p.max_rot_vel * 0.4 if d == 1 else (
                -p.max_rot_vel * 0.4 if d == 2 else 0.0)
            return 0.0, rot
        self.last_dir = 0
        return p.max_forward_vel * max(0.4, front), 0.0

    def go_to_waypoint(self, wp: Pose, front: float) -> Tuple[float, float]:
        p = self.p
        dist = wp.dist(self.jackal_pos)
        if dist < p.waypoint_reached_dist:
            self.reached_waypoint = True
            return 0.0, 0.0
        if self.rot_frames != 0:
            if self.rot_frames < 0:
                rot = p.max_rot_vel * 0.5
                self.rot_frames += 1
            else:
                rot = -p.max_rot_vel * 0.5
                self.rot_frames -= 1
            return p.max_forward_vel * max(0.4, front), rot
        return p.max_forward_vel * max(0.4, front), 0.0

    def auto_navigate_mode(self, front: float) -> Tuple[float, float]:
        if len(self.path) == 0 and self.reached_waypoint:
            return 0.0, 0.0
        if self.reached_waypoint:
            self.current_waypoint = self.path.popleft()
            self.reached_waypoint = False
        return self.go_to_waypoint(self.current_waypoint, front)

    # ---- main tick (navigate.cpp:302-342) ----
    def drive(self, joy: JoyState) -> Optional[Twist]:
        p = self.p
        if joy.r1 and joy.r2:
            desired = self.stop_in_front_mode(joy.side, joy.front)
        elif joy.triangle:
            desired = self.auto_navigate_mode(joy.front)
        elif joy.x:
            desired = self.obstacle_avoid_mode(joy.front)
        elif joy.o:
            desired = self.stop_in_front_mode()
        else:
            return None
        desired_fwd, desired_rot = desired
        if desired_fwd < self.forward_vel:
            self.forward_vel = max(desired_fwd,
                                   self.forward_vel - p.trans_decel)
        else:
            self.forward_vel = min(desired_fwd,
                                   self.forward_vel + p.trans_accel)
        if desired_rot < self.rot_vel:
            self.rot_vel = max(desired_rot, self.rot_vel - p.rot_accel)
        else:
            self.rot_vel = min(desired_rot, self.rot_vel + p.rot_accel)
        return Twist(self.forward_vel, self.rot_vel)

    # ---- pose / waypoints (navigate.cpp:365-416) ----
    def on_pose(self, x: float, y: float, theta: float) -> None:
        p = self.p
        self.jackal_pos = Pose(x, y, theta)
        self.pose_update_counter += 1
        heading = math.atan2(self.jackal_pos.y - self.last_jackal_pos.y,
                             self.jackal_pos.x - self.last_jackal_pos.x)
        wp_line = math.atan2(self.current_waypoint.y - self.jackal_pos.y,
                             self.current_waypoint.x - self.jackal_pos.x)
        ang_diff = heading - wp_line
        if self.pose_update_counter > 20:
            if self.last_jackal_pos.dist(self.jackal_pos) > 3:
                if abs(ang_diff * 180 / 3.14) > 30:
                    self.rot_frames = int(
                        ang_diff * p.cmd_rate / (p.max_rot_vel * 0.5))
                else:
                    self.rot_frames = 0
                self.last_jackal_pos = self.jackal_pos
            self.pose_update_counter = 0

    def read_waypoints(self, filename: str) -> None:
        with open(filename) as f:
            tokens = f.read().split()
        n = int(tokens[0])
        vals = [float(t) for t in tokens[1:1 + 2 * n]]
        for i in range(n):
            self.path.append(Pose(vals[2 * i], vals[2 * i + 1], 0.0))
        if self.path:
            self.current_waypoint = self.path.popleft()
