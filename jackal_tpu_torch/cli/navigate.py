"""navigate CLI: safe-navigation control node.

    python -m jackal_tpu_torch.cli.navigate [flags]

Mirrors navigate.cpp's flags (navigate.cpp:422-429): -f max-forward-vel,
-l laser-thresh, -c forward-clearance; consumes LaserScan messages (from a
live TopicBus, an NPZ scan recording, or stdin) and emits Twist commands.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m jackal_tpu_torch.cli.navigate",
        description="obstacle gating / velocity control from obstacle scans")
    ap.add_argument("-f", "--max-forward-vel", type=float, default=0.6)
    ap.add_argument("-l", "--laser-thresh", type=int, default=8)
    ap.add_argument("-c", "--forward-clearance", type=float, default=1.04)
    ap.add_argument("--mode", choices=["stop", "avoid", "auto"],
                    default="stop",
                    help="joystick-free drive mode (O / X / triangle)")
    ap.add_argument("--scans", default=None,
                    help="NPZ with 'scans' [N,90] + optional angles; "
                         "default: demo scan stream")
    ap.add_argument("--waypoints", default=None,
                    help="waypoint file (count then x y pairs)")
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--bus", default=None, metavar="HOST:PORT",
                    help="consume /webcam/left/obstacle_scan from a "
                         "bus broker (jackal_tpu_torch.cli.bus_broker); "
                         "publish cmd_vel + Markers")
    ap.add_argument("--bus-timeout", type=float, default=30.0,
                    help="give up if no scan arrives for this long")
    return ap


def _run_bus(args, nav, joy) -> int:
    """Cross-process mode: scans, joystick and GPS pose in over the
    broker; Twist + Marker out — the navigate node side of
    launch/stereo.launch's topology with all three reference inputs
    (navigate.cpp:435-437):

      /webcam/left/obstacle_scan  -> on_laser_scan + Marker + drive tick
      /bluetooth_teleop/joy       -> latest JoyState (mode/axes dispatch,
                                     safeNavigate 302-324)
      /jackal/gps_estimate        -> on_pose (waypoint heading correction,
                                     getCurrentPose 365-392)

    Conscious deviation: the reference drives on each JOY message; here
    the drive tick rides each SCAN with the latest joy state, so the
    joystick-free default (--mode) works without an operator publisher —
    a joy message updates the state consumed at the next scan."""
    import time

    from ..io_bus.bus import TopicBus
    from ..io_bus.socket_bus import BusBridge
    from ..nav.navigate import joy_state_from_msg

    bus = TopicBus()
    sub = bus.subscribe_queue("/webcam/left/obstacle_scan", maxlen=1)
    joy_sub = bus.subscribe_queue("/bluetooth_teleop/joy", maxlen=1)
    pose_sub = bus.subscribe_queue("/jackal/gps_estimate", maxlen=64)
    vel_pub = bus.advertise("/jackal_velocity_controller/cmd_vel")
    marker_pub = bus.advertise("/visualize_laser")   # navigate.cpp:438
    bridge = BusBridge(
        bus, args.bus,
        publish_topics=("/jackal_velocity_controller/cmd_vel",
                        "/visualize_laser"),
        subscribe_topics=("/webcam/left/obstacle_scan",
                          "/bluetooth_teleop/joy",
                          "/jackal/gps_estimate"))
    print(f"bridged to broker at {args.bus}", flush=True)

    handled = 0
    deadline = time.time() + args.bus_timeout
    while handled < args.ticks and time.time() < deadline:
        while True:                       # drain poses in arrival order
            pm = pose_sub.pop()
            if pm is None:
                break
            nav.on_pose(pm.x, pm.y, pm.theta)
            print(f"Current position: {pm.x}, {pm.y}", flush=True)
        jm = joy_sub.pop()
        if jm is not None:
            joy = joy_state_from_msg(jm)
        msg = sub.pop()
        if msg is None:
            time.sleep(0.005)
            continue
        nav.on_laser_scan(msg.ranges, msg.angle_min, msg.angle_max)
        marker_pub.publish(nav.visualize_laser_points(handled))
        tw = nav.drive(joy)
        count, total, stat, closest, conf = nav.last_obstacle_stats
        print(f"{count}, {total}, {stat}, {closest}, {conf}", flush=True)
        if tw is not None:
            vel_pub.publish(tw)
            print(f"  cmd_vel: linear.x={tw.linear_x:.3f} "
                  f"angular.z={tw.angular_z:.3f}", flush=True)
        handled += 1
        deadline = time.time() + args.bus_timeout
    bridge.close()
    print(f"handled {handled} scans", flush=True)
    return 0 if handled else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..config import NavParams
    from ..nav.navigate import JoyState, Navigator
    from ..scan.obstacle import INF, format_laser_scan_ranges

    p = NavParams(max_forward_vel=args.max_forward_vel,
                  laser_pt_thresh=args.laser_thresh,
                  clear_front=args.forward_clearance)
    nav = Navigator(p)
    if args.waypoints:
        nav.read_waypoints(args.waypoints)

    joy_bus = JoyState(o=args.mode == "stop", x=args.mode == "avoid",
                       triangle=args.mode == "auto", front=1.0)
    if args.bus:
        return _run_bus(args, nav, joy_bus)

    if args.scans:
        z = np.load(args.scans)
        scan_mat = z["scans"]
    else:
        # demo: obstacle approaching head-on from 3 m to 0.3 m
        n = args.ticks
        scan_mat = np.full((n, 90), INF)
        for i in range(n):
            r = max(3.0 - i * 0.15, 0.3)
            scan_mat[i, 42:48] = r

    joy = JoyState(o=args.mode == "stop", x=args.mode == "avoid",
                   triangle=args.mode == "auto", front=1.0)

    for i in range(min(args.ticks, len(scan_mat))):
        ranges = format_laser_scan_ranges(scan_mat[i])
        # reference quirk: angle extrema come from the scan payload; for
        # bins 42..47 of a 90-bin scan that's theta in [-3, 3] deg approx
        occupied = np.nonzero(scan_mat[i] < INF - 1)[0]
        if len(occupied):
            amax = (45.0 - occupied.min()) * 3.1415 / 180.0
            amin = (45.0 - occupied.max() - 1) * 3.1415 / 180.0
        else:
            amin, amax = 400.0, -400.0
        nav.on_laser_scan(ranges.tolist(), amin, amax)
        tw = nav.drive(joy)
        count, total, stat, closest, conf = nav.last_obstacle_stats
        print(f"{count}, {total}, {stat}, {closest}, {conf}")
        if tw is not None:
            print(f"  cmd_vel: linear.x={tw.linear_x:.3f} "
                  f"angular.z={tw.angular_z:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
