"""The port's navigator and navigate CLI == jackal_tpu's.

The navigator is plain Python arithmetic in both packages, so twists,
markers and the CLI's printed lines are held exactly equal. The cases of
tests/test_nav.py run on both navigators as one parametrised test.
"""
import contextlib
import dataclasses
import io
import types

import numpy as np
import pytest

import jackal_tpu.cli.navigate as ref_cli
import jackal_tpu_torch.cli.navigate as port_cli
from jackal_tpu import config as ref_config
from jackal_tpu.nav import navigate as ref_nav
from jackal_tpu.scan import obstacle as ref_obstacle
from jackal_tpu_torch import config as port_config
from jackal_tpu_torch.nav import navigate as port_nav
from jackal_tpu_torch.scan import obstacle as port_obstacle

SIDES = {
    "port": types.SimpleNamespace(
        nav=port_nav, NavParams=port_config.NavParams,
        ranges=port_obstacle.format_laser_scan_ranges, INF=port_obstacle.INF),
    "reference": types.SimpleNamespace(
        nav=ref_nav, NavParams=ref_config.NavParams,
        ranges=ref_obstacle.format_laser_scan_ranges, INF=ref_obstacle.INF),
}


def scan_with_obstacle(s, r=0.8, bins=(42, 48)):
    scan = np.full(90, s.INF)
    scan[bins[0]:bins[1]] = r
    return scan


def feed(s, nav, scan):
    """The navigate CLI's scan -> (ranges, angle extrema) step."""
    ranges = s.ranges(scan)
    occ = np.nonzero(scan < s.INF - 1)[0]
    if len(occ):
        amax = (45.0 - occ.min()) * 3.1415 / 180.0
        amin = (45.0 - occ.max() - 1) * 3.1415 / 180.0
    else:
        amin, amax = 400.0, -400.0
    nav.on_laser_scan(ranges.tolist(), amin, amax)


def _laser_points_reconstruction(s, tmp_path):
    nav = s.nav.Navigator()
    feed(s, nav, scan_with_obstacle(s, 1.0, (44, 46)))
    assert len(nav.laser_points) == 2
    for x, y in nav.laser_points:
        assert 0.97 < x <= 1.0 and abs(y) < 0.1


def _check_obstacle_counts_and_votes(s, tmp_path):
    nav = s.nav.Navigator()
    feed(s, nav, scan_with_obstacle(s, 0.9, (42, 48)))
    assert nav.check_obstacle() == 0
    feed(s, nav, scan_with_obstacle(s, 0.9, (40, 50)))
    assert nav.check_obstacle() == 1
    c, total, stat, closest, conf = nav.last_obstacle_stats
    assert stat == "Y" and c == 10 and abs(closest - 0.9) < 1e-6


def _hard_stop_under_half_meter(s, tmp_path):
    nav = s.nav.Navigator()
    feed(s, nav, scan_with_obstacle(s, 0.4, (44, 45)))
    assert nav.check_obstacle() == 1


def _temporal_filter_sticks(s, tmp_path):
    nav = s.nav.Navigator()
    for _ in range(3):
        feed(s, nav, scan_with_obstacle(s, 0.4, (44, 45)))
        nav.check_obstacle()
    feed(s, nav, np.full(90, s.INF))
    assert nav.check_obstacle() == 1


def _choose_direction_hysteresis(s, tmp_path):
    nav = s.nav.Navigator()
    scan = np.full(90, s.INF)
    scan[50:60] = 0.8
    feed(s, nav, scan)
    assert nav.choose_direction() == 1
    nav.last_dir = 1
    scan = np.full(90, s.INF)
    scan[40:44] = 0.8
    scan[46:50] = 0.8
    feed(s, nav, scan)
    assert nav.choose_direction() == 1


def _stop_in_front_ramp(s, tmp_path):
    p = s.NavParams()
    nav = s.nav.Navigator(p)
    joy = s.nav.JoyState(o=True)
    feed(s, nav, np.full(90, s.INF))
    assert nav.drive(joy).linear_x == pytest.approx(p.trans_accel)
    assert nav.drive(joy).linear_x == pytest.approx(2 * p.trans_accel)
    for _ in range(12):
        feed(s, nav, scan_with_obstacle(s, 0.3, (38, 52)))
        tw = nav.drive(joy)
    assert tw.linear_x == 0.0


def _obstacle_avoid_turns(s, tmp_path):
    nav = s.nav.Navigator()
    joy = s.nav.JoyState(x=True, front=1.0)
    scan = np.full(90, s.INF)
    scan[50:70] = 0.6
    for _ in range(4):
        feed(s, nav, scan)
        tw = nav.drive(joy)
    assert tw.angular_z > 0 and nav.last_dir == 1


def _waypoints_and_modes(s, tmp_path):
    f = tmp_path / "wp.txt"
    f.write_text("2\n10 0\n20 0\n")
    nav = s.nav.Navigator()
    nav.read_waypoints(str(f))
    assert nav.current_waypoint.x == 10 and len(nav.path) == 1
    joy = s.nav.JoyState(triangle=True, front=1.0)
    feed(s, nav, np.full(90, s.INF))
    assert nav.drive(joy).linear_x > 0
    nav.jackal_pos = s.nav.Pose(8.0, 0.0, 0.0)
    feed(s, nav, np.full(90, s.INF))
    nav.drive(joy)
    assert nav.reached_waypoint
    feed(s, nav, np.full(90, s.INF))
    nav.drive(joy)
    assert nav.current_waypoint.x == 20


def _joy_mode_dispatch_none(s, tmp_path):
    nav = s.nav.Navigator()
    feed(s, nav, np.full(90, s.INF))
    assert nav.drive(s.nav.JoyState()) is None


NAV_CASES = {f.__name__.lstrip("_"): f for f in (
    _laser_points_reconstruction, _check_obstacle_counts_and_votes,
    _hard_stop_under_half_meter, _temporal_filter_sticks,
    _choose_direction_hysteresis, _stop_in_front_ramp,
    _obstacle_avoid_turns, _waypoints_and_modes, _joy_mode_dispatch_none)}


@pytest.mark.parametrize("side", sorted(SIDES))
@pytest.mark.parametrize("case", sorted(NAV_CASES))
def test_navigator(case, side, tmp_path):
    NAV_CASES[case](SIDES[side], tmp_path)


def _seeded_scans(seed, n=20):
    """Obstacles of random extent and range, some frames empty, some with
    points under the hard-stop distance."""
    rng = np.random.default_rng(seed)
    scans = np.full((n, 90), 1e9)
    for i in range(n):
        for _ in range(rng.integers(0, 4)):
            a = int(rng.integers(0, 85))
            scans[i, a:a + int(rng.integers(1, 20))] = rng.uniform(0.2, 3.0)
    return scans.astype(np.float32)


def _marker_fields(m):
    return (m.header.seq, m.header.frame_id, m.ns, m.id, m.type, m.action,
            [dataclasses.astuple(p) for p in m.points], m.scale_x,
            m.color_rgba)


@pytest.mark.parametrize("mode", ["stop", "avoid", "auto"])
def test_navigators_agree_tick_by_tick(mode, tmp_path):
    """20 seeded scans through both navigators (with waypoints and poses in
    auto mode): equal Twists, markers and obstacle stats every tick."""
    wp = tmp_path / "wp.txt"
    wp.write_text("2\n3 1\n6 -2\n")
    navs, outs = [], []
    for name in ("port", "reference"):
        s = SIDES[name]
        nav = s.nav.Navigator(s.NavParams(laser_pt_thresh=5))
        nav.read_waypoints(str(wp))
        navs.append((s, nav))
        outs.append([])
    scans = _seeded_scans({"stop": 1, "avoid": 2, "auto": 3}[mode])
    for i, scan in enumerate(scans):
        for (s, nav), out in zip(navs, outs):
            joy = s.nav.JoyState(o=mode == "stop", x=mode == "avoid",
                                 triangle=mode == "auto",
                                 front=0.5 + 0.025 * i, side=0.1)
            if mode == "auto":
                nav.on_pose(0.3 * i, 0.2 * i * (-1) ** i, 0.0)
            feed(s, nav, scan)
            tw = nav.drive(joy)
            out.append((dataclasses.astuple(tw),
                        _marker_fields(nav.visualize_laser_points(i)),
                        nav.last_obstacle_stats, nav.last_dir,
                        nav.rot_frames, nav.reached_waypoint))
    assert outs[0] == outs[1]
    assert any(o[0] != (0.0, 0.0) for o in outs[0])


def _cli_stdout(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["--ticks", "5"],
    ["--ticks", "20", "--mode", "avoid", "-f", "0.4", "-l", "3"],
    ["--ticks", "12", "--mode", "auto", "-c", "0.8"],
    ["--scans", "SCANS", "--ticks", "5"],
    ["--scans", "SCANS", "--ticks", "20", "--mode", "avoid"],
], ids=["demo", "demo-avoid", "demo-auto", "scans", "scans-avoid"])
def test_navigate_cli_equals_reference(argv, tmp_path):
    scans = tmp_path / "scans.npz"
    np.savez(scans, scans=_seeded_scans(4))
    argv = [str(scans) if a == "SCANS" else a for a in argv]
    port = _cli_stdout(port_cli, argv)
    ref = _cli_stdout(ref_cli, argv)
    assert port[0] == ref[0] == 0
    assert port[1] == ref[1]
    assert port[1].count("\n") >= 5
