"""point_cloud CLI: the perception node.

    python -m jackal_tpu_torch.cli.point_cloud [flags]

Mirrors the reference binary's popt flags (point_cloud.cpp:502-514):
  --img-height (-h crop height), --calib-file (-c), --logging (-l),
  --gen-pcl (-g), --calib-extrinsic (-m), --dmap-file (-d),
  --pcl-file (-p), --scan-file (-s)
plus --engine {elas,bm,sgm}, --source (NPZ/dir replay, 'synthetic' or
live V4L2 cameras), --frames, --batch, --out, and --device: the node runs
on the CUDA card unless --device names another (--device cpu runs every
kernel's plain PyTorch version); with no card it exits non-zero.

Publishes on the in-process topic bus with the reference topic names and
writes plot-script-compatible time files.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m jackal_tpu_torch.cli.point_cloud", add_help=True,
        description="stereo perception on a CUDA card: rect -> disparity "
                    "-> cloud -> scan")
    ap.add_argument("--img-height", type=int, default=None,
                    help="crop height (partial-height mode, reference -h)")
    ap.add_argument("--size", default=None, metavar="WxH",
                    help="rectified processing size (default 320x180, the "
                         "reference's rawimsize); e.g. 640x480 for the "
                         "benchmark configuration")
    ap.add_argument("-c", "--calib-file", default=None,
                    help="stereo calibration YAML (default: bundled)")
    ap.add_argument("-l", "--logging", action="store_true",
                    help="log pipeline stage times")
    ap.add_argument("-g", "--gen-pcl", action="store_true",
                    help="generate full point cloud (else scan direct)")
    ap.add_argument("-m", "--calib-extrinsic", action="store_true",
                    help="live camera->robot extrinsic calibration mode")
    ap.add_argument("-d", "--dmap-file", default=None,
                    help="disparity-stage time log file")
    ap.add_argument("-p", "--pcl-file", default=None,
                    help="point-cloud-stage time log file")
    ap.add_argument("-s", "--scan-file", default=None,
                    help="scan-stage time log file")
    ap.add_argument("--engine", choices=["elas", "bm", "sgm"],
                    default="elas")
    ap.add_argument("--source", default="synthetic",
                    help="NPZ file, image directory, 'synthetic[:n]', or "
                         "live cameras 'v4l2:/dev/video1,/dev/video2"
                         "[?WxH@fps[,YUYV|MJPG]]' (uvc_stereo_node "
                         "equivalent, launch/stereo.launch)")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1,
                    help="batch size >1 routes the node through the "
                         "streaming runner (ELAS: the elas_match_stream "
                         "scheduler — the measured throughput path); 1 = "
                         "per-frame, the reference's callback shape")
    ap.add_argument("--out", default=None,
                    help="write results (dmaps + scans) to this NPZ; "
                         "per-frame mode only")
    ap.add_argument("--phi", type=float, nargs=3, default=None,
                    metavar=("PHI_X", "PHI_Y", "PHI_Z"),
                    help="extrinsic Euler angles for -m mode")
    ap.add_argument("--trans", type=float, nargs=3, default=None,
                    metavar=("TX", "TY", "TZ"),
                    help="extrinsic translation for -m mode")
    ap.add_argument("--reconfig", default=None, metavar="FILE",
                    help="dynamic_reconfigure analogue: JSON file with "
                         "{'phi': [x,y,z], 'trans': [x,y,z]} polled every "
                         "frame while -m is set; edits apply live")
    ap.add_argument("--bus", default=None, metavar="HOST:PORT",
                    help="connect to a jackal-bus-broker and publish the "
                         "depth/scan/time topics cross-process")
    ap.add_argument("--delay", type=float, default=0.0,
                    help="seconds to sleep between frames (replay pacing)")
    ap.add_argument("--loop", action="store_true",
                    help="loop a replay source until --frames is reached")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain PyTorch versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..config import PipelineParams, ExtrinsicCalibParams
    from ..device import resolve_device
    from ..io_bus.bus import TopicBus
    from ..io_bus.messages import Header, Image, JackalTimeLog, LaserScan
    from ..io_bus.camera import open_source
    from ..io_bus.timelog import TimeLogWriter
    from ..pipeline.default import make_pipeline
    from ..scan.obstacle import compact_cloud_msg, format_laser_scan_ranges

    W, H = 320, 180
    if args.size:
        W, H = (int(v) for v in args.size.lower().split("x"))
    pp = PipelineParams(
        gen_pcl=args.gen_pcl, logging=args.logging,
        calib_robot_to_cam=args.calib_extrinsic,
        im_width=W, im_height=H, crop_im_width=W,
        crop_im_height=args.img_height or H)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"point_cloud: {e} (--device cpu)", file=sys.stderr)
        return 2
    pipe = make_pipeline(args.calib_file, args.engine, pp, device=device)

    def print_extrinsics():
        print(f"Rotation matrix: {pipe.XR32.cpu().numpy()}")
        print(f"Translation matrix: {pipe.XT32.cpu().numpy()}")

    reconfig_state = {"mtime": None}

    def poll_reconfig():
        """Per-frame dynamic_reconfigure poll (point_cloud.cpp:305-311,
        492-495): while -m is set, re-read PHI/TRANS and recompose XR/XT
        (and the valid-disparity cache) whenever the file changes."""
        import json
        import os
        try:
            mtime = os.path.getmtime(args.reconfig)
        except OSError:
            return
        if mtime == reconfig_state["mtime"]:
            return
        reconfig_state["mtime"] = mtime
        with open(args.reconfig) as f:
            cfg = json.load(f)
        pipe.update_extrinsics(cfg["phi"], cfg["trans"])
        print_extrinsics()

    if args.calib_extrinsic:
        ext = ExtrinsicCalibParams()
        phi = args.phi or [ext.phi_x, ext.phi_y, ext.phi_z]
        trans = args.trans or [ext.trans_x, ext.trans_y, ext.trans_z]
        pipe.update_extrinsics(phi, trans)
        print_extrinsics()

    # gen-pcl feeds the LEFT COLOR frame into the cloud RGB packing
    # (point_cloud.cpp:356-383)
    source = open_source(args.source, n_synthetic=args.frames,
                         want_color=args.gen_pcl, loop=args.loop)
    stream = iter(source)

    bus = TopicBus()
    disp_pub = bus.advertise("/webcam/left/depth_map")
    scan_pub = bus.advertise("/webcam/left/obstacle_scan")
    pcl_pub = bus.advertise("/webcam/left/point_cloud")
    tl_pub = bus.advertise("/jackal/time_log")
    bus.advertise("/visualization_marker")   # parity: point_cloud.cpp:524
    bridge = None
    if args.bus:
        from ..io_bus.socket_bus import BusBridge
        bridge = BusBridge(
            bus, args.bus,
            publish_topics=("/webcam/left/depth_map",
                            "/webcam/left/obstacle_scan",
                            "/webcam/left/point_cloud",
                            "/jackal/time_log"))
        print(f"bridged to broker at {args.bus}", flush=True)
    writer = TimeLogWriter(args.dmap_file, args.pcl_file, args.scan_file)

    if args.batch > 1:
        # throughput node path: the StreamingRunner publishes the same
        # topics per frame; ELAS rides the elas_match_stream scheduler so
        # the host prior of one batch overlaps the card's work on another
        if args.calib_extrinsic and args.reconfig:
            print("note: --reconfig polls per BATCH in --batch mode")
        from ..pipeline.runner import StreamingRunner
        import time as _t
        runner = StreamingRunner(pipe, bus, batch_size=args.batch,
                                 timelog=writer if args.logging else None)

        def paced():
            for frame in stream:
                if args.delay:
                    _t.sleep(args.delay)
                if args.calib_extrinsic and args.reconfig:
                    poll_reconfig()
                yield frame

        t0 = _t.time()
        n_done = runner.run(paced(), max_frames=args.frames)
        dt = _t.time() - t0
        writer.close()
        if hasattr(source, "close"):
            source.close()
        if bridge is not None:
            _t.sleep(0.2)
            bridge.close()
        if args.out:
            print("note: --out is unsupported with --batch (per-frame "
                  "collection); skipped")
        path = ("elas_match_stream" if runner.used_elas_stream
                else "double-buffered")
        print(f"processed {n_done} frames in {dt:.2f}s -> "
              f"{n_done / dt:.1f} fps (engine={args.engine}, "
              f"batch={args.batch}, {path})")
        return 0

    dmaps, scans = [], []
    seq = 0
    for i, frame in enumerate(stream):
        left, right, *rest = frame
        color = rest[0] if rest else None
        if i >= args.frames:
            break
        if args.delay:
            import time
            time.sleep(args.delay)
        if args.calib_extrinsic and args.reconfig:
            poll_reconfig()
        fr = pipe.process_frame(left, right, color_bgr=color,
                                timing=args.logging)
        disp_pub.publish(Image(Header.now(seq, "jackal"),
                               *fr.dmap.shape, "mono8", fr.dmap))
        if args.gen_pcl and fr.cloud is not None:
            pcl_pub.publish(compact_cloud_msg(
                Header.now(seq, "jackal"), fr.cloud))
        scan = fr.scan.scan.cpu().numpy()
        ranges = format_laser_scan_ranges(scan)
        scan_pub.publish(LaserScan(
            Header.now(seq, "jackal"),
            float(fr.scan.angle_min), float(fr.scan.angle_max),
            3.1415 / 180.0, 0.1, 0.001,
            float(fr.scan.range_min), float(fr.scan.range_max),
            ranges.tolist()))
        if args.logging:
            writer.log("dmap", fr.dmap_time)
            if args.gen_pcl:
                writer.log("pcl", fr.pcl_time)
            writer.log("scan", fr.scan_time)
            tl_pub.publish(JackalTimeLog(
                Header.now(seq, "jackal"), fr.pcl_time,
                fr.scan_time, fr.dmap_time))
            print(f"frame {seq}: dmap={fr.dmap_time:.4f}s "
                  f"scan={fr.scan_time:.4f}s ranges={len(ranges)}")
        dmaps.append(fr.dmap)
        scans.append(scan)
        seq += 1
    writer.close()
    if hasattr(source, "close"):
        source.close()
    if bridge is not None:
        import time
        time.sleep(0.2)   # let the last frames drain to the broker
        bridge.close()
    if args.out:
        np.savez_compressed(args.out, dmaps=np.stack(dmaps),
                            scans=np.stack(scans))
        print(f"wrote {args.out}")
    print(f"processed {seq} frames (engine={args.engine})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
