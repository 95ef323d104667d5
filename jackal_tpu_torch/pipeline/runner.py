"""Streaming node loop: batched disparity on a frame stream, published
per frame.

The reference overlaps its stages by ROS process pipelining. Here one host
process keeps the card fed: frames are gathered into batches and
rectified on the card. ELAS runs them through
matching.elas.pipeline._elas_stream_u8 (elas_match_stream's u8 maps, from
the epilogue of the postprocess's last kernel), which keeps two batches in
flight so one batch's host prior (support pruning, Delaunay) overlaps the
card's work on the batch before. SGM runs
StereoPipeline.process_batch_fused on batch k+1 while batch k is
published. Every frame's depth map and obstacle scan are published on the
topic bus under the reference's topic names, in order, by a publisher
thread that waits only for its own batch's copies to the host. BM runs
as SGM does, and so does ELAS with elas_stream=False (process_batch(_pcl)
a batch, with no stage times). With gen_pcl, frames may be (left, right,
color_bgr), each frame's compacted cloud is published too, and the scan
comes from the cloud's points.

Per-stage times: every stage_sample_every-th batch is timed with device
synchronizes, per frame. ELAS: dmap = the batch interval up to its
disparity maps (what a consumer of the depth topic sees in the stream),
pcl = the cloud stage, scan = the scan stage. SGM and BM: the sampled batch
runs process_batch_fused(_pcl) with timing, dmap = rectified pair to u8
maps, pcl = the cloud, scan = the scan stage. With gen_pcl the cloud and
its scan are one fused launch: pcl carries it, scan is what remains after
it. Other batches log nothing.
"""
from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from collections import deque
from typing import Iterable, Optional, Tuple

import numpy as np

from ..io_bus.bus import TopicBus
from ..io_bus.messages import Header, Image, JackalTimeLog, LaserScan
from ..io_bus.timelog import TimeLogWriter
from ..matching.elas.pipeline import _elas_stream_u8
from ..ops.transfer import HostCopy, to_device
from ..scan.obstacle import compact_cloud_msg, format_laser_scan_ranges
from .frame_pipeline import StereoPipeline

TOPIC_DEPTH = "/webcam/left/depth_map"
TOPIC_SCAN = "/webcam/left/obstacle_scan"
TOPIC_PCL = "/webcam/left/point_cloud"
TOPIC_TIMELOG = "/jackal/time_log"


class StreamingRunner:
    """The point_cloud node's --batch > 1 loop on a StereoPipeline."""

    def __init__(self, pipeline: StereoPipeline,
                 bus: Optional[TopicBus] = None, batch_size: int = 8,
                 timelog: Optional[TimeLogWriter] = None,
                 stage_sample_every: int = 8, elas_stream: bool = True):
        self.pipe = pipeline
        self.elas_stream = elas_stream
        self.used_elas_stream = False
        self.bus = bus or TopicBus()
        self.B = batch_size
        self.timelog = timelog
        self.stage_sample_every = max(stage_sample_every, 1)
        self.depth_pub = self.bus.advertise(TOPIC_DEPTH)
        self.scan_pub = self.bus.advertise(TOPIC_SCAN)
        self.pcl_pub = self.bus.advertise(TOPIC_PCL)
        self.tl_pub = self.bus.advertise(TOPIC_TIMELOG)
        self.seq = 0
        self.batch_no = 0

    def _publish(self, dmaps: np.ndarray, scans, stage_times=None,
                 cloud=None) -> None:
        """dmaps [n, H, W] uint8; scans: (scan [n, bins], angle_min,
        angle_max, range_min, range_max [n]); cloud: None or (points,
        rgb, valid) [n, ...]; all numpy arrays."""
        scan, a_min, a_max, r_min, r_max = scans
        for i in range(len(dmaps)):
            hdr = Header.now(self.seq, "jackal")
            self.depth_pub.publish(Image(hdr, dmaps[i].shape[0],
                                         dmaps[i].shape[1], "mono8",
                                         dmaps[i]))
            if cloud is not None:
                self.pcl_pub.publish(compact_cloud_msg(
                    hdr, tuple(x[i] for x in cloud)))
            self.scan_pub.publish(LaserScan(
                hdr, float(a_min[i]), float(a_max[i]), 3.1415 / 180.0, 0.1,
                0.001, float(r_min[i]), float(r_max[i]),
                format_laser_scan_ranges(scan[i]).tolist()))
            if stage_times is not None:
                dmap_t, pcl_t, scan_t = stage_times
                if self.timelog is not None:
                    self.timelog.log("dmap", dmap_t)
                    if cloud is not None:
                        self.timelog.log("pcl", pcl_t)
                    self.timelog.log("scan", scan_t)
                self.tl_pub.publish(JackalTimeLog(hdr, pcl_t, scan_t, dmap_t))
            self.seq += 1

    def _batches(self, stream: Iterable[Tuple[np.ndarray, ...]],
                 max_frames: Optional[int]):
        """(left [B, H, W], right, color [B, H, W, 3] or None, n): the
        stream's (left, right[, color_bgr]) frames in batches of B, at most
        max_frames in all; a short last batch holds n frames and is padded
        to the batch shape with its last one. Colours are kept with
        gen_pcl when the frames carry them."""
        it = iter(stream)
        taken = 0
        while max_frames is None or taken < max_frames:
            want = self.B if max_frames is None \
                else min(self.B, max_frames - taken)
            frames = list(itertools.islice(it, want))
            if not frames:
                return
            n = len(frames)
            taken += n
            frames += [frames[-1]] * (self.B - n)
            color = (np.stack([f[2] for f in frames])
                     if self.pipe.p.gen_pcl and len(frames[0]) > 2 else None)
            yield (np.stack([f[0] for f in frames]),
                   np.stack([f[1] for f in frames]), color, n)

    def _run_elas_stream(self, stream: Iterable[Tuple[np.ndarray, ...]],
                         max_frames: Optional[int] = None) -> int:
        pipe = self.pipe
        dev = pipe.device
        B = self.B
        meta: deque = deque()

        def pairs():
            for lb, rb, cb, n in self._batches(stream, max_frames):
                meta.append((n, cb))
                yield pipe._rectify_crop(to_device(lb, dev)[0],
                                         to_device(rb, dev)[0])

        # the chunk rule of process_batch: the device tail costs about the
        # same per chunk whatever its size (it is launch-bound), so fewer,
        # larger chunks are faster
        chunk = max(c for c in (1, 2, 4, 8) if B % c == 0 and c <= B)
        done = 0
        t_last = time.perf_counter()
        with self._ordered_publisher() as publish:
            for dmaps in _elas_stream_u8(pairs(), pipe.elas_params,
                                         chunk=chunk, device=dev):
                n, cb = meta.popleft()
                sampled = self.batch_no % self.stage_sample_every == 0
                self.batch_no += 1
                stage_times = cloud = None
                t1 = pipe._sync(sampled)
                if pipe.p.gen_pcl:          # the fused cloud and scan
                    cloud, scans = pipe._cloud_scan(
                        dmaps, None if cb is None else to_device(cb, dev)[0])
                t2 = pipe._sync(sampled)
                if not pipe.p.gen_pcl:
                    scans = pipe._scan_stage(dmaps)
                if sampled:
                    stage_times = ((t1 - t_last) / B,
                                   (t2 - t1) / B if pipe.p.gen_pcl else 0.0,
                                   (pipe._sync(True) - t2) / B)
                publish(dmaps, scans, n, stage_times, cloud)
                done += n
                t_last = time.perf_counter()
        return done

    @contextlib.contextmanager
    def _ordered_publisher(self):
        """Yields publish(dmaps, scans, n, stage_times, cloud=None): starts
        the copies of a batch's first n u8 maps, scans and clouds to the
        host and queues them for a thread that publishes them in order,
        waiting only on those copies. At most two batches wait; an error of
        the thread is raised on the caller's at its next publish or on
        leaving."""
        q: "queue.Queue" = queue.Queue(maxsize=2)
        err: list = []

        def publisher():
            while True:
                item = q.get()
                if item is None:
                    return
                dmaps, scans, n, stage_times, cloud = item
                try:
                    self._publish(
                        dmaps.numpy()[:n], [s.numpy()[:n] for s in scans],
                        stage_times,
                        None if cloud is None
                        else [c.numpy()[:n] for c in cloud])
                except BaseException as e:   # raised on the caller's thread
                    err.append(e)

        def publish(dmaps, scans, n, stage_times, cloud=None):
            if err:
                raise err[0]
            q.put((HostCopy(dmaps),
                   [HostCopy(x) for x in (scans.scan, scans.angle_min,
                                          scans.angle_max, scans.range_min,
                                          scans.range_max)],
                   n, stage_times,
                   None if cloud is None else [HostCopy(c) for c in cloud]))

        pub_thread = threading.Thread(target=publisher, daemon=True)
        pub_thread.start()
        try:
            yield publish
        finally:
            q.put(None)
            pub_thread.join()
        if err:
            raise err[0]

    def _run_batches(self, stream: Iterable[Tuple[np.ndarray, ...]],
                     max_frames: Optional[int] = None) -> int:
        """The SGM and BM loop, and ELAS's without the stream scheduler:
        batch k+1 on the device while the publisher thread waits for batch
        k's copies and publishes it."""
        pipe = self.pipe
        dev = pipe.device
        done = 0
        with self._ordered_publisher() as publish:
            for lb, rb, cb, n in self._batches(stream, max_frames):
                sampled = self.batch_no % self.stage_sample_every == 0
                self.batch_no += 1
                left, right = to_device(lb, dev)[0], to_device(rb, dev)[0]
                color = None if cb is None else to_device(cb, dev)[0]
                if pipe.engine == "elas":   # no stage times without syncs
                    stage_times = None
                    if pipe.p.gen_pcl:
                        dmaps, cloud, scans = pipe.process_batch_pcl(
                            left, right, color)
                    else:
                        cloud = None
                        dmaps, scans = pipe.process_batch(left, right)
                elif pipe.p.gen_pcl:
                    dmaps, cloud, scans, *times = pipe.process_batch_fused_pcl(
                        left, right, color, timing=sampled)
                    stage_times = times[0] if sampled else None
                else:
                    cloud = None
                    dmaps, scans, *times = pipe.process_batch_fused(
                        left, right, timing=sampled)
                    stage_times = (times[0][0], 0.0, times[0][1]) \
                        if sampled else None
                publish(dmaps, scans, n, stage_times, cloud)
                done += n
        return done

    def run(self, stream: Iterable[Tuple[np.ndarray, ...]],
            max_frames: Optional[int] = None) -> int:
        """Consume (left, right) raw uint8 frames, or (left, right,
        color_bgr) with gen_pcl; returns the number of frames published.
        ELAS runs on the stream scheduler unless elas_stream=False."""
        if self.pipe.engine == "elas" and self.elas_stream:
            self.used_elas_stream = True
            return self._run_elas_stream(stream, max_frames)
        return self._run_batches(stream, max_frames)
