"""Streaming node loop: batched ELAS on a frame stream, published per frame.

The reference overlaps its stages by ROS process pipelining. Here one host
process keeps the card fed: frames are gathered into batches, rectified on
the card, and run through matching.elas.pipeline.elas_match_stream, which
keeps two batches in flight so one batch's host prior (support
pruning, Delaunay) overlaps the card's work on the batch before. Every
frame's depth map and obstacle scan are published on the topic bus under
the reference's topic names, in order, by a publisher thread that waits
only for its own batch's copies to the host.

Per-stage times: every stage_sample_every-th batch is timed with device
synchronizes: dmap = the batch interval up to its disparity maps, per
frame (what a consumer of the depth topic sees in the stream), scan = the
scan stage, per frame. Other batches log nothing.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Iterable, Optional, Tuple

import numpy as np

from ..io_bus.bus import TopicBus
from ..io_bus.messages import Header, Image, JackalTimeLog, LaserScan
from ..io_bus.timelog import TimeLogWriter
from ..matching.elas.pipeline import elas_match_stream
from ..ops.transfer import HostCopy, to_device
from ..scan.obstacle import format_laser_scan_ranges
from .frame_pipeline import StereoPipeline

TOPIC_DEPTH = "/webcam/left/depth_map"
TOPIC_SCAN = "/webcam/left/obstacle_scan"
TOPIC_TIMELOG = "/jackal/time_log"


class StreamingRunner:
    """The point_cloud node's --batch > 1 loop on a StereoPipeline."""

    def __init__(self, pipeline: StereoPipeline,
                 bus: Optional[TopicBus] = None, batch_size: int = 8,
                 timelog: Optional[TimeLogWriter] = None,
                 stage_sample_every: int = 8):
        self.pipe = pipeline
        self.bus = bus or TopicBus()
        self.B = batch_size
        self.timelog = timelog
        self.stage_sample_every = max(stage_sample_every, 1)
        self.depth_pub = self.bus.advertise(TOPIC_DEPTH)
        self.scan_pub = self.bus.advertise(TOPIC_SCAN)
        self.tl_pub = self.bus.advertise(TOPIC_TIMELOG)
        self.seq = 0
        self.batch_no = 0

    def _publish(self, dmaps: np.ndarray, scans, stage_times=None) -> None:
        """dmaps [n, H, W] uint8; scans: (scan [n, bins], angle_min,
        angle_max, range_min, range_max [n]) as numpy arrays."""
        scan, a_min, a_max, r_min, r_max = scans
        for i in range(len(dmaps)):
            hdr = Header.now(self.seq, "jackal")
            self.depth_pub.publish(Image(hdr, dmaps[i].shape[0],
                                         dmaps[i].shape[1], "mono8",
                                         dmaps[i]))
            self.scan_pub.publish(LaserScan(
                hdr, float(a_min[i]), float(a_max[i]), 3.1415 / 180.0, 0.1,
                0.001, float(r_min[i]), float(r_max[i]),
                format_laser_scan_ranges(scan[i]).tolist()))
            if stage_times is not None:
                dmap_t, pcl_t, scan_t = stage_times
                if self.timelog is not None:
                    self.timelog.log("dmap", dmap_t)
                    self.timelog.log("scan", scan_t)
                self.tl_pub.publish(JackalTimeLog(hdr, pcl_t, scan_t, dmap_t))
            self.seq += 1

    def _run_elas_stream(self, stream: Iterable[Tuple[np.ndarray, ...]],
                         max_frames: Optional[int] = None) -> int:
        pipe = self.pipe
        dev = pipe.device
        B = self.B
        it = iter(stream)
        meta: deque = deque()
        taken = 0

        def take_batch():
            nonlocal taken
            lefts, rights = [], []
            while len(lefts) < B:
                if max_frames is not None and taken + len(lefts) >= max_frames:
                    break
                frame = next(it, None)
                if frame is None:
                    break
                lefts.append(frame[0])
                rights.append(frame[1])
            if not lefts:
                return None
            n = len(lefts)
            taken += n
            while len(lefts) < B:        # pad to the batch shape
                lefts.append(lefts[-1])
                rights.append(rights[-1])
            return np.stack(lefts), np.stack(rights), n

        def pairs():
            while True:
                nxt = take_batch()
                if nxt is None:
                    return
                lb, rb, n = nxt
                meta.append(n)
                yield pipe._rectify_crop(to_device(lb, dev)[0],
                                         to_device(rb, dev)[0])

        # the chunk rule of process_batch: the device tail costs about the
        # same per chunk whatever its size (it is launch-bound), so fewer,
        # larger chunks are faster
        chunk = max(c for c in (1, 2, 4, 8) if B % c == 0 and c <= B)
        q: "queue.Queue" = queue.Queue(maxsize=2)
        err: list = []

        def publisher():
            while True:
                item = q.get()
                if item is None:
                    return
                dmaps, scans, n, stage_times = item
                try:
                    self._publish(dmaps.numpy()[:n],
                                  [s.numpy()[:n] for s in scans], stage_times)
                except BaseException as e:   # raised on the caller's thread
                    err.append(e)

        done = 0
        t_last = time.perf_counter()
        pub_thread = threading.Thread(target=publisher, daemon=True)
        pub_thread.start()
        try:
            for D1, _ in elas_match_stream(pairs(), pipe.elas_params,
                                           chunk=chunk, device=dev):
                n = meta.popleft()
                sampled = self.batch_no % self.stage_sample_every == 0
                self.batch_no += 1
                dmaps = pipe._dmap_u8(D1)
                stage_times = None
                if sampled:
                    t1 = pipe._sync(True)
                    dmap_t = (t1 - t_last) / B
                scans = pipe._scan_stage(dmaps)
                if sampled:
                    stage_times = (dmap_t, 0.0, (pipe._sync(True) - t1) / B)
                if err:
                    raise err[0]
                q.put((HostCopy(dmaps),
                       [HostCopy(x) for x in (scans.scan, scans.angle_min,
                                              scans.angle_max,
                                              scans.range_min,
                                              scans.range_max)],
                       n, stage_times))
                done += n
                t_last = time.perf_counter()
        finally:
            q.put(None)
            pub_thread.join()
        if err:
            raise err[0]
        return done

    def run(self, stream: Iterable[Tuple[np.ndarray, ...]],
            max_frames: Optional[int] = None) -> int:
        """Consume (left, right) raw uint8 frames; returns the number of
        frames published."""
        if self.pipe.engine != "elas":
            raise NotImplementedError(
                "the streaming loop of the BM/SGM engines waits for their "
                "slice of the port (ROADMAP Queue 1, items 2-3)")
        return self._run_elas_stream(stream, max_frames)
