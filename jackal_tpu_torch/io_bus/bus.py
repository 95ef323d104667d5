"""In-process topic bus (the transport layer replacing ROS TCPROS).

The reference's distributed backend is ROS pub/sub between processes;
here a single host process feeds the card, with stage outputs exposed on
a topic bus that keeps the reference's topic names:

  /webcam/left/image_raw/compressed   /webcam/left/depth_map
  /webcam/left/point_cloud            /webcam/left/obstacle_scan
  /jackal/time_log                    /jackal_velocity_controller/cmd_vel

Queue-size-1 drop-stale backpressure (point_cloud.cpp:567-568) is the
default, matching the reference's latest-frame-wins behavior. Thread-safe;
subscribers run on the publisher's thread (like single-threaded ros::spin)
unless a queue is used for cross-thread handoff.
"""
from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Any, Callable, Deque, Dict, List, Optional


class TopicBus:
    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self._queues: Dict[str, Deque[Any]] = {}
        self._latest: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def advertise(self, topic: str) -> "Publisher":
        return Publisher(self, topic)

    def subscribe(self, topic: str, callback: Callable[[Any], None]) -> None:
        with self._lock:
            self._subs[topic].append(callback)

    def subscribe_queue(self, topic: str, maxlen: int = 1) -> "Subscription":
        """Queue-size-N subscription; maxlen=1 == drop-stale (reference
        default)."""
        q: Deque[Any] = deque(maxlen=maxlen)
        with self._lock:
            self._queues[topic] = q
        return Subscription(self, topic, q)

    def publish(self, topic: str, msg: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(topic, ()))
            q = self._queues.get(topic)
            self._latest[topic] = msg
            if q is not None:
                q.append(msg)
        for cb in subs:
            cb(msg)

    def latest(self, topic: str) -> Optional[Any]:
        with self._lock:
            return self._latest.get(topic)


class Publisher:
    def __init__(self, bus: TopicBus, topic: str):
        self.bus = bus
        self.topic = topic

    def publish(self, msg: Any) -> None:
        self.bus.publish(self.topic, msg)


class Subscription:
    def __init__(self, bus: TopicBus, topic: str, q: Deque[Any]):
        self.bus = bus
        self.topic = topic
        self._q = q

    def pop(self) -> Optional[Any]:
        try:
            return self._q.popleft()
        except IndexError:
            return None

    def __len__(self) -> int:
        return len(self._q)
