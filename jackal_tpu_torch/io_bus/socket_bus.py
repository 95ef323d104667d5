"""Cross-process topic transport: a minimal TCP broker + bus bridge.

The reference's L1 is ROS TCPROS between processes/machines — uvc_camera,
point_cloud and navigate each run as their own node against a ROS master
(launch/stereo.launch:1-14, README.md:19). This module gives the port the
same composition property: a `BusBroker` plays the master+router role, and a
`BusBridge` connects a process-local `TopicBus` to it, so

    python -m jackal_tpu_torch.cli.bus_broker --port 47311 &
    python -m jackal_tpu_torch.cli.point_cloud --bus 127.0.0.1:47311 ... &
    python -m jackal_tpu_torch.cli.navigate --bus 127.0.0.1:47311 ...

composes the two CLIs exactly like the two ROS nodes.

Wire format: 4-byte big-endian length + pickled {op, topic, msg} dict.
Messages are the io_bus.messages dataclasses (numpy payloads pickle fine);
a pickle names its class, so the port's processes talk to each other
through jackal_tpu_torch.io_bus.messages. The broker unpickles each frame
to read its op and topic, and sends it on as it came.
Subscriptions are broker-side routing state; a publisher's frames are
forwarded only to connections subscribed to that topic (like TCPROS
topic connections). Delivery into the receiving process re-publishes on its
local TopicBus, so queue-size-1 drop-stale semantics stay local, matching
the reference's subscriber queues (point_cloud.cpp:567-568).
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Dict, Iterable, Optional, Set

from .bus import TopicBus

_HDR = struct.Struct(">I")


def _send_frame(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Optional[Any]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    return pickle.loads(payload)


class BusBroker:
    """Topic router: accepts bridge connections, forwards published frames
    to every connection subscribed to the frame's topic."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen()
        self.host, self.port = self._srv.getsockname()
        self._lock = threading.Lock()
        self._subs: Dict[socket.socket, Set[str]] = {}
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._subs[conn] = set()
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def _client_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                frame = _recv_frame(conn)
                if frame is None:
                    break
                op = frame.get("op")
                if op == "sub":
                    with self._lock:
                        self._subs[conn].add(frame["topic"])
                elif op == "pub":
                    self._route(frame, conn)
        except OSError:
            pass
        finally:
            with self._lock:
                self._subs.pop(conn, None)
            conn.close()

    def _route(self, frame: Dict[str, Any], sender: socket.socket) -> None:
        topic = frame["topic"]
        with self._lock:
            targets = [c for c, topics in self._subs.items()
                       if topic in topics and c is not sender]
        for c in targets:
            try:
                _send_frame(c, frame)
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass


class BusBridge:
    """Connects a local TopicBus to a broker.

    publish_topics: local publications on these topics are forwarded to the
    broker. subscribe_topics: broker frames on these topics are re-published
    on the local bus (callbacks/queues fire as if published locally)."""

    def __init__(self, bus: TopicBus, address: str,
                 publish_topics: Iterable[str] = (),
                 subscribe_topics: Iterable[str] = (),
                 timeout: float = 10.0):
        host, port = address.rsplit(":", 1)
        self.bus = bus
        self._sock = socket.create_connection((host, int(port)), timeout)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._closed = False
        for t in subscribe_topics:
            with self._send_lock:
                _send_frame(self._sock, {"op": "sub", "topic": t})
        for t in publish_topics:
            bus.subscribe(t, self._forwarder(t))
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _forwarder(self, topic: str):
        def fwd(msg):
            if self._closed:
                return
            try:
                with self._send_lock:
                    _send_frame(self._sock,
                                {"op": "pub", "topic": topic, "msg": msg})
            except OSError:
                pass
        return fwd

    def _read_loop(self) -> None:
        while not self._closed:
            try:
                frame = _recv_frame(self._sock)
            except OSError:
                return
            if frame is None:
                return
            if frame.get("op") == "pub":
                self.bus.publish(frame["topic"], frame["msg"])

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
