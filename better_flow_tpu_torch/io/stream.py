"""Socket event transport — the ROS pub/sub replacement for live pipelines.

The reference's only IPC is ROS topics carrying dvs_msgs::EventArray
(bf_visualizer.cpp:93-96).  Here a minimal length-prefixed binary protocol
over TCP (or Unix sockets) carries event batches:

    header:  uint32 magic 0x44565321 ('DVS!'), uint32 count
    payload: count * (float32 x, float32 y, int64 t_ns)

Intended for camera daemons / replay processes feeding a live
EventVisualizer on the same host or over the LAN.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Optional, Tuple

import numpy as np

MAGIC = 0x44565321
_HEADER = struct.Struct("<II")
_EVENT_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("t_ns", "<i8")])


def pack_events(x, y, t_ns) -> bytes:
    arr = np.empty(len(x), _EVENT_DTYPE)
    arr["x"] = x
    arr["y"] = y
    arr["t_ns"] = t_ns
    return _HEADER.pack(MAGIC, len(arr)) + arr.tobytes()


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def read_batch(sock: socket.socket) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    magic, count = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    payload = _recv_exact(sock, count * _EVENT_DTYPE.itemsize)
    if payload is None:
        return None
    arr = np.frombuffer(payload, _EVENT_DTYPE)
    return arr["x"].copy(), arr["y"].copy(), arr["t_ns"].copy()


class EventPublisher:
    """Send event batches to all connected subscribers."""

    def __init__(self, address=("127.0.0.1", 0)):
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(address)
        self._server.listen(8)
        self.address = self._server.getsockname()
        self._clients = []
        self._lock = threading.Lock()
        self._accepting = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._accepting:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            with self._lock:
                self._clients.append(conn)

    def publish(self, x, y, t_ns):
        data = pack_events(x, y, t_ns)
        with self._lock:
            alive = []
            for c in self._clients:
                try:
                    c.sendall(data)
                    alive.append(c)
                except OSError:
                    c.close()
            self._clients = alive

    def close(self):
        self._accepting = False
        self._server.close()
        with self._lock:
            for c in self._clients:
                c.close()
            self._clients = []


class EventSubscriber:
    """Receive event batches and hand them to a callback (or iterate)."""

    def __init__(self, address, on_batch: Optional[Callable] = None):
        self._sock = socket.create_connection(address)
        self.on_batch = on_batch

    def run(self, max_batches: Optional[int] = None) -> int:
        """Blocking receive loop; returns number of batches handled."""
        n = 0
        while max_batches is None or n < max_batches:
            batch = read_batch(self._sock)
            if batch is None:
                break
            if self.on_batch is not None:
                self.on_batch(*batch)
            n += 1
        return n

    def close(self):
        self._sock.close()
