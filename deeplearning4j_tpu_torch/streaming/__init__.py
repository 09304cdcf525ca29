"""Streaming ingest and online serving (the port of
`deeplearning4j_tpu/streaming/`).

Arrays travel as length-prefixed `.npy` messages over TCP: an 8-byte
big-endian length, then `np.save`'s bytes. The bytes are the JAX package's,
so a publisher of either package feeds a consumer or route of the other.
`NDArrayConsumer` listens, `NDArrayPublisher` connects and sends, and
`InferenceRoute` wires consumer -> restored model -> publisher (the
reference's `DL4jServeRouteBuilder`): each batch is one `model.output` call
on the model's device, the GPU unless the caller passes `device="cpu"`.
`topic.py` holds the durable counterparts (`FileTopic`, `TopicPublisher`,
`TopicConsumer`).
"""
from __future__ import annotations

import io
import logging
import queue
import socket
import struct
import threading
from typing import Optional

import numpy as np
import torch

from ..util.platform import DeviceLike

__all__ = ["NDArraySerde", "NDArrayConsumer", "NDArrayPublisher",
           "InferenceRoute"]

_log = logging.getLogger(__name__)


class NDArraySerde:
    """Array <-> bytes through the self-describing `.npy` format."""

    @staticmethod
    def to_bytes(arr: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr), allow_pickle=False)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> np.ndarray:
        return np.load(io.BytesIO(data), allow_pickle=False)


def _send_msg(sock: socket.socket, payload: bytes):
    sock.sendall(struct.pack(">Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    parts = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            return None
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def _recv_msg(sock: socket.socket) -> Optional[bytes]:
    head = _recv_exact(sock, 8)
    if head is None:
        return None
    (ln,) = struct.unpack(">Q", head)
    return _recv_exact(sock, ln)


class NDArrayConsumer:
    """Listens on a TCP port; received arrays are queued for `take()`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 queue_size: int = 64):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.host, self.port = self._srv.getsockname()
        self._q: queue.Queue = queue.Queue(queue_size)
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            # one daemon reader per connection; it ends with its socket
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: socket.socket):
        with conn:
            while not self._stop.is_set():
                try:
                    msg = _recv_msg(conn)
                except OSError:
                    return
                if msg is None:
                    return
                self._q.put(NDArraySerde.from_bytes(msg))

    def take(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NDArrayPublisher:
    """Connects to a consumer and publishes arrays."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def publish(self, arr: np.ndarray):
        _send_msg(self._sock, NDArraySerde.to_bytes(arr))

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _numpy(out: torch.Tensor) -> np.ndarray:
    """A model output as numpy (bf16, which numpy lacks, as float32)."""
    out = out.detach()
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()


class InferenceRoute:
    """Serve route: consume input arrays, run the model's `output()`,
    publish the predictions.

    `model_or_path` is a model object or a ModelSerializer zip, restored
    onto `device` (the GPU unless the caller passes `device="cpu"`). Use
    `start()` for the background route (consumer port -> `forward`
    publisher), or call `process(arr)` directly. A batch that fails is
    logged and dropped, and the route goes on serving."""

    def __init__(self, model_or_path, listen_port: int = 0,
                 forward: Optional[NDArrayPublisher] = None,
                 before_processing=None, device: DeviceLike = None):
        if isinstance(model_or_path, str):
            from ..util.serializer import ModelSerializer
            self.model = ModelSerializer.restore(model_or_path,
                                                 device=device)
        else:
            self.model = model_or_path
        self.consumer = NDArrayConsumer(port=listen_port)
        self.forward = forward
        self.before_processing = before_processing
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.consumer.port

    def process(self, arr: np.ndarray) -> np.ndarray:
        if self.before_processing is not None:
            arr = self.before_processing(arr)
        return _numpy(self.model.output(arr))

    def _loop(self):
        while not self._stop.is_set():
            arr = self.consumer.take(timeout=0.2)
            if arr is None:
                continue
            try:
                out = self.process(arr)
                if self.forward is not None:
                    self.forward.publish(out)
            except Exception:   # a bad batch must not kill the route
                _log.exception("InferenceRoute: dropping failed batch "
                               "(shape=%s)", getattr(arr, "shape", None))

    def start(self) -> "InferenceRoute":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.consumer.close()
