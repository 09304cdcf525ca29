"""Cross-node time sources for distributed stats: the port's own copy of
`deeplearning4j_tpu/parallel/timesource.py`, which is framework-free.

Parity with the reference's Spark timing clock-alignment tier
(`dl4j-spark/src/main/java/org/deeplearning4j/spark/time/TimeSource.java`,
`SystemClockTimeSource.java`, `NTPTimeSource.java`,
`TimeSourceProvider.java`): multi-host phase stats are only comparable
across hosts if their clocks agree, so the reference periodically queries
an NTP server and applies the measured offset to every timestamp.

Form used here: no NTP dependency (the hosts may have no egress) — the
natural clock reference is rank 0's host, reachable over the same network
the `torch.distributed` rendezvous uses. The
`CoordinatorTimeSource` runs the classic NTP 4-timestamp exchange
(offset = ((t1-t0) + (t2-t3)) / 2) against a tiny time server on the
coordinator host, repeats it `samples` times and keeps the MINIMUM-DELAY
sample (NTP's clock-filter rule: the fastest round trip has the least
asymmetric queueing error), and refreshes every `frequency_sec`
(reference default: 30 min; env-overridable, like the reference's system
properties).
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Callable, Optional, Tuple

__all__ = ["TimeSource", "SystemClockTimeSource", "CoordinatorTimeSource",
           "TimeServer", "get_time_source"]

_PACK = struct.Struct(">dd")   # (t1 server-recv, t2 server-send)

FREQUENCY_ENV = "DL4J_TPU_TIMESOURCE_FREQUENCY_SEC"
SOURCE_ENV = "DL4J_TPU_TIMESOURCE"
SERVER_ENV = "DL4J_TPU_TIMESOURCE_SERVER"


class TimeSource:
    """`TimeSource.java` contract: milliseconds since epoch, offset-
    corrected where the implementation has one."""

    def current_time_millis(self) -> int:
        raise NotImplementedError

    def offset_ms(self) -> float:
        return 0.0


class SystemClockTimeSource(TimeSource):
    """`SystemClockTimeSource.java` — the local clock, no correction."""

    def current_time_millis(self) -> int:
        return int(time.time() * 1000)


class TimeServer:
    """Reference clock endpoint (run on the coordinator host): answers
    each 1-byte ping with (t1 recv-time, t2 send-time) — the server half
    of the NTP exchange."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 clock: Callable[[], float] = time.time):
        self._clock = clock
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dl4jtpu-timeserver")
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            # one daemon thread per connection with a recv timeout: a
            # stalled/half-open client must not block other hosts'
            # refreshes, and close() must not leave a handler stuck
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        with conn:
            conn.settimeout(5.0)
            while not self._stop.is_set():
                try:
                    if not conn.recv(1):
                        return
                    t1 = self._clock()
                    conn.sendall(_PACK.pack(t1, self._clock()))
                except socket.timeout:
                    continue   # idle keep-alive; re-check stop flag
                except OSError:
                    return

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


class CoordinatorTimeSource(TimeSource):
    """`NTPTimeSource.java` analog with the coordinator host as the
    reference clock. Offset is re-measured every `frequency_sec`
    (min-delay of `samples` exchanges); timestamps are local clock +
    offset, so phase stats from every process share process 0's
    timeline."""

    def __init__(self, host: str, port: int,
                 frequency_sec: Optional[float] = None,
                 samples: int = 8, timeout: float = 5.0,
                 clock: Callable[[], float] = time.time):
        self.host, self.port = host, int(port)
        if frequency_sec is None:
            frequency_sec = float(os.environ.get(FREQUENCY_ENV, 30 * 60))
        self.frequency_sec = max(1.0, float(frequency_sec))
        self.samples = max(1, int(samples))
        self.timeout = timeout
        self._clock = clock
        self._offset: Optional[float] = None
        self._measured_at = float("-inf")
        self._refreshing = False
        self._lock = threading.Lock()
        # Measure EAGERLY: an unreachable server fails here, at
        # construction, where it is unambiguously a configuration error —
        # not on the first stats.time() inside the training loop (which is
        # designed never to crash; review finding r4)
        self._refresh()

    # -- NTP exchange ----------------------------------------------------
    def _measure_once(self, sock) -> Tuple[float, float]:
        """(offset_sec, round_trip_delay_sec) from one exchange."""
        t0 = self._clock()
        sock.sendall(b"p")
        data = b""
        while len(data) < _PACK.size:
            chunk = sock.recv(_PACK.size - len(data))
            if not chunk:
                raise OSError("time server closed connection")
            data += chunk
        t3 = self._clock()
        t1, t2 = _PACK.unpack(data)
        return ((t1 - t0) + (t2 - t3)) / 2.0, (t3 - t0) - (t2 - t1)

    def _refresh(self):
        # the network exchange runs with NO lock held (graftlint:
        # blocking-call-under-lock) — only the publish of the measured
        # offset takes the lock, so concurrent offset_ms() readers are
        # never stalled behind a slow/unreachable time server
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout) as sock:
            best = None
            for _ in range(self.samples):
                off, delay = self._measure_once(sock)
                if best is None or delay < best[1]:
                    best = (off, delay)
        with self._lock:
            self._offset = best[0]
            self._measured_at = self._clock()

    def offset_ms(self) -> float:
        """Current offset. The first measurement happened in __init__
        (synchronous — a failure there is a config error and raises).
        Refreshes run on a background thread while the STALE offset keeps
        being served, and a refresh failure logs and keeps the last good
        value (reference behavior) — a dead time server can never crash
        the training loop or stall the stats hot path. The lock is held
        only for the state reads/flag flip; network I/O (the defensive
        re-measure included) always happens outside it."""
        with self._lock:
            offset = self._offset
            spawn = (offset is not None
                     and self._clock() - self._measured_at
                     > self.frequency_sec
                     and not self._refreshing)
            if spawn:
                self._refreshing = True
        if offset is None:            # defensive; __init__ measures
            self._refresh()
            with self._lock:
                offset = self._offset
        elif spawn:
            threading.Thread(target=self._refresh_bg,
                             daemon=True).start()
        return offset * 1000.0

    def _refresh_bg(self):
        import logging
        try:
            self._refresh()
        except OSError as e:
            logging.getLogger("deeplearning4j_tpu").warning(
                "time-source refresh failed (keeping stale offset "
                "%.1f ms): %s", (self._offset or 0.0) * 1e3, e)
            with self._lock:
                # back off a full period before retrying
                self._measured_at = self._clock()
        finally:
            self._refreshing = False

    def current_time_millis(self) -> int:
        return int(self._clock() * 1000 + self.offset_ms())


def get_time_source() -> TimeSource:
    """`TimeSourceProvider.getInstance` analog: selected via env —
    `DL4J_TPU_TIMESOURCE=coordinator` + `DL4J_TPU_TIMESOURCE_SERVER=
    host:port` for the offset-corrected source; default = system clock."""
    kind = os.environ.get(SOURCE_ENV, "system").lower()
    if kind == "coordinator":
        server = os.environ.get(SERVER_ENV)
        if not server:
            raise ValueError(
                f"{SOURCE_ENV}=coordinator requires {SERVER_ENV}=host:port")
        host, port = server.rsplit(":", 1)
        return CoordinatorTimeSource(host, int(port))
    if kind == "system":
        return SystemClockTimeSource()
    raise ValueError(f"unknown {SOURCE_ENV}={kind!r} "
                     "(expected 'system' or 'coordinator')")
