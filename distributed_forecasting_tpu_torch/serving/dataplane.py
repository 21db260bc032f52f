"""The scorer's HTTP data plane (port of the reference's
``serving/dataplane.py``), shared by the replica servers and the fleet's
front door.

* :class:`HttpConfig` — the strict ``serving.http`` conf block (unknown
  keys raise, every field has a default);
* :class:`ConnectionPool` + :func:`pooled_get` — the client half: bounded
  per-replica pools of persistent keep-alive ``HTTPConnection``s for the
  front door's forward, scatter and health legs (``serving/fleet.py``),
  ``TCP_NODELAY`` on every dialed socket (:func:`_set_nodelay`).  The lock
  only snapshots or updates the idle lists; connect, close and settimeout
  run outside it.  Telemetry: the ``dftpu_http_pool_{open,reused,evicted}
  _total`` counters and an ``http.conn_acquire`` span per checkout
  (``outcome`` ``reused`` | ``open``).  A half-closed pooled connection
  (the replica restarted, or its idle timer fired a beat before ours)
  fails on the NEXT request; callers that acquired a REUSED connection
  retry once on a fresh one before reporting failure (predict is
  idempotent), so the race never reaches a client;
* :class:`PooledHTTPServer` + :class:`KeepAliveHandlerMixin` — HTTP/1.1
  keep-alive with an idle timeout (a silent client cannot pin a worker),
  ``TCP_NODELAY`` on accepted sockets, a listen backlog sized for bursts,
  and a BOUNDED pool of pre-spawned worker threads in place of
  thread-per-request; the ``dftpu_http_workers_busy`` gauge reports how many
  are handling a request.  Shutdown stops admission, lets queued requests
  finish and closes keep-alive connections after their current request.

The thread sanitizer (``monitoring/sanitizer.py``, a no-op unless armed)
guards :class:`ConnectionPool`'s idle lists and closed flag with its
``_lock``.
"""

from __future__ import annotations

import dataclasses
import http.client
import queue
import socket
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from distributed_forecasting_tpu_torch.monitoring import sanitizer
from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.monitoring.trace import get_tracer
from distributed_forecasting_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass(frozen=True)
class HttpConfig:
    """The ``serving.http`` conf block (see conf/tasks/serve_config.yml)."""

    keepalive: bool = True        # HTTP/1.1 persistent connections
    pool_size: int = 8            # idle outbound connections kept per replica
    workers: int = 16             # bounded handler pool
    idle_timeout_s: float = 30.0  # reap keep-alive sockets idle this long

    def __post_init__(self):
        if self.pool_size < 1:
            raise ValueError(
                f"pool_size must be >= 1, got {self.pool_size}")
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.idle_timeout_s <= 0:
            raise ValueError(
                f"idle_timeout_s must be > 0, got {self.idle_timeout_s}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "HttpConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like pool_sizes must not silently fall back to defaults
            raise ValueError(
                f"unknown serving.http conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf
        }
        return cls(**kwargs)


def _set_nodelay(sock) -> None:
    """TCP_NODELAY on an outbound socket: a forwarded request is one small
    write followed by a read — Nagle would hold the tail segment for the
    peer's delayed ACK (up to ~40 ms) for no batching benefit."""
    if sock is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not a TCP socket (tests may inject fakes)


class ConnectionPool:
    """Bounded per-(host, port) pools of idle keep-alive connections.

    Thread-safety: ``_lock`` guards the idle lists and the closed flag; every blocking socket call
    — connect, close, settimeout — happens OUTSIDE the critical section on
    connections no other thread can reach (checked out, or popped for
    eviction).  LIFO checkout keeps the warmest socket in play and lets
    the cold end of the list age out via ``idle_timeout_s``.
    """

    def __init__(self, config: Optional[HttpConfig] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.config = config or HttpConfig()
        self.logger = get_logger("ConnectionPool")
        self._lock = threading.Lock()
        # (host, port) -> [(conn, released_at monotonic), ...] newest last
        self._idle: Dict[Tuple[str, int], List[tuple]] = {}
        self._closed = False
        r = registry if registry is not None else MetricsRegistry()
        self.registry = r
        self.opened = r.counter(
            "dftpu_http_pool_open_total",
            "outbound connections the pool dialed fresh")
        self.reused = r.counter(
            "dftpu_http_pool_reused_total",
            "checkouts served by an idle keep-alive connection")
        self.evicted = r.counter(
            "dftpu_http_pool_evicted_total",
            "pooled connections closed instead of reused (unhealthy "
            "release, idle expiry, overflow, breaker/drain purge)")
        # dftsan (no-op unless DFTPU_TSAN armed): the idle lists every
        # forward / probe / scatter leg checks out of concurrently
        sanitizer.attach(self, cls=ConnectionPool, guards={
            "_lock": ("_idle", "_closed")})

    def acquire(self, host: str, port: int, timeout: float):
        """Check out a connection to ``host:port`` -> ``(conn, reused)``.

        ``reused`` tells the caller whether a request failure may be the
        half-closed-keep-alive race (retry once fresh) or a real peer
        failure (report it).  The checkout is traced as
        ``http.conn_acquire`` with the reuse outcome."""
        with get_tracer().span("http.conn_acquire", port=int(port)) as span:
            conn = None
            expired: List = []
            if self.config.keepalive:
                now = time.monotonic()
                with self._lock:
                    bucket = self._idle.get((host, int(port)))
                    while bucket:
                        cand, released_at = bucket.pop()
                        if now - released_at <= self.config.idle_timeout_s:
                            conn = cand
                            break
                        expired.append(cand)
            for cand in expired:  # close outside the lock
                self.evicted.inc()
                cand.close()
            if conn is not None:
                self.reused.inc()
                span.set_attribute("outcome", "reused")
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn, True
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
            conn.connect()
            _set_nodelay(conn.sock)
            self.opened.inc()
            span.set_attribute("outcome", "open")
            return conn, False

    def release(self, conn, healthy: bool = True) -> None:
        """Return a checked-out connection.  Only a healthy one (response
        fully read, server not closing — ``not resp.will_close``) is
        pooled; everything else closes.  Overflow beyond ``pool_size``
        closes the returned connection (the newest-released socket is the
        one most likely to be reaped by the peer's idle timer anyway)."""
        if not self.config.keepalive or not healthy:
            if self.config.keepalive:
                self.evicted.inc()
            conn.close()
            return
        pooled = False
        with self._lock:
            if not self._closed:
                bucket = self._idle.setdefault(
                    (conn.host, int(conn.port)), [])
                if len(bucket) < self.config.pool_size:
                    bucket.append((conn, time.monotonic()))
                    pooled = True
        if not pooled:
            self.evicted.inc()
            conn.close()

    def discard(self, conn) -> None:
        """Drop a checked-out connection that failed mid-request."""
        self.evicted.inc()
        conn.close()

    def drain(self, host: str, port: int) -> int:
        """Close every idle connection to one replica — called when its
        breaker opens, its process is killed, or a forward fails at the
        connection level: the pooled sockets point at a peer that just
        proved unreliable, and the next checkout should dial fresh."""
        with self._lock:
            bucket = self._idle.pop((host, int(port)), [])
        for conn, _ in bucket:
            self.evicted.inc()
            conn.close()
        return len(bucket)

    def close(self) -> None:
        """Close every idle connection and refuse future pooling (in-flight
        checkouts finish and close on release)."""
        with self._lock:
            self._closed = True
            buckets = list(self._idle.values())
            self._idle = {}
        for bucket in buckets:
            for conn, _ in bucket:
                self.evicted.inc()
                conn.close()

    def idle_count(self, host: str, port: int) -> int:
        with self._lock:
            return len(self._idle.get((host, int(port)), ()))


def pooled_get(pool: ConnectionPool, host: str, port: int, path: str,
               timeout: float):
    """One GET over the pool -> ``(status, body)``.

    Retries once on a fresh connection when a REUSED socket fails (the
    half-closed keep-alive race); a fresh-connection failure propagates —
    that is a real peer failure the caller must account."""
    for attempt in (0, 1):
        conn, reused = pool.acquire(host, port, timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
        except (OSError, http.client.HTTPException):
            pool.discard(conn)
            if reused and attempt == 0:
                continue
            raise
        pool.release(conn, healthy=not resp.will_close)
        return resp.status, body


class KeepAliveHandlerMixin:
    """Mix into a ``BaseHTTPRequestHandler`` serving from a
    :class:`PooledHTTPServer`: HTTP/1.1 persistent connections with an
    idle timeout, and ``TCP_NODELAY`` on the accepted socket."""

    #: socketserver.StreamRequestHandler: setsockopt(TCP_NODELAY) in setup()
    disable_nagle_algorithm = True

    def setup(self):
        http_cfg = getattr(self.server, "http", None)
        if http_cfg is not None and http_cfg.keepalive:
            # per instance (the class default stays HTTP/1.0, so
            # keepalive=false closes after each request).  The timeout is
            # set before super().setup() applies it to the socket: an idle
            # keep-alive client frees its worker after idle_timeout_s.
            self.protocol_version = "HTTP/1.1"
            self.timeout = http_cfg.idle_timeout_s
        super().setup()

    def handle_one_request(self):
        super().handle_one_request()
        if getattr(self.server, "_pool_draining", False):
            # drain: finish the in-flight request, then close the connection
            self.close_connection = True


class PooledHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a BOUNDED pre-spawned worker pool.

    ``http.workers`` daemon threads take accepted connections off a bounded
    queue (when it is full the accept loop waits, and the kernel's listen
    backlog holds the rest).  Daemon threads, not a ``ThreadPoolExecutor``:
    executor workers are joined at interpreter exit, and one blocked in an
    idle keep-alive read would hang the process's exit.
    """

    daemon_threads = True
    # socketserver's default backlog is 5: a burst would get kernel resets
    # before a worker ran; shedding load is the batcher's 429
    request_queue_size = 512

    def __init__(self, addr, handler_cls,
                 http: Optional[HttpConfig] = None):
        super().__init__(addr, handler_cls)
        self.http = http or HttpConfig()
        # set by the owner once its metrics exist; None = no telemetry
        self.busy_gauge = None
        self._pool_draining = False
        self._work: queue.Queue = queue.Queue(maxsize=self.http.workers * 4)
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"http-worker-{i}", daemon=True)
            for i in range(self.http.workers)
        ]
        for t in self._workers:
            t.start()

    def process_request(self, request, client_address):
        """Accept-loop side: enqueue instead of spawning a thread.  A full
        queue blocks the accept loop in short waits, so a drain wakes it."""
        while True:
            if self._pool_draining:
                self.shutdown_request(request)
                return
            try:
                self._work.put((request, client_address), timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker_loop(self):
        while True:
            item = self._work.get()
            if item is None:
                return
            request, client_address = item
            gauge = self.busy_gauge
            if gauge is not None:
                gauge.inc()
            try:
                # mirror ThreadingMixIn.process_request_thread
                try:
                    self.finish_request(request, client_address)
                except Exception:  # noqa: BLE001 — a worker outlives one bad request
                    self.handle_error(request, client_address)
                finally:
                    self.shutdown_request(request)
            finally:
                if gauge is not None:
                    gauge.dec()

    def shutdown(self):
        """Stop admission, let queued requests finish, and release the
        workers (keep-alive connections close after their current request,
        :meth:`KeepAliveHandlerMixin.handle_one_request`)."""
        self._pool_draining = True
        super().shutdown()
        for _ in self._workers:
            try:
                # FIFO: the sentinels land behind queued requests, so the
                # drain serves those first; a full queue is fine, the
                # workers are daemon threads
                self._work.put_nowait(None)
            except queue.Full:
                break
