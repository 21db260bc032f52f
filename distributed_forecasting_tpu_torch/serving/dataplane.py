"""The scorer's HTTP data plane, server half (port of the reference's
``serving/dataplane.py``).

* :class:`HttpConfig` — the strict ``serving.http`` conf block (unknown
  keys raise, every field has a default);
* :class:`PooledHTTPServer` + :class:`KeepAliveHandlerMixin` — HTTP/1.1
  keep-alive with an idle timeout (a silent client cannot pin a worker),
  ``TCP_NODELAY`` on accepted sockets, a listen backlog sized for bursts,
  and a BOUNDED pool of pre-spawned worker threads in place of
  thread-per-request; the ``dftpu_http_workers_busy`` gauge reports how many
  are handling a request.  Shutdown stops admission, lets queued requests
  finish and closes keep-alive connections after their current request.

Not here: the client half (``ConnectionPool``, ``pooled_get`` and the
``_set_nodelay`` they call, which serve the fleet's front door; ROADMAP
Queue 1: P12), the thread sanitizer's ``attach`` calls (P12) and the
``http.conn_acquire`` span (P11).
``pool_size`` is parsed for the front door's outbound pool and read by
nothing here.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from http.server import ThreadingHTTPServer
from typing import Optional


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
