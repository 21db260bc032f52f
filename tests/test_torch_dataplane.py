"""The client half of the port's data plane (``serving/dataplane.py``):
``ConnectionPool``, ``pooled_get`` and ``_set_nodelay``, as the
reference's tests hold them.

The pool reuses idle keep-alive connections (counted, ``TCP_NODELAY`` on
every dialed socket) and traces each checkout as an ``http.conn_acquire``
span with its outcome; idle expiry, overflow and unhealthy releases evict;
a reused socket the server half-closed is retried once on a fresh one, so
the caller sees a 200; keep-alive off never pools.  In the fleet a
connection-level failure, an opened breaker and a drain each empty the
replica's idle connections.  The pool's counters carry the reference's
names, types and help texts.
"""

import http.client
import json
import socket
import threading
import time

import pytest
import torch

from distributed_forecasting_tpu.serving import dataplane as jdp
from distributed_forecasting_tpu_torch.monitoring.trace import (
    TraceConfig,
    configure_tracing,
)
from distributed_forecasting_tpu_torch.serving.dataplane import (
    ConnectionPool,
    HttpConfig,
    KeepAliveHandlerMixin,
    PooledHTTPServer,
    _set_nodelay,
    pooled_get,
)
from distributed_forecasting_tpu_torch.serving.resilience import (
    OPEN,
    ResilienceConfig,
)

from test_torch_fleet import _boot

torch.set_num_threads(1)


def _echo_server(http=None):
    """A minimal keep-alive GET server on the port's PooledHTTPServer."""
    from http.server import BaseHTTPRequestHandler

    class Handler(KeepAliveHandlerMixin, BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = json.dumps(
                {"port": self.server.server_address[1]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = PooledHTTPServer(("127.0.0.1", 0), Handler,
                           http=http or HttpConfig(workers=2))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def echo():
    srv = _echo_server()
    try:
        yield srv.server_address
    finally:
        srv.shutdown()
        srv.server_close()


def test_pool_counters_match_the_reference():
    def families(pool_cls):
        return pool_cls(HttpConfig()).registry.render_prometheus()
    assert families(ConnectionPool) == families(jdp.ConnectionPool)


def test_reuse_is_counted_traced_and_nodelay(echo):
    host, port = echo
    tracer = configure_tracing(TraceConfig(enabled=True))
    pool = ConnectionPool(HttpConfig(pool_size=2))
    try:
        with tracer.root_span("test.root", trace_id="pool-1"):
            status, body = pooled_get(pool, host, port, "/x", timeout=5.0)
            assert status == 200 and json.loads(body)["port"] == port
            assert pooled_get(pool, host, port, "/x", timeout=5.0)[0] == 200
        assert (int(pool.opened.value), int(pool.reused.value)) == (1, 1)
        spans = [s for s in tracer.recorder.snapshot()
                 if s.name == "http.conn_acquire"]
        assert [s.attrs["outcome"] for s in spans] == ["open", "reused"]
        assert all(s.attrs["port"] == port for s in spans)
        conn, reused = pool.acquire(host, port, timeout=5.0)
        assert reused and conn.sock.getsockopt(
            socket.IPPROTO_TCP, socket.TCP_NODELAY) != 0
        pool.release(conn)
        _set_nodelay(None)  # a missing socket is a no-op
    finally:
        pool.close()
        configure_tracing(TraceConfig())


def test_idle_expiry_overflow_and_unhealthy_release(echo):
    host, port = echo
    pool = ConnectionPool(HttpConfig(pool_size=1, idle_timeout_s=0.05))
    try:
        pooled_get(pool, host, port, "/x", timeout=5.0)
        time.sleep(0.1)
        pooled_get(pool, host, port, "/x", timeout=5.0)
        assert (int(pool.opened.value), int(pool.reused.value),
                int(pool.evicted.value)) == (2, 0, 1)
        c1, _ = pool.acquire(host, port, timeout=5.0)
        c2, _ = pool.acquire(host, port, timeout=5.0)
        evicted = int(pool.evicted.value)
        pool.release(c1)
        pool.release(c2)
        assert pool.idle_count(host, port) == 1
        assert int(pool.evicted.value) == evicted + 1
        c3, _ = pool.acquire(host, port, timeout=5.0)
        assert pool.drain(host, port) == 0
        pool.release(c3, healthy=False)
        assert pool.idle_count(host, port) == 0
    finally:
        pool.close()
    assert pool.idle_count(host, port) == 0


def test_keepalive_off_never_pools(echo):
    host, port = echo
    pool = ConnectionPool(HttpConfig(keepalive=False))
    try:
        pooled_get(pool, host, port, "/x", timeout=5.0)
        pooled_get(pool, host, port, "/x", timeout=5.0)
        assert (int(pool.opened.value), int(pool.reused.value)) == (2, 0)
        assert pool.idle_count(host, port) == 0
    finally:
        pool.close()


def test_a_half_closed_reused_socket_is_retried_fresh():
    srv = _echo_server(HttpConfig(workers=2, idle_timeout_s=0.2))
    host, port = srv.server_address
    pool = ConnectionPool(HttpConfig(pool_size=2, idle_timeout_s=30.0))
    try:
        assert pooled_get(pool, host, port, "/x", timeout=5.0)[0] == 200
        time.sleep(0.6)  # the server reaps its side; our idle entry stays
        status, body = pooled_get(pool, host, port, "/x", timeout=5.0)
        assert status == 200 and json.loads(body)["port"] == port
        assert int(pool.evicted.value) >= 1 and int(pool.opened.value) == 2
    finally:
        pool.close()
        srv.shutdown()
        srv.server_close()
    with pytest.raises(OSError):  # a fresh connection's failure propagates
        pooled_get(ConnectionPool(), host, port, "/x", timeout=1.0)


def _prime(sup, front):
    conn = http.client.HTTPConnection(*front.server_address, timeout=10)
    try:
        for _ in range(4):
            conn.request("POST", "/invocations", body=b"{}",
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 200
    finally:
        conn.close()
    return {p: sup.pool.idle_count("127.0.0.1", p) for p in sup.all_ports()}


def test_failure_breaker_and_stop_drain_the_replica_pool():
    sup, front, _ = _boot(poll_s=60.0, resilience=ResilienceConfig(
        breaker_failures=1, breaker_open_s=60.0))
    try:
        idle = _prime(sup, front)
        a, b = sup.all_ports()
        assert idle[a] >= 1 and idle[b] >= 1, idle
        sup.report_failure(a)
        assert sup.pool.idle_count("127.0.0.1", a) == 0
        assert sup.pool.idle_count("127.0.0.1", b) == idle[b]
        sup.breaker_failure(b)
        assert sup.breaker_for(b).state == OPEN
        assert sup.pool.idle_count("127.0.0.1", b) == 0
    finally:
        front.shutdown()
        sup.stop()
    assert all(sup.pool.idle_count("127.0.0.1", p) == 0 for p in idle)
