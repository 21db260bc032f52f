"""The port's serving fleet (``serving/fleet.py``): supervisor, front door,
Prometheus aggregation, and one fleet of real replica processes.

* ``aggregate_prometheus`` equals the reference's, text for text, on the
  reference's own cases and on real scrapes of two port scorers (the
  quality, ingest and anomaly runtimes on, so every family the port
  registers is in the scrape); every ``dftpu_*`` gauge the port registers
  has exactly one fleet-merge policy.
* The fast tests inject in-process fake replicas through ``spawn_fn``, as
  the reference's do: round-robin, retry on the next replica, restart
  with a capped backoff, ``kill_replica``, ``resize``, metrics, the
  unrouted 503, drain, and the ``fleet.forward`` failpoint.
* One test boots real ``python -m
  distributed_forecasting_tpu_torch.serving.replica`` children with
  ``DFTPU_PLATFORM=cpu`` on a tiny Holt-Winters artifact (8 series x 60
  days), sharded: both replicas become ready, front-door ``/invocations``
  bodies at 1 and 8 series are byte-equal to a single in-process scorer's
  on the same artifact, the replicas' ``/metrics`` carry the shard
  gauges, and a drain stops both children.  Another boots one replica at
  ``mesh_devices: 2`` (a follower rank) beside one at ``mesh_devices: 0``:
  byte-equal bodies, a follower's death restarts its replica, and the
  drain leaves no follower alive.
"""

import ast
import http.client
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.serving import fleet as jfleet
from distributed_forecasting_tpu_torch.monitoring import failpoints as fp
from distributed_forecasting_tpu_torch.serving import fleet as tfleet
from distributed_forecasting_tpu_torch.serving.fleet import (
    FleetConfig,
    FleetSupervisor,
    aggregate_prometheus,
    start_fleet,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(ROOT, "distributed_forecasting_tpu_torch")


# -- config -------------------------------------------------------------------

def test_fleet_config_defaults_casts_and_unknown_keys():
    cfg = FleetConfig.from_conf(None)
    assert cfg.replicas == 2 and not cfg.enabled
    cfg = FleetConfig.from_conf(
        {"enabled": True, "replicas": 3, "base_port": "9000"})
    assert cfg.enabled and cfg.replicas == 3 and cfg.base_port == 9000
    with pytest.raises(ValueError, match="restart_backof_s"):
        FleetConfig.from_conf({"restart_backof_s": 1.0})
    assert tfleet.FleetConfig.from_conf({"replicas": 4}) == \
        tfleet.FleetConfig(**jfleet.FleetConfig.from_conf(
            {"replicas": 4}).__dict__)


@pytest.mark.parametrize("bad", [
    {"replicas": 0},
    {"restart_backoff_s": 0.0},
    {"restart_backoff_s": 5.0, "restart_backoff_max_s": 1.0},
    {"health_poll_interval_s": 0.0},
    {"mesh_devices": -1},
])
def test_fleet_config_validates(bad):
    with pytest.raises(ValueError):
        FleetConfig(**bad)


# -- Prometheus aggregation -----------------------------------------------------

AGG_CASES = {
    "sums": [
        "# HELP serving_requests_total requests\n"
        "# TYPE serving_requests_total counter\n"
        "serving_requests_total 3\n"
        'serving_errors_total{code="429"} 1\n',
        "# HELP serving_requests_total requests\n"
        "# TYPE serving_requests_total counter\n"
        "serving_requests_total 4\n"
        'serving_errors_total{code="429"} 2\n'],
    "labels": ['serving_latency_bucket{le="0.1"} 2\n'
               'serving_latency_bucket{le="1"} 5\n',
               'serving_latency_bucket{le="0.1"} 1\n'],
    "floats": ["m 0.25\n", "m 0.5\n"],
    "empty": [],
    "histogram ladders differ": [
        "# TYPE h histogram\n"
        'h_bucket{le="0.1"} 1\nh_bucket{le="1"} 3\nh_bucket{le="+Inf"} 4\n'
        "h_sum 2.5\nh_count 4\n",
        "# TYPE h histogram\n"
        'h_bucket{le="0.5"} 2\nh_bucket{le="+Inf"} 2\nh_sum 0.5\n'
        "h_count 2\n"],
    "policies": [
        "# TYPE dftpu_slo_burn_rate gauge\ndftpu_slo_burn_rate 0.5\n"
        "# TYPE dftpu_ingest_wal_bytes gauge\ndftpu_ingest_wal_bytes 100\n"
        "# TYPE dftpu_cost_program_flops gauge\n"
        'dftpu_cost_program_flops{entry="e",key="k"} 7\n'
        "# TYPE dftpu_shard_resident_series gauge\n"
        "dftpu_shard_resident_series 10\n",
        "# TYPE dftpu_slo_burn_rate gauge\ndftpu_slo_burn_rate 2\n"
        "# TYPE dftpu_ingest_wal_bytes gauge\ndftpu_ingest_wal_bytes 90\n"
        "# TYPE dftpu_cost_program_flops gauge\n"
        'dftpu_cost_program_flops{entry="e",key="k"} 7\n'
        "# TYPE dftpu_shard_resident_series gauge\n"
        "dftpu_shard_resident_series 12\n"],
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_prometheus_matches_the_reference(case):
    texts = AGG_CASES[case]
    got = aggregate_prometheus(texts)
    assert got == jfleet.aggregate_prometheus(texts)
    if case == "sums":
        assert "serving_requests_total 7" in got
        assert 'serving_errors_total{code="429"} 3' in got
        assert got.count("# TYPE serving_requests_total") == 1
    if case == "policies":
        assert "dftpu_slo_burn_rate 2" in got          # max
        assert "dftpu_ingest_wal_bytes 100" in got     # max
        assert 'key="k"} 7' in got                     # replicated
        assert "dftpu_shard_resident_series 22" in got  # summed


def _tiny_hw(S=8, T=60, seed=13):
    """(batch, forecaster) of a Holt-Winters fit on the CPU."""
    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
        tensorize,
    )
    from distributed_forecasting_tpu_torch.models.base import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    df = synthetic_store_item_sales(n_stores=2, n_items=S // 2, n_days=T,
                                    seed=seed)
    batch = tensorize(df, device="cpu")
    fns = get_model("holt_winters")
    cfg = fns.config_cls()
    params = fns.fit(batch.y, batch.mask, batch.day, cfg)
    return batch, BatchForecaster.from_fit(batch, params, "holt_winters",
                                           cfg)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def scrapes(tmp_path_factory):
    """Two port scorers' /metrics with the quality, ingest and anomaly
    runtimes on and a sharded replica's shard registry, after traffic."""
    from distributed_forecasting_tpu_torch.monitoring.quality import (
        build_quality_runtime,
    )
    from distributed_forecasting_tpu_torch.serving.anomaly import (
        build_anomaly_runtime,
    )
    from distributed_forecasting_tpu_torch.serving.ingest import (
        build_ingest_runtime,
    )
    from distributed_forecasting_tpu_torch.serving.server import start_server
    from distributed_forecasting_tpu_torch.serving.sharding import (
        ShardMetrics,
        subset_for_shards,
    )

    tmp = tmp_path_factory.mktemp("scrapes")
    batch, fc_full = _tiny_hw()
    texts = []
    for i, shards in enumerate(([0, 1, 2, 3], [2, 3, 4, 5, 6, 7])):
        fc, idx = subset_for_shards(fc_full, shards, 8)
        sm = ShardMetrics()
        sm.observe_assignment(fc.keys, shards, 8)
        quality = build_quality_runtime(
            {"quality": {"enabled": True},
             "quality_store": {"enabled": True,
                               "directory": str(tmp / f"qs{i}")},
             "slo": {"enabled": True}}, fc)
        ingest = build_ingest_runtime(
            {"enabled": True, "wal_dir": str(tmp / f"wal{i}")}, fc,
            history_y=batch.y.numpy()[idx],
            history_mask=batch.mask.numpy()[idx], device="cpu")
        anomaly = build_anomaly_runtime({"enabled": True}, fc)
        srv = start_server(fc, quality=quality, ingest=ingest,
                           anomaly=anomaly, extra_metrics=sm)
        port = srv.server_address[1]
        key = {n: int(v) for n, v in zip(fc.key_names, fc.keys[0])}
        assert _post(port, "/invocations",
                     {"inputs": [key], "horizon": 5})[0] == 200
        texts.append(_get(port, "/metrics")[1].decode())
        srv.shutdown()
        srv.server_close()
    return texts


def test_aggregate_prometheus_of_real_scrapes_matches_the_reference(scrapes):
    got = aggregate_prometheus(scrapes)
    assert got == jfleet.aggregate_prometheus(scrapes)
    for family in ("serving_requests_total", "dftpu_shard_series",
                   "dftpu_ingest_wal_bytes", "dftpu_slo_", "dftpu_anomaly_"):
        assert family in got, family


def _registered_gauges() -> set:
    """Every ``dftpu_*`` gauge family the port registers, read from its
    source: ``gauge`` / ``labeled_gauge`` calls with a literal name (an
    f-string contributes its literal head, a policy prefix)."""
    names = set()
    for dirpath, _, files in os.walk(PORT_PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) and node.func.attr in (
                        "gauge", "labeled_gauge") and node.args):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str):
                    names.add(arg.value)
                elif isinstance(arg, ast.JoinedStr) and isinstance(
                        arg.values[0], ast.Constant):
                    names.add(arg.values[0].value)
    return {n for n in names if n.startswith("dftpu_")}


def test_every_port_gauge_has_one_fleet_merge_policy(scrapes):
    from_scrape = {line.split()[2] for text in scrapes
                   for line in text.splitlines()
                   if line.startswith("# TYPE dftpu_")
                   and line.split()[3] == "gauge"}
    names = _registered_gauges() | from_scrape
    assert "dftpu_shard_series" in names and len(names) > 20
    for name in sorted(names):
        policies = [name in tfleet._GAUGE_MAX_MERGE,
                    name in tfleet._GAUGE_SUM_MERGE,
                    name.startswith(tfleet._GAUGE_MAX_PREFIXES),
                    name.startswith(tfleet._GAUGE_REPLICATE_PREFIX)]
        assert sum(policies) == 1, (name, policies)


# -- in-process fake replicas ---------------------------------------------------

def _make_fake_replica(port, delay_s=0.0):
    """A minimal in-process 'replica': /readyz, /metrics, POST answers."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so the supervisor's pool keeps legs alive (every
        # response sets Content-Length)
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def setup(self):
            super().setup()
            # _FakeProc severs these like a process death would
            self.server.conns.append(self.connection)

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/readyz":
                code = 200 if self.server.ready else 503
                self._send(code, b'{"ready": true}')
            elif self.path == "/metrics":
                text = ("# HELP serving_requests_total requests\n"
                        "# TYPE serving_requests_total counter\n"
                        f"serving_requests_total {self.server.hits}\n")
                self._send(200, text.encode(), "text/plain")
            else:
                self._send(404, b"{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            self.rfile.read(n)
            if self.server.delay_s:
                time.sleep(self.server.delay_s)
            self.server.hits += 1
            self._send(200, json.dumps(
                {"port": self.server.server_address[1]}).encode())

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    srv.daemon_threads = True
    srv.ready = True
    srv.hits = 0
    srv.delay_s = delay_s
    srv.conns = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class _FakeProc:
    """Popen-compatible handle over an in-process fake replica."""

    def __init__(self, server):
        self.server = server
        self._returncode = None

    def _close(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            for c in getattr(self.server, "conns", ()):
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            self.server = None

    def poll(self):
        return self._returncode

    def crash(self):
        """The process died: port closed, poll() reports an exit."""
        self._close()
        self._returncode = -9

    def hang_up(self):
        """A wedged process: port closed, poll() still alive."""
        self._close()

    def terminate(self):
        self._close()
        if self._returncode is None:
            self._returncode = -15

    kill = terminate

    def wait(self, timeout=None):
        return self._returncode


def _front_call(front, method="POST", path="/invocations", body=b"{}",
                headers=None):
    host, port = front.server_address
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        hdrs = {"Content-Type": "application/json"} if body else {}
        hdrs.update(headers or {})
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _boot(replicas=2, poll_s=0.05, retry_window_s=3.0, resilience=None,
          delays=None, backoff=(0.05, 0.4), serving_conf=None):
    """(supervisor, front, procs) over in-process fakes, all ready."""
    cfg = FleetConfig(
        enabled=True, replicas=replicas, health_poll_interval_s=poll_s,
        probe_timeout_s=1.0, restart_backoff_s=backoff[0],
        restart_backoff_max_s=backoff[1], drain_timeout_s=2.0,
        retry_window_s=retry_window_s, proxy_timeout_s=10.0)
    procs = {}

    def spawn(index, port):
        delay = (delays or {}).get(index, 0.0)
        procs[index] = _FakeProc(_make_fake_replica(port, delay_s=delay))
        return procs[index]

    sup, front = start_fleet(cfg, spawn_fn=spawn, wait=False,
                             resilience=resilience, serving_conf=serving_conf)
    sup.poll_once()
    assert sup.ready_count() == replicas
    return sup, front, procs


@pytest.fixture
def fake_fleet():
    sup, front, procs = _boot()
    try:
        yield sup, front, procs
    finally:
        front.shutdown()
        sup.stop()


def test_round_robin_and_health_endpoints(fake_fleet):
    sup, front, _ = fake_fleet
    hit = {int(_front_call(front)[1]["X-Fleet-Replica"]) for _ in range(6)}
    assert hit == set(sup.all_ports())
    assert _front_call(front, "GET", "/healthz", None)[0] == 200
    status, _, body = _front_call(front, "GET", "/readyz", None)
    assert status == 200 and json.loads(body)["ready_replicas"] == 2
    replicas = json.loads(_front_call(front, "GET", "/fleet", None)[2])
    assert [r["ready"] for r in replicas["replicas"]] == [True, True]


def test_retry_on_a_dead_replica_is_invisible_to_clients():
    sup, front, procs = _boot(poll_s=60.0)
    try:
        procs[0].hang_up()
        dead, live = sup.all_ports()
        for _ in range(4):
            status, headers, _ = _front_call(front)
            assert status == 200 and int(headers["X-Fleet-Replica"]) == live
        metrics = sup.render_metrics()
        assert "fleet_connection_failures_total 1" in metrics
        assert "fleet_retries_total 1" in metrics
        assert "fleet_unrouted_total 0" in metrics
    finally:
        front.shutdown()
        sup.stop()


def test_restart_after_a_crash_and_after_kill_replica(fake_fleet):
    sup, front, procs = fake_fleet
    procs[0].crash()
    sup.kill_replica(1)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and not (
            sup.ready_count() == 2
            and all(r["restarts"] >= 1 for r in sup.describe())):
        time.sleep(0.05)
    assert [r["restarts"] >= 1 for r in sup.describe()] == [True, True]
    assert sup.ready_count() == 2
    assert "fleet_restarts_total 2" in sup.render_metrics()
    assert _front_call(front)[0] == 200  # the restart reused the port
    with pytest.raises(ValueError):
        sup.kill_replica(7)


def test_restart_backoff_doubles_caps_and_resets():
    cfg = FleetConfig(enabled=True, replicas=1, health_poll_interval_s=0.05,
                      restart_backoff_s=0.05, restart_backoff_max_s=0.4,
                      drain_timeout_s=1.0)
    procs = []

    def spawn(index, port):
        procs.append(_FakeProc(_make_fake_replica(port)))
        return procs[-1]

    sup = FleetSupervisor(cfg, spawn)
    try:
        expected = [0.05, 0.1, 0.2, 0.4, 0.4]
        observed = []
        for _ in expected:
            if procs:
                procs[-1].crash()
            with sup._lock:
                sup._replicas[0].next_restart_at = 0.0
            sup.poll_once()
            with sup._lock:
                observed.append(sup._replicas[0].backoff_s)
        assert observed == pytest.approx(expected)
        sup.poll_once()
        with sup._lock:
            assert sup._replicas[0].ready
            assert sup._replicas[0].backoff_s == 0.0
    finally:
        sup.stop()


def test_metrics_aggregate_replicas_and_the_supervisor(fake_fleet):
    sup, front, _ = fake_fleet
    for _ in range(5):
        assert _front_call(front)[0] == 200
    status, headers, body = _front_call(front, "GET", "/metrics", None)
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    assert "serving_requests_total 5" in text
    assert "fleet_replicas_total 2" in text
    assert "fleet_replicas_ready 2" in text


def test_unrouted_503_when_the_whole_fleet_is_down():
    sup, front, procs = _boot(retry_window_s=0.3, backoff=(30.0, 30.0))
    try:
        for p in procs.values():
            p.hang_up()
        status, headers, body = _front_call(front)
        assert status == 503 and headers.get("Retry-After") == "1"
        assert json.loads(body)["error"] == "no ready replica"
        assert "fleet_unrouted_total 1" in sup.render_metrics()
    finally:
        front.shutdown()
        sup.stop()


def test_resize_grows_and_shrinks_with_a_rebalance():
    from distributed_forecasting_tpu_torch.serving.sharding import (
        ShardingConfig,
    )

    cfg = FleetConfig(enabled=True, replicas=2, health_poll_interval_s=0.05,
                      restart_backoff_s=0.05, drain_timeout_s=1.0)
    procs, shards_seen = [], {}

    def spawn(index, port, shards):
        shards_seen[index] = tuple(shards)
        procs.append(_FakeProc(_make_fake_replica(port)))
        return procs[-1]

    sharding = ShardingConfig(enabled=True, num_shards=8, replication=1)
    sup = FleetSupervisor(cfg, spawn, sharding=sharding)
    try:
        sup.start()
        assert sup.wait_ready(min_ready=2, timeout=10)
        before = sup.assignments()
        sup.resize(3)
        assert sup.size == 3 and sup.wait_ready(min_ready=3, timeout=10)
        after = sup.assignments()
        moved = sum(before[k] != after[k] for k in range(8))
        assert 0 < moved < 8  # the ring remaps some shards, not all
        owned = sorted(k for r in sup.describe() for k in r["shards"])
        assert owned == list(range(8))
        sup.resize(1)
        assert sup.size == 1
        assert sup.describe()[0]["shards"] == list(range(8))
        assert "dftpu_shard_rebalance_total" in sup.render_metrics()
    finally:
        sup.stop()


def test_drain_terminates_replicas(fake_fleet):
    sup, front, procs = fake_fleet
    sup.stop()
    assert all(p.poll() is not None for p in procs.values())
    assert sup.ready_count() == 0


def test_fleet_forward_failpoint_takes_the_retry_path(fake_fleet):
    sup, front, _ = fake_fleet
    try:
        fp.configure("fleet.forward=raise OSError:1")
        status, _, _ = _front_call(front)
        assert status == 200
        assert fp.fired("fleet.forward") == 1
        metrics = sup.render_metrics()
        assert "fleet_connection_failures_total 1" in metrics
        assert "fleet_retries_total 1" in metrics
    finally:
        fp.deactivate()


# -- real replica processes ------------------------------------------------------

def test_real_replicas_serve_byte_equal_forecasts_and_drain(tmp_path):
    from distributed_forecasting_tpu_torch.serving.server import start_server
    from distributed_forecasting_tpu_torch.serving.sharding import (
        ShardingConfig,
    )

    batch, fc = _tiny_hw()
    art = str(tmp_path / "forecaster")
    fc.save(art)
    np.savez(os.path.join(art, "history.npz"), y=batch.y.numpy(),
             mask=batch.mask.numpy())
    serving_conf = {"warmup_sizes": [1], "warmup_horizon": 5,
                    "ingest": {"enabled": True,
                               "wal_dir": str(tmp_path / "wal")}}
    cfg = FleetConfig(enabled=True, replicas=2, health_poll_interval_s=0.1,
                      restart_backoff_s=0.2, ready_timeout_s=120.0,
                      drain_timeout_s=10.0, retry_window_s=20.0)
    env = {"DFTPU_PLATFORM": "cpu",
           "DFTPU_COMPILE_CACHE": str(tmp_path / "cc")}
    sup, front = start_fleet(
        cfg, artifact_dir=art, serving_conf=serving_conf, env_extra=env,
        sharding=ShardingConfig(enabled=True, num_shards=4, replication=1),
        wait=False)
    single = start_server(fc)
    try:
        assert sup.wait_ready(min_ready=2, timeout=120.0), sup.describe()
        owned = sorted(k for r in sup.describe() for k in r["shards"])
        assert owned == [0, 1, 2, 3]
        fport = front.server_address[1]
        keys = [{n: int(v) for n, v in zip(fc.key_names, k)}
                for k in fc.keys]
        for inputs in (keys[:1], keys[::-1]):
            req = {"inputs": inputs, "horizon": 7}
            status, headers, body = _post(fport, "/invocations", req)
            assert status == 200, body[:300]
            want = _post(single.server_address[1], "/invocations", req)
            assert body == want[2]
        assert "X-Fleet-Scatter" in headers
        for rep in sup.describe():
            text = _get(rep["port"], "/metrics")[1].decode()
            assert "dftpu_shard_resident_series" in text
        status, body = _get(fport, "/metrics")
        assert status == 200 and b"dftpu_shard_scatter_total 1" in body
    finally:
        single.shutdown()
        single.server_close()
        front.shutdown()
        sup.stop()
    assert all(r["alive"] is False for r in sup.describe())


def test_a_replica_without_a_card_raises_and_never_serves(tmp_path):
    """No ``DFTPU_PLATFORM=cpu`` and no card (the child sees none, on any
    host): the replica raises before it binds (the supervisor's restart
    backoff then shows it); it never carries on on the CPU."""
    import subprocess
    import sys

    batch, fc = _tiny_hw()
    fc.save(str(tmp_path / "art"))
    conf = {"artifact_dir": str(tmp_path / "art"), "port": 1,
            "host": "127.0.0.1"}
    env = {k: v for k, v in os.environ.items() if k != "DFTPU_PLATFORM"}
    env["PYTHONPATH"] = ROOT
    env["DFTPU_PLATFORM"] = "cuda"
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_forecasting_tpu_torch.serving."
         "replica", "--conf", json.dumps(conf)], capture_output=True,
        text=True, cwd=ROOT, env=env, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr


def _children(pid: int) -> list:
    """Pids of ``pid``'s child processes (read from /proc): a replica's are
    its forked followers."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rpartition(")")[2].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid:
            out.append(int(d))
    return out


def _alive(pid: int) -> bool:
    """The pid runs and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except OSError:
        return False


def test_a_mesh_replica_serves_byte_equal_bodies_restarts_and_drains(
        tmp_path):
    """A fleet of one replica at ``mesh_devices: 2`` under
    ``DFTPU_PLATFORM=cpu`` (a serving rank and one follower process over
    gloo) beside the same fleet at ``mesh_devices: 0``: point and quantile
    bodies at 1 and 8 series are byte-equal; a SIGKILLed follower takes
    its replica out of /readyz with a nonzero exit and the supervisor's
    restart brings it back serving the same bytes; a SIGKILLed replica's
    follower ends on its own; the drain leaves no follower alive."""
    import signal

    batch, fc = _tiny_hw()
    art = str(tmp_path / "forecaster")
    fc.save(art)
    env = {"DFTPU_PLATFORM": "cpu",
           "DFTPU_COMPILE_CACHE": str(tmp_path / "cc")}
    conf = {"warmup_sizes": [1, 8], "warmup_horizon": 5}
    fleets = {}
    for mesh in (2, 0):
        cfg = FleetConfig(enabled=True, replicas=1, mesh_devices=mesh,
                          health_poll_interval_s=0.1, restart_backoff_s=0.2,
                          ready_timeout_s=180.0, drain_timeout_s=30.0,
                          retry_window_s=30.0)
        fleets[mesh] = start_fleet(cfg, artifact_dir=art, serving_conf=conf,
                                   env_extra=env, wait=False)
    keys = [{n: int(v) for n, v in zip(fc.key_names, k)} for k in fc.keys]
    payloads = [{"inputs": keys[:1], "horizon": 5},
                {"inputs": keys[::-1], "horizon": 5},
                {"inputs": keys[::-1], "horizon": 5,
                 "quantiles": [0.1, 0.5, 0.9]}]

    def bodies(mesh):
        port = fleets[mesh][1].server_address[1]
        out = []
        for p in payloads:
            status, _, body = _post(port, "/invocations", p)
            assert status == 200, body[:300]
            out.append(body)
        return out

    def replica_proc(sup):
        with sup._lock:
            return sup._replicas[0].proc

    try:
        for mesh, (sup, _) in fleets.items():
            assert sup.wait_ready(min_ready=1, timeout=180.0), (
                mesh, sup.describe())
        want = bodies(0)
        assert bodies(2) == want
        sup = fleets[2][0]
        proc = replica_proc(sup)
        (follower,) = _children(proc.pid)
        os.kill(follower, signal.SIGKILL)
        assert proc.wait(60) == 75  # the replica's "a follower died" exit

        def restarted(n):
            deadline = time.monotonic() + 180.0
            while not (sup.describe()[0]["restarts"] >= n
                       and sup.ready_count() == 1):
                assert time.monotonic() < deadline, sup.describe()
                time.sleep(0.1)
            return replica_proc(sup)

        second = restarted(1)
        assert second is not proc and bodies(2) == want
        (second_follower,) = _children(second.pid)
        # the replica SIGKILLed: its follower ends on its own (the
        # parent-death signal), and the supervisor restarts the replica
        os.kill(second.pid, signal.SIGKILL)
        deadline = time.monotonic() + 30.0
        while _alive(second_follower) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not _alive(second_follower)
        third = restarted(2)
        assert bodies(2) == want
        (third_follower,) = _children(third.pid)
    finally:
        for sup, front in fleets.values():
            front.shutdown()
            sup.stop()
    assert third.returncode == 0  # drained
    deadline = time.monotonic() + 30.0
    while _alive(third_follower) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(_alive(p) for p in (follower, second_follower,
                                       third_follower))


@pytest.mark.parametrize("conf, error, match", [
    ({"cache": {"enabled": True}}, FileNotFoundError, "forecaster.json"),
    ({"batching": {"max_batchsize": 3}}, ValueError,
     "unknown batching conf key"),
], ids=["cache", "typo"])
def test_a_replica_refuses_what_the_port_lacks(tmp_path, monkeypatch, conf,
                                               error, match):
    """A conf typo fails at the parse.  An enabled ``cache`` block is
    ported: it parses, and the replica goes on to the model load (an empty
    directory here).  ``mesh_devices > 1`` is ported too
    (``test_a_mesh_replica_serves_byte_equal_bodies_restarts_and_drains``)."""
    from distributed_forecasting_tpu_torch.serving import replica

    monkeypatch.setenv("DFTPU_PLATFORM", "cpu")
    full = {"artifact_dir": str(tmp_path), "port": 1, **conf}
    with pytest.raises(error, match=match):
        replica.main(["--conf", json.dumps(full)])


class _ReachedIngest(Exception):
    pass


def test_the_replica_history_sidecar_lookup_departs_from_the_reference(
        tmp_path, monkeypatch):
    """A pinned difference.  A registered version whose artifact sits in a
    ``forecaster/`` subdirectory, with ``history.npz`` at the version's
    root (where both serve tasks look first): both fleet tasks hand the
    replica the subdirectory.  The reference's replica looks there and in
    its ``forecaster/`` only, so it misses the sidecar and builds its
    ingest runtime without history (no full refits); the port's
    ``replica._history`` also looks in the version's directory and finds
    it.  Each replica is driven to its ingest runtime's construction,
    where a stub records the history it was handed."""
    from distributed_forecasting_tpu.serving import ingest as jingest
    from distributed_forecasting_tpu.serving import replica as jreplica
    from distributed_forecasting_tpu_torch.serving import ingest as tingest
    from distributed_forecasting_tpu_torch.serving import replica as treplica

    batch, fc = _tiny_hw()
    version = tmp_path / "version"
    fc.save(str(version / "forecaster"))
    y, mask = batch.y.numpy(), batch.mask.numpy()
    np.savez(str(version / "history.npz"), y=y, mask=mask)
    for pkg in ("distributed_forecasting_tpu", PORT_PKG):
        # both fleet tasks pick the subdirectory when it exists
        with open(os.path.join(ROOT, pkg, "tasks", "fleet.py")) as f:
            assert ('os.path.join(version.artifact_dir, "forecaster")'
                    in f.read())
    seen = {}

    def stub(name):
        def build(ingest_conf, forecaster, history_y=None, history_mask=None,
                  **kw):
            seen[name] = (history_y, history_mask)
            raise _ReachedIngest(name)
        return build

    monkeypatch.setattr(jingest, "build_ingest_runtime", stub("reference"))
    monkeypatch.setattr(tingest, "build_ingest_runtime", stub("port"))
    monkeypatch.setenv("DFTPU_PLATFORM", "cpu")
    conf = json.dumps({"artifact_dir": str(version / "forecaster"),
                       "port": 1, "ingest": {"enabled": True}})
    for name, mod in (("reference", jreplica), ("port", treplica)):
        with pytest.raises(_ReachedIngest, match=name):
            mod.main(["--conf", conf])
    assert seen["reference"] == (None, None)  # the reference's miss
    got_y, got_mask = seen["port"]  # the port's hit
    assert np.array_equal(got_y, y) and np.array_equal(got_mask, mask)
