"""The port's series partition (``serving/sharding.py``) and the fleet's
routing over it.

Parity with the reference, exact, on inputs drawn from a numpy seed:
``ShardingConfig``, ``stable_hash``, ``shard_of_key``,
``HashRing.lookup_n``, ``compute_assignments``, ``shard_indices``,
``plan_request`` (plannable and unplannable bodies),
``merge_invocation_responses``, ``merge_detect_responses`` and
``merge_ingest_responses`` (every shard up, some failed, all failed,
unparseable).

The port's own invariants: ``subset_for_shards`` partitions the key set,
and for Holt-Winters, theta, arima and the curve model a subset's predict
is bitwise the full forecaster's for the owned keys — held end to end by a
sharded fleet of in-process port scorers whose front-door bodies are
byte-equal to one unsharded scorer's.  Per-shard WAL namespaces: appends
land in their shard's directory, a replica follows (and applies) only its
owned shards, and a new owner's replay loses no pending write.  Routing
over fakes: single-shard requests reach an owner, scatter-gather merges
in request order, a failed shard degrades to per-key errors, ingest
reaches owners only, an unowned shard is a distinct 503, a tenant over
quota a 429, an unplannable body falls back to round-robin, and a restart
keeps its shards.
"""

import json
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu.serving import sharding as jsh
from distributed_forecasting_tpu_torch.serving import sharding as tsh
from distributed_forecasting_tpu_torch.serving.fleet import (
    FleetConfig,
    start_fleet,
)
from distributed_forecasting_tpu_torch.serving.sharding import (
    ShardedWAL,
    ShardingConfig,
    ShardMetrics,
    TokenBucket,
    shard_of_key,
    subset_for_shards,
)

from test_torch_fleet import _FakeProc, _front_call

torch.set_num_threads(1)

KEY_NAMES = ("store", "item")


# -- parity with the reference ----------------------------------------------------

@pytest.mark.parametrize("conf", [
    None, {"enabled": True, "num_shards": "16", "replication": 2},
    {"quota_rps": 5, "quota_burst": 0}, {"num_shard": 4},
    {"num_shards": 0}, {"replication": 0}, {"vnodes": 0},
    {"quota_rps": -1}])
def test_config_matches_the_reference(conf):
    def parse(mod):
        try:
            return mod.ShardingConfig.from_conf(conf).__dict__
        except ValueError as e:
            return str(e)
    assert parse(tsh) == parse(jsh)


def test_hashing_and_the_ring_match_the_reference():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 10_000, size=(400, 2)).tolist()
    for n in (1, 3, 8, 64):
        assert [tsh.shard_of_key(k, n) for k in keys] == \
            [jsh.shard_of_key(k, n) for k in keys]
    tokens = [f"t{int(v)}" for v in rng.integers(0, 10**9, 200)]
    assert [tsh.stable_hash(t) for t in tokens] == \
        [jsh.stable_hash(t) for t in tokens]
    for nodes, vnodes in (([0, 1], 64), ([0, 1, 2, 3, 4], 8),
                          (["a", "b", "c"], 1)):
        tr, jr = tsh.HashRing(nodes, vnodes), jsh.HashRing(nodes, vnodes)
        for n in (1, 2, 3, 7):
            assert [tr.lookup_n(t, n) for t in tokens] == \
                [jr.lookup_n(t, n) for t in tokens]
        assert [tr.lookup(t) for t in tokens] == \
            [jr.lookup(t) for t in tokens]


@pytest.mark.parametrize("num_shards,replication,vnodes,replicas", [
    (8, 2, 64, 2), (8, 1, 64, 3), (16, 3, 16, 5), (4, 2, 1, 1)])
def test_assignments_and_shard_indices_match_the_reference(
        num_shards, replication, vnodes, replicas):
    kw = dict(enabled=True, num_shards=num_shards, replication=replication,
              vnodes=vnodes)
    got = tsh.compute_assignments(tsh.ShardingConfig(**kw), range(replicas))
    assert got == jsh.compute_assignments(jsh.ShardingConfig(**kw),
                                          range(replicas))
    keys = np.random.default_rng(replicas).integers(0, 50, size=(300, 2))
    for owned in ([0], list(range(num_shards))[::2], []):
        t = tsh.shard_indices(keys, owned, num_shards)
        assert t.dtype == np.int64
        assert np.array_equal(t, jsh.shard_indices(keys, owned, num_shards))


def _bodies():
    rng = np.random.default_rng(9)
    keys = [tuple(int(v) for v in k)
            for k in rng.integers(0, 30, size=(40, 2))]
    named = [dict(zip(KEY_NAMES, k)) for k in keys]
    return [
        ("/invocations", {"inputs": named, "horizon": 7}),
        ("/invocations", {"inputs": named[:1]}),
        ("/invocations", {"inputs": [{"keys": dict(zip(KEY_NAMES, k))}
                                     for k in keys[:9]]}),
        ("/predict", {"inputs": [{"k": list(k)} for k in keys[:12]]}),
        ("/ingest", {"points": [dict(n, d=10 + i, y=1.0)
                                for i, n in enumerate(named)]}),
        ("/observe", {"observations": [dict(n, ds="2020-01-01", y=2.0)
                                       for n in named[:5]]}),
        ("/detect_anomalies", {"points": [dict(n, ds="2020-01-01", y=2.0)
                                          for n in named[5:20]]}),
        # unplannable: None from both
        ("/invocations", {"horizon": 3}),
        ("/invocations", {"inputs": []}),
        ("/invocations", {"inputs": [{"store": 1}]}),
        ("/invocations", {"inputs": [{"k": [1, 2, 3]}]}),
        ("/nope", {"inputs": named}),
        ("/invocations", ["not", "a", "dict"]),
    ]


def _plan_dict(plan):
    if plan is None:
        return None
    return {"field": plan.field, "shards": plan.shards,
            "items": plan.shard_items, "keys": plan.shard_keys,
            "order": plan.key_order, "tenants": plan.tenants,
            "sub": {s: plan.sub_body({"horizon": 3}, s)
                    for s in plan.shards}}


@pytest.mark.parametrize("case", range(len(_bodies())))
@pytest.mark.parametrize("num_shards", [4, 8])
def test_plan_request_matches_the_reference(case, num_shards):
    path, body = _bodies()[case]
    got = _plan_dict(tsh.plan_request(path, body, KEY_NAMES, num_shards))
    assert got == _plan_dict(jsh.plan_request(path, body, KEY_NAMES,
                                              num_shards))
    assert (got is None) == (case >= 7)


def _shard_responses(plan, kind, fail=(), garbage=()):
    """Per-shard (status, payload) as owners would answer ``kind``."""
    out = {}
    for shard in plan.shards:
        if shard in fail:
            out[shard] = (500, json.dumps({"error": "injected"}).encode())
            continue
        if shard in garbage:
            out[shard] = (200, b"not json")
            continue
        keys = plan.shard_keys[shard]
        if kind == "invocations":
            recs = [dict(zip(KEY_NAMES, k), ds=f"2020-01-0{d}",
                         yhat=0.1 * d + k[1]) for k in keys for d in (1, 2)]
            body = {"predictions": recs, "n_series": len(keys)}
        elif kind == "detect":
            recs = [dict(zip(KEY_NAMES, k), score=1.5, anomaly=False)
                    for k in keys]
            body = {"results": recs, "n_scored": len(recs), "n_flagged": 0,
                    "n_skipped": 1, "threshold": 4.0}
        else:
            n = len(plan.shard_items[shard])
            body = {"written": n, "unknown_series": 0, "malformed": 0,
                    "applied": {"accepted": n, "late": 0, "days": 1}}
        out[shard] = (200, json.dumps(body).encode())
    return out


@pytest.mark.parametrize("kind,path,case", [
    ("invocations", "/invocations", 0), ("detect", "/detect_anomalies", 6),
    ("ingest", "/ingest", 4)])
@pytest.mark.parametrize("outcome", ["ok", "partial", "garbage", "all"])
def test_merges_match_the_reference(kind, path, case, outcome):
    body = _bodies()[case][1]
    plan = tsh.plan_request(path, body, KEY_NAMES, 8)
    jplan = jsh.plan_request(path, body, KEY_NAMES, 8)
    fail = {"ok": (), "partial": plan.shards[::2], "garbage": (),
            "all": plan.shards}[outcome]
    garbage = plan.shards[1:2] if outcome == "garbage" else ()
    responses = _shard_responses(plan, kind, fail, garbage)
    if kind == "invocations":
        got = tsh.merge_invocation_responses(plan, KEY_NAMES, responses)
        want = jsh.merge_invocation_responses(jplan, KEY_NAMES, responses)
    elif kind == "detect":
        got = tsh.merge_detect_responses(plan, KEY_NAMES, responses)
        want = jsh.merge_detect_responses(jplan, KEY_NAMES, responses)
    else:
        got = tsh.merge_ingest_responses(plan, responses)
        want = jsh.merge_ingest_responses(jplan, responses)
    assert got == want
    assert json.dumps(got[1]).encode() == json.dumps(want[1]).encode()
    assert got[0] == (503 if outcome == "all" else 200)


# -- subsets -----------------------------------------------------------------

_FITS = {}


def _tiny_forecaster(family):
    """One fitted 8-series artifact a family on the CPU (4 stores x 2
    items x 40 days), with per-series conformal scales."""
    if family in _FITS:
        return _FITS[family]
    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
        tensorize,
    )
    from distributed_forecasting_tpu_torch.engine import fit_forecast
    from distributed_forecasting_tpu_torch.models.base import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    df = synthetic_store_item_sales(n_stores=4, n_items=2, n_days=40,
                                    seed=7)
    batch = tensorize(df, device="cpu")
    cfg = get_model(family).config_cls()
    params, _ = fit_forecast(batch, model=family, config=cfg, horizon=4)
    fc = BatchForecaster.from_fit(
        batch, params, family, cfg,
        interval_scale=np.linspace(0.5, 1.5, 8).astype(np.float32))
    _FITS[family] = (batch, fc)
    return _FITS[family]


def test_subset_partitions_the_key_set():
    _, fc = _tiny_forecaster("theta")
    seen = []
    for shard in range(4):
        sub, idx = subset_for_shards(fc, [shard], 4)
        assert np.array_equal(sub.keys, fc.keys[idx])
        assert np.array_equal(sub.interval_scale, fc.interval_scale[idx])
        assert (sub.day0, sub.day1, sub.time_bucket) == \
            (fc.day0, fc.day1, fc.time_bucket)
        assert all(shard_of_key(k, 4) == shard for k in sub.keys.tolist())
        seen.extend(idx.tolist())
    assert sorted(seen) == list(range(8))


FAMILIES = ["holt_winters", "theta", "arima", "prophet"]


@pytest.mark.parametrize("family", FAMILIES)
def test_a_subset_predicts_bitwise_the_full_forecast(family):
    _, fc = _tiny_forecaster(family)
    sub, idx = subset_for_shards(fc, [0, 2], 4)
    assert 0 < len(idx) < 8
    req = pd.DataFrame(fc.keys[idx][::-1], columns=list(fc.key_names))
    for kw in ({"horizon": 5}, {"horizon": 3, "include_history": True}):
        got = sub.predict(req, **kw)
        want = fc.predict(req, **kw)
        assert got.columns.tolist() == want.columns.tolist()
        for col in got.columns:
            assert np.array_equal(got[col].to_numpy(), want[col].to_numpy())
    q = sub.predict_quantiles(req, quantiles=(0.1, 0.9), horizon=4)
    assert q.equals(fc.predict_quantiles(req, quantiles=(0.1, 0.9),
                                         horizon=4))


def _call(srv, body):
    import http.client

    conn = http.client.HTTPConnection(*srv.server_address, timeout=30)
    try:
        conn.request("POST", "/invocations", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("family", FAMILIES)
def test_a_sharded_fleet_serves_byte_identical_forecasts(family):
    from distributed_forecasting_tpu_torch.serving.server import start_server

    _, fc = _tiny_forecaster(family)
    full = start_server(fc)
    servers = [full]

    def spawn(index, port, shards=None):
        sub, _ = subset_for_shards(fc, shards, 4)
        servers.append(start_server(sub, port=port))
        return _FakeProc(servers[-1])

    cfg = FleetConfig(enabled=True, replicas=2, health_poll_interval_s=0.05,
                      probe_timeout_s=2.0, drain_timeout_s=2.0,
                      retry_window_s=5.0)
    sup, front = start_fleet(
        cfg, spawn_fn=spawn, wait=False, key_names=fc.key_names,
        sharding=ShardingConfig(enabled=True, num_shards=4, replication=1,
                                vnodes=32))
    try:
        assert sup.wait_ready(min_ready=2, timeout=30.0)
        keys = [tuple(int(v) for v in k) for k in fc.keys.tolist()]
        assert len({shard_of_key(k, 4) for k in keys}) >= 3
        named = [dict(zip(fc.key_names, k)) for k in keys]
        for req in ({"inputs": named[:1], "horizon": 4},
                    {"inputs": named[::-1], "horizon": 4},
                    {"inputs": named[::3], "horizon": 3,
                     "include_history": True}):
            body = json.dumps(req).encode()
            status, payload = _call(full, body)
            got = _front_call(front, "POST", "/invocations", body)
            assert status == got[0] == 200
            assert got[2] == payload
    finally:
        front.shutdown()
        sup.stop()
        for srv in servers:
            srv.shutdown()
            srv.server_close()


# -- per-shard WALs ------------------------------------------------------------

def test_sharded_wal_routes_appends_and_follows_owned_only(tmp_path):
    keys = [(s, i) for s in range(8) for i in range(2)]
    by_shard = {}
    for k in keys:
        by_shard.setdefault(shard_of_key(k, 4), []).append(k)
    owned = sorted(by_shard)[:2]
    reads = []
    wal = ShardedWAL(str(tmp_path), owned, 4,
                     on_read=lambda s, n: reads.append((s, n)))
    assert wal.append([{"k": list(k), "d": 35, "y": 42.0}
                       for k in keys]) == len(keys)
    for shard, skeys in by_shard.items():
        lines = [json.loads(line)
                 for seg in sorted((tmp_path / f"shard-{shard}").glob(
                     "seg-*.jsonl"))
                 for line in seg.read_text().splitlines()]
        assert {tuple(r["k"]) for r in lines} == set(skeys)
    records, cursor = wal.read_new(None)
    assert {tuple(r["k"]) for r in records} == \
        {k for s in owned for k in by_shard[s]}
    assert sorted(s for s, _ in reads) == owned
    assert wal.read_new(cursor) == ([], cursor)
    st = wal.stats()
    assert st["segments"] == len(owned) and st["bytes"] > 0


def _runtime(fc, shards, wal_dir, mode, metrics=None):
    from distributed_forecasting_tpu_torch.serving.ingest import (
        build_ingest_runtime,
    )

    return build_ingest_runtime(
        {"enabled": True, "apply_mode": mode, "time_bucket": 8},
        fc, default_wal_dir=wal_dir, device="cpu",
        wal_factory=lambda d, m: ShardedWAL(
            d, shards, 4, max_segment_bytes=m,
            on_read=None if metrics is None else metrics.note_wal_read))


def test_ingest_applies_only_on_owners_and_a_new_owner_replays(tmp_path):
    _, fc = _tiny_forecaster("theta")
    populated = sorted({shard_of_key(k, 4) for k in fc.keys.tolist()})
    assign = {0: populated[:len(populated) // 2],
              1: populated[len(populated) // 2:]}
    wal_dir = str(tmp_path / "wal")
    runtimes, metrics = {}, {}
    for r, shards in assign.items():
        metrics[r] = ShardMetrics()
        runtimes[r] = _runtime(subset_for_shards(fc, shards, 4)[0], shards,
                               wal_dir, "sync", metrics[r])
    key = next(tuple(k) for k in fc.keys.tolist()
               if shard_of_key(k, 4) in assign[0])
    day = int(fc.day1) + 1
    out = runtimes[0].submit([dict(zip(fc.key_names, key), d=day, y=123.0)])
    assert out["written"] == 1 and out["applied"]["accepted"] == 1
    assert runtimes[0].forecaster.day1 >= day
    assert runtimes[1].poll_apply()["accepted"] == 0
    assert runtimes[1].forecaster.day1 == fc.day1
    shard = shard_of_key(key, 4)
    assert f'dftpu_shard_ingest_points_total{{shard="{shard}"}} 1' in \
        metrics[0].render()
    assert metrics[1].ingest_points.snapshot() == {}
    # hand-off: an interval-mode owner accepts but has not applied; a new
    # owner over the same shard WALs replays every pending write
    shards = assign[1]
    old = _runtime(subset_for_shards(fc, shards, 4)[0], shards,
                   str(tmp_path / "wal2"), "interval")
    sub = subset_for_shards(fc, shards, 4)[0]
    points = [dict(zip(fc.key_names, k), d=day, y=50.0 + j)
              for j, k in enumerate(sub.keys.tolist())]
    assert old.submit(points)["written"] == len(points)
    new = _runtime(subset_for_shards(fc, shards, 4)[0], shards,
                   str(tmp_path / "wal2"), "interval")
    assert new.poll_apply()["accepted"] == len(points)
    assert new.forecaster.day1 >= day


def test_token_bucket_and_shard_metrics():
    now = [0.0]
    tb = TokenBucket(rate=2.0, burst=4.0, time_fn=lambda: now[0])
    assert tb.allow("a", 4) and not tb.allow("a", 1) and tb.allow("b", 1)
    now[0] = 1.0
    assert tb.allow("a", 2) and not tb.allow("a", 1)
    assert TokenBucket(rate=3.0).burst == 6.0
    with pytest.raises(ValueError):
        TokenBucket(rate=0)
    sm = ShardMetrics()
    keys = np.array([[1, 1], [1, 2], [2, 1], [3, 3]])
    owned = sorted({shard_of_key(k, 4) for k in keys.tolist()})
    sm.observe_assignment(keys, owned, 4)
    text = sm.render()
    assert "dftpu_shard_resident_series 4" in text
    assert f"dftpu_shard_owned {len(owned)}" in text


# -- routing over fakes ---------------------------------------------------------

def _make_routing_fake(port):
    """A fake sharded replica: /readyz, /schema, /metrics, and POSTs that
    echo which port served which keys; ``fail`` turns POSTs into 500s."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, payload, ctype="application/json"):
            body = payload if isinstance(payload, bytes) \
                else json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/readyz":
                self._send(200, {"ready": True})
            elif self.path == "/schema":
                self._send(200, {"key_names": list(KEY_NAMES)})
            elif self.path == "/metrics":
                self._send(200, b"", "text/plain")
            else:
                self._send(404, {})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            if self.server.fail:
                self._send(500, {"error": "injected failure"})
                return
            me = self.server.server_address[1]
            if self.path == "/ingest":
                self.server.ingested.extend(
                    (r["store"], r["item"]) for r in req.get("points", []))
                self._send(200, {"written": len(req.get("points", []))})
                return
            seen = []
            for item in req.get("inputs", []):
                k = (item["store"], item["item"])
                if k not in seen:
                    seen.append(k)
            self._send(200, {"predictions": [
                {"store": k[0], "item": k[1], "port": me} for k in seen],
                "n_series": len(seen)})

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    srv.daemon_threads = True
    srv.fail = False
    srv.ingested = []
    srv.conns = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def routed():
    cfg = FleetConfig(enabled=True, replicas=2, health_poll_interval_s=0.05,
                      probe_timeout_s=1.0, restart_backoff_s=0.05,
                      restart_backoff_max_s=0.4, drain_timeout_s=2.0,
                      retry_window_s=1.0)
    procs, spawned = {}, []

    def spawn(index, port, shards=None):
        spawned.append((index, tuple(shards or ())))
        procs[index] = _FakeProc(_make_routing_fake(port))
        return procs[index]

    # key names discovered from a replica's /schema
    sup, front = start_fleet(
        cfg, spawn_fn=spawn, wait=False,
        sharding=ShardingConfig(enabled=True, num_shards=4, replication=1,
                                vnodes=32))
    assert sup.wait_ready(min_ready=2, timeout=10.0)
    try:
        yield sup, front, procs, spawned
    finally:
        front.shutdown()
        sup.stop()


def _keys_on(shard, n=1):
    out = [(s, i) for s in range(64) for i in range(4)
           if shard_of_key((s, i), 4) == shard]
    return out[:n]


def _named(keys):
    return [dict(zip(KEY_NAMES, k)) for k in keys]


def test_single_shard_routes_and_scatter_merges_in_order(routed):
    sup, front, procs, spawned = routed
    owned = [set(s) for _, s in spawned]
    assert set().union(*owned) == set(range(4)) and not owned[0] & owned[1]
    assign = sup.assignments()
    ports = {r["index"]: r["port"] for r in sup.describe()}
    for shard in range(4):
        body = json.dumps({"inputs": _named(_keys_on(shard))}).encode()
        status, headers, payload = _front_call(front, body=body)
        assert status == 200 and int(headers["X-Fleet-Shard"]) == shard
        assert json.loads(payload)["predictions"][0]["port"] == \
            ports[assign[shard][0]]
    keys = sorted(k for s in range(4) for k in _keys_on(s, 2))
    status, headers, payload = _front_call(
        front, body=json.dumps({"inputs": _named(keys)}).encode())
    merged = json.loads(payload)
    assert status == 200 and int(headers["X-Fleet-Scatter"]) == 4
    assert [(r["store"], r["item"]) for r in merged["predictions"]] == keys
    metrics = sup.render_metrics()
    assert "dftpu_shard_routed_total 4" in metrics
    assert "dftpu_shard_scatter_total 1" in metrics


def test_partial_failure_ingest_unowned_quota_and_fallback(routed):
    sup, front, procs, _ = routed
    with sup._lock:
        dead = set(sup._replicas[0].shards)
    procs[0].server.fail = True
    keys = [k for s in range(4) for k in _keys_on(s)]
    status, _, payload = _front_call(
        front, body=json.dumps({"inputs": _named(keys)}).encode())
    merged = json.loads(payload)
    assert status == 200
    assert {(e["store"], e["item"]) for e in merged["errors"]} == \
        {k for k in keys if shard_of_key(k, 4) in dead}
    procs[0].server.fail = False
    points = [dict(n, d=10, y=1.0) for n in _named(keys)]
    status, _, payload = _front_call(
        front, path="/ingest", body=json.dumps({"points": points}).encode())
    assert status == 200 and json.loads(payload)["written"] == len(keys)
    assign = sup.assignments()
    for r, proc in procs.items():
        assert set(proc.server.ingested) == {
            k for k in keys if assign[shard_of_key(k, 4)][0] == r}
    with sup._lock:
        owners, sup._assignments[0] = sup._assignments[0], []
    status, headers, payload = _front_call(
        front, body=json.dumps({"inputs": _named(_keys_on(0))}).encode())
    assert status == 503 and headers.get("Retry-After") == "1"
    assert json.loads(payload)["error"] == "shard has no owner"
    with sup._lock:
        sup._assignments[0] = owners
    now = [0.0]
    sup.quota = TokenBucket(rate=0.001, burst=2.0, time_fn=lambda: now[0])
    body = json.dumps({"inputs": _named([(7, 0), (7, 1)])}).encode()
    assert _front_call(front, body=body)[0] == 200
    status, headers, payload = _front_call(front, body=body)
    assert status == 429 and json.loads(payload)["tenant"] == "7"
    status, _, _ = _front_call(front, body=json.dumps({"horizon": 3})
                               .encode())
    assert status == 200
    metrics = sup.render_metrics()
    assert "fleet_unowned_shard_total 1" in metrics
    assert "dftpu_shard_quota_rejected_total 1" in metrics
    assert "dftpu_shard_unrouted_total 1" in metrics


def test_a_restart_keeps_its_shards(routed):
    sup, front, procs, spawned = routed
    before = dict(spawned)
    procs[0].crash()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and not (
            sup.ready_count() == 2 and len(spawned) >= 3):
        time.sleep(0.05)
    assert spawned[2] == (0, before[0])
    assert "dftpu_shard_rebalance_total 1" in sup.render_metrics()
