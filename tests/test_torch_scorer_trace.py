"""The scorer's runtime on the port: request spans from HTTP to the
dispatch, the flight recorder, ``/debug/*``, and the scorer's cost charges
and store rows (``serving/server.py``, ``serving/batcher.py``,
``serving/predictor.py``, ``serving/anomaly.py``, ``serving/ingest.py``,
``ops/update.py``, ``engine/state_store.py``, ``monitoring/quality.py``).

The reference's cases run on the port first
(``tests/unit/test_trace.py::test_request_trace_end_to_end``,
``test_debug_endpoints_gated``, ``test_flight_recorder_dumped_on_5xx``;
``tests/unit/test_cost.py::test_debug_cost_endpoint_gated``).  Then both
packages' servers serve one theta artifact fit by the reference (the
port's loaded from it through ``convert.py``) with the shipped conf's
runtimes: micro-batching, the quality store and SLO evaluator, streaming
ingest with refits, the anomaly scorer.  The same requests go to both,
once to warm the reference's AOT store and once traced, and then:

- equal: each route's span kinds, its parent/child edges by kind, and
  every span's attributes but times and ids (``device_seconds``, the
  ``trace_ids`` values, ``wal_dir``); the forced refit's span tree; the
  ``/debug/*`` status codes, ``Retry-After`` headers and error bodies;
  the ``/debug/ingest`` body but its one time-valued field
  (``seconds_since_refit``); the ``/debug/quality`` body's counts, keys
  and SLO block, with its metrics within rtol 1e-5 (the served paths
  round the forecast differently, ``tests/test_torch_predictor.py``) and
  the store's path and byte count left out (a row holds a float's
  decimal digits); the dump file-name pattern; the ``dftpu_cost_*``
  family names, types and help texts on ``/metrics``; the serving
  entries' store rows and their dispatch and padding counts;
  ``scripts/trace_report.py``'s ``by_kind``, ``quality_rollup`` and
  ``streaming_rollup`` over each package's flight-recorder dump;
- pinned differences, each for the reason given where it is asserted:
  ``aot.call``'s ``outcome`` is ``eager`` on the port (no executable
  store: the reference's warm store answers ``memo``); the port charges
  ``state_update:<model>`` dispatches (``aot_call`` charges its entry,
  ROADMAP Queue 3) and has no program rows for the plain-torch
  forecast (program costs are its kernels' own counts).
"""

import importlib.util
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
from distributed_forecasting_tpu.engine import compile_cache as jcc
from distributed_forecasting_tpu.models import base as jbase
from distributed_forecasting_tpu.monitoring import cost as jcost
from distributed_forecasting_tpu.monitoring import quality as jq
from distributed_forecasting_tpu.monitoring import trace as jtrace
from distributed_forecasting_tpu.serving import anomaly as janom
from distributed_forecasting_tpu.serving import batcher as jbatcher
from distributed_forecasting_tpu.serving import ingest as jingest
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu.serving import server as jserver
from distributed_forecasting_tpu_torch.monitoring import cost as tcost
from distributed_forecasting_tpu_torch.monitoring import quality as tq
from distributed_forecasting_tpu_torch.monitoring import trace as ttrace
from distributed_forecasting_tpu_torch.serving import anomaly as tanom
from distributed_forecasting_tpu_torch.serving import batcher as tbatcher
from distributed_forecasting_tpu_torch.serving import ingest as tingest
from distributed_forecasting_tpu_torch.serving import predictor as tpred
from distributed_forecasting_tpu_torch.serving import server as tserver

from test_torch_batcher import FakeForecaster

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": (jserver, jbatcher, jtrace, jcost),
        "port": (tserver, tbatcher, ttrace, tcost)}
DUMP_NAME = re.compile(r"flight-\d{8}T\d{6}-\d+-http-503\.trace\.json")
# attributes that hold times, ids or paths: never compared
TIMED = ("device_seconds", "wal_dir")


def _raw(port, method, path, payload=None, headers=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method, headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _json(port, method, path, payload=None, headers=None):
    code, body, head = _raw(port, method, path, payload, headers)
    return code, json.loads(body), head


@pytest.fixture()
def global_tracing():
    """Swap the port's process-wide tracer for the test; defaults after."""
    def apply(config):
        ttrace.configure_tracing(config)
        return ttrace.get_tracer()
    yield apply
    ttrace.configure_tracing(ttrace.TraceConfig())


def _isolate_cost(mod):
    """Fresh cost singleton and config; returns the restore callable."""
    with mod._state_lock:
        prev = mod._cost_metrics, mod._active_config
        mod._cost_metrics, mod._active_config = None, None

    def restore():
        with mod._state_lock:
            mod._cost_metrics, mod._active_config = prev
    return restore


@pytest.fixture()
def fresh_cost():
    restore = [_isolate_cost(m) for m in (tcost, jcost)]
    yield
    for r in restore:
        r()


# -- the reference's cases, on the port ---------------------------------------

def _port_theta():
    """The port's own theta fit of a 2 x 2 x 200 synthetic catalog."""
    from distributed_forecasting_tpu_torch.data import tensorize
    from distributed_forecasting_tpu_torch.models import get_model

    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=2, n_days=200,
                                          seed=9)
    batch = tensorize(df, device="cpu")
    fns = get_model("theta")
    cfg = fns.config_cls()
    params = fns.fit(batch.y, batch.mask, batch.day, cfg)
    return tpred.BatchForecaster.from_fit(batch, params, "theta", cfg)


def test_request_trace_end_to_end(tmp_path, global_tracing):
    """One /invocations under the batched server: queue wait, dispatch,
    predict and the AOT entry share the request's trace id, across the
    handler and scheduler threads."""
    global_tracing(ttrace.TraceConfig(enabled=True, debug_endpoints=True,
                                      dump_dir=str(tmp_path / "dumps")))
    fc = _port_theta()
    srv = tserver.start_server(fc, batching=tbatcher.BatchingConfig(
        enabled=True, max_batch_size=8, max_wait_ms=1.0,
        max_queue_depth=16, request_timeout_s=60.0))
    port = srv.server_address[1]
    try:
        trace_id = "feedbeefcafe0001"
        k0 = {n: int(v) for n, v in zip(fc.key_names, fc.keys[0])}
        code, _, headers = _json(port, "POST", "/invocations",
                                 {"inputs": [k0], "horizon": 14},
                                 {"X-Trace-Id": trace_id})
        assert code == 200
        assert headers["X-Trace-Id"] == trace_id
        time.sleep(0.3)  # the root span closes after the response
        code, doc, _ = _json(port, "GET", "/debug/trace")
        assert code == 200
    finally:
        srv.shutdown()
    mine = [e for e in doc["traceEvents"] if e.get("ph") == "X"
            and e.get("args", {}).get("trace_id") == trace_id]
    kinds = {e["name"] for e in mine}
    assert {"http.request", "batcher.queue_wait", "batcher.dispatch",
            "serving.predict", "aot.call"} <= kinds, kinds
    assert len({e["tid"] for e in mine}) >= 2
    root = next(e for e in mine if e["name"] == "http.request")
    dispatch = next(e for e in mine if e["name"] == "batcher.dispatch")
    assert dispatch["args"]["parent_id"] == root["args"]["span_id"]
    assert root["args"]["status"] == 200
    predict = next(e for e in mine if e["name"] == "serving.predict")
    assert predict["args"]["parent_id"] == dispatch["args"]["span_id"]
    assert predict["args"]["device_seconds"] > 0
    # the dispatch carries the chunk's device seconds (the attribution
    # scope over the predictor's charge)
    assert dispatch["args"]["device_seconds"] == pytest.approx(
        predict["args"]["device_seconds"])
    # a client with no usable id gets the root span's id echoed
    srv = tserver.start_server(fc)
    try:
        _, _, headers = _json(srv.server_address[1], "POST", "/invocations",
                              {"inputs": [k0], "horizon": 3},
                              {"X-Trace-Id": "bad id;rm"})
        code, doc, _ = _json(srv.server_address[1], "GET", "/debug/trace")
    finally:
        srv.shutdown()
    roots = [e for e in doc["traceEvents"] if e.get("name") == "http.request"]
    assert headers["X-Trace-Id"] == roots[-1]["args"]["trace_id"]
    assert re.fullmatch("[0-9a-f]{16}", headers["X-Trace-Id"])


def test_debug_endpoints_gated(global_tracing, tmp_path):
    """/debug/* is 404 with debug_endpoints off (the default); on, the
    profile route is 503 without a profile_dir and 400 for a bad number,
    and with one it captures (409 while another capture runs)."""
    global_tracing(ttrace.TraceConfig(enabled=True, debug_endpoints=False))
    srv = tserver.start_server(FakeForecaster())
    try:
        for path in ("/debug/trace", "/debug/profile", "/debug/cost",
                     "/debug/quality", "/debug/ingest"):
            assert _raw(srv.server_address[1], "GET", path)[0] == 404
    finally:
        srv.shutdown()

    global_tracing(ttrace.TraceConfig(enabled=True, debug_endpoints=True))
    srv = tserver.start_server(FakeForecaster())
    port = srv.server_address[1]
    try:
        code, doc, _ = _json(port, "GET", "/debug/trace")
        assert code == 200 and "traceEvents" in doc
        assert _raw(port, "GET", "/debug/profile?seconds=2")[0] == 503
        assert _raw(port, "GET", "/debug/profile?seconds=banana")[0] == 400
    finally:
        srv.shutdown()

    tracer = global_tracing(ttrace.TraceConfig(
        enabled=True, debug_endpoints=True,
        profile_dir=str(tmp_path / "prof")))
    srv = tserver.start_server(FakeForecaster())
    port = srv.server_address[1]
    try:
        code, out, _ = _json(port, "GET", "/debug/profile?seconds=0.2")
        assert code == 200 and out["seconds"] == 0.2
        assert os.path.isfile(os.path.join(out["capture_dir"], "trace.json"))
        tracer.profiler._active = True  # a capture in flight
        try:
            code, out, _ = _json(port, "GET", "/debug/profile?seconds=1")
        finally:
            tracer.profiler._active = False
        assert code == 409 and "in flight" in out["error"]
    finally:
        srv.shutdown()


def test_flight_recorder_dumped_on_5xx(tmp_path, global_tracing):
    """A 503 (the request outlived request_timeout_s) dumps the ring: the
    post-mortem exists without anyone asking for it."""
    dump_dir = tmp_path / "dumps"
    global_tracing(ttrace.TraceConfig(enabled=True, dump_dir=str(dump_dir)))
    release = threading.Event()
    srv = tserver.start_server(
        FakeForecaster(block_event=release),
        batching=tbatcher.BatchingConfig(
            enabled=True, max_batch_size=4, max_wait_ms=0.0,
            max_queue_depth=8, request_timeout_s=0.1))
    try:
        code, _, _ = _raw(srv.server_address[1], "POST", "/invocations",
                          {"inputs": [{"store": 1, "item": 1}], "horizon": 3})
        assert code == 503
        deadline = time.time() + 5
        while time.time() < deadline and not list(dump_dir.glob("*")):
            time.sleep(0.05)
        dumps = list(dump_dir.glob("flight-*-http-503.trace.json"))
        assert dumps, list(dump_dir.glob("*"))
        assert json.load(open(dumps[0]))["traceEvents"]
    finally:
        release.set()
        srv.shutdown()


def test_debug_cost_endpoint_gated(fresh_cost, global_tracing):
    """/debug/cost: 404 with the debug endpoints off, 503 with the cost
    block disabled, else the cost table with its roofline placement; the
    registry rides /metrics."""
    global_tracing(ttrace.TraceConfig(enabled=True, debug_endpoints=False))
    srv = tserver.start_server(FakeForecaster())
    try:
        assert _raw(srv.server_address[1], "GET", "/debug/cost")[0] == 404
    finally:
        srv.shutdown()
    global_tracing(ttrace.TraceConfig(enabled=True, debug_endpoints=True))
    srv = tserver.start_server(FakeForecaster())
    port = srv.server_address[1]
    try:
        tcost.configure_cost(tcost.CostConfig(enabled=False))
        assert _raw(port, "GET", "/debug/cost")[0] == 503
        tcost.configure_cost(tcost.CostConfig(
            enabled=True, peak_flops=1e12, peak_bytes_per_s=1e11))
        cm = tcost.cost_metrics()
        cm.record_program("serving_predict:fake",
                          {"flops": 4e8, "bytes_accessed": 2e7},
                          key="beefcafe")
        cm.record_dispatch("serving_predict:fake", "fake", 0.004)
        code, snap, _ = _json(port, "GET", "/debug/cost")
        assert code == 200
        assert snap["config"]["ridge_intensity"] == pytest.approx(10.0)
        assert snap["watermarks"]["host_rss_bytes"] > 0
        (row,) = [r for r in snap["entries"]
                  if r["entry"] == "serving_predict:fake"]
        assert row["bound"] == "compute"  # intensity 20 against a ridge of 10
        assert row["dispatches"] == 1.0
        text = _raw(port, "GET", "/metrics")[1].decode()
        assert "dftpu_cost_device_saturation" in text
        assert 'dftpu_cost_program_flops{entry="serving_predict:fake"' in text
    finally:
        srv.shutdown()


# -- the debug routes' answers against the reference --------------------------

DEBUG_CASES = {
    "trace_off": (False, "/debug/trace"),
    "profile_off": (False, "/debug/profile?seconds=1"),
    "cost_off": (False, "/debug/cost"),
    "quality_off": (False, "/debug/quality"),
    "ingest_off": (False, "/debug/ingest"),
    "profile_no_dir": (True, "/debug/profile?seconds=2"),
    "profile_bad_seconds": (True, "/debug/profile?seconds=banana"),
    "profile_busy": (True, "/debug/profile?seconds=1"),
    "quality_absent": (True, "/debug/quality"),
    "ingest_absent": (True, "/debug/ingest"),
    "cost_disabled": (True, "/debug/cost"),
    "unknown_route": (True, "/debug/nope"),
}


@pytest.mark.parametrize("case", list(DEBUG_CASES))
def test_debug_answers_like_the_reference(case, tmp_path, fresh_cost):
    on, path = DEBUG_CASES[case]
    answers = {}
    try:
        for tag, (server, _, trace, cost) in PKGS.items():
            tracer = trace.configure_tracing(trace.TraceConfig(
                enabled=True, debug_endpoints=on,
                profile_dir=(str(tmp_path / tag) if case == "profile_busy"
                             else None)))
            if case == "profile_busy":
                tracer.profiler._active = True
            cost.configure_cost(cost.CostConfig(
                enabled=case != "cost_disabled"))
            srv = server.start_server(FakeForecaster())
            try:
                answers[tag] = _raw(srv.server_address[1], "GET", path)
            finally:
                srv.shutdown()
    finally:
        for _, _, trace, _ in PKGS.values():
            trace.configure_tracing(trace.TraceConfig())
    (g_code, g_body, g_head), (w_code, w_body, w_head) = (
        answers["port"], answers["ref"])
    assert g_code == w_code
    assert g_head.get("Retry-After") == w_head.get("Retry-After")
    assert g_head.get("Content-Type") == w_head.get("Content-Type")
    assert json.loads(g_body) == json.loads(w_body)
    assert g_code == {"profile_bad_seconds": 400, "profile_busy": 409,
                      "unknown_route": 404}.get(
        case, 404 if not on else 503)


def test_dump_file_names_match_the_reference(tmp_path):
    """A 503 dumps the flight recorder in both packages under the same
    file-name pattern, ``flight-<stamp>-<n>-http-503.trace.json``."""
    names = {}
    try:
        for tag, (server, batcher, trace, _) in PKGS.items():
            dump_dir = tmp_path / tag
            trace.configure_tracing(trace.TraceConfig(
                enabled=True, dump_dir=str(dump_dir)))
            release = threading.Event()
            srv = server.start_server(
                FakeForecaster(block_event=release),
                batching=batcher.BatchingConfig(
                    enabled=True, max_batch_size=4, max_wait_ms=0.0,
                    max_queue_depth=8, request_timeout_s=0.1))
            try:
                code, _, _ = _raw(srv.server_address[1], "POST",
                                  "/invocations",
                                  {"inputs": [{"store": 1, "item": 1}],
                                   "horizon": 3})
                assert code == 503
                deadline = time.time() + 5
                while time.time() < deadline and not list(
                        dump_dir.glob("*.trace.json")):
                    time.sleep(0.05)
            finally:
                release.set()
                srv.shutdown()
            names[tag] = [p.name for p in dump_dir.glob("*")]
    finally:
        for _, _, trace, _ in PKGS.values():
            trace.configure_tracing(trace.TraceConfig())
    for tag in PKGS:
        assert len(names[tag]) == 1, names
        assert DUMP_NAME.fullmatch(names[tag][0]), names


# -- both servers under the shipped conf's runtimes ---------------------------

TRACE_IDS = {"invocations": "route0invocations",
             "quantiles": "route1quantiles",
             "padded": "route2padded",
             "observe": "route3observe",
             "detect": "route4detect",
             "ingest": "route5ingest"}
QUALITY = {"quality": {"enabled": True, "max_horizon": 60},
           "quality_store": {"enabled": True, "scrape_interval_s": 3600},
           "slo": {"enabled": True, "evaluation_interval_s": 3600},
           "cost": {"enabled": True}}
INGEST = {"enabled": True, "apply_mode": "sync", "time_bucket": 16,
          "refit": {"enabled": True, "max_applied_points": 10 ** 9,
                    "max_staleness_s": 1e9, "check_interval_s": 3600,
                    "drift_coverage_tol": 0.0}}
BATCHING = dict(enabled=True, max_batch_size=8, max_wait_ms=1.0,
                max_queue_depth=64, request_timeout_s=60.0)


def _requests(fc, df, day):
    """The traced requests, in order: ``day`` is the ordinal /ingest posts."""
    keys = [dict(zip(fc.key_names, map(int, k))) for k in fc.keys]
    last = df["date"].max()
    recent = df[df["date"] > last - pd.Timedelta(days=5)].rename(
        columns={"date": "ds", "sales": "y"})
    recent["ds"] = recent["ds"].dt.strftime("%Y-%m-%d")
    two = recent.merge(pd.DataFrame(keys[:2]))
    obs = two[["store", "item", "ds", "y"]].to_dict("records")
    pts = [{**p, "y": p["y"] * (6.0 if i == 3 else 1.0)}
           for i, p in enumerate(obs)]
    return [
        ("invocations", "/invocations", {"inputs": keys[:1], "horizon": 14}),
        ("quantiles", "/invocations",
         {"inputs": keys[:2], "horizon": 7, "quantiles": [0.1, 0.9]}),
        ("padded", "/invocations", {"inputs": keys[:5], "horizon": 5}),
        ("observe", "/observe", {"observations": obs}),
        ("detect", "/detect_anomalies", {"points": pts}),
        ("ingest", "/ingest",
         {"points": [{**k, "d": day, "y": 100.0 + i}
                     for i, k in enumerate(keys)]}),
    ]


def _spans(doc):
    """Chrome-trace events -> span dicts (kind, ids, attributes).  The
    span's own ``status`` shares ``args`` with the attributes (an
    ``http.request``'s HTTP status overrides it), so it stays there."""
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        args = dict(e["args"])
        out.append({"kind": e["name"], "tid": e["tid"],
                    "trace_id": args.pop("trace_id"),
                    "span_id": args.pop("span_id"),
                    "parent_id": args.pop("parent_id"), "attrs": args})
    return out


def _attrs(span):
    """A span's attributes but times, ids and paths; ``trace_ids`` by
    count; ``aot.call``'s ``outcome`` pinned apart (module docstring)."""
    attrs = {k: v for k, v in span["attrs"].items() if k not in TIMED}
    if "trace_ids" in attrs:
        attrs["trace_ids"] = len(attrs["trace_ids"])
    if span["kind"] == "aot.call":
        attrs.pop("outcome")
    return attrs


def _tree(spans):
    """(kinds, parent/child edges by kind, sorted (kind, attributes))."""
    kind_of = {s["span_id"]: s["kind"] for s in spans}
    edges = {(kind_of.get(s["parent_id"]), s["kind"]) for s in spans}
    rows = sorted(json.dumps([s["kind"], _attrs(s)], sort_keys=True)
                  for s in spans)
    return {s["kind"] for s in spans}, edges, rows


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' scorers on one theta artifact, after a warm round and
    a traced round of :func:`_requests` and a forced refit: every answer,
    trace and registry the tests below compare."""
    restore = [_isolate_cost(m) for m in (tcost, jcost)]
    tmp = tmp_path_factory.mktemp("scorer_trace")
    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=120,
                                          seed=13)
    jb = jdata.tensorize(df)
    cfg = jbase.get_model("theta").config_cls()
    params = jbase.get_model("theta").fit(jb.y, jb.mask, jb.day, cfg)
    art = str(tmp / "artifact")
    jpred.BatchForecaster.from_fit(jb, params, "theta", cfg).save(art)
    history = (np.asarray(jb.y), np.asarray(jb.mask))
    jcc.configure_compile_cache(jcc.CompileCacheConfig(
        enabled=True, directory=str(tmp / "cc"), aot_store=True))
    servers, out = {}, {"df": df}
    try:
        for tag, (server, batcher, trace, _) in PKGS.items():
            trace.configure_tracing(trace.TraceConfig(
                enabled=True, debug_endpoints=True))
            if tag == "ref":
                fc = jpred.BatchForecaster.load(art)
                quality = jq.build_quality_runtime(
                    QUALITY, fc, default_store_dir=str(tmp / "q_ref"))
                ingest = jingest.build_ingest_runtime(
                    {**INGEST, "wal_dir": str(tmp / "wal_ref")}, fc,
                    history_y=history[0], history_mask=history[1],
                    quality=quality)
                anomaly = janom.build_anomaly_runtime(
                    {"enabled": True}, fc,
                    default_store_dir=str(tmp / "an_ref"))
            else:
                fc = tpred.BatchForecaster.load(art, device="cpu")
                quality = tq.build_quality_runtime(
                    QUALITY, fc, default_store_dir=str(tmp / "q_port"))
                ingest = tingest.build_ingest_runtime(
                    {**INGEST, "wal_dir": str(tmp / "wal_port")}, fc,
                    history_y=history[0], history_mask=history[1],
                    quality=quality, device="cpu")
                anomaly = tanom.build_anomaly_runtime(
                    {"enabled": True}, fc,
                    default_store_dir=str(tmp / "an_port"))
            servers[tag] = server.start_server(
                fc, model_version="1",
                batching=batcher.BatchingConfig(**BATCHING),
                quality=quality, ingest=ingest, anomaly=anomaly)
        fc = servers["port"].forecaster
        day = int(fc.day1) + 1
        # the warm round: the reference's AOT store compiles each program
        # once (aot.load / aot.compile spans); the traced round hits memo
        for tag, srv in servers.items():
            for _, path, body in _requests(fc, df, day):
                assert _raw(srv.server_address[1], "POST", path,
                            body)[0] == 200
        answers = {}
        for tag, srv in servers.items():
            trace = PKGS[tag][2]
            tracer = trace.configure_tracing(trace.TraceConfig(
                enabled=True, debug_endpoints=True))
            number = srv.server_address[1]
            answers[tag] = {
                route: _raw(number, "POST", path, body,
                            {"X-Trace-Id": TRACE_IDS[route]})
                for route, path, body in _requests(fc, df, day + 1)}
            refit = srv.ingest.refit
            assert refit.maybe_refit(force=True) == "forced"
            assert refit.wait(timeout=120)["day_snap"] == day + 1
            time.sleep(0.3)  # the last root spans close after the response
            answers[tag]["debug_trace"] = _json(number, "GET",
                                                "/debug/trace")
            answers[tag]["dump"] = trace.dump_flight_recorder(
                "parity", directory=str(tmp / f"dump_{tag}"), tracer=tracer)
            for route in ("quality", "ingest", "cost"):
                answers[tag][f"debug_{route}"] = _json(
                    number, "GET", f"/debug/{route}")
            answers[tag]["metrics"] = _raw(number, "GET", "/metrics")[1]
            srv.quality.scrape.scrape_once(now=2_000_000_000.0)
            answers[tag]["store"] = srv.quality.store.query(
                since=2_000_000_000.0)
        out["answers"] = answers
        out["forecaster"] = fc
        yield out
    finally:
        for srv in servers.values():
            srv.shutdown()
        for _, _, trace, _ in PKGS.values():
            trace.configure_tracing(trace.TraceConfig())
        jcc.configure_compile_cache(jcc.CompileCacheConfig(enabled=False))
        for r in restore:
            r()


def _trace_spans(served, tag):
    code, doc, _ = served["answers"][tag]["debug_trace"]
    assert code == 200
    return _spans(doc)


@pytest.mark.parametrize("route", list(TRACE_IDS))
def test_route_span_trees_equal_the_reference(served, route):
    """Each route's request: its status and X-Trace-Id, then the span
    kinds, edges and attributes under its trace id."""
    trees = {}
    for tag in PKGS:
        code, _, head = served["answers"][tag][route]
        assert code == 200 and head["X-Trace-Id"] == TRACE_IDS[route]
        spans = [s for s in _trace_spans(served, tag)
                 if s["trace_id"] == TRACE_IDS[route]]
        trees[tag] = _tree(spans)
        root = [s for s in spans if s["kind"] == "http.request"]
        assert len(root) == 1 and root[0]["parent_id"] is None
        assert root[0]["attrs"]["status"] == 200
        if route != "observe":  # /observe predicts on the handler thread
            assert len({s["tid"] for s in spans}) >= 2, spans
    assert trees["port"][0] == trees["ref"][0]
    assert trees["port"][1] == trees["ref"][1]
    assert trees["port"][2] == trees["ref"][2]
    kinds = trees["port"][0]
    want = {"invocations": {"batcher.queue_wait", "batcher.dispatch",
                            "serving.predict", "aot.call"},
            "quantiles": {"batcher.dispatch", "serving.predict_quantiles"},
            "padded": {"batcher.dispatch", "serving.predict", "aot.call"},
            "observe": {"quality.observe", "serving.predict", "aot.call"},
            "detect": {"anomaly.score", "batcher.dispatch",
                       "serving.predict"},
            "ingest": {"ingest.append", "anomaly.score", "state.update",
                       "aot.call"}}[route]
    assert want <= kinds, kinds
    if route == "invocations":
        spans = [s for s in _trace_spans(served, "port")
                 if s["trace_id"] == TRACE_IDS[route]]
        by_kind = {s["kind"]: s for s in spans}
        assert (by_kind["batcher.dispatch"]["parent_id"]
                == by_kind["http.request"]["span_id"])


def test_refit_span_tree_equals_the_reference(served):
    """The forced refit's spans (its own trace: no request caused it)."""
    trees = {}
    for tag in PKGS:
        spans = [s for s in _trace_spans(served, tag)
                 if s["trace_id"] not in TRACE_IDS.values()]
        trees[tag] = _tree(spans)
    assert trees["port"] == trees["ref"]
    assert {"pipeline.prep", "pipeline.dispatch", "pipeline.complete",
            "refit.swap"} <= trees["port"][0]
    assert ("pipeline.complete", "refit.swap") in trees["port"][1]


def test_debug_ingest_and_quality_bodies_equal_the_reference(served):
    bodies = {tag: {r: served["answers"][tag][f"debug_{r}"]
                    for r in ("ingest", "quality")} for tag in PKGS}
    for route in ("ingest", "quality"):
        assert bodies["port"][route][0] == bodies["ref"][route][0] == 200
    got, want = (bodies[t]["ingest"][1] for t in ("port", "ref"))
    for body in (got, want):
        assert body["store"].pop("seconds_since_refit") >= 0  # time-valued
    assert got == want
    assert got["refit"]["refits_done"] == 1 and got["wal"]["bytes"] > 0
    got, want = (bodies[t]["quality"][1] for t in ("port", "ref"))
    assert set(got) == set(want) == {"quality", "slo", "store"}
    assert got["slo"] == want["slo"]
    # the store's directory is each server's own; its byte count rides the
    # rows' float digits
    for body in (got, want):
        assert body["store"].pop("directory") and body["store"].pop(
            "bytes") > 0
    assert got["store"] == want["store"]
    gq, wq = got["quality"], want["quality"]
    assert set(gq) == set(wq)
    for k in ("family", "n_series", "series_observed", "observations",
              "nominal_coverage"):
        assert gq[k] == wq[k], k
    for m, v in wq["metrics"].items():
        np.testing.assert_allclose(gq["metrics"][m], v, rtol=1e-5)
    assert ([[r[k] for k in ("store", "item", "n")]
             for r in gq["worst_series"]]
            == [[r[k] for k in ("store", "item", "n")]
                for r in wq["worst_series"]])


def _cost_families(text):
    return sorted(ln for ln in text.decode().splitlines()
                  if ln.startswith(("# HELP dftpu_cost_",
                                    "# TYPE dftpu_cost_")))


def test_cost_families_and_rows_equal_the_reference(served):
    """The ``dftpu_cost_*`` families on /metrics; the serving entries'
    store rows after one scrape, with their dispatch and padding counts;
    /debug/cost's serving rows."""
    answers = served["answers"]
    assert (_cost_families(answers["port"]["metrics"])
            == _cost_families(answers["ref"]["metrics"]))
    rows = {}
    for tag in PKGS:
        rows[tag] = {
            (p["name"], json.dumps(p["labels"], sort_keys=True)): p["value"]
            for p in answers[tag]["store"]
            if p["name"].startswith("dftpu_cost_")}
    # the attribution families; the program rows are pinned below
    serving = {tag: {k: v for k, v in r.items()
                     if '"serving_predict' in k[1]
                     and not k[0].startswith("dftpu_cost_program_")}
               for tag, r in rows.items()}
    assert set(serving["port"]) == set(serving["ref"])
    for key, value in serving["ref"].items():
        if key[0] in ("dftpu_cost_dispatches_total",
                      "dftpu_cost_padding_rows_total",
                      "dftpu_cost_padding_waste"):
            assert serving["port"][key] == value, key
    pad = {k: v for k, v in serving["port"].items()
           if k[0] == "dftpu_cost_padding_rows_total" and '"pad"' in k[1]}
    assert pad and sum(pad.values()) > 0  # the 5-series request's pad row
    unlabeled = {tag: sorted(k[0] for k in r if k[1] == "{}")
                 for tag, r in rows.items()}
    assert unlabeled["port"] == unlabeled["ref"]
    # pinned: aot_call charges the streaming update's entry in the port
    # (ROADMAP Queue 3); the reference's rows for it are its
    # compiled program's costs, which eager PyTorch does not have
    assert any('"state_update:theta"' in k[1]
               and k[0] == "dftpu_cost_dispatches_total"
               for k in rows["port"])
    assert not any(k[0].startswith("dftpu_cost_program_")
                   and '"serving_predict' in k[1] for k in rows["port"])
    snaps = {tag: answers[tag]["debug_cost"] for tag in PKGS}
    assert snaps["port"][0] == snaps["ref"][0] == 200
    assert snaps["port"][1]["config"] == snaps["ref"][1]["config"]
    assert set(snaps["port"][1]["watermarks"]) == set(
        snaps["ref"][1]["watermarks"])
    entries = {tag: {r["entry"]: (r.get("family"), r.get("dispatches"))
                     for r in s[1]["entries"]
                     if r["entry"].startswith("serving_predict")}
               for tag, s in snaps.items()}
    assert entries["port"] == entries["ref"]
    # on the CPU the scrape's watermark sample never starts CUDA
    assert not torch.cuda.is_initialized()


@pytest.fixture(scope="module")
def trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report_under_test",
        os.path.join(REPO, "scripts", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_report_reads_both_dumps_alike(served, trace_report):
    """``scripts/trace_report.py`` over each package's flight-recorder
    dump: the same kinds and counts by kind, the same /observe rollup per
    trace id and the same streaming rollup's counts and volumes."""
    report = {}
    for tag in PKGS:
        spans = trace_report.load_spans(served["answers"][tag]["dump"])
        report[tag] = {
            "by_kind": sorted((r["kind"], r["count"])
                              for r in trace_report.by_kind(spans)),
            "quality": sorted((r["trace_id"], r["spans"], r["rows"])
                              for r in trace_report.quality_rollup(spans)),
            "streaming": sorted((r["kind"], r["count"], r["points"],
                                 r["series"])
                                for r in trace_report.streaming_rollup(
                                    spans))}
    assert report["port"] == report["ref"]
    assert ("route3observe", 1, len(_requests(
        served["forecaster"], served["df"], 0)[3][2]["observations"])) in \
        report["port"]["quality"]
    assert {k for k, *_ in report["port"]["streaming"]} == {
        "ingest.append", "state.update", "refit.swap"}
