"""Port parity: the HTTP scorer (``serving/server.py``).

One curve-model artifact, written by the reference with a conformal band
scale, is served on ``127.0.0.1:0`` by the reference (JAX on the CPU) and by
the port (torch on the CPU), each with its quality runtime; the same
requests go to both.  For every case the status, the headers the reference
sets (Content-Type, Retry-After, X-Trace-Id: the client's, or one minted per
request on both sides) and the JSON layout are equal:
error bodies byte for byte, and for forecasts the keys, dates, ``n_series``
and column order, with values within rtol 1e-5 / atol 1e-5 of the data's
scale (the reference's own parameters; only the forecast arithmetic rounds
differently, ``tests/test_torch_predictor.py``).  ``/observe`` summaries
agree within rtol 1e-5.  ``/metrics`` carries, for every family the port
registers, the reference's name, type, help text and bucket edges.

A second pair of servers carries the shipped serve conf's runtimes: the
quality store, the SLO evaluator and an anomaly scorer.  ``POST
/detect_anomalies`` answers every status of the reference's contract (200,
400, 404, 429, 503) with its headers and error bodies; a 200 body equals the
in-process scorer's byte for byte, and the reference's within the curve
model's predict tolerance (``tests/test_torch_anomaly.py`` states it).
``/metrics`` appends the ``dftpu_slo_*``, ``dftpu_anomaly_*`` and
``dftpu_data_quality_*`` families as the reference does, ``/debug/quality``
is a 404 as in the reference with ``tracing.debug_endpoints`` off, and
``shutdown`` joins the scrape and SLO threads and leaves the final scrape
on disk.
"""

import json
import os
import re
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
from distributed_forecasting_tpu.data import quality as jdq
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import prophet_glm as jpg
from distributed_forecasting_tpu.monitoring import quality as jq
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu.serving import anomaly as janom
from distributed_forecasting_tpu.serving import server as jserver
from distributed_forecasting_tpu_torch.data import quality as tdq
from distributed_forecasting_tpu_torch.monitoring import quality as tq
from distributed_forecasting_tpu_torch.serving import anomaly as tanom
from distributed_forecasting_tpu_torch.serving import predictor as tpred
from distributed_forecasting_tpu_torch.serving import server as tserver

torch.set_num_threads(1)

QUALITY = {"quality": {"enabled": True, "max_horizon": 60}}
HEADERS = ("Content-Type", "Retry-After", "X-Trace-Id")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=760,
                                          seed=4)
    jb = jdata.tensorize(df)
    cfg = jpg.CurveModelConfig()
    params, _ = jfit.fit_forecast(jb, model="prophet", config=cfg, horizon=30,
                                  autoprep=False)
    scale = np.linspace(0.8, 1.2, jb.n_series).astype(np.float32)
    path = str(tmp_path_factory.mktemp("served"))
    jpred.BatchForecaster.from_fit(jb, params, "prophet", cfg,
                                   interval_scale=scale).save(path)
    jfc = jpred.BatchForecaster.load(path)
    tfc = tpred.BatchForecaster.load(path, device="cpu")
    ref = jserver.start_server(jfc, model_version="3",
                               quality=jq.build_quality_runtime(QUALITY, jfc))
    port = tserver.start_server(tfc, model_version="3",
                                quality=tq.build_quality_runtime(QUALITY, tfc))
    yield {"ref": ref, "port": port, "df": df,
           "scale": float(np.abs(np.asarray(jb.y)).max())}
    ref.shutdown()
    port.shutdown()


def _raw(srv, method, path, payload=None, headers=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = None
    if payload is not None:
        data = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _observations(df, n_series=3):
    last = df["date"].max()
    obs = df[df["date"] > last - pd.Timedelta(days=28)]
    keys = obs[["store", "item"]].drop_duplicates().head(n_series)
    obs = obs.merge(keys).rename(columns={"date": "ds", "sales": "y"})
    obs["ds"] = obs["ds"].dt.strftime("%Y-%m-%d")
    return obs[["store", "item", "ds", "y"]].to_dict("records")


ONE = [{"store": 1, "item": 2}]
TWO = [{"store": 2, "item": 3}, {"store": 1, "item": 1}]

CASES = {
    "health": ("GET", "/health", None, None),
    "healthz": ("GET", "/healthz", None, None),
    "readyz": ("GET", "/readyz", None, None),
    "schema": ("GET", "/schema", None, None),
    "get_unknown_route": ("GET", "/nope", None, None),
    "debug_trace": ("GET", "/debug/trace", None, None),
    "debug_quality": ("GET", "/debug/quality", None, None),
    "invocations": ("POST", "/invocations", {"inputs": TWO, "horizon": 14},
                    None),
    "predict_route": ("POST", "/predict", {"inputs": ONE, "horizon": 5}, None),
    "default_horizon": ("POST", "/invocations", {"inputs": ONE}, None),
    "include_history": ("POST", "/invocations",
                        {"inputs": ONE, "horizon": 3,
                         "include_history": True}, None),
    "duplicate_keys": ("POST", "/invocations",
                       {"inputs": ONE + TWO + ONE, "horizon": 4}, None),
    "quantiles": ("POST", "/invocations",
                  {"inputs": TWO, "horizon": 7,
                   "quantiles": [0.9, 0.1, 0.5, 0.1004]}, None),
    "trace_id_echo": ("POST", "/invocations", {"inputs": ONE, "horizon": 2},
                      {"X-Trace-Id": "abc-123_X"}),
    "trace_id_hostile": ("POST", "/invocations",
                         {"inputs": ONE, "horizon": 2},
                         {"X-Trace-Id": "bad id;rm"}),
    "deadline_spent": ("POST", "/invocations", {"inputs": ONE, "horizon": 2},
                       {"X-Deadline-Ms": "0"}),
    "deadline_garbage": ("POST", "/invocations",
                         {"inputs": ONE, "horizon": 2},
                         {"X-Deadline-Ms": "soon"}),
    "unknown_series": ("POST", "/invocations",
                       {"inputs": [{"store": 99, "item": 1}], "horizon": 5},
                       None),
    "unknown_series_skipped": ("POST", "/invocations",
                               {"inputs": [{"store": 99, "item": 1}] + ONE,
                                "horizon": 5, "on_missing": "skip"}, None),
    "all_skipped": ("POST", "/invocations",
                    {"inputs": [{"store": 99, "item": 1}], "horizon": 5,
                     "on_missing": "skip"}, None),
    "empty_body": ("POST", "/invocations", {}, None),
    "empty_inputs": ("POST", "/invocations", {"inputs": []}, None),
    "missing_key_column": ("POST", "/invocations",
                           {"inputs": [{"store": 1}]}, None),
    "list_body": ("POST", "/invocations", ONE, None),
    "not_json": ("POST", "/invocations", b"{oops", None),
    "horizon_zero": ("POST", "/invocations", {"inputs": ONE, "horizon": 0},
                     None),
    "horizon_huge": ("POST", "/invocations",
                     {"inputs": ONE, "horizon": 100_000_000}, None),
    "horizon_null": ("POST", "/invocations",
                     {"inputs": ONE, "horizon": None}, None),
    "quantiles_bad": ("POST", "/invocations",
                      {"inputs": ONE, "quantiles": [0.5, 1.5]}, None),
    "quantiles_round_to_zero": ("POST", "/invocations",
                                {"inputs": ONE, "quantiles": [0.0001]}, None),
    "on_missing_bogus": ("POST", "/invocations",
                         {"inputs": ONE, "on_missing": "maybe"}, None),
    "post_unknown_route": ("POST", "/nope", {"inputs": ONE}, None),
    "ingest_absent": ("POST", "/ingest", {"points": []}, None),
    "anomalies_absent": ("POST", "/detect_anomalies", {"points": []}, None),
    "observe": ("POST", "/observe", "OBS", None),
    "observe_raise_missing": ("POST", "/observe", "OBS_UNKNOWN", None),
    "observe_empty": ("POST", "/observe", {"observations": []}, None),
    "observe_list_body": ("POST", "/observe", [1], None),
    "observe_missing_column": ("POST", "/observe",
                               {"observations": [{"store": 1, "item": 1,
                                                  "ds": "2015-01-01"}]},
                               None),
}


def _payload(servers, payload):
    if payload == "OBS":
        return {"observations": _observations(servers["df"])}
    if payload == "OBS_UNKNOWN":
        return {"observations": _observations(servers["df"]) + [
            {"store": 42, "item": 1, "ds": "2015-01-01", "y": 1.0}],
            "on_missing": "raise"}
    return payload


def _assert_forecasts_match(got, want, scale):
    assert list(got) == list(want) == ["predictions", "n_series"]
    assert got["n_series"] == want["n_series"]
    assert len(got["predictions"]) == len(want["predictions"])
    for g, w in zip(got["predictions"], want["predictions"]):
        assert list(g) == list(w)  # column order
        for k, v in w.items():
            if isinstance(v, float):
                assert abs(g[k] - v) <= 1e-5 * abs(v) + 1e-5 * scale, (k, g, w)
            else:
                assert g[k] == v, k  # ds, store, item


def _assert_observe_match(got, want):
    assert list(got) == list(want)
    for k in ("family", "n_series", "series_observed", "observations",
              "nominal_coverage"):
        assert got[k] == want[k], k
    for m, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][m], v, rtol=1e-5)
    assert ([[(k, r[k]) for k in ("store", "item", "n")]
             for r in got["worst_series"]]
            == [[(k, r[k]) for k in ("store", "item", "n")]
                for r in want["worst_series"]])


@pytest.mark.parametrize("case", list(CASES))
def test_route_answers_like_the_reference(servers, case):
    method, path, payload, headers = CASES[case]
    payload = _payload(servers, payload)
    w_status, w_body, w_headers = _raw(servers["ref"], method, path, payload,
                                       headers)
    g_status, g_body, g_headers = _raw(servers["port"], method, path, payload,
                                       headers)
    assert g_status == w_status, (g_body, w_body)
    for h in HEADERS:
        if h == "X-Trace-Id" and not jserver._safe_trace_id(
                (headers or {}).get(h)):
            # minted per request when the client sends no usable id
            assert (re.fullmatch("[0-9a-f]{16}", g_headers.get(h) or "")
                    is not None) == (w_headers.get(h) is not None), h
        else:
            assert g_headers.get(h) == w_headers.get(h), h
    assert sorted(k for k in g_headers if k != "Date") == sorted(
        k for k in w_headers if k != "Date")
    got, want = json.loads(g_body), json.loads(w_body)
    if w_status == 200 and "predictions" in want:
        _assert_forecasts_match(got, want, servers["scale"])
    elif case == "observe":
        _assert_observe_match(got, want)
    else:
        assert got == want


def test_status_codes_cover_the_contract(servers):
    """The cases above reach every status the scorer answers with batching
    off: 200, 400, 404, 503."""
    seen = {_raw(servers["port"], m, p, _payload(servers, b), h)[0]
            for m, p, b, h in CASES.values()}
    assert seen == {200, 400, 404, 503}


def _families(text):
    """{name: (type, help, bucket edges)} of a Prometheus exposition."""
    out, helps = {}, {}
    for line in text.splitlines():
        m = re.match(r"# HELP (\S+) (.*)", line)
        if m:
            helps[m.group(1)] = m.group(2)
        m = re.match(r"# TYPE (\S+) (\S+)", line)
        if m:
            out[m.group(1)] = [m.group(2), helps.get(m.group(1)), []]
        m = re.match(r'(\S+)_bucket\{le="([^"]+)"\}', line)
        if m and m.group(1) in out:
            out[m.group(1)][2].append(m.group(2))
    return {k: tuple(v[:2]) + (tuple(v[2]),) for k, v in out.items()}


def _publish_data_quality(df):
    """One report in each package, so both expositions carry the
    process-wide data-quality family whatever ran before in this worker."""
    assert tdq.quality_report(df).to_dict() == jdq.quality_report(
        df).to_dict()


def test_metrics_families_match_the_reference(servers):
    _publish_data_quality(servers["df"])
    for srv in (servers["ref"], servers["port"]):
        _raw(srv, "POST", "/invocations", {"inputs": ONE, "horizon": 3})
    w_status, w_body, w_headers = _raw(servers["ref"], "GET", "/metrics")
    g_status, g_body, g_headers = _raw(servers["port"], "GET", "/metrics")
    assert g_status == w_status == 200
    assert g_headers["Content-Type"] == w_headers["Content-Type"]
    want, got = _families(w_body.decode()), _families(g_body.decode())
    assert set(got) >= {"serving_requests_total", "serving_batch_size",
                        "serving_request_latency_seconds",
                        "dftpu_http_workers_busy", "dftpu_quality_metric"}
    for name, fam in got.items():
        assert want.get(name) == fam, name


def test_batched_server_bodies_equal_the_unbatched_server(servers):
    """The port's coalescing server, under concurrent mixed-signature
    requests, answers byte for byte what its unbatched server answers, in
    fewer dispatches than requests."""
    payloads = [
        {"inputs": [{"store": 1, "item": 1}], "horizon": 14},
        {"inputs": [{"store": 1, "item": 2}], "horizon": 14},
        {"inputs": [{"store": 2, "item": 1}], "horizon": 14},
        {"inputs": [{"store": 2, "item": 3}], "horizon": 14},
        {"inputs": [{"store": 1, "item": 3}, {"store": 2, "item": 2}],
         "horizon": 14},
        {"inputs": [{"store": 1, "item": 1}], "horizon": 7,
         "quantiles": [0.1, 0.9]},
    ]
    want = [_raw(servers["port"], "POST", "/invocations", p)[1]
            for p in payloads]
    batched = tserver.start_server(
        servers["port"].forecaster,
        batching=tserver.BatchingConfig(enabled=True, max_batch_size=8,
                                        max_wait_ms=200.0,
                                        max_queue_depth=32,
                                        request_timeout_s=60.0))
    try:
        got = [None] * len(payloads)
        barrier = threading.Barrier(len(payloads))

        def client(i):
            barrier.wait()
            got[i] = _raw(batched, "POST", "/invocations", payloads[i])[1]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        snap = batched.metrics.snapshot()
    finally:
        batched.shutdown()
    assert got == want
    assert snap["serving_requests_total"] == len(payloads)
    assert snap["serving_dispatches_total"] < len(payloads)


def _blocking_forecaster(release, started):
    class Blocking:
        key_names = ("store", "item")
        family = "fake"
        n_series = 1
        coalesce_safe = True

        def predict(self, frame, horizon=90, **_):
            started.set()
            assert release.wait(10)
            return pd.DataFrame({"ds": pd.to_datetime(["2020-01-01"] * horizon),
                                 "store": 1, "item": 1, "yhat": 1.0})

    return Blocking()


def test_429_and_503_with_retry_after():
    """A full batching queue answers 429 with Retry-After: 1; a request that
    outlives request_timeout_s answers 503 with Retry-After: 1."""
    release, started = threading.Event(), threading.Event()
    srv = tserver.start_server(
        _blocking_forecaster(release, started),
        batching=tserver.BatchingConfig(enabled=True, max_batch_size=4,
                                        max_wait_ms=0.0, max_queue_depth=1,
                                        request_timeout_s=30.0))
    results = {}

    def fire(tag):
        results[tag] = _raw(srv, "POST", "/invocations",
                            {"inputs": ONE, "horizon": 2})[0]

    try:
        a = threading.Thread(target=fire, args=("a",))
        a.start()
        assert started.wait(10)  # a's dispatch is blocked in predict
        b = threading.Thread(target=fire, args=("b",))
        b.start()
        for _ in range(200):
            if srv.metrics.queue_depth.value >= 1:
                break
            threading.Event().wait(0.01)
        status, body, headers = _raw(srv, "POST", "/invocations",
                                     {"inputs": ONE, "horizon": 2})
        assert status == 429 and headers["Retry-After"] == "1"
        assert "queue is full" in json.loads(body)["error"]
        release.set()
        a.join(30)
        b.join(30)
    finally:
        release.set()
        srv.shutdown()
    assert results == {"a": 200, "b": 200}
    assert srv.metrics.rejections.value == 1

    release, started = threading.Event(), threading.Event()
    srv = tserver.start_server(
        _blocking_forecaster(release, started),
        batching=tserver.BatchingConfig(enabled=True, max_batch_size=4,
                                        max_wait_ms=0.0, max_queue_depth=8,
                                        request_timeout_s=0.1))
    try:
        status, body, headers = _raw(srv, "POST", "/invocations",
                                     {"inputs": ONE, "horizon": 2})
        assert status == 503 and headers["Retry-After"] == "1"
        assert "timed out" in json.loads(body)["error"]
        assert srv.metrics.timeouts.value == 1
    finally:
        release.set()
        srv.shutdown()


def test_readyz_until_marked_ready_and_after_shutdown(servers):
    srv = tserver.start_server(servers["port"].forecaster, ready=False)
    try:
        assert _raw(srv, "GET", "/healthz")[0] == 200
        status, body, headers = _raw(srv, "GET", "/readyz")
        assert status == 503 and headers["Retry-After"] == "1"
        assert json.loads(body) == {"ready": False, "reason": "warming up"}
        srv.mark_ready()
        assert _raw(srv, "GET", "/readyz")[0] == 200
    finally:
        srv.shutdown()
    assert srv.readiness()[0] is False


@pytest.mark.parametrize("runtime", ["ingest", "cache"])
def test_unported_runtimes_are_refused(servers, runtime):
    """``cache=`` (P12) is refused; ``ingest=`` is ported: the server takes
    the runtime, starts it at construction and stops it in ``shutdown``
    (``tests/test_torch_ingest.py`` drives a real one)."""
    if runtime == "ingest":
        calls = []
        ingest = types.SimpleNamespace(
            start=lambda: calls.append("start"),
            stop=lambda: calls.append("stop"),
            wal=types.SimpleNamespace(directory="wal"),
            config=types.SimpleNamespace(apply_mode="sync"), refit=None)
        srv = tserver.start_server(servers["port"].forecaster,
                                   ingest=ingest)
        assert srv.ingest is ingest and calls == ["start"]
        srv.shutdown()
        assert calls == ["start", "stop"]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1: P12"):
        tserver.ForecastServer(("127.0.0.1", 0), servers["port"].forecaster,
                               **{runtime: object()})


def test_encode_predictions_and_trace_ids_match_the_reference(servers):
    fc = servers["port"].forecaster
    out = fc.predict(pd.DataFrame(TWO), horizon=3)
    assert (tserver._encode_predictions(out, fc.key_names)
            == jserver._encode_predictions(out, fc.key_names))
    empty = out.iloc[0:0]
    assert (tserver._encode_predictions(empty, fc.key_names)
            == jserver._encode_predictions(empty, fc.key_names))
    for raw in (None, "", "ok-1_A", " padded ", "x" * 65, "semi;colon"):
        assert tserver._safe_trace_id(raw) == jserver._safe_trace_id(raw)


def test_kernel_library_loads_once_under_concurrent_first_use(monkeypatch):
    """Handler threads may make the first kernel launch together: the
    library is built and loaded once (the build itself runs only on the
    card's machine, so a slow stand-in takes its place here)."""
    import time

    from distributed_forecasting_tpu_torch.ops import _build

    loads = []

    def slow_load():
        loads.append(threading.get_ident())
        time.sleep(0.2)
        return object()

    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "_load", slow_load)
    barrier = threading.Barrier(8)
    got = [None] * 8

    def first_use(i):
        barrier.wait()
        got[i] = _build.library()

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(loads) == 1
    assert all(g is got[0] for g in got) and got[0] is not None


# -- the shipped serve conf's runtimes: store, SLO, anomaly scorer ------------

MONITORING = {
    "quality": {"enabled": True, "max_horizon": 60},
    "quality_store": {"enabled": True, "scrape_interval_s": 3600},
    "slo": {"enabled": True, "evaluation_interval_s": 3600,
            "rules": [{"name": "predict_latency_p95",
                       "kind": "latency_quantile", "quantile": 0.95,
                       "objective": 0.5},
                      {"name": "calibration_coverage", "kind": "coverage",
                       "tolerance": 0.05},
                      {"name": "model_staleness", "kind": "staleness",
                       "objective": 604800}]},
}
ANOMALY = {"enabled": True, "max_points_per_request": 500}


@pytest.fixture(scope="module")
def detecting(servers, tmp_path_factory):
    root = tmp_path_factory.mktemp("detecting")
    out = {"df": servers["df"], "scale": servers["scale"], "root": root}
    for side, pkg_q, pkg_a, srv_mod, fc in (
            ("ref", jq, janom, jserver, servers["ref"].forecaster),
            ("port", tq, tanom, tserver, servers["port"].forecaster)):
        quality = pkg_q.build_quality_runtime(
            MONITORING, fc, default_store_dir=str(root / f"store_{side}"))
        anomaly = pkg_a.build_anomaly_runtime(
            ANOMALY, fc, default_store_dir=str(root / f"stream_{side}"))
        out[side] = srv_mod.start_server(fc, model_version="3",
                                         quality=quality, anomaly=anomaly)
    yield out
    for side in ("ref", "port"):
        out[side].shutdown()


def _points(df, n_series=3, spikes=(2, 9, 20)):
    last = df["date"].max()
    pts = df[df["date"] > last - pd.Timedelta(days=20)]
    keys = pts[["store", "item"]].drop_duplicates().head(n_series)
    pts = pts.merge(keys).rename(columns={"date": "ds", "sales": "y"})
    pts["ds"] = pts["ds"].dt.strftime("%Y-%m-%d")
    pts = pts[["store", "item", "ds", "y"]].reset_index(drop=True)
    for i in spikes:
        pts.at[i, "y"] = float(pts.at[i, "y"]) * 6.0 + 500.0
    return pts.to_dict("records")


DETECT = {
    "detect": {"points": "PTS"},
    "detect_threshold": {"points": "PTS", "threshold": 3.5},
    "detect_unknown_skipped": {"points": "PTS_UNKNOWN"},
    "detect_unknown_raise": {"points": "PTS_UNKNOWN", "on_missing": "raise"},
    "detect_all_skipped": {"points": [{"store": 42, "item": 1,
                                       "ds": "2015-01-01", "y": 1.0}]},
    "detect_list_body": [1, 2],
    "detect_no_points": {"threshold": 2.0},
    "detect_empty_points": {"points": []},
    "detect_points_not_list": {"points": {"store": 1}},
    "detect_too_many": {"points": "PTS_MANY"},
    "detect_threshold_zero": {"points": "PTS", "threshold": 0},
    "detect_threshold_negative": {"points": "PTS", "threshold": -1.5},
    "detect_threshold_text": {"points": "PTS", "threshold": "high"},
    "detect_missing_column": {"points": [{"store": 1, "ds": "2015-01-01",
                                          "y": 1.0}]},
    "detect_not_json": b"{oops",
    "detect_trace_id": {"points": "PTS"},
}


def _detect_payload(df, payload):
    if isinstance(payload, dict) and isinstance(payload.get("points"), str):
        pts = _points(df)
        extra = {"PTS": [], "PTS_UNKNOWN": [
            {"store": 42, "item": 1, "ds": pts[0]["ds"], "y": 3.0}],
            "PTS_MANY": pts * 40}[payload["points"]]
        pts = pts * 0 + extra if payload["points"] == "PTS_MANY" else (
            pts + extra)
        return dict(payload, points=pts)
    return payload


def _assert_detections_match(got, want, scale):
    """The curve model's predict tolerance on the bands, its propagation on
    the scores, flags equal away from the threshold, the threshold within
    two float32 ulps (the inverse normal's last digit)."""
    assert list(got) == list(want)
    thr = want["threshold"]
    assert abs(got["threshold"] - thr) <= 2 * np.spacing(np.float32(thr))
    for k in ("n_scored", "n_flagged", "n_skipped"):
        assert got[k] == want[k], k
    for g, w in zip(got["results"], want["results"]):
        assert list(g) == list(w)
        for k in ("store", "item", "ds", "y"):
            assert g[k] == w[k], k
        for k in ("yhat", "yhat_lower", "yhat_upper"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]) + 1e-5 * scale, k
        e = 1e-5 * abs(w["yhat_upper"]) + 1e-5 * scale
        tol = (2 * e * (2.6 + 2 * w["anomaly_score"])
               / (w["yhat_upper"] - w["yhat"]) + 1e-6)
        assert abs(g["anomaly_score"] - w["anomaly_score"]) <= tol
        if abs(w["anomaly_score"] - thr) > tol:
            assert g["is_anomaly"] == w["is_anomaly"]


@pytest.mark.parametrize("case", list(DETECT))
def test_detect_anomalies_answers_like_the_reference(detecting, case):
    payload = _detect_payload(detecting["df"], DETECT[case])
    headers = {"X-Trace-Id": "detect-1"} if case == "detect_trace_id" else {}
    w_status, w_body, w_headers = _raw(detecting["ref"], "POST",
                                       "/detect_anomalies", payload, headers)
    g_status, g_body, g_headers = _raw(detecting["port"], "POST",
                                       "/detect_anomalies", payload, headers)
    assert g_status == w_status, (g_body, w_body)
    for h in ("Content-Type", "Retry-After"):
        assert g_headers.get(h) == w_headers.get(h), h
    if headers:
        assert g_headers["X-Trace-Id"] == w_headers["X-Trace-Id"] == "detect-1"
    else:
        assert re.fullmatch("[0-9a-f]{16}", g_headers.get("X-Trace-Id", ""))
    got, want = json.loads(g_body), json.loads(w_body)
    if w_status == 200:
        _assert_detections_match(got, want, detecting["scale"])
        # the served body is the in-process scorer's, byte for byte
        scorer = tanom.AnomalyScorer(detecting["port"].forecaster,
                                     tanom.AnomalyConfig.from_conf(ANOMALY))
        mine = scorer.score(pd.DataFrame(payload["points"]),
                            on_missing=payload.get("on_missing", "skip"),
                            threshold=payload.get("threshold"))
        assert g_body == json.dumps(mine).encode()
    else:
        assert got == want
    expected = {"detect": 200, "detect_unknown_raise": 404,
                "detect_list_body": 400, "detect_too_many": 400}
    assert g_status == expected.get(case, g_status)


def test_planted_points_are_flagged(detecting):
    status, body, _ = _raw(detecting["port"], "POST", "/detect_anomalies",
                           {"points": _points(detecting["df"])})
    out = json.loads(body)
    assert status == 200 and out["n_scored"] == 60
    flagged = [i for i, r in enumerate(out["results"]) if r["is_anomaly"]]
    assert {2, 9, 20} <= set(flagged)


def test_metrics_append_slo_anomaly_and_data_quality(detecting):
    _publish_data_quality(detecting["df"])
    for side in ("ref", "port"):
        _raw(detecting[side], "POST", "/detect_anomalies",
             {"points": _points(detecting["df"])})
        _raw(detecting[side], "POST", "/invocations",
             {"inputs": ONE, "horizon": 3})
        detecting[side].quality.slo.evaluate_once(now=1_700_000_000.0)
    w_body = _raw(detecting["ref"], "GET", "/metrics")[1].decode()
    g_body = _raw(detecting["port"], "GET", "/metrics")[1].decode()
    want, got = _families(w_body), _families(g_body)
    added = {n for n in got if n.startswith(("dftpu_slo_", "dftpu_anomaly_",
                                              "dftpu_data_quality_"))}
    assert len([n for n in added if n.startswith("dftpu_slo_")]) == 5
    assert len([n for n in added if n.startswith("dftpu_anomaly_")]) == 8
    assert len([n for n in added
                if n.startswith("dftpu_data_quality_")]) == 10
    for name, fam in got.items():
        assert want.get(name) == fam, name
    # the reference's order: serving, quality + SLO, anomaly, data quality
    order = [g_body.index(f"# TYPE {n} ") for n in (
        "serving_requests_total", "dftpu_quality_metric", "dftpu_slo_sli",
        "dftpu_anomaly_requests_total", "dftpu_data_quality_rows")]
    assert order == sorted(order)
    assert "dftpu_slo_evaluation_errors_total 0" in g_body
    assert re.search(r"^dftpu_anomaly_points_total [1-9]", g_body, re.M)


def test_debug_quality_is_a_404_as_in_the_reference(detecting):
    answers = [_raw(detecting[s], "GET", "/debug/quality")
               for s in ("ref", "port")]
    assert answers[0][0] == answers[1][0] == 404
    assert json.loads(answers[0][1]) == json.loads(answers[1][1])


def _blocking_band_forecaster(release, started):
    """A forecaster whose predict blocks until ``release``, then serves one
    banded row for (1, 1) on 2020-01-01."""
    inner = _blocking_forecaster(release, started)

    class Banded:
        key_names, family, n_series, coalesce_safe = (
            inner.key_names, inner.family, inner.n_series, True)

        def predict(self, frame, horizon=90, **kw):
            inner.predict(frame, horizon=1)
            return pd.DataFrame({"ds": pd.to_datetime(["2020-01-01"]),
                                 "store": 1, "item": 1, "yhat": 1.0,
                                 "yhat_lower": 0.0, "yhat_upper": 2.0})

    return Banded()


def test_detect_anomalies_429_and_503_like_the_reference():
    """The coalescer's answers reach /detect_anomalies: a full queue is a
    429 and a request outliving request_timeout_s a 503, each with
    Retry-After: 1 and the reference's body."""
    answers = {}
    for side, mod, anom in (("ref", jserver, janom), ("port", tserver,
                                                      tanom)):
        release, started = threading.Event(), threading.Event()
        fc = _blocking_band_forecaster(release, started)
        srv = mod.start_server(
            fc, anomaly=anom.AnomalyScorer(fc),
            batching=mod.BatchingConfig(enabled=True, max_batch_size=4,
                                        max_wait_ms=0.0, max_queue_depth=1,
                                        request_timeout_s=30.0))
        body = {"points": [{"store": 1, "item": 1, "ds": "2020-01-01",
                            "y": 1.0}]}
        done = []

        def fire():
            done.append(_raw(srv, "POST", "/detect_anomalies", body)[0])

        try:
            a = threading.Thread(target=fire)
            a.start()
            assert started.wait(10)
            b = threading.Thread(target=fire)
            b.start()
            for _ in range(200):
                if srv.metrics.queue_depth.value >= 1:
                    break
                threading.Event().wait(0.01)
            full = _raw(srv, "POST", "/detect_anomalies", body)
            release.set()
            a.join(30)
            b.join(30)
        finally:
            release.set()
            srv.shutdown()
        release, started = threading.Event(), threading.Event()
        fc = _blocking_band_forecaster(release, started)
        srv = mod.start_server(
            fc, anomaly=anom.AnomalyScorer(fc),
            batching=mod.BatchingConfig(enabled=True, max_batch_size=4,
                                        max_wait_ms=0.0, max_queue_depth=8,
                                        request_timeout_s=0.1))
        try:
            late = _raw(srv, "POST", "/detect_anomalies", body)
        finally:
            release.set()
            srv.shutdown()
        answers[side] = [(full[0], full[2].get("Retry-After"),
                          json.loads(full[1])),
                         (late[0], late[2].get("Retry-After"),
                          json.loads(late[1])), sorted(done)]
    assert answers["port"] == answers["ref"]
    assert [a[:2] for a in answers["port"][:2]] == [(429, "1"), (503, "1")]
    assert answers["port"][2] == [200, 200]


def test_shutdown_joins_the_loops_and_leaves_the_final_scrape(servers,
                                                              tmp_path):
    fc = servers["port"].forecaster
    quality = tq.build_quality_runtime(
        MONITORING, fc, default_store_dir=str(tmp_path / "store"))
    srv = tserver.start_server(fc, quality=quality)
    threads = (quality.scrape._thread, quality.slo._thread)
    assert all(t.is_alive() for t in threads)
    assert quality.slo._latency is srv.metrics.latency
    assert _raw(srv, "POST", "/invocations",
                {"inputs": ONE, "horizon": 3})[0] == 200
    # the handler records the request's latency after its response is
    # written (and its root span closed): wait for it, so the final scrape
    # below races nothing
    deadline = time.monotonic() + 10
    while srv.metrics.latency.count < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.metrics.latency.count == 1
    assert quality.store.query() == []
    srv.shutdown()
    assert not any(t.is_alive() for t in threads)
    names = {p["name"] for p in quality.store.query()}
    assert {"serving_requests_total", "serving_request_latency_seconds_p95",
            "dftpu_slo_evaluations_total",
            "dftpu_quality_nominal_coverage"} <= names
    assert os.listdir(str(tmp_path / "store")) == ["seg-00000001.jsonl"]
