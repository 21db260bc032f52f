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
"""

import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import prophet_glm as jpg
from distributed_forecasting_tpu.monitoring import quality as jq
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu.serving import server as jserver
from distributed_forecasting_tpu_torch.monitoring import quality as tq
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


def test_metrics_families_match_the_reference(servers):
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


@pytest.mark.parametrize("runtime", ["ingest", "anomaly", "cache"])
def test_unported_runtimes_are_refused(servers, runtime):
    item = {"ingest": "P9", "anomaly": "P10", "cache": "P12"}[runtime]
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1: {item}"):
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
