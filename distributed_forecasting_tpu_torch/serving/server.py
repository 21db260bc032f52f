"""Online inference endpoint: the registered model behind an HTTP surface
(port of the reference's ``serving/server.py``).

The artifact is loaded once onto the card and every request runs the
request-proportional batched predict (``serving/predictor.py``): a k-series
request is one forecast over a leading axis of about k.

Endpoints (JSON over HTTP, the standard library's ``http.server``), with the
reference's routes, statuses, headers and bodies:

  GET  /health            -> {"status": "ok", "model": ..., "n_series": N,
                              "version": ...}
  GET  /healthz           -> {"status": "ok"} (liveness only)
  GET  /readyz            -> 200 once warmup is done and the batcher is
                             accepting, else 503 with Retry-After: 1
  GET  /schema            -> serving schema + key names
  GET  /metrics           -> Prometheus text exposition, in the
                             reference's order: the serving counters, gauges
                             and histograms; with a quality runtime the
                             ``dftpu_quality_*`` and ``dftpu_slo_*``
                             families; with an ingest runtime the
                             ``dftpu_ingest_*`` ones; with an anomaly
                             scorer the
                             ``dftpu_anomaly_*`` ones; and, once a
                             data-quality report has run in the process,
                             the ``dftpu_data_quality_*`` gauges
  POST /invocations       -> {"inputs": [{"store": 1, "item": 2}, ...],
  POST /predict              "horizon": 90, "include_history": false,
                              "quantiles": [...], "on_missing": "raise"}
                          -> {"predictions": [...], "n_series": k}; an
                             unknown series is a 404 unless "on_missing":
                             "skip"; with batching on, a full queue is a 429
                             (Retry-After: 1) and a request outliving
                             request_timeout_s a 503; an X-Deadline-Ms
                             header of 0 or less is a 503 before parsing
  POST /observe           -> {"observations": [{<keys>, "ds", "y"}, ...]}:
                             actuals scored against what the model serves
                             (``monitoring/quality.py``); 503 without a
                             quality runtime; with ``observe_feeds_ingest``
                             the actuals also enter the ingest WAL
  POST /detect_anomalies -> {"points": [{<keys>, "ds", "y"}, ...],
                              "threshold": 4.0, "on_missing": "skip"}:
                             actuals scored against the served bands in one
                             batched predict, through the coalescer when
                             batching is on (``serving/anomaly.py``); 503
                             without an anomaly scorer
  POST /ingest            -> {"points": [{<keys> | "keys": {...} |
                              "k": [...], "ds": ... | "d": <ordinal>,
                              "y": ...}, ...]}: appended to the write-ahead
                             log (``serving/ingest.py``); the ack counts
                             written / unknown_series / malformed /
                             out_of_range, and in sync mode ``applied``
                             (the next /invocations already reflects the
                             points); 400 for a bad body or too many
                             points, 503 without an ingest runtime
  GET  /debug/trace       -> the flight recorder's spans as a Chrome trace
  GET  /debug/profile     -> ?seconds=N: one torch.profiler capture into
                             tracing.profile_dir ({"capture_dir": ...});
                             400 for a bad number, 503 without a
                             profile_dir, 409 while another capture runs
  GET  /debug/quality     -> the quality runtime's snapshot (503 without one)
  GET  /debug/ingest      -> the ingest runtime's snapshot (503 without one)
  GET  /debug/cost        -> the cost registry's table (503 with the
                             monitoring.cost block disabled); every
                             /debug/* route is 404 unless
                             tracing.debug_endpoints is set

``serve`` blocks; ``start_server`` returns the live server for tests and
embedding.  Requests go through the micro-batching coalescer
(``serving/batcher.py``) when a ``BatchingConfig(enabled=True)`` is given.

With a quality runtime, the server binds the runtime to its own metrics and
starts its scrape and SLO threads at construction, and ``shutdown`` stops
them (one final scrape) before the accept loop stops, as the reference does.
An ingest runtime is started at construction too (its WAL follower in
interval mode, its refit scheduler) and stopped in ``shutdown``; with an
anomaly scorer whose ``stream_scoring`` is on, every validated /ingest
batch is scored against the current bands before it applies.

Tracing (``monitoring/trace.py``), as in the reference: each request on
``/invocations`` / ``/predict``, ``/observe``, ``/detect_anomalies`` and
``/ingest`` is an ``http.request`` root span (``method``, ``path``,
``status``) whose trace id — the client's X-Trace-Id when it is a safe
token, else a fresh one — is echoed as X-Trace-Id; the batcher, predictor,
anomaly scorer, ingest runtime and state store open their spans under it.
An ``/invocations`` answered 5xx dumps the flight recorder
(``tracing.dump_dir``) after its response is written.

Not here: the forecast-cache runtime (P12; its parameter takes None only)
and the sharded replicas' ``extra_metrics`` (P12).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from concurrent.futures import TimeoutError as _FutureTimeoutError
from http.server import BaseHTTPRequestHandler
from typing import Optional

import numpy as np
import pandas as pd

from distributed_forecasting_tpu_torch.data.quality import (
    render_data_quality_metrics,
)
from distributed_forecasting_tpu_torch.monitoring.cost import (
    cost_metrics,
    get_cost_config,
)
from distributed_forecasting_tpu_torch.monitoring.trace import (
    ProfilerBusyError,
    dump_flight_recorder,
    get_tracer,
    to_chrome_trace,
)
from distributed_forecasting_tpu_torch.serving.batcher import (
    BatchingConfig,
    QueueFullError,
    RequestBatcher,
    ServingMetrics,
    ShuttingDownError,
)
from distributed_forecasting_tpu_torch.serving.dataplane import (
    HttpConfig,
    KeepAliveHandlerMixin,
    PooledHTTPServer,
)
from distributed_forecasting_tpu_torch.serving.forecast_cache import (
    canonical_quantiles,
)
from distributed_forecasting_tpu_torch.serving.predictor import UnknownSeriesError
from distributed_forecasting_tpu_torch.utils.logging import get_logger

_MAX_HORIZON = 3650  # 10 years daily: beyond any sane scoring request
_MAX_QUANTILES = 32  # more levels than any scorer needs

# the runtimes the reference's server takes and the port lacks: their
# modules and ROADMAP items (the serve task refuses their conf blocks too)
UNPORTED_RUNTIMES = {
    "cache": ("serving/forecast_cache.py", "P12"),
}


def _encode_predictions(out: pd.DataFrame, key_names) -> bytes:
    """A forecast frame -> the exact ``/invocations`` 200 response body.
    The shallow copy keeps the ``ds`` stringification off the caller's
    frame."""
    out = out.copy(deep=False)
    out["ds"] = out["ds"].astype(str)
    keys = list(key_names)
    n_series = int(out[keys].drop_duplicates().shape[0]) if len(out) else 0
    return json.dumps({
        "predictions": out.to_dict(orient="records"),
        "n_series": n_series,
    }).encode()


def _safe_trace_id(raw: Optional[str]) -> Optional[str]:
    """Accept a client's X-Trace-Id only when it is a sane token — a hostile
    header must not ride into logs."""
    if not raw:
        return None
    raw = raw.strip()
    if 1 <= len(raw) <= 64 and all(c.isalnum() or c in "-_" for c in raw):
        return raw
    return None


class _Handler(KeepAliveHandlerMixin, BaseHTTPRequestHandler):
    server_version = "dftpu-serve/1.0"

    # per request (with keep-alive one handler serves many requests)
    _trace_id: Optional[str] = None
    _status: int = 0

    def _send(self, code: int, payload: dict, extra_headers=()) -> None:
        self._send_bytes(code, json.dumps(payload).encode(),
                         extra_headers=extra_headers)

    def _send_bytes(self, code: int, body: bytes, extra_headers=()) -> None:
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self._trace_id:
            # echo the client's correlation id
            self.send_header("X-Trace-Id", self._trace_id)
        for name, value in extra_headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route through the package's logging
        self.server.logger.info("%s " + fmt, self.address_string(), *args)

    def do_GET(self):
        # a trace id from an earlier POST on this connection must not echo
        self._trace_id = None
        fc = self.server.forecaster
        parsed = urllib.parse.urlsplit(self.path)
        if parsed.path == "/healthz":
            self._send(200, {"status": "ok"})
            return
        if parsed.path == "/readyz":
            ready, reason = self.server.readiness()
            self._send(200 if ready else 503,
                       {"ready": ready, "reason": reason},
                       extra_headers=(() if ready
                                      else (("Retry-After", "1"),)))
            return
        if parsed.path.startswith("/debug/"):
            self._debug(parsed)
            return
        if self.path == "/health":
            self._send(
                200,
                {
                    "status": "ok",
                    "model": fc.family,
                    "n_series": int(fc.n_series),
                    "version": self.server.model_version,
                },
            )
        elif self.path == "/schema":
            self._send(
                200,
                {
                    "key_names": list(fc.key_names),
                    "serving_schema": fc.serving_schema,
                },
            )
        elif self.path == "/metrics":
            text = self.server.metrics.render()
            if self.server.quality is not None:
                text += self.server.quality.render_metrics()
            if self.server.ingest is not None:
                text += self.server.ingest.render_metrics()
            if self.server.anomaly is not None:
                text += self.server.anomaly.render_metrics()
            text += render_data_quality_metrics()
            body = text.encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def _debug(self, parsed) -> None:
        """The introspection routes, off unless tracing.debug_endpoints is
        set (they expose internals, and a capture holds its handler thread
        for seconds)."""
        tracer = get_tracer()
        if not tracer.config.debug_endpoints:
            self._send(404, {"error": f"no route {parsed.path}"})
            return
        if parsed.path == "/debug/trace":
            # the recent spans as a Chrome trace: save the body, open it in
            # ui.perfetto.dev
            spans = tracer.recorder.snapshot()
            self._send(200, to_chrome_trace(
                spans, metadata={"n_spans": len(spans)}))
        elif parsed.path == "/debug/profile":
            query = urllib.parse.parse_qs(parsed.query)
            try:
                seconds = float(query.get("seconds", ["3"])[0])
            except ValueError:
                self._send(400, {"error": "seconds must be a number"})
                return
            if not tracer.profiler.available:
                self._send(503, {"error": "profiler capture not configured "
                                          "(tracing.profile_dir is unset)"},
                           extra_headers=(("Retry-After", "60"),))
                return
            try:
                # holds THIS handler thread for the window; the other
                # workers go on serving, so the capture sees live traffic
                out = tracer.profiler.capture(seconds)
            except ProfilerBusyError as e:
                self._send(409, {"error": str(e)})
                return
            self._send(200, {"capture_dir": out, "seconds": seconds})
        elif parsed.path == "/debug/quality":
            quality = self.server.quality
            if quality is None:
                self._send(503, {"error": "quality monitoring not enabled "
                                          "(monitoring.quality conf block)"},
                           extra_headers=(("Retry-After", "60"),))
                return
            self._send(200, quality.snapshot())
        elif parsed.path == "/debug/ingest":
            ingest = self.server.ingest
            if ingest is None:
                self._send(503, {"error": "streaming ingest not enabled "
                                          "(serving.ingest conf block)"},
                           extra_headers=(("Retry-After", "60"),))
                return
            self._send(200, ingest.snapshot())
        elif parsed.path == "/debug/cost":
            cconf = get_cost_config()
            if not cconf.enabled:
                self._send(503, {"error": "cost observability disabled "
                                          "(monitoring.cost conf block)"},
                           extra_headers=(("Retry-After", "60"),))
                return
            # the per-entry cost table, watermarks sampled afresh
            self._send(200, cost_metrics().snapshot(cconf))
        else:
            self._send(404, {"error": f"no route {parsed.path}"})

    def do_POST(self):
        # deadline shed: work whose X-Deadline-Ms budget is already spent
        # gets its 503 before parsing or dispatch
        raw_budget = (self.headers.get("X-Deadline-Ms") or "").strip()
        if raw_budget:
            try:
                budget_ms = float(raw_budget)
            except ValueError:
                budget_ms = None  # a garbage header is ignored
            if budget_ms is not None and budget_ms <= 0:
                self.server.metrics.deadline_shed.inc()
                self._send(
                    503,
                    {"error": "deadline budget exhausted before dispatch"},
                    extra_headers=(("Retry-After", "1"),))
                return
        if self.path == "/observe":
            self._observe()
            return
        if self.path == "/ingest":
            self._ingest()
            return
        if self.path == "/detect_anomalies":
            self._detect_anomalies()
            return
        if self.path not in ("/invocations", "/predict"):
            self._send(404, {"error": f"no route {self.path}"})
            return
        metrics = self.server.metrics
        metrics.requests.inc()
        tracer = get_tracer()
        self._trace_id = _safe_trace_id(self.headers.get("X-Trace-Id"))
        t0 = time.monotonic()
        try:
            with tracer.root_span(
                "http.request", trace_id=self._trace_id,
                method="POST", path=self.path,
            ) as root:
                self._trace_id = root.trace_id or self._trace_id
                self._invoke()
                root.set_attribute("status", self._status)
        finally:
            metrics.latency.observe(time.monotonic() - t0)
            if self._status >= 500:
                # a failed or timed-out request leaves the last spans on
                # disk; the response is already written, so a slow dump
                # directory delays no client
                path = dump_flight_recorder(f"http-{self._status}")
                if path:
                    self.server.logger.warning(
                        "status %d: flight recorder dumped to %s",
                        self._status, path)

    def _invoke(self):
        metrics = self.server.metrics
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                self._send(400, {"error": "body must be a JSON object with 'inputs'"})
                return
            inputs = req.get("inputs")
            if not inputs:
                self._send(400, {"error": "body needs a non-empty 'inputs' list"})
                return
            horizon = int(req.get("horizon", 90))
            if not 1 <= horizon <= _MAX_HORIZON:
                # an unbounded horizon would let one call allocate GBs
                self._send(
                    400,
                    {"error": f"horizon must be in [1, {_MAX_HORIZON}], got {horizon}"},
                )
                return
            frame = pd.DataFrame(inputs)
            missing_cols = set(self.server.forecaster.key_names) - set(frame.columns)
            if missing_cols:
                self._send(
                    400, {"error": f"inputs missing key columns {sorted(missing_cols)}"}
                )
                return
            xreg = req.get("xreg")
            if xreg is not None:
                # regressor values for models fit with n_regressors > 0:
                # (T_all, R) shared or (S_trained, T_all, R) per series;
                # BatchForecaster.predict checks shape and length
                xreg = np.asarray(xreg, dtype=np.float32)
            quantiles = req.get("quantiles")
            if quantiles is not None:
                if (
                    not isinstance(quantiles, list)
                    or not quantiles
                    or len(quantiles) > _MAX_QUANTILES
                    or not all(
                        isinstance(q, (int, float)) and 0.0 < q < 1.0
                        for q in quantiles
                    )
                ):
                    self._send(
                        400,
                        {"error": "quantiles must be a non-empty list of "
                                  f"at most {_MAX_QUANTILES} levels in (0, 1)"},
                    )
                    return
                # canonical to 3 decimals, as the reference does (the levels
                # are a signature of the coalescer)
                quantiles = canonical_quantiles(quantiles)
                if not all(0.0 < q < 1.0 for q in quantiles):
                    self._send(
                        400,
                        {"error": "quantile levels round to the open "
                                  "interval (0.001, 0.999)"},
                    )
                    return
            include_history = bool(req.get("include_history", False))
            on_missing = req.get("on_missing", "raise")
            out = self.server.execute(
                frame,
                horizon=horizon,
                include_history=include_history,
                quantiles=quantiles,
                on_missing=on_missing,
                xreg=xreg,
            )
            self._send_bytes(200, _encode_predictions(
                out, self.server.forecaster.key_names))
        except UnknownSeriesError as e:
            self._send(404, {"error": str(e)})
        except QueueFullError as e:
            # admission control: shed load now so clients back off
            metrics.rejections.inc()
            self._send(429, {"error": str(e)},
                       extra_headers=(("Retry-After", "1"),))
        except (TimeoutError, _FutureTimeoutError) as e:
            # the request outlived request_timeout_s (queued or in flight)
            metrics.timeouts.inc()
            self._send(503, {"error": f"request timed out: {e}" if str(e)
                             else "request timed out"},
                       extra_headers=(("Retry-After", "1"),))
        except ShuttingDownError as e:
            self._send(503, {"error": str(e)},
                       extra_headers=(("Retry-After", "1"),))
        except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
            # TypeError covers JSON-legal but wrong-typed fields, such as
            # "horizon": null
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # noqa: BLE001 — the scorer outlives a request
            metrics.errors.inc()
            self.server.logger.exception("invocation failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _observe(self):
        """POST /observe: ground-truth actuals into the quality monitor.

        Body: ``{"observations": [{<key cols>, "ds": "...", "y": ...}, ...],
        "on_missing": "skip"|"raise"}``.  Scoring is the forecaster's own
        batched predict plus one term pass over the whole batch."""
        quality = self.server.quality
        if quality is None or quality.monitor is None:
            self._send(503, {"error": "quality monitoring not enabled "
                                      "(monitoring.quality conf block)"},
                       extra_headers=(("Retry-After", "60"),))
            return
        tracer = get_tracer()
        self._trace_id = _safe_trace_id(self.headers.get("X-Trace-Id"))
        try:
            with tracer.root_span(
                "http.request", trace_id=self._trace_id,
                method="POST", path="/observe",
            ) as root:
                self._trace_id = root.trace_id or self._trace_id
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    self._send(400, {"error": "body must be a JSON object "
                                              "with 'observations'"})
                    return
                observations = req.get("observations")
                if not observations:
                    self._send(400, {"error": "body needs a non-empty "
                                              "'observations' list"})
                    return
                summary = quality.observe(
                    pd.DataFrame(observations),
                    on_missing=req.get("on_missing", "skip"))
                ingest = self.server.ingest
                if ingest is not None and ingest.config.observe_feeds_ingest:
                    # the scoring feedback loop doubles as an ingest source;
                    # a feed failure must not fail the observe (scoring is
                    # done)
                    try:
                        summary["ingest"] = ingest.submit(observations)
                    except Exception:  # noqa: BLE001
                        self.server.logger.exception(
                            "observe -> ingest feed failed")
                self._send(200, summary)
                root.set_attribute("status", self._status)
        except UnknownSeriesError as e:
            self._send(404, {"error": str(e)})
        except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # noqa: BLE001 — the scorer outlives a request
            self.server.logger.exception("observe failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _detect_anomalies(self):
        """POST /detect_anomalies: score actuals against the served bands.

        Body: ``{"points": [{<key cols>, "ds": "...", "y": ...}, ...],
        "threshold": 4.0, "on_missing": "skip"|"raise"}``.  One batched
        predict per request (through the coalescer when batching is on),
        per-point ``anomaly_score`` + ``is_anomaly`` back in request order.
        503 when no anomaly scorer is configured (``serving.anomaly`` conf
        block)."""
        anomaly = self.server.anomaly
        if anomaly is None:
            self._send(503, {"error": "anomaly detection not enabled "
                                      "(serving.anomaly conf block)"},
                       extra_headers=(("Retry-After", "60"),))
            return
        tracer = get_tracer()
        self._trace_id = _safe_trace_id(self.headers.get("X-Trace-Id"))
        try:
            with tracer.root_span(
                "http.request", trace_id=self._trace_id,
                method="POST", path="/detect_anomalies",
            ) as root:
                self._trace_id = root.trace_id or self._trace_id
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    self._send(400, {"error": "body must be a JSON object "
                                              "with 'points'"})
                    return
                points = req.get("points")
                if not points or not isinstance(points, list):
                    self._send(400, {"error": "body needs a non-empty "
                                              "'points' list"})
                    return
                if len(points) > anomaly.config.max_points_per_request:
                    self._send(400, {
                        "error": f"request has {len(points)} points; "
                                 f"max_points_per_request="
                                 f"{anomaly.config.max_points_per_request}"})
                    return
                threshold = req.get("threshold")
                if threshold is not None:
                    threshold = float(threshold)
                    if not threshold > 0:
                        self._send(400, {"error": "threshold must be > 0"})
                        return
                out = anomaly.score(
                    pd.DataFrame(points),
                    on_missing=req.get("on_missing", "skip"),
                    threshold=threshold)
                root.set_attribute("points", len(points))
                root.set_attribute("flagged", out["n_flagged"])
                self._send(200, out)
                root.set_attribute("status", self._status)
        except UnknownSeriesError as e:
            self._send(404, {"error": str(e)})
        except QueueFullError as e:
            self._send(429, {"error": str(e)},
                       extra_headers=(("Retry-After", "1"),))
        except (TimeoutError, _FutureTimeoutError) as e:
            self._send(503, {"error": f"request timed out: {e}" if str(e)
                             else "request timed out"},
                       extra_headers=(("Retry-After", "1"),))
        except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # noqa: BLE001 — the scorer outlives a request
            self.server.logger.exception("detect_anomalies failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _ingest(self):
        """POST /ingest: new observations into the streaming WAL.

        Body: ``{"points": [{<key cols> | "keys": {...} | "k": [...],
        "ds": "..." | "d": <ordinal>, "y": ...}, ...]}``.  The append is
        durable before the response; in sync mode the response's
        ``applied`` block means the next /invocations already reflects the
        points — one batched update, no refit."""
        ingest = self.server.ingest
        if ingest is None:
            self._send(503, {"error": "streaming ingest not enabled "
                                      "(serving.ingest conf block)"},
                       extra_headers=(("Retry-After", "60"),))
            return
        tracer = get_tracer()
        self._trace_id = _safe_trace_id(self.headers.get("X-Trace-Id"))
        try:
            with tracer.root_span(
                "http.request", trace_id=self._trace_id,
                method="POST", path="/ingest",
            ) as root:
                self._trace_id = root.trace_id or self._trace_id
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    self._send(400, {"error": "body must be a JSON object "
                                              "with 'points'"})
                    return
                points = req.get("points")
                if not points or not isinstance(points, list):
                    self._send(400, {"error": "body needs a non-empty "
                                              "'points' list"})
                    return
                out = ingest.submit(points)
                root.set_attribute("points", len(points))
                self._send(200, out)
                root.set_attribute("status", self._status)
        except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # noqa: BLE001 — the scorer outlives a request
            self.server.logger.exception("ingest failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})


class ForecastServer(PooledHTTPServer):
    """The scorer: listen backlog, worker pool, keep-alive and TCP_NODELAY
    come from :class:`PooledHTTPServer` and the ``serving.http`` block."""

    def __init__(
        self,
        addr,
        forecaster,
        model_version: Optional[str] = None,
        batching: Optional[BatchingConfig] = None,
        quality=None,
        ingest=None,
        anomaly=None,
        cache=None,
        http: Optional[HttpConfig] = None,
    ):
        if cache is not None:
            module, item = UNPORTED_RUNTIMES["cache"]
            raise NotImplementedError(
                f"cache= ({module}) is not ported yet "
                f"(ROADMAP Queue 1: {item})")
        super().__init__(addr, _Handler, http=http)
        self.forecaster = forecaster
        self.model_version = model_version
        self.logger = get_logger("ForecastServer")
        self.metrics = ServingMetrics()
        self.busy_gauge = self.metrics.http_workers_busy
        self.batching = batching
        # the wired quality stack (monitoring/quality.QualityRuntime): its
        # scrape and SLO loops start here, so every construction path
        # (serve, start_server, tests) gets the same lifecycle; the latency
        # SLO and the scrape loop bind to THIS server's metrics
        self.quality = quality
        if quality is not None:
            quality.attach_server_metrics(self.metrics)
            quality.start()
        # the streaming ingest runtime (serving/ingest.IngestRuntime): its
        # WAL follower and refit scheduler start here and stop in shutdown
        self.ingest = ingest
        if ingest is not None:
            ingest.start()
            self.logger.info(
                "streaming ingest on: wal_dir=%s apply_mode=%s refit=%s",
                ingest.wal.directory, ingest.config.apply_mode,
                "on" if ingest.refit is not None else "off")
        # the anomaly scorer (serving/anomaly.AnomalyScorer): detection
        # batches ride the same coalescing dispatch as forecast traffic
        self.anomaly = anomaly
        if anomaly is not None:
            anomaly.bind_execute(self.execute)
            if ingest is not None and anomaly.config.stream_scoring:
                # the streaming leg: every validated /ingest batch is
                # scored against the current bands before it applies
                ingest.anomaly = anomaly
            self.logger.info(
                "anomaly detection on: threshold=%.3f stream_scoring=%s",
                anomaly.threshold,
                anomaly.config.stream_scoring and ingest is not None)
        # readiness is set once after warmup and cleared at shutdown
        self._ready = threading.Event()
        self.batcher: Optional[RequestBatcher] = None
        if batching is not None and batching.enabled:
            self.batcher = RequestBatcher(forecaster, batching, self.metrics)
            self.logger.info(
                "micro-batching on: max_batch_size=%d max_wait_ms=%g "
                "max_queue_depth=%d request_timeout_s=%g",
                batching.max_batch_size, batching.max_wait_ms,
                batching.max_queue_depth, batching.request_timeout_s,
            )

    def execute(
        self,
        frame,
        horizon: int,
        include_history: bool,
        quantiles,
        on_missing: str,
        xreg,
    ):
        """Run one parsed /invocations request: through the coalescer when
        batching is on, as a direct forecaster call otherwise (both feed the
        same dispatch and batch-size metrics)."""
        if self.batcher is not None:
            fut = self.batcher.submit(
                frame,
                horizon=horizon,
                include_history=include_history,
                quantiles=quantiles,
                on_missing=on_missing,
                xreg=xreg,
            )
            # the batcher fails queued requests at their deadline; this
            # wait is the backstop for a request stuck in a dispatch
            return fut.result(timeout=self.batching.request_timeout_s)
        self.metrics.dispatches.inc()
        self.metrics.batch_size.observe(1)
        if quantiles is not None:
            return self.forecaster.predict_quantiles(
                frame,
                quantiles=quantiles,
                horizon=horizon,
                include_history=include_history,
                on_missing=on_missing,
                xreg=xreg,
            )
        return self.forecaster.predict(
            frame,
            horizon=horizon,
            include_history=include_history,
            on_missing=on_missing,
            xreg=xreg,
        )

    def mark_ready(self) -> None:
        """Flip /readyz to 200 — called by the launcher after warmup."""
        self._ready.set()

    def readiness(self):
        """(ready, reason) for /readyz: warmup done and batcher accepting."""
        if not self._ready.is_set():
            return False, "warming up"
        if self.batcher is not None and not self.batcher.accepting:
            return False, "draining"
        return True, "ok"

    def shutdown(self):
        """Graceful: flip /readyz to 503 and drain the batching queue (every
        queued request gets its response) before stopping the accept loop
        and the workers."""
        self._ready.clear()
        if self.batcher is not None:
            self.batcher.close()
        if self.ingest is not None:
            # stop the follower and refit threads; the WAL stays on disk
            self.ingest.stop()
        if self.quality is not None:
            # stop the SLO and scrape threads and flush one final scrape, so
            # the on-disk history covers the whole process lifetime
            self.quality.stop()
        super().shutdown()


def start_server(
    forecaster,
    host: str = "127.0.0.1",
    port: int = 0,
    model_version: Optional[str] = None,
    batching: Optional[BatchingConfig] = None,
    ready: bool = True,
    quality=None,
    ingest=None,
    anomaly=None,
    cache=None,
    http: Optional[HttpConfig] = None,
) -> ForecastServer:
    """Start serving on a background thread; returns the server (its
    ``server_address[1]`` is the bound port — port=0 picks a free one).
    ``ready=False`` starts with /readyz at 503 until ``mark_ready()``."""
    srv = ForecastServer((host, port), forecaster, model_version, batching,
                         quality=quality, ingest=ingest, anomaly=anomaly,
                         cache=cache, http=http)
    if ready:
        srv.mark_ready()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


def serve(
    forecaster,
    host: str = "0.0.0.0",
    port: int = 8080,
    model_version: Optional[str] = None,
    batching: Optional[BatchingConfig] = None,
    quality=None,
    ingest=None,
    anomaly=None,
    cache=None,
    http: Optional[HttpConfig] = None,
) -> None:
    srv = ForecastServer((host, port), forecaster, model_version, batching,
                         quality=quality, ingest=ingest, anomaly=anomaly,
                         cache=cache, http=http)
    srv.mark_ready()
    srv.logger.info("serving on %s:%d", host, port)
    srv.serve_forever()
