"""On-device anomaly detection: ``POST /detect_anomalies`` + the
streaming ``/ingest`` scoring leg (port of the reference's
``serving/anomaly.py``).

ARIMA_PLUS ships anomaly detection as a first-class verb next to
forecasting (``ML.DETECT_ANOMALIES`` over a trained model): actuals are
scored against the model's own predictive band, and a point is anomalous
when its residual exceeds the band's spread at a configurable severity.
This module is that verb for the served artifact, on the forecaster's
device, in two legs that share one scorer:

* **Request leg** — ``POST /detect_anomalies`` with ``{"points":
  [{<keys>, "ds": ..., "y": ...}, ...]}``: the batch aligns against ONE
  batched predict (routed through the server's :class:`RequestBatcher`
  when micro-batching is on — the same ``execute`` path /invocations
  uses, so concurrent detection requests coalesce into shared device
  dispatches) and every point comes back with ``anomaly_score`` +
  ``is_anomaly``.  (A sharded fleet's front door, ``serving/fleet.py``,
  routes the batch per shard and merges the owners' answers.)
* **Streaming leg** — with ``stream_scoring`` on, every validated
  ``/ingest`` batch is scored against the CURRENT bands before the state
  update applies (a point must not vouch for itself), emitting
  ``dftpu_anomaly_*`` counters and appending flagged points to a JSONL
  anomaly stream on the quality-store machinery
  (:class:`monitoring.store.TimeSeriesStore`).  A scoring failure never
  fails the ingest — the WAL append already happened.  ``ForecastServer``
  binds :meth:`score_ingest` to the ingest runtime (``serving/ingest.py``)
  when both are on.

Scoring contract (same sigma recovery as ``monitoring/monitor.py``'s
batch ``detect_anomalies``): ``sigma = (yhat_upper - yhat) / z_w`` from
the UPPER half-band only (lower bounds may be clamped — croston floors
at 0, multiplicative bands are asymmetric), ``score = |y - yhat| /
sigma``, flagged when ``score > threshold``.  The default threshold is
the band's own z (points outside the band flag, for symmetric bands),
so the endpoint agrees with what ``/invocations`` clients see as the
interval.  Bands are the CALIBRATED ones — ``BatchForecaster.predict``
applies the conformal ``interval_scale`` (``engine/calibrate.py``) — so
detection severity tracks the shipped coverage, not the raw model band.
The predict runs on the forecaster's device; the scoring is float64 numpy on
the host, as in the reference.  The predict and merge run under an
``anomaly.score`` span (``rows``, ``source``: ``endpoint`` or ``ingest``),
the ``/ingest`` leg's too.

Conf block ``serving.anomaly`` (strict)::

    serving:
      anomaly:
        enabled: true
        threshold: 0.0            # robust-z severity; 0 -> the band's z
        max_horizon: 365          # bounds the predict grid a request forces
        max_points_per_request: 10000
        stream_scoring: true      # score /ingest batches too
        stream_store_dir: ""      # "" -> <env.root>/anomaly_stream
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from distributed_forecasting_tpu_torch.data.tensorize import period_ordinals
from distributed_forecasting_tpu_torch.engine.calibrate import config_interval_width
from distributed_forecasting_tpu_torch.models.base import _ndtri
from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.monitoring.trace import get_tracer
from distributed_forecasting_tpu_torch.utils.logging import get_logger

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class AnomalyConfig:
    """The ``serving.anomaly`` conf block."""

    enabled: bool = False
    threshold: float = 0.0          # 0 -> z of the served interval width
    max_horizon: int = 365
    max_points_per_request: int = 10000
    stream_scoring: bool = True
    stream_store_dir: str = ""      # "" -> caller supplies a default root

    def __post_init__(self):
        if self.threshold < 0:
            raise ValueError("threshold must be >= 0 (0 means the band z)")
        if self.max_horizon < 1:
            raise ValueError("max_horizon must be >= 1")
        if self.max_points_per_request < 1:
            raise ValueError("max_points_per_request must be >= 1")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "AnomalyConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like treshold must not silently keep the default
            raise ValueError(
                f"unknown serving.anomaly conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


class AnomalyScorer:
    """Batched residual scoring of actuals against the served bands.

    One ``score()`` call runs ONE batched predict for the whole point set
    (through the server's coalescing ``execute`` once bound — see
    :meth:`bind_execute`) plus host-side alignment; no per-series loop.
    Thread-safe: all state is read-only after construction except the
    metrics registry (internally synchronized) and the stream store
    (internally synchronized).
    """

    def __init__(self, forecaster, config: Optional[AnomalyConfig] = None,
                 store=None):
        self.forecaster = forecaster
        self.config = config or AnomalyConfig(enabled=True)
        self.store = store              # JSONL anomaly stream (optional)
        self.logger = get_logger("AnomalyScorer")
        self._execute = None            # bound by ForecastServer
        width = config_interval_width(getattr(forecaster, "config", None))
        # z of the served band width — the sigma divisor AND the default
        # severity, from the float32 inverse normal the model modules use
        # (torch's is correctly rounded; XLA's is up to one ulp off)
        self._z_w = float(_ndtri(0.5 + width / 2.0, "cpu"))
        self.threshold = float(self.config.threshold) or self._z_w

        r = MetricsRegistry()
        self.registry = r
        self.requests = r.counter(
            "dftpu_anomaly_requests_total",
            "POST /detect_anomalies calls")
        self.points_total = r.counter(
            "dftpu_anomaly_points_total",
            "actuals scored against served bands (request leg)")
        self.flagged_total = r.counter(
            "dftpu_anomaly_flagged_total",
            "points flagged anomalous (request leg)")
        self.skipped_total = r.counter(
            "dftpu_anomaly_skipped_total",
            "points not scored: unknown series, unmatched dates, or "
            "beyond max_horizon")
        self.stream_points = r.counter(
            "dftpu_anomaly_stream_points_total",
            "ingest points scored by the streaming leg")
        self.stream_flagged = r.counter(
            "dftpu_anomaly_stream_flagged_total",
            "ingest points flagged anomalous by the streaming leg")
        self.last_flagged = r.gauge(
            "dftpu_anomaly_last_batch_flagged",
            "flagged count of the most recent scored batch (either leg)")
        self.threshold_gauge = r.gauge(
            "dftpu_anomaly_threshold",
            "the robust-z severity a point must exceed to flag")
        self.threshold_gauge.set(self.threshold)

    # -- wiring ---------------------------------------------------------------
    def bind_execute(self, execute) -> None:
        """Late-bind the server's coalescing dispatch (the /invocations
        ``execute`` signature) so detection batches ride the same
        RequestBatcher as forecast traffic — called by ``ForecastServer``
        at construction."""
        self._execute = execute

    def _predict(self, req: pd.DataFrame, horizon: int, on_missing: str):
        if self._execute is not None:
            return self._execute(
                req, horizon=horizon, include_history=True,
                quantiles=None, on_missing=on_missing, xreg=None)
        return self.forecaster.predict(
            req, horizon=horizon, include_history=True,
            on_missing=on_missing)

    # -- scoring --------------------------------------------------------------
    def score(self, points: pd.DataFrame, on_missing: str = "skip",
              threshold: Optional[float] = None,
              source: str = "endpoint") -> Dict:
        """Score a batch of actuals; returns per-point results in request
        order plus summary counts.

        ``points``: long frame with the forecaster's key columns, ``ds``
        (date-like) or ``_ord`` (period ordinal), and ``y``.
        ``threshold`` overrides the configured severity for this request.
        """
        fc = self.forecaster
        self.requests.inc()
        sev = float(threshold) if threshold else self.threshold
        key_names = list(fc.key_names)
        need = key_names + ["y"]
        missing = [c for c in need if c not in points.columns]
        if missing:
            raise ValueError(f"points missing column(s) {missing}")
        if "ds" not in points.columns and "_ord" not in points.columns:
            raise ValueError("points need a 'ds' (date) column")
        obs = points[[c for c in (*need, "ds", "_ord")
                      if c in points.columns]].copy()
        obs["y"] = pd.to_numeric(obs["y"], errors="coerce")
        n_in = len(obs)
        freq = getattr(fc, "freq", "D")
        if "_ord" not in obs.columns:
            obs["ds"] = pd.to_datetime(obs["ds"])
            obs["_ord"] = period_ordinals(obs["ds"], freq)
        obs["_row"] = np.arange(n_in)  # request order survives the merge
        obs = obs[np.isfinite(obs["y"].to_numpy(float))]

        day1 = getattr(fc, "day1", None)
        if day1 is not None:
            horizon = int(np.clip(obs["_ord"].max() - day1, 1,
                                  self.config.max_horizon)) if len(obs) else 1
            obs = obs[obs["_ord"] <= day1 + self.config.max_horizon]
        else:  # composite artifacts: serve whatever predict covers
            horizon = self.config.max_horizon
        if obs.empty:
            self.skipped_total.inc(n_in)
            return {"results": [], "n_scored": 0, "n_flagged": 0,
                    "n_skipped": n_in, "threshold": sev}

        with get_tracer().span("anomaly.score", rows=n_in, source=source):
            req = obs[key_names].drop_duplicates()
            pred = self._predict(req, horizon, on_missing)
            pred = pred[key_names + ["ds", "yhat", "yhat_lower",
                                     "yhat_upper"]]
            merged = obs.merge(
                pred.assign(_ord=period_ordinals(pred["ds"], freq))
                    .drop(columns=["ds"]),
                on=key_names + ["_ord"], how="inner")
        merged = merged.sort_values("_row", kind="stable")
        y = merged["y"].to_numpy(float)
        yhat = merged["yhat"].to_numpy(float)
        hi = merged["yhat_upper"].to_numpy(float)
        # sigma from the UPPER half-band only (module docstring; the same
        # rationale as monitoring/monitor.detect_anomalies)
        sigma = np.maximum((hi - yhat) / self._z_w, _EPS)
        score = np.abs(y - yhat) / sigma
        flagged = score > sev

        results: List[Dict] = []
        epoch = pd.Timestamp("1970-01-01")
        for i, (_, row) in enumerate(merged.iterrows()):
            ds = row.get("ds")
            if ds is None or ds != ds:
                ds = epoch + pd.Timedelta(days=int(row["_ord"]))
            results.append({
                **{k: int(row[k]) for k in key_names},
                "ds": str(pd.Timestamp(ds).date()),
                "y": float(y[i]),
                "yhat": float(yhat[i]),
                "yhat_lower": float(row["yhat_lower"]),
                "yhat_upper": float(row["yhat_upper"]),
                "anomaly_score": round(float(score[i]), 6),
                "is_anomaly": bool(flagged[i]),
            })
        n_scored = len(results)
        n_flagged = int(flagged.sum())
        if source == "ingest":
            self.stream_points.inc(n_scored)
            self.stream_flagged.inc(n_flagged)
        else:
            self.points_total.inc(n_scored)
            self.flagged_total.inc(n_flagged)
        self.skipped_total.inc(n_in - n_scored)
        self.last_flagged.set(n_flagged)
        if n_flagged:
            self._stream_flagged(
                [r for r in results if r["is_anomaly"]], source)
        return {"results": results, "n_scored": n_scored,
                "n_flagged": n_flagged, "n_skipped": n_in - n_scored,
                "threshold": sev}

    def score_ingest(self, rows: List[Dict]) -> Dict:
        """Streaming leg: score validated ``/ingest`` WAL rows (compact
        ``{"k": [...], "d": n, "y": v}`` form) against the CURRENT bands.
        Returns the summary WITHOUT per-point results (an ingest ack must
        stay small); flagged points land on the anomaly stream."""
        key_names = list(self.forecaster.key_names)
        frame = pd.DataFrame(
            [dict(zip(key_names, r["k"]), _ord=r["d"], y=r["y"])
             for r in rows])
        out = self.score(frame, on_missing="skip", source="ingest")
        return {"scored": out["n_scored"], "flagged": out["n_flagged"],
                "skipped": out["n_skipped"], "threshold": out["threshold"]}

    def _stream_flagged(self, flagged: List[Dict], source: str) -> None:
        """Flagged points -> the JSONL anomaly stream (quality-store
        segments: atomic O_APPEND lines, retention, torn-line-tolerant
        readers).  A stream failure must not fail scoring."""
        if self.store is None:
            return
        at = time.time()  # dflint: disable=nondeterminism — stream rows are wall-clock telemetry
        key_names = list(self.forecaster.key_names)
        points = [{
            "ts": at, "name": "dftpu_anomaly_point",
            "labels": {**{k: str(r[k]) for k in key_names},
                       "ds": r["ds"], "source": source},
            "value": r["anomaly_score"],
        } for r in flagged]
        try:
            self.store.append(points)  # dflint: disable=unlocked-shared-state — TimeSeriesStore is internally synchronized
        except OSError:
            self.logger.exception("anomaly stream append failed")

    # -- exposition -----------------------------------------------------------
    def render_metrics(self) -> str:
        return self.registry.render_prometheus()

    def snapshot(self) -> Dict:
        out: Dict = {"threshold": self.threshold,
                     "band_z": self._z_w,
                     "stream_scoring": self.config.stream_scoring}
        if self.store is not None:
            out["stream_store"] = self.store.stats()
        return out


def build_anomaly_runtime(conf: Optional[dict], forecaster,
                          default_store_dir: Optional[str] = None,
                          ) -> Optional[AnomalyScorer]:
    """``serving.anomaly`` conf block -> a wired scorer (or None when the
    block is absent/disabled).  ``default_store_dir`` backs an empty
    ``stream_store_dir``; two processes must never share an append cursor,
    so each gets its own directory."""
    config = AnomalyConfig.from_conf(conf)
    if not config.enabled:
        return None
    store = None
    directory = config.stream_store_dir or default_store_dir
    if directory:
        from distributed_forecasting_tpu_torch.monitoring.store import (
            TimeSeriesStore,
        )

        store = TimeSeriesStore(directory)
    return AnomalyScorer(forecaster, config=config, store=store)
