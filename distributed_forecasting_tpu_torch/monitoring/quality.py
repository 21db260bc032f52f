"""Forecast-quality monitor: rolling accuracy and calibration from actuals
(port of the reference's ``monitoring/quality.py``).

Actuals arrive (the scorer's ``POST /observe``, or a batch script), are
aligned against what the model SERVED for those dates — the conformal-scaled
band included, since ``BatchForecaster.predict`` applies ``interval_scale``
— and update per-series rolling WAPE / RMSSE / coverage accumulators.

One ``observe()`` call is one batched pass: the forecaster's own batched
``predict``, then the elementwise terms (``ops/metrics.quality_terms``) over
a dense ``(k, T)`` layout on the forecaster's device, with no loop over
series.  The terms are summed once on the host in float64, so the
accumulators are bitwise a NumPy computation's and stay stable over
unbounded streams.  Live gauges (``dftpu_quality_*``, the reference's
names) ride the scorer's ``/metrics``.

Conf block ``monitoring.quality`` (strict)::

    monitoring:
      quality:
        enabled: true
        max_horizon: 365        # observations beyond day1+this are skipped
        nominal_coverage: 0.0   # 0 -> the model config's interval_width

With a store (``monitoring/store.py``), each observe also appends the
family's rolling metrics and its worst series as store rows, outside the
accumulator lock; :func:`build_quality_runtime` wires the monitor, the store,
the scrape loop and the SLO evaluator (``monitoring/slo.py``) into one
:class:`QualityRuntime`.  The cost block (``monitoring.cost``) is parsed
strictly and logged as having no effect (ROADMAP Queue 1: P11), so the
scrape loop has no cost source.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data.tensorize import period_ordinals
from distributed_forecasting_tpu_torch.engine.calibrate import config_interval_width
from distributed_forecasting_tpu_torch.monitoring.cost import CostConfig
from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.ops.metrics import quality_terms
from distributed_forecasting_tpu_torch.utils.logging import get_logger

#: accumulator columns
_ACC_FIELDS = ("abs_err", "abs_y", "sq_err", "inside", "n",
               "naive_sq", "naive_n")

#: keys of the top-level ``monitoring:`` block
_MONITORING_KEYS = frozenset(
    {"quality", "quality_store", "slo", "tracking_root", "cost"})


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """The ``monitoring.quality`` conf block."""

    enabled: bool = False
    max_horizon: int = 365        # bounds the predict grid an observe can force
    nominal_coverage: float = 0.0  # 0 -> config_interval_width(fc.config)

    def __post_init__(self):
        if self.max_horizon < 1:
            raise ValueError("max_horizon must be >= 1")
        if not 0.0 <= self.nominal_coverage < 1.0:
            raise ValueError("nominal_coverage must be in [0, 1)")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "QualityConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            raise ValueError(
                f"unknown monitoring.quality conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


def _pow2(n: int) -> int:
    """Next power of two: the dense layout buckets both axes, so ragged
    observation batches come in O(log^2) shapes."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _metrics_from_acc(acc: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Accumulator sums -> WAPE / RMSSE / coverage arrays (NaN where the
    denominator is degenerate, as in ``ops/metrics``)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        wape = np.where(acc["abs_y"] > 0, acc["abs_err"] / acc["abs_y"],
                        np.nan)
        mse = np.where(acc["n"] > 0, acc["sq_err"] / acc["n"], np.nan)
        naive = np.where(acc["naive_n"] > 0,
                         acc["naive_sq"] / acc["naive_n"], np.nan)
        rmsse = np.where(naive > 0, np.sqrt(mse / naive), np.nan)
        cov = np.where(acc["n"] > 0, acc["inside"] / acc["n"], np.nan)
    return {"wape": wape, "rmsse": rmsse, "coverage": cov}


def _device(forecaster) -> torch.device:
    """Where the forecaster's parameters live (a composite's first member's)."""
    dev = getattr(forecaster, "device", None)
    if dev is not None:
        return dev
    members = forecaster.forecasters
    first = (next(iter(members.values())) if isinstance(members, dict)
             else members[0])
    return _device(first)


class QualityMonitor:
    """Rolling per-series forecast quality from arriving actuals.

    Thread safety: ``_lock`` guards the accumulator arrays (numpy float64,
    sized to the forecaster's series count once).  The predict, the pandas
    alignment, the term pass and the store append run outside it; only the
    accumulation and the snapshot reads hold it.
    """

    def __init__(self, forecaster, config: Optional[QualityConfig] = None,
                 store=None):
        self.forecaster = forecaster
        self.config = config or QualityConfig(enabled=True)
        self.store = store
        self.logger = get_logger("QualityMonitor")
        n = int(forecaster.n_series)
        self._lock = threading.Lock()
        self._acc = {f: np.zeros(n, dtype=np.float64) for f in _ACC_FIELDS}
        # key -> accumulator slot, built once (predict guarantees observed
        # keys are trained keys); composites without a top-level key table
        # grow _extra_index under the lock instead
        self._slot_index: Optional[Dict[tuple, int]] = (
            {tuple(k): i
             for i, k in enumerate(map(tuple, forecaster.keys.tolist()))}
            if hasattr(forecaster, "keys") else None
        )
        self._extra_index: Dict[tuple, int] = {}
        self._nominal = (
            self.config.nominal_coverage
            or config_interval_width(getattr(forecaster, "config", None))
        )
        # quality telemetry, appended to the scorer's /metrics body
        r = MetricsRegistry()
        self.registry = r
        self.observe_requests = r.counter(
            "dftpu_quality_observe_requests_total",
            "POST /observe calls (incl. batch scripts)")
        self.observations_total = r.counter(
            "dftpu_quality_observations_total",
            "actuals scored against served forecasts")
        self.observations_skipped = r.counter(
            "dftpu_quality_observations_skipped_total",
            "actuals dropped: unknown series, unmatched dates, or beyond "
            "max_horizon")
        self.series_observed = r.gauge(
            "dftpu_quality_series_observed",
            "distinct series with at least one scored actual")
        self.family_metrics = r.labeled_gauge(
            "dftpu_quality_metric", ("family", "metric"),
            "rolling forecast quality per model family "
            "(wape | rmsse | coverage)")
        self.nominal_gauge = r.gauge(
            "dftpu_quality_nominal_coverage",
            "the interval width the served bands target "
            "(engine/calibrate.py)")
        self.nominal_gauge.set(self._nominal)

    # -- core ----------------------------------------------------------------
    @property
    def nominal_coverage(self) -> float:
        return float(self._nominal)

    def observe(self, observations: pd.DataFrame,
                on_missing: str = "skip") -> Dict:
        """Score a batch of actuals; returns the per-family summary.

        ``observations``: a long frame with the forecaster's key columns,
        ``ds`` (date-like) and ``y``.  Series unknown to the artifact follow
        ``on_missing`` (predict's contract: "skip" drops them, "raise" makes
        the request a 404); observations dated past ``day1 + max_horizon``
        count as skipped.
        """
        fc = self.forecaster
        self.observe_requests.inc()
        key_names = list(fc.key_names)
        need = key_names + ["ds", "y"]
        missing = [c for c in need if c not in observations.columns]
        if missing:
            raise ValueError(f"observations missing column(s) {missing}")
        obs = observations[need].copy()
        obs["ds"] = pd.to_datetime(obs["ds"])
        obs["y"] = pd.to_numeric(obs["y"], errors="coerce")
        n_in = len(obs)
        freq = getattr(fc, "freq", "D")
        # snap to period ordinals: daily feeds align exactly; a coarser grid
        # buckets each date to its period (tensorize's rule)
        obs["_ord"] = period_ordinals(obs["ds"], freq)

        day1 = getattr(fc, "day1", None)
        if day1 is not None:
            horizon = int(np.clip(obs["_ord"].max() - day1, 1,
                                  self.config.max_horizon))
            in_grid = obs["_ord"] <= day1 + self.config.max_horizon
            obs = obs[in_grid]
        else:  # a composite without a day1: serve what predict covers
            horizon = self.config.max_horizon
        if obs.empty:
            self.observations_skipped.inc(n_in)
            return self.snapshot(series=False)

        req = obs[key_names].drop_duplicates()
        pred = fc.predict(req, horizon=horizon, include_history=True,
                          on_missing=on_missing)
        pred = pred[key_names + ["ds", "yhat", "yhat_lower", "yhat_upper"]]
        merged = obs.merge(
            pred.assign(_ord=period_ordinals(pred["ds"], freq))
                .drop(columns=["ds"]),
            on=key_names + ["_ord"], how="inner")
        scored = self._score(merged, key_names)
        self.observations_total.inc(scored)
        self.observations_skipped.inc(n_in - scored)
        # the worst series ride the response
        summary = self.snapshot(series=True, top=20)
        self._publish(summary)
        return summary

    def _score(self, merged: pd.DataFrame, key_names: List[str]) -> int:
        """Dense layout + ONE term pass on the device + float64 host sums +
        locked accumulation.  Returns the number of scored observations."""
        if merged.empty:
            return 0
        merged = merged.sort_values(key_names + ["_ord"], kind="stable")
        sid, uniq = pd.factorize(
            pd.MultiIndex.from_frame(merged[key_names]), sort=False)
        pos = merged.groupby(sid).cumcount().to_numpy()
        k = len(uniq)
        T = int(pos.max()) + 1
        kb, Tb = _pow2(k), max(_pow2(T), 2)
        dev = _device(self.forecaster)

        def dense(col, fill, dtype):
            out = np.full((kb, Tb), fill, dtype=dtype)
            out[sid, pos] = merged[col].to_numpy(dtype=dtype)
            return torch.from_numpy(out).to(dev)

        mask = np.zeros((kb, Tb), dtype=bool)
        mask[sid, pos] = True
        terms = quality_terms(
            dense("y", np.nan, np.float32), dense("yhat", np.nan, np.float32),
            dense("yhat_lower", 0.0, np.float32),
            dense("yhat_upper", 0.0, np.float32),
            dense("_ord", -10, np.int32),  # a pad never looks consecutive
            torch.from_numpy(mask).to(dev))
        # float64 host sums: bitwise a NumPy reference, stable when unbounded
        sums = {
            f: np.sum(terms[f].cpu().numpy().astype(np.float64), axis=-1)[:k]
            for f in _ACC_FIELDS
        }
        scored = int(sums["n"].sum())
        # the k dense rows -> trained-series slots; a composite's slot
        # resolution grows _extra_index, so mapping and accumulation share
        # the one lock
        with self._lock:
            if self._slot_index is not None:
                slots = np.asarray([self._slot_index[tuple(u)]
                                    for u in uniq])
            else:  # dense slots per observed series, capped
                idx = self._extra_index
                for u in uniq:
                    idx.setdefault(tuple(u),
                                   len(idx) % self.forecaster.n_series)
                slots = np.asarray([idx[tuple(u)] for u in uniq])
            for f in _ACC_FIELDS:
                np.add.at(self._acc[f], slots, sums[f])
            self.series_observed.set(int(np.count_nonzero(self._acc["n"])))
        return scored

    # -- reads ---------------------------------------------------------------
    def snapshot(self, series: bool = True, top: int = 50) -> Dict:
        """JSON-friendly state: family-level rolling metrics (and the worst
        ``top`` series by WAPE when ``series``)."""
        with self._lock:
            acc = {f: self._acc[f].copy() for f in _ACC_FIELDS}
        observed = acc["n"] > 0
        fam_acc = {f: np.array([float(acc[f].sum())]) for f in _ACC_FIELDS}
        fam = {m: float(v[0]) for m, v in _metrics_from_acc(fam_acc).items()}
        out = {
            "family": getattr(self.forecaster, "family", "unknown"),
            "n_series": int(self.forecaster.n_series),
            "series_observed": int(np.count_nonzero(observed)),
            "observations": int(acc["n"].sum()),
            "nominal_coverage": self.nominal_coverage,
            "metrics": fam,
        }
        if series and observed.any() and hasattr(self.forecaster, "keys"):
            per = _metrics_from_acc(acc)
            wape_rank = np.where(np.isnan(per["wape"]), -np.inf, per["wape"])
            order = np.argsort(-wape_rank)[: int(top)]
            keys = self.forecaster.keys
            key_names = list(self.forecaster.key_names)
            rows = []
            for i in order:
                if not observed[i]:
                    continue
                rows.append({
                    **dict(zip(key_names,
                               (int(v) for v in keys[i]))),
                    "n": int(acc["n"][i]),
                    "wape": _nanround(per["wape"][i]),
                    "rmsse": _nanround(per["rmsse"][i]),
                    "coverage": _nanround(per["coverage"][i]),
                })
            out["worst_series"] = rows
        return out

    def coverage(self) -> float:
        """Lifetime family-level coverage (NaN before any observation)."""
        with self._lock:
            n = float(self._acc["n"].sum())
            inside = float(self._acc["inside"].sum())
        return inside / n if n > 0 else float("nan")

    # -- publication ---------------------------------------------------------
    def _publish(self, summary: Dict) -> None:
        """Gauges and store rows from a snapshot; all I/O outside the lock
        (NaN skipped: a gauge must not report 0 for 'no data')."""
        fam = summary["family"]
        for metric, value in summary["metrics"].items():
            if value == value:
                self.family_metrics.set(value, family=fam, metric=metric)
        if self.store is None:
            return
        at = time.time()  # dflint: disable=nondeterminism — store rows are wall-clock telemetry
        points = [{
            "ts": at, "name": f"dftpu_quality_{metric}",
            "labels": {"family": fam}, "value": value,
        } for metric, value in summary["metrics"].items() if value == value]
        points.append({
            "ts": at, "name": "dftpu_quality_observations",
            "labels": {"family": fam}, "value": summary["observations"]})
        for row in summary.get("worst_series", []):
            labels = {"family": fam}
            labels.update({k: str(v) for k, v in row.items()
                           if k not in ("n", "wape", "rmsse", "coverage")})
            for metric in ("wape", "rmsse", "coverage"):
                if row.get(metric) is not None:
                    points.append({
                        "ts": at, "name": f"dftpu_quality_series_{metric}",
                        "labels": labels, "value": row[metric]})
        try:
            # the store synchronizes internally (one atomic O_APPEND write);
            # holding the accumulator lock across disk I/O is what the
            # blocking-under-lock rule catches
            self.store.append(points)  # dflint: disable=unlocked-shared-state — TimeSeriesStore is internally synchronized; deliberately outside _lock
        except OSError:
            self.logger.exception("quality store append failed")


def _nanround(v: float, nd: int = 6) -> Optional[float]:
    v = float(v)
    return None if v != v else round(v, nd)


class QualityRuntime:
    """The wired quality stack one serving process owns: monitor + store +
    scrape loop + SLO evaluator, with one lifecycle and one exposition.

    Built by :func:`build_quality_runtime`; the server mounts
    ``runtime.observe`` behind ``POST /observe``, appends
    ``runtime.render_metrics()`` to the ``/metrics`` body, and calls
    ``attach_server_metrics``, ``start()`` and ``stop()`` around its own
    lifetime.  ``snapshot()`` is the reference's ``/debug/quality`` body; the
    port serves no debug route until tracing is ported (ROADMAP Queue 1:
    P11).
    """

    def __init__(self, monitor=None, store=None, scrape=None, slo=None):
        self.monitor = monitor
        self.store = store
        self.scrape = scrape
        self.slo = slo

    def observe(self, observations: pd.DataFrame,
                on_missing: str = "skip") -> Dict:
        if self.monitor is None:
            raise RuntimeError("quality monitoring is not enabled "
                               "(monitoring.quality.enabled)")
        return self.monitor.observe(observations, on_missing=on_missing)

    def render_metrics(self) -> str:
        parts = []
        if self.monitor is not None:
            parts.append(self.monitor.registry.render_prometheus())
        if self.slo is not None:
            parts.append(self.slo.registry.render_prometheus())
        return "".join(parts)

    def snapshot(self) -> Dict:
        out: Dict = {}
        if self.monitor is not None:
            out["quality"] = self.monitor.snapshot()
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        if self.store is not None:
            out["store"] = self.store.stats()
        return out

    def attach_server_metrics(self, serving_metrics) -> None:
        """Late-bind the serving telemetry the runtime cannot see at build
        time (the latency histogram the latency SLO reads, and the serving
        registry the scrape loop persists) — called by ``ForecastServer``
        before ``start()``."""
        if self.slo is not None:
            self.slo.bind_latency(serving_metrics.latency)
        if self.scrape is not None:
            self.scrape.add_source({}, lambda: serving_metrics.registry)

    def start(self) -> None:
        if self.scrape is not None:
            self.scrape.start()
        if self.slo is not None:
            self.slo.start()

    def stop(self) -> None:
        if self.slo is not None:
            self.slo.stop()
        if self.scrape is not None:
            self.scrape.stop(final_scrape=True)


def build_quality_runtime(
    conf: Optional[dict],
    forecaster,
    latency_histogram=None,
    extra_registries=None,
    tracking_root: Optional[str] = None,
    default_store_dir: Optional[str] = None,
) -> Optional[QualityRuntime]:
    """Wire a :class:`QualityRuntime` from the top-level ``monitoring:``
    conf block; None when nothing in it is enabled.

    Keys are checked strictly (``quality``, ``quality_store``, ``slo``,
    ``tracking_root``, ``cost``).  ``extra_registries``: ``(labels,
    registry_fn)`` pairs the scrape loop persists beside the quality and SLO
    registries.  ``tracking_root`` feeds the staleness SLO (the conf's
    ``monitoring.tracking_root`` wins over it); ``default_store_dir`` backs
    an empty ``quality_store.directory`` (two processes must never share an
    append cursor, so each gets its own directory).  ``cost`` is parsed
    strictly and has no effect (ROADMAP Queue 1: P11).
    """
    from distributed_forecasting_tpu_torch.monitoring.slo import (
        SLOConfig,
        SLOEvaluator,
        latest_run_timestamp,
    )
    from distributed_forecasting_tpu_torch.monitoring.store import (
        QualityStoreConfig,
        ScrapeLoop,
        TimeSeriesStore,
    )

    conf = dict(conf or {})
    unknown = set(conf) - _MONITORING_KEYS
    if unknown:
        raise ValueError(
            f"unknown monitoring conf key(s) {sorted(unknown)}; "
            f"valid: {sorted(_MONITORING_KEYS)}")
    # conf wins over the caller's default: tasks inject the env's tracking
    # root, but an explicit monitoring.tracking_root pins the staleness SLO
    # at another registry (e.g. the production one from a canary)
    tracking_root = conf.get("tracking_root") or tracking_root
    qconf = QualityConfig.from_conf(conf.get("quality"))
    sconf = QualityStoreConfig.from_conf(conf.get("quality_store"))
    slo_conf = SLOConfig.from_conf(conf.get("slo"))
    CostConfig.from_conf(conf.get("cost"))
    if not (qconf.enabled or sconf.enabled or slo_conf.enabled):
        return None
    if slo_conf.enabled and not sconf.enabled:
        raise ValueError(
            "monitoring.slo needs monitoring.quality_store.enabled: "
            "burn-rate windows are means over STORED good/bad samples")

    store = None
    scrape = None
    if sconf.enabled:
        directory = sconf.directory or default_store_dir
        if not directory:
            raise ValueError(
                "monitoring.quality_store.directory is empty and the "
                "caller supplied no default root")
        store = TimeSeriesStore(
            directory, retention_s=sconf.retention_s,
            max_segment_bytes=sconf.max_segment_bytes)

    monitor = None
    if qconf.enabled:
        monitor = QualityMonitor(forecaster, config=qconf, store=store)

    slo = None
    if slo_conf.enabled:
        slo = SLOEvaluator(
            slo_conf, store,
            latency_histogram=latency_histogram,
            coverage_fn=(monitor.coverage if monitor is not None else None),
            nominal_fn=(
                (lambda: monitor.nominal_coverage)
                if monitor is not None else None),
            staleness_fn=(
                (lambda: latest_run_timestamp(tracking_root))
                if tracking_root else None),
        )

    if store is not None:
        sources = list(extra_registries or [])
        if monitor is not None:
            sources.append(({}, lambda: monitor.registry))
        if slo is not None:
            sources.append(({}, lambda: slo.registry))
        scrape = ScrapeLoop(
            store, sources,
            scrape_interval_s=sconf.scrape_interval_s,
            compact_interval_s=sconf.compact_interval_s)

    return QualityRuntime(monitor=monitor, store=store, scrape=scrape,
                          slo=slo)


def check_unported_monitoring(conf: Optional[dict], logger=None) -> None:
    """Parse the ``monitoring.cost`` block strictly and log it: it changes
    no result, and the runtime behind it (the reference's
    ``monitoring/cost.py``) is not ported (ROADMAP Queue 1: P11)."""
    conf = conf or {}
    CostConfig.from_conf(conf.get("cost"))
    if conf.get("cost") is not None and logger is not None:
        logger.info("monitoring.cost: accepted; monitoring/cost.py is not "
                    "ported, so the block has no effect in the port yet "
                    "(ROADMAP Queue 1: P11)")
