"""Declarative SLOs with multi-window burn-rate alerting (port of the
reference's ``monitoring/slo.py``; framework-free, so this is its own copy,
with the reference's rules, metric names, label sets, help texts and store
series).

The quality layer (``monitoring/quality.py``) measures; this module
decides.  A strict ``monitoring.slo`` conf block declares objectives over
three SLI kinds the serving stack already produces:

  * ``latency_quantile`` — a quantile of the serving latency histogram
    (``Histogram.snapshot_quantiles``, one locked snapshot) must stay at or
    under ``objective`` seconds;
  * ``coverage`` — the quality monitor's rolling calibration coverage must
    stay within ``±tolerance`` of the nominal interval width
    (``engine/calibrate.py``'s ``config_interval_width``, or the conf
    override);
  * ``staleness`` — the age of the newest FINISHED tracking run
    (``tracking/filestore.py`` run ``end_time``/``start_time`` stamps)
    must stay under ``objective`` seconds: a model nobody retrains is a
    quality incident waiting to be measured.

Alerting follows the multi-window burn-rate construction (the SRE-workbook
shape): each evaluation tick appends a good/bad sample to the time-series
store, the burn rate over window W is ``mean(bad over W) / error_budget``,
and a rule FIRES only when every configured window burns past its
threshold — the short window proves it's happening NOW, the long window
proves it's not a blip.  It CLEARS when the shortest window recovers.
Results surface as ``dftpu_slo_*`` gauges on ``/metrics`` (the reference's
fleet front door max-merges them, so an SLO firing anywhere is firing
fleet-wide; the port's fleet is ROADMAP Queue 1: P12).

Conf::

    monitoring:
      slo:
        enabled: true
        evaluation_interval_s: 30
        error_budget: 0.05           # allowed bad-tick fraction
        windows: [[300, 2.0], [3600, 1.0]]   # [window_s, burn_threshold]
        rules:
          - {name: predict_latency_p95, kind: latency_quantile,
             quantile: 0.95, objective: 0.5}
          - {name: calibration_coverage, kind: coverage, tolerance: 0.05}
          - {name: model_staleness, kind: staleness, objective: 604800}

Every rule evaluation is exception-isolated;
``dftpu_slo_evaluation_errors_total`` counts failures (``chip_smoke.py``'s
scorer phase gates on it staying zero).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.utils.logging import get_logger

_KINDS = ("latency_quantile", "coverage", "staleness")
_BAD_SERIES = "dftpu_slo_bad"      # 0/1 per (rule, tick) in the store
_SLI_SERIES = "dftpu_slo_sli"


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One objective.  ``objective`` means: max seconds for
    ``latency_quantile`` and ``staleness``; target coverage for
    ``coverage`` (0 -> the monitor's nominal width)."""

    name: str
    kind: str
    objective: float = 0.0
    quantile: float = 0.95       # latency_quantile only
    tolerance: float = 0.05      # coverage only

    def __post_init__(self):
        if not self.name:
            raise ValueError("slo rule needs a name")
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown slo rule kind {self.kind!r}; valid: {_KINDS}")
        if self.kind != "coverage" and self.objective <= 0:
            raise ValueError(
                f"rule {self.name!r}: objective must be > 0 seconds")
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"rule {self.name!r}: quantile outside (0, 1)")
        if not 0.0 < self.tolerance < 1.0:
            raise ValueError(f"rule {self.name!r}: tolerance outside (0, 1)")

    @classmethod
    def from_conf(cls, conf: dict) -> "SLORule":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            raise ValueError(
                f"unknown monitoring.slo rule key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        return cls(**{k: conf[k] for k in conf})


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """The ``monitoring.slo`` conf block."""

    enabled: bool = False
    evaluation_interval_s: float = 30.0
    error_budget: float = 0.05
    windows: Tuple[Tuple[float, float], ...] = ((300.0, 2.0), (3600.0, 1.0))
    rules: Tuple[SLORule, ...] = ()

    def __post_init__(self):
        if self.evaluation_interval_s <= 0:
            raise ValueError("evaluation_interval_s must be > 0")
        if not 0.0 < self.error_budget <= 1.0:
            raise ValueError("error_budget must be in (0, 1]")
        if not self.windows:
            raise ValueError("slo needs at least one burn-rate window")
        for w, t in self.windows:
            if w <= 0 or t <= 0:
                raise ValueError(
                    f"burn-rate window [{w}, {t}] must be positive")
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo rule names in {names}")

    @property
    def short_window(self) -> Tuple[float, float]:
        return min(self.windows, key=lambda wt: wt[0])

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "SLOConfig":
        conf = dict(conf or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            raise ValueError(
                f"unknown monitoring.slo conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs: Dict = {}
        if "enabled" in conf:
            kwargs["enabled"] = bool(conf["enabled"])
        if "evaluation_interval_s" in conf:
            kwargs["evaluation_interval_s"] = float(
                conf["evaluation_interval_s"])
        if "error_budget" in conf:
            kwargs["error_budget"] = float(conf["error_budget"])
        if "windows" in conf:
            windows = conf["windows"]
            if not isinstance(windows, (list, tuple)):
                raise ValueError("monitoring.slo windows must be a list of "
                                 "[window_s, burn_threshold] pairs")
            kwargs["windows"] = tuple(
                (float(w[0]), float(w[1])) for w in windows)
        if "rules" in conf:
            rules = conf["rules"]
            if not isinstance(rules, (list, tuple)):
                raise ValueError("monitoring.slo rules must be a list")
            kwargs["rules"] = tuple(SLORule.from_conf(dict(r))
                                    for r in rules)
        return cls(**kwargs)


def latest_run_timestamp(tracking_root: str) -> Optional[float]:
    """Newest run timestamp under a FileTracker root — ``end_time`` when the
    run finished, else ``start_time`` (an in-flight retrain still counts as
    freshness).  None when no run has ever been logged."""
    latest: Optional[float] = None
    pattern = os.path.join(tracking_root, "experiments", "*", "runs", "*",
                           "meta.json")
    for path in glob.glob(pattern):
        try:
            with open(path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        ts = meta.get("end_time") or meta.get("start_time")
        if ts is not None and (latest is None or float(ts) > latest):
            latest = float(ts)
    return latest


class SLOEvaluator:
    """Periodic rule evaluation: SLI -> good/bad sample -> burn rates ->
    ``dftpu_slo_*`` gauges.

    Sources are injected callables so the evaluator carries no serving
    imports: ``latency_histogram`` (the serving latency Histogram or None),
    ``coverage_fn`` (-> rolling coverage, NaN before data),
    ``nominal_fn`` (-> target width), ``staleness_fn`` (-> newest run
    timestamp or None).  ``_lock`` guards the per-rule firing state; store
    reads/writes happen outside it (snapshot-then-write, the fleet
    supervisor's discipline).
    """

    def __init__(
        self,
        config: SLOConfig,
        store,
        latency_histogram=None,
        coverage_fn=None,
        nominal_fn=None,
        staleness_fn=None,
    ):
        self.config = config
        self.store = store
        self._latency = latency_histogram
        self._coverage_fn = coverage_fn
        self._nominal_fn = nominal_fn
        self._staleness_fn = staleness_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._firing: Dict[str, bool] = {r.name: False for r in config.rules}
        self.logger = get_logger("SLOEvaluator")

        r = MetricsRegistry()
        self.registry = r
        self.evaluations = r.counter(
            "dftpu_slo_evaluations_total", "SLO evaluation ticks completed")
        self.evaluation_errors = r.counter(
            "dftpu_slo_evaluation_errors_total",
            "rule evaluations that raised (isolated per rule)")
        self.sli_gauge = r.labeled_gauge(
            "dftpu_slo_sli", ("rule",),
            "current SLI value per rule (seconds or coverage fraction)")
        self.burn_gauge = r.labeled_gauge(
            "dftpu_slo_burn_rate", ("rule", "window"),
            "error-budget burn rate per rule and window")
        self.firing_gauge = r.labeled_gauge(
            "dftpu_slo_firing", ("rule",),
            "1 while every burn-rate window of the rule exceeds its "
            "threshold (multi-window alerting)")

    def bind_latency(self, histogram) -> None:
        """Late-bind the serving latency histogram — it only exists once
        the server process constructs its ``ServingMetrics``.  Called
        before ``start()``, so the write happens-before the evaluator
        thread ever reads it."""
        self._latency = histogram  # dflint: disable=unlocked-shared-state — bound before start(); happens-before the evaluator thread

    # -- SLI computation -----------------------------------------------------
    def _sli(self, rule: SLORule, now: float) -> Tuple[float, Optional[bool]]:
        """(sli_value, bad) — ``bad`` None when the SLI is unmeasurable
        (no traffic yet / no runs yet): no budget burns on silence."""
        if rule.kind == "latency_quantile":
            if self._latency is None:
                return float("nan"), None
            q = self._latency.snapshot_quantiles((rule.quantile,))[
                rule.quantile]
            if q != q:
                return float("nan"), None
            return q, q > rule.objective
        if rule.kind == "coverage":
            if self._coverage_fn is None:
                return float("nan"), None
            cov = float(self._coverage_fn())
            if cov != cov:
                return float("nan"), None
            target = rule.objective or (
                float(self._nominal_fn()) if self._nominal_fn else 0.95)
            return cov, abs(cov - target) > rule.tolerance
        # staleness
        if self._staleness_fn is None:
            return float("nan"), None
        ts = self._staleness_fn()
        if ts is None:
            return float("nan"), None
        age = max(now - float(ts), 0.0)
        return age, age > rule.objective

    def _burn_rates(self, rule: SLORule, now: float) -> Dict[float, float]:
        """Burn per window from the stored bad/good samples: mean(bad) /
        error_budget; a window with no samples burns 0."""
        out: Dict[float, float] = {}
        for window_s, _ in self.config.windows:
            pts = self.store.query(
                name=_BAD_SERIES, since=now - window_s,
                labels={"rule": rule.name})
            if pts:
                bad_frac = sum(p["value"] for p in pts) / len(pts)
                out[window_s] = bad_frac / self.config.error_budget
            else:
                out[window_s] = 0.0
        return out

    # -- the tick ------------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> Dict:
        """One evaluation pass over every rule; returns the JSON-friendly
        state ``/debug/quality`` embeds."""
        if now is None:
            now = time.time()  # dflint: disable=nondeterminism — SLO windows are wall-clock by definition
        results = []
        points: List[Dict] = []
        for rule in self.config.rules:
            try:
                sli, bad = self._sli(rule, now)
                if bad is not None:
                    points.append({
                        "ts": now, "name": _BAD_SERIES,
                        "labels": {"rule": rule.name},
                        "value": 1.0 if bad else 0.0})
                    points.append({
                        "ts": now, "name": _SLI_SERIES,
                        "labels": {"rule": rule.name}, "value": sli})
                results.append((rule, sli, bad))
            except Exception:  # noqa: BLE001 — one broken rule must not silence the rest
                self.evaluation_errors.inc()
                self.logger.exception("slo rule %s failed", rule.name)
        if points:
            # outside any lock: the store synchronizes internally (one
            # atomic O_APPEND write per batch)
            self.store.append(points)  # dflint: disable=unlocked-shared-state — TimeSeriesStore is internally synchronized; deliberately outside _lock
        state: Dict = {"rules": []}
        short_w = self.config.short_window[0]
        for rule, sli, bad in results:
            try:
                burns = self._burn_rates(rule, now)
                burning_all = all(
                    burns[w] > threshold
                    for w, threshold in self.config.windows)
                short_thresh = self.config.short_window[1]
                with self._lock:
                    firing = self._firing[rule.name]
                    if burning_all:
                        firing = True
                    elif burns[short_w] <= short_thresh:
                        # hysteresis: clear on short-window recovery only
                        firing = False
                    self._firing[rule.name] = firing
                if sli == sli:
                    self.sli_gauge.set(sli, rule=rule.name)
                for w, burn in burns.items():
                    self.burn_gauge.set(burn, rule=rule.name,
                                        window=f"{w:g}s")
                self.firing_gauge.set(1.0 if firing else 0.0,
                                      rule=rule.name)
                state["rules"].append({
                    "name": rule.name, "kind": rule.kind,
                    "sli": None if sli != sli else round(float(sli), 6),
                    "bad": bad, "firing": firing,
                    "burn_rates": {f"{w:g}s": round(b, 4)
                                   for w, b in burns.items()},
                })
            except Exception:  # noqa: BLE001
                self.evaluation_errors.inc()
                self.logger.exception("slo burn-rate for %s failed",
                                      rule.name)
        self.evaluations.inc()
        return state

    def snapshot(self) -> Dict:
        with self._lock:
            firing = dict(self._firing)
        return {
            "enabled": self.config.enabled,
            "error_budget": self.config.error_budget,
            "windows": [list(w) for w in self.config.windows],
            "firing": firing,
            "evaluations": self.evaluations.value,
            "evaluation_errors": self.evaluation_errors.value,
        }

    # -- lifecycle -----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.config.evaluation_interval_s):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — the loop must outlive one bad tick
                self.evaluation_errors.inc()
                self.logger.exception("slo evaluation tick failed")

    def start(self) -> None:
        # lifecycle runs on the owning (server) thread only; _lock guards
        # the firing map the evaluator thread shares, not these
        if self._thread is not None:
            return
        self._thread = threading.Thread(  # dflint: disable=unlocked-shared-state — lifecycle field touched only by the owning thread
            target=self._run, name="slo-evaluator", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None  # dflint: disable=unlocked-shared-state — lifecycle field touched only by the owning thread
