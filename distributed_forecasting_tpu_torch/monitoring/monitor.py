"""Model monitoring over forecast tables (port of the host part of the
reference's ``monitoring/monitor.py``).

The reference sketches Databricks model monitoring (``notebooks/prophet/
05_monitoring_wip.py``): ``create_monitor`` over a logging table with
granularities, id/timestamp columns and slicing expressions, plus cleanup
helpers for monitors and registered models.  This module implements that
intent on the port's own :class:`DatasetCatalog`:

  * :class:`MonitorConfig` — what to monitor: a forecast table (the
    ``[ds, keys..., y, yhat, ...]`` schema), timestamp column, granularities
    (e.g. ``1 day``/``1 week``/``1 month``), slicing columns (store, item);
  * :class:`MonitorRegistry` — monitor lifecycle (create/get/list/delete)
    persisted as JSON next to the warehouse;
  * :func:`run_monitor` — the profile-metrics table: per (window,
    granularity, slice) forecast-quality metrics (mape, smape, bias, rmse,
    coverage) over rows where actuals exist, written back to the catalog as
    ``<table>_profile_metrics``;
  * :func:`detect_anomalies`, :func:`drift_report` and
    :func:`degradation_report` — residual z-scores against the model's own
    band, PSI/KS drift between table versions, and latest-window accuracy
    against each slice's own history.

Everything here is pandas and numpy in float64 on the host; the one number
taken from torch is the band's z, the float32 inverse normal CDF, as the
reference takes it from ``jax.scipy.special.ndtri`` (the two are within one
float32 ulp).

The reference's live process metrics are here too, at the end: the
Prometheus primitives (:class:`Counter`, :class:`Gauge`,
:class:`LabeledCounter`, :class:`Histogram`, :class:`LabeledGauge`) and
:class:`MetricsRegistry`, whose text exposition is byte-equal to the
reference's for the same calls.  The scorer's ``GET /metrics`` renders them,
and :class:`IngestMetrics` (the ``dftpu_ingest_*`` set of the streaming
ingest path).  The training-pipeline metric set stays with the executor
(ROADMAP Queue 1: P11).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from distributed_forecasting_tpu_torch.data.catalog import DatasetCatalog
from distributed_forecasting_tpu_torch.models.base import _ndtri

_GRANULARITY_FREQ = {"1 day": "D", "1 week": "W", "1 month": "M"}  # Period freqs


@dataclasses.dataclass
class MonitorConfig:
    name: str
    table: str                        # catalog table with forecasts+actuals
    timestamp_col: str = "ds"
    prediction_col: str = "yhat"
    label_col: str = "y"
    granularities: tuple = ("1 day", "1 week")
    slicing_cols: tuple = ("store", "item")
    interval_cols: tuple = ("yhat_lower", "yhat_upper")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "MonitorConfig":
        d = dict(d)
        for k in ("granularities", "slicing_cols", "interval_cols"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**d)


class MonitorRegistry:
    """Create/list/delete monitors (the reference's ``create_monitor`` /
    ``cleanup_existing_monitor`` lifecycle, ``05_monitoring_wip.py:20-78``)."""

    def __init__(self, root: str):
        self.root = os.path.join(root, "monitors")
        os.makedirs(self.root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.json")

    def create_monitor(self, config: MonitorConfig, exist_ok: bool = True) -> None:
        path = self._path(config.name)
        if os.path.exists(path) and not exist_ok:
            raise FileExistsError(f"monitor {config.name!r} exists")
        with open(path, "w") as f:
            # human-readable provenance only, never numerics
            json.dump({**config.to_dict(),
                       "created_at": time.time()},  # dflint: disable=nondeterminism
                      f, indent=2)

    def get_monitor(self, name: str) -> MonitorConfig:
        path = self._path(name)
        if not os.path.exists(path):
            raise KeyError(f"monitor {name!r} not found")
        with open(path) as f:
            d = json.load(f)
        d.pop("created_at", None)
        return MonitorConfig.from_dict(d)

    def list_monitors(self) -> List[str]:
        return sorted(
            f[:-5] for f in os.listdir(self.root) if f.endswith(".json")
        )

    def delete_monitor(self, name: str) -> None:
        path = self._path(name)
        if os.path.exists(path):
            os.remove(path)


def _row_metrics(df: pd.DataFrame, cfg: MonitorConfig) -> pd.DataFrame:
    """Per-row metric terms; every window/slice metric is then a plain
    groupby mean over these (rmse via sqrt of the err2 mean), which turns
    the profile computation into a handful of vectorized groupbys instead
    of a Python loop over every slice value."""
    y = df[cfg.label_col].to_numpy(dtype=float)
    yhat = df[cfg.prediction_col].to_numpy(dtype=float)
    err = yhat - y
    denom = np.where(np.abs(y) > 1e-9, y, np.nan)
    out = pd.DataFrame(
        {
            "_ape": np.abs(err / denom),  # NaN rows skipped by mean()
            "_sape": np.abs(err)
            / np.maximum((np.abs(y) + np.abs(yhat)) / 2, 1e-9),
            "_err2": err**2,
            "_err": err,
            # missing predictions must surface, not shrink the denominator:
            # groupby mean skips NaN, so carry an indicator and NaN out
            # rmse/bias for any window that contains one (the old np.mean
            # semantics)
            "_prednan": np.isnan(err).astype(float),
        },
        index=df.index,
    )
    lo_c, hi_c = cfg.interval_cols
    if lo_c in df.columns and hi_c in df.columns:
        out["_inside"] = (
            (y >= df[lo_c].to_numpy(float)) & (y <= df[hi_c].to_numpy(float))
        ).astype(float)
    return out


def _grouped_metrics(terms: pd.DataFrame, keys: list) -> pd.DataFrame:
    g = terms.groupby(keys, observed=True)  # dropna default: a NaN slice
    # value never formed a group in the per-value loop this replaces
    agg = g.mean()
    agg["n_obs"] = g.size()
    agg["rmse"] = np.sqrt(agg.pop("_err2"))
    bad = agg.pop("_prednan") > 0
    agg.loc[bad, ["rmse", "_err"]] = np.nan
    agg = agg.rename(
        columns={"_ape": "mape", "_sape": "smape", "_err": "bias",
                 "_inside": "coverage"}
    )
    return agg.reset_index()


def run_monitor(
    catalog: DatasetCatalog,
    config: MonitorConfig,
    output_table: Optional[str] = None,
    df: Optional[pd.DataFrame] = None,
) -> pd.DataFrame:
    """Compute the profile-metrics table and persist it.

    Output rows: one per (window_start, granularity, slice_key, slice_value)
    plus un-sliced ``:all`` rows; written to ``<table>_profile_metrics``.
    ``df``: optional pre-loaded table (a caller running several monitoring
    passes over the same snapshot reads it once).
    """
    if df is None:
        df = catalog.read_table(config.table)
    df = df[~df[config.label_col].isna()].copy()
    if df.empty:
        raise ValueError(f"no labeled rows in {config.table} to monitor")
    ts = pd.to_datetime(df[config.timestamp_col])

    terms = _row_metrics(df, config)
    parts = []
    for gran in config.granularities:
        freq = _GRANULARITY_FREQ.get(gran)
        if freq is None:
            raise ValueError(
                f"unknown granularity {gran!r}; valid: {sorted(_GRANULARITY_FREQ)}"
            )
        window = ts.dt.to_period(freq).dt.start_time.rename("window_start")
        for col in [None, *[c for c in config.slicing_cols if c in df.columns]]:
            keys = [window] if col is None else [df[col], window]
            agg = _grouped_metrics(terms, keys)
            agg["granularity"] = gran
            agg["slice_key"] = col or ":all"
            agg["slice_value"] = (
                agg.pop(col).astype(str) if col is not None else ":all"
            )
            parts.append(agg)
    lead = ["window_start", "granularity", "slice_key", "slice_value",
            "n_obs"]
    if parts:
        profile = pd.concat(parts, ignore_index=True)
        profile = profile[lead + [c for c in profile.columns if c not in lead]]
    else:  # e.g. granularities=() in a hand-edited monitor spec
        profile = pd.DataFrame(columns=lead)
    out_name = output_table or f"{config.table}_profile_metrics"
    catalog.save_table(out_name, profile)
    return profile


def detect_anomalies(
    catalog: DatasetCatalog,
    table: str,
    interval_width: float = 0.95,
    score_threshold: Optional[float] = None,
    label_col: str = "y",
    prediction_col: str = "yhat",
    interval_cols: Tuple[str, str] = ("yhat_lower", "yhat_upper"),
    output_table: Optional[str] = None,
    df: Optional[pd.DataFrame] = None,
) -> pd.DataFrame:
    """Score a forecast table's labeled rows for anomalies.

    Residual z-scores against the model's own predictive band: the
    per-row sigma is recovered from the UPPER half-band, ``(hi - yhat) /
    z_w`` for the ``interval_width`` the model was fit with (the lower
    bound may be clamped — croston floors it at 0, multiplicative/logistic
    bands are asymmetric in data space — so the full width underestimates
    sigma), making the score comparable across series with different
    scales and across lead times (the band widens with horizon).  A row is
    flagged when its score exceeds ``score_threshold`` (default: the z of
    the interval — for symmetric bands that is y outside the band; below a
    clamped lower bound intentionally flags only past the same sigma
    distance).  This is the alerting half the reference's
    WIP monitoring notebook never got to — built on the forecast table the
    training pipeline already writes, no extra model pass needed.

    Returns all scored rows with ``anomaly_score``/``is_anomaly`` columns;
    the flagged subset is persisted to ``<table>_anomalies``.  ``df``: a
    pre-loaded table (MonitorTask shares one read between the profile and
    anomaly passes).
    """
    if df is None:
        df = catalog.read_table(table)
    lo_c, hi_c = interval_cols
    for c in (label_col, prediction_col, lo_c, hi_c):
        if c not in df.columns:
            raise ValueError(f"column {c!r} not in {table}")
    df = df[~df[label_col].isna()].copy()
    if df.empty:
        raise ValueError(f"no labeled rows in {table} to score")
    # the float32 z the model modules price their bands with, on the host
    # (torch's ndtri is correctly rounded; XLA's is up to one ulp off)
    z_w = float(_ndtri(0.5 + interval_width / 2.0, "cpu"))
    if score_threshold is None:
        score_threshold = z_w
    y = df[label_col].to_numpy(float)
    yhat = df[prediction_col].to_numpy(float)
    # sigma from the UPPER half-band only: lower bounds get clamped (croston
    # floors yhat_lower at 0; multiplicative/logistic bands are asymmetric
    # in data space), so (hi-lo)/(2z) under-estimates sigma for
    # intermittent/near-zero series and inflates scores — same rationale as
    # models/base.gaussian_quantiles.  Approximation for transformed bands:
    # the upper half-width is read as one z_w of spread in data space.
    sigma = (df[hi_c].to_numpy(float) - yhat) / z_w
    sigma = np.maximum(sigma, 1e-9)
    df["anomaly_score"] = np.abs(y - yhat) / sigma
    df["is_anomaly"] = df["anomaly_score"] > score_threshold
    out_name = output_table or f"{table}_anomalies"
    catalog.save_table(out_name, df[df["is_anomaly"]])
    return df


def drift_report(
    catalog: DatasetCatalog,
    table: str,
    baseline_version: Optional[str] = None,
    current_version: Optional[str] = None,
    columns: Tuple[str, ...] = ("y", "yhat"),
    slicing_cols: Tuple[str, ...] = (),
    n_bins: int = 10,
    psi_threshold: float = 0.2,
    ks_threshold: float = 0.2,
    output_table: Optional[str] = None,
    df: Optional[pd.DataFrame] = None,
) -> pd.DataFrame:
    """Distribution drift between two versions of a monitored table.

    The third leg of the monitoring triad (profiles, anomalies, drift) the
    reference's WIP monitor gestured at.  The catalog's time travel makes
    the baseline free: compare the current snapshot against an explicit
    ``baseline_version`` (default: the previous version).  Per column and
    per slice it reports:

    * **PSI** (population stability index) over ``n_bins`` quantile bins
      FIXED FROM THE BASELINE (the standard credit-scoring construction):
      <0.1 stable, 0.1-0.25 moderate, >0.25 major by the usual rule of
      thumb; ``drifted`` flags PSI > ``psi_threshold``;
    * **KS**: the Kolmogorov-Smirnov sup-distance between the empirical
      CDFs — consulted for the ``drifted`` flag too (``ks_threshold``),
      because PSI degenerates when the baseline's quantile edges collapse
      on tied values (e.g. intermittent demand that is mostly zeros);
    * segments that VANISH from or are NEW in the current snapshot (slice
      values on one side only) get a row with ``status`` vanished/new and
      ``drifted=True`` — a missing store is the strongest drift there is.

    Returns one row per (column, slice_key, slice_value) incl. ``:all``
    rows, persisted to ``<table>_drift`` (or ``output_table``).  ``df``:
    pre-loaded CURRENT snapshot (a caller sharing one read across
    monitoring passes), only valid when ``current_version`` is None.
    """
    versions = catalog.table_versions(table)
    if baseline_version is None:
        if len(versions) < 2:
            raise ValueError(
                f"{table} has {len(versions)} version(s); drift needs a "
                f"baseline — write a new snapshot or pass baseline_version"
            )
        baseline_version = versions[-2]
    if df is not None and current_version is None:
        cur = df
    else:
        cur = catalog.read_table(table, version=current_version)
    base = catalog.read_table(table, version=baseline_version)

    def _one(col: str, b: np.ndarray, c: np.ndarray) -> Dict:
        b = b[np.isfinite(b)]
        c = c[np.isfinite(c)]
        if b.size < n_bins or c.size < n_bins:
            return {"psi": float("nan"), "ks": float("nan"),
                    "n_baseline": int(b.size), "n_current": int(c.size)}
        # quantile bin edges from the BASELINE; open outer edges
        qs = np.linspace(0, 1, n_bins + 1)[1:-1]
        edges = np.unique(np.quantile(b, qs))
        pb = np.histogram(b, bins=[-np.inf, *edges, np.inf])[0] / b.size
        pc = np.histogram(c, bins=[-np.inf, *edges, np.inf])[0] / c.size
        eps = 1e-4
        pb = np.clip(pb, eps, None)
        pc = np.clip(pc, eps, None)
        pb, pc = pb / pb.sum(), pc / pc.sum()
        psi = float(np.sum((pc - pb) * np.log(pc / pb)))
        # KS over the pooled support
        grid = np.sort(np.concatenate([b, c]))
        cdf_b = np.searchsorted(np.sort(b), grid, side="right") / b.size
        cdf_c = np.searchsorted(np.sort(c), grid, side="right") / c.size
        ks = float(np.abs(cdf_b - cdf_c).max())
        return {"psi": psi, "ks": ks,
                "n_baseline": int(b.size), "n_current": int(c.size)}

    rows = []
    # UNION of slice values: a segment on one side only is itself drift
    slice_plan = [(None, None)] + [
        (sc, v)
        for sc in slicing_cols
        if sc in cur.columns and sc in base.columns
        for v in sorted(set(cur[sc].unique()) | set(base[sc].unique()))
    ]
    for col in columns:
        if col not in cur.columns or col not in base.columns:
            raise ValueError(f"column {col!r} not in both versions of {table}")
        for sc, v in slice_plan:
            bsel = base if sc is None else base[base[sc] == v]
            csel = cur if sc is None else cur[cur[sc] == v]
            nb, nc = len(bsel), len(csel)
            if nb > 0 and nc == 0:
                status, drifted = "vanished", True
            elif nb == 0 and nc > 0:
                status, drifted = "new", True
            else:
                status = "compared"
                drifted = None  # from the stats below
            stats = _one(col, bsel[col].to_numpy(float),
                         csel[col].to_numpy(float))
            if drifted is None:
                psi_hit = (
                    np.isfinite(stats["psi"])
                    and stats["psi"] > psi_threshold
                )
                ks_hit = (
                    np.isfinite(stats["ks"]) and stats["ks"] > ks_threshold
                )
                drifted = bool(psi_hit or ks_hit)
            rows.append({
                "column": col,
                "slice_key": sc or ":all",
                "slice_value": str(v) if sc is not None else ":all",
                "baseline_version": baseline_version,
                "current_version": current_version or versions[-1],
                "status": status,
                **stats,
                "drifted": drifted,
            })
    out = pd.DataFrame(rows)
    catalog.save_table(output_table or f"{table}_drift", out)
    return out


def degradation_report(
    catalog: DatasetCatalog,
    config: MonitorConfig,
    profile: Optional[pd.DataFrame] = None,
    metric: str = "mape",
    granularity: str = "1 week",
    min_windows: int = 6,
    z_threshold: float = 3.0,
    output_table: Optional[str] = None,
) -> pd.DataFrame:
    """Flag slices whose LATEST window's realized accuracy degraded vs
    their own history — the alerting layer over the profile table.

    The profile (:func:`run_monitor`) already tracks per-window quality;
    this closes the loop the reference's WIP monitor gestured at
    ("model quality monitoring"): for every (slice_key, slice_value), the
    trailing windows (all but the latest) form a robust baseline —
    median + MAD — and the latest window is scored one-sided,

        z = (latest - median) / (1.4826 * MAD)

    (one-sided because only WORSE matters: a metric improving is not an
    alert).  ``degraded`` is z > z_threshold; slices with fewer than
    ``min_windows`` windows report ``insufficient_history`` instead of a
    verdict, and a zero-MAD baseline (flat history) falls back to a small
    fraction of the median so a genuinely flat-then-broken slice still
    alerts.  Output persists to ``<table>_degradation``.
    """
    if metric not in ("mape", "smape", "rmse", "bias", "coverage"):
        raise ValueError(f"unknown degradation metric {metric!r}")
    if profile is None:
        profile = run_monitor(catalog, config, df=None)
    if metric not in profile.columns:
        # coverage is only profiled when the table carries interval columns
        raise ValueError(
            f"profile has no {metric!r} column — for 'coverage' the "
            f"monitored table must carry the interval columns "
            f"{config.interval_cols}"
        )
    part = profile[profile.granularity == granularity]
    if part.empty:
        raise ValueError(
            f"profile has no rows at granularity {granularity!r} "
            f"(monitor granularities: {config.granularities})"
        )
    rows = []
    for (skey, sval), grp in part.groupby(["slice_key", "slice_value"]):
        grp = grp.sort_values("window_start")
        vals = grp[metric].to_numpy(dtype=float)
        # orient so LARGER always means worse: coverage degrades down;
        # bias degrades in BOTH directions (a severe under-forecast is as
        # broken as an over-forecast), so its score is the absolute
        # deviation from the baseline median
        if metric == "coverage":
            series = -vals
        elif metric == "bias":
            base_med = float(np.nanmedian(vals[:-1])) if len(vals) > 1 else 0.0
            series = np.abs(vals - base_med)
        else:
            series = vals
        latest_raw = series[-1] if len(series) else np.nan
        base = series[:-1][np.isfinite(series[:-1])]
        n = base.size + int(np.isfinite(latest_raw))
        row = {
            "slice_key": skey,
            "slice_value": sval,
            "metric": metric,
            "granularity": granularity,
            "n_windows": int(n),
            "latest_window": grp["window_start"].iloc[-1],
            "latest_value": float(vals[-1]) if len(vals) else np.nan,
            "baseline_median": float(np.nanmedian(vals[:-1]))
            if len(vals) > 1 else np.nan,
        }
        if not np.isfinite(latest_raw):
            # the latest window was unmeasurable (e.g. rmse NaN'd by a
            # missing prediction): say so — scoring an OLDER window as
            # "latest" would let a broken-and-unmeasurable window pass
            row.update(z_score=np.nan, degraded=False,
                       insufficient_history=False, latest_unmeasured=True)
            rows.append(row)
            continue
        if n < min_windows:
            row.update(z_score=np.nan, degraded=False,
                       insufficient_history=True, latest_unmeasured=False)
            rows.append(row)
            continue
        med = float(np.median(base))
        mad = float(np.median(np.abs(base - med)))
        scale = 1.4826 * mad
        if scale <= 0:
            # flat history: a relative floor keeps z finite and still
            # catches a break (1% of |median|, or epsilon for ~zero bases)
            scale = max(0.01 * abs(med), 1e-9)
        z = (latest_raw - med) / scale
        row.update(
            z_score=float(z),
            degraded=bool(z > z_threshold),
            insufficient_history=False,
            latest_unmeasured=False,
        )
        rows.append(row)
    report = pd.DataFrame(rows)
    out_name = output_table or f"{config.table}_degradation"
    catalog.save_table(out_name, report)
    return report


# ---------------------------------------------------------------------------
# Live process metrics (counters/gauges/histograms + Prometheus exposition)
#
# The table-based monitors above close the loop on MODEL quality, offline.
# The serving path needs the other half of the reference's monitoring story:
# live process telemetry — request counters, queue depth, latency and
# coalesced-batch-size distributions — scraped from the scorer itself
# (serving/server.py's GET /metrics).  These are deliberately tiny,
# dependency-free, thread-safe primitives in the Prometheus data model, not
# a client-library vendoring: the image carries no prometheus_client, and a
# scorer needs exactly counters, gauges and fixed-bucket histograms.
# ---------------------------------------------------------------------------


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integral floats render as integers."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def escape_label_value(value) -> str:
    """Escape a label VALUE per the text exposition format 0.0.4: backslash,
    double-quote and newline must be escaped inside the quoted value, in
    this order (escaping the escape character first).  Label values are the
    one place arbitrary strings (model families, AOT entry names, span
    kinds) reach the exposition, so un-escaped quotes or newlines would let
    one hostile or merely unlucky name corrupt the whole scrape."""
    return (str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP text escaping (format 0.0.4): backslash and newline only —
    a newline in help text would otherwise terminate the comment line and
    inject whatever follows as a sample line."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def render_labels(labels: Dict[str, str]) -> str:
    """``{a="x",b="y"}`` with escaped values; empty dict renders nothing."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing counter (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self, name: str) -> List[str]:
        return [f"{name} {_fmt_value(self.value)}"]

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Settable instantaneous value (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self, name: str) -> List[str]:
        return [f"{name} {_fmt_value(self.value)}"]

    def snapshot(self) -> float:
        return self.value


class LabeledCounter:
    """Counter family keyed by label values (thread-safe).

    The plain :class:`Counter` covers fixed-name telemetry; this is the
    labeled variant for low-cardinality breakdowns (AOT entry × outcome,
    span kinds).  Values render with :func:`escape_label_value`, so family
    members named with quotes/backslashes/newlines cannot corrupt the
    exposition.  Keep label cardinality bounded by construction — every
    distinct label combination is a live time series.
    """

    def __init__(self, label_names: Tuple[str, ...]) -> None:
        if not label_names:
            raise ValueError("labeled counter needs at least one label")
        self._label_names = tuple(label_names)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        if set(labels) != set(self._label_names):
            raise ValueError(
                f"expected labels {self._label_names}, got {sorted(labels)}")
        key = tuple(str(labels[k]) for k in self._label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(str(labels[k]) for k in self._label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self, name: str) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            name
            + render_labels(dict(zip(self._label_names, key)))
            + f" {_fmt_value(v)}"
            for key, v in items
        ]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            items = sorted(self._values.items())
        return {
            ",".join(f"{k}={v}" for k, v in zip(self._label_names, key)): val
            for key, val in items
        }


class Histogram:
    """Fixed-bucket histogram in the Prometheus cumulative-``le`` model.

    Buckets are upper bounds; every observation also lands in the implicit
    ``+Inf`` bucket, and ``sum``/``count`` ride along so scrapers can derive
    means and quantile estimates.
    """

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._uppers = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._uppers) + 1)  # +1 = +Inf
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self._uppers)
        for j, ub in enumerate(self._uppers):
            if v <= ub:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += v

    def _state(self) -> Tuple[List[int], float]:
        """One consistent (counts, sum) pair; every read path derives from a
        single locked snapshot so bucket counts and _sum never tear against
        a concurrent observe()."""
        with self._lock:
            return list(self._counts), self._sum

    @property
    def count(self) -> int:
        counts, _ = self._state()
        return sum(counts)

    @property
    def sum(self) -> float:
        _, total = self._state()
        return total

    def _cumulative(self, counts: List[int]) -> List[Tuple[str, int]]:
        out, running = [], 0
        for ub, c in zip(self._uppers, counts):
            running += c
            out.append((f"{ub:g}", running))
        out.append(("+Inf", running + counts[-1]))
        return out

    def cumulative_buckets(self) -> List[Tuple[str, int]]:
        counts, _ = self._state()
        return self._cumulative(counts)

    def render(self, name: str) -> List[str]:
        counts, total = self._state()
        lines = [
            f'{name}_bucket{{le="{le}"}} {c}'
            for le, c in self._cumulative(counts)
        ]
        lines.append(f"{name}_sum {_fmt_value(total)}")
        lines.append(f"{name}_count {sum(counts)}")
        return lines

    def snapshot(self) -> Dict:
        counts, total = self._state()
        return {
            "count": sum(counts),
            "sum": total,
            "buckets": dict(self._cumulative(counts)),
        }

    def snapshot_quantiles(
        self, qs: Tuple[float, ...] = (0.5, 0.95, 0.99)
    ) -> Dict[float, float]:
        """Quantile estimates from ONE locked (counts, sum) snapshot — the
        shared derivation the SLO evaluator and report scripts use instead
        of re-deriving quantiles from bucket text ad hoc.

        Prometheus ``histogram_quantile`` convention: each quantile reports
        the upper bound of the bucket its rank falls in (no intra-bucket
        interpolation — fixed buckets cannot support it honestly), clamped
        to the highest FINITE bound when the rank lands in +Inf.  An empty
        histogram reports NaN for every level, which no threshold compares
        true against — an SLO on an idle endpoint stays quiet.
        """
        counts, _ = self._state()
        total = sum(counts)
        out: Dict[float, float] = {}
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile {q} outside [0, 1]")
            if total == 0:
                out[q] = float("nan")
                continue
            rank = q * total
            running = 0
            value = self._uppers[-1]  # +Inf rank clamps to top finite bound
            for ub, c in zip(self._uppers, counts):
                running += c
                if running >= rank and c:
                    value = ub
                    break
            out[q] = float(value)
        return out


class LabeledGauge:
    """Gauge family keyed by label values (thread-safe) — the settable
    counterpart of :class:`LabeledCounter`, for per-rule/per-family live
    values (SLO burn rates, rolling quality per model family).  Same
    escaping and cardinality caveats as the labeled counter."""

    def __init__(self, label_names: Tuple[str, ...]) -> None:
        if not label_names:
            raise ValueError("labeled gauge needs at least one label")
        self._label_names = tuple(label_names)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict) -> Tuple[str, ...]:
        if set(labels) != set(self._label_names):
            raise ValueError(
                f"expected labels {self._label_names}, got {sorted(labels)}")
        return tuple(str(labels[k]) for k in self._label_names)

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self, name: str) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            name
            + render_labels(dict(zip(self._label_names, key)))
            + f" {_fmt_value(v)}"
            for key, v in items
        ]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            items = sorted(self._values.items())
        return {
            ",".join(f"{k}={v}" for k, v in zip(self._label_names, key)): val
            for key, val in items
        }


class MetricsRegistry:
    """Named metrics + Prometheus text exposition (format 0.0.4).

    One registry per scorer process; ``render_prometheus()`` is what the
    ``GET /metrics`` endpoint returns, ``snapshot()`` is the JSON-friendly
    view tests and in-process consumers use.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Tuple[str, str, object]] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, kind: str, help_text: str, metric):
        with self._lock:
            if name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = (kind, help_text, metric)
        return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(name, "counter", help_text, Counter())

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(name, "gauge", help_text, Gauge())

    def histogram(
        self, name: str, buckets: Tuple[float, ...], help_text: str = ""
    ) -> Histogram:
        return self._register(name, "histogram", help_text, Histogram(buckets))

    def labeled_counter(
        self, name: str, label_names: Tuple[str, ...], help_text: str = ""
    ) -> LabeledCounter:
        return self._register(
            name, "counter", help_text, LabeledCounter(label_names))

    def labeled_gauge(
        self, name: str, label_names: Tuple[str, ...], help_text: str = ""
    ) -> LabeledGauge:
        return self._register(
            name, "gauge", help_text, LabeledGauge(label_names))

    def items(self) -> List[Tuple[str, str, object]]:
        """(name, kind, metric) triples from one locked registry snapshot —
        the public walk the scrape loop uses (the metric objects are
        themselves thread-safe, only the registry dict needs the lock)."""
        with self._lock:
            return [(n, k, m) for n, (k, _, m) in self._metrics.items()]

    def render_prometheus(self) -> str:
        with self._lock:
            items = list(self._metrics.items())
        lines: List[str] = []
        for name, (kind, help_text, metric) in items:
            if help_text:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(metric.render(name))
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        with self._lock:
            items = list(self._metrics.items())
        return {name: metric.snapshot() for name, (_, _, metric) in items}


# the reference's pipeline stage buckets (monitoring/monitor._STAGE_BUCKETS),
# which its ingest histograms share
_INGEST_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0)


class IngestMetrics:
    """Telemetry for the streaming ingest path (``dftpu_ingest_*``).

    One instance per :class:`serving.ingest.IngestRuntime`, its registry
    appended to the serving ``GET /metrics`` exposition.  Same discipline
    as the serving metrics: attributes are created once here, the metric
    objects themselves are thread-safe, so the HTTP handler threads, the
    WAL follower, and the refit scheduler observe freely.

    Fleet note: ``wal_bytes`` / ``wal_segments`` / ``applied_day`` describe
    SHARED state when replicas converge over one WAL directory — the
    reference's fleet aggregator max-merges them instead of summing (the
    fleet is ROADMAP Queue 1: P12).  ``tail_window_refits_total`` counts
    the windowed path's refits (P9's second half) and stays 0 until it is
    ported.
    """

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.points_total = self.registry.counter(
            "dftpu_ingest_points_total",
            "observation points accepted into the WAL")
        self.late_points_total = self.registry.counter(
            "dftpu_ingest_late_points_total",
            "points at or before the applied day (history-only until the "
            "next full refit)")
        self.unknown_series_total = self.registry.counter(
            "dftpu_ingest_unknown_series_total",
            "points dropped because their key matches no fitted series")
        self.out_of_range_total = self.registry.counter(
            "dftpu_ingest_out_of_range_total",
            "points dropped before the WAL because their day falls before "
            "the training grid or beyond the max_pending_days horizon")
        self.wal_appends_total = self.registry.counter(
            "dftpu_ingest_wal_appends_total",
            "WAL append batches written (one O_APPEND write each)")
        self.applied_points_total = self.registry.counter(
            "dftpu_ingest_applied_points_total",
            "points applied to model state via batched update dispatches")
        self.refits_total = self.registry.counter(
            "dftpu_ingest_refits_total",
            "background full refits completed and swapped in")
        self.tail_window_refits_total = self.registry.counter(
            "dftpu_ingest_tail_window_refits_total",
            "windowed refits that re-fit only the tail window, reusing "
            "frozen per-window stats for the untouched prefix "
            "(engine.windowed streaming path)")
        self.wal_bytes = self.registry.gauge(
            "dftpu_ingest_wal_bytes",
            "total bytes across WAL segments (shared in fleet mode: "
            "max-merged by the aggregator)")
        self.wal_segments = self.registry.gauge(
            "dftpu_ingest_wal_segments",
            "number of WAL segment files (shared in fleet mode: "
            "max-merged by the aggregator)")
        self.dirty_series = self.registry.gauge(
            "dftpu_ingest_dirty_series",
            "series with pending unapplied points")
        self.pending_days = self.registry.gauge(
            "dftpu_ingest_pending_days",
            "distinct future days waiting in the pending buffer")
        self.applied_day = self.registry.gauge(
            "dftpu_ingest_applied_day",
            "absolute day ordinal the model state is current through "
            "(shared in fleet mode: max-merged by the aggregator)")
        self.refit_backlog = self.registry.gauge(
            "dftpu_ingest_refit_backlog",
            "points applied incrementally since the last full refit")
        self.update_seconds = self.registry.histogram(
            "dftpu_ingest_update_seconds", _INGEST_BUCKETS,
            "wall seconds per batched state-update dispatch")
        self.refit_seconds = self.registry.histogram(
            "dftpu_ingest_refit_seconds", _INGEST_BUCKETS,
            "wall seconds per background full refit (fit + replay + swap)")
        self.ingest_shutdown_stuck_total = self.registry.counter(
            "dftpu_ingest_shutdown_stuck_total",
            "shutdowns where the WAL follower thread outlived its join "
            "timeout and was leaked (daemon) instead of drained")
        self.refit_shutdown_stuck_total = self.registry.counter(
            "dftpu_refit_shutdown_stuck_total",
            "shutdowns where the refit scheduler thread outlived its join "
            "timeout and was leaked (daemon) instead of drained")
