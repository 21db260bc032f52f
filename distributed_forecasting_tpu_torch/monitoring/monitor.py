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
float32 ulp).  The reference's live
process metrics (counters, gauges, histograms, ``MetricsRegistry``) are not
ported (ROADMAP Queue 1: P10).
"""

from __future__ import annotations

import dataclasses
import json
import os
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
