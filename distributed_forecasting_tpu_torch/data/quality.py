"""Ingest-time data-quality report for the long sales format (port of the
reference's ``data/quality.py``).

Tensorize is deliberately forgiving (duplicate (key, date) rows sum, gaps
become mask=0), which is right for the fit path but wrong as the only line
of defense: a silently-summed duplicate feed or a 40%-gap series is an
upstream data incident someone should see.

:func:`quality_report` is the cheap, vectorized pre-pass: one frame in, a
typed report out — row/series counts, duplicate (store, item, date) rows,
negative / non-finite sales, per-series calendar gap ratio, short and
constant series.  ``IngestTask`` runs it by default and logs the issues
(warn-only; ``validate_strict: true`` turns issues into a hard failure).
The report's fields and issues are the reference's.

Every report also publishes the ``dftpu_data_quality_*`` gauge family (the
reference's names and help texts), which the scorer appends to its
``GET /metrics`` once a report has run in its process, so a feed that
degrades between retrains shows on the same scrape as serving latency.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List

import numpy as np
import pandas as pd

from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry


@dataclasses.dataclass
class QualityReport:
    n_rows: int
    n_series: int
    date_min: str
    date_max: str
    n_duplicate_rows: int      # extra rows beyond one per (store, item, date)
    n_negative_sales: int
    n_nonfinite_sales: int
    n_short_series: int        # fewer than min_days observed
    n_constant_series: int     # zero variance over observed days
    gap_ratio: float           # missing (series, day) cells / span cells
    issues: List[str]

    @property
    def ok(self) -> bool:
        return not self.issues

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# metrics: one module-level registry, last-report-wins gauges


_METRICS = MetricsRegistry()
_G_ROWS = _METRICS.gauge(
    "dftpu_data_quality_rows", "rows in the last quality-checked feed")
_G_SERIES = _METRICS.gauge(
    "dftpu_data_quality_series", "series in the last quality-checked feed")
_G_DUP = _METRICS.gauge(
    "dftpu_data_quality_duplicate_rows",
    "duplicate (store, item, date) rows in the last feed")
_G_NEG = _METRICS.gauge(
    "dftpu_data_quality_negative_sales",
    "negative sales values in the last feed")
_G_NONFIN = _METRICS.gauge(
    "dftpu_data_quality_nonfinite_sales",
    "non-finite sales values in the last feed")
_G_SHORT = _METRICS.gauge(
    "dftpu_data_quality_short_series",
    "series under min_days observed periods in the last feed")
_G_CONST = _METRICS.gauge(
    "dftpu_data_quality_constant_series",
    "zero-variance series in the last feed")
_G_GAP = _METRICS.gauge(
    "dftpu_data_quality_gap_ratio",
    "missing (series, day) cells / span cells in the last feed")
_G_ISSUES = _METRICS.gauge(
    "dftpu_data_quality_issues",
    "issue count from the last quality report (0 == clean feed)")
_C_REPORTS = _METRICS.counter(
    "dftpu_data_quality_reports_total", "quality reports computed")

_published = False
_publish_lock = threading.Lock()


def _publish(report: QualityReport) -> None:
    global _published
    _G_ROWS.set(report.n_rows)
    _G_SERIES.set(report.n_series)
    _G_DUP.set(report.n_duplicate_rows)
    _G_NEG.set(report.n_negative_sales)
    _G_NONFIN.set(report.n_nonfinite_sales)
    _G_SHORT.set(report.n_short_series)
    _G_CONST.set(report.n_constant_series)
    _G_GAP.set(report.gap_ratio)
    _G_ISSUES.set(len(report.issues))
    _C_REPORTS.inc()
    with _publish_lock:
        _published = True


def render_data_quality_metrics() -> str:
    """Prometheus text for the ``dftpu_data_quality_*`` family, or the
    empty string when no report has run in this process — a serving node
    that never ingested should not advertise an all-zero "clean feed"."""
    with _publish_lock:
        if not _published:
            return ""
    return _METRICS.render_prometheus()


def data_quality_snapshot() -> dict:
    """JSON-friendly view of the gauge family (tests, in-process use)."""
    return _METRICS.snapshot()


def quality_report(
    df: pd.DataFrame,
    min_days: int = 60,
    max_gap_ratio: float = 0.5,
    freq: str = "D",
) -> QualityReport:
    """Vectorized quality pre-pass over the ``(date, store, item, sales)``
    long frame; ONE normalized snapshot, ONE grouped aggregation pass.

    ``freq`` matches the cadence the feed will be tensorized at: a weekly
    feed checked at daily precision would false-alarm a 6/7 "gap ratio"
    and miss same-week duplicates.  ``min_days`` counts PERIODS of that
    cadence.
    """
    # normalize to the tensorize grid first: tensorize buckets timestamps
    # to freq periods and SUMS same-period rows, so an intraday feed
    # ('08:00' and '20:00' rows) is a duplicate incident even though the
    # raw timestamps differ — checking at raw precision would miss
    # exactly that class
    if freq == "D":
        dates = pd.to_datetime(df["date"]).dt.normalize()
    else:
        dates = pd.PeriodIndex(
            pd.to_datetime(df["date"]), freq=freq
        ).to_timestamp()
        dates = pd.Series(dates, index=df.index)
    sales = df["sales"].to_numpy(dtype=float)

    if len(df) == 0:
        # a 0-row feed is the broken-export case strict mode exists for
        report = QualityReport(
            n_rows=0, n_series=0, date_min="", date_max="",
            n_duplicate_rows=0, n_negative_sales=0, n_nonfinite_sales=0,
            n_short_series=0, n_constant_series=0, gap_ratio=0.0,
            issues=["empty feed: 0 rows"],
        )
        _publish(report)
        return report

    # one snapshot frame (normalized dates assigned exactly once), then a
    # single .agg pass over a single groupby — the previous shape built
    # the assigned frame twice and walked the grouped frame five separate
    # times (size, min, max, nunique, std)
    snap = df.assign(_d=dates)
    n_dup = int(snap.duplicated(subset=["store", "item", "_d"]).sum())
    n_neg = int((sales < 0).sum())
    n_nonfin = int((~np.isfinite(sales)).sum())

    per_series = snap.groupby(["store", "item"], observed=True).agg(
        n_obs=("_d", "size"),
        d_min=("_d", "min"),
        d_max=("_d", "max"),
        n_periods=("_d", "nunique"),
        sales_std=("sales", "std"),
    )
    n_series = int(len(per_series))

    step_days = {"D": 1, "W": 7}.get(freq)
    if step_days is not None:
        span_days = (
            (per_series["d_max"] - per_series["d_min"]).dt.days
            // step_days + 1
        )
    else:  # monthly periods: count via period arithmetic
        span_days = (
            (per_series["d_max"].dt.to_period(freq)
             - per_series["d_min"].dt.to_period(freq)).apply(
                 lambda o: o.n) + 1
        )
    observed = per_series["n_periods"]
    gap_cells = (span_days - observed).clip(lower=0)
    gap_ratio = float(gap_cells.sum() / max(int(span_days.sum()), 1))

    n_short = int((observed < min_days).sum())
    # std() is NaN for single-observation groups — one data point is no
    # evidence of constancy (newly-launched SKUs), so require >= 2
    n_const = int(
        ((per_series["sales_std"] <= 0.0) & (per_series["n_obs"] >= 2)).sum()
    )

    issues = []
    if n_dup:
        issues.append(
            f"{n_dup} duplicate (store, item, date) rows — tensorize SUMS "
            f"them; aggregate upstream if that is not the intent"
        )
    if n_neg:
        issues.append(f"{n_neg} negative sales values")
    if n_nonfin:
        issues.append(f"{n_nonfin} non-finite sales values")
    if n_short:
        issues.append(
            f"{n_short}/{n_series} series have under {min_days} observed "
            f"days (fail-safe fallback will own them)"
        )
    if gap_ratio > max_gap_ratio:
        issues.append(
            f"calendar gap ratio {gap_ratio:.2f} exceeds {max_gap_ratio} — "
            f"most of the grid is unobserved; check the feed's date coverage"
        )
    if n_const:
        issues.append(
            f"{n_const}/{n_series} series are constant over their observed "
            f"days (dead SKUs or a frozen upstream column)"
        )
    report = QualityReport(
        n_rows=int(len(df)),
        n_series=n_series,
        date_min=str(dates.min().date()),
        date_max=str(dates.max().date()),
        n_duplicate_rows=n_dup,
        n_negative_sales=n_neg,
        n_nonfinite_sales=n_nonfin,
        n_short_series=n_short,
        n_constant_series=n_const,
        gap_ratio=round(gap_ratio, 4),
        issues=issues,
    )
    _publish(report)
    return report
