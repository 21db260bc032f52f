"""Exploratory aggregations over the raw sales table (port of the
reference's ``data/eda.py``).

Library versions of the reference's SQL EDA cells (``notebooks/prophet/
02_training.py:52-108``): yearly sales trend, month-of-year seasonality,
weekday seasonality (computed per year to show stability), and the dataset
stats summary (distinct items/stores, date range, row count).  All pure
pandas on the long table — EDA belongs on the host, not the card.
"""

from __future__ import annotations

from typing import Dict

import pandas as pd


def yearly_trend(df: pd.DataFrame) -> pd.DataFrame:
    """Total sales per year — the long-horizon growth view."""
    out = (
        df.assign(year=df["date"].dt.year)
        .groupby("year", as_index=False)["sales"].sum()
    )
    return out


def monthly_trend(df: pd.DataFrame) -> pd.DataFrame:
    """Total sales per calendar month (yyyy-mm) — trend + yearly seasonality."""
    month = df["date"].dt.to_period("M").dt.start_time
    return (
        df.assign(month=month).groupby("month", as_index=False)["sales"].sum()
    )


def weekday_trend(df: pd.DataFrame) -> pd.DataFrame:
    """Mean daily sales per weekday, per year — weekly-profile stability.

    Matches the reference's per-year weekday breakdown (Sunday=0 in its SQL;
    here pandas' Monday=0 convention with a name column for clarity).
    """
    tmp = df.assign(
        year=df["date"].dt.year,
        weekday=df["date"].dt.dayofweek,
        weekday_name=df["date"].dt.day_name(),
    )
    daily = (
        tmp.groupby(["year", "weekday", "weekday_name", "date"],
                    as_index=False)["sales"].sum()
    )
    return (
        daily.groupby(["year", "weekday", "weekday_name"], as_index=False)["sales"]
        .mean()
        .rename(columns={"sales": "mean_daily_sales"})
    )


def dataset_stats(df: pd.DataFrame) -> Dict[str, object]:
    """Distinct stores/items, date span, row count, expected model count —
    the reference's pre-training sanity query (``02_training.py:101-108``)."""
    n_stores = int(df["store"].nunique())
    n_items = int(df["item"].nunique())
    return {
        "rows": int(len(df)),
        "n_stores": n_stores,
        "n_items": n_items,
        "n_series": int(df[["store", "item"]].drop_duplicates().shape[0]),
        "expected_models": n_stores * n_items,
        "start_date": str(df["date"].min().date()),
        "end_date": str(df["date"].max().date()),
        "days": int((df["date"].max() - df["date"].min()).days + 1),
    }
