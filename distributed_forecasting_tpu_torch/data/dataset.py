"""Dataset ingestion + synthetic data generation (port of the reference's
``data/dataset.py``).

:func:`load_sales_csv` and :func:`load_sales_parquet` read the ``(date,
store, item, sales)`` long format, the CSV through the native C++ parser
(``data/native.py``) where it is available;
:func:`synthetic_store_item_sales` generates a Kaggle-store-item-demand-shaped
table with known structure (piecewise-linear trend, weekly + yearly
multiplicative seasonality, lognormal noise) from a numpy seed — the same
numbers the reference generates from the same seed.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.utils.device import resolve_device


def _coerce_sales_frame(df: pd.DataFrame) -> pd.DataFrame:
    missing = {"date", "store", "item", "sales"} - set(df.columns)
    if missing:
        raise ValueError(f"sales table missing columns: {sorted(missing)}")
    out = df[["date", "store", "item", "sales"]].copy()
    out["date"] = pd.to_datetime(out["date"])
    out["store"] = out["store"].astype(np.int64)
    out["item"] = out["item"].astype(np.int64)
    out["sales"] = out["sales"].astype(np.float64)
    return out


def load_sales_csv(path: str) -> pd.DataFrame:
    """Read the ``train.csv`` long format.

    The native C++ parser does the parse when the library is available and
    the header names the columns in its positional order; else pandas.  A
    ``.csv.gz`` file is decompressed to a temporary file so the native
    parser still parses it (pandas reads gz itself on its path).  A file
    the native parser calls malformed goes to pandas.
    """
    from distributed_forecasting_tpu_torch.data import native

    if path.endswith(".gz") and native.is_available():
        import gzip
        import shutil
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".csv", delete=False) as tmp:
            try:
                with gzip.open(path, "rb") as src:
                    shutil.copyfileobj(src, tmp)
                tmp.close()
                return load_sales_csv(tmp.name)
            finally:
                os.unlink(tmp.name)

    if native.is_available() and _native_csv_layout_ok(path):
        try:
            day, store, item, sales = native.parse_sales_csv(path)
        except (ValueError, IOError):
            return _coerce_sales_frame(pd.read_csv(path))
        return pd.DataFrame(
            {
                "date": (np.datetime64("1970-01-01", "D")
                         + day.astype("timedelta64[D]")),
                "store": store,
                "item": item,
                "sales": sales,
            }
        )
    return _coerce_sales_frame(pd.read_csv(path))


def _native_csv_layout_ok(path: str) -> bool:
    """The C parser is positional (date, store, item, sales) where pandas
    selects by name: hand it a file only when the header states exactly
    that order, or there is no header — a reordering such as date, item,
    store, sales would parse with the keys silently swapped."""
    try:
        with open(path, "r") as f:
            first = f.readline().strip().lstrip("\ufeff")
    except OSError:
        return False
    cols = [c.strip().strip('"').lower() for c in first.split(",")]
    if cols and cols[0] and not any(ch.isalpha() for ch in "".join(cols)):
        return True  # headerless numeric/date first row: positional by spec
    return cols == ["date", "store", "item", "sales"]


def load_sales_parquet(path: str) -> pd.DataFrame:
    return _coerce_sales_frame(pd.read_parquet(path))


def synthetic_store_item_sales(
    n_stores: int = 10,
    n_items: int = 50,
    n_days: int = 1826,
    start: str = "2013-01-01",
    seed: int = 0,
    missing_rate: float = 0.0,
) -> pd.DataFrame:
    """Synthetic (date, store, item, sales) long table with known structure:
    ``sales = trend(t) * weekly(t) * yearly(t) * lognormal noise`` with a
    per-series changepoint in the trend.  ``missing_rate`` drops that share
    of rows (seeded), leaving gaps the mask records."""
    dates, sales = _synthetic_sales_matrix(n_stores, n_items, n_days, start, seed)
    S = n_stores * n_items
    stores = np.repeat(np.arange(1, n_stores + 1), n_items)
    items = np.tile(np.arange(1, n_items + 1), n_stores)
    df = pd.DataFrame(
        {
            "date": np.tile(dates.values, S),
            "store": np.repeat(stores, n_days),
            "item": np.repeat(items, n_days),
            "sales": np.round(sales.reshape(-1), 2),
        }
    )
    if missing_rate > 0.0:
        rng = np.random.default_rng(seed + 1)
        keep = rng.random(len(df)) >= missing_rate
        df = df[keep].reset_index(drop=True)
    return df


def _synthetic_sales_matrix(n_stores, n_items, n_days, start, seed):
    """Dense (S, n_days) sales matrix shared by the long-table and direct
    tensor generators."""
    rng = np.random.default_rng(seed)
    dates = pd.date_range(start, periods=n_days, freq="D")
    t = np.arange(n_days, dtype=np.float64)
    dow = dates.dayofweek.values
    doy = dates.dayofyear.values

    S = n_stores * n_items
    base = rng.uniform(15.0, 80.0, size=S)
    slope = rng.uniform(-0.004, 0.015, size=S) * base
    cp_pos = rng.integers(int(0.2 * n_days), int(0.8 * n_days), size=S)
    cp_delta = rng.uniform(-0.01, 0.01, size=S) * base

    wk_amp = rng.uniform(0.05, 0.30, size=S)
    wk_phase = rng.uniform(0, 2 * np.pi, size=S)
    weekly = 1.0 + wk_amp[:, None] * np.sin(
        2 * np.pi * dow[None, :] / 7.0 + wk_phase[:, None]
    )
    yr_amp = rng.uniform(0.1, 0.4, size=S)
    yr_phase = rng.uniform(0, 2 * np.pi, size=S)
    yearly = (
        1.0
        + yr_amp[:, None] * np.sin(2 * np.pi * doy[None, :] / 365.25 + yr_phase[:, None])
        + 0.3 * yr_amp[:, None] * np.sin(4 * np.pi * doy[None, :] / 365.25)
    )

    trend = (
        base[:, None]
        + slope[:, None] * t[None, :] / n_days
        + cp_delta[:, None] * np.maximum(0.0, t[None, :] - cp_pos[:, None]) / n_days
    )
    noise = rng.lognormal(mean=0.0, sigma=0.08, size=(S, n_days))
    sales = np.maximum(trend * weekly * yearly * noise, 0.0)
    return dates, sales


def synthetic_series_batch(
    n_stores: int = 10,
    n_items: int = 50,
    n_days: int = 1826,
    start: str = "2013-01-01",
    seed: int = 0,
    device=None,
) -> SeriesBatch:
    """The synthetic workload built directly as a :class:`SeriesBatch` on
    ``device`` — no intermediate long table."""
    dev = resolve_device(device)
    dates, sales = _synthetic_sales_matrix(n_stores, n_items, n_days, start, seed)
    stores = np.repeat(np.arange(1, n_stores + 1), n_items)
    items = np.tile(np.arange(1, n_items + 1), n_stores)
    d0 = int((dates.values[0].astype("datetime64[D]")
              - np.datetime64("1970-01-01", "D")).astype(np.int64))
    y = torch.from_numpy(sales.astype(np.float32)).to(dev)
    return SeriesBatch(
        y=y,
        mask=torch.ones_like(y),
        day=torch.arange(d0, d0 + n_days, dtype=torch.int32, device=dev),
        keys=np.stack([stores, items], axis=1).astype(np.int64),
        key_names=("store", "item"),
        start_date=str(dates[0].date()),
    )
