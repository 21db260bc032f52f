"""Group-and-pad: long-format sales rows -> one dense ``(n_series, T)`` tensor.

Port of the reference's ``data/tensorize.py``.  Every series is aligned onto
one shared date grid and stacked into a float tensor plus a validity mask:
missing days and ragged starts/ends become mask zeros, never shape changes.
Series keys stay on the host in numpy; the card sees only dense tensors.

Two host data planes build the planes, with bit-identical results: the C++
group-and-scatter library (``data/native.py``, daily grids keyed by
(store, item)) and numpy.  ``bucket_by_span`` splits a ragged batch into
span buckets on trimmed grids; ``tensorize_regressors`` and
``regressors_for_grid`` align covariate rows onto a batch's or an
artifact's day grid.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SeriesBatch:
    """All series of a dataset as one padded dense batch.

    Tensors (on one device):
      y:    (S, T) float32  observed values, 0 where unobserved
      mask: (S, T) float32  1.0 where observed, 0.0 where padded/missing
      day:  (T,)   int32    absolute period ordinal (days since the Unix
            epoch for the daily cadence; week/month ordinals for W/M)

    Host metadata:
      keys:  (S, k) int64 numpy array of series keys (e.g. store, item)
      key_names: names of the key columns
      start_date: ISO date of day[0]'s period start
      freq: grid cadence — "D" (default), "W" or "M"
    """

    y: torch.Tensor
    mask: torch.Tensor
    day: torch.Tensor
    keys: np.ndarray
    key_names: tuple
    start_date: str
    freq: str = "D"

    @property
    def n_series(self) -> int:
        return self.y.shape[0]

    @property
    def n_time(self) -> int:
        return self.y.shape[1]

    def dates(self) -> pd.DatetimeIndex:
        """The shared date grid on the host (period-start timestamps for
        non-daily cadences)."""
        if self.freq == "D":
            return pd.date_range(self.start_date, periods=self.n_time, freq="D")
        return pd.period_range(
            self.start_date, periods=self.n_time, freq=self.freq
        ).to_timestamp()

    def key_frame(self) -> pd.DataFrame:
        return pd.DataFrame(np.asarray(self.keys), columns=list(self.key_names))

    def pad_series_to(self, n: int) -> "SeriesBatch":
        """Pad the series axis up to ``n`` with mask=0 rows (keys -1)."""
        s = self.n_series
        if n < s:
            raise ValueError(f"cannot pad {s} series down to {n}")
        if n == s:
            return self
        pad = self.y.new_zeros((n - s, self.n_time))
        keys = np.concatenate(
            [self.keys, np.full((n - s, self.keys.shape[1]), -1, self.keys.dtype)]
        )
        return dataclasses.replace(
            self,
            y=torch.cat([self.y, pad]),
            mask=torch.cat([self.mask, pad]),
            keys=keys,
        )

    def take_series(self, idx: Sequence[int]) -> "SeriesBatch":
        idx = np.asarray(idx)
        rows = torch.as_tensor(idx, dtype=torch.long, device=self.y.device)
        return dataclasses.replace(
            self, y=self.y[rows], mask=self.mask[rows], keys=self.keys[idx]
        )


def _epoch_days(dates) -> np.ndarray:
    """Date-like column -> int64 days since the Unix epoch."""
    d = pd.to_datetime(dates)
    return (
        d.values.astype("datetime64[D]") - np.datetime64("1970-01-01", "D")
    ).astype(np.int64)


VALID_FREQS = ("D", "W", "M")


def period_ordinals(dates, freq: str = "D") -> np.ndarray:
    """Date-like column -> int64 pandas Period ordinals at ``freq`` ("D" is
    days since the epoch; "W"/"M" map every date to its period's ordinal,
    so a daily feed tensorized at a coarser freq sums into period buckets)."""
    if freq == "D":
        return _epoch_days(dates)
    if freq not in VALID_FREQS:
        raise ValueError(f"unknown freq {freq!r}; valid: {VALID_FREQS}")
    return pd.PeriodIndex(pd.to_datetime(dates), freq=freq).asi8


def ordinals_to_dates(ordinals, freq: str = "D") -> pd.DatetimeIndex:
    """Absolute period ordinals -> period-start timestamps (the inverse
    every long output frame uses)."""
    arr = np.asarray(ordinals, dtype="int64")
    if freq == "D":
        return pd.to_datetime(arr, unit="D", origin="unix")
    if freq not in VALID_FREQS:
        raise ValueError(f"unknown freq {freq!r}; valid: {VALID_FREQS}")
    return pd.PeriodIndex.from_ordinals(arr, freq=freq).to_timestamp()


def bucket_by_span(batch: SeriesBatch, max_buckets: int = 4):
    """Split a ragged batch into span buckets with trimmed time grids.

    Series group by observed span (first observation to the grid's end)
    rounded up to a power of two and capped at T; the ``max_buckets``
    longest lengths are kept and the last bucket absorbs every series left.
    Each bucket's grid is trimmed to its length: the dropped leading region
    is fully masked, so no observation is lost.  Returns a list of
    ``(indices, sub_batch)`` with host indices into the series axis; the
    sub-batches slice the batch's device tensors.  Weekly and monthly grids
    take their origin from the trimmed grid's first period ordinal.
    """
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    mask_np = batch.mask.cpu().numpy() > 0
    day_np = batch.day.cpu().numpy()
    T = batch.n_time
    any_obs = mask_np.any(axis=1)
    first = np.where(any_obs, mask_np.argmax(axis=1), T - 1)
    span = T - first
    pow2 = np.minimum(
        np.power(2, np.ceil(np.log2(np.maximum(span, 1)))).astype(np.int64), T
    )
    lengths = sorted(set(pow2.tolist()))[-max_buckets:]
    buckets = []
    assigned = np.zeros(batch.n_series, dtype=bool)
    for L in lengths:
        sel = ~assigned if L == lengths[-1] else (pow2 <= L) & ~assigned
        idx = np.nonzero(sel)[0]
        if idx.size == 0:
            continue
        assigned[idx] = True
        rows = torch.as_tensor(idx, dtype=torch.long, device=batch.y.device)
        d0 = int(day_np[T - L])
        sub = dataclasses.replace(
            batch,
            y=batch.y[rows, T - L:],
            mask=batch.mask[rows, T - L:],
            day=batch.day[T - L:],
            keys=batch.keys[idx],
            start_date=str(
                pd.Period(ordinal=d0, freq=batch.freq).start_time.date()
            ),
        )
        buckets.append((idx, sub))
    return buckets


def resolved_backend(n_keys: int = 2, backend: str = "auto") -> str:
    """The tensorize data plane that will run: ``'native'`` or ``'pandas'``.

    ``'auto'`` (or the ``DFTPU_TENSORIZE_BACKEND`` environment override)
    picks native when the library loads and the keys are the two (store,
    item) columns its C ABI takes.  An explicit ``'native'`` that cannot be
    honoured raises.  The training pipeline logs this resolution as the
    ``tensorize_backend`` run param.
    """
    if backend == "auto":
        backend = os.environ.get("DFTPU_TENSORIZE_BACKEND", "auto")
    if backend not in ("auto", "native", "pandas"):
        raise ValueError(f"unknown tensorize backend {backend!r}")
    if backend == "pandas":
        return "pandas"
    from distributed_forecasting_tpu_torch.data import native

    supported = n_keys == 2
    available = native.is_available()
    if backend == "native":
        if not supported:
            raise RuntimeError(
                f"tensorize backend 'native' requested but the native data "
                f"plane supports 2 key columns, got {n_keys}"
            )
        if not available:
            raise RuntimeError(
                "tensorize backend 'native' requested but the native library "
                "is unavailable (no loadable .so and no compiler)"
            )
        return "native"
    return "native" if (supported and available) else "pandas"


def tensorize(
    df: pd.DataFrame,
    key_cols: Sequence[str] = ("store", "item"),
    date_col: str = "date",
    value_col: str = "sales",
    backend: str = "auto",
    freq: str = "D",
    device=None,
) -> SeriesBatch:
    """Long table ``(date, *keys, value)`` -> :class:`SeriesBatch` on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    Duplicate (key, date) rows are summed (SQL ``GROUP BY`` semantics); keys
    come out lexicographically sorted.  Values accumulate in float64 on the
    host and are rounded once to float32, as the reference does.
    ``backend``: ``'native'`` (the C++ group and scatter, daily grids
    only), ``'pandas'`` (numpy) or ``'auto'`` (see :func:`resolved_backend`);
    both planes give bit-identical batches.
    """
    dev = resolve_device(device)
    df = df[[date_col, *key_cols, value_col]]
    day = period_ordinals(df[date_col], freq)
    d0, d1 = int(day.min()), int(day.max())
    T = d1 - d0 + 1

    keys = df[list(key_cols)].astype(np.int64).values
    vals = df[value_col].to_numpy(dtype=np.float64)

    # the C++ path speaks epoch days only
    if backend == "native" and freq != "D":
        raise ValueError(
            f"backend='native' supports freq='D' only (the C++ path speaks "
            f"epoch-days); freq={freq!r} uses the numpy path"
        )
    if freq == "D" and resolved_backend(
            n_keys=len(key_cols), backend=backend) == "native":
        from distributed_forecasting_tpu_torch.data import native

        y32, m, day_grid, uniq = native.tensorize_arrays(
            day.astype(np.int32), keys[:, 0], keys[:, 1], vals)
        return SeriesBatch(
            y=torch.from_numpy(y32).to(dev),
            mask=torch.from_numpy(m).to(dev),
            day=torch.from_numpy(day_grid).to(dev),
            keys=uniq,
            key_names=tuple(key_cols),
            start_date=str(np.datetime64(d0, "D")),
        )

    uniq, series_idx = np.unique(keys, axis=0, return_inverse=True)
    series_idx = series_idx.reshape(-1)
    S = uniq.shape[0]

    y = np.zeros((S, T), dtype=np.float64)
    m = np.zeros((S, T), dtype=np.float32)
    tpos = (day - d0).astype(np.int64)
    np.add.at(y, (series_idx, tpos), vals)
    m[series_idx, tpos] = 1.0

    if freq == "D":
        start_date = str(np.datetime64(d0, "D"))
    else:
        start_date = str(pd.Period(ordinal=d0, freq=freq).start_time.date())
    return SeriesBatch(
        y=torch.from_numpy(y.astype(np.float32)).to(dev),
        mask=torch.from_numpy(m).to(dev),
        day=torch.arange(d0, d1 + 1, dtype=torch.int32, device=dev),
        keys=uniq,
        key_names=tuple(key_cols),
        start_date=start_date,
        freq=freq,
    )


def _fill_time(a: np.ndarray) -> np.ndarray:
    """Forward- then back-fill NaNs along the time axis (-2), rest -> 0."""
    shp = a.shape
    T = shp[-2]
    flat = np.moveaxis(a, -2, -1).reshape(-1, T)  # (N, T)
    filled = (
        pd.DataFrame(flat).ffill(axis=1).bfill(axis=1).fillna(0.0).to_numpy()
    )
    out = filled.reshape(*shp[:-2], shp[-1], T)
    return np.moveaxis(out, -1, -2)


def tensorize_regressors(
    df: pd.DataFrame,
    batch: SeriesBatch,
    regressor_cols: Sequence[str],
    date_col: str = "date",
    horizon: int = 0,
    per_series: bool = False,
) -> torch.Tensor:
    """Long-format covariate rows -> a float32 regressor tensor on the
    batch's day grid extended by ``horizon`` future days, on the batch's
    device: ``(T + horizon, R)`` from a calendar shared by all series (one
    row per date), or ``(S, T + horizon, R)`` with ``per_series=True`` (the
    frame also carries the batch's key columns; unknown keys are ignored).
    The result feeds ``fit_forecast(..., xreg=...)`` directly.  Missing days
    are forward- then back-filled along time (a price stays in force until
    changed); a regressor never observed for a series fills 0.
    """
    if batch.freq != "D":
        raise ValueError(
            "regressor tensorization resolves on a daily calendar grid; "
            f"the batch's cadence is {batch.freq!r} — regressors require "
            "freq='D'"
        )
    return regressors_for_grid(
        df,
        day0=int(batch.day[0]),
        n_days=batch.n_time + horizon,
        regressor_cols=regressor_cols,
        date_col=date_col,
        per_series=per_series,
        keys=batch.keys,
        key_names=batch.key_names,
        device=batch.y.device,
    )


def regressors_for_grid(
    df: pd.DataFrame,
    day0: int,
    n_days: int,
    regressor_cols: Sequence[str],
    date_col: str = "date",
    per_series: bool = False,
    keys: Optional[np.ndarray] = None,
    key_names: Sequence[str] = (),
    device=None,
) -> torch.Tensor:
    """:func:`tensorize_regressors` on an explicit day grid of ``n_days``
    epoch days from ``day0``, on ``device`` (``cuda`` unless the caller
    asks for the CPU).  The serving-side variant: at inference there is only
    the artifact's grid (``day0 .. day1 + horizon``) and key table.
    ``keys``/``key_names`` are required for ``per_series=True`` (rows follow
    the artifact's series order).  Duplicate dates (shared) or duplicate
    (key, date) rows (per series) raise.
    """
    dev = resolve_device(device)
    regressor_cols = list(regressor_cols)
    R = len(regressor_cols)
    if R == 0:
        raise ValueError("regressor_cols is empty")
    day = _epoch_days(df[date_col])
    tpos = day - day0
    in_grid = (tpos >= 0) & (tpos < n_days)
    vals = df[regressor_cols].to_numpy(dtype=np.float64)

    if not per_series:
        # a shared calendar has one row per date: a last-row-wins scatter of
        # a per-series frame would silently corrupt it
        uniq_days = np.unique(tpos[in_grid])
        if uniq_days.size < int(in_grid.sum()):
            raise ValueError(
                "duplicate dates in the regressor frame — a shared calendar "
                "has one row per date; for per-(store,item) covariates pass "
                "per_series=True with the key columns present"
            )
        arr = np.full((n_days, R), np.nan)
        arr[tpos[in_grid]] = vals[in_grid]
        return torch.from_numpy(_fill_time(arr).astype(np.float32)).to(dev)

    if keys is None or not len(key_names):
        raise ValueError("per_series=True needs the keys/key_names tables")
    keys = np.asarray(keys)
    key_df = df[list(key_names)].astype(np.int64)
    index = {tuple(k): i for i, k in enumerate(keys.tolist())}
    rows = np.array(
        [index.get(tuple(k), -1) for k in key_df.values.tolist()], dtype=np.int64
    )
    keep = in_grid & (rows >= 0)
    slots = rows[keep] * np.int64(n_days) + tpos[keep]
    if np.unique(slots).size < slots.size:
        raise ValueError(
            "duplicate (key, date) rows in the regressor frame — one row "
            "per series per date; aggregate duplicates before tensorizing"
        )
    arr = np.full((keys.shape[0], n_days, R), np.nan)
    arr[rows[keep], tpos[keep]] = vals[keep]
    return torch.from_numpy(_fill_time(arr).astype(np.float32)).to(dev)
