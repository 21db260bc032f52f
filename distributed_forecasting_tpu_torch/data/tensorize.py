"""Group-and-pad: long-format sales rows -> one dense ``(n_series, T)`` tensor.

Port of the reference's numpy tensorize path.  Every series is aligned onto
one shared date grid and stacked into a float tensor plus a validity mask:
missing days and ragged starts/ends become mask zeros, never shape changes.
Series keys stay on the host in numpy; the card sees only dense tensors.

(The reference's C++ group-and-scatter path produces bit-identical batches
and is not ported yet; this is the numpy path.)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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


def tensorize(
    df: pd.DataFrame,
    key_cols: Sequence[str] = ("store", "item"),
    date_col: str = "date",
    value_col: str = "sales",
    freq: str = "D",
    device=None,
) -> SeriesBatch:
    """Long table ``(date, *keys, value)`` -> :class:`SeriesBatch` on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    Duplicate (key, date) rows are summed (SQL ``GROUP BY`` semantics); keys
    come out lexicographically sorted.  Values accumulate in float64 on the
    host and are rounded once to float32, as the reference does.
    """
    dev = resolve_device(device)
    df = df[[date_col, *key_cols, value_col]]
    day = period_ordinals(df[date_col], freq)
    d0, d1 = int(day.min()), int(day.max())
    T = d1 - d0 + 1

    keys = df[list(key_cols)].astype(np.int64).values
    vals = df[value_col].to_numpy(dtype=np.float64)
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
