"""Serving for span-bucketed fits: one BatchForecaster per bucket (port of
the reference's ``serving/bucketed.py``).

The companion of ``engine.fit_forecast_bucketed``: the buckets partition
the series keys, each keeps its own predictor on its trimmed grid, and a
request is routed to the buckets owning its keys — one batched predict per
bucket present in the request, never one per series.  The artifact has the
reference's layout (``buckets.json`` and a ``bucket_<j>/`` forecaster
directory a bucket), so it loads in either package.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.models import get_model
from distributed_forecasting_tpu_torch.serving.predictor import (
    BatchForecaster,
    UnknownSeriesError,
    _bucket_ladder,
    quantile_columns,
)

_META_FILE = "buckets.json"


class BucketedForecaster:
    def __init__(self, forecasters: List[BatchForecaster]):
        if not forecasters:
            raise ValueError("need at least one bucket forecaster")
        self.forecasters = list(forecasters)
        self.key_names = self.forecasters[0].key_names
        # host-side key -> bucket routing table; buckets partition the keys
        self._route = {}
        for j, fc in enumerate(self.forecasters):
            for row in np.asarray(fc.keys):
                k = tuple(int(v) for v in row)
                if k in self._route:
                    raise ValueError(f"series key {k} appears in two buckets")
                self._route[k] = j

    @classmethod
    def from_bucketed_fit(cls, buckets, model: str, config=None
                          ) -> "BucketedForecaster":
        """Build from ``engine.fit_forecast_bucketed``'s ``buckets``
        (``(indices, sub_batch, params)``): each predictor takes its
        sub-batch's trimmed grid, not the global one."""
        if config is None:
            config = get_model(model).config_cls()
        return cls([BatchForecaster.from_fit(sub, params, model, config)
                    for _, sub, params in buckets])

    @property
    def n_series(self) -> int:
        return len(self._route)

    @property
    def model(self) -> str:
        """Every bucket holds the one family of the fit."""
        return self.forecasters[0].model

    @property
    def family(self) -> str:
        return self.model

    @property
    def serving_schema(self) -> str:
        return self.forecasters[0].serving_schema

    # -- persistence --------------------------------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for j, fc in enumerate(self.forecasters):
            fc.save(os.path.join(directory, f"bucket_{j}"))
        with open(os.path.join(directory, _META_FILE), "w") as f:
            json.dump({"n_buckets": len(self.forecasters)}, f)

    @classmethod
    def load(cls, directory: str, device=None) -> "BucketedForecaster":
        """Load an artifact directory (written by this package or by the
        reference) onto ``device`` (``cuda`` unless the caller asks for
        the CPU)."""
        with open(os.path.join(directory, _META_FILE)) as f:
            meta = json.load(f)
        return cls([
            BatchForecaster.load(os.path.join(directory, f"bucket_{j}"),
                                 device=device)
            for j in range(meta["n_buckets"])
        ])

    # -- inference ----------------------------------------------------------
    def _route_request(self, request: pd.DataFrame, on_missing: str, xreg):
        """Validate the request and the xreg's shape, and map its keys to
        buckets: ``{bucket index: [key tuples]}``.

        ``xreg``: a shared (T, R) calendar over the union grid ``min(bucket
        day0) .. day1 + horizon`` for buckets fit with ``n_regressors > 0``.
        Per-series regressors have no global row order across buckets:
        serve them through the per-bucket ``BatchForecaster`` objects."""
        if xreg is not None and torch.as_tensor(xreg).dim() != 2:
            raise ValueError(
                "BucketedForecaster accepts only a shared (T, R) xreg "
                "calendar; for per-series regressors predict through the "
                "per-bucket BatchForecaster objects"
            )
        if on_missing not in ("raise", "skip"):
            raise ValueError(
                f"on_missing must be 'raise' or 'skip', got {on_missing!r}"
            )
        names = list(self.key_names)
        missing_cols = [c for c in names if c not in request.columns]
        if missing_cols:
            raise KeyError(f"request lacks key column(s) {missing_cols}")
        req_keys = [tuple(int(v) for v in row)
                    for row in request[names].itertuples(index=False)]
        unknown = sorted(set(k for k in req_keys if k not in self._route))
        if unknown and on_missing == "raise":
            raise UnknownSeriesError(
                f"{len(unknown)} requested series not in any bucket "
                f"(first: {unknown[:3]})"
            )
        per_bucket = {}
        for k in req_keys:
            j = self._route.get(k)
            if j is not None:
                per_bucket.setdefault(j, []).append(k)
        return per_bucket

    def _bucket_xreg(self, fc: BatchForecaster, xreg, horizon: int):
        """The union-grid calendar sliced down to one bucket's window."""
        if xreg is None:
            return None
        d0_union = min(f.day0 for f in self.forecasters)
        xr = torch.as_tensor(xreg, dtype=torch.float32)
        T_need = fc.day1 + horizon - d0_union + 1
        # exactly that length: a longer calendar would be sliced from the
        # wrong origin and serve time-shifted covariates
        if xr.shape[0] != T_need:
            raise ValueError(
                f"xreg covers {xr.shape[0]} days, expected exactly the "
                f"union grid of {T_need} days "
                f"(min bucket day0 .. last day + horizon)"
            )
        return xr[fc.day0 - d0_union: fc.day1 + horizon - d0_union + 1]

    def warmup(self, horizon: int = 90, sizes=(1,)) -> int:
        """Warm every bucket's predict (``BatchForecaster.warmup``) over the
        whole request ladder up to the largest size: a request splits
        across buckets into any smaller sub-request."""
        return sum(fc.warmup(horizon=horizon, sizes=_bucket_ladder(sizes))
                   for fc in self.forecasters)

    def _per_bucket(self, request, on_missing, xreg, horizon, call):
        per_bucket = self._route_request(request, on_missing, xreg)
        names = list(self.key_names)
        return [call(self.forecasters[j],
                     pd.DataFrame(per_bucket[j], columns=names),
                     self._bucket_xreg(self.forecasters[j], xreg, horizon))
                for j in sorted(per_bucket)]

    def predict(self, request: pd.DataFrame, horizon: int = 90,
                include_history: bool = False, on_missing: str = "raise",
                xreg=None) -> pd.DataFrame:
        """One batched predict per bucket present in the request (see
        ``_route_request`` for the xreg calendar)."""
        parts = self._per_bucket(
            request, on_missing, xreg, horizon,
            lambda fc, req, xr: fc.predict(
                req, horizon=horizon, include_history=include_history,
                xreg=xr))
        if not parts:
            return pd.DataFrame(columns=["ds", *self.key_names, "yhat",
                                         "yhat_upper", "yhat_lower"])
        return pd.concat(parts, ignore_index=True)

    def predict_quantiles(self, request: pd.DataFrame,
                          quantiles=(0.1, 0.5, 0.9), horizon: int = 90,
                          include_history: bool = False,
                          on_missing: str = "raise",
                          xreg=None) -> pd.DataFrame:
        """Per-bucket quantile forecasts (routing and xreg as
        :meth:`predict`)."""
        parts = self._per_bucket(
            request, on_missing, xreg, horizon,
            lambda fc, req, xr: fc.predict_quantiles(
                req, quantiles=quantiles, horizon=horizon,
                include_history=include_history, xreg=xr))
        if not parts:
            return pd.DataFrame(columns=["ds", *self.key_names,
                                         *quantile_columns(quantiles)])
        return pd.concat(parts, ignore_index=True)
