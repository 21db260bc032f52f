"""Composite serving artifacts (port of the reference's
``serving/ensemble.py``), in the reference's directory layout so either
package loads them:

* :class:`MultiModelForecaster` (``ensemble.json``) serves each series from
  the family that won it in ``engine/select`` — one batched predict per
  family present in the request, never one per series;
* :class:`BlendedForecaster` (``blend.json``, ``blend_weights.npy``, an
  optional ``blend_interval_scale.npy``) serves the linear pool of
  ``engine/blend`` — every family predicts every requested series and the
  (S, F) weights combine them: point paths as the weighted mean, band
  half-widths linearly, quantile levels level-wise.

Each member is a :class:`BatchForecaster` in a subdirectory named after its
family.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import pandas as pd

from distributed_forecasting_tpu_torch.engine.blend import blend_band_floor
from distributed_forecasting_tpu_torch.models.base import (
    generator_kwargs,
    get_model,
)
from distributed_forecasting_tpu_torch.serving.predictor import (
    BatchForecaster,
    quantile_columns,
)

_META_FILE = "ensemble.json"


def _family_kwargs(name: str, xreg, generator=None) -> dict:
    """``xreg`` for a member whose family takes regressors, ``generator``
    for one whose forecast draws, else nothing."""
    fns = get_model(name)
    kw = generator_kwargs(fns, generator)
    if xreg is not None and fns.supports_xreg:
        kw["xreg"] = xreg
    return kw


class MultiModelForecaster:
    def __init__(self, forecasters: Dict[str, BatchForecaster],
                 assignment: np.ndarray):
        if not forecasters:
            raise ValueError("need at least one family forecaster")
        self.forecasters = dict(forecasters)
        self.models = tuple(sorted(self.forecasters))
        # every member was fit on one batch: one key table
        first = self.forecasters[self.models[0]]
        self.keys, self.key_names = first.keys, first.key_names
        self.assignment = np.asarray(assignment)
        if self.assignment.shape[0] != self.keys.shape[0]:
            raise ValueError(
                f"assignment covers {self.assignment.shape[0]} series, "
                f"params cover {self.keys.shape[0]}"
            )

    @classmethod
    def from_fit(cls, batch, params_by_family, configs, selection
                 ) -> "MultiModelForecaster":
        """Build from ``engine.fit_forecast_auto``'s outputs; ``configs``
        maps family -> config (a missing one is the family's default)."""
        fcs = {}
        for name, params in params_by_family.items():
            cfg = (configs or {}).get(name) or get_model(name).config_cls()
            fcs[name] = BatchForecaster.from_fit(batch, params, name, cfg)
        name_per_series = selection.chosen
        unknown = sorted(set(name_per_series) - set(fcs))
        if unknown:
            raise ValueError(
                f"selection assigns series to famil"
                f"{'ies' if len(unknown) > 1 else 'y'} {unknown} absent from "
                f"params_by_family (has {sorted(fcs)})"
            )
        # the assignment indexes the sorted family names, whatever order
        # the selection used
        order = {n: j for j, n in enumerate(sorted(fcs))}
        return cls(fcs, np.asarray([order[n] for n in name_per_series]))

    @property
    def family(self) -> str:
        return "auto:" + ",".join(self.models)

    @property
    def day0(self) -> int:
        return self.forecasters[self.models[0]].day0

    @property
    def day1(self) -> int:
        return self.forecasters[self.models[0]].day1

    @property
    def serving_schema(self) -> str:
        """The base schema plus the winning family's column."""
        return self.forecasters[self.models[0]].serving_schema + ", model string"

    @property
    def n_series(self) -> int:
        return int(self.keys.shape[0])

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for name, fc in self.forecasters.items():
            fc.save(os.path.join(directory, name))
        with open(os.path.join(directory, _META_FILE), "w") as f:
            json.dump({"models": list(self.models),
                       "assignment": self.assignment.tolist()}, f)

    @classmethod
    def load(cls, directory: str, device=None) -> "MultiModelForecaster":
        with open(os.path.join(directory, _META_FILE)) as f:
            meta = json.load(f)
        fcs = {name: BatchForecaster.load(os.path.join(directory, name),
                                          device=device)
               for name in meta["models"]}
        return cls(fcs, np.asarray(meta["assignment"]))

    def _parts(self, request, on_missing, columns, call):
        """One ``call(forecaster, request)`` per family present in the
        request, each frame tagged with its family."""
        first = self.forecasters[self.models[0]]
        sidx = first.series_indices(request, on_missing=on_missing)
        if sidx.size == 0:
            return pd.DataFrame(columns=["ds", *self.key_names, *columns,
                                         "model"])
        parts = []
        for j, name in enumerate(self.models):
            sub = sidx[self.assignment[sidx] == j]
            if sub.size == 0:
                continue
            req = pd.DataFrame(self.keys[sub], columns=list(self.key_names))
            out = call(name, req)
            out["model"] = name
            parts.append(out)
        return pd.concat(parts, ignore_index=True)

    def predict(self, request: pd.DataFrame, horizon: int = 90,
                include_history: bool = False, on_missing: str = "raise",
                xreg=None, generator=None) -> pd.DataFrame:
        """One batched predict per family present in the request.  ``xreg``
        goes to the families that take regressors (the curve model); it
        raises when no held family does."""
        if xreg is not None and not any(get_model(n).supports_xreg
                                        for n in self.models):
            raise ValueError(
                f"none of the held families {self.models} accepts "
                f"exogenous regressors"
            )
        return self._parts(
            request, on_missing, ["yhat", "yhat_upper", "yhat_lower"],
            lambda name, req: self.forecasters[name].predict(
                req, horizon=horizon, include_history=include_history,
                **_family_kwargs(name, xreg, generator)))

    def predict_quantiles(self, request: pd.DataFrame,
                          quantiles=(0.1, 0.5, 0.9), horizon: int = 90,
                          include_history: bool = False,
                          on_missing: str = "raise",
                          xreg=None, generator=None) -> pd.DataFrame:
        """Per-family quantile forecasts; every requested series' winning
        family must price quantiles."""

        def call(name, req):
            if get_model(name).forecast_quantiles is None:
                raise ValueError(
                    f"requested series are assigned to family {name!r}, "
                    f"which has no quantile forecast implementation"
                )
            return self.forecasters[name].predict_quantiles(
                req, quantiles=quantiles, horizon=horizon,
                include_history=include_history, on_missing=on_missing,
                **_family_kwargs(name, xreg, generator))

        return self._parts(request, on_missing, quantile_columns(quantiles),
                           call)


_BLEND_META_FILE = "blend.json"
_BLEND_WEIGHTS_FILE = "blend_weights.npy"
_BLEND_SCALE_FILE = "blend_interval_scale.npy"


class BlendedForecaster:
    """Linear-pool serving of ``engine.fit_forecast_blend``: F batched
    predicts per request, combined by the (S, F) weights."""

    def __init__(self, forecasters: Dict[str, BatchForecaster],
                 weights: np.ndarray, models: Optional[tuple] = None,
                 interval_scale: Optional[np.ndarray] = None):
        if not forecasters:
            raise ValueError("need at least one family forecaster")
        self.forecasters = dict(forecasters)
        # the weight COLUMNS follow this order, never re-sorted
        self.models = (tuple(models) if models is not None
                       else tuple(sorted(forecasters)))
        if set(self.models) != set(self.forecasters):
            raise ValueError(
                f"models order {self.models} does not cover forecasters "
                f"{sorted(self.forecasters)}"
            )
        # every member was fit on one batch: one key table
        first = self.forecasters[self.models[0]]
        self.keys, self.key_names = first.keys, first.key_names
        S = self.keys.shape[0]
        self.weights = np.asarray(weights, dtype=np.float32)
        if self.weights.shape != (S, len(self.models)):
            raise ValueError(
                f"weights must be ({S}, {len(self.models)}) — one row per "
                f"series, one column per family — got {self.weights.shape}"
            )
        # (S,) conformal scale of the POOLED band, applied after blending
        self.interval_scale = (None if interval_scale is None
                               else np.asarray(interval_scale, np.float32))
        if self.interval_scale is not None and (
                self.interval_scale.shape != (S,)):
            raise ValueError(
                f"interval_scale must be ({S},), got "
                f"{self.interval_scale.shape}"
            )

    @classmethod
    def from_fit(cls, batch, params_by_family, configs, blend
                 ) -> "BlendedForecaster":
        """Build from ``engine.fit_forecast_blend``'s outputs (params for
        every family of ``blend.models``, the weight columns' order)."""
        missing = sorted(set(blend.models) - set(params_by_family))
        if missing:
            raise ValueError(
                f"blend weights cover famil"
                f"{'ies' if len(missing) > 1 else 'y'} {missing} absent from "
                f"params_by_family"
            )
        fcs = {}
        for name in blend.models:
            cfg = (configs or {}).get(name) or get_model(name).config_cls()
            fcs[name] = BatchForecaster.from_fit(
                batch, params_by_family[name], name, cfg)
        return cls(fcs, blend.weights, models=blend.models,
                   interval_scale=blend.interval_scale)

    @property
    def family(self) -> str:
        return "blend:" + ",".join(self.models)

    @property
    def day0(self) -> int:
        return self.forecasters[self.models[0]].day0

    @property
    def day1(self) -> int:
        return self.forecasters[self.models[0]].day1

    @property
    def serving_schema(self) -> str:
        return self.forecasters[self.models[0]].serving_schema

    @property
    def n_series(self) -> int:
        return int(self.keys.shape[0])

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for name, fc in self.forecasters.items():
            fc.save(os.path.join(directory, name))
        np.save(os.path.join(directory, _BLEND_WEIGHTS_FILE), self.weights)
        scale_path = os.path.join(directory, _BLEND_SCALE_FILE)
        if self.interval_scale is not None:
            np.save(scale_path, self.interval_scale)
        elif os.path.exists(scale_path):
            os.remove(scale_path)  # a reused directory keeps no stale scale
        with open(os.path.join(directory, _BLEND_META_FILE), "w") as f:
            json.dump({"models": list(self.models)}, f)

    @classmethod
    def load(cls, directory: str, device=None) -> "BlendedForecaster":
        with open(os.path.join(directory, _BLEND_META_FILE)) as f:
            meta = json.load(f)
        fcs = {name: BatchForecaster.load(os.path.join(directory, name),
                                          device=device)
               for name in meta["models"]}
        weights = np.load(os.path.join(directory, _BLEND_WEIGHTS_FILE))
        scale_path = os.path.join(directory, _BLEND_SCALE_FILE)
        scale = np.load(scale_path) if os.path.exists(scale_path) else None
        return cls(fcs, weights, models=tuple(meta["models"]),
                   interval_scale=scale)

    def _pool(self, request, on_missing, columns, call):
        """Every family's frame for the requested series, combined by the
        weights: ``columns(part) -> {name: values}`` gives each family's
        weighted terms, summed over families.  Returns ``(sidx, frame,
        sums)``; the frame holds ds and the keys."""
        first = self.forecasters[self.models[0]]
        sidx = first.series_indices(request, on_missing=on_missing)
        if sidx.size == 0:
            return sidx, None, None
        req = pd.DataFrame(self.keys[sidx], columns=list(self.key_names))
        frame = sums = None
        for i, name in enumerate(self.models):
            part = call(name, req)
            # one request and one shared day grid: frames align row for row
            w = np.repeat(self.weights[sidx, i], len(part) // sidx.size)
            terms = {k: w * v for k, v in columns(part).items()}
            if frame is None:
                frame = part[["ds", *self.key_names]].copy()
                sums = terms
            else:
                sums = {k: sums[k] + v for k, v in terms.items()}
        return sidx, frame, sums

    def _scale(self, sidx, n_rows) -> np.ndarray:
        return np.repeat(self.interval_scale[sidx], n_rows // sidx.size)

    def predict(self, request: pd.DataFrame, horizon: int = 90,
                include_history: bool = False, on_missing: str = "raise",
                xreg=None, generator=None) -> pd.DataFrame:
        def columns(part):
            yh = part["yhat"].to_numpy()
            return {"yhat": yh, "up": part["yhat_upper"].to_numpy() - yh,
                    "dn": yh - part["yhat_lower"].to_numpy()}

        sidx, out, sums = self._pool(
            request, on_missing, columns,
            lambda name, req: self.forecasters[name].predict(
                req, horizon=horizon, include_history=include_history,
                **_family_kwargs(name, xreg, generator)))
        if out is None:
            return pd.DataFrame(columns=["ds", *self.key_names, "yhat",
                                         "yhat_upper", "yhat_lower"])
        yhat, up, dn = sums["yhat"], sums["up"], sums["dn"]
        if self.interval_scale is not None:
            sc = self._scale(sidx, len(out))
            up, dn = sc * up, sc * dn
            floor = blend_band_floor(self.models)
            if floor is not None:
                dn = np.minimum(dn, yhat - floor)
        out["yhat"] = yhat
        out["yhat_upper"] = yhat + up
        out["yhat_lower"] = yhat - dn
        return out

    def predict_quantiles(self, request: pd.DataFrame,
                          quantiles=(0.1, 0.5, 0.9), horizon: int = 90,
                          include_history: bool = False,
                          on_missing: str = "raise",
                          xreg=None, generator=None) -> pd.DataFrame:
        for name in self.models:
            if get_model(name).forecast_quantiles is None:
                raise ValueError(
                    f"family {name!r} has no quantile forecast implementation"
                )
        qcols = quantile_columns(quantiles)
        # conformal scaling spreads the levels around the pooled median, so
        # the median is priced alongside when calibration is on
        priced = tuple(quantiles)
        if self.interval_scale is not None and 0.5 not in priced:
            priced = tuple(sorted((*priced, 0.5)))
        pcols = quantile_columns(priced)
        sidx, out, sums = self._pool(
            request, on_missing,
            lambda part: {c: part[c].to_numpy() for c in pcols},
            lambda name, req: self.forecasters[name].predict_quantiles(
                req, quantiles=priced, horizon=horizon,
                include_history=include_history,
                **_family_kwargs(name, xreg, generator)))
        if out is None:
            return pd.DataFrame(columns=["ds", *self.key_names, *qcols])
        if self.interval_scale is not None:
            sc = self._scale(sidx, len(out))
            med = sums["q0.5"].copy()
            floor = blend_band_floor(self.models)
            for c in pcols:
                scaled = med + sc * (sums[c] - med)
                sums[c] = scaled if floor is None else np.maximum(scaled, floor)
        for c in qcols:
            out[c] = sums[c]
        return out
