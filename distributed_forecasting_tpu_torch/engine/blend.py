"""Per-series weighted cross-family blending, a linear opinion pool (port of
the reference's ``engine/blend.py``).

Where ``engine/select`` serves each series from ONE family, this combines
every family with per-series weights from their rolling-origin CV errors
(the same one CV pass per family that selection runs): ``w_f ∝
(1/err_f)^temperature``.

Combination rules, closed-form:

* point path: ``yhat = sum_f w_f yhat_f``;
* bands: half-widths combine linearly, ``hi - yhat = sum_f w_f (hi_f -
  yhat_f)`` (family errors on one series are strongly correlated, so the
  perfectly-correlated rule is the conservative one);
* a family with a non-finite CV metric on a series weighs 0 there; a series
  where every family is non-finite takes equal weights and is not ``ok``;
  a series is ``ok`` only if every family CARRYING WEIGHT on it fit
  healthily.

``fit_forecast_blend(calibrate=True)`` scales the pooled band by a
split-conformal factor from the pooled CV paths: each family's CV pass runs
a second time for it, as in the reference.  Families that sample draw
from one ``generator`` in turn (``engine/select``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine.calibrate import (
    apply_interval_scale,
    config_interval_width,
    conformal_scale_from_paths,
)
from distributed_forecasting_tpu_torch.engine.cv import (
    CVConfig,
    _cv_entry,
    _cv_paths,
    cutoff_indices,
)
from distributed_forecasting_tpu_torch.engine.fit import (
    ForecastResult,
    fit_forecast,
)
from distributed_forecasting_tpu_torch.engine.select import (
    _HIGHER_BETTER,
    DEFAULT_FAMILIES,
    select_model,
)
from distributed_forecasting_tpu_torch.models.base import (
    get_model,
    require_models,
)

_EPS = 1e-9


@dataclasses.dataclass
class BlendResult:
    models: Tuple[str, ...]   # family names, the weight matrix's column space
    weights: np.ndarray       # (S, F) convex weights per series
    scores: pd.DataFrame      # (S, F) per-family CV metric
    metric: str
    valid: np.ndarray         # (S,) bool: some family scored finite
    # (S,) split-conformal scale of the POOLED band, filled by
    # fit_forecast_blend(calibrate=True); None = uncalibrated
    interval_scale: Optional[np.ndarray] = None

    def mean_weights(self) -> Dict[str, float]:
        return {name: float(self.weights[:, i].mean())
                for i, name in enumerate(self.models)}


def blend_weights(
    batch: SeriesBatch,
    models: Sequence[str] = DEFAULT_FAMILIES,
    configs: Optional[Dict[str, object]] = None,
    metric: str = "smape",
    cv: CVConfig = CVConfig(),
    temperature: float = 1.0,
    generator=None,
) -> BlendResult:
    """Per-series inverse-CV-error weights, ``w_f ∝ (1/err_f)^temperature``
    (on the host, from ``select_model``'s score table): temperature > 1
    sharpens the pool toward winner-take-all, < 1 flattens it."""
    sel = select_model(batch, models=models, configs=configs, metric=metric,
                       cv=cv, generator=generator)
    table = sel.scores[list(models)].to_numpy(dtype=np.float64)  # (S, F)
    finite = np.isfinite(table)
    if metric in _HIGHER_BETTER:
        # a bigger-is-better score weighs by itself, not its inverse
        base = np.maximum(table, 0.0)
    else:
        base = 1.0 / np.maximum(table, _EPS)
    # divide by the row max before the power (1e9**34 overflows float64);
    # the row normalisation below makes the weights scale-invariant
    rowmax = np.where(finite, base, 0.0).max(axis=1, keepdims=True)
    base = base / np.maximum(rowmax, _EPS)
    # the finite mask goes on AFTER the power: 0**0 == 1 would weigh a
    # non-finite family at temperature 0
    inv = np.where(finite, base ** temperature, 0.0)
    tot = inv.sum(axis=1, keepdims=True)
    equal = np.full_like(inv, 1.0 / len(models))
    weights = np.where(tot > 0, inv / np.maximum(tot, _EPS), equal)
    return BlendResult(models=tuple(models), weights=weights,
                       scores=sel.scores, metric=metric, valid=sel.valid)


def _blend_conformal_scale(batch, blend: BlendResult, configs, cv,
                           generator=None) -> np.ndarray:
    """Split-conformal scale of the POOLED band: each family's CV paths are
    blended with the per-series weights (the rules the final forecast
    uses), and the pooled residuals are scored against the pooled
    half-band, so the calibration set is the forecast being shipped.
    Holds F sets of (C, S, T) paths at once."""
    # every member's width first: a pool calibrated "at 95%" while one
    # member prices 80% has no defined target
    resolved, widths = {}, {}
    for name in blend.models:
        config, _ = _cv_entry(batch, name, configs.get(name), None,
                              "fit_forecast_blend(calibrate=True)")
        resolved[name] = config
        widths[name] = config_interval_width(config)
    if len(set(widths.values())) > 1:
        raise ValueError(
            f"calibrate=True needs ONE interval_width across the pool, got "
            f"{widths}; align the member configs"
        )
    w = torch.as_tensor(blend.weights, dtype=torch.float32,
                        device=batch.y.device)
    cuts = cutoff_indices(batch.n_time, cv)
    yhat_b = up_b = eval_masks = None
    for i, name in enumerate(blend.models):
        yhat, _, hi, em, _ = _cv_paths(batch, name, resolved[name], cuts,
                                       cv.horizon, generator=generator)
        wf = w[:, i][None, :, None]  # broadcast over (C, S, T)
        if yhat_b is None:
            yhat_b, up_b, eval_masks = wf * yhat, wf * (hi - yhat), em
        else:
            yhat_b = yhat_b + wf * yhat
            up_b = up_b + wf * (hi - yhat)
    return conformal_scale_from_paths(
        batch.y, yhat_b, yhat_b + up_b, eval_masks,
        interval_width=next(iter(widths.values())),
    ).cpu().numpy()


def blend_band_floor(models) -> Optional[float]:
    """The pooled band's hard floor: the loosest floor EVERY member
    guarantees, or None when any member is unbounded below (the engine's
    result and serving share it)."""
    floors = [get_model(name).band_floor for name in models]
    if any(f is None for f in floors):
        return None
    return min(floors)


def fit_forecast_blend(
    batch: SeriesBatch,
    models: Sequence[str] = DEFAULT_FAMILIES,
    configs: Optional[Dict[str, object]] = None,
    metric: str = "smape",
    cv: CVConfig = CVConfig(),
    horizon: int = 90,
    blend: Optional[BlendResult] = None,
    temperature: float = 1.0,
    calibrate: bool = False,
    generator=None,
) -> Tuple[Dict[str, object], BlendResult, ForecastResult]:
    """Weight per series, fit every family on the full history, combine.

    Returns ``(params_by_family, blend, result)``; the params and
    ``blend.weights`` feed ``serving.BlendedForecaster``.  With
    ``calibrate=True`` the pooled band is split-conformal calibrated from
    the pooled CV residuals (``blend.interval_scale``, applied to the
    result's bands).  Every family is checked before any CV pass.
    """
    configs = configs or {}
    if blend is None:
        blend = blend_weights(batch, models=models, configs=configs,
                              metric=metric, cv=cv, temperature=temperature,
                              generator=generator)
    else:
        require_models(blend.models)
    if calibrate and blend.interval_scale is None:
        blend = dataclasses.replace(
            blend,
            interval_scale=_blend_conformal_scale(batch, blend, configs, cv,
                                                  generator))

    params_by_family: Dict[str, object] = {}
    dev = batch.y.device
    w = torch.as_tensor(blend.weights, dtype=torch.float32, device=dev)
    yhat = up = dn = ok = day_all = None
    for i, name in enumerate(blend.models):
        params, res = fit_forecast(batch, model=name,
                                   config=configs.get(name), horizon=horizon,
                                   generator=generator)
        params_by_family[name] = params
        wf = w[:, i][:, None]
        # a family vouches only for the series it carries: a 0.6-weight
        # member that fell back to seasonal-naive makes the series not ok
        carries_ok = res.ok | (w[:, i] <= 1e-6)
        if yhat is None:
            yhat = wf * res.yhat
            up = wf * (res.hi - res.yhat)
            dn = wf * (res.yhat - res.lo)
            ok, day_all = carries_ok, res.day_all
        else:
            yhat = yhat + wf * res.yhat
            up = up + wf * (res.hi - res.yhat)
            dn = dn + wf * (res.yhat - res.lo)
            ok = ok & carries_ok
    ok = ok & torch.as_tensor(blend.valid, device=dev)
    lo_b, hi_b = yhat - dn, yhat + up
    if blend.interval_scale is not None:
        _, lo_b, hi_b = apply_interval_scale(
            yhat, lo_b, hi_b, torch.as_tensor(blend.interval_scale, device=dev),
            floor=blend_band_floor(blend.models))
    result = ForecastResult(yhat=yhat, lo=lo_b, hi=hi_b, ok=ok,
                            day_all=day_all)
    return params_by_family, blend, result
