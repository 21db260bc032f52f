"""Per-series automatic model selection across model families (port of the
reference's ``engine/select.py``: ``select_model`` and
``fit_forecast_auto``).

Rolling-origin CV runs once per family (each one batched pass,
``engine/cv``); each series' winner is the family with the best CV-mean
selection metric (default smape); every family that won a series is refit
on the full history, and the combined forecast gathers each series' row
from its winner.  A family whose CV metric is non-finite for a series can
never win it, and the fit engine's seasonal-naive fallback still applies.

The reference's budgeted ``successive_halving_select`` is not ported
(ROADMAP Queue 1: P8).  A family that samples (the curve model's
Monte-Carlo intervals) draws from the one ``generator`` passed in, each CV
pass and refit in turn, where the reference folds its key per family
(``utils/rng.py``); arnet draws its minibatch schedule from its config's
seed in every pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine.cv import CVConfig, cross_validate
from distributed_forecasting_tpu_torch.engine.fit import (
    ForecastResult,
    fit_forecast,
)
from distributed_forecasting_tpu_torch.models.base import require_models

DEFAULT_FAMILIES = ("prophet", "holt_winters", "theta", "croston", "arima")

# metrics where larger is better; everything else is argmin'd
_HIGHER_BETTER = frozenset({"coverage"})


@dataclasses.dataclass
class SelectionResult:
    models: Tuple[str, ...]       # candidate family names, index space below
    assignment: np.ndarray        # (S,) winning family index per series
    best_score: np.ndarray        # (S,) winning CV-mean selection metric
    scores: pd.DataFrame          # (S, len(models)) per-family scores
    metric: str
    valid: np.ndarray = None      # (S,) bool: some family scored finite;
                                  # invalid series keep assignment 0 and
                                  # rely on the fit engine's fail-safe

    def __post_init__(self):
        if self.valid is None:
            # a caller-built selection (forced assignments) trusts every
            # series
            self.valid = np.ones(self.assignment.shape[0], dtype=bool)

    @property
    def chosen(self) -> np.ndarray:
        """(S,) winning family name per series."""
        return np.asarray(self.models, dtype=object)[self.assignment]

    def counts(self) -> Dict[str, int]:
        names, cnt = np.unique(self.chosen, return_counts=True)
        return dict(zip(names.tolist(), cnt.tolist()))


def select_model(
    batch: SeriesBatch,
    models: Sequence[str] = DEFAULT_FAMILIES,
    configs: Optional[Dict[str, object]] = None,
    metric: str = "smape",
    cv: CVConfig = CVConfig(),
    generator=None,
) -> SelectionResult:
    """CV every family, then the per-series argmin of the selection
    metric.  Every family is checked before the first CV pass starts; the
    families' (S,) scores come to the host in one pull."""
    configs = configs or {}
    require_models(models)
    scores = [cross_validate(batch, model=name, config=configs.get(name),
                             cv=cv, generator=generator)[metric]
              for name in models]
    table = torch.stack(scores, dim=1).cpu().numpy().astype(np.float64)
    cols = {name: table[:, i] for i, name in enumerate(models)}
    # orient so smaller is better; a non-finite score can never win
    oriented = -table if metric in _HIGHER_BETTER else table
    guarded = np.where(np.isfinite(oriented), oriented, np.inf)
    assignment = np.argmin(guarded, axis=1)
    valid = np.isfinite(guarded).any(axis=1)
    best = np.take_along_axis(table, assignment[:, None], axis=1)[:, 0]
    return SelectionResult(
        models=tuple(models),
        assignment=assignment,
        best_score=best,
        scores=pd.DataFrame(cols),
        metric=metric,
        valid=valid,
    )


def fit_forecast_auto(
    batch: SeriesBatch,
    models: Sequence[str] = DEFAULT_FAMILIES,
    configs: Optional[Dict[str, object]] = None,
    metric: str = "smape",
    cv: CVConfig = CVConfig(),
    horizon: int = 90,
    selection: Optional[SelectionResult] = None,
    generator=None,
) -> Tuple[Dict[str, object], SelectionResult, ForecastResult]:
    """Select per series, refit every winning family on the full history,
    and gather the combined forecast.  Returns ``(params_by_family,
    selection, result)``; ``params_by_family`` (the families that won at
    least one series) feeds ``serving.MultiModelForecaster``."""
    configs = configs or {}
    if selection is None:
        selection = select_model(batch, models=models, configs=configs,
                                 metric=metric, cv=cv, generator=generator)
    else:
        require_models(selection.models)
    winners = sorted(set(selection.assignment.tolist()))
    params_by_family: Dict[str, object] = {}
    yhat = lo = hi = ok = day_all = None
    dev = batch.y.device
    assign = torch.as_tensor(selection.assignment, device=dev)
    for i in winners:
        name = selection.models[i]
        params, res = fit_forecast(batch, model=name,
                                   config=configs.get(name), horizon=horizon,
                                   generator=generator)
        params_by_family[name] = params
        pick = (assign == i)[:, None]
        if yhat is None:
            yhat, lo, hi = res.yhat, res.lo, res.hi
            ok, day_all = res.ok, res.day_all
        else:
            yhat = torch.where(pick, res.yhat, yhat)
            lo = torch.where(pick, res.lo, lo)
            hi = torch.where(pick, res.hi, hi)
            ok = torch.where(pick[:, 0], res.ok, ok)
    # a series with no finite CV score anywhere is not trustworthy even if
    # its full-history fit succeeded
    ok = ok & torch.as_tensor(selection.valid, device=dev)
    result = ForecastResult(yhat=yhat, lo=lo, hi=hi, ok=ok, day_all=day_all)
    return params_by_family, selection, result
