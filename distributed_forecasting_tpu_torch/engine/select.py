"""Per-series automatic model selection across model families (port of the
reference's ``engine/select.py``: ``select_model``,
``successive_halving_select`` and ``fit_forecast_auto``).

Rolling-origin CV runs once per family (each one batched pass,
``engine/cv``); each series' winner is the family with the best CV-mean
selection metric (default smape); every family that won a series is refit
on the full history, and the combined forecast gathers each series' row
from its winner.  A family whose CV metric is non-finite for a series can
never win it, and the fit engine's seasonal-naive fallback still applies.

The budgeted sweep, :func:`successive_halving_select`, triages families
on cheap rungs (a strided series subset, the last CV cutoffs) before one
full :func:`select_model` pass over the survivors; it is a library entry
point, not called by the train task (as in the reference).  A family that
samples (the curve model's Monte-Carlo intervals) draws from the one
``generator`` passed in, each CV pass and refit in turn, where the
reference folds its key per family (``utils/rng.py``); arnet draws its
minibatch schedule from its config's seed in every pass.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine.cv import (
    CVConfig,
    cross_validate,
    cutoff_indices,
)
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


@dataclasses.dataclass
class AutoMLResult:
    """Outcome of one :func:`successive_halving_select` sweep."""

    leaderboard: pd.DataFrame     # one row per (rung, family) evaluation:
    #                               family, rung, n_series, n_cutoffs,
    #                               score, seconds, cumulative seconds
    survivors: Tuple[str, ...]    # families alive after the last rung
    selection: SelectionResult    # final per-series assignment
    spent_device_seconds: float   # total metered seconds
    budget_exhausted: bool        # True when the launch gate closed early
    metric: str = "smape"


def _rung_subset(batch: SeriesBatch, n_sub: int) -> SeriesBatch:
    """Evenly strided deterministic series subset of size ``n_sub`` (a
    stride keeps every demand regime represented; a prefix would score
    whatever the row order put first)."""
    S = batch.n_series
    if n_sub >= S:
        return batch
    idx = (np.arange(n_sub) * S) // n_sub
    rows = torch.as_tensor(idx, device=batch.y.device)
    return dataclasses.replace(batch, y=batch.y[rows], mask=batch.mask[rows],
                               keys=np.asarray(batch.keys)[idx])


def _rung_cv(cv: CVConfig, n_time: int, n_cutoffs: int) -> CVConfig:
    """The CV variant covering only the last ``n_cutoffs`` cutoffs of
    ``cv`` (the most recent windows, which the final selection scores
    too)."""
    cuts = cutoff_indices(n_time, cv)
    if n_cutoffs >= len(cuts):
        return cv
    return dataclasses.replace(cv, initial=cuts[-n_cutoffs] + 1)


def successive_halving_select(
    batch: SeriesBatch,
    config=None,
    configs: Optional[Dict[str, object]] = None,
    cv: CVConfig = CVConfig(),
    generator=None,
) -> AutoMLResult:
    """Cross-family successive halving under a seconds budget.

    Rung r scores every surviving family on a ``base_series * eta**r``
    series subset (the ``engine/gradfit.series_bucket`` ladder, evenly
    strided) over the last ``base_cutoffs * eta**r`` CV cutoffs, then keeps
    the best ``1/eta`` of them by rung-mean metric.  After the rungs (or
    once one family is left) the survivors get one full-batch
    :func:`select_model` pass for the per-series assignment.

    The budget is a launch gate: every evaluation is timed to completion
    (the host pull of its metric waits for the card) and charged with
    ``monitoring/cost.record_dispatch`` (entry ``automl:cv:<family>``,
    ``automl:final`` for the full pass), which the sweep's attribution
    scope sums into its meter; no evaluation starts once the meter reads
    >= the budget.
    The sweep then returns the best ranking so far with
    ``budget_exhausted=True`` and a uniform assignment of the best family.

    ``config``: an :class:`~distributed_forecasting_tpu_torch.engine.hyper.
    AutoMLConfig` (default the process-wide ``engine.automl`` block);
    ``configs``: per-family model configs for the CV passes and the final
    selection; ``generator``: the draws of a family that samples.
    """
    from distributed_forecasting_tpu_torch.engine.gradfit import series_bucket
    from distributed_forecasting_tpu_torch.engine.hyper import automl_config
    from distributed_forecasting_tpu_torch.monitoring.cost import cost_metrics

    cfg = config if config is not None else automl_config()
    configs = configs or {}
    require_models(cfg.families)
    S = batch.n_series
    rows = []
    survivors = list(cfg.families)
    ranking: Dict[str, float] = {}
    exhausted = False
    # the sweep's meter: each evaluation's seconds to completion, charged to
    # the cost registry (entries automl:cv:<family> and automl:final) and
    # summed by this thread's attribution scope
    cm = cost_metrics()

    with cm.attribution() as acc:

        def eval_once(fam, sub, cv_r, rung):
            t0 = time.perf_counter()
            res = cross_validate(sub, model=fam, config=configs.get(fam),
                                 cv=cv_r, generator=generator)
            # the host pull waits for the card: dt is the evaluation's
            # time to completion
            vals = res[cfg.metric].cpu().numpy().astype(np.float64)
            dt = time.perf_counter() - t0
            cm.record_dispatch(f"automl:cv:{fam}", fam, dt)
            finite = np.isfinite(vals)
            score = (float(np.mean(vals[finite])) if finite.any()
                     else float("inf"))
            if cfg.metric in _HIGHER_BETTER:
                score = -score if np.isfinite(score) else float("inf")
            rows.append({
                "family": fam, "rung": rung, "n_series": sub.n_series,
                "n_cutoffs": int(res["_n_cutoffs"]),
                f"mean_{cfg.metric}": (score if cfg.metric not in
                                       _HIGHER_BETTER else -score),
                "device_seconds": dt,
                "cumulative_device_seconds": acc["device_seconds"],
            })
            return score

        for r in range(cfg.rungs):
            if len(survivors) <= 1:
                break
            n_sub = min(S, series_bucket(
                min(S, cfg.base_series * cfg.eta ** r), cfg.base_series))
            sub = _rung_subset(batch, n_sub)
            cv_r = _rung_cv(cv, batch.n_time, cfg.base_cutoffs * cfg.eta ** r)
            scores: Dict[str, float] = {}
            for fam in survivors:
                if acc["device_seconds"] >= cfg.budget_device_seconds:
                    exhausted = True
                    break
                scores[fam] = eval_once(fam, sub, cv_r, r)
            ranking.update(scores)
            if exhausted:
                # families the gate cut off keep their previous rung's rank
                break
            order = sorted(survivors, key=lambda f: scores[f])
            keep = max(1, -(-len(survivors) // cfg.eta))  # ceil division
            survivors = order[:keep]

        if not exhausted and acc["device_seconds"] < cfg.budget_device_seconds:
            t0 = time.perf_counter()
            selection = select_model(batch, models=tuple(survivors),
                                     configs=configs, metric=cfg.metric,
                                     cv=cv, generator=generator)
            dt = time.perf_counter() - t0
            cm.record_dispatch("automl:final", "select", dt)
            rows.append({
                "family": "+".join(survivors), "rung": "final",
                "n_series": S, "n_cutoffs": -1,
                f"mean_{cfg.metric}": float(np.nanmean(np.where(
                    np.isfinite(selection.best_score), selection.best_score,
                    np.nan))),
                "device_seconds": dt,
                "cumulative_device_seconds": acc["device_seconds"],
            })
        else:
            exhausted = True
            # the budget closed before the full pass: the best-ranked
            # family for every series (a usable assignment, never a crash)
            best = min(ranking, key=ranking.get) if ranking else survivors[0]
            sc = ranking.get(best, float("inf"))
            selection = SelectionResult(
                models=(best,), assignment=np.zeros(S, dtype=int),
                best_score=np.full(S, sc),
                scores=pd.DataFrame({best: np.full(S, sc)}),
                metric=cfg.metric)

    return AutoMLResult(
        leaderboard=pd.DataFrame(rows), survivors=tuple(survivors),
        selection=selection,
        spent_device_seconds=float(acc["device_seconds"]),
        budget_exhausted=exhausted, metric=cfg.metric)


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
