"""Vectorized hyperparameter search of the curve model, the AutoML path's
equivalent (port of the reference's ``engine/hyper.py``: the
``engine.automl`` conf block and its process-wide install,
``HyperSearchConfig``, ``tune_curve_model``).

The reference's AutoML notebook tunes each series with hyperopt TPE over
``changepoint_prior_scale``, ``seasonality_prior_scale``,
``holidays_prior_scale`` (log-uniform) and ``seasonality_mode``, scoring
smape over CV folds.  Here the prior scales are data to the curve fit
(``models/prophet_glm.fit(prior_scales=...)``), so every trial x cutoff x
series is one row of one batched fit per seasonality mode (in blocks of
trials where the rows would not fit, ``_TRIAL_ELEMS``).  Selection is the
per-series argmin of the CV-mean metric; every series is then refit with
its own winning scales (a per-series (S, F) ridge precision), once per
mode.

Adaptive search (``adaptive_rounds > 1``): after the log-uniform round,
each round resamples every series' scales log-normally around that
series' incumbent with a geometrically shrinking width, clipped to the
box.  A trial whose metric is non-finite scores +inf and never wins.

The trials are drawn from a ``torch.Generator`` seeded ``search.seed``
(``utils/rng.py``: held to the reference by distribution); the tuner also
takes the standard draws themselves (``draws``), which is how the tests
hand it the reference's.  The ``engine.automl`` block configures the
cross-family successive-halving sweep,
``engine/select.successive_halving_select``; ``tasks/common`` installs it
with :func:`configure_automl`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine.cv import (
    CVConfig,
    cutoff_indices,
    cv_windows,
)
from distributed_forecasting_tpu_torch.models import prophet_glm
from distributed_forecasting_tpu_torch.models.prophet_glm import (
    CurveModelConfig,
    CurveParams,
)
from distributed_forecasting_tpu_torch.ops import metrics as metrics_ops
from distributed_forecasting_tpu_torch.utils.rng import make_generator


@dataclasses.dataclass(frozen=True)
class AutoMLConfig:
    """The strict ``engine.automl`` conf block: the reference's cross-family
    successive-halving sweep.  Rung r evaluates the surviving families on a
    ``base_series * eta**r``-sized series subset and the last
    ``base_cutoffs * eta**r`` CV cutoffs, then keeps the best ``1/eta``
    fraction; ``budget_device_seconds`` gates new evaluations."""

    enabled: bool = False
    budget_device_seconds: float = 60.0
    eta: int = 2
    rungs: int = 3
    base_series: int = 64
    base_cutoffs: int = 1
    metric: str = "smape"
    families: tuple = ("prophet", "holt_winters", "theta", "croston",
                       "arima", "arnet")

    def __post_init__(self):
        if self.eta < 2:
            raise ValueError(f"eta must be >= 2, got {self.eta}")
        if self.rungs < 1:
            raise ValueError(f"rungs must be >= 1, got {self.rungs}")
        if self.budget_device_seconds <= 0:
            raise ValueError(
                f"budget_device_seconds must be > 0, got "
                f"{self.budget_device_seconds}")
        if self.base_series < 1:
            raise ValueError(
                f"base_series must be >= 1, got {self.base_series}")
        if self.base_cutoffs < 1:
            raise ValueError(
                f"base_cutoffs must be >= 1, got {self.base_cutoffs}")
        if not self.families:
            raise ValueError("families must name at least one family")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "AutoMLConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            raise ValueError(
                f"unknown engine.automl conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


_active_automl = AutoMLConfig()


def configure_automl(conf) -> AutoMLConfig:
    """Install the process-wide sweep config: an :class:`AutoMLConfig`, or
    an ``engine.automl`` conf block parsed strictly."""
    global _active_automl
    cfg = (conf if isinstance(conf, AutoMLConfig)
           else AutoMLConfig.from_conf(conf))
    _active_automl = cfg
    return cfg


def automl_config() -> AutoMLConfig:
    return _active_automl


@dataclasses.dataclass(frozen=True)
class HyperSearchConfig:
    n_trials: int = 8
    metric: str = "smape"  # selection metric (reference automl: val_smape)
    cp_scale_range: Tuple[float, float] = (0.001, 0.5)
    seas_scale_range: Tuple[float, float] = (0.01, 10.0)
    # swept alongside the other two; a no-op without holiday features
    hol_scale_range: Tuple[float, float] = (0.01, 10.0)
    modes: Tuple[str, ...] = ("additive", "multiplicative")
    seed: int = 0
    # total rounds including the log-uniform one; each later round samples
    # per-series log-normal around that series' incumbent with width
    # zoom_sigma * zoom_factor**(round-1), clipped to the box (1 = plain
    # random search)
    adaptive_rounds: int = 1
    zoom_sigma: float = 0.8
    zoom_factor: float = 0.5


@dataclasses.dataclass
class TuneResult:
    params: CurveParams          # refit with per-series best scales
    config: CurveModelConfig     # config of the refit (the majority mode)
    best_cp_scale: np.ndarray    # (S,)
    best_seas_scale: np.ndarray  # (S,)
    best_hol_scale: np.ndarray   # (S,)
    best_mode: np.ndarray        # (S,) str
    best_score: np.ndarray       # (S,) CV-mean selection metric
    trials: pd.DataFrame         # trial table (round, mode, scales, score)
    mode_params: Dict[str, CurveParams]  # per-mode refit params (serving)


def _log_uniform(u, lo: float, hi: float):
    """Log-uniform values on [lo, hi] from uniforms ``u`` on [0, 1)."""
    lo_t = torch.log(torch.tensor(lo, dtype=torch.float32, device=u.device))
    hi_t = torch.log(torch.tensor(hi, dtype=torch.float32, device=u.device))
    return torch.exp(lo_t + u * (hi_t - lo_t))


# elements of one (rows, T) tensor of a scoring pass: trials go in blocks
# that keep the trials x cutoffs x series rows under it
_TRIAL_ELEMS = 1 << 27


def _cv_scores(batch: SeriesBatch, config: CurveModelConfig, cv: CVConfig,
               cp_scales, seas_scales, hol_scales, metric: str, xreg=None):
    """CV-mean metric for every (trial, series): (n_trials, S), +inf where
    non-finite.  Each scale is (n,) (one per trial) or (n, S) (per
    series).  Trials x cutoffs x series fit as rows of one batch (trial-
    major, then cutoff), in blocks of trials under ``_TRIAL_ELEMS``; only
    the point path is scored, so the scoring forecast prices no band."""
    y, mask, day = batch.y, batch.mask, batch.day
    S, T = y.shape
    dev = y.device
    cuts = cutoff_indices(batch.n_time, cv)
    C = len(cuts)
    train_masks, eval_masks, t_ends = cv_windows(mask, day, cuts, cv.horizon)
    fn = metrics_ops.METRIC_FNS[metric]
    cfg = dataclasses.replace(config, uncertainty_samples=0)
    scales = [torch.as_tensor(v, dtype=torch.float32, device=dev)
              for v in (cp_scales, seas_scales, hol_scales)]
    n = scales[0].shape[0]
    step = max(1, _TRIAL_ELEMS // max(C * S * T, 1))
    out = []
    for i in range(0, n, step):
        k = min(step, n - i)

        def rows(v):  # (k,) or (k, S) -> (k * C * S,)
            v = v[i:i + k]
            v = v[:, None, None] if v.dim() == 1 else v[:, None, :]
            return v.expand(k, C, S).reshape(-1)

        kw = {}
        if xreg is not None:
            kw["xreg"] = xreg.repeat(k * C, 1, 1) if xreg.dim() == 3 else xreg
        params = prophet_glm.fit(
            y.repeat(k * C, 1), train_masks.reshape(C * S, T).repeat(k, 1),
            day, cfg, prior_scales=tuple(rows(v) for v in scales), **kw)
        yhat, _, _ = prophet_glm.forecast(
            params, day, t_ends.repeat_interleave(S).repeat(k), cfg, **kw)
        per = fn(y.repeat(k * C, 1), yhat, eval_masks.reshape(C * S, T)
                 .repeat(k, 1)).reshape(k, C, S)
        score = torch.mean(per, dim=1)
        out.append(torch.where(torch.isfinite(score), score, torch.inf))
    return torch.cat(out)


def _trial_draws(gen: torch.Generator, r: int, n: int, S: int):
    """Round ``r``'s standard draws for the three scales: uniforms (3, n)
    for the log-uniform round, normals (3, n, S) for a zoom round."""
    if r == 0:
        return torch.rand((3, n), generator=gen, device=gen.device)
    return torch.randn((3, n, S), generator=gen, device=gen.device)


def tune_curve_model(
    batch: SeriesBatch,
    base_config: Optional[CurveModelConfig] = None,
    search: HyperSearchConfig = HyperSearchConfig(),
    cv: CVConfig = CVConfig(),
    xreg=None,
    draws: Optional[Sequence] = None,
) -> TuneResult:
    """Per-series random (or adaptive) search of the curve model's prior
    scales and seasonality mode, then a refit per mode.  ``xreg``:
    history-grid regressor values when ``base_config.n_regressors > 0``
    (a longer tensor is trimmed); the refit uses them too.  ``draws``: one
    entry per round, the standard draws of :func:`_trial_draws` (by
    default drawn from a generator on the batch's device seeded
    ``search.seed``)."""
    base_config = base_config or CurveModelConfig()
    from distributed_forecasting_tpu_torch.engine.fit import validate_xreg
    from distributed_forecasting_tpu_torch.models.base import get_model

    xreg = validate_xreg(get_model("prophet"), "prophet", base_config, xreg,
                         None, "tune_curve_model", trim_to=batch.n_time)
    dev = batch.y.device
    if xreg is not None:
        xreg = xreg.to(dev)
    gen = make_generator(dev, search.seed) if draws is None else None
    S = batch.n_series
    n = search.n_trials
    ranges = (search.cp_scale_range, search.seas_scale_range,
              search.hol_scale_range)

    # per-series incumbents; round 0 always replaces them (an inf score
    # loses to anything finite)
    best_score = np.full(S, np.inf)
    best = [np.full(S, float(np.sqrt(lo * hi))) for lo, hi in ranges]
    best_mode_idx = np.zeros(S, dtype=int)

    trial_rows = []
    rounds = max(1, int(search.adaptive_rounds))
    for r in range(rounds):
        d = (_trial_draws(gen, r, n, S) if draws is None
             else torch.as_tensor(draws[r], dtype=torch.float32, device=dev))
        if r == 0:
            trials = [_log_uniform(d[i], lo, hi)      # (n,) shared
                      for i, (lo, hi) in enumerate(ranges)]
        else:
            sigma = search.zoom_sigma * search.zoom_factor ** (r - 1)
            trials = []
            for i, ((lo, hi), inc) in enumerate(zip(ranges, best)):
                inc_t = torch.as_tensor(inc, dtype=torch.float32, device=dev)
                prop = torch.exp(torch.log(inc_t)[None, :] + sigma * d[i])
                trials.append(torch.clamp(prop, lo, hi))
        trials_np = [v.cpu().numpy() for v in trials]

        for mi, mode in enumerate(search.modes):
            cfg = dataclasses.replace(base_config, seasonality_mode=mode)
            scores = _cv_scores(batch, cfg, cv, *trials, search.metric,
                                xreg=xreg).cpu().numpy()      # (n, S)
            for t in range(n):
                finite = np.isfinite(scores[t])
                row = {"round": r, "mode": mode}
                for name, v in zip(("changepoint_prior_scale",
                                    "seasonality_prior_scale",
                                    "holidays_prior_scale"), trials_np):
                    # zoom rounds carry per-series scales: the table
                    # reports their geometric mean
                    row[name] = float(np.exp(np.mean(np.log(v[t]))))
                row[f"mean_{search.metric}"] = (
                    float(np.mean(scores[t][finite])) if finite.any()
                    else float("inf"))
                trial_rows.append(row)
            t_best = np.argmin(scores, axis=0)                # (S,)
            sc = scores[t_best, np.arange(S)]
            upd = sc < best_score

            def pick(vals, t_best=t_best):
                return vals[t_best] if vals.ndim == 1 else vals[t_best,
                                                               np.arange(S)]

            best = [np.where(upd, pick(v), b) for v, b in zip(trials_np, best)]
            best_mode_idx = np.where(upd, mi, best_mode_idx)
            best_score = np.minimum(best_score, sc)

    best_mode = np.asarray(search.modes)[best_mode_idx]
    prior = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev)
                  for v in best)
    mode_params: Dict[str, CurveParams] = {}
    for mode in search.modes:
        cfg = dataclasses.replace(base_config, seasonality_mode=mode)
        mode_params[mode] = prophet_glm.fit(batch.y, batch.mask, batch.day,
                                            cfg, xreg=xreg, prior_scales=prior)

    counts = {m: int((best_mode == m).sum()) for m in search.modes}
    major = max(counts, key=counts.get)
    return TuneResult(
        params=mode_params[major],
        config=dataclasses.replace(base_config, seasonality_mode=major),
        best_cp_scale=best[0], best_seas_scale=best[1],
        best_hol_scale=best[2], best_mode=best_mode, best_score=best_score,
        trials=pd.DataFrame(trial_rows), mode_params=mode_params,
    )
