"""Rolling-origin cross-validation (port of the reference's ``engine/cv.py``:
the metric means, with or without split-conformal calibration, and the raw
per-cutoff forecasts as a diagnostics frame).

Prophet's ``cross_validation(horizon, period, initial)`` protocol: cutoffs
every ``period`` steps after ``initial`` steps of history; each cutoff fits
on rows [0, c] and scores rows (c, c + horizon]; metrics average over
cutoffs.  Train masks differ per cutoff and everything else is shared, so
the cutoff axis is folded into the series axis: all C cutoffs x S series fit
as one (C·S, T) batch — one fit and one forecast per CV pass (for
Holt-Winters one launch of each kernel; for the curve model one Gram GEMM
and one batched solve).  Stacking is exact for every family: each row's
fit sees its own train mask, and arnet's trainer sums per-series losses
with one schedule for all rows; only statistics a family takes over all
rows of a call (arnet's per-series regressor standardization; a family
registered with ``per_block_stats``) are kept to each cutoff's block
(``groups``).  ``calibrate=True`` adds the per-series conformal band scale
(``engine/calibrate``) from the same paths.  A family that samples (the
curve model's Monte-Carlo intervals) draws every cutoff's paths from one
``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.models import get_model
from distributed_forecasting_tpu_torch.models.base import generator_kwargs
from distributed_forecasting_tpu_torch.ops import metrics as metrics_ops


@dataclasses.dataclass(frozen=True)
class CVConfig:
    horizon: int = 90   # steps scored after each cutoff
    period: int = 360   # steps between cutoffs
    initial: int = 730  # minimum history before the first cutoff


def cutoff_indices(n_time: int, cv: CVConfig) -> List[int]:
    """Host-side list of cutoff row indices: cutoff c trains on rows [0, c]
    and scores rows (c, c + horizon]; every cutoff has a full horizon."""
    cuts = []
    c = cv.initial - 1
    while c + cv.horizon < n_time:
        cuts.append(c)
        c += cv.period
    if not cuts:
        raise ValueError(
            f"series too short for CV: T={n_time}, initial={cv.initial}, "
            f"horizon={cv.horizon}"
        )
    return cuts


def cv_windows(mask, day, cuts, horizon):
    """Rolling-origin window tensors on the batch's device:
    ``(train_masks, eval_masks, t_ends)``, shapes ((C, S, T), (C, S, T), (C,))."""
    T = day.shape[0]
    idx = torch.arange(T, device=mask.device)
    cuts_t = torch.as_tensor(cuts, device=mask.device)
    within = idx[None, :] <= cuts_t[:, None]               # (C, T)
    train_masks = mask[None] * within[:, None, :]
    in_eval = (~within) & (idx[None, :] <= cuts_t[:, None] + horizon)
    eval_masks = mask[None] * in_eval[:, None, :]
    t_ends = day[cuts_t].to(torch.float32)
    return train_masks, eval_masks, t_ends


def _cv_metric_means(y, yhat, lo, hi, eval_masks, train_masks, mase_m=7):
    """Per-series CV-mean metrics from the (C, S, T) paths, MASE against
    each cutoff's own training window."""
    y_b = y[None].expand_as(yhat)
    per_cut = metrics_ops.compute_all(y_b, yhat, eval_masks, lo=lo, hi=hi)
    per_cut["mase"] = metrics_ops.mase(y_b, yhat, eval_masks, train_masks,
                                       m=mase_m)
    return {name: torch.mean(v, dim=0) for name, v in per_cut.items()}


def _cv_entry(batch: SeriesBatch, model: str, config, xreg, what: str):
    """Entry validation shared by every CV route: the grid cadence,
    explicit changepoint days and regressor tensors.  Returns
    ``(config, xreg)``."""
    from distributed_forecasting_tpu_torch.engine.fit import (
        validate_changepoint_days,
        validate_grid_cadence,
        validate_xreg,
    )

    fns = get_model(model)
    config = config if config is not None else fns.config_cls()
    validate_grid_cadence(model, batch)
    validate_changepoint_days(config, batch.day)
    xreg = validate_xreg(fns, model, config, xreg, None, what,
                         trim_to=batch.n_time)
    return config, xreg


def _cv_paths(batch: SeriesBatch, model: str, config, cuts, horizon: int,
              xreg=None, generator=None):
    """Every cutoff's forecast paths and windows:
    ``(yhat, lo, hi, eval_masks, train_masks)``, each (C, S, T), from one
    fit and one forecast over the cutoff-major (C·S, T) rows."""
    fns = get_model(model)
    y, mask, day = batch.y, batch.mask, batch.day
    S, T = y.shape
    C = len(cuts)
    train_masks, eval_masks, t_ends = cv_windows(mask, day, cuts, horizon)

    # cutoff-major rows: row c*S + s is series s trained up to cutoff c
    kw = {}
    if xreg is not None:
        xreg = xreg.to(y.device)
        kw["xreg"] = xreg.repeat(C, 1, 1) if xreg.dim() == 3 else xreg
    # a family that takes statistics over all rows of a fit keeps each
    # cutoff's block of S rows to its own
    groups = {"groups": C} if fns.per_block_stats else {}
    params = fns.fit(y.repeat(C, 1), train_masks.reshape(C * S, T), day,
                     config, **kw, **groups)
    yhat, lo, hi = fns.forecast(params, day, t_ends.repeat_interleave(S),
                                config, **kw,
                                **generator_kwargs(fns, generator))
    yhat, lo, hi = (x.reshape(C, S, T) for x in (yhat, lo, hi))
    return yhat, lo, hi, eval_masks, train_masks


def _calibration_outputs(y, yhat, lo, hi, eval_masks, model: str, config):
    """Conformal scale and the calibrated band's CV coverage from the
    (C, S, T) paths: ``(scale (S,), coverage (S,))``."""
    from distributed_forecasting_tpu_torch.engine.calibrate import (
        apply_interval_scale,
        config_interval_width,
        conformal_scale_from_paths,
    )

    scale = conformal_scale_from_paths(
        y, yhat, hi, eval_masks,
        interval_width=config_interval_width(config),
    )
    # the (S, 1) scale broadcasts against the (C, S, T) paths directly
    _, lo_c, hi_c = apply_interval_scale(
        yhat, lo, hi, scale, floor=get_model(model).band_floor
    )
    y_b = y[None].expand_as(yhat)
    cov_c = torch.mean(metrics_ops.coverage(y_b, lo_c, hi_c, eval_masks),
                       dim=0)
    return scale, cov_c


def _frame_from_paths(batch: SeriesBatch, cuts, yhat, lo, hi, eval_masks):
    """The diagnostics frame from the (C, S, T) paths, on the host: one row
    per series, cutoff and scored day, ``[ds, *keys, cutoff, y, yhat,
    yhat_lower, yhat_upper]``, cutoff-major."""
    em = eval_masks.cpu().numpy() > 0
    ci, si, ti = np.nonzero(em)
    dates = batch.dates()
    y_np = batch.y.cpu().numpy()
    frame = {"ds": dates.values[ti]}
    for j, name in enumerate(batch.key_names):
        frame[name] = batch.keys[si, j]
    frame["cutoff"] = dates.values[np.asarray(cuts)[ci]]
    frame["y"] = y_np[si, ti]
    frame["yhat"] = yhat.cpu().numpy()[ci, si, ti]
    frame["yhat_lower"] = lo.cpu().numpy()[ci, si, ti]
    frame["yhat_upper"] = hi.cpu().numpy()[ci, si, ti]
    return pd.DataFrame(frame)


def cv_forecast_frame(
    batch: SeriesBatch,
    model: str = "prophet",
    config=None,
    cv: CVConfig = CVConfig(),
    xreg=None,
    generator=None,
) -> pd.DataFrame:
    """Raw rolling-origin forecasts as a long frame, the shape Prophet's
    ``diagnostics.cross_validation`` returns: one row per series, cutoff and
    scored day, ``[ds, *keys, cutoff, y, yhat, yhat_lower, yhat_upper]``.
    A diagnostics-scale tool: the (C, S, T) paths come to the host.  For
    the frame and the metric means from one CV pass, use
    ``cross_validate(..., return_frame=True)``."""
    config, xreg = _cv_entry(batch, model, config, xreg, "cv_forecast_frame")
    cuts = cutoff_indices(batch.n_time, cv)
    yhat, lo, hi, eval_masks, _ = _cv_paths(batch, model, config, cuts,
                                            cv.horizon, xreg, generator)
    return _frame_from_paths(batch, cuts, yhat, lo, hi, eval_masks)


def cross_validate(
    batch: SeriesBatch,
    model: str = "prophet",
    config=None,
    cv: CVConfig = CVConfig(),
    xreg=None,
    return_frame: bool = False,
    calibrate: bool = False,
    generator=None,
):
    """Per-series CV-mean metrics — mse, rmse, mae, mape, smape, mdape,
    coverage, mase — each an (S,) tensor, plus ``"_n_cutoffs"`` (int).

    ``xreg``: regressor values for a config with ``n_regressors > 0``,
    (T, R) or (S, T, R) over the history (a longer, history + horizon
    tensor is trimmed: CV scores inside the history).  Per-series
    regressors re-standardize under each cutoff's train mask, as a fit at
    that cutoff would.

    ``calibrate=True`` adds ``"_interval_scale"``, the (S,) split-conformal
    band scale from the same paths (``engine/calibrate``), and
    ``"_coverage_calibrated"``, the CV coverage of the band it scales.

    ``return_frame=True`` returns ``(metrics, frame)``: the diagnostics
    frame of :func:`cv_forecast_frame` from the same paths, one CV pass.

    ``generator``: the draws of a family that samples; ``None`` seeds one
    as the reference seeds its default key.
    """
    config, xreg = _cv_entry(batch, model, config, xreg, "cross_validate")
    cuts = cutoff_indices(batch.n_time, cv)
    yhat, lo, hi, eval_masks, train_masks = _cv_paths(
        batch, model, config, cuts, cv.horizon, xreg, generator)
    out = _cv_metric_means(
        batch.y, yhat, lo, hi, eval_masks, train_masks,
        mase_m=metrics_ops.seasonal_naive_lag(batch.freq),
    )
    out["_n_cutoffs"] = len(cuts)
    if calibrate:
        out["_interval_scale"], out["_coverage_calibrated"] = (
            _calibration_outputs(batch.y, yhat, lo, hi, eval_masks, model,
                                 config))
    if return_frame:
        return out, _frame_from_paths(batch, cuts, yhat, lo, hi, eval_masks)
    return out
