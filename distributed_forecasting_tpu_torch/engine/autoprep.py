"""Automatic data prep: one batched pre-fit program per (S, T) batch (port
of the reference's ``engine/autoprep.py``).

The ``engine.autoprep`` conf block arms it; :func:`autoprep_batch` runs
every armed stage over the dense batch on its device (the operations of
``ops/clean.py``: zero-run masking, MAD outlier repair, CUSUM level shifts,
holiday indicators, and the ACF of ``engine/season`` for the period), and
the result is

* a cleaned :class:`~distributed_forecasting_tpu_torch.data.tensorize.SeriesBatch`
  for the fit (the STORED history is never mutated: repairs and
  re-levelings exist only in the fit tensor),
* a per-series :class:`PrepReport`, with every repair recorded per point
  (``repairs_frame``) for run artifacts,
* an optional batch season length and holiday regressor matrix.

The program is one Python function over torch tensors, called directly:
the reference's AOT executable store is not ported (ROADMAP Queue 1: P11),
and the series axis is not padded to a power of two (the reference pads
only to key its AOT entry; its ACF batch mean weights empty rows 0, so the
unpadded result is the same).

When every stage gate is off the call short-circuits before any device
work and returns the input batch object itself: identity with no prep is
structural, not numerical.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distributed_forecasting_tpu_torch.data.holidays import (
    holiday_spec_for_range,
)
from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine.season import (
    acf_scores_per_series,
    clamp_max_lag,
    select_period,
)
from distributed_forecasting_tpu_torch.ops import clean


@dataclasses.dataclass(frozen=True)
class AutoprepConfig:
    """The strict ``engine.autoprep`` conf block (flat keys, one per knob).

    ``enabled`` arms the subsystem; each stage has its own gate, so
    operators can, say, repair outliers without trusting changepoint
    re-leveling.  All thresholds are robust-z units (MAD sigmas).
    """

    enabled: bool = False
    # gap/zero-run masking (data/quality.py's dead-feed semantics)
    zero_run_mask: bool = True
    zero_run_min: int = 14
    # MAD spike scoring + interpolation repair
    outlier_repair: bool = True
    outlier_threshold: float = 6.0
    outlier_window: int = 7
    # CUSUM level-shift detection (+ optional fit-tensor re-leveling)
    changepoints: bool = True
    changepoint_threshold: float = 8.0
    align_level_shifts: bool = False
    # holiday-effect regressors (data/holidays.py specs)
    holiday_regressors: bool = False
    holiday_calendar: str = "US"
    holiday_lower_window: int = 0
    holiday_upper_window: int = 0
    # spectral seasonality selection (engine/season.py)
    season_detect: bool = False
    season_max_lag: int = 400
    season_min_score: float = 0.1
    season_default: int = 7

    def __post_init__(self):
        if self.zero_run_min < 2:
            raise ValueError(
                f"zero_run_min must be >= 2 (a single observed zero is "
                f"ordinary intermittent demand), got {self.zero_run_min}")
        if self.outlier_window < 1:
            raise ValueError(
                f"outlier_window must be >= 1, got {self.outlier_window}")
        if self.outlier_threshold <= 0 or self.changepoint_threshold <= 0:
            raise ValueError("outlier/changepoint thresholds must be > 0")
        if self.holiday_lower_window < 0 or self.holiday_upper_window < 0:
            raise ValueError("holiday windows must be >= 0")
        if self.season_max_lag < 4:
            raise ValueError(
                f"season_max_lag must be >= 4, got {self.season_max_lag}")

    @property
    def any_stage(self) -> bool:
        """True when at least one stage would do work: the all-gates-off
        short-circuit key."""
        return bool(self.zero_run_mask or self.outlier_repair
                    or self.changepoints or self.holiday_regressors
                    or self.season_detect)

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "AutoprepConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like outlier_treshold must not silently keep a default
            raise ValueError(
                f"unknown engine.autoprep conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


_active_config = AutoprepConfig()


def configure_autoprep(conf) -> AutoprepConfig:
    """Install the process-wide autoprep config (``tasks/common`` parses the
    ``engine.autoprep`` conf block into this).  Accepts a dict or an
    :class:`AutoprepConfig`; returns the installed config."""
    global _active_config
    cfg = conf if isinstance(conf, AutoprepConfig) \
        else AutoprepConfig.from_conf(conf)
    _active_config = cfg
    return cfg


def autoprep_config() -> AutoprepConfig:
    return _active_config


@dataclasses.dataclass
class PrepReport:
    """What autoprep did to one batch, per series, and per point for
    repairs.  Arrays are host numpy: the inspectability artifact."""

    config: AutoprepConfig
    n_series: int
    n_time: int
    masked_zero_cells: np.ndarray     # (S,) cells dropped by zero-run mask
    outlier_score: np.ndarray         # (S, T) robust spike z per point
    outlier_scale: np.ndarray         # (S,) MAD residual scale
    repaired: np.ndarray              # (S, T) bool: repaired in fit tensor
    repair_value: np.ndarray          # (S, T) value used where repaired
    cp_index: np.ndarray              # (S,) int split cell, -1 = none
    cp_shift: np.ndarray              # (S,) level shift (after - before)
    cp_score: np.ndarray              # (S,) CUSUM z-score
    season_length: Optional[int] = None
    holiday_names: Tuple[str, ...] = ()

    def summary(self) -> Dict:
        """Aggregates for ``run.log_metrics``."""
        return {
            "prep_masked_zero_cells": int(self.masked_zero_cells.sum()),
            "prep_repaired_points": int(self.repaired.sum()),
            "prep_series_repaired": int(self.repaired.any(axis=1).sum()),
            "prep_series_with_changepoint": int((self.cp_index >= 0).sum()),
            "prep_season_length": int(self.season_length or 0),
            "prep_holiday_regressors": len(self.holiday_names),
        }

    def to_frame(self, batch: SeriesBatch):
        """Per-series report rows for the ``prep_report.parquet`` run
        artifact: keys + what each stage found."""
        frame = batch.key_frame()
        frame["masked_zero_cells"] = self.masked_zero_cells.astype(np.int64)
        frame["repaired_points"] = self.repaired.sum(axis=1).astype(np.int64)
        frame["max_outlier_score"] = self.outlier_score.max(axis=1)
        frame["outlier_scale"] = self.outlier_scale
        frame["cp_index"] = self.cp_index.astype(np.int64)
        frame["cp_shift"] = self.cp_shift
        frame["cp_score"] = self.cp_score
        return frame

    def repairs_frame(self, batch: SeriesBatch):
        """Long frame of every repaired point: keys, ds, the original value
        (read from ``batch``, which must be the RAW batch), the repair, and
        its spike score."""
        import pandas as pd

        sidx, tidx = np.nonzero(self.repaired)
        keys = np.asarray(batch.keys)[sidx]
        dates = batch.dates()[tidx]
        y_raw = batch.y.cpu().numpy()[sidx, tidx]
        frame = pd.DataFrame(keys, columns=list(batch.key_names))
        frame["ds"] = dates
        frame["y_raw"] = y_raw
        frame["y_repaired"] = self.repair_value[sidx, tidx]
        frame["outlier_score"] = self.outlier_score[sidx, tidx]
        return frame


@dataclasses.dataclass(frozen=True)
class PrepResult:
    batch: SeriesBatch                # cleaned fit tensor (or the input)
    report: Optional[PrepReport]
    season_length: Optional[int]      # None unless season_detect found one
    xreg: Optional[torch.Tensor]      # (T+horizon, R) holiday indicators


def _autoprep_impl(y, mask, day_all, hol_days, *, zero_run_mask,
                   zero_run_min, outlier_repair, outlier_threshold,
                   outlier_window, changepoints, changepoint_threshold,
                   align_level_shifts, season_detect, acf_max_lag):
    """The prep program: every armed stage over the (S, T) batch."""
    S, T = y.shape
    dev = y.device
    mask_clean = mask
    dropped = torch.zeros((S, T), dtype=torch.bool, device=dev)
    if zero_run_mask:
        mask_clean, dropped = clean.mask_zero_runs(y, mask, zero_run_min)

    score = torch.zeros_like(y)
    scale = y.new_zeros((S,))
    repaired = torch.zeros((S, T), dtype=torch.bool, device=dev)
    y_clean = y
    if outlier_repair:
        score, scale = clean.mad_outlier_scores(y, mask_clean,
                                                outlier_window)
        flag = score > outlier_threshold
        y_clean, repaired = clean.interpolate_repair(y, mask_clean, flag)

    cp_index = torch.full((S,), -1, dtype=torch.int32, device=dev)
    cp_shift = y.new_zeros((S,))
    cp_score = y.new_zeros((S,))
    if changepoints:
        # detect on the REPAIRED tensor: a 30-sigma promo spike otherwise
        # dominates the cumsum statistic and masquerades as a level shift
        cp_index, cp_shift, cp_score = clean.cusum_level_shift(
            y_clean, mask_clean, changepoint_threshold)
        if align_level_shifts:
            y_clean = clean.align_level_shift(
                y_clean, mask_clean, cp_index, cp_shift)

    if season_detect:
        # the batch mean over non-empty rows only
        r, nonempty = acf_scores_per_series(y_clean, mask_clean, acf_max_lag)
        w = nonempty.to(y.dtype)
        acf = torch.sum(r * w[:, None], dim=0) / torch.clamp_min(
            torch.sum(w), 1.0)
    else:
        acf = y.new_zeros((1,))

    hol = clean.holiday_indicators(day_all, hol_days)
    return (y_clean, mask_clean, dropped, score, scale, repaired,
            cp_index, cp_shift, cp_score, acf, hol)


def _holiday_days_array(batch: SeriesBatch, horizon: int,
                        config: AutoprepConfig,
                        spec=None) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Resolve the holiday spec over the batch grid + horizon into the
    padded (R, Dmax) int32 day array the program broadcasts against.
    ``spec`` overrides; otherwise the config's named calendar is resolved
    over the grid's date range."""
    if spec is None:
        dates = batch.dates()
        end = dates[-1] + (dates[-1] - dates[0]) / max(len(dates) - 1, 1) \
            * horizon
        spec = holiday_spec_for_range(
            dates[0], end, calendar=config.holiday_calendar,
            lower_window=config.holiday_lower_window,
            upper_window=config.holiday_upper_window)
    names = tuple(name for name, _ in spec)
    if not names:
        return np.zeros((0, 1), np.int32), ()
    dmax = max(len(days) for _, days in spec)
    out = np.full((len(names), dmax), -1, np.int32)
    for i, (_, days) in enumerate(spec):
        out[i, : len(days)] = np.asarray(days, np.int32)
    return out, names


def autoprep_batch(
    batch: SeriesBatch,
    config: Optional[AutoprepConfig] = None,
    horizon: int = 0,
    holiday_spec=None,
) -> PrepResult:
    """Run the armed prep stages over ``batch`` on its device.

    Returns a :class:`PrepResult`; when the config is disabled or every
    stage gate is off, ``result.batch is batch``.  ``horizon`` extends the
    holiday regressor grid past history, so the same matrix serves fit AND
    forecast (the xreg contract of ``fit_forecast``).
    """
    cfg = config if config is not None else autoprep_config()
    if not cfg.enabled or not cfg.any_stage:
        return PrepResult(batch=batch, report=None, season_length=None,
                          xreg=None)
    T = batch.n_time
    dev = batch.y.device
    if cfg.holiday_regressors:
        hol_days, hol_names = _holiday_days_array(batch, horizon, cfg,
                                                  holiday_spec)
    else:
        hol_days, hol_names = np.zeros((0, 1), np.int32), ()
    day0 = int(batch.day[0])
    day_all = torch.arange(day0, day0 + T + horizon, dtype=torch.int32,
                           device=dev)
    acf_max_lag = clamp_max_lag(cfg.season_max_lag, T) \
        if cfg.season_detect else 1

    (y_clean, mask_clean, dropped, score, scale, repaired, cp_index,
     cp_shift, cp_score, acf, hol) = _autoprep_impl(
        batch.y, batch.mask, day_all,
        torch.as_tensor(hol_days, device=dev),
        zero_run_mask=cfg.zero_run_mask, zero_run_min=cfg.zero_run_min,
        outlier_repair=cfg.outlier_repair,
        outlier_threshold=cfg.outlier_threshold,
        outlier_window=cfg.outlier_window, changepoints=cfg.changepoints,
        changepoint_threshold=cfg.changepoint_threshold,
        align_level_shifts=cfg.align_level_shifts,
        season_detect=cfg.season_detect, acf_max_lag=acf_max_lag)

    season_length = None
    if cfg.season_detect and acf_max_lag >= 4:
        season_length = select_period(
            acf.cpu().numpy(), acf_max_lag, default=cfg.season_default,
            min_score=cfg.season_min_score)

    xreg = None
    if cfg.holiday_regressors and len(hol_names):
        xreg = hol

    rep_mask = repaired.cpu().numpy()
    report = PrepReport(
        config=cfg, n_series=batch.n_series, n_time=T,
        masked_zero_cells=torch.sum(dropped, dim=1).cpu().numpy(),
        outlier_score=score.cpu().numpy(),
        outlier_scale=scale.cpu().numpy(),
        repaired=rep_mask,
        repair_value=np.where(rep_mask, y_clean.cpu().numpy(), 0.0),
        cp_index=cp_index.cpu().numpy(),
        cp_shift=cp_shift.cpu().numpy(),
        cp_score=cp_score.cpu().numpy(),
        season_length=season_length,
        holiday_names=hol_names,
    )
    clean_batch = dataclasses.replace(batch, y=y_clean, mask=mask_clean)
    return PrepResult(batch=clean_batch, report=report,
                      season_length=season_length, xreg=xreg)
