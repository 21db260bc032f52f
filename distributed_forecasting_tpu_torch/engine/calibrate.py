"""Split-conformal calibration of forecast intervals from CV residuals (port
of the reference's ``engine/calibrate.py``).

The rolling-origin CV forecasts (``engine/cv``) are the calibration set and
the model's own upper half-band is the conformity scale, so the calibrated
interval is the parametric one multiplied per series by the smallest factor
that would have covered ``interval_width`` of the CV residuals.  Series with
too few scored CV points take the quantile pooled over every series.

Everything runs on the paths' device as tensor reductions — a sort per
series, one pooled sort, and gathers at ranks computed on the device — with
no host sync, so the CV pass that feeds it waits for nothing extra.
"""

from __future__ import annotations

from typing import Optional

import torch

from distributed_forecasting_tpu_torch.engine.cv import (
    CVConfig,
    _cv_entry,
    _cv_paths,
    cutoff_indices,
)

_EPS = 1e-9


def _conformal_rank(n: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """The finite-sample conformal rank ``ceil((n + 1) * width) - 1``,
    clipped to [0, max(n - 1, 0)], in the reference's float32 arithmetic:
    ``n`` float32 counts, ``width`` the interval width rounded to float32
    (0.95 is 0.949999988...).  Returns int64 ranks, on n's device."""
    k = torch.ceil((n + 1.0) * width).to(torch.int32) - 1
    hi = torch.clamp_min(n.to(torch.int32) - 1, 0)
    return torch.minimum(torch.clamp_min(k, 0), hi).to(torch.int64)


def conformal_scale_from_paths(y, yhat, hi, eval_masks,
                               interval_width: float = 0.95,
                               min_points: int = 30) -> torch.Tensor:
    """Per-series interval scale factors (S,) from (C, S, T) CV paths.

    Score r = |y - yhat| / (hi - yhat): the residual in units of the
    model's upper half-band.  A point scores only where it is observed in
    the eval window and its band is not degenerate (hi - yhat above 1e-6 of
    |yhat|); every other point scores inf and sorts last.  The scale is the
    ``ceil((n + 1) * width)``-th order statistic of a series' n scores; a
    series with fewer than ``min_points`` takes the pooled order statistic
    over every series' scores, and a non-finite result (no scores at all)
    is 1, the identity.
    """
    half = hi - yhat
    obs = (eval_masks > 0) & (half > 1e-6 * (yhat.abs() + _EPS))
    r = (y[None] - yhat).abs() / torch.clamp_min(half, _EPS)     # (C, S, T)
    r = torch.where(obs, r, torch.inf)
    S = r.shape[1]
    # series-major: each series' C*T scores in one row (the paths are
    # cutoff-major, so transpose before the reshape)
    r_s = torch.sort(r.transpose(0, 1).reshape(S, -1), dim=1).values
    n = torch.sum(obs, dim=(0, 2)).to(torch.float32)             # (S,)
    # a fill, not a copy from the host: no sync
    width = torch.full((), interval_width, dtype=torch.float32,
                       device=r.device)
    k = _conformal_rank(n, width)
    q = torch.gather(r_s, 1, k[:, None])[:, 0]

    # pooled fallback for thin series
    r_all = torch.sort(r_s.reshape(-1)).values
    n_tot = torch.sum(n)
    k_tot = _conformal_rank(n_tot, width)
    q_pool = torch.take(r_all, k_tot)
    q = torch.where(n >= min_points, q, q_pool)
    # no calibration data at all (or an infinite quantile): identity
    return torch.where(torch.isfinite(q) & (n_tot > 0), q, 1.0)


def conformal_scale_work(C: int, S: int, T: int) -> tuple:
    """(float32 operations, bytes) of :func:`conformal_scale_from_paths`'s
    least work: y (S, T) and yhat, hi, eval_masks (C, S, T) read once, the
    (S,) scale written once; about eight operations a point to score it
    (the comparison network of a sort is not counted)."""
    return 8 * C * S * T, 4 * (S * T + 3 * C * S * T + S)


def config_interval_width(config) -> float:
    """The width a config's bands target."""
    return float(getattr(config, "interval_width", 0.95))


def conformal_interval_scale(
    batch,
    model: str = "prophet",
    config=None,
    cv: CVConfig = CVConfig(),
    xreg=None,
    min_points: int = 30,
) -> torch.Tensor:
    """Standalone entry: run the rolling-origin CV pass and return the (S,)
    conformal scale for ``config.interval_width``.  Prefer
    ``cross_validate(..., calibrate=True)`` when CV metrics are computed
    anyway."""
    config, xreg = _cv_entry(batch, model, config, xreg,
                             "conformal_interval_scale")
    cuts = cutoff_indices(batch.n_time, cv)
    yhat, _, hi, eval_masks, _ = _cv_paths(batch, model, config, cuts,
                                           cv.horizon, xreg)
    return conformal_scale_from_paths(
        batch.y, yhat, hi, eval_masks,
        interval_width=config_interval_width(config), min_points=min_points)


def apply_interval_scale(yhat, lo, hi, scale: Optional[torch.Tensor],
                         floor: Optional[float] = None):
    """Widen (or tighten) both half-bands around the point path:
    lo' = yhat - s (yhat - lo), hi' = yhat + s (hi - yhat).  ``None`` is the
    identity.  ``floor`` re-applies a family's hard lower clamp after
    widening (``ModelFns.band_floor``)."""
    if scale is None:
        return yhat, lo, hi
    s = scale[:, None]
    lo2 = yhat - s * (yhat - lo)
    hi2 = yhat + s * (hi - yhat)
    if floor is not None:
        lo2 = torch.clamp_min(lo2, floor)
    return yhat, lo2, hi2
