"""Design-matrix construction for the curve model (port of the reference's
``ops/features.py``).

The batch shares one absolute day grid, so every feature is a function of
the day number only: one (T, F) design serves all series, and the per-series
work is one batched penalized least-squares solve (``ops/solve.py``).

Float32 arguments are kept bitwise equal to the reference's where the
reference computes inside ``jit``: there XLA turns a division by a constant
(a Fourier period, the changepoint grid's ``n + 1``) into a multiplication
by the constant's float32 reciprocal, folding constant factors into one,
and the port multiplies the same way.  That matters for the Fourier
columns: their angles are ~1e3-1e5 rad on absolute epoch days, where one
float32 ulp of the angle moves ``sin`` by up to 4e-3; with equal angles
only the ``sin``/``cos`` implementations differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WEEK_PERIOD = 7.0
YEAR_PERIOD = 365.25


def _f32_reciprocal(c: float) -> np.float32:
    """``1 / c`` rounded to float32 from the float32 value of ``c`` — the
    constant XLA multiplies by where the reference divides by ``c``."""
    return np.float32(1.0) / np.float32(c)


def scaled_time(day: torch.Tensor, t0, t1) -> torch.Tensor:
    """Absolute day numbers mapped onto [0, 1] over the training span
    (the global span, so changepoint sites are comparable across series).
    ``t0``/``t1`` are scalars, or (S, 1) columns for per-row spans."""
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=day.device)
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=day.device)
    return (day.to(torch.float32) - t0) / torch.clamp_min(t1 - t0, 1.0)


def fourier_features(day: torch.Tensor, period: float, order: int) -> torch.Tensor:
    """(T, 2*order) matrix of [sin, cos] harmonics of ``period``, angles
    ``2π · k · t / period`` in the reference's order of operations."""
    t = day.to(torch.float32)
    k = torch.arange(1, order + 1, dtype=torch.float32, device=day.device)
    ang = (np.float32(2.0 * math.pi) * k[None, :] * t[:, None]
           * _f32_reciprocal(period))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def changepoint_features(t_scaled: torch.Tensor, n_changepoints: int,
                         changepoint_range: float = 0.8):
    """Hinge basis ``max(0, t - s_k)`` on a uniform grid of
    ``n_changepoints`` sites over the first ``changepoint_range`` of the
    span (Prophet's default: 25 over the first 80%).  Returns (A (T, K),
    s (K,))."""
    # the reference's ``k / (K + 1) * range``, as XLA folds it: one float32
    # constant ``range * (1 / (K + 1))`` times k
    step = np.float32(changepoint_range) * _f32_reciprocal(n_changepoints + 1)
    s = torch.arange(1, n_changepoints + 1, dtype=torch.float32,
                     device=t_scaled.device) * step
    A = torch.clamp_min(t_scaled[:, None] - s[None, :], 0.0)
    return A, s


def holiday_features(day: torch.Tensor, holidays: tuple) -> torch.Tensor:
    """(T, H) indicator columns, one per named holiday of the static spec
    ``((name, (epoch_day, ...)), ...)``: 1 on every occurrence (all years
    share one coefficient, like Prophet's holiday regressors)."""
    # all occurrences and their column in one host-to-device copy (each
    # copy waits for the device's queue); a holiday's days are distinct, so
    # summing its matches gives the 0/1 indicator
    pairs = np.array([(d, h) for h, (_name, days) in enumerate(holidays)
                      for d in days], dtype=np.int64).reshape(-1, 2)
    pairs = torch.as_tensor(pairs, device=day.device)
    hit = (day.to(torch.int64)[:, None] == pairs[None, :, 0]).to(torch.float32)
    cols = torch.zeros((day.shape[0], len(holidays)), dtype=torch.float32,
                       device=day.device)
    return cols.index_add_(1, pairs[:, 1], hit)


def conditional_seasonality_columns(day: torch.Tensor, period: float,
                                    order: int, condition) -> torch.Tensor:
    """Prophet's ``add_seasonality(condition_name=...)`` as regressor
    columns: the Fourier block zeroed where the boolean ``condition`` (one
    0/1 value per grid day, history + horizon) is false.  Feed the result as
    ``xreg`` with ``CurveModelConfig(n_regressors=2*order,
    regressor_standardize=False)``; the block is then regularized by
    ``regressor_prior_scale``.  Returns (T, 2*order)."""
    cvals = np.asarray(condition)
    if cvals.shape != (int(day.shape[0]),):
        raise ValueError(
            f"condition must be one value per grid day ({int(day.shape[0])},), "
            f"got {cvals.shape}"
        )
    if not np.isin(cvals, (0, 1)).all():
        raise ValueError(
            "condition must be boolean/0-1 per day (a fractional value "
            "would scale the seasonality instead of gating it)"
        )
    cond = torch.as_tensor(cvals.astype(np.float32), device=day.device)
    return fourier_features(day, float(period), int(order)) * cond[:, None]


def with_regressors(X: torch.Tensor, layout: dict, xreg: torch.Tensor):
    """Append exogenous-regressor columns (already standardized) to the
    design: ``xreg`` (T, R) shared, or (S, T, R) per series, which makes the
    result an (S, T, F + R) per-series design.  Returns (X', layout') with a
    ``regressors`` slice in the layout."""
    R = xreg.shape[-1]
    F = layout["n_features"]
    new_layout = dict(layout)
    new_layout["regressors"] = slice(F, F + R)
    new_layout["n_features"] = F + R
    if xreg.dim() == 3 and X.dim() == 2:
        X = X[None].expand((xreg.shape[0],) + tuple(X.shape))
    return torch.cat([X, xreg], dim=-1), new_layout


def curve_design_matrix(
    day: torch.Tensor,
    t0,
    t1,
    n_changepoints: int = 25,
    weekly_order: int = 3,
    yearly_order: int = 10,
    changepoint_range: float = 0.8,
    holidays: tuple = (),
    extra_seasonalities: tuple = (),
    changepoint_days: tuple = (),
):
    """Full (T, F) design and its layout.

    Columns: [1, t, hinge_1..K, weekly sin/cos, yearly sin/cos, extra
    seasonality blocks, holiday indicators].  ``extra_seasonalities`` are
    ``((name, period_days, fourier_order), ...)``, each with a
    ``seas_<name>`` slice; ``changepoint_days`` (epoch days) replace the
    uniform hinge grid when non-empty.
    """
    t = scaled_time(day, t0, t1)
    if changepoint_days:
        s = scaled_time(torch.as_tensor(sorted(changepoint_days),
                                        device=day.device), t0, t1)
        A = torch.clamp_min(t[:, None] - s[None, :], 0.0)
        k = len(changepoint_days)
    else:
        A, s = changepoint_features(t, n_changepoints, changepoint_range)
        k = n_changepoints
    cols = [torch.ones_like(t)[:, None], t[:, None], A]
    n_fixed = 2
    n_wk = 2 * weekly_order if weekly_order else 0
    n_yr = 2 * yearly_order if yearly_order else 0
    if weekly_order:
        cols.append(fourier_features(day, WEEK_PERIOD, weekly_order))
    if yearly_order:
        cols.append(fourier_features(day, YEAR_PERIOD, yearly_order))
    extra_slices = {}
    pos = n_fixed + k + n_wk + n_yr
    for name, period, order in extra_seasonalities:
        order = int(order)
        cols.append(fourier_features(day, float(period), order))
        extra_slices[f"seas_{name}"] = slice(pos, pos + 2 * order)
        pos += 2 * order
    n_hol = len(holidays)
    if n_hol:
        cols.append(holiday_features(day, holidays))
    X = torch.cat(cols, dim=1)
    base = pos
    layout = {
        "intercept": slice(0, 1),
        "slope": slice(1, 2),
        "changepoints": slice(n_fixed, n_fixed + k),
        "weekly": slice(n_fixed + k, n_fixed + k + n_wk),
        "yearly": slice(n_fixed + k + n_wk, n_fixed + k + n_wk + n_yr),
        "extra_seas": slice(n_fixed + k + n_wk + n_yr, base),
        **extra_slices,
        "holidays": slice(base, base + n_hol),
        "n_features": base + n_hol,
        "changepoint_grid": s,
    }
    return X, layout
