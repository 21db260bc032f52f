"""Masked forecast-accuracy metrics as tensor reductions (port of the
reference's ``ops/metrics.py``: the functions behind ``compute_all`` and
``mase``, and the serving quality monitor's ``quality_terms``).

All functions take ``y, yhat: (..., T)`` and ``mask: (..., T)`` and reduce
the last axis.  Division guards keep fully-masked rows finite (0, not NaN)
for the ``METRIC_FNS`` set; ``mase`` returns NaN on a zero naive scale.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _mean(x, mask):
    n = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
    return torch.sum(x * mask, dim=-1) / n


def mse(y, yhat, mask):
    return _mean((y - yhat) ** 2, mask)


def rmse(y, yhat, mask):
    return torch.sqrt(mse(y, yhat, mask))


def mae(y, yhat, mask):
    return _mean(torch.abs(y - yhat), mask)


def mape(y, yhat, mask):
    """Mean absolute percentage error; near-zero actuals are masked out."""
    nz = torch.abs(y) > _EPS
    ok = mask * nz
    return _mean(torch.abs((y - yhat) / torch.where(nz, y, 1.0)), ok)


def smape(y, yhat, mask):
    denom = (torch.abs(y) + torch.abs(yhat)) / 2.0
    ok = mask * (denom > _EPS)
    return _mean(torch.abs(y - yhat) / torch.clamp_min(denom, _EPS), ok)


def masked_median(x, valid):
    """Median over the last axis of the entries where ``valid`` > 0; 0.0 for
    an all-invalid row (sort with +inf sentinels, index the valid middle)."""
    xv = torch.where(valid > 0, x, torch.inf)
    s = torch.sort(xv, dim=-1).values
    n = torch.sum(valid > 0, dim=-1)
    last = x.shape[-1] - 1
    hi = torch.clamp((n - 1) // 2 + (n - 1) % 2, 0, last)
    lo = torch.clamp((n - 1) // 2, 0, last)
    med = (
        torch.gather(s, -1, lo[..., None]) + torch.gather(s, -1, hi[..., None])
    )[..., 0] / 2.0
    return torch.where(n > 0, med, 0.0)


def mdape(y, yhat, mask):
    """Median absolute percentage error under the mask."""
    nz = torch.abs(y) > _EPS
    ape = torch.abs((y - yhat) / torch.where(nz, y, 1.0))
    return masked_median(ape, mask * nz)


# per-cadence seasonal-naive lag for MASE (M4 convention): daily grids score
# against the weekly naive, weekly against the 1-step naive, monthly against
# last year's month
MASE_LAGS = {"D": 7, "W": 1, "M": 12}


def seasonal_naive_lag(freq: str = "D") -> int:
    return MASE_LAGS.get(freq, 1)


def mase(y, yhat, eval_mask, train_mask, m: int = 7):
    """Mean absolute scaled error: eval-window MAE over the seasonal-naive
    MAE on the training window (lag ``m`` grid steps); NaN where the naive
    scale is zero."""
    dy = torch.abs(y[..., m:] - y[..., :-m])
    both = train_mask[..., m:] * train_mask[..., :-m]
    scale = torch.sum(dy * both, dim=-1) / torch.clamp_min(
        torch.sum(both, dim=-1), 1.0
    )
    mae_eval = _mean(torch.abs(y - yhat), eval_mask)
    return torch.where(scale > _EPS, mae_eval / torch.clamp_min(scale, _EPS),
                       torch.nan)


def coverage(y, lo, hi, mask):
    """Fraction of actuals inside [lo, hi]."""
    inside = ((y >= lo) & (y <= hi)).to(y.dtype)
    return _mean(inside, mask)


def quality_terms(y, yhat, lo, hi, step, mask):
    """Elementwise rolling-quality terms for ``monitoring/quality.py``, one
    batched pass over every observed series (reference
    ``ops/metrics.quality_terms``).

    All inputs are ``(..., T)`` tensors on one device: ``y``, ``yhat``,
    ``lo``, ``hi`` float32, ``step`` the integer period ordinal of each
    observation, ``mask`` bool.  Returns per-point float32 term tensors; the
    caller reduces them in float64 on the host, so the rolling sums neither
    drift nor depend on a device's reduction order.

    Terms: ``abs_err``/``abs_y`` (WAPE numerator/denominator), ``sq_err``
    (RMSSE numerator), ``inside`` (coverage of the served [lo, hi] band),
    ``n`` (observation count), ``naive_sq``/``naive_n`` (RMSSE denominator:
    squared one-step naive differences over consecutive observed periods).
    """
    m = mask & torch.isfinite(y) & torch.isfinite(yhat)
    mf = m.to(torch.float32)
    y0 = torch.where(m, y, 0.0)
    err = (y0 - torch.where(m, yhat, 0.0)) * mf
    inside = ((y0 >= lo) & (y0 <= hi)).to(torch.float32) * mf
    adj = (m[..., 1:] & m[..., :-1]
           & ((step[..., 1:] - step[..., :-1]) == 1))
    d = torch.where(adj, y0[..., 1:] - y0[..., :-1], 0.0)
    return {
        "abs_err": torch.abs(err),
        "abs_y": torch.abs(y0) * mf,
        "sq_err": err * err,
        "inside": inside,
        "n": mf,
        "naive_sq": d * d,
        "naive_n": adj.to(torch.float32),
    }


METRIC_FNS = {
    "mse": mse,
    "rmse": rmse,
    "mae": mae,
    "mape": mape,
    "smape": smape,
    "mdape": mdape,
}


def compute_all(y, yhat, mask, lo=None, hi=None) -> dict:
    out = {name: fn(y, yhat, mask) for name, fn in METRIC_FNS.items()}
    if lo is not None and hi is not None:
        out["coverage"] = coverage(y, lo, hi, mask)
    return out
