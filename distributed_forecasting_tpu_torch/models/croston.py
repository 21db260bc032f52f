"""Batched Croston / SBA / TSB intermittent-demand forecasting (port of the
reference's ``models/croston.py``).

Croston's method smooths demand sizes and inter-demand intervals separately
with SES and forecasts their ratio; SBA multiplies the ratio by the
(1 - alpha/2) bias correction.  TSB (Teunter-Syntetos-Babai) smooths the
demand *probability* every observed period instead, so a run of zero days
decays the forecast toward zero where Croston/SBA freeze at the last rate.

The recurrence is one Python loop over T, each step a dozen elementwise
launches on (S,) state vectors (seven for TSB), with no host sync: every
series advances at once.  The per-step demand flags and the ``alpha * y`` terms are computed
for the whole (S, T) grid before the loop; the squared one-step errors are
summed over the fitted path after it.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_forecasting_tpu_torch.models.base import (
    _ndtri,
    gaussian_quantiles,
    history_splice,
    register_model,
)

_EPS = 1e-6
_VARIANTS = ("croston", "sba", "tsb")


@dataclasses.dataclass(frozen=True)
class CrostonConfig:
    alpha: float = 0.1          # SES smoothing for sizes and intervals
    variant: str = "sba"        # 'croston' | 'sba' | 'tsb'
    # TSB only: smoothing rate of the demand-probability EWMA, updated every
    # observed period (sizes only at demand points)
    beta: float = 0.1
    interval_width: float = 0.95


@dataclasses.dataclass(frozen=True)
class CrostonParams:
    z_level: torch.Tensor    # (S,) smoothed demand size
    # (S,) smoothed inter-demand interval; for TSB the INVERSE smoothed
    # demand probability (1/b >= 1), so the shared rate z/p is TSB's z*b
    p_level: torch.Tensor
    sigma: torch.Tensor      # (S,) one-step residual std (demand-rate space)
    fitted: torch.Tensor     # (S, T) one-step-ahead fitted rates
    day0: torch.Tensor       # () first training day, float32
    t_fit_end: torch.Tensor  # () last training day, float32


def _rate(z, p, alpha: float, variant: str):
    rate = z / torch.clamp_min(p, 1.0)
    if variant == "sba":
        rate = rate * (1.0 - alpha / 2.0)
    return rate


def _check_variant(config: CrostonConfig) -> None:
    if config.variant not in _VARIANTS:
        raise ValueError(
            f"unknown CrostonConfig.variant {config.variant!r}; "
            f"'croston', 'sba', or 'tsb'"
        )


def fit(y, mask, day, config: CrostonConfig) -> CrostonParams:
    """Fit every series at once.  y, mask: (S, T); day: (T,)."""
    _check_variant(config)
    a = config.alpha
    S, T = y.shape
    demand = (y > _EPS) & (mask > 0)                      # (S, T)
    n_demands = torch.clamp_min(demand.sum(1).to(torch.float32), 1.0)
    z = torch.where(demand, y, 0.0).sum(1) / n_demands    # (S,)
    n_obs = torch.clamp_min(mask.sum(1), 1.0)
    # time-major copies: each step reads and writes one contiguous row
    ay = (a * y).t().contiguous()
    d_t = demand.t().contiguous()
    path = y.new_empty(T, S)
    if config.variant == "tsb":
        bta = config.beta
        # the probability's update term beta * 1[demand], for every step
        b_in = torch.where(d_t, bta * 1.0, 0.0)
        observed = (mask > 0).t().contiguous()
        b = n_demands / n_obs
        for t in range(T):
            torch.mul(z, b, out=path[t])
            b = torch.where(observed[t], b_in[t] + (1 - bta) * b, b)
            z = torch.where(d_t[t], ay[t] + (1 - a) * z, z)
        p = 1.0 / torch.clamp_min(b, _EPS)
    else:
        m_t = mask.t().contiguous()
        # 0 at a demand, else 1: q * keep restarts the interval count as
        # where(demand, 0, q) does, exactly (q is a finite count)
        keep = (~d_t).to(y.dtype)
        p = n_obs / n_demands
        q = torch.zeros_like(p)
        for t in range(T):
            if config.variant == "sba":
                rate = z / torch.clamp_min(p, 1.0)
                torch.mul(rate, 1.0 - a / 2.0, out=path[t])
            else:
                torch.div(z, torch.clamp_min(p, 1.0), out=path[t])
            q_new = q + m_t[t]  # observed periods since the last demand
            d = d_t[t]
            z = torch.where(d, ay[t] + (1 - a) * z, z)
            p = torch.where(d, a * q_new + (1 - a) * p, p)
            q = q_new * keep[t]
    fitted = path.t().contiguous()
    err = (y - fitted) * mask
    sigma = torch.sqrt(torch.sum(err * err, dim=1)
                       / torch.clamp_min(mask.sum(1), 1.0))
    return CrostonParams(
        z_level=z, p_level=p, sigma=sigma, fitted=fitted,
        day0=day[0].to(torch.float32), t_fit_end=day[-1].to(torch.float32),
    )


def fit_work(S: int, T: int) -> tuple:
    """(float32 operations, bytes) of :func:`fit`'s least work: y and mask
    read once, the (S, T) fitted path and the (S,) states written once;
    about twelve operations a step (rate, SBA factor, interval count, two
    smoothing updates, three selects, the squared error and its sum)."""
    return 12 * S * T, 4 * (3 * S * T + 3 * S)


def forecast(params: CrostonParams, day_all, t_end, config: CrostonConfig):
    """(yhat, lo, hi) over history + future days, each (S, T_all): the
    fitted path in history, the frozen rate after it; a constant band of
    the one-step sigma, its lower edge clamped at 0 (demand is
    non-negative).  ``t_end`` is unused: the band does not widen."""
    dayf = day_all.to(torch.float32)
    h = dayf - params.t_fit_end
    rate = _rate(params.z_level, params.p_level, config.alpha, config.variant)
    fut = rate[:, None].expand(rate.shape[0], day_all.shape[0])
    yhat = history_splice(params.fitted, fut, day_all, params.day0, h)
    z = _ndtri(0.5 + config.interval_width / 2.0, yhat.device)
    sd = params.sigma[:, None]
    lo = torch.clamp_min(yhat - z * sd, 0.0)
    hi = yhat + z * sd
    return yhat, lo, hi


register_model("croston", fit, forecast, CrostonConfig,
               forecast_quantiles=gaussian_quantiles(forecast, floor=0.0),
               band_floor=0.0)
