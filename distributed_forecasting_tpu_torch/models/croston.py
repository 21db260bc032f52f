"""Batched Croston / SBA / TSB intermittent-demand forecasting (port of the
reference's ``models/croston.py``).

Croston's method smooths demand sizes and inter-demand intervals separately
with SES and forecasts their ratio; SBA multiplies the ratio by the
(1 - alpha/2) bias correction.  TSB (Teunter-Syntetos-Babai) smooths the
demand *probability* every observed period instead, so a run of zero days
decays the forecast toward zero where Croston/SBA freeze at the last rate.

The recurrence runs in :func:`ops.ses.croston_filter`: one launch of a
hand-written CUDA kernel a fit, a CV pass or a streaming update on the
card, its plain twin (a Python loop over T of elementwise steps on the (S,)
carries) on the CPU.  The fit and :func:`update_state` run the same step,
so a streamed state continues the fit's bit for bit.  The squared one-step
errors of the fit are summed over its fitted path after the filter.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_forecasting_tpu_torch.models.base import (
    _ndtri,
    advance_t_fit_end,
    gaussian_quantiles,
    history_splice,
    register_model,
    streamed_columns,
)
from distributed_forecasting_tpu_torch.ops import ses
from distributed_forecasting_tpu_torch.ops.ses import croston_filter

_EPS = 1e-6


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
    ses._check_variant(config.variant)


def initial_carry(y, mask, variant: str) -> tuple:
    """The fit's initial carries for y, mask (S, T): the mean demand size
    and, for Croston / SBA, the mean interval and a zero period count
    ``(z, p, q)``; for TSB the demand probability ``(z, b)``."""
    demand = (y > _EPS) & (mask > 0)                      # (S, T)
    n_demands = torch.clamp_min(demand.sum(1).to(torch.float32), 1.0)
    z = torch.where(demand, y, 0.0).sum(1) / n_demands    # (S,)
    n_obs = torch.clamp_min(mask.sum(1), 1.0)
    if variant == "tsb":
        return z, n_demands / n_obs
    return z, n_obs / n_demands, torch.zeros_like(z)


def fit(y, mask, day, config: CrostonConfig) -> CrostonParams:
    """Fit every series at once.  y, mask: (S, T); day: (T,)."""
    _check_variant(config)
    carry = initial_carry(y, mask, config.variant)
    # time-major copies: each step reads and writes one contiguous row
    path, carry, _ = croston_filter(
        y.t().contiguous(), mask.t().contiguous(), carry, config.alpha,
        config.variant, config.beta)
    z, p = carry[0], carry[1]
    if config.variant == "tsb":
        p = 1.0 / torch.clamp_min(p, _EPS)
    fitted = path.t().contiguous()
    err = (y - fitted) * mask
    sigma = torch.sqrt(torch.sum(err * err, dim=1)
                       / torch.clamp_min(mask.sum(1), 1.0))
    return CrostonParams(
        z_level=z, p_level=p, sigma=sigma, fitted=fitted,
        day0=day[0].to(torch.float32), t_fit_end=day[-1].to(torch.float32),
    )


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


def update_state(params: CrostonParams, aux, y_new, mask_new, valid,
                 day_new, config: CrostonConfig, day0=None):
    """Continue the Croston / SBA / TSB filter over appended day-columns
    (the streaming update; ``models/base.ModelFns.update_state``).

    The real columns go through :func:`ops.ses.croston_filter` in one call,
    from the carries and the running (sse, n_obs): the filter forms the
    per-step inputs as the fit does, so the state continues the fit's bit
    for bit.  The carries the fit does not keep live in aux: ``q`` (Croston
    / SBA periods since the last demand) and ``b`` (TSB's demand
    probability; params keep only 1/b).  aux keeps both keys whatever the
    variant.  Padding columns (``valid`` 0) are skipped, as the reference's
    ``mask * valid == 0`` steps keep the carry.  ``day0`` is unused: the
    recursion has no calendar."""
    _check_variant(config)
    cols, days = streamed_columns(valid, day_new)
    S, K = y_new.shape
    preds = y_new.new_zeros(S, K)
    z, p, q, b = params.z_level, params.p_level, aux["q"], aux["b"]
    sse, n = aux["sse"], aux["n_obs"]
    if cols:
        take = torch.as_tensor(cols, dtype=torch.long).to(y_new.device)
        tsb = config.variant == "tsb"
        carry = (z, b) if tsb else (z, p, q)
        path, carry, (sse, n) = croston_filter(
            y_new[:, take].t().contiguous(),
            mask_new[:, take].t().contiguous(),
            tuple(c.contiguous() for c in carry), config.alpha,
            config.variant, config.beta,
            sums=(sse.contiguous(), n.contiguous()))
        preds[:, take] = path.t()
        if tsb:
            z, b = carry
            p = 1.0 / torch.clamp_min(b, _EPS)
        else:
            z, p, q = carry
    sigma = torch.sqrt(sse / torch.clamp_min(n, 1.0))
    params2 = dataclasses.replace(
        params, z_level=z, p_level=p, sigma=sigma,
        t_fit_end=advance_t_fit_end(params.t_fit_end, days))
    return params2, {"sse": sse, "n_obs": n, "q": q, "b": b}, preds


def init_update_aux(params: CrostonParams, y=None, mask=None):
    """The carries the fit does not keep in params.

    With (y, mask): ``q`` is the count of observed periods after the last
    demand (exact in float32: 0/1 sums); without, 0 (as if a demand closed
    the training window).  ``b`` is ``1 / max(p_level, eps)``: unused by
    Croston / SBA and a reciprocal round trip for TSB, after which aux
    carries it exactly.  (sse, n_obs) as in the other families."""
    dev = params.sigma.device
    if mask is not None:
        maskf = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        n = maskf.sum(1)
    else:
        maskf = None
        n = torch.full_like(params.sigma, float(params.fitted.shape[1]))
    sse = params.sigma**2 * torch.clamp_min(n, 1.0)
    b = 1.0 / torch.clamp_min(params.p_level, _EPS)
    if y is not None and maskf is not None:
        yf = torch.as_tensor(y, dtype=torch.float32, device=dev)
        nz = ((yf > _EPS) & (maskf > 0)).to(torch.float32)
        # the positions after the last demand are those whose reversed
        # running count of demands is still 0
        trailing = (torch.cumsum(nz.flip(1), dim=1) == 0).to(torch.float32)
        q = torch.sum(maskf.flip(1) * trailing, dim=1)
    else:
        q = torch.zeros_like(params.sigma)
    return {"sse": sse, "n_obs": n, "q": q, "b": b}


register_model("croston", fit, forecast, CrostonConfig,
               forecast_quantiles=gaussian_quantiles(forecast, floor=0.0),
               band_floor=0.0,
               update_state=update_state, init_update_aux=init_update_aux)
