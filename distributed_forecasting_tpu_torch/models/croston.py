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
summed over the fitted path after it.  Each step is :func:`_croston_step`
or :func:`_tsb_step`, which streaming ingest's :func:`update_state` runs
over new days too.
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


def _croston_step(z, p, q, ay, mt, demand, keep, alpha: float,
                  variant: str, out):
    """One Croston / SBA step on (S,) lanes: writes the one-step rate into
    ``out`` and returns ``(z', p', q')``.  ``ay`` is ``alpha * y``,
    ``demand`` the step's demand flag, ``keep`` 0 at a demand and 1 else
    (``q * keep`` restarts the interval count as ``where(demand, 0, q)``
    does, exactly: q is a finite count).  The fit's loop and
    :func:`update_state` both step through here, so a streamed state is
    the fit's bit for bit."""
    if variant == "sba":
        rate = z / torch.clamp_min(p, 1.0)
        torch.mul(rate, 1.0 - alpha / 2.0, out=out)
    else:
        torch.div(z, torch.clamp_min(p, 1.0), out=out)
    q_new = q + mt  # observed periods since the last demand
    z = torch.where(demand, ay + (1 - alpha) * z, z)
    p = torch.where(demand, alpha * q_new + (1 - alpha) * p, p)
    return z, p, q_new * keep


def _tsb_step(z, b, ay, b_in, observed, demand, alpha: float, beta: float,
              out):
    """One TSB step on (S,) lanes: writes the one-step rate ``z * b`` into
    ``out`` and returns ``(z', b')``.  The probability moves every observed
    period (``b_in`` is ``beta * 1[demand]``), the size only at demands;
    shared by the fit and :func:`update_state` as :func:`_croston_step`
    is."""
    torch.mul(z, b, out=out)
    b = torch.where(observed, b_in + (1 - beta) * b, b)
    z = torch.where(demand, ay + (1 - alpha) * z, z)
    return z, b


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
            z, b = _tsb_step(z, b, ay[t], b_in[t], observed[t], d_t[t], a,
                             bta, out=path[t])
        p = 1.0 / torch.clamp_min(b, _EPS)
    else:
        m_t = mask.t().contiguous()
        # 0 at a demand, else 1: q * keep restarts the interval count as
        # where(demand, 0, q) does, exactly (q is a finite count)
        keep = (~d_t).to(y.dtype)
        p = n_obs / n_demands
        q = torch.zeros_like(p)
        for t in range(T):
            z, p, q = _croston_step(z, p, q, ay[t], m_t[t], d_t[t], keep[t],
                                    a, config.variant, out=path[t])
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


def update_state(params: CrostonParams, aux, y_new, mask_new, valid,
                 day_new, config: CrostonConfig, day0=None):
    """Continue the Croston / SBA / TSB filter over appended day-columns
    (the streaming update; ``models/base.ModelFns.update_state``).

    Each real column runs :func:`_croston_step` or :func:`_tsb_step` on the
    fit's per-step inputs (``alpha * y``, the demand flag, ``keep``,
    ``beta * 1[demand]``, formed as the fit forms them), so the state
    continues the fit's bit for bit.  The carries the fit does not keep
    live in aux: ``q`` (Croston / SBA periods since the last demand) and
    ``b`` (TSB's demand probability; params keep only 1/b).  aux keeps both
    keys whatever the variant.  Padding columns (``valid`` 0) are skipped,
    as the reference's ``mask * valid == 0`` steps keep the carry.
    ``day0`` is unused: the recursion has no calendar."""
    _check_variant(config)
    a = config.alpha
    cols, days = streamed_columns(valid, day_new)
    S, K = y_new.shape
    preds = y_new.new_zeros(S, K)
    z, p, q, b = params.z_level, params.p_level, aux["q"], aux["b"]
    sse, n = aux["sse"], aux["n_obs"]
    demand = (y_new > _EPS) & (mask_new > 0)
    ay = a * y_new
    if config.variant == "tsb":
        bta = config.beta
        b_in = torch.where(demand, bta * 1.0, 0.0)
        observed = mask_new > 0
        for j in cols:
            z, b = _tsb_step(z, b, ay[:, j], b_in[:, j], observed[:, j],
                             demand[:, j], a, bta, out=preds[:, j])
        if cols:
            p = 1.0 / torch.clamp_min(b, _EPS)
    else:
        keep = (~demand).to(y_new.dtype)
        for j in cols:
            z, p, q = _croston_step(z, p, q, ay[:, j], mask_new[:, j],
                                    demand[:, j], keep[:, j], a,
                                    config.variant, out=preds[:, j])
    for j in cols:
        err = (y_new[:, j] - preds[:, j]) * mask_new[:, j]
        sse = sse + err * err
        n = n + mask_new[:, j]
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
