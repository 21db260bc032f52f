"""Batched Theta-method forecasting (port of the reference's
``models/theta.py``: fit, forecast and quantiles).

Hyndman & Billah (2003) showed the classic two-line Theta method is SES with
an added drift of half the linear-trend slope, which is how it is computed:

    1. multiplicative seasonal indices per slot of ``season_length``,
    2. weighted OLS trend ``a + b.t`` on the seasonally adjusted series (the
       theta = 0 line),
    3. SES on the theta line ``Z = th.y_sa + (1 - th).trend`` with a
       per-series smoothing constant picked from a grid by masked SSE,
    4. forecast = the ``1/th`` mix of the flat SES forecast and the trend
       line, reseasonalized.

The SES recursion is one Python loop over T on an (S, A) state, A the alpha
grid: each step is the masked SES step alone (a multiply, an add and a
select, no host sync), writing the one-step predictions into a preallocated
(T + 1, S, A) buffer.  The fitted paths, the SSEs, the argmin and sigma are
computed for every candidate after the loop, and the winner's path is
gathered from them (the reference runs the winner's SES a second time; the
gathered path is the same floats, element for element).  Streaming ingest
continues the selected alpha's SES over new days (:func:`update_state`)
through the same step, :func:`_ses_step`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_forecasting_tpu_torch.models.base import (
    _ndtri,
    advance_t_fit_end,
    first_day,
    gaussian_quantiles,
    history_splice,
    register_model,
    streamed_columns,
)

_EPS = 1e-6
# observed values the SES level starts from (their mean)
_HEAD = 7


@dataclasses.dataclass(frozen=True)
class ThetaConfig:
    theta: float = 2.0
    season_length: int = 7
    deseasonalize: bool = True
    alphas: tuple = (0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.8)
    interval_width: float = 0.95


@dataclasses.dataclass(frozen=True)
class ThetaParams:
    intercept: torch.Tensor  # (S,) trend intercept (seasonally adjusted space)
    slope: torch.Tensor      # (S,) trend slope per day
    level: torch.Tensor      # (S,) final SES level of the theta line
    alpha: torch.Tensor      # (S,) selected smoothing constant
    seas: torch.Tensor       # (S, m) multiplicative seasonal indices
    sigma: torch.Tensor      # (S,) one-step residual std (original space)
    fitted: torch.Tensor     # (S, T) one-step fitted values (original space)
    day0: torch.Tensor       # () first training day, float32
    t_fit_end: torch.Tensor  # () last training day, float32


def _seasonal_indices(y, mask, dow, m: int):
    """Masked multiplicative index per seasonal slot, normalized to mean 1:
    (S, m).  The slot sums are one (S, T) x (T, m) one-hot product (a
    deterministic GEMM, where ``index_add_`` would sum by atomics)."""
    onehot = torch.nn.functional.one_hot(dow, m).to(y.dtype)  # (T, m)
    slot_sum = (y * mask) @ onehot
    slot_cnt = torch.clamp_min(mask @ onehot, 1.0)
    slot_mean = slot_sum / slot_cnt
    overall = torch.sum(y * mask, dim=1) / torch.clamp_min(mask.sum(1), 1.0)
    idx = slot_mean / torch.clamp_min(overall[:, None], _EPS)
    idx = torch.where(idx > _EPS, idx, 1.0)
    return idx / torch.clamp_min(idx.mean(dim=1, keepdim=True), _EPS)


def _ses_step(level, az, observed, one_minus, out=None, carry=None):
    """One masked SES step on any lane shape: ``(1 - alpha) * level +
    alpha * z`` where observed, else ``level`` (whose value is the step's
    one-step prediction).  ``az`` is ``alpha * z`` and ``one_minus`` is
    ``1 - alpha``, formed by the caller.  :func:`ses_paths` (the fit, on
    (S, A) lanes) and :func:`update_state` (one alpha a row, on (S,)) both
    step through here, so a streamed level is the fit's bit for bit.
    ``out`` / ``carry`` are optional buffers for the result and the
    unmasked update."""
    carry = torch.mul(one_minus, level, out=carry)
    carry.add_(az)
    return torch.where(observed, carry, level, out=out)


def ses_paths(z, mask, alpha):
    """Masked SES of every row under every smoothing constant.

    ``z, mask``: (S, T); ``alpha``: (A,) shared or (S, A) per row.  Returns
    the (T + 1, S, A) buffer whose row t is the one-step prediction of step
    t (the level before it) and whose last row is the final level.  The
    level starts at the mean of each row's first seven *observed* values
    and moves only where ``mask > 0``.
    """
    S, T = z.shape
    alpha = torch.as_tensor(alpha, dtype=z.dtype, device=z.device)
    if alpha.dim() == 1:
        alpha = alpha[None, :]
    A = alpha.shape[1]
    alpha = alpha.expand(S, A)
    head = torch.where(torch.cumsum(mask, dim=1) <= _HEAD, mask, 0.0)
    l0 = (torch.sum(torch.where(mask > 0, z, 0.0) * head, dim=1)
          / torch.clamp_min(head.sum(1), 1.0))
    one_minus = 1.0 - alpha
    # time-major: each step reads and writes contiguous (S, A) slices
    az = alpha[None] * z.t()[:, :, None]                   # (T, S, A)
    observed = (mask > 0).t()[:, :, None]                  # (T, S, 1)
    buf = z.new_empty(T + 1, S, A)
    buf[0] = l0[:, None]
    carry = z.new_empty(S, A)
    for t in range(T):
        _ses_step(buf[t], az[t], observed[t], one_minus, out=buf[t + 1],
                  carry=carry)
    return buf


def ses_work(S: int, T: int, A: int) -> tuple:
    """(float32 operations, bytes) of :func:`ses_paths`' least work: z and
    mask read once, the (T + 1, S, A) buffer written once; four operations
    a (row, candidate, step): ``alpha * z``, ``(1 - alpha) * level``, the
    add and the select."""
    return 4 * S * A * T, 4 * (2 * S * T + S * A * (T + 1))


def _lines(y, mask, day, config: ThetaConfig):
    """The decomposition ahead of the SES: ``(seas, si, intercept, slope,
    trend, zline)`` — the (S, m) seasonal indices and their (S, T) path,
    the weighted OLS trend on the seasonally adjusted series (the theta = 0
    line) and the theta line ``th * y_sa + (1 - th) * trend``."""
    m = config.season_length
    dow = torch.remainder(day, m).to(torch.int64)           # (T,)
    if config.deseasonalize:
        seas = _seasonal_indices(y, mask, dow, m)           # (S, m)
    else:
        seas = y.new_ones(y.shape[0], m)
    si = seas[:, dow]                                       # (S, T)
    y_sa = y / torch.clamp_min(si, _EPS)

    t = (day - day[0]).to(y.dtype)                          # (T,)
    w = mask
    sw = torch.clamp_min(w.sum(1), 1.0)
    tm = torch.sum(w * t[None, :], dim=1) / sw
    ym = torch.sum(w * y_sa, dim=1) / sw
    tc = t[None, :] - tm[:, None]
    cov = torch.sum(w * tc * (y_sa - ym[:, None]), dim=1)
    var = torch.clamp_min(torch.sum(w * tc * tc, dim=1), _EPS)
    slope = cov / var
    intercept = ym - slope * tm

    trend = intercept[:, None] + slope[:, None] * t[None, :]  # (S, T)
    th = config.theta
    return seas, si, intercept, slope, trend, th * y_sa + (1.0 - th) * trend


def _candidates(y, mask, si, trend, zline, config: ThetaConfig):
    """Every alpha candidate's SES buffer (T + 1, S, A), fitted path
    (S, A, T) and masked SSE (S, A).  Inverting Z = th*y_sa + (1-th)*trend
    gives E[y_sa] = (1/th)*Z + (1-1/th)*trend (the classic 0.5/0.5 mean at
    th=2)."""
    alphas = torch.tensor(config.alphas, dtype=y.dtype, device=y.device)
    w_ses = 1.0 / config.theta
    buf = ses_paths(zline, mask, alphas)
    preds = buf[:-1].permute(1, 2, 0)                       # (S, A, T)
    fitted = (w_ses * preds + (1.0 - w_ses) * trend[:, None, :]) * si[
        :, None, :]
    err = (y[:, None, :] - fitted) * mask[:, None, :]
    return alphas, buf, fitted, torch.sum(err * err, dim=2)


def candidate_sses(y, mask, day, config: ThetaConfig) -> torch.Tensor:
    """(S, A) masked SSE of every alpha candidate; ``fit`` picks each
    row's argmin."""
    _, si, _, _, trend, zline = _lines(y, mask, day, config)
    return _candidates(y, mask, si, trend, zline, config)[3]


def fit(y, mask, day, config: ThetaConfig) -> ThetaParams:
    """Fit every series at once.  y, mask: (S, T); day: (T,)."""
    seas, si, intercept, slope, trend, zline = _lines(y, mask, day, config)
    alphas, buf, fitted, sses = _candidates(y, mask, si, trend, zline,
                                            config)
    k = torch.argmin(sses, dim=1)                           # (S,)
    rows = torch.arange(y.shape[0], device=y.device)
    n = torch.clamp_min(mask.sum(1), 1.0)
    return ThetaParams(
        intercept=intercept, slope=slope, level=buf[-1, rows, k],
        alpha=alphas[k], seas=seas, sigma=torch.sqrt(sses[rows, k] / n),
        fitted=fitted[rows, k],
        day0=day[0].to(torch.float32), t_fit_end=day[-1].to(torch.float32),
    )


def forecast(params: ThetaParams, day_all, t_end, config: ThetaConfig):
    """(yhat, lo, hi) over history + future days, each (S, T_all).

    The splice origin is the fit grid's end (inside a masked CV eval window
    the SES level is frozen, so the fitted path equals the future formula
    there); the band widens from ``t_end`` (a scalar, or one per row), where
    observations stop, with the SES h-step variance
    ``sigma^2 (1 + (h - 1) alpha^2)``."""
    m = config.season_length
    dev = params.level.device
    dayf = day_all.to(torch.float32)
    h = dayf - params.t_fit_end                             # > 0 past the grid
    t_end = torch.as_tensor(t_end, dtype=torch.float32,
                            device=dev).reshape(-1, 1)
    h_unc = dayf[None, :] - t_end                           # (1 or S, T_all)
    t = dayf - params.day0

    trend = params.intercept[:, None] + params.slope[:, None] * t[None, :]
    w_ses = 1.0 / config.theta
    fut_sa = w_ses * params.level[:, None] + (1.0 - w_ses) * trend
    dow = torch.remainder(day_all, m).to(torch.int64)
    fut = fut_sa * params.seas[:, dow]

    yhat = history_splice(params.fitted, fut, day_all, params.day0, h)

    steps = torch.clamp_min(h_unc, 1.0)
    sd = params.sigma[:, None] * torch.sqrt(
        1.0 + (steps - 1.0) * (params.alpha[:, None] ** 2))
    z = _ndtri(0.5 + config.interval_width / 2.0, dev)
    return yhat, yhat - z * sd, yhat + z * sd


def update_state(params: ThetaParams, aux, y_new, mask_new, valid, day_new,
                 config: ThetaConfig, day0=None):
    """Continue the theta SES over appended day-columns (the streaming
    update; ``models/base.ModelFns.update_state``).

    The decomposition the fit estimated — seasonal indices, OLS trend,
    the selected alpha — stays frozen (re-estimating it is the refit's
    job); only the SES level and the (sse, n_obs) running moments move.
    The theta line, the step (:func:`_ses_step`) and the fitted value are
    the fit's expressions element for element, so the level after k
    columns continues the fit's filter bit for bit.  Padding columns
    (``valid`` 0) are skipped, which is what the reference's ``mask *
    valid == 0`` steps do: a masked SES step keeps the carry."""
    m = config.season_length
    cols, days = streamed_columns(valid, day_new)
    d0 = first_day(params, day0)
    S, K = y_new.shape
    dev = y_new.device
    preds = y_new.new_zeros(S, K)
    level, sse, n = params.level, aux["sse"], aux["n_obs"]
    if cols:
        take = torch.as_tensor(cols, dtype=torch.long).to(dev)
        day = np.asarray(days, np.int64)
        dow = torch.as_tensor(day % m).to(dev)
        # days since the first training day: exact integers in float32
        t = torch.as_tensor((day - d0).astype(np.float32)).to(dev)
        y, mask = y_new[:, take], mask_new[:, take]
        si = params.seas[:, dow]                            # (S, k)
        y_sa = y / torch.clamp_min(si, _EPS)
        trend = params.intercept[:, None] + params.slope[:, None] * t[None, :]
        th = config.theta
        zline = th * y_sa + (1.0 - th) * trend
        az = params.alpha[:, None] * zline
        one_minus = 1.0 - params.alpha
        observed = mask > 0
        w_ses = 1.0 / th
        for j in range(len(cols)):
            pred = level
            level = _ses_step(level, az[:, j], observed[:, j], one_minus)
            fitted = (w_ses * pred + (1.0 - w_ses) * trend[:, j]) * si[:, j]
            err = (y[:, j] - fitted) * mask[:, j]
            sse = sse + err * err
            n = n + mask[:, j]
            preds[:, cols[j]] = fitted
    sigma = torch.sqrt(sse / torch.clamp_min(n, 1.0))
    params2 = dataclasses.replace(
        params, level=level, sigma=sigma,
        t_fit_end=advance_t_fit_end(params.t_fit_end, days))
    return params2, {"sse": sse, "n_obs": n}, preds


def init_update_aux(params: ThetaParams, y=None, mask=None):
    """(sse, n_obs) for sigma's continuation; see the holt_winters
    counterpart for the square-root round trip."""
    if mask is not None:
        n = torch.as_tensor(mask, dtype=torch.float32,
                            device=params.sigma.device).sum(1)
    else:
        n = torch.full_like(params.sigma, float(params.fitted.shape[1]))
    return {"sse": params.sigma**2 * torch.clamp_min(n, 1.0), "n_obs": n}


register_model("theta", fit, forecast, ThetaConfig,
               forecast_quantiles=gaussian_quantiles(forecast),
               update_state=update_state, init_update_aux=init_update_aux)
