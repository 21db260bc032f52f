"""Batched AR-Net: linear autoregression + regressor head, fit by minibatch
gradient descent over ALL series at once (port of the reference's
``models/arnet.py``; NeuralProphet's AR-Net core, arXiv 2111.15397, without
the hidden layers).

The model per series s, in per-series standardized space ``z``:

    z_t ~ w_s · [z_{t-1} .. z_{t-L}] + beta_s · x_t + b_s

``x_t`` are regressors known over history + horizon, standardized with
statistics frozen at fit time.  Fitting is the batched gradient loop of
``engine/gradfit.py`` (one optimizer step advances all S series; a sum of
per-series losses, so series never couple and padding rows are no-ops).

Two fit paths, one numeric core:

* :func:`fit` (registered) trains with ``gradfit.train_scan`` on the
  batch's device, so the family rides ``fit_forecast``, the CV, the
  training pipeline and the serving predictor like the others;
* the engine path (``gradfit.gradfit_fit_forecast``, armed by the
  ``engine.gradfit`` block) trains on host-assembled minibatches, then
  calls :func:`params_from_weights` and :func:`forecast` — the same
  post-training code as this module.

Forecasting rolls the AR recursion forward from the fit-grid-end lag
buffer (predictions feed back as lag inputs).  Bands grow with the AR(1)
proxy ``a = sum(w)``: h-step variance ``sigma^2 (1 - a^{2h}) / (1 - a^2)``.

Every sum here adds each series' terms in an order that does not depend on
the rows beside it (row sums in order, ``models/base.cumsum_rows``; the
recursions and contractions sum with ``models/base.sum_leading``), so a fit
padded to a bucket, and a forecast coalesced with other requests, give a
series the same bits.  ``groups`` (the CV's stacked cutoffs) keeps the
statistics of per-series regressors to each block of rows, as a fit at
each cutoff would compute them.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_forecasting_tpu_torch.models.base import (
    _ndtri,
    cumsum_rows,
    design_product,
    history_splice,
    register_model,
    sum_leading,
    t_end_rows,
)

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ArnetConfig:
    lags: int = 28
    n_regressors: int = 0
    loss: str = "huber"            # "huber" | "mse"
    huber_delta: float = 1.0
    optimizer: str = "adam"        # "adam" | "sgd" | "momentum"
    learning_rate: float = 0.05
    epochs: int = 30
    batch_size: int = 64
    seed: int = 0
    interval_width: float = 0.95

    def __post_init__(self):
        if self.lags < 1:
            raise ValueError(f"lags must be >= 1, got {self.lags}")
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if self.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {self.batch_size}")
        if not 0.0 < self.interval_width < 1.0:
            raise ValueError(
                f"interval_width must lie in (0, 1), got "
                f"{self.interval_width}")


@dataclasses.dataclass(frozen=True)
class ArnetParams:
    w: torch.Tensor          # (S, L) AR lag weights (lag 1 first), z-space
    beta: torch.Tensor       # (S, R) regressor weights, standardized space
    b: torch.Tensor          # (S,) bias, z-space
    mu: torch.Tensor         # (S,) per-series target mean
    sd: torch.Tensor         # (S,) per-series target std
    xmu: torch.Tensor        # (S, R) regressor means (rows repeat)
    xsd: torch.Tensor        # (S, R) regressor stds
    sigma: torch.Tensor      # (S,) one-step residual std, data space
    buf_end: torch.Tensor    # (S, L) z-space lag buffer at the grid end
    fitted: torch.Tensor     # (S, T) one-step fitted path, data space
    day0: torch.Tensor       # () first fit day
    t_fit_end: torch.Tensor  # () last fit day


def _check_xreg(xreg, config: ArnetConfig, what: str) -> bool:
    if config.n_regressors == 0:
        if xreg is not None:
            raise ValueError(
                "xreg passed but config.n_regressors == 0 — set "
                f"ArnetConfig(n_regressors={xreg.shape[-1]}) ({what})")
        return False
    if xreg is None:
        raise ValueError(
            f"config.n_regressors={config.n_regressors} but no xreg "
            f"values passed to {what}")
    if xreg.shape[-1] != config.n_regressors:
        raise ValueError(
            f"xreg has {xreg.shape[-1]} columns, config.n_regressors="
            f"{config.n_regressors} ({what})")
    return True


def _row_sum(x):
    """Sum over the last axis, each row's terms added in order whatever
    the rows beside it (``cumsum_rows``' last column)."""
    return cumsum_rows(x.contiguous())[..., -1]


def _per_group_stats(xreg, mask, groups: int):
    """Mask-weighted per-column mean and std of per-series regressors
    (S, T, R) over each of ``groups`` equal blocks of rows: (G, R) each.
    Padded rows (mask 0) add exact zeros at the end of each in-order sum."""
    S, T, R = xreg.shape
    w = mask[:, :, None]

    def block_sum(v):  # (S, T, R) -> (G, R)
        per_row = _row_sum(v.permute(0, 2, 1))                # (S, R)
        return _row_sum(per_row.reshape(groups, -1, R).permute(0, 2, 1))

    cnt = torch.clamp_min(_row_sum(_row_sum(mask).reshape(groups, -1)), 1.0)
    xmu = block_sum(xreg * w) / cnt[:, None]
    rows = xmu.repeat_interleave(S // groups, dim=0)          # (S, R)
    xvar = block_sum(((xreg - rows[:, None, :]) ** 2) * w) / cnt[:, None]
    return xmu, xvar


def prep_training(y, mask, config: ArnetConfig, xreg=None, groups: int = 1):
    """Standardized training tensors ``(z, mu, sd, xz, valid, xmu, xsd)``.

    z: (S, T) per-series standardized targets, masked positions zeroed;
    xz: regressors standardized per column, in the input's layout ((T, R)
    shared, (S, T, R) per-series; (T, 0) without regressors); valid:
    (S, T) teacher-forcing weight, 1 only where the target and all
    ``lags`` lag positions are observed.  A shared calendar takes plain
    time statistics; per-series values mask-weighted ones over each of the
    ``groups`` blocks of rows ((R,) for one group, else (G, R)), so padded
    bucket rows cannot move them.
    """
    y = torch.as_tensor(y, dtype=torch.float32)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=y.device)
    T = y.shape[1]
    n = torch.clamp_min(_row_sum(mask), 1.0)
    mu = _row_sum(y * mask) / n
    var = _row_sum(((y - mu[:, None]) ** 2) * mask) / n
    sd = torch.sqrt(var)
    sd = torch.where(sd > _EPS, sd, 1.0)
    z = torch.where(mask > 0, (y - mu[:, None]) / sd[:, None], 0.0)

    valid = mask
    for i in range(1, config.lags + 1):
        valid = valid * torch.nn.functional.pad(mask, (i, 0))[:, :T]

    if _check_xreg(xreg, config, "fit"):
        xreg = torch.as_tensor(xreg, dtype=torch.float32, device=y.device)
        if xreg.dim() == 3:
            xmu, xvar = _per_group_stats(xreg, mask, groups)
            rows = lambda v: v.repeat_interleave(  # noqa: E731
                y.shape[0] // groups, dim=0)[:, None, :]
        else:
            xmu = torch.mean(xreg, dim=0)
            xvar = torch.mean((xreg - xmu) ** 2, dim=0)
            rows = lambda v: v  # noqa: E731
        xsd = torch.sqrt(xvar)
        xsd = torch.where(xsd > _EPS, xsd, 1.0)
        xz = (xreg - rows(xmu)) / rows(xsd)
        if xreg.dim() == 3 and groups == 1:
            xmu, xsd = xmu[0], xsd[0]
    else:
        xmu = torch.zeros((0,), dtype=torch.float32, device=y.device)
        xsd = torch.ones((0,), dtype=torch.float32, device=y.device)
        xz = torch.zeros((T, 0), dtype=torch.float32, device=y.device)
    return z, mu, sd, xz, valid, xmu, xsd


def _fitted_scan(z, mask, xc, w):
    """One-step-ahead fitted path in z-space with a recursive lag buffer:
    observed positions enter the buffer as they are, masked ones (gaps, CV
    eval windows) as their own prediction — the dynamics the future
    rollout continues.  The buffer is the (L + T, S) tensor of values,
    oldest first.  Returns (preds (S, T), buf_end (S, L), lag 1 first)."""
    S, L = w.shape
    T = z.shape[1]
    w_rev = w.flip(1).t().contiguous()                       # (L, S)
    vals = z.new_zeros((L + T, S))
    preds = z.new_empty((T, S))
    zt, xct = z.t().contiguous(), xc.t().contiguous()
    obs = (mask > 0).t().contiguous()
    for t in range(T):
        preds[t] = sum_leading(w_rev * vals[t:t + L]) + xct[t]
        vals[L + t] = torch.where(obs[t], zt[t], preds[t])
    return preds.t(), vals[T:].flip(0).t()


def _xreg_contrib(xreg_grid, params: ArnetParams):
    """(S, T_grid) regressor contribution from RAW values, the frozen
    standardization folded into the weights (``beta·(x-mu)/sd =
    (beta/sd)·x - beta·mu/sd``)."""
    xreg_grid = torch.as_tensor(xreg_grid, dtype=torch.float32,
                                device=params.beta.device)
    beta_eff = params.beta / params.xsd                         # (S, R)
    offset = torch.sum(params.beta * params.xmu / params.xsd, dim=1)
    return _contract(xreg_grid, beta_eff) - offset[:, None]


def _contract(x, coef):
    """``sum_r x[..., t, r] coef[s, r]`` -> (S, T), each entry summed in
    one order whatever S: ``x`` (T, R) shared or (S, T, R) per-series."""
    if x.dim() == 2:
        return design_product(coef, x)
    return sum_leading(x.permute(2, 1, 0) * coef.t()[:, None, :]).t()


def params_from_weights(y, mask, day, config: ArnetConfig, w, beta, b,
                        xreg=None, groups: int = 1) -> ArnetParams:
    """Finalize trained weights into the family's params: fitted path,
    residual sigma, grid-end lag buffer, frozen standardization.  Shared by
    :func:`fit` and the engine path, so the two trainers differ only in
    who ran the optimizer loop."""
    y = torch.as_tensor(y, dtype=torch.float32)
    m = torch.as_tensor(mask, dtype=torch.float32, device=y.device)
    z, mu, sd, xz, _valid, xmu_g, xsd_g = prep_training(
        y, m, config, xreg=xreg, groups=groups)
    S = y.shape[0]
    xc = b[:, None].expand(z.shape)
    if xz.shape[-1]:
        xc = xc + _contract(xz, beta)
    preds, buf_end = _fitted_scan(z, m, xc, w)
    fitted = mu[:, None] + sd[:, None] * preds
    resid = (y - fitted) * m
    sigma = torch.sqrt(_row_sum(resid * resid)
                       / torch.clamp_min(_row_sum(m), 1.0))
    R = config.n_regressors

    def rows(v):
        if v.dim() == 1:
            return v[None, :].expand(S, R).clone()
        return v.repeat_interleave(S // v.shape[0], dim=0)

    return ArnetParams(
        w=w, beta=beta, b=b, mu=mu, sd=sd, xmu=rows(xmu_g), xsd=rows(xsd_g),
        sigma=sigma, buf_end=buf_end.contiguous(), fitted=fitted,
        day0=day[0].to(torch.float32), t_fit_end=day[-1].to(torch.float32),
    )


def fit(y, mask, day, config: ArnetConfig, xreg=None, groups: int = 1,
        schedule=None) -> ArnetParams:
    """Batched gradient fit (``gradfit.train_scan``) on the batch's device.
    Determinism comes from ``config.seed`` (the schedule's generator), so
    two fits on identical inputs are bitwise identical.  ``schedule``:
    (steps, B) time positions to train on instead of the seeded ones."""
    from distributed_forecasting_tpu_torch.engine import gradfit

    z, _mu, _sd, xz, valid, _xmu, _xsd = prep_training(
        y, mask, config, xreg=xreg, groups=groups)
    wp, _losses = gradfit.train_scan(z, xz, valid, config, schedule=schedule)
    return params_from_weights(y, mask, day, config, wp["w"], wp["beta"],
                               wp["b"], xreg=xreg, groups=groups)


def forecast(params: ArnetParams, day_all, t_end, config: ArnetConfig,
             xreg=None):
    """Recursive multi-step rollout from the fit-grid-end lag buffer.
    ``t_end``: the forecast start, a scalar or one per row.  ``xreg`` (with
    regressors) covers the full history + horizon grid."""
    if config.n_regressors and xreg is None:
        raise ValueError(
            f"config.n_regressors={config.n_regressors} but no xreg "
            f"values passed to forecast")
    S, L = params.w.shape
    T_fit = params.fitted.shape[1]
    T_all = day_all.shape[0]
    H = T_all - T_fit + 1 if T_all > T_fit else T_all
    dev = params.w.device

    dayf = day_all.to(torch.float32)
    h = dayf - params.t_fit_end
    h_unc = dayf[None, :] - t_end_rows(t_end, dev)                # (n, T_all)

    xc_all = params.b[:, None].expand(S, T_all)
    if config.n_regressors:
        xc_all = xc_all + _xreg_contrib(xreg, params)
    pos = torch.clamp(T_fit + torch.arange(H, device=dev), 0, T_all - 1)
    xc_fut = xc_all[:, pos].t().contiguous()                       # (H, S)

    w_rev = params.w.flip(1).t().contiguous()                      # (L, S)
    vals = torch.cat([params.buf_end.flip(1).t(),
                      params.w.new_empty((H, S))])
    for j in range(H):
        vals[L + j] = sum_leading(w_rev * vals[j:j + L]) + xc_fut[j]
    fut = params.mu[:, None] + params.sd[:, None] * vals[L:].t()   # (S, H)

    hidx = torch.clamp(h.to(torch.int64) - 1, 0, H - 1)
    fut_g = torch.gather(fut, 1, hidx[None, :].expand(S, T_all))
    yhat = history_splice(params.fitted, fut_g, day_all, params.day0, h)

    # AR(1) persistence proxy for band growth: a = sum of lag weights,
    # clipped inside the unit circle so the geometric series is finite
    a = sum_leading(params.w.t())
    a2 = torch.clamp(a, -0.98, 0.98) ** 2                          # (S,)
    steps = torch.clamp_min(h_unc, 1.0)
    growth = (1.0 - a2[:, None] ** steps) / (1.0 - a2[:, None])
    sd_path = params.sigma[:, None] * torch.sqrt(growth)
    z_w = _ndtri(0.5 + config.interval_width / 2.0, dev)
    return yhat, yhat - z_w * sd_path, yhat + z_w * sd_path


def forecast_quantiles(params: ArnetParams, day_all, t_end,
                       config: ArnetConfig, quantiles=(0.1, 0.5, 0.9),
                       xreg=None):
    """Gaussian quantile paths (S, Q, T_all) with the regressor values
    passed through to :func:`forecast`."""
    if not quantiles or not all(0.0 < q < 1.0 for q in quantiles):
        raise ValueError(f"quantiles must lie in (0, 1), got {quantiles!r}")
    yhat, _lo, hi = forecast(params, day_all, t_end, config, xreg=xreg)
    z_w = _ndtri(0.5 + config.interval_width / 2.0, yhat.device)
    sd = (hi - yhat) / z_w
    zq = _ndtri(tuple(quantiles), yhat.device)
    return yhat[:, None, :] + zq[None, :, None] * sd[:, None, :]


register_model("arnet", fit, forecast, ArnetConfig, supports_xreg=True,
               forecast_quantiles=forecast_quantiles, per_block_stats=True)
