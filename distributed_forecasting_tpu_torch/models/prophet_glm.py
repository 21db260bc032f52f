"""Prophet-equivalent curve model: piecewise-linear trend + Fourier
seasonality + holidays (port of the reference's ``models/prophet_glm.py``).

Prophet's MAP problem — a hinge-basis trend with a sparsity prior on the
slope deltas, weekly and yearly Fourier seasonality, a Gaussian likelihood —
is solved in closed form as one batched penalized least squares: one shared
design matrix (``ops/features``), one Gram per series, one batched Cholesky
solve (``ops/solve``).  No iterative optimizer, no per-series Python.

Multiplicative seasonality is fit additively in log space (forecasts are
mapped back with exp); logistic growth is fit in the logit of
``(y - floor) / (cap - floor)``.  Intervals follow Prophet's trick:
observation noise from the training residuals plus trend uncertainty from
simulated future changepoints (Laplace slope changes at the historical
rate).  By default (``uncertainty_samples == 0``) they are analytic, the
closed-form variance of that process; with ``uncertainty_samples > 0``
they are linear quantiles over that many Monte-Carlo paths, drawn from a
``torch.Generator`` (``generator=``, by default seeded 0 as the reference's
``PRNGKey(0)``; ``utils/rng.py``) and held to the reference by
distribution.  ``fit`` takes the reference's prior-scale overrides
(``prior_scales``), scalars or one per series, for the hyper search
(``engine/hyper.py``).

``forecast`` takes ``t_end`` as a scalar or one per row: the CV folds its
cutoffs into the series axis, so each row's uncertainty (and AR correction)
starts at its own cutoff.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch

from distributed_forecasting_tpu_torch.models.base import (
    _ndtri,
    design_product,
    register_model,
    t_end_rows,
)
from distributed_forecasting_tpu_torch.ops.features import (
    curve_design_matrix,
    scaled_time,
    with_regressors,
)
from distributed_forecasting_tpu_torch.utils.rng import resolve_generator
from distributed_forecasting_tpu_torch.ops.solve import (
    fitted_values,
    huber_irls_solve,
    masked_mad_scale,
    ridge_solve_batch,
    weighted_residual_scale,
    yule_walker_masked,
)

_LOG_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class CurveModelConfig:
    growth: str = "linear"  # 'linear' | 'flat' | 'logistic'
    # logistic growth: per-series capacity = cap_multiplier * max(y), unless
    # cap_value gives a shared one (Prophet's `cap`); floor_value is the
    # saturating minimum (Prophet's `floor`, logistic only)
    cap_multiplier: float = 1.1
    cap_value: Optional[float] = None
    floor_value: float = 0.0
    n_changepoints: int = 25
    changepoint_range: float = 0.8
    # explicit hinge sites (epoch days); override the uniform grid
    changepoint_days: tuple = ()
    changepoint_prior_scale: float = 0.05
    seasonality_prior_scale: float = 10.0
    weekly_order: int = 3
    yearly_order: int = 10
    # Prophet's add_seasonality: ((name, period_days, order[, prior_scale]), ...)
    extra_seasonalities: tuple = ()
    seasonality_mode: str = "multiplicative"  # or 'additive'
    # static holiday spec ((name, (epoch_day, ...)), ...): data/holidays
    holidays: tuple = ()
    holiday_prior_scale: float = 10.0
    interval_width: float = 0.95
    # 0 = analytic intervals; > 0 = Monte-Carlo quantiles over that many
    # sample paths
    uncertainty_samples: int = 0
    # AR(p) on the fit residuals, added to the forecast (0 = off)
    ar_order: int = 0
    # exogenous regressors (Prophet's add_regressor): values arrive as the
    # ``xreg`` argument, (T, R) shared or (S, T, R) per series
    n_regressors: int = 0
    regressor_prior_scale: float = 10.0
    regressor_standardize: bool = True
    regressor_names: tuple = ()
    # 'huber': IRLS instead of the L2 solve, sigma from the MAD scale
    loss: str = "l2"  # 'l2' | 'huber'
    huber_delta: float = 1.345
    robust_iters: int = 3


def _empty(*shape, fill=0.0, device=None):
    return torch.full(shape, fill, dtype=torch.float32, device=device)


def _no_regressors(device) -> dict:
    """The (0, 0) standardization fields of a fit without regressors."""
    return dict(reg_mu=_empty(0, 0, device=device),
                reg_sd=_empty(0, 0, fill=1.0, device=device))


def _no_ar(device) -> dict:
    """The empty AR fields of a fit with ``ar_order == 0``."""
    return dict(ar_phi=_empty(0, 0, device=device),
                ar_tail=_empty(0, 0, device=device),
                ar_sigma=_empty(0, device=device),
                ar_last_day=_empty(0, device=device))


@dataclasses.dataclass(frozen=True)
class CurveParams:
    """Fitted parameters of a batch of series (per-series fields lead with
    S; ``t0``/``t1`` are 0-d)."""

    beta: torch.Tensor     # (S, F) coefficients in the design basis
    sigma: torch.Tensor    # (S,) residual std (fit space)
    y_scale: torch.Tensor  # (S,) per-series normalization of y
    cap: torch.Tensor      # (S,) carrying capacity (logistic; else 1)
    t0: torch.Tensor       # () first training day (absolute)
    t1: torch.Tensor       # () last training day (absolute)
    # regressor standardization, always (S, R); (0, 0) without regressors
    reg_mu: torch.Tensor
    reg_sd: torch.Tensor
    # AR-on-residuals state (ar_order > 0; empty otherwise): coefficients,
    # the residual window ending at each series' last observed day, the
    # innovation std and that day
    ar_phi: torch.Tensor
    ar_tail: torch.Tensor
    ar_sigma: torch.Tensor
    ar_last_day: torch.Tensor

    # artifacts written before these fields existed load with the empty
    # values a model without regressors or AR fits
    _LEGACY_DEFAULTS: ClassVar[dict] = {
        name: (lambda f, make=make, name=name: make(f["beta"].device)[name])
        for make in (_no_regressors, _no_ar)
        for name in make(None)
    }


def _fit_space(y, mask, mode, cap=None, floor=0.0):
    """Observations in the additive fitting space: the logit of
    ``(y - floor) / (cap - floor)`` for logistic growth, log y for
    multiplicative seasonality, else y (each zeroed off the mask)."""
    if cap is not None:
        frac = torch.clamp((y - floor) / (cap[:, None] - floor),
                           _LOG_EPS, 1.0 - _LOG_EPS)
        return torch.log(frac / (1.0 - frac)) * mask
    if mode == "multiplicative":
        return torch.log(torch.clamp_min(y, _LOG_EPS)) * mask
    return y * mask


def _feature_masks(layout, own_scale=(), device=None):
    """0/1 masks over the feature axis for each prior group; ``own_scale``
    entries ((slice, prior_scale), ...) leave the shared seasonal mask and
    come back as (mask, scale) pairs."""
    F = layout["n_features"]

    groups = [(layout["changepoints"],),
              (layout["weekly"], layout["yearly"], layout["extra_seas"]),
              (layout["intercept"],), (layout["slope"],),
              (layout.get("holidays", slice(0, 0)),),
              (layout.get("regressors", slice(0, 0)),)]
    groups += [(sl,) for sl, _ in own_scale]
    m = np.zeros((len(groups), F), np.float32)
    for i, slices in enumerate(groups):
        for sl in slices:
            m[i, sl] = 1.0
    for sl, _ in own_scale:
        m[1, sl] = 0.0
    # one host-to-device copy (each copy waits for the device's queue)
    masks = torch.as_tensor(m, device=device).unbind(0)
    own = [(mk, float(ps)) for mk, (_, ps) in zip(masks[6:], own_scale)]
    return tuple(masks[:6]) + (own,)


def _prior_precision(layout, cfg: CurveModelConfig, device=None,
                     cp_scale=None, seas_scale=None, hol_scale=None):
    """Per-feature ridge precision: flat prior on intercept and slope,
    ``1/scale^2`` on changepoint deltas, seasonality, holidays and
    regressors, each extra seasonality with a scale of its own on its own
    block.  ``cp_scale`` / ``seas_scale`` / ``hol_scale`` override the
    config's scales (the hyper search), each a scalar or one per series;
    the result is (F,), or (S, F) when an override is per series."""
    def prec(scale):
        scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
        return 1.0 / (scale[:, None] if scale.dim() else scale) ** 2

    cp_scale = cfg.changepoint_prior_scale if cp_scale is None else cp_scale
    seas_scale = cfg.seasonality_prior_scale if seas_scale is None else seas_scale
    hol_scale = cfg.holiday_prior_scale if hol_scale is None else hol_scale

    own_scale = tuple((layout[f"seas_{name}"], ps)
                      for name, _p, _o, ps in _extra_entries(cfg)
                      if ps is not None)
    cp_m, seas_m, fixed_m, slope_m, hol_m, reg_m, own = _feature_masks(
        layout, own_scale, device)
    # flat growth: no trend at all, slope and hinges both clamped
    slope_prec = 1e8 if cfg.growth == "flat" else 1e-8
    if cfg.growth == "flat":
        cp_scale = torch.full_like(
            torch.as_tensor(cp_scale, dtype=torch.float32, device=device),
            1e-4)
    lam = (cp_m * prec(cp_scale)
           + seas_m * prec(seas_scale)
           + fixed_m * 1e-8
           + slope_m * slope_prec
           + hol_m * prec(hol_scale)
           + reg_m * (1.0 / cfg.regressor_prior_scale**2))
    for m, ps in own:
        lam = lam + m * (1.0 / ps**2)
    return lam


_RESERVED_COMPONENTS = frozenset({
    "trend", "weekly", "yearly", "holidays", "regressors",
    "ds", "store", "item", "y", "yhat", "yhat_lower", "yhat_upper",
})


def _extra_entries(cfg: CurveModelConfig):
    """extra_seasonalities validated and normalized to
    (name, period, order, prior_scale or None) 4-tuples."""
    seen = set()
    out = []
    for entry in cfg.extra_seasonalities:
        if len(entry) == 3:
            name, period, order = entry
            ps = None
        elif len(entry) == 4:
            name, period, order, ps = entry
            if ps is not None and not float(ps) > 0:
                raise ValueError(
                    f"extra seasonality {name!r} prior_scale must be > 0, "
                    f"got {ps}"
                )
        else:
            raise ValueError(
                f"extra seasonality entries are (name, period, order[, "
                f"prior_scale]), got {entry!r}"
            )
        if str(name) in _RESERVED_COMPONENTS:
            raise ValueError(
                f"extra seasonality name {name!r} collides with a built-in "
                f"component; rename it"
            )
        if str(name) in seen:
            raise ValueError(f"duplicate extra seasonality name {name!r}")
        seen.add(str(name))
        if not (float(period) > 0 and int(order) > 0):
            raise ValueError(
                f"extra seasonality {name!r} needs period > 0 and "
                f"order >= 1, got period={period}, order={order}"
            )
        out.append((str(name), float(period), int(order),
                    None if ps is None else float(ps)))
    return tuple(out)


def _n_cp(cfg: CurveModelConfig) -> int:
    """Hinge count: explicit changepoint_days override the grid."""
    return len(cfg.changepoint_days) or cfg.n_changepoints


def _cp_range(cfg: CurveModelConfig) -> float:
    """Share of history the hinge sites span (explicit dates: all of it)."""
    return 1.0 if cfg.changepoint_days else cfg.changepoint_range


def _design(day, t0, t1, cfg: CurveModelConfig):
    entries = _extra_entries(cfg)
    return curve_design_matrix(
        day, t0, t1,
        n_changepoints=cfg.n_changepoints,
        weekly_order=cfg.weekly_order,
        yearly_order=cfg.yearly_order,
        changepoint_range=cfg.changepoint_range,
        holidays=cfg.holidays,
        extra_seasonalities=tuple((n, p, o) for n, p, o, _ in entries),
        changepoint_days=cfg.changepoint_days,
    )


def _standardize_xreg(xreg, mask, config: CurveModelConfig):
    """Regressor columns z-scored for conditioning; returns (xs, mu, sd).
    Per-series (S, T, R) regressors standardize under the mask, shared
    (T, R) ones over the grid; a near-constant column keeps sd = 1, and a
    column whose observed values are exactly {0, 1} (both present) passes
    untouched (Prophet's ``standardize='auto'``)."""
    R = xreg.shape[-1]
    dev = xreg.device
    if not config.regressor_standardize:
        return (xreg, torch.zeros(R, dtype=torch.float32, device=dev),
                torch.ones(R, dtype=torch.float32, device=dev))
    if xreg.dim() == 3:
        w = mask[:, :, None]
        obs = w > 0
        is01 = (torch.all((xreg == 0) | (xreg == 1) | ~obs, dim=1)
                & torch.any((xreg == 0) & obs, dim=1)
                & torch.any((xreg == 1) & obs, dim=1))  # (S, R)
        n = torch.clamp_min(w.sum(dim=1), 1.0)
        mu = (xreg * w).sum(dim=1) / n
        var = (((xreg - mu[:, None, :]) ** 2) * w).sum(dim=1) / n
        sd_raw = torch.sqrt(var)
        sd = torch.where(sd_raw > 1e-6, sd_raw, 1.0)
        mu = torch.where(is01, 0.0, mu)
        sd = torch.where(is01, 1.0, sd)
        return (xreg - mu[:, None, :]) / sd[:, None, :], mu, sd
    is01 = (torch.all((xreg == 0) | (xreg == 1), dim=0)
            & torch.any(xreg == 0, dim=0) & torch.any(xreg == 1, dim=0))
    mu = torch.where(is01, 0.0, xreg.mean(dim=0))
    sd_raw = xreg.std(dim=0, correction=0)
    sd = torch.where(is01 | (sd_raw <= 1e-6), 1.0, sd_raw)
    return (xreg - mu) / sd, mu, sd


def _check_xreg(xreg, config: CurveModelConfig, what: str) -> bool:
    if config.n_regressors == 0:
        if xreg is not None:
            raise ValueError(
                "xreg passed but config.n_regressors == 0 — set "
                "CurveModelConfig(n_regressors=R) so the design and priors "
                "include the regressor columns"
            )
        return False
    if xreg is None:
        raise ValueError(
            f"config.n_regressors={config.n_regressors} but no xreg values "
            f"were passed to {what} (like Prophet, regressor values must be "
            f"supplied for fitting AND for the forecast window)"
        )
    if xreg.shape[-1] != config.n_regressors:
        raise ValueError(
            f"xreg has {xreg.shape[-1]} columns, config.n_regressors="
            f"{config.n_regressors}"
        )
    return True


def _fit_target(y, mask, config: CurveModelConfig):
    """(normalized fit-space target zn, y_scale, cap), each per series."""
    S = y.shape[0]
    ones = torch.ones(S, dtype=torch.float32, device=y.device)
    if config.growth == "logistic":
        if config.cap_value is not None:
            if config.cap_value <= config.floor_value:
                raise ValueError(
                    f"cap_value ({config.cap_value}) must exceed "
                    f"floor_value ({config.floor_value})"
                )
            cap = torch.full((S,), float(config.cap_value),
                             dtype=torch.float32, device=y.device)
        else:
            if config.floor_value != 0.0:
                raise ValueError(
                    "floor_value requires an explicit cap_value (the "
                    "cap_multiplier rule derives capacity from 0)"
                )
            cap = config.cap_multiplier * torch.clamp_min(
                torch.amax(y * mask, dim=1), _LOG_EPS)
        z = _fit_space(y, mask, config.seasonality_mode, cap=cap,
                       floor=float(config.floor_value))
        y_scale = ones
    else:
        cap = ones
        z = _fit_space(y, mask, config.seasonality_mode)
        if config.seasonality_mode == "multiplicative":
            y_scale = ones
        else:
            y_scale = torch.clamp_min(torch.amax(torch.abs(z) * mask, dim=1), 1.0)
    return z / y_scale[:, None], y_scale, cap


def fit(y, mask, day, config: CurveModelConfig, xreg=None,
        prior_scales=None) -> CurveParams:
    """Fit all series at once.  y, mask: (S, T); day: (T,) absolute days.
    ``xreg``: regressor values over the same day grid, (T, R) or
    (S, T, R); required iff ``config.n_regressors > 0``.
    ``prior_scales``: ``(changepoint, seasonality)`` or ``(changepoint,
    seasonality, holiday)`` scale overrides, each a scalar or an (S,)
    tensor (the hyper search); ``None`` uses the config's."""
    t0 = day[0].to(torch.float32)
    t1 = day[-1].to(torch.float32)
    zn, y_scale, cap = _fit_target(y, mask, config)
    X, layout = _design(day, t0, t1, config)
    S = y.shape[0]
    if _check_xreg(xreg, config, "fit"):
        xs, reg_mu, reg_sd = _standardize_xreg(
            torch.as_tensor(xreg, dtype=torch.float32, device=y.device),
            mask, config)
        X, layout = with_regressors(X, layout, xs)
        if reg_mu.dim() == 1:  # shared calendar: stats broadcast per series
            reg_mu = reg_mu[None].expand(S, -1).clone()
            reg_sd = reg_sd[None].expand(S, -1).clone()
    else:
        reg_mu, reg_sd = _no_regressors(y.device).values()
    if prior_scales is None:
        prior_scales = ()
    elif len(prior_scales) not in (2, 3):
        raise ValueError(
            f"prior_scales takes 2 or 3 scales, got {len(prior_scales)}")
    lam = _prior_precision(layout, config, y.device, *prior_scales)
    resid_clip = None
    if config.loss == "huber":
        beta, _ = huber_irls_solve(X, zn, mask, lam, delta=config.huber_delta,
                                   iters=config.robust_iters)
        # sigma from the MAD of the final residuals: bounded in outlier
        # size; the AR stage sees the residuals winsorized at delta sigma
        r_fin = (zn - fitted_values(X, beta)) * mask
        sigma = masked_mad_scale(r_fin, mask)
        cl = (config.huber_delta * sigma)[:, None]
        resid_clip = torch.clamp(r_fin, -cl, cl)
    elif config.loss == "l2":
        beta = ridge_solve_batch(X, zn, mask, lam)
        sigma = weighted_residual_scale(X, zn, mask, beta)
    else:
        raise ValueError(
            f"unknown CurveModelConfig.loss {config.loss!r}; 'l2' or 'huber'"
        )
    ar = _no_ar(y.device)
    if config.ar_order > 0:
        resid = (resid_clip if resid_clip is not None
                 else (zn - fitted_values(X, beta)) * mask)
        phi, tail, s_inn, last = _fit_ar_residuals(resid, mask, config.ar_order)
        ar = dict(ar_phi=phi, ar_tail=tail, ar_sigma=s_inn,
                  ar_last_day=day[last].to(torch.float32))
    return CurveParams(beta=beta, sigma=sigma, y_scale=y_scale, cap=cap,
                       t0=t0, t1=t1, reg_mu=reg_mu, reg_sd=reg_sd, **ar)


_FUTURE_CP_GRID = 25  # candidate future changepoint sites per forecast window


def _future_sites(t_all, te):
    """(n, L): the L future changepoint sites spread over (t_end, t_max]
    for each of the n scaled forecast starts ``te`` (n, 1)."""
    L = _FUTURE_CP_GRID
    span = torch.clamp_min(t_all[-1] - te, 0.0)
    frac = (torch.arange(L, dtype=torch.float32, device=t_all.device) + 0.5) / L
    return te + frac[None, :] * span


def _lag2(t_all, te):
    """sum_l max(0, t - s_l)^2 over the future sites of each row's forecast
    start: (n, T_all).  Per-row starts (the CV's folded cutoffs) are
    computed once per distinct start and gathered, so no (S, L, T_all)
    tensor is built (274 MB at the CV shape); ``torch.unique`` costs one
    device-to-host sync there, the output size depending on the data."""
    inv = None
    if te.shape[0] > 1:
        vals, inv = torch.unique(te[:, 0], return_inverse=True)
        te = vals[:, None]
    sites = _future_sites(t_all, te)
    lag = torch.clamp_min(t_all[None, None, :] - sites[:, :, None], 0.0)
    lag2 = torch.sum(lag**2, dim=1)
    return lag2 if inv is None else lag2[inv]


def _trend_deviation_variance(params: CurveParams, t_all, te, cfg):
    """Closed-form variance of Prophet's simulated future changepoints: each
    of L sites flips on with probability p and a Laplace(0, b) slope change,
    so Var[dev(t)] = 2 b^2 p sum_l max(0, t - s_l)^2, with b the mean
    |delta| learned on history.  ``te``: (n, 1) scaled forecast starts,
    n = 1 or one per row.  Returns (S, T_all)."""
    lam_scale, p_cp, _ = _cp_process(params, t_all, te, cfg)
    return 2.0 * lam_scale[:, None] ** 2 * p_cp * _lag2(t_all, te)


def _cp_process(params: CurveParams, t_all, te, cfg):
    """The simulated changepoint process's parameters: the Laplace scale b
    (S,) (the mean |delta| learned on history), the probability p (n, 1)
    that a site flips on, and the sites (n, L) over each row's window."""
    L = _FUTURE_CP_GRID
    lam_scale = torch.mean(torch.abs(params.beta[:, 2:2 + _n_cp(cfg)]), dim=1)
    span = torch.clamp_min(t_all[-1] - te, 0.0)
    p_cp = torch.clamp(_n_cp(cfg) * span / _cp_range(cfg) / L, 0.0, 1.0)
    return lam_scale, p_cp, _future_sites(t_all, te)


def draw_standard(shape_sites, shape_noise, p_cp, generator):
    """The Monte-Carlo branch's own draws from ``generator``, in order:
    ``occur`` (S, N, L), each site on with probability ``p_cp`` (n, 1)
    (uniforms below p); ``laplace`` (S, N, L), standard Laplace by the
    inverse CDF of uniforms on [-1 + 2^-24, 1) (as JAX draws it); ``noise``
    (S, N, T_all) standard normal.  One generator drawn in sequence takes
    the place of the reference's split and folded keys."""
    dev = generator.device
    u = torch.rand(shape_sites, generator=generator, device=dev)
    occur = (u < p_cp.to(dev).reshape(-1, 1, 1)).to(torch.float32)
    u = 2.0 * torch.rand(shape_sites, generator=generator, device=dev) - 1.0
    u = torch.clamp_min(u, -1.0 + 2.0 ** -24)
    laplace = torch.sign(u) * torch.log1p(-torch.abs(u))
    noise = torch.randn(shape_noise, generator=generator, device=dev)
    return occur, laplace, noise


def _trend_deviation_samples(params: CurveParams, t_all, te, cfg, draws):
    """Simulated future trend deviations, Prophet-style, (S, N, T_all),
    zero at and before each row's forecast start: on a static grid of L
    candidate sites over the forecast window, each site flips on with the
    historical changepoint rate and a Laplace slope change of the
    historical mean |delta| (``draws``' ``occur`` and ``laplace``), and
    ``dev(t) = sum_l delta_l max(0, t - s_l)``."""
    occur, laplace = draws[0], draws[1]
    lam_scale, _p, sites = _cp_process(params, t_all, te, cfg)
    delta = occur * laplace * lam_scale[:, None, None]             # (S, N, L)
    lag = torch.clamp_min(t_all[None, None, :] - sites[:, :, None], 0.0)
    if lag.shape[0] == 1:
        S, N, L = delta.shape
        return (delta.reshape(S * N, L) @ lag[0]).reshape(S, N, -1)
    return torch.bmm(delta, lag)


def _regressor_contrib(params: CurveParams, xreg, F0: int):
    """Fit-space regressor contribution (before y_scale), (S, T_all), via
    ``beta.(x - mu)/sd = (beta/sd).x - sum(beta.mu/sd)``: a shared (T, R)
    calendar never becomes an (S, T, R) tensor."""
    xreg = torch.as_tensor(xreg, dtype=torch.float32,
                           device=params.beta.device)
    w = params.beta[:, F0:] / params.reg_sd  # (S, R)
    offset = torch.sum(w * params.reg_mu, dim=-1)[:, None]
    if xreg.dim() == 3:
        return torch.bmm(xreg, w[:, :, None])[..., 0] - offset
    return w @ xreg.T - offset


# AR mean/variance tables cover this many leads; past them the mean is zero
# and the variance the marginal residual variance
_AR_TABLE_LEN = 64


def _fit_ar_residuals(resid, mask, p: int):
    """Batched Yule-Walker AR(p) on masked residuals (zeroed off the mask).
    Returns (phi (S, p), tail (S, p): the residual window ending at each
    series' last observed day, newest last; sigma_inn (S,): the std of the
    one-step innovations over fully observed windows; last (S,): that
    day's index)."""
    S, T = resid.shape
    phi, c = yule_walker_masked(resid, mask, p, per_lag_norm=False,
                                jitter_rel=1e-6, jitter_abs=1e-12)
    # all-masked rows resolve to index 0
    last = torch.argmax(
        torch.arange(T, dtype=torch.float32, device=resid.device)[None, :] * mask
        + mask, dim=1)
    start = torch.clamp(last - (p - 1), 0, T - p)
    take = start[:, None] + torch.arange(p, device=resid.device)[None, :]
    tail = torch.gather(resid, 1, take)
    lags = torch.stack([resid[:, p - k:T - k] for k in range(1, p + 1)], dim=2)
    lag_mask = torch.prod(
        torch.stack([mask[:, p - k:T - k] for k in range(0, p + 1)], dim=2),
        dim=2)
    e = (resid[:, p:] - torch.einsum("stp,sp->st", lags, phi)) * lag_mask
    n_win = torch.sum(lag_mask, dim=1)
    sigma_inn = torch.sqrt(torch.sum(e**2, dim=1) / torch.clamp_min(n_win, 1.0))
    sigma_marg = torch.sqrt(torch.clamp_min(c[:, 0], 1e-12))
    return phi, tail, torch.where(n_win > 0, sigma_inn, sigma_marg), last


def _ar_tables(params: CurveParams, p: int):
    """(mean_table, var_table), each (K+1, S) for leads 0..K: the AR(p)
    h-step prediction from the stored tail, and its variance
    ``sigma_inn^2 * sum_{j<h} psi_j^2`` (psi: the MA(inf) weights).  A loop
    of K = 64 steps of (S, p) work."""
    phi_rev = params.ar_phi.flip(-1)
    S = phi_rev.shape[0]
    w = params.ar_tail
    psi_w = torch.cat([phi_rev.new_zeros((S, p - 1)), phi_rev.new_ones((S, 1))],
                      dim=1)
    var_acc = phi_rev.new_ones(S)
    means, var_sums = [], []
    for _ in range(_AR_TABLE_LEN):
        r_next = torch.sum(w * phi_rev, dim=1)
        w = torch.cat([w[:, 1:], r_next[:, None]], dim=1)
        var_sums.append(var_acc)
        psi_next = torch.sum(psi_w * phi_rev, dim=1)
        psi_w = torch.cat([psi_w[:, 1:], psi_next[:, None]], dim=1)
        var_acc = var_acc + psi_next**2
        means.append(r_next)
    mean_table = torch.stack([phi_rev.new_zeros(S)] + means)
    var_table = (torch.stack([phi_rev.new_ones(S)] + var_sums)
                 * params.ar_sigma[None, :] ** 2)
    return mean_table, var_table


def _ar_correction(params: CurveParams, day_all, t_end, p: int):
    """(mean, var, future mask), each (S, T_all), in normalized fit space.

    The lead is counted per series from its last observed day, so a stale
    series gets the decayed correction and the wider variance; the
    correction applies strictly after ``t_end`` ((n, 1): the batch end, or
    each row's cutoff).  Past the tables the mean is zero and the variance
    the marginal one.
    """
    mean_t, var_t = _ar_tables(params, p)
    dayf = day_all.to(torch.float32)
    h_raw = torch.round(dayf[None, :] - params.ar_last_day[:, None]).to(torch.int64)
    h_idx = torch.clamp(h_raw, 0, _AR_TABLE_LEN)
    within = h_raw <= _AR_TABLE_LEN
    fut = (dayf[None, :] > t_end) & (h_raw > 0)
    mean = torch.where(fut & within, torch.gather(mean_t.T, 1, h_idx), 0.0)
    var = torch.where(within, torch.gather(var_t.T, 1, h_idx),
                      params.sigma[:, None] ** 2)
    return mean, var, fut


def _predictive(params: CurveParams, day_all, t_end, config, xreg,
                generator=None, draws=None):
    """Fit-space predictive distribution over ``day_all``: ``(zhat, sd,
    paths)``, the point path (S, T_all) with either the analytic sd
    (S, T_all) and ``paths=None`` (``uncertainty_samples == 0``), or
    Monte-Carlo sample paths (S, N, T_all) and ``sd=None``.  The paths'
    draws are ``draws`` (``(occur, laplace, noise)`` standard draws, see
    :func:`draw_standard`) when given, else drawn from ``generator``."""
    dev = params.beta.device
    X, layout = _design(day_all, params.t0, params.t1, config)
    # the base design stays shared (T_all, F0) even with per-series
    # regressors: their contribution is added on top
    F0 = layout["n_features"]
    ys = params.y_scale[:, None]
    zhat = design_product(params.beta[:, :F0], X) * ys
    if _check_xreg(xreg, config, "forecast"):
        zhat = zhat + _regressor_contrib(params, xreg, F0) * ys
    t_end = t_end_rows(t_end, dev)
    t_all = scaled_time(day_all, params.t0, params.t1)
    te = (t_end - params.t0) / torch.clamp_min(params.t1 - params.t0, 1.0)
    var_obs = params.sigma[:, None] ** 2
    if config.ar_order > 0:
        ar_mean, ar_var, fut = _ar_correction(params, day_all, t_end,
                                              config.ar_order)
        zhat = zhat + ar_mean * ys
        var_obs = torch.where(fut, ar_var, var_obs)
    if config.uncertainty_samples > 0:
        S, T_all = zhat.shape
        N = config.uncertainty_samples
        if draws is None:
            gen = resolve_generator(generator, dev, 0)
            draws = draw_standard((S, N, _FUTURE_CP_GRID), (S, N, T_all),
                                  _cp_process(params, t_all, te, config)[1],
                                  gen)
        draws = tuple(torch.as_tensor(d, dtype=torch.float32, device=dev)
                      for d in draws)
        # in place: at Prophet's 1,000 samples the (S, N, T_all) paths and
        # the noise draws are the branch's two large tensors
        paths = _trend_deviation_samples(params, t_all, te, config, draws)
        paths.mul_(ys[:, :, None]).add_(zhat[:, None, :])
        paths.addcmul_(draws[2], (torch.sqrt(var_obs) * ys)[:, None, :])
        return zhat, None, paths
    var_dev = _trend_deviation_variance(params, t_all, te, config)
    return zhat, torch.sqrt(var_dev + var_obs) * ys, None


# rows of Monte-Carlo paths whose quantiles one call takes: each call holds
# at most this many path elements
_QUANTILE_CHUNK = 1 << 24


def _sample_quantiles(paths, qs) -> torch.Tensor:
    """Linear-interpolation quantiles (``jnp.quantile``'s default) of the
    (S, N, T) paths over the sample axis: (S, Q, T), in row blocks that
    keep each ``torch.quantile`` call under ``_QUANTILE_CHUNK`` elements."""
    S, N, T = paths.shape
    step = max(1, _QUANTILE_CHUNK // max(N * T, 1))
    q = torch.as_tensor(qs, dtype=torch.float32, device=paths.device)
    parts = [torch.quantile(paths[i:i + step], q, dim=1).permute(1, 0, 2)
             for i in range(0, S, step)]
    return torch.cat(parts)


def _to_data_space(v, params: CurveParams, config):
    """Fit space -> data space (monotone: fit-space quantiles map through).
    ``v`` leads with S and may have trailing axes."""
    if config.growth == "logistic":
        cap = params.cap.reshape((-1,) + (1,) * (v.dim() - 1))
        floor = float(config.floor_value)
        return floor + (cap - floor) * torch.sigmoid(v)
    if config.seasonality_mode == "multiplicative":
        return torch.exp(v)
    return v


def forecast(params: CurveParams, day_all, t_end, config: CurveModelConfig,
             xreg=None, generator=None, draws=None):
    """(yhat, lo, hi), each (S, T_all), over ``day_all`` (history + future):
    Prophet's ``predict`` on ``make_future_dataframe(include_history=True)``.
    ``t_end``: the forecast start, a scalar or one per row.  ``xreg``:
    regressor values over ``day_all``, required iff ``n_regressors > 0``.
    With ``uncertainty_samples > 0`` the band is the central
    ``interval_width`` of the Monte-Carlo paths, drawn from ``generator``
    (or given as ``draws``, see :func:`_predictive`)."""
    zhat, sd, paths = _predictive(params, day_all, t_end, config, xreg,
                                  generator, draws)
    if paths is not None:
        alpha = (1.0 - config.interval_width) / 2.0
        band = _sample_quantiles(paths, [alpha, 1.0 - alpha])
        lo, hi = band[:, 0], band[:, 1]
    else:
        z = _ndtri(0.5 + config.interval_width / 2.0, zhat.device)
        lo, hi = zhat - z * sd, zhat + z * sd
    return (_to_data_space(zhat, params, config),
            _to_data_space(lo, params, config),
            _to_data_space(hi, params, config))


def forecast_quantiles(params: CurveParams, day_all, t_end,
                       config: CurveModelConfig, quantiles=(0.1, 0.5, 0.9),
                       xreg=None, generator=None, draws=None):
    """(S, Q, T_all) forecast quantiles, non-decreasing along Q: each level
    priced from the fit-space Gaussian, or with ``uncertainty_samples > 0``
    taken over the Monte-Carlo paths, and mapped through the monotone
    data-space transform (so under multiplicative seasonality the band is
    Gaussian in log space, not in data space)."""
    if not quantiles or not all(0.0 < q < 1.0 for q in quantiles):
        raise ValueError(f"quantiles must lie in (0, 1), got {quantiles!r}")
    zhat, sd, paths = _predictive(params, day_all, t_end, config, xreg,
                                  generator, draws)
    if paths is not None:
        zq = _sample_quantiles(paths, tuple(quantiles))
    else:
        zq = zhat[:, None, :] \
            + _ndtri(tuple(quantiles), zhat.device)[None, :, None] \
            * sd[:, None, :]
    return _to_data_space(zq, params, config)


def decompose(params: CurveParams, day_all, config: CurveModelConfig,
              xreg=None, t_end=None) -> dict:
    """Per-component contributions over ``day_all`` in FIT SPACE — name ->
    (S, T_all): trend, weekly, yearly, holidays, each extra seasonality,
    ``regressors`` when ``xreg`` is given, ``ar`` when ``ar_order > 0`` and
    ``t_end`` is given.  They sum to the fit-space point path; under
    multiplicative seasonality exp(component) is its factor on yhat."""
    X, layout = _design(day_all, params.t0, params.t1, config)
    ys = params.y_scale[:, None]
    tr = slice(0, 2 + _n_cp(config))
    comps = {"trend": (params.beta[:, tr] @ X[:, tr].T) * ys}
    extra_names = tuple(str(e[0]) for e in config.extra_seasonalities)
    for name, key in ([(n, n) for n in ("weekly", "yearly", "holidays")]
                      + [(n, f"seas_{n}") for n in extra_names]):
        sl = layout.get(key)
        if sl is not None and (sl.stop - sl.start) > 0:
            comps[name] = (params.beta[:, sl] @ X[:, sl].T) * ys
    if xreg is not None:
        if config.n_regressors == 0:
            raise ValueError("xreg passed but config.n_regressors == 0")
        xreg = torch.as_tensor(xreg, dtype=torch.float32,
                               device=params.beta.device)
        if xreg.shape[-1] != config.n_regressors:
            raise ValueError(
                f"xreg has {xreg.shape[-1]} columns, config.n_regressors="
                f"{config.n_regressors}"
            )
        if xreg.shape[-2] != day_all.shape[0]:
            raise ValueError(
                f"xreg time axis is {xreg.shape[-2]}, expected "
                f"len(day_all) = {day_all.shape[0]}"
            )
        comps["regressors"] = (
            _regressor_contrib(params, xreg, layout["n_features"]) * ys)
    if config.ar_order > 0 and t_end is not None:
        ar_mean, _, _ = _ar_correction(
            params, day_all, t_end_rows(t_end, params.beta.device),
            config.ar_order)
        comps["ar"] = ar_mean * ys
    # in name order, as the reference's (jit returns a dict key-sorted):
    # component_frame's columns follow it
    return dict(sorted(comps.items()))


def component_frame(batch, params: CurveParams, config: CurveModelConfig,
                    horizon: int = 0, xreg=None):
    """Long component table ``[ds, *keys, trend, weekly, yearly, ...]`` over
    history + ``horizon`` days, fit-space values (see :func:`decompose`)."""
    import pandas as pd

    from distributed_forecasting_tpu_torch.engine.fit import (
        day_grid,
        long_frame_skeleton,
    )

    day_all = day_grid(batch.day, horizon)
    comps = decompose(params, day_all, config, xreg=xreg,
                      t_end=batch.day[-1].to(torch.float32))
    frame = long_frame_skeleton(batch.keys, batch.key_names, day_all,
                                freq=batch.freq)
    for name, vals in comps.items():
        frame[name] = vals.cpu().numpy().reshape(-1)
    return pd.DataFrame(frame)


def extract_params(params: CurveParams, config: CurveModelConfig) -> dict:
    """Loggable scalar settings of the fit (Prophet's SIMPLE_ATTRIBUTES)."""
    return {
        "growth": config.growth,
        "n_changepoints": _n_cp(config),
        "explicit_changepoints": bool(config.changepoint_days),
        "changepoint_range": config.changepoint_range,
        "changepoint_prior_scale": config.changepoint_prior_scale,
        "seasonality_prior_scale": config.seasonality_prior_scale,
        "seasonality_mode": config.seasonality_mode,
        "interval_width": config.interval_width,
        "weekly_order": config.weekly_order,
        "yearly_order": config.yearly_order,
        "extra_seasonalities": ",".join(
            f"{n}:{p}:{o}" + (f":{ps}" if ps is not None else "")
            for n, p, o, ps in _extra_entries(config)
        ) or "none",
        "uncertainty_samples": config.uncertainty_samples,
        "n_holidays": len(config.holidays),
        "holiday_prior_scale": config.holiday_prior_scale,
        "n_regressors": config.n_regressors,
        "regressor_prior_scale": config.regressor_prior_scale,
        "ar_order": config.ar_order,
    }


@dataclasses.dataclass(frozen=True)
class CurveModelConfigAR(CurveModelConfig):
    """The curve model with AR-on-residuals on by default (``prophet_ar``)."""

    ar_order: int = 1


register_model("prophet_ar", fit, forecast, CurveModelConfigAR,
               forecast_quantiles=forecast_quantiles, supports_xreg=True,
               draws=True)
register_model("prophet", fit, forecast, CurveModelConfig,
               forecast_quantiles=forecast_quantiles, supports_xreg=True,
               draws=True)
register_model("curve", fit, forecast, CurveModelConfig,
               forecast_quantiles=forecast_quantiles, supports_xreg=True,
               draws=True)
