"""Prophet MAP oracle — the reference model's EXACT objective, in-repo.

The reference's production model is the ``prophet`` package with this config
(reference ``notebooks/prophet/02_training.py:162-186``): linear growth,
weekly+yearly seasonality, multiplicative mode, 95% intervals, MAP fit via
Stan's L-BFGS (``cmdstan optimize``).  The prophet package cannot be
installed in the zero-egress image (BASELINE.md records the parity
claim as unverified against the real package), so this module implements
the same generative model from its published specification (Taylor &
Letham, "Forecasting at scale", 2017; the Stan program shipped in
prophet) and fits it the same way — L-BFGS on the penalized joint density,
no Jacobian adjustment, matching ``cmdstan optimize``'s default:

  trend      g(t) = (k + A(t) delta) * t + (m + A(t) gamma),
             gamma_j = -s_j delta_j   (continuity at changepoints);
             25 changepoints uniform over the first 80% of history
  seasonal   X(t) beta, Fourier features: yearly period 365.25 order 10,
             weekly period 7 order 3 (t in absolute days, prophet's
             ``fourier_series``)
  model      y/scale ~ Normal(g(t) * (1 + X(t) beta), sigma)   [mult. mode]
  priors     delta ~ Laplace(0, 0.05); beta ~ Normal(0, 10);
             sigma ~ HalfNormal(0.5); k, m flat
  scaling    scale = max|y| (linear growth); t scaled to [0, 1] over the
             fit window

The port's copy of the reference's ``models/prophet_map.py`` (numpy and
scipy only, the same code): ``chip_smoke.py`` phase 24 runs it beside the
port's curve-model CV on the card, as ``scripts/prophet_parity.py
--oracle`` does for the reference.  This is an ORACLE for accuracy
measurement, not a production path: it fits one series at a time with scipy
L-BFGS-B over a float64 numpy objective with analytic gradients, exactly
because that is what Stan does (f64 L-BFGS) — and deliberately WITHOUT
touching the framework's torch compute path, so the production
``models/prophet_glm`` batched estimator is measured against a fully
independent implementation.  It is also a DIFFERENT estimator (L1
changepoint posterior vs closed-form ridge), so the CV-MAPE delta
between them measures model-quality parity, not self-agreement.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass(frozen=True)
class ProphetMAPConfig:
    """Defaults == the prophet package's defaults under the reference's
    training config (multiplicative weekly+yearly, linear growth)."""

    n_changepoints: int = 25
    changepoint_range: float = 0.8
    changepoint_prior_scale: float = 0.05   # tau: Laplace scale on delta
    seasonality_prior_scale: float = 10.0   # sigma: Normal scale on beta
    yearly_order: int = 10
    weekly_order: int = 3
    sigma_prior_scale: float = 0.5          # HalfNormal scale on sigma_obs
    maxiter: int = 2000                     # cmdstan optimize default


@dataclass
class ProphetMAPParams:
    k: float
    m: float
    delta: np.ndarray       # (S,)
    beta: np.ndarray        # (F,)
    sigma: float
    t_change: np.ndarray    # (S,) changepoints in scaled time
    t0_days: float          # absolute day of the fit window's first point
    t_span_days: float      # fit window length in days (scaled-time unit)
    y_scale: float


def _fourier(t_days: np.ndarray, period: float, order: int) -> np.ndarray:
    """prophet's ``fourier_series``: t in absolute days; (T, 2*order)
    columns [sin(2*pi*1*t/P), cos(2*pi*1*t/P), sin(2*pi*2*t/P), ...]."""
    cols = []
    for n in range(1, order + 1):
        ang = 2.0 * np.pi * n * t_days / period
        cols.append(np.sin(ang))
        cols.append(np.cos(ang))
    return np.stack(cols, axis=1).astype(np.float64)


def _design(t_days: np.ndarray, cfg: ProphetMAPConfig) -> np.ndarray:
    return np.concatenate(
        [
            _fourier(t_days, 365.25, cfg.yearly_order),
            _fourier(t_days, 7.0, cfg.weekly_order),
        ],
        axis=1,
    )


def _changepoints(t_scaled: np.ndarray, cfg: ProphetMAPConfig) -> np.ndarray:
    """prophet's ``set_changepoints``: evenly spaced over the first
    ``changepoint_range`` of HISTORY ROWS, first point excluded."""
    T = t_scaled.shape[0]
    hist = int(np.floor(T * cfg.changepoint_range))
    n = min(cfg.n_changepoints, max(hist - 1, 1))
    idx = np.linspace(0, hist - 1, n + 1).round().astype(int)[1:]
    return t_scaled[idx].astype(np.float64)


def _objective_fn(t, A, A_s, X, y_s, tau: float, beta_sd: float,
                  sigma_sd: float):
    """Penalized joint density + analytic gradient, float64 numpy.

    Trend is (k + A delta) t + (m - A_s delta): A is the changepoint
    indicator matrix and A_s = A * t_change carries the continuity
    offsets gamma_j = -s_j delta_j.  Stan optimizes the same density in
    float64 L-BFGS; an earlier float32-JAX variant of this objective
    left the seasonal amplitudes ~25% short at L-BFGS-B's default
    tolerances.
    """
    T = t.shape[0]
    S = A.shape[1]
    F = X.shape[1]
    At_As = A * t[:, None] - A_s  # d(trend)/d(delta), (T, S)

    def f(theta):
        # errstate: a wild line-search step can underflow sigma to 0 (1/0
        # divide) or overflow mu; the non-finite guard below handles those
        # steps correctly, so the transient RuntimeWarnings are pure noise
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            k, m = theta[0], theta[1]
            delta = theta[2 : 2 + S]
            beta = theta[2 + S : 2 + S + F]
            log_sigma = theta[-1]
            sigma = np.exp(log_sigma)
            g = (k + A @ delta) * t + (m - A_s @ delta)
            season = 1.0 + X @ beta
            mu = g * season
            err = y_s - mu
            inv_s2 = 1.0 / sigma**2
            val = (
                0.5 * inv_s2 * float(err @ err)
                + T * log_sigma
                + float(np.sum(np.abs(delta))) / tau
                + 0.5 * float(beta @ beta) / beta_sd**2
                + 0.5 * sigma**2 / sigma_sd**2
            )
            if not np.isfinite(val):
                # a wild line-search step (sigma underflow / mu overflow):
                # return a huge finite value with a zero gradient so L-BFGS-B
                # backtracks instead of propagating NaNs into its history
                return 1e15, np.zeros_like(theta)
            dmu = -err * inv_s2          # dL/dmu, (T,)
            ds = dmu * season            # dL/d(trend)
            dg = dmu * g                 # dL/d(season term X beta)
            grad = np.empty_like(theta)
            grad[0] = float(ds @ t)
            grad[1] = float(np.sum(ds))
            grad[2 : 2 + S] = At_As.T @ ds + np.sign(delta) / tau
            grad[2 + S : 2 + S + F] = X.T @ dg + beta / beta_sd**2
            grad[-1] = -inv_s2 * float(err @ err) + T + sigma**2 / sigma_sd**2
            return val, grad

    return f


def fit_map(
    day: np.ndarray, y: np.ndarray, cfg: ProphetMAPConfig = ProphetMAPConfig()
) -> ProphetMAPParams:
    """MAP fit of one series.  ``day``: absolute integer day numbers
    (monotone, gaps allowed); ``y``: observations, same length."""
    from scipy.optimize import minimize

    day = np.asarray(day, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    t0, t1 = float(day[0]), float(day[-1])
    span = max(t1 - t0, 1.0)
    t = (day - t0) / span
    y_scale = max(float(np.max(np.abs(y))), 1e-10)
    y_s = y / y_scale

    t_change = _changepoints(t, cfg)
    S = t_change.shape[0]
    A = (t[:, None] >= t_change[None, :]).astype(np.float64)       # (T, S)
    A_s = A * t_change[None, :]                                    # (T, S)
    X = _design(day, cfg)                                          # (T, F)
    F = X.shape[1]

    # prophet's linear_growth_init
    k0 = (y_s[-1] - y_s[0]) / max(float(t[-1] - t[0]), 1e-10)
    m0 = y_s[0] - k0 * t[0]
    theta0 = np.zeros(2 + S + F + 1, dtype=np.float64)
    theta0[0], theta0[1] = k0, m0
    theta0[-1] = 0.0  # log sigma = 0 -> sigma = 1, prophet's init

    f = _objective_fn(t, A, A_s, X, y_s, cfg.changepoint_prior_scale,
                      cfg.seasonality_prior_scale, cfg.sigma_prior_scale)
    res = minimize(f, theta0, jac=True, method="L-BFGS-B",
                   options={"maxiter": cfg.maxiter, "maxcor": 20})
    th = res.x
    return ProphetMAPParams(
        k=float(th[0]), m=float(th[1]),
        delta=th[2 : 2 + S].copy(), beta=th[2 + S : 2 + S + F].copy(),
        sigma=float(np.exp(th[-1])), t_change=t_change,
        t0_days=t0, t_span_days=span, y_scale=y_scale,
    )


def predict(params: ProphetMAPParams, day: np.ndarray,
            cfg: ProphetMAPConfig = ProphetMAPConfig()) -> np.ndarray:
    """Point forecast (yhat) on absolute day numbers — in-sample or
    future; the trend extrapolates the last fitted segment, exactly
    prophet's deterministic ``predict`` path."""
    day = np.asarray(day, dtype=np.float64)
    t = (day - params.t0_days) / params.t_span_days
    A = (t[:, None] >= params.t_change[None, :]).astype(np.float64)
    slope = params.k + A @ params.delta
    offset = params.m - A @ (params.t_change * params.delta)
    g = slope * t + offset
    X = _design(day, cfg)
    yhat_s = g * (1.0 + X @ params.beta)
    return (yhat_s * params.y_scale).astype(np.float64)


def cv_cutoff_days(day: np.ndarray, initial: int = 730, period: int = 360,
                   horizon: int = 90) -> np.ndarray:
    """prophet.diagnostics.generate_cutoffs on integer days: last cutoff =
    max(day) - horizon, stepping back by ``period`` while the training
    window keeps >= ``initial`` days."""
    day = np.asarray(day, dtype=np.float64)
    cutoffs = []
    c = float(day.max()) - horizon
    while c - float(day.min()) >= initial:
        cutoffs.append(c)
        c -= period
    if not cutoffs:
        raise ValueError(
            f"series too short for CV: span {day.max() - day.min():.0f}d "
            f"< initial {initial}d + horizon {horizon}d"
        )
    return np.asarray(sorted(cutoffs))


def cv_mape(day: np.ndarray, y: np.ndarray,
            cfg: ProphetMAPConfig = ProphetMAPConfig(),
            initial: int = 730, period: int = 360,
            horizon: int = 90) -> float:
    """Rolling-origin CV MAPE, the reference's protocol
    (``notebooks/prophet/02_training.py:179-186``): fit on data through
    each cutoff, forecast ``horizon`` days, mean |y-yhat|/|y| over all
    horizon points with y != 0 pooled across cutoffs."""
    day = np.asarray(day, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    apes = []
    for c in cv_cutoff_days(day, initial, period, horizon):
        tr = day <= c
        te = (day > c) & (day <= c + horizon)
        if not te.any():
            continue
        params = fit_map(day[tr], y[tr], cfg)
        yhat = predict(params, day[te], cfg)
        yy = y[te]
        nz = np.abs(yy) > 1e-9
        apes.append(np.abs(yy[nz] - yhat[nz]) / np.abs(yy[nz]))
    return float(np.concatenate(apes).mean())
