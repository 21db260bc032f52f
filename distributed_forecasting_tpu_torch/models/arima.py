"""Batched ARIMA(p, d, q) by Hannan-Rissanen and a state-space Kalman filter
(port of the reference's ``models/arima.py``).

Fit (``method='hr'``, the reference's default): difference (d in {0, 1}),
center, then the closed-form Hannan-Rissanen estimate — a long-AR
Yule-Walker solve, the innovations it leaves, and one ridge regression of
the series on its AR lag set and the innovations' MA lag set (seasonal SARMA
terms are more lags in those sets) — projected into the stationary and
invertible region through the PACF.  One Kalman pass then gives sigma^2, the
final state and the one-step fitted path, integrated back to the original
scale for d = 1.  Forecast runs the predict-only recursion from the final
state.

Harvey's state space: state dimension r = max(p, q + 1), transition T with
phi in its first column and ones on its superdiagonal, disturbance loading
R = (1, theta_1..theta_q, 0..), observation e_1, no observation noise.  T's
structure makes ``T a``, ``T P`` and ``T P T'`` pairs of terms
(:func:`_ta`, :func:`_tpt`), the non-zero terms of the reference's dense
products in their order.

The Kalman pass and the forecast recursion run on the card as hand-written
CUDA kernels (``ops/kalman``); the sequential loops here are their plain
twins, which the CPU runs.  ``kalman='pscan'`` runs the filter as a parallel
prefix instead (``ops/pkalman``); its d = 1 integration is the sequential
loop, as in the reference.  Missing values take the predict-only branch of
the filter, as state-space models handle gaps.

``method='mle'`` fits the coefficients by ``fit_steps`` steps of Adam on the
exact concentrated Gaussian likelihood plus a Gaussian prior on the
unconstrained PACF parameters, every series at once (the reference vmaps
one Adam per series; the update is elementwise and every row's count the
same, so one Adam over the stacked rows is the same update).  On the card
the whole fit is one launch of ``ops/kalman.arima_mle_fit``: each step maps
u to the coefficients and, in forward mode, to the Jacobian's columns,
runs the sequential filter (whatever ``kalman`` says, as in the reference)
with one tangent per coordinate of u, forms the loss's gradient and takes
the Adam step.  Its plain twin :func:`mle_fit_reference` writes the same
operations in torch (:func:`_pacf_directions`,
:func:`arima_loglik_grad_reference`, :func:`_mle_grad`, ``ops/optim.adam``).
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_forecasting_tpu_torch.models.base import (
    _ndtri,
    cumsum_rows,
    gaussian_quantiles,
    register_model,
)
from distributed_forecasting_tpu_torch.ops.kalman import (
    arima_filter,
    arima_mle_fit,
    arima_predict,
    first_observed,
)
from distributed_forecasting_tpu_torch.ops.optim import adam
from distributed_forecasting_tpu_torch.ops.pkalman import (
    parallel_kalman_filter,
)
from distributed_forecasting_tpu_torch.ops.solve import (
    solve_dense,
    yule_walker_masked,
)

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ArimaConfig:
    p: int = 2
    d: int = 1
    q: int = 1
    # seasonal (SARMA) terms: AR/MA lags at multiples of m, the additive
    # subset form phi_1..phi_p plus Phi_1 B^m..Phi_P B^{Pm}, estimated by the
    # HR regression as extra lag features
    P: int = 0
    Q: int = 0
    m: int = 7
    interval_width: float = 0.95
    # 'hr': closed-form Hannan-Rissanen.  'mle': fit_steps steps of Adam on
    # the exact Kalman likelihood (no seasonal terms)
    method: str = "hr"
    # long-AR order of the HR innovation estimate
    hr_ar_order: int = 20
    fit_steps: int = 200
    learning_rate: float = 0.05
    # Gaussian prior on the unconstrained (atanh-PACF) parameters: keeps MAP
    # solutions off the stationarity boundary
    prior_scale: float = 1.0
    # final filtering pass: 'scan' the sequential filter (on the card the
    # arima_filter kernel); 'pscan' the associative-scan filter
    # (ops/pkalman), O(log T) depth, the same results within float tolerance
    kalman: str = "scan"


@dataclasses.dataclass(frozen=True)
class ArimaParams:
    phi: torch.Tensor         # (S, p_eff) AR coefficients
    theta: torch.Tensor       # (S, q_eff) MA coefficients
    sigma2: torch.Tensor      # (S,) innovation variance (differenced space)
    mean: torch.Tensor        # (S,) mean of the differenced series
    a_last: torch.Tensor      # (S, r) final predictive state
    P_last: torch.Tensor      # (S, r, r) its covariance
    level_end: torch.Tensor   # (S,) level at the fit grid's end (d = 1): the
                              # last observed y, or the carried-forward
                              # predicted level after an unobserved stretch
    var_end: torch.Tensor     # (S,) accumulated level variance at the end
    fitted: torch.Tensor      # (S, T) one-step fitted values, original grid
    fitted_var: torch.Tensor  # (S, T) their predictive variance
    day0: torch.Tensor        # () first training day, float32
    t_fit_end: torch.Tensor   # () last training day, float32


# -- stationarity: the PACF maps (Durbin-Levinson), batched over rows --------

def _pacf_stack(r: torch.Tensor) -> torch.Tensor:
    """Durbin-Levinson: PACF sequences (S, k) in (-1, 1) -> AR
    coefficients (S, k)."""
    k = r.shape[1]
    coef = torch.zeros_like(r)
    for j in range(k):
        prev = coef[:, :j]
        new = prev - r[:, j:j + 1] * prev.flip(1)
        coef = torch.cat([new, r[:, j:j + 1], coef[:, j + 1:]], dim=1)
    return coef


def _pacf_to_coef(u: torch.Tensor) -> torch.Tensor:
    """Monahan map: unconstrained (S, k) -> stationary AR coefficients."""
    return _pacf_stack(torch.tanh(u))


def _coef_to_pacf(c: torch.Tensor) -> torch.Tensor:
    """Inverse Durbin-Levinson: AR coefficients (S, k) -> PACF sequences.
    The reverse recursion divides by 1 - pac_j^2, floored at 1e-6 so a
    numerically non-stationary input degrades instead of going inf/nan."""
    k = c.shape[1]
    pac = torch.zeros_like(c)
    cur = c
    for j in range(k - 1, -1, -1):
        pj = cur[:, j]
        pac[:, j] = pj
        if j > 0:
            prev = cur[:, :j]
            denom = torch.clamp_min(1.0 - pj * pj, 1e-6)
            cur = (prev + pj[:, None] * prev.flip(1)) / denom[:, None]
    return pac


def _stabilize(c: torch.Tensor, limit: float = 0.97) -> torch.Tensor:
    """Project coefficients (S, k) into the stationary / invertible region
    by clipping their PACF: the identity for interior points, a gentle
    shrink for boundary and exterior ones."""
    if c.shape[1] == 0:
        return c
    return _pacf_stack(torch.clamp(_coef_to_pacf(c), -limit, limit))


# -- the state space and its plain filters (the kernels' twins) --------------

def _pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """(S, k) -> (S, r), zero past k."""
    return torch.nn.functional.pad(x, (0, r - x.shape[1]))


def _model(phi, theta, r: int):
    """``(phi_pad (S, r), Rv (S, r), RRt (S, r, r))``: T's first column and
    the disturbance loading R = (1, theta, 0..) with its outer product."""
    ph = _pad(phi, r)
    Rv = _pad(torch.cat([theta.new_ones((theta.shape[0], 1)), theta], dim=1),
              r)
    return ph, Rv, Rv[:, :, None] * Rv[:, None, :]


def _build_ssm(phi, theta, r: int):
    """Dense transition T (S, r, r) and loading R (S, r) of Harvey's form."""
    ph, Rv, _ = _model(phi, theta, r)
    T_mat = torch.diag_embed(ph.new_ones(r - 1), offset=1).expand(
        ph.shape[0], r, r).clone()
    T_mat[:, :, 0] = T_mat[:, :, 0] + ph
    return T_mat, Rv


def _shift(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x moved one place down ``dim`` (entry i takes i + 1), zero last."""
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, 1]
    return torch.nn.functional.pad(x.narrow(dim, 1, x.shape[dim] - 1), pad)


def _ta(ph, a):
    """T a: (T a)_i = phi_i a_0 + a_{i+1} (over the last axis; leading axes
    broadcast)."""
    return ph * a[..., :1] + _shift(a, -1)


def _tp(ph, P):
    """M = T P: M_il = phi_i P_0l + P_{i+1,l}."""
    return ph[..., :, None] * P[..., :1, :] + _shift(P, -2)


def _tpt(ph, M):
    """T P T' from M = T P: N_ij = M_i0 phi_j + M_{i,j+1}."""
    return M[..., :, :1] * ph[..., None, :] + _shift(M, -1)


def _init_cov(ph, RRt, n_iter: int = 30):
    """Stationary covariance by fixed-point iteration of the Lyapunov
    equation P = T P T' + R R' from R R' (converges geometrically for a
    stationary T)."""
    P = RRt
    for _ in range(n_iter):
        P = _tpt(ph, _tp(ph, P)) + RRt
    return P


def _kalman_loglik_impl(z, mask, phi, theta, r: int):
    """The sequential Kalman filter of every row, one Python loop over T
    (the plain twin of ``ops/kalman.arima_filter``).  z, mask: (S, T).
    Unit innovation variance (sigma2 is concentrated out).  Returns
    ``(ssq, ldet, n, preds, Fs, a_T, P_T)``."""
    S, T = z.shape
    ph, _, RRt = _model(phi, theta, r)
    P = _init_cov(ph, RRt)
    a = z.new_zeros((S, r))
    ssq, ldet, n = z.new_zeros(S), z.new_zeros(S), z.new_zeros(S)
    preds, Fs = z.new_empty((S, T)), z.new_empty((S, T))
    obs = mask > 0
    for t in range(T):
        ot = obs[:, t]
        pred = a[:, 0]
        F = torch.clamp_min(P[:, 0, 0], _EPS)
        v = z[:, t] - pred
        M = _tp(ph, P)
        K = M[:, :, 0] / F[:, None]
        Ta = _ta(ph, a)
        P_pred = _tpt(ph, M) + RRt
        a = torch.where(ot[:, None], Ta + K * v[:, None], Ta)
        P = torch.where(ot[:, None, None], P_pred - (
            K[:, :, None] * K[:, None, :]) * F[:, None, None], P_pred)
        ssq = ssq + torch.where(ot, v * v / F, 0.0)
        ldet = ldet + torch.where(ot, torch.log(F), 0.0)
        n = n + mask[:, t]
        preds[:, t] = pred
        Fs[:, t] = F
    return ssq, ldet, n, preds, Fs, a, P


def _pacf_jacobian(u: torch.Tensor):
    """The Monahan map of ``u`` (S, m) (:func:`_pacf_to_coef`) and its
    forward-mode tangent along each coordinate: ``(coef (S, m), dcoef (S, m,
    m))`` with ``dcoef[:, j]`` = d coef / d u_j.  Through tanh (derivative
    (1 - t)(1 + t)) and the Durbin-Levinson recursion: the MLE kernel's
    operations (``csrc/arima_mle.cu``, ``Model::pacf``), in its order."""
    S, m = u.shape
    t = torch.tanh(u)
    dt = torch.diag_embed((1.0 - t) * (1.0 + t))  # (S, direction, j)
    coef, dcoef = u.new_zeros((S, m)), u.new_zeros((S, m, m))
    for j in range(m):
        prev, dprev = coef[:, :j], dcoef[:, :, :j]
        rj, drj = t[:, j:j + 1], dt[:, :, j:j + 1]
        new = prev - rj * prev.flip(1)
        dnew = dprev - (drj * prev.flip(1)[:, None]
                        + rj[:, :, None] * dprev.flip(2))
        coef = torch.cat([new, rj, coef[:, j + 1:]], dim=1)
        dcoef = torch.cat([dnew, drj, dcoef[:, :, j + 1:]], dim=2)
    return coef, dcoef


def _pacf_directions(u: torch.Tensor, p: int, q: int, r: int):
    """``(phi (S, p), theta (S, q), dph (S, p + q, r), dRv (S, p + q, r))``:
    the coefficients at u and, for each coordinate u_j, the tangents of T's
    first column and of the loading R = (1, theta, 0..) along it (column j
    of the map's Jacobian, zero where u_j belongs to the other
    polynomial)."""
    S, k = u.shape[0], p + q
    phi, dphi = _pacf_jacobian(u[:, :p])
    theta, dtheta = _pacf_jacobian(u[:, p:p + q])
    dph, dRv = u.new_zeros((S, k, r)), u.new_zeros((S, k, r))
    dph[:, :p, :p] = dphi
    dRv[:, p:, 1:q + 1] = dtheta
    return phi, theta, dph, dRv


def arima_loglik_grad_reference(zc, zmask, phi, theta, r: int, dph=None,
                                dRv=None):
    """The plain twin of ``ops/kalman.arima_loglik_grad``: the sequential
    Kalman filter of :func:`_kalman_loglik_impl` (the same operations: its
    ssq, ldet and n are that filter's) and, carried beside it in forward
    mode, one tangent (da, dP) per direction.  zc, zmask: (S, T); phi (S,
    p), theta (S, q).  A direction is a pair (dph, dRv), tangents of T's
    first column and of the loading R; by default one per coefficient of
    (phi_1..phi_p, theta_1..theta_q), one-hot; else ``dph``, ``dRv`` (S, k,
    r) dense, as the MLE fit's map gives them (:func:`_pacf_directions`).

    d(T X) = T dX + dph X_0. and d(M T') = dM T' + M_.0 dph'.  An observed
    step adds dF = dP_00 (0 where P_00 is floored), dv = -da_0, dK = (dM_.0
    - K dF) rF with rF = 1 / F (one reciprocal a step on the tangent side,
    as the kernel computes it), and the gain terms' tangents to da and dP;
    a masked step takes the predict branch's.  Returns ``(ssq, ldet, n,
    dssq, dldet)``: (S,) each, and the derivatives (S, k) of ssq and ldet
    along each direction."""
    S, T = zc.shape
    p, q = phi.shape[1], theta.shape[1]
    ph, Rv, RRt = _model(phi, theta, r)
    if dph is None:
        k = p + q
        eye = torch.eye(r, dtype=zc.dtype, device=zc.device)
        dph = torch.cat([eye[:p], eye.new_zeros((q, r))]).expand(S, k, r)
        dRv = torch.cat([eye.new_zeros((p, r)), eye[1:q + 1]]).expand(S, k, r)
    k = dph.shape[1]
    ph1, Rv1 = ph[:, None], Rv[:, None]
    dRRt = (dRv[..., :, None] * Rv1[..., None, :]
            + Rv1[..., :, None] * dRv[..., None, :])

    def tangent_tp(dP, P):
        return _tp(ph1, dP) + dph[..., :, None] * P[:, None, :1, :]

    def tangent_tpt(dM, M):
        return (_tpt(ph1, dM) + M[:, None, :, :1] * dph[..., None, :]) + dRRt

    P, dP = RRt, dRRt.expand(S, k, r, r)
    for _ in range(30):  # _init_cov's iterations and their tangents
        M, dM = _tp(ph, P), tangent_tp(dP, P)
        P, dP = _tpt(ph, M) + RRt, tangent_tpt(dM, M)
    a, da = zc.new_zeros((S, r)), zc.new_zeros((S, k, r))
    ssq, ldet, n = zc.new_zeros(S), zc.new_zeros(S), zc.new_zeros(S)
    dssq, dldet = zc.new_zeros((S, k)), zc.new_zeros((S, k))
    obs = zmask > 0
    for t in range(T):
        ot = obs[:, t]
        o1, o2, o3 = ot[:, None], ot[:, None, None], ot[:, None, None, None]
        pred = a[:, 0]
        F = torch.clamp_min(P[:, 0, 0], _EPS)
        v = zc[:, t] - pred
        dF = torch.where((P[:, 0, 0] > _EPS)[:, None], dP[..., 0, 0], 0.0)
        dv = -da[..., 0]
        rF = F.reciprocal()[:, None]
        M, dM = _tp(ph, P), tangent_tp(dP, P)
        K = M[:, :, 0] / F[:, None]
        dK = (dM[..., :, 0] - K[:, None] * dF[..., None]) * rF[..., None]
        Ta = _ta(ph, a)
        dTa = _ta(ph1, da) + dph * a[:, None, :1]
        P_pred, dP_pred = _tpt(ph, M) + RRt, tangent_tpt(dM, M)
        K1 = K[:, None]
        KK = K[:, :, None] * K[:, None, :]
        a = torch.where(o1, Ta + K * v[:, None], Ta)
        da = torch.where(o2, (dTa + dK * v[:, None, None])
                         + K1 * dv[..., None], dTa)
        P = torch.where(o2, P_pred - KK * F[:, None, None], P_pred)
        dP = torch.where(o3, dP_pred - (
            (dK[..., :, None] * K1[..., None, :]
             + K1[..., :, None] * dK[..., None, :]) * F[:, None, None, None]
            + KK[:, None] * dF[..., None, None]), dP_pred)
        w = v * v / F
        ssq = ssq + torch.where(ot, w, 0.0)
        ldet = ldet + torch.where(ot, torch.log(F), 0.0)
        n = n + zmask[:, t]
        dssq = dssq + torch.where(
            o1, (2.0 * v[:, None] * dv - w[:, None] * dF) * rF, 0.0)
        dldet = dldet + torch.where(o1, dF * rF, 0.0)
    return ssq, ldet, n, dssq, dldet


def _integrate(y, mask, zhat, Fs, sigma2, y_first):
    """The d = 1 integration, one Python loop over T: the fitted level
    starts at each row's first observed value, resets to y where observed,
    and over unobserved stretches (gaps, CV eval windows: the actual y must
    not leak) carries the predicted level forward, accumulating variance
    random-walk style.  Returns ``(fitted, fitted_var, level_end,
    var_end)``."""
    S, T = y.shape
    lvl, var = y_first, y.new_zeros(S)
    fitted, fitted_var = y.new_empty((S, T)), y.new_empty((S, T))
    obs = mask > 0
    for t in range(T):
        mean_t = lvl + zhat[:, t]
        var_t = var + Fs[:, t] * sigma2
        fitted[:, t] = mean_t
        fitted_var[:, t] = var_t
        lvl = torch.where(obs[:, t], y[:, t], mean_t)
        var = torch.where(obs[:, t], 0.0 * var_t, var_t)
    return fitted, fitted_var, lvl, var


def _predict_path(phi, theta, a0, P0, sigma2, r: int, H: int):
    """The predict-only recursion, one Python loop over H (the plain twin
    of ``ops/kalman.arima_predict``): ``(zf, vf)``, (S, H) each."""
    ph, _, RRt = _model(phi, theta, r)
    a, P = a0, P0
    zf = a0.new_empty((a0.shape[0], H))
    vf = a0.new_empty((a0.shape[0], H))
    for h in range(H):
        a = _ta(ph, a)
        P = _tpt(ph, _tp(ph, P)) + RRt
        zf[:, h] = a[:, 0]
        vf[:, h] = P[:, 0, 0] * sigma2
    return zf, vf


# -- Hannan-Rissanen ---------------------------------------------------------

def _lag(x, k: int):
    """Time shift: out[:, t] = x[:, t - k], zero-filled at the front."""
    if k == 0:
        return x
    return torch.nn.functional.pad(x, (k, 0))[:, : x.shape[1]]


def _lag_sets(config: ArimaConfig):
    """AR / MA lag sets with the seasonal terms, deduplicated and sorted, and
    the dense polynomial orders they scatter into."""
    if (config.P > 0 or config.Q > 0) and config.m < 1:
        raise ValueError(
            f"seasonal orders P={config.P}/Q={config.Q} require a seasonal "
            f"period m >= 1, got m={config.m}"
        )
    ar = sorted(set(range(1, config.p + 1))
                | {config.m * i for i in range(1, config.P + 1)})
    ma = sorted(set(range(1, config.q + 1))
                | {config.m * j for j in range(1, config.Q + 1)})
    return ar, ma, (ar[-1] if ar else 0), (ma[-1] if ma else 0)


def _effective_r(config: ArimaConfig) -> int:
    _, _, p_eff, q_eff = _lag_sets(config)
    return max(p_eff, q_eff + 1, 1)


def _hr_regression(z, m, ar_lags, ma_lags, K: int, ridge: float = 1e-4):
    """The Hannan-Rissanen regression's sufficient statistics.  z, m: the
    centered differenced series and its mask, (S, T).  Returns ``(coef (S,
    F), gram (S, F, F), n_valid (S,), sigma2 (S,))``: the raw regression
    coefficients over the lag-set features ``ar_lags + ma_lags``, the ridged
    normal matrix, the rows with every lag observed and the regression's
    residual variance."""
    S, T = z.shape
    zm = z * m
    g0 = torch.clamp_min(
        torch.sum(zm * zm, dim=1) / torch.clamp_min(torch.sum(m, dim=1), 1.0),
        _EPS)
    a, _ = yule_walker_masked(z, m, K, per_lag_norm=True, jitter_abs=ridge,
                              eps=_EPS)                     # (S, K)

    e = zm
    evalid = m
    for i in range(1, K + 1):
        e = e - a[:, i - 1:i] * _lag(zm, i)
        evalid = evalid * _lag(m, i)
    e = e * evalid

    F = len(ar_lags) + len(ma_lags)
    if F == 0:
        return (z.new_zeros((S, 0)), z.new_zeros((S, 0, 0)), z.new_ones(S),
                torch.clamp_min(g0, _EPS))
    feats = [_lag(zm, i) for i in ar_lags] + [_lag(e, j) for j in ma_lags]
    valid = m
    for i in ar_lags:
        valid = valid * _lag(m, i)
    for j in ma_lags:
        valid = valid * _lag(evalid, j)
    X = torch.stack(feats, dim=2) * valid[..., None]        # (S, T, F)
    zv = zm * valid
    n_valid = torch.clamp_min(torch.sum(valid, dim=1), 1.0)
    G = X.mT @ X
    G = G + (ridge * g0 * n_valid)[:, None, None] * torch.eye(
        F, dtype=z.dtype, device=z.device)[None]
    b = (zv[:, None, :] @ X)[:, 0, :]
    coef = solve_dense(G, b)
    resid = zv - (X @ coef[:, :, None])[..., 0] * valid
    sigma2 = torch.clamp_min(torch.sum(resid * resid, dim=1) / n_valid, _EPS)
    return coef, G, n_valid, sigma2


def coef_to_poly(coef, ar_lags, ma_lags, p_eff: int, q_eff: int):
    """Scatter lag-set coefficients (S, F) into dense stabilized
    polynomials ``(phi (S, p_eff), theta (S, q_eff))``."""
    S = coef.shape[0]
    nar = len(ar_lags)
    phi = coef.new_zeros((S, p_eff))
    for col, lag in enumerate(ar_lags):
        phi[:, lag - 1] = coef[:, col]
    theta = coef.new_zeros((S, q_eff))
    for col, lag in enumerate(ma_lags):
        theta[:, lag - 1] = coef[:, nar + col]
    return _stabilize(phi), _stabilize(theta)


def _hannan_rissanen(z, m, ar_lags, ma_lags, p_eff: int, q_eff: int, K: int,
                     ridge: float = 1e-4):
    """Closed-form batched (S)ARMA estimation: a long-AR(K) Yule-Walker
    solve, the innovations it leaves, one (S, F, F) ridge regression on the
    AR and MA lag sets, then the PACF-clip projection.  Returns dense
    ``(phi (S, p_eff), theta (S, q_eff))``."""
    S = z.shape[0]
    if len(ar_lags) + len(ma_lags) == 0:
        return z.new_zeros((S, 0)), z.new_zeros((S, 0))
    coef, _, _, _ = _hr_regression(z, m, ar_lags, ma_lags, K, ridge)
    return coef_to_poly(coef, ar_lags, ma_lags, p_eff, q_eff)


def hr_work(S: int, T: int, K: int, F: int) -> tuple:
    """(float32 operations, bytes) of :func:`_hannan_rissanen`'s least
    work: the K lagged products of the Yule-Walker autocorrelations (4 S T K:
    the numerator's and the pair count's multiply and add), the innovations'
    K lagged multiply-subtracts and mask products (4 S T K), the regression's
    Gram, right-hand side and residual (2 S T F (F + 2)); the centered series
    and its mask read once, the coefficients written once (the small
    Toeplitz and ridge solves are not counted)."""
    return 8 * S * T * K + 2 * S * T * F * (F + 2), 4 * (2 * S * T + S * F)


def _difference(y, mask, d: int):
    if d == 0:
        return y, mask
    z = y[:, 1:] - y[:, :-1]
    m = mask[:, 1:] * mask[:, :-1]
    z = torch.nn.functional.pad(z * m, (1, 0))
    m = torch.nn.functional.pad(m, (1, 0))
    return z, m


def _centered(y, mask, d: int):
    """``(zc, zmask, mean)``: the differenced series centered on its masked
    mean."""
    z, zmask = _difference(y, mask, d)
    n_obs = torch.clamp_min(zmask.sum(dim=1), 1.0)
    mean = (z * zmask).sum(dim=1) / n_obs
    return (z - mean[:, None]) * zmask, zmask, mean


def _mle_grad(u, ssq, n, dssq, dldet, prior_scale: float):
    """The gradient in u (S, k) of the loss the MLE fit minimizes, the
    concentrated Gaussian NLL plus the prior of the unconstrained
    parameters, 0.5 n log(max(ssq / n, eps)) + 0.5 ldet + 0.5 |u /
    prior_scale|^2 with n floored at 1 (the reference's ``nll_one``), from
    the filter's sums and their derivatives along each u_j; the clamp's
    gradient is zero, a non-finite entry is zeroed.  The MLE kernel's
    operations, in its order."""
    c = ssq / torch.clamp_min(n, 1.0)
    gs = torch.where(c > _EPS, 0.5 * c.reciprocal(), 0.0)
    g = ((gs[:, None] * dssq + 0.5 * dldet)
         + u * (1.0 / (prior_scale * prior_scale)))
    return torch.where(torch.isfinite(g), g, 0.0)


def mle_fit_reference(zc, zmask, p: int, q: int, r: int, steps: int,
                      learning_rate: float, prior_scale: float,
                      path: bool = False):
    """The plain twin of ``ops/kalman.arima_mle_fit``: ``steps`` steps of
    Adam (``ops/optim.adam``, the reference's update; one Adam over the
    stacked rows is the reference's vmapped per-series Adam) from u = 0 on
    the unconstrained PACF parameters u (S, p + q).  Each step maps u to
    the coefficients and the tangent directions (:func:`_pacf_directions`),
    runs the filter with them (:func:`arima_loglik_grad_reference`) and
    steps along :func:`_mle_grad`.  Returns u, or with ``path`` the list of
    u after each step."""
    u = zc.new_zeros((zc.shape[0], p + q))
    opt = adam(learning_rate)
    state = opt.init({"u": u})
    us = []
    for _ in range(steps):
        phi, theta, dph, dRv = _pacf_directions(u, p, q, r)
        ssq, _, n, dssq, dldet = arima_loglik_grad_reference(
            zc, zmask, phi, theta, r, dph, dRv)
        g = _mle_grad(u, ssq, n, dssq, dldet, prior_scale)
        updates, state = opt.update({"u": g}, state)
        u = u + updates["u"]
        us.append(u)
    return us if path else u


def _mle_estimate(zc, zmask, config: ArimaConfig, r: int):
    """``fit_steps`` steps of Adam on the MAP loss from u = 0: one launch of
    ``ops/kalman.arima_mle_fit`` on the card, its twin on the CPU.  Returns
    the dense ``(phi (S, p), theta (S, q))``."""
    p, q = config.p, config.q
    u = zc.new_zeros((zc.shape[0], p + q))
    if p + q:
        u = arima_mle_fit(zc.contiguous(), zmask.contiguous(), p, q, r,
                          config.fit_steps, config.learning_rate,
                          config.prior_scale)
    return _pacf_to_coef(u[:, :p]), _pacf_to_coef(u[:, p:p + q])


def fit(y, mask, day, config: ArimaConfig) -> ArimaParams:
    """Fit every series at once.  y, mask: (S, T); day: (T,)."""
    ar_lags, ma_lags, p_eff, q_eff = _lag_sets(config)
    zc, zmask, mean = _centered(y, mask, config.d)
    if config.method == "hr":
        K = max(config.hr_ar_order, p_eff + q_eff + config.m)
        phi, theta = _hannan_rissanen(zc, zmask, ar_lags, ma_lags, p_eff,
                                      q_eff, K)
    elif config.method == "mle":
        if config.P or config.Q:
            raise ValueError(
                "seasonal (P, Q) terms require method='hr' — the MLE path's "
                "PACF parameterization is dense in the lag order"
            )
        phi, theta = _mle_estimate(zc, zmask, config, _effective_r(config))
    else:
        raise ValueError(
            f"unknown ARIMA fit method {config.method!r}; 'hr' or 'mle'")
    return _finalize(y, mask, day, config, phi, theta, mean, zc, zmask)


def _finalize(y, mask, day, config: ArimaConfig, phi, theta, mean, zc,
              zmask) -> ArimaParams:
    """The post-estimation tail of ``fit``: one Kalman pass for sigma2, the
    final state and the one-step fitted path, then the d = 1 integration."""
    d = config.d
    r = _effective_r(config)
    phi, theta = phi.contiguous(), theta.contiguous()
    if config.kalman == "scan":
        out = arima_filter(zc.contiguous(), zmask.contiguous(),
                           y.contiguous(), mask.contiguous(), phi, theta,
                           mean.contiguous(), r, d)
        ssq, n, preds, Fs, a_T, P_T = (out.ssq, out.n, out.preds, out.Fs,
                                       out.a_T, out.P_T)
    elif config.kalman == "pscan":
        T_mat, Rv = _build_ssm(phi, theta, r)
        ph, _, RRt = _model(phi, theta, r)
        ssq, _, n, preds, Fs, a_T, P_T = parallel_kalman_filter(
            zc, zmask, T_mat, RRt, _init_cov(ph, RRt))
    else:
        raise ValueError(
            f"unknown ArimaConfig.kalman {config.kalman!r}; 'scan' or 'pscan'"
        )
    sigma2 = ssq / torch.clamp_min(n, 1.0)

    # fitted values on the original scale: undifference the one-step
    # predictions, never reading y over unobserved stretches
    zhat = preds + mean[:, None]
    if d == 1 and config.kalman == "scan":
        fitted, fitted_var, level_end, var_end = (
            out.fitted, out.fitted_var, out.level_end, out.var_end)
    elif d == 1:  # pscan filters in parallel; the integration stays the scan
        fitted, fitted_var, level_end, var_end = _integrate(
            y, mask, zhat, Fs, sigma2, first_observed(y, mask))
    else:
        fitted = zhat
        fitted_var = Fs * sigma2[:, None]
        level_end = torch.zeros_like(sigma2)
        var_end = torch.zeros_like(sigma2)
    return ArimaParams(
        phi=phi, theta=theta, sigma2=sigma2, mean=mean, a_last=a_T,
        P_last=P_T, level_end=level_end, var_end=var_end, fitted=fitted,
        fitted_var=fitted_var, day0=day[0].to(torch.float32),
        t_fit_end=day[-1].to(torch.float32),
    )


def window_stats(y, mask, config: ArimaConfig) -> dict:
    """Per-window HR sufficient statistics for the split-and-combine path
    (arXiv 2007.09577): y, mask (B, W) raw windows.  Returns ``{coef,
    gram, n_valid, sigma2, mean, n_obs}``, each O(F^2) a window."""
    if config.method != "hr":
        raise ValueError(
            "windowed fitting requires ArimaConfig.method='hr' — the MLE "
            "path has no closed-form sufficient statistics to combine"
        )
    ar_lags, ma_lags, p_eff, q_eff = _lag_sets(config)
    z, zmask = _difference(y, mask, config.d)
    n_obs = torch.clamp_min(zmask.sum(dim=1), 1.0)
    mean = (z * zmask).sum(dim=1) / n_obs
    zc = (z - mean[:, None]) * zmask
    K = max(config.hr_ar_order, p_eff + q_eff + config.m)
    coef, gram, n_valid, sigma2 = _hr_regression(zc, zmask, ar_lags, ma_lags,
                                                 K)
    return {"coef": coef, "gram": gram, "n_valid": n_valid, "sigma2": sigma2,
            "mean": mean, "n_obs": n_obs}


def params_from_estimates(y, mask, day, config: ArimaConfig, phi, theta,
                          mean) -> ArimaParams:
    """Full ``ArimaParams`` from externally estimated coefficients: only the
    post-estimation Kalman and integration tail over (y, mask, day)."""
    z, zmask = _difference(y, mask, config.d)
    zc = (z - mean[:, None]) * zmask
    return _finalize(y, mask, day, config, phi, theta, mean, zc, zmask)


def _forecast_impl(params: ArimaParams, day_all, config: ArimaConfig, r: int):
    T_all = day_all.shape[0]
    dev = params.sigma2.device
    dayf = day_all.to(torch.float32)
    h = dayf - params.t_fit_end
    # forecast-path length.  CONTRACT (the reference's): day_all is a
    # contiguous grid, and a grid longer than the fit grid starts at day0
    # (history + future: the engine's day_grid, the serving predictor's full
    # grid), so the largest lead is T_all - T_fit; a grid no longer than the
    # fit grid needs at most T_all steps
    T_fit = params.fitted.shape[1]
    H = T_all - T_fit + 1 if T_all > T_fit else T_all
    zf, vf = arima_predict(params.phi.contiguous(), params.theta.contiguous(),
                           params.a_last.contiguous(),
                           params.P_last.contiguous(),
                           params.sigma2.contiguous(), r, H)
    zf = zf + params.mean[:, None]
    if config.d == 1:
        # integrate from the carried level and variance at the fit grid's
        # end, so the future continues the fitted path without a jump
        path = params.level_end[:, None] + cumsum_rows(zf)
        var = params.var_end[:, None] + cumsum_rows(vf)
    else:
        path, var = zf, vf

    hidx = torch.clamp(h.to(torch.int32) - 1, 0, H - 1).long()
    fit_idx = torch.clamp((dayf - params.day0).to(torch.int32), 0,
                          T_fit - 1).long()
    is_future = (h > 0.0)[None, :]
    yhat = torch.where(is_future, path[:, hidx], params.fitted[:, fit_idx])
    sd = torch.sqrt(torch.where(is_future, var[:, hidx],
                                params.fitted_var[:, fit_idx]))
    z = _ndtri(0.5 + config.interval_width / 2.0, dev)
    return yhat, yhat - z * sd, yhat + z * sd


def forecast(params: ArimaParams, day_all, t_end, config: ArimaConfig):
    """(yhat, lo, hi) over history + future days, each (S, T_all).  The
    band widens from the fit grid's end (``t_end`` is not read: a CV
    cutoff's masked eval window already widens ``fitted_var``)."""
    return _forecast_impl(params, day_all, config, _effective_r(config))


register_model("arima", fit, forecast, ArimaConfig,
               forecast_quantiles=gaussian_quantiles(forecast))
