"""Parallel Kalman filtering by an associative scan over filtering elements
(port of the reference's ``ops/pkalman.py``; the cross-device
``parallel_kalman_filter_time_sharded`` is not ported, ROADMAP Queue 1:
P12).

Kalman filtering is not an affine recurrence in the state (the gain depends
on the covariance's Riccati recursion), but Särkkä & García-Fernández
("Temporal Parallelization of Bayesian Smoothers", IEEE TAC 2021) showed the
filter is associative over 5-tuple conditional-Gaussian elements ``(A, b, C,
eta, J)``: composing the elements of steps 1..t gives the exact filtered
mean and covariance at t.  ``ops/pscan.blocked_prefix`` then evaluates all T
posteriors in O(log T) depth of batched (r, r) products and small inverses.

The state space is the ARIMA family's, masked, with no observation noise::

    x_t = T x_{t-1} + R eps_t,   eps ~ N(0, 1)     (transition)
    z_t = x_t[0]                                   (observation)

and a missing observation (mask == 0) enters as a pure-prediction element.
Every function takes a batch of series: z, mask (S, T); T_mat, RRt, P0
(S, r, r); elements are time-major, (T, S, ...).  The outputs match the
sequential filter ``models/arima._kalman_loglik_impl`` within float
tolerance (the one-step predictions, their variances, the concentrated
likelihood pieces and the predictive state after the grid).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_forecasting_tpu_torch.ops.pscan import blocked_prefix

_EPS = 1e-8


class _Elements(NamedTuple):
    """Per-step filtering elements, leading axis T."""

    A: torch.Tensor    # (T, S, r, r)
    b: torch.Tensor    # (T, S, r)
    C: torch.Tensor    # (T, S, r, r)
    eta: torch.Tensor  # (T, S, r)
    J: torch.Tensor    # (T, S, r, r)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _inv_small(M: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small (r, r) matrices by unrolled Gauss-Jordan,
    pivot-free.  Used only on ``I + C J`` with C, J PSD: C J is similar to a
    PSD matrix, so the spectrum of I + C J lies in [1, inf) and elimination
    without pivoting is safe (a tiny diagonal guard absorbs round-off)."""
    r = M.shape[-1]
    eye = torch.eye(r, dtype=M.dtype, device=M.device)
    aug = torch.cat([M, eye.expand(M.shape)], dim=-1)
    rows = torch.arange(r, device=M.device)
    for k in range(r):
        piv = aug[..., k:k + 1, k:k + 1]
        piv = torch.where(torch.abs(piv) < 1e-12, 1e-12, piv)
        row = aug[..., k:k + 1, :] / piv              # (..., 1, 2r)
        fac = aug[..., :, k:k + 1] * row              # (..., r, 2r)
        rowsel = (rows == k)[:, None]
        aug = torch.where(rowsel, row, aug - fac)
    return aug[..., r:]


def _compose(left: _Elements, right: _Elements) -> _Elements:
    """Associative composition of filtering elements (left = earlier)."""
    Ai, bi, Ci, etai, Ji = left
    Aj, bj, Cj, etaj, Jj = right
    r = Ai.shape[-1]
    eye = torch.eye(r, dtype=Ai.dtype, device=Ai.device)
    M = _inv_small(eye + Ci @ Jj)
    N = _inv_small(eye + Jj @ Ci)
    AjM = Aj @ M
    AiTN = Ai.mT @ N
    return _Elements(
        A=AjM @ Ai,
        b=_mv(AjM, bi + _mv(Ci, etaj)) + bj,
        C=AjM @ Ci @ Aj.mT + Cj,
        eta=_mv(AiTN, etaj - _mv(Jj, bi)) + etai,
        J=AiTN @ Jj @ Ai + Ji,
    )


def _identity_elements(n: int, r: int, dtype, device=None) -> _Elements:
    eye = torch.eye(r, dtype=dtype, device=device)
    return _Elements(
        A=eye.expand(n, r, r),
        b=torch.zeros((n, r), dtype=dtype, device=device),
        C=torch.zeros((n, r, r), dtype=dtype, device=device),
        eta=torch.zeros((n, r), dtype=dtype, device=device),
        J=torch.zeros((n, r, r), dtype=dtype, device=device),
    )


def _build_elements(z, mask, T_mat, RRt, P0):
    """Per-step filtering elements of the masked, noise-free observation
    state space.  Returns ``(elems, S0, Sq, t_row)``: the (T, S, ...)
    elements, the prior's and the transition noise's observation variances
    (S,) and the transition's first row (S, r)."""
    r = T_mat.shape[-1]
    dt, dev = z.dtype, z.device
    eye = torch.eye(r, dtype=dt, device=dev)
    e1 = eye[0]
    outer = lambda u, v: u[..., :, None] * v[..., None, :]  # noqa: E731

    # step 0 carries the prior: predicted cov is P0 (stationary), so
    # S_0 = P0[0,0]; steps t >= 1 use the transition-noise covariance RRt
    S0 = torch.clamp_min(P0[:, 0, 0], _EPS)
    K0 = P0[:, :, 0] / S0[:, None]
    m0 = mask[:, 0] > 0
    zero_rr = torch.zeros_like(P0)
    A0 = zero_rr
    b0 = torch.where(m0[:, None], K0 * z[:, :1], 0.0)
    C0 = torch.where(m0[:, None, None], (eye - outer(K0, e1)) @ P0, P0)
    eta0 = torch.zeros_like(K0)
    J0 = zero_rr

    Sq = torch.clamp_min(RRt[:, 0, 0], _EPS)
    Kq = RRt[:, :, 0] / Sq[:, None]
    IKH = eye - outer(Kq, e1)
    A_obs = IKH @ T_mat
    C_obs = IKH @ RRt
    t_row = T_mat[:, 0]
    J_obs = outer(t_row, t_row) / Sq[:, None, None]

    zt = z[:, 1:].t()[..., None]                     # (T-1, S, 1)
    mt = (mask[:, 1:] > 0).t()[..., None]            # (T-1, S, 1)
    mtm = mt[..., None]
    A_rest = torch.where(mtm, A_obs[None], T_mat[None])
    b_rest = torch.where(mt, Kq[None] * zt, 0.0)
    C_rest = torch.where(mtm, C_obs[None], RRt[None])
    eta_rest = torch.where(mt, t_row[None] * (zt / Sq[None, :, None]), 0.0)
    J_rest = torch.where(mtm, J_obs[None], 0.0)

    elems = _Elements(
        A=torch.cat([A0[None], A_rest]),
        b=torch.cat([b0[None], b_rest]),
        C=torch.cat([C0[None], C_rest]),
        eta=torch.cat([eta0[None], eta_rest]),
        J=torch.cat([J0[None], J_rest]),
    )
    return elems, S0, Sq, t_row


def _filter_outputs(m_filt, P_filt, z, mask, T_mat, RRt, P0, S0, Sq, t_row):
    """``(ssq, ldet, n, preds, Fs, a_T, P_T)`` from the filtered (T, S, ...)
    trajectory; preds and Fs come back (S, T)."""
    m_prev = torch.cat([torch.zeros_like(m_filt[:1]), m_filt[:-1]])
    P_prev = torch.cat([P0[None], P_filt[:-1]])
    preds = torch.sum(m_prev * t_row, dim=-1).t()          # (S, T)
    preds[:, 0] = 0.0                                       # prior mean zero
    Fs = torch.sum(_mv(P_prev, t_row) * t_row, dim=-1).t() + Sq[:, None]
    Fs[:, 0] = S0
    Fs = torch.clamp_min(Fs, _EPS)

    v = z - preds
    obs = mask > 0
    ssq = torch.sum(torch.where(obs, v * v / Fs, 0.0), dim=1)
    ldet = torch.sum(torch.where(obs, torch.log(Fs), 0.0), dim=1)
    n = torch.sum(mask, dim=1)

    a_T = _mv(T_mat, m_filt[-1])
    P_T = T_mat @ P_filt[-1] @ T_mat.mT + RRt
    return ssq, ldet, n, preds, Fs, a_T, P_T


def parallel_kalman_filter(z, mask, T_mat, RRt, P0, block_size: int = 256):
    """Filter every series in O(log T) depth: ``(ssq, ldet, n, preds, Fs,
    a_T, P_T)``, what the sequential filter returns — the one-step
    predictive means and variances of z_t (S, T), the concentrated
    log-likelihood pieces over observed steps (S,), and the one-step
    predictive state after the grid, (S, r) and (S, r, r), the forecast's
    seed.  z, mask: (S, T); T_mat, RRt, P0: (S, r, r)."""
    r = T_mat.shape[-1]
    elems, S0, Sq, t_row = _build_elements(z, mask, T_mat, RRt, P0)
    # prefix-compose the elements; only the filtered mean and covariance
    # are stacked across T (A/eta/J prefixes live within a block)
    m_filt, P_filt = blocked_prefix(
        _compose, elems, _identity_elements(1, r, z.dtype, z.device),
        block_size, project=lambda full: (full.b, full.C),
    )
    return _filter_outputs(m_filt, P_filt, z, mask, T_mat, RRt, P0,
                           S0, Sq, t_row)
