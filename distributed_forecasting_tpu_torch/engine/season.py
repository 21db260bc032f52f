"""Dominant-seasonality detection for ``season_length: auto`` (port of the
reference's ``engine/season.py``).

Method: masked autocorrelation of the FIRST-DIFFERENCED series (differencing
kills trend, which would otherwise drown the seasonal peaks), by FFT: the
masked pairwise products at every lag are two self-correlations,
``irfft(|rfft(z)|^2)`` of the mean-centred masked differences and the same
of the mask, so the whole lag axis costs one transform pair per batch.
Each series normalises by its own lag-0 autocovariance, the scores average
over series, and only the (max_lag + 1,) score vector leaves the device.

Period selection runs on the host, because ``season_length`` is a static
config field: a harmonic-comb score gates detection (a non-seasonal batch
falls back to the default), and the period is the argmax of a matched
cosine filter over the whole lag axis.  One period for the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_forecasting_tpu_torch.ops.solve import masked_mad_scale

_MIN_LAG = 2


def acf_scores_per_series(y, mask, max_lag: int):
    """Per-series masked ACF of diff(y): ``(r (S, max_lag+1), nonempty (S,)
    bool)``.

    The differences are winsorised at 6 robust sigmas (MAD) per series
    first, so a few spike days cannot swamp the variance normalisation.  A
    series whose median |diff| is zero (intermittent demand) is not
    clipped: its spikes are its seasonal signal.
    """
    dy = y[:, 1:] - y[:, :-1]
    dm = mask[:, 1:] * mask[:, :-1]
    mad = masked_mad_scale(dy, dm)[:, None]
    lim = torch.where(mad > 0, 6.0 * mad, torch.inf)
    dy = torch.clamp(dy, -lim, lim)
    n = torch.clamp_min(torch.sum(dm, dim=1, keepdim=True), 1.0)
    mu = torch.sum(dy * dm, dim=1, keepdim=True) / n
    z = (dy - mu) * dm
    T = z.shape[1]
    L = int(2 ** np.ceil(np.log2(T + max_lag + 1)))  # linear, not circular
    fz = torch.fft.rfft(z, n=L, dim=1)
    fm = torch.fft.rfft(dm, n=L, dim=1)
    num = torch.fft.irfft(fz * torch.conj(fz), n=L, dim=1)[:, : max_lag + 1]
    cnt = torch.fft.irfft(fm * torch.conj(fm), n=L, dim=1)[:, : max_lag + 1]
    acov = num / torch.clamp_min(cnt, 1.0)            # (S, max_lag+1)
    a0 = acov[:, :1]
    r = torch.where(a0 > 1e-12, acov / torch.clamp_min(a0, 1e-12), 0.0)
    return r, torch.sum(mask, dim=1) > 0


def acf_scores_impl(y, mask, max_lag: int):
    """(max_lag+1,) batch-mean masked ACF of diff(y) at lags 0..max_lag;
    every series counts in the mean (a flat one contributes its zero
    row)."""
    r, _ = acf_scores_per_series(y, mask, max_lag)
    return torch.mean(r, dim=0)


def acf_work(S: int, T: int, max_lag: int) -> tuple:
    """(float32 operations, bytes) of :func:`acf_scores_impl`'s least work:
    y and mask read once, the (max_lag + 1,) scores written once; the four
    length-L real transforms at ~2.5 L log2 L operations each, per series
    (the MAD's sort is not counted)."""
    L = int(2 ** np.ceil(np.log2(T - 1 + max_lag + 1)))
    return int(S * 4 * 2.5 * L * np.log2(L)), 4 * (2 * S * T + max_lag + 1)


def clamp_max_lag(max_lag: int, n_time: int) -> int:
    """The lag window: candidates need two comb teeth in range, so the
    scan never exceeds T/3."""
    return int(min(max_lag, max(n_time // 3, _MIN_LAG)))


def detect_season_length(batch, max_lag: int = 400, default: int = 7,
                         min_score: float = 0.1) -> int:
    """The batch's dominant seasonal period as a Python int: lags
    2..max_lag (clamped to T/3) are scanned, so detection needs
    ``T >= ~6m`` and periods below 4 are out of range; ``default`` when the
    best comb score stays under ``min_score``.  One host pull of the
    score vector."""
    max_lag = clamp_max_lag(max_lag, batch.n_time)
    if max_lag < 4:
        return int(default)
    raw = acf_scores_impl(batch.y, batch.mask, max_lag).cpu().numpy()
    return select_period(raw, max_lag, default=default, min_score=min_score)


def select_period(raw: np.ndarray, max_lag: int, default: int = 7,
                  min_score: float = 0.1) -> int:
    """Host-side period selection over a (max_lag+1,) ACF score vector.

    Gate: the harmonic comb of each candidate m — mean of the peaks at its
    first <= 3 multiples (each the larger of the raw and the 3-point
    smoothed ACF) minus the mean of the raw ACF at the anti-phase
    half-multiples; candidates need two multiples in range.  Period: the
    argmax of the matched cosine filter ``sum_d raw[d] cos(2 pi d / m)``,
    which is harmonic-safe and integrates every lag coherently.
    """
    if max_lag < 4 or raw.shape[0] < max_lag + 1:
        return int(default)
    raw = np.asarray(raw[: max_lag + 1], dtype=np.float64)
    smooth = raw.copy()
    smooth[1:-1] = (raw[:-2] + raw[1:-1] + raw[2:]) / 3.0
    peak_s = np.maximum(raw, smooth)

    def comb(m: int) -> float:
        ks = np.arange(1, min(3, max_lag // m) + 1)
        trough = np.clip(np.round((ks - 0.5) * m).astype(int), 1, max_lag)
        return float(np.mean(peak_s[ks * m]) - np.mean(raw[trough]))

    cand = np.arange(4, max_lag // 2 + 1)
    if cand.size == 0:
        return int(default)
    combs = np.asarray([comb(m) for m in cand])
    if float(np.max(combs)) < min_score:
        return int(default)
    d_ax = np.arange(_MIN_LAG, max_lag + 1)

    def matched(m: int) -> float:
        return float(np.sum(raw[_MIN_LAG:] * np.cos(2.0 * np.pi * d_ax / m)))

    return int(max((int(m) for m in cand), key=matched))
