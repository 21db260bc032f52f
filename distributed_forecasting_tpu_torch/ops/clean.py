"""Batched data-cleaning operations of the autoprep program (port of the
reference's ``ops/clean.py``).

Every function is plain torch over the dense ``(S, T)`` batch on its
device, with no per-series loop, composed by
``engine/autoprep._autoprep_impl`` into the one prep program a batch runs:

* zero-run lengths use the cummax of the index: ``t - cummax(t where
  not-zero)`` is the forward run length at every cell in one scan, the
  flipped pass gives the backward half;
* the outlier neighborhood mean is a cumsum-differenced box window that
  EXCLUDES the center cell (a spike must not launder itself into its own
  baseline), and the residual scale is the per-series MAD
  (``ops/solve.masked_mad_scale``), so one promo week cannot inflate the
  threshold that should catch it;
* repair gathers the nearest valid, non-repaired neighbors on both sides
  (cummax index scans again) and interpolates linearly; edge cells with a
  single-sided neighbor take that value, isolated cells keep the original;
* the CUSUM changepoint is the max-|cumsum| statistic with a robust
  (MAD-of-differences) sigma and a two-sample mean-shift z-score.

Every running sum goes through ``models/base.cumsum_rows``, which adds each
row's terms in order on the card as on the CPU: the CUSUM argmax on
repaired (non-integer) values is decided by margins thinner than the
rounding of a parallel scan.  Nothing here mutates its inputs: repair and
masking return NEW tensors plus per-point bool maps.
"""

from __future__ import annotations

import torch

from distributed_forecasting_tpu_torch.models.base import cumsum_rows
from distributed_forecasting_tpu_torch.ops.solve import masked_mad_scale

_EPS = 1e-9


def _index_grid(S: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int64, device=device).expand(S, T)


# -- zero-run masking --------------------------------------------------------

def zero_run_lengths(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(S, T) int64 total length of the observed-zero run each cell sits in.

    A cell counts as "zero" when it is observed (mask > 0) and exactly 0:
    tensorize's encoding for both true zero demand and silently dead feeds.
    Cells outside any zero run get 0.
    """
    S, T = y.shape
    z = (mask > 0) & (y == 0.0)
    idx = _index_grid(S, T, y.device)
    # forward run length ending at t: distance to the last non-zero cell
    last_nz = torch.cummax(torch.where(z, -1, idx), dim=1).values
    fwd = idx - last_nz
    # backward run length starting at t: the same scan on the flipped rows
    next_nz = torch.cummax(torch.where(torch.flip(z, [1]), -1, idx),
                           dim=1).values
    bwd = torch.flip(idx - next_nz, [1])
    return torch.where(z, fwd + bwd - 1, 0)


def mask_zero_runs(y, mask, min_run: int):
    """Drop observed-zero runs of >= ``min_run`` cells from the mask.

    Returns ``(mask_clean, dropped)``; ``dropped`` is the (S, T) bool map of
    cells that were observed and are now masked out.  Long dead-zero
    stretches are store closures or feed outages, not demand; short zero
    runs (true intermittent demand) stay.
    """
    dropped = zero_run_lengths(y, mask) >= min_run
    return torch.where(dropped, 0.0, mask), dropped


# -- MAD outlier scoring + interpolation repair ------------------------------

def _box_window_sums(v: torch.Tensor, window: int) -> torch.Tensor:
    """Inclusive box window [t - window, t + window] sums along axis 1 by
    cumsum differences: one in-order scan a row, whatever the window."""
    S, T = v.shape
    cs = torch.cat([v.new_zeros((S, 1)), cumsum_rows(v)], dim=1)
    t = torch.arange(T, device=v.device)
    a = torch.clamp(t - window, 0, T)
    b = torch.clamp(t + window + 1, 0, T)
    return cs[:, b] - cs[:, a]


def mad_outlier_scores(y, mask, window: int):
    """Robust per-point spike scores: ``(score (S, T), scale (S,))``.

    The baseline at t is the mean of the observed neighbors in a +-window
    box EXCLUDING t; the residual against it is scaled by the per-series
    MAD of all such residuals.  Cells without an observed neighbor, and
    whole series whose MAD is 0 (constants have no spikes), score 0.
    """
    vm = y * mask
    nb_sum = _box_window_sums(vm, window) - vm
    nb_cnt = _box_window_sums(mask, window) - mask
    has_nb = nb_cnt > 0
    nb_mean = nb_sum / torch.clamp_min(nb_cnt, 1.0)
    r = torch.where(has_nb, y - nb_mean, 0.0)
    valid = mask * has_nb.to(mask.dtype)
    scale = masked_mad_scale(r, valid)
    score = torch.abs(r) / torch.clamp_min(scale, _EPS)[:, None]
    score = torch.where((valid > 0) & (scale[:, None] > 0), score, 0.0)
    return score, scale


def interpolate_repair(y, mask, repair: torch.Tensor):
    """Replace flagged cells by linear interpolation between the nearest
    valid NON-flagged observed neighbors.

    Returns ``(y_repaired, repaired)``; ``repaired`` is the (S, T) bool map
    of cells whose value actually changed source (smaller than ``repair``
    where no anchor exists: a row of flagged cells with no anchor keeps its
    values rather than inventing data).  The neighbor indices carry -1 / T
    sentinels where a side has none; the gathers are int64.
    """
    S, T = y.shape
    good = (mask > 0) & ~repair
    idx = _index_grid(S, T, y.device)
    prev_i = torch.cummax(torch.where(good, idx, -1), dim=1).values
    next_rev = torch.flip(
        torch.cummax(torch.where(torch.flip(good, [1]), idx, -1),
                     dim=1).values, [1])
    next_i = torch.where(next_rev >= 0, (T - 1) - next_rev, T)
    has_prev = prev_i >= 0
    has_next = next_i < T
    v_prev = torch.gather(y, 1, torch.clamp(prev_i, 0, T - 1))
    v_next = torch.gather(y, 1, torch.clamp(next_i, 0, T - 1))
    span = torch.clamp_min((next_i - prev_i).to(y.dtype), 1.0)
    w_next = (idx - prev_i).to(y.dtype) / span
    interp = v_prev * (1.0 - w_next) + v_next * w_next
    filled = torch.where(
        has_prev & has_next, interp,
        torch.where(has_prev, v_prev, torch.where(has_next, v_next, y)))
    repaired = repair & (has_prev | has_next) & (mask > 0)
    return torch.where(repaired, filled, y), repaired


# -- CUSUM level-shift detection ---------------------------------------------

def cusum_level_shift(y, mask, threshold: float):
    """Single most significant level shift per series.

    Returns ``(cp_index (S,) int32, shift (S,), score (S,))``: ``cp_index``
    is the last cell of the pre-shift segment (-1 when no shift clears
    ``threshold``), ``shift`` is mean(after) - mean(before), and ``score``
    the two-sample mean-shift z with a robust sigma (MAD of first
    differences / sqrt(2), immune to the shift itself).  The argmax takes
    the first of equal maxima, as the reference's does.
    """
    m = mask
    S, T = y.shape
    n_tot = torch.sum(m, dim=1)
    tot = torch.sum(y * m, dim=1)
    mu = tot / torch.clamp_min(n_tot, 1.0)
    dev = cumsum_rows((y - mu[:, None]) * m)
    n_left = cumsum_rows(m)
    s_left = cumsum_rows(y * m)
    n_right = n_tot[:, None] - n_left
    # a candidate split needs real mass on BOTH sides; the last column
    # (n_right = 0) and leading unobserved cells are excluded by scoring
    valid = (n_left >= 2.0) & (n_right >= 2.0)
    stat = torch.where(valid, torch.abs(dev), -torch.inf)
    cp = torch.argmax(stat, dim=1)
    at = cp[:, None]
    nl = torch.clamp_min(torch.gather(n_left, 1, at)[:, 0], 1.0)
    nr = torch.clamp_min(torch.gather(n_right, 1, at)[:, 0], 1.0)
    s_at = torch.gather(s_left, 1, at)[:, 0]
    shift = (tot - s_at) / nr - s_at / nl
    dy = y[:, 1:] - y[:, :-1]
    dm = m[:, 1:] * m[:, :-1]
    sigma = masked_mad_scale(dy, dm) / torch.sqrt(torch.full_like(n_tot, 2.0))
    se = torch.clamp_min(sigma, _EPS) * torch.sqrt(1.0 / nl + 1.0 / nr)
    score = torch.abs(shift) / se
    found = (torch.gather(valid, 1, at)[:, 0] & (score >= threshold)
             & (sigma > 0))
    return (torch.where(found, cp, -1).to(torch.int32),
            torch.where(found, shift, 0.0),
            torch.where(found, score, 0.0))


def align_level_shift(y, mask, cp_index, shift):
    """Re-level the PRE-shift segment onto the post-shift level: cells at or
    before ``cp_index`` get ``+ shift``; series with ``cp_index < 0`` pass
    through.  This feeds the FIT tensor only; the stored history keeps the
    raw values (the report records the alignment)."""
    del mask  # alignment applies to the whole grid; masked cells are inert
    t = torch.arange(y.shape[1], device=y.device)[None, :]
    cp = cp_index.to(torch.int64)[:, None]
    pre = (t <= cp) & (cp >= 0)
    return torch.where(pre, y + shift[:, None], y)


# -- holiday indicators ------------------------------------------------------

def holiday_indicators(day_grid: torch.Tensor,
                       holiday_days: torch.Tensor) -> torch.Tensor:
    """(G,) day ordinals x (R, D) padded per-holiday day lists -> (G, R)
    float32 0/1 indicator matrix (the design columns holiday regressors
    become).  ``holiday_days`` pads ragged occurrence lists with -1, which
    matches no epoch-day ordinal on the served grids; with no holiday the
    result is (G, 0)."""
    if holiday_days.numel() == 0:
        return torch.zeros((day_grid.shape[0], holiday_days.shape[0]),
                           dtype=torch.float32, device=day_grid.device)
    hit = day_grid[:, None, None] == holiday_days[None, :, :]
    return torch.any(hit, dim=-1).to(torch.float32)
