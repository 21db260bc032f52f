"""Batched Holt-Winters seasonal exponential smoothing (port of the
reference's ``models/holt_winters.py``).

The recursion is sequential in time and independent across lanes, where a
lane is one (series, candidate) pair.  :func:`_filter` runs it for every lane
at once as one Python loop over T; each step is a handful of elementwise ops
on the ``(S,)`` or ``(S, C)`` lane tensors.  The smoothing parameters are a
grid search: every (alpha, beta, gamma[, phi]) candidate is one more lane.

Fit is two passes.  Pass 1 scores every candidate by masked one-step-ahead
MSE — on the card with the hand-written CUDA kernel
(:func:`~distributed_forecasting_tpu_torch.ops.fused_scan.hw_score`,
tolerance-grade), with :func:`_filter` over the (S, C) lanes, or with the
parallel prefix over time (:func:`parallel_filter`, ``filter='pscan'``,
within float tolerance of :func:`_filter`).  Pass 2
refits the winner, collecting the fitted path, with
:func:`~distributed_forecasting_tpu_torch.ops.fused_scan.hw_filter`: on the
card a CUDA kernel bitwise equal to :func:`_filter`, on the CPU
:func:`_filter` itself.  So whichever pass 1 ran, the returned state is the
product of the one step body :func:`_hw_step`.  With the ``precision``
gate on (``ops/precision``), the ``scan`` and ``pscan`` scoring passes run
in bf16 and their MSEs come back as float32; the kernel's scoring ignores
the gate, as the reference's Pallas route does.

Missing observations (mask == 0) take the predict-only branch, which still
advances the level by ``phi * trend``.  Forecast intervals use the HW(A,A)
class-1 variance recursion on the one-step residual scale.

Streaming ingest continues a fitted state over new days with
:func:`update_state`, a loop of :func:`_hw_step` as :func:`_filter` runs
it: the streamed state is the fit's of the extended series bit for bit
(on the card, the ``hw_filter`` kernel's) when the fit picks the same
candidate.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from distributed_forecasting_tpu_torch.models.base import (
    _ndtri,
    advance_t_fit_end,
    cumsum_rows,
    first_day,
    gaussian_quantiles,
    history_splice,
    register_model,
    streamed_columns,
)
from distributed_forecasting_tpu_torch.ops.fused_scan import (
    hw_filter,
    hw_score,
    select_filter,
)
from distributed_forecasting_tpu_torch.ops.precision import scoring_dtype
from distributed_forecasting_tpu_torch.ops.pscan import affine_scan

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class HoltWintersConfig:
    season_length: int = 7
    seasonality_mode: str = "additive"  # 'additive' | 'multiplicative'
    interval_width: float = 0.95
    # grid-search resolution (candidate count derives from these)
    n_alpha: int = 6
    n_beta: int = 4
    n_gamma: int = 4
    # damped trend (Gardner-McKenzie): phi joins the grid as n_phi values in
    # [0.80, 0.98]; undamped runs with phi = 1 exactly
    damped: bool = False
    n_phi: int = 3
    # candidate-scoring solver, the reference's values:
    #   'scan'   — :func:`_filter` over the (S, C) lanes;
    #   'pallas' — the candidate-scoring kernel; on the card this names the
    #              hand-written CUDA kernel (ops/fused_scan.hw_score, additive
    #              only), on the CPU its plain twin.  The name is kept so
    #              configs in artifacts written by the reference load as-is;
    #   'pscan'  — :func:`parallel_filter`, the parallel prefix over time
    #              (ops/pscan.affine_scan; additive only), one candidate at
    #              a time;
    #   'auto'   — ops/fused_scan.select_filter: 'pallas' on cuda, else
    #              'scan'; multiplicative always scans.
    # The winner is refit exactly (ops/fused_scan.hw_filter, :func:`_filter`'s
    # arithmetic) whatever scored it.  The default is 'auto' where the
    # reference's is 'scan': the reference's scan is one compiled program,
    # and its counterpart on the card is the kernel, not a Python loop of
    # ~30 launches a step; on the CPU 'auto' is 'scan', the same arithmetic.
    filter: str = "auto"  # 'scan' | 'pscan' | 'pallas' | 'auto'


@dataclasses.dataclass(frozen=True)
class HWParams:
    alpha: torch.Tensor   # (S,)
    beta: torch.Tensor    # (S,)
    gamma: torch.Tensor   # (S,)
    phi: torch.Tensor     # (S,) trend damping; 1.0 when config.damped=False
    level: torch.Tensor   # (S,) final level
    trend: torch.Tensor   # (S,) final trend
    season: torch.Tensor  # (S, m) final seasonal states (slot = row index mod m)
    sigma: torch.Tensor   # (S,) one-step residual std
    fitted: torch.Tensor  # (S, T) one-step-ahead fitted values on the train grid
    day0: torch.Tensor    # () first training day (absolute), float32
    t_fit_end: torch.Tensor  # () last training day (absolute), float32

    # artifacts saved before the damped-trend feature have no phi field;
    # phi = 1 is exactly the recursion they were fit with
    _LEGACY_DEFAULTS: ClassVar[dict] = {
        "phi": lambda fields: torch.ones_like(fields["alpha"])
    }


def _damp_sum(phi, h):
    """sum_{j=1..h} phi^j, continuous in h; exactly h at phi == 1 (the
    geometric form is 0/0 there)."""
    near1 = torch.abs(1.0 - phi) < 1e-6
    phi_safe = torch.where(near1, 0.5, phi)
    geo = phi_safe * (1.0 - phi_safe**h) / (1.0 - phi_safe)
    return torch.where(near1, h, geo)


def _init_state(y, mask, m, mode):
    """Initial level/trend/season of every series from its first two
    seasonal cycles.  y, mask: (S, T) -> l0 (S,), b0 (S,), s0 (S, m)."""
    y0, m0 = y[:, :m], mask[:, :m]
    l0 = (y0 * m0).sum(-1) / torch.clamp_min(m0.sum(-1), 1.0)
    y1, m1 = y[:, m: 2 * m], mask[:, m: 2 * m]
    l1 = (y1 * m1).sum(-1) / torch.clamp_min(m1.sum(-1), 1.0)
    b0 = (l1 - l0) / m
    if mode == "multiplicative":
        s0 = torch.where(m0 > 0, y0 / torch.clamp_min(l0, _EPS)[:, None], 1.0)
    else:
        s0 = torch.where(m0 > 0, y0 - l0[:, None], 0.0)
    return l0, b0, s0


def _hw_step(l, b, s, yt, obs, it, alpha, beta, gamma, phi, mode):
    """One Holt-Winters step over all lanes: returns (l', b', pred) and
    writes the new seasonal state of slot ``it`` into ``s`` in place (``s``
    is (m, *lanes); updating one slot row in place keeps the step O(lanes)
    instead of copying the whole seasonal state).  ``obs`` is ``mask > 0``
    at this step; unobserved lanes take the predict-only branch, which still
    advances the level by phi*b."""
    si = s[it]
    pb = phi * b
    lp = l + pb
    if mode == "multiplicative":
        pred = lp * si
        l_obs = alpha * yt / torch.clamp_min(si, _EPS) + (1 - alpha) * lp
        s_obs = gamma * yt / torch.clamp_min(l_obs, _EPS) + (1 - gamma) * si
    else:
        pred = lp + si
        l_obs = alpha * (yt - si) + (1 - alpha) * lp
        s_obs = gamma * (yt - l_obs) + (1 - gamma) * si
    b_obs = beta * (l_obs - l) + (1 - beta) * pb
    s[it] = torch.where(obs, s_obs, si)
    return torch.where(obs, l_obs, lp), torch.where(obs, b_obs, pb), pred


def _filter(y, mask, alpha, beta, gamma, m, mode, phi, keep_path=True):
    """One-step-ahead filter for every lane, one Python loop over T.

    y, mask: (S, T).  alpha/beta/gamma/phi give the lanes: (S,) for one
    candidate per series, or (S, C) / (1, C) for a candidate grid scored
    against every series.  Returns ``((l, b, s), mse, preds)``: final level
    and trend (lane shape), season (*lanes, m), masked MSE (lane shape) and,
    with ``keep_path``, the (*lanes, T) one-step prediction path (else None).
    """
    S, T = y.shape
    lanes = torch.broadcast_shapes(alpha.shape, beta.shape, gamma.shape,
                                   phi.shape, (S,) + (1,) * (alpha.dim() - 1))
    per_series = (S,) + (1,) * (len(lanes) - 1)  # view that broadcasts
    l0, b0, s0 = _init_state(y, mask, m, mode)
    l = l0.view(per_series).expand(lanes)
    b = b0.view(per_series).expand(lanes)
    s = s0.t().reshape((m,) + per_series).expand((m,) + lanes).contiguous()
    obs = mask > 0
    sse = y.new_zeros(lanes)
    n = y.new_zeros(lanes)
    preds = y.new_empty(lanes + (T,)) if keep_path else None
    for t in range(T):
        yt = y[:, t].view(per_series)
        mt = mask[:, t].view(per_series)
        l, b, pred = _hw_step(l, b, s, yt, obs[:, t].view(per_series),
                              t % m, alpha, beta, gamma, phi, mode)
        err = (yt - pred) * mt
        sse = sse + err * err
        n = n + mt
        if keep_path:
            preds[..., t] = pred
    mse = sse / torch.clamp_min(n, 1.0)
    return (l, b, s.movedim(0, -1)), mse, preds


def _affine_elems(y, mask, alpha, beta, gamma, m, phi=1.0, offset: int = 0):
    """The additive HW update as per-step affine maps ``x_t = A_t x_{t-1} +
    c_t`` over the state x = [l, b, s_0..s_{m-1}] (d = m + 2), for every
    row: y, mask (S, T); alpha/beta/gamma/phi scalars or (S,).  Returns
    (A (T, S, d, d), c (T, S, d), x0 (S, d), e (T, m) one-hot slots).
    ``offset``: the series step of y's first column (a later rank's slice
    of a time-sharded filter), which sets the seasonal slots.

    The slot one-hots and the predict map are float32 whatever y's type, as
    the reference's ``jnp.eye`` / ``jnp.zeros`` are: with bf16 inputs (the
    precision gate) the maps come out float32 by type promotion, from
    bf16-rounded parameters, and x0 stays bf16."""
    S, T = y.shape
    dev, dt = y.device, y.dtype
    d = m + 2
    as_lane = lambda x: torch.as_tensor(x, dtype=dt, device=dev).expand(S)  # noqa: E731
    a, be, g, f = (as_lane(x)[None, :, None] for x in (alpha, beta, gamma, phi))
    eye_m = torch.eye(m, dtype=torch.float32, device=dev)
    e = eye_m[(torch.arange(T, device=dev) + offset) % m]    # (T, m)
    es = e[:, None, :].expand(T, S, m)
    full = lambda v: v.expand(T, S, 1)  # noqa: E731

    # observed-update matrix rows (affine in the previous state; f = phi):
    #   l' = (1-a) l + (1-a)f b - a s_i             + a y
    #   b' = -ab l + f(b(1-a)+(1-b)) b - ab s_i     + ab y
    #   s_i' = -g(1-a) l - g(1-a)f b + (ga+1-g)s_i  + g(1-a) y ; s_j'=s_j
    row_l = torch.cat([full(1 - a), full((1 - a) * f), -a * es], dim=2)
    bb = (be * (1 - a) + (1 - be)) * f
    row_b = torch.cat([full(-a * be), full(bb), -a * be * es], dim=2)
    s_rows = (eye_m + es[..., :, None]
              * ((g * a + 1 - g - 1.0)[..., None] * es[..., None, :]))
    s_lb = es[..., :, None] * torch.stack(
        [full(-g * (1 - a)), full(-g * (1 - a) * f)], dim=-1)
    A_obs = torch.cat([row_l[:, :, None, :], row_b[:, :, None, :],
                       torch.cat([s_lb, s_rows], dim=3)], dim=2)  # (T, S, d, d)
    yt = y.t()[..., None]                                     # (T, S, 1)
    c_obs = torch.cat([a * yt, a * be * yt, es * (g * (1 - a) * yt)], dim=2)

    A_pred = torch.zeros((S, d, d), dtype=torch.float32, device=dev)
    A_pred[:, 0, 0] = 1.0
    A_pred[:, 0, 1] = f[0, :, 0]
    A_pred[:, 1, 1] = f[0, :, 0]
    A_pred[:, 2:, 2:] = eye_m
    obs = (mask.t() > 0)[..., None]                           # (T, S, 1)
    A = torch.where(obs[..., None], A_obs, A_pred[None])
    c = torch.where(obs, c_obs, 0.0)

    l0, b0, s0 = _init_state(y, mask, m, "additive")
    x0 = torch.cat([l0[:, None], b0[:, None], s0], dim=1)
    return A, c, x0, e


def _filter_outputs(states, x0, e, y, mask, phi):
    """``((l, b, s), mse, preds)`` from the scanned (T, S, d) state
    trajectory, as :func:`_filter` returns them for (S,) lanes."""
    prev = torch.cat([x0[None], states[:-1]], dim=0)         # state before t
    phi = torch.as_tensor(phi, dtype=y.dtype, device=y.device)
    preds = (prev[..., 0] + phi * prev[..., 1]
             + torch.sum(prev[..., 2:] * e[:, None, :], dim=2)).t()
    err = (y - preds) * mask
    n = torch.clamp_min(torch.sum(mask, dim=1), 1.0)
    mse = torch.sum(err * err, dim=1) / n
    xT = states[-1]
    return (xT[:, 0], xT[:, 1], xT[:, 2:]), mse, preds


def parallel_filter(y, mask, alpha, beta, gamma, m, phi=1.0):
    """Additive HW filter of every row by a parallel prefix over time
    (``ops/pscan.affine_scan``, O(log T) depth).  y, mask: (S, T);
    alpha/beta/gamma/phi scalars or (S,).  Returns ``((l, b, s), mse,
    preds)`` as :func:`_filter` does, within float tolerance of it."""
    A, c, x0, e = _affine_elems(y, mask, alpha, beta, gamma, m, phi)
    states = affine_scan(A, c, x0.to(A.dtype))                # (T, S, d)
    return _filter_outputs(states, x0, e, y, mask, phi)


def parallel_filter_time_sharded(y, mask, alpha, beta, gamma, m, mesh,
                                 axis_name: str = "series", phi=1.0):
    """:func:`parallel_filter` with the time axis sharded over the ranks of
    ``mesh`` (``ops/pscan.affine_scan_time_sharded``): one very long
    series' filter pass spans every device, T growing with the mesh.  Each
    rank passes its own ``T / D`` consecutive steps of y and mask (S, T/D)
    and the same parameters.  Returns ``((l, b, s), mse, preds)`` as
    :func:`parallel_filter` does: preds this rank's steps (S, T/D); the
    final state and the MSE the whole series', equal on every rank.

    The initial state comes from the first two seasonal cycles, which the
    first rank holds (it needs ``T / D >= 2 m``) and sends with one
    all-gather; the MSE's sums and the last rank's final state ride one
    all-reduce.  A global T the mesh does not divide raises ``ValueError``
    (pad at the ops level with identity maps); masked steps are not
    state-preserving (the predict map still advances the level by ``phi *
    trend``), so a mask-0 tail drifts the final state.  The reference
    caches one jitted closure per mesh; eager PyTorch has no program to
    cache, so the port has the function and no cache.
    """
    from distributed_forecasting_tpu_torch.ops.pscan import (
        _affine_scan_time_sharded,
    )
    from distributed_forecasting_tpu_torch.parallel.mesh import (
        all_gather_rows,
        all_reduce_sum,
        mesh_group,
        mesh_rank,
        mesh_size,
    )

    S, T = y.shape
    if T < 2 * m:
        raise ValueError(
            f"each rank holds {T} steps; the time-sharded filter needs at "
            f"least two seasonal cycles ({2 * m}) on the first rank")
    group = mesh_group(mesh, axis_name)
    rank = mesh_rank(mesh, axis_name)
    A, c, x0, e = _affine_elems(y, mask, alpha, beta, gamma, m, phi,
                                offset=rank * T)
    # the first rank's initial state, on every rank
    x0 = all_gather_rows(x0[None], group)[0]
    states, x_eff = _affine_scan_time_sharded(A, c, x0.to(A.dtype), mesh,
                                              axis_name, 1024)
    (l, b, s), _, preds = _filter_outputs(states, x_eff, e, y, mask, phi)
    err = (y - preds) * mask
    xT = torch.cat([l[:, None], b[:, None], s], dim=1)
    last = rank == mesh_size(mesh, axis_name) - 1
    local = torch.cat([torch.sum(err * err, dim=1)[:, None],
                       torch.sum(mask, dim=1)[:, None].to(err.dtype),
                       xT if last else torch.zeros_like(xT)], dim=1)
    total = all_reduce_sum(local, group)
    mse = total[:, 0] / torch.clamp_min(total[:, 1], 1.0)
    return (total[:, 2], total[:, 3], total[:, 4:]), mse, preds


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """Float32 grid of ``num`` points, each the float64 value rounded once."""
    return torch.from_numpy(np.linspace(start, stop, num).astype(np.float32)).to(device)


def _candidate_grid(cfg: HoltWintersConfig, device=None):
    """(alpha, beta, gamma, phi) candidate vectors, (C,) each, in the
    reference's ij-meshgrid order.

    Each value is the float64 grid point rounded once to float32.  The
    reference's float32 ``jnp.linspace`` can land one ulp off that in a few
    entries (default grid: gamma[1]), so winners are compared with the
    reference by grid index and their values within one ulp."""
    a = _linspace(0.05, 0.95, cfg.n_alpha, device)
    b = _linspace(0.01, 0.4, cfg.n_beta, device)
    g = _linspace(0.05, 0.6, cfg.n_gamma, device)
    p = (_linspace(0.80, 0.98, cfg.n_phi, device) if cfg.damped
         else torch.ones(1, device=device))
    return tuple(x.reshape(-1).contiguous()
                 for x in torch.meshgrid(a, b, g, p, indexing="ij"))


def fit(y, mask, day, config: HoltWintersConfig) -> HWParams:
    """Grid-search fit of all series at once.  y, mask: (S, T); day: (T,)."""
    # the kernels read whole rows: a column slice of a longer history
    # (a streamed series' snapshot, a CV window) is copied once
    y, mask = y.contiguous(), mask.contiguous()
    m = config.season_length
    mode = config.seasonality_mode
    A, B, G, P = _candidate_grid(config, device=y.device)

    which = config.filter
    if which == "auto":
        which = select_filter(y.device.type) if mode == "additive" else "scan"
    # the precision gate (ops/precision): bf16 scoring on the scan and pscan
    # routes only; the argmin is its one consumer, the refit stays float32
    sd = scoring_dtype()
    scored = (y, mask, A, B, G, P)
    if sd is not None and which in ("scan", "pscan"):
        scored = tuple(x.to(sd) for x in scored)
    sy, smask, sA, sB, sG, sP = scored
    if which == "pallas":
        if mode != "additive":
            raise ValueError("filter='pallas' supports additive seasonality only")
        msec = hw_score(y, mask, A, B, G, P, m)  # (S, C)
    elif which == "scan":
        _, msec, _ = _filter(sy, smask, sA[None], sB[None], sG[None], m, mode,
                             sP[None], keep_path=False)
    elif which == "pscan":
        if mode != "additive":
            raise ValueError(
                "filter='pscan' supports additive seasonality only "
                "(the multiplicative update is not affine in the state)"
            )
        # one candidate at a time: the (T, S, d, d) maps of all C candidates
        # at once would take C times the memory
        msec = torch.stack([
            parallel_filter(sy, smask, sA[c], sB[c], sG[c], m, sP[c])[1]
            for c in range(A.shape[0])], dim=1)
    else:
        raise ValueError(
            f"unknown filter {config.filter!r}; "
            f"'scan', 'pscan', 'pallas', or 'auto'"
        )

    best = torch.argmin(msec.to(torch.float32), dim=1)  # (S,)
    a, b, g, p = A[best], B[best], G[best], P[best]
    (l, t, s), mse, fitted = hw_filter(y, mask, a, b, g, p, m, mode)
    return HWParams(
        alpha=a, beta=b, gamma=g, phi=p, level=l, trend=t, season=s,
        sigma=torch.sqrt(mse), fitted=fitted,
        day0=day[0].to(torch.float32),
        t_fit_end=day[-1].to(torch.float32),
    )


def forecast(params: HWParams, day_all, t_end, config: HoltWintersConfig):
    """(yhat, lo, hi) over history + future days, each (S, T_all).

    In-sample days (day <= t_fit_end) return the filter's one-step fitted
    path; future days extrapolate level + damped trend + season.  ``t_end``
    (scalar, or one per series) is the last observed day: intervals widen
    from there (a CV cutoff sits before t_fit_end).
    """
    m = config.season_length
    S = params.level.shape[0]
    T_all = day_all.shape[0]
    dev = params.level.device
    dayf = day_all.to(torch.float32)
    h = dayf - params.t_fit_end  # steps past the fit grid; <= 0 in history
    t_end = torch.as_tensor(t_end, dtype=torch.float32, device=dev).reshape(-1, 1)
    h_unc = dayf[None, :] - t_end  # (1 or S, T_all)

    # slot of day d is (d - day0) mod m: training rows were indexed 0..T-1
    sidx = torch.remainder((dayf - params.day0).to(torch.int32), m).long()
    s_at = params.season[:, sidx]  # (S, T_all)
    hpos = torch.clamp_min(h, 0.0)[None, :]
    base = params.level[:, None] + params.trend[:, None] * _damp_sum(
        params.phi[:, None], hpos
    )
    if config.seasonality_mode == "multiplicative":
        fut = base * s_at
    else:
        fut = base + s_at

    yhat = history_splice(params.fitted, fut, day_all, params.day0, h)

    # class-1 variance: var(h) = sigma^2 (1 + sum_{j=1}^{h-1} c_j^2), with
    # the damped form beta * sum_{i<=j} phi^i in place of j*beta
    j = torch.arange(1, T_all + 1, dtype=torch.float32, device=dev)
    cj = (
        params.alpha[:, None]
        * (1.0 + params.beta[:, None] * _damp_sum(params.phi[:, None], j[None, :]))
        + params.gamma[:, None] * (torch.remainder(j[None, :], float(m)) == 0)
    )
    cum = torch.cat(
        [cj.new_zeros((S, 1)), cumsum_rows(cj**2)[:, :-1]], dim=1
    )
    hclip = torch.clamp(h_unc.to(torch.int32) - 1, 0, T_all - 1).long()
    var_mult = 1.0 + torch.gather(cum, 1, hclip.expand(S, T_all))
    var_mult = torch.where(h_unc > 0.0, var_mult, 1.0)
    sd = params.sigma[:, None] * torch.sqrt(var_mult)
    z = _ndtri(0.5 + config.interval_width / 2.0, dev)
    return yhat, yhat - z * sd, yhat + z * sd


def update_state(params: HWParams, aux, y_new, mask_new, valid, day_new,
                 config: HoltWintersConfig, day0=None):
    """Continue the HW filter over appended day-columns (the streaming
    update; ``models/base.ModelFns.update_state``).

    Each real column runs :func:`_hw_step` as :func:`_filter` calls it, on
    a private (m, S) copy of the season: so level, trend and season after
    k columns equal a fit of the extended series bit for bit when the fit
    picks the same candidate (on the card the fit's refit is the
    ``hw_filter`` kernel, bitwise :func:`_filter`).  Padding columns
    (``valid`` 0) are skipped: HW's masked branch still advances the
    level, so padding must not run the step at all.  ``sigma`` continues
    from aux's running (sse, n_obs); ``params.fitted`` is passed through
    unread.  No installed tensor is written: the update reads ``params``
    and returns new tensors."""
    m = config.season_length
    mode = config.seasonality_mode
    cols, days = streamed_columns(valid, day_new)
    d0 = first_day(params, day0)
    S, K = y_new.shape
    l, b = params.level, params.trend
    # (m, S) slot rows, a private copy: _hw_step writes a slot in place,
    # and the installed season may be a view of this very layout
    s = params.season.t().clone(memory_format=torch.contiguous_format)
    sse, n = aux["sse"], aux["n_obs"]
    obs = mask_new > 0
    preds = y_new.new_zeros(S, K)
    for j, d in zip(cols, days):
        yt, mt = y_new[:, j], mask_new[:, j]
        # training rows are indexed (day - day0): the slot of day d
        l, b, pred = _hw_step(l, b, s, yt, obs[:, j], (d - d0) % m,
                              params.alpha, params.beta, params.gamma,
                              params.phi, mode)
        err = (yt - pred) * mt
        sse = sse + err * err
        n = n + mt
        preds[:, j] = pred
    sigma = torch.sqrt(sse / torch.clamp_min(n, 1.0))
    params2 = dataclasses.replace(
        params, level=l, trend=b, season=s.t().contiguous(), sigma=sigma,
        t_fit_end=advance_t_fit_end(params.t_fit_end, days))
    return params2, {"sse": sse, "n_obs": n}, preds


def init_update_aux(params: HWParams, y=None, mask=None):
    """The carries the fit does not keep: ``n_obs`` (exact from the
    training mask, else the grid length) and ``sse`` recovered as
    ``sigma^2 * max(n, 1)`` — the square of a square root, so a streamed
    sigma agrees with a refit's within float tolerance while the filter
    state stays bitwise."""
    if mask is not None:
        n = torch.as_tensor(mask, dtype=torch.float32,
                            device=params.sigma.device).sum(1)
    else:
        n = torch.full_like(params.sigma, float(params.fitted.shape[1]))
    return {"sse": params.sigma**2 * torch.clamp_min(n, 1.0), "n_obs": n}


register_model("holt_winters", fit, forecast, HoltWintersConfig,
               forecast_quantiles=gaussian_quantiles(forecast),
               update_state=update_state, init_update_aux=init_update_aux)
