"""The fit engine: one batched fit + forecast for every series (port of the
reference's ``engine/fit.py``), plus its memory-bounded (chunked) and
ragged (span-bucketed) entry points.

Per-series fault tolerance follows the reference's fail-safe: a series whose
forecast has a non-finite value, or with too little history, is flagged
not-ok and its path replaced by a seasonal-naive fallback with a band that
widens with lead time.  ``forecast_frame`` assembles the output schema
``[ds, store, item, y, yhat, yhat_upper, yhat_lower, training_date]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data.tensorize import (
    SeriesBatch,
    bucket_by_span,
    ordinals_to_dates,
)
from distributed_forecasting_tpu_torch.engine.compile_cache import aot_call
from distributed_forecasting_tpu_torch.models import get_model
from distributed_forecasting_tpu_torch.models.base import generator_kwargs
from distributed_forecasting_tpu_torch.utils.rng import resolve_generator

# a series needs at least this many observed points for its fit to be
# trusted (else the seasonal-naive fallback)
DEFAULT_MIN_POINTS = 14


@dataclasses.dataclass(frozen=True)
class ForecastResult:
    yhat: torch.Tensor     # (S, T_all)
    lo: torch.Tensor       # (S, T_all)
    hi: torch.Tensor       # (S, T_all)
    ok: torch.Tensor       # (S,) bool — fit healthy (fail-safe flag)
    day_all: torch.Tensor  # (T_all,) absolute day grid (history + horizon)


def seasonal_naive(y, mask, horizon: int, season: int = 7):
    """(S, T) history -> (S, T + horizon): the history itself, then the last
    ``season`` values tiled (unobserved ones replaced by the series mean)."""
    tail = y[:, -season:]
    tail_mask = mask[:, -season:]
    mean = torch.sum(y * mask, dim=1) / torch.clamp_min(torch.sum(mask, dim=1), 1.0)
    cycle = torch.where(tail_mask > 0, tail, mean[:, None])  # (S, season)
    reps = -(-horizon // season)
    fut = cycle.repeat(1, reps)[:, :horizon]
    return torch.cat([y, fut], dim=1)


def seasonal_naive_sigma(y, mask, season: int = 7):
    """Per-series residual scale of the seasonal-naive predictor: RMS of the
    observed lag-``season`` differences; falls back to the masked std, then
    to 1.0, so the band is never zero-width."""
    d = y[:, season:] - y[:, :-season]
    m = mask[:, season:] * mask[:, :-season]
    n = torch.sum(m, dim=1)
    ssq = torch.sum((d * m) ** 2, dim=1)
    sigma = torch.sqrt(ssq / torch.clamp_min(n, 1.0))
    cnt = torch.clamp_min(torch.sum(mask, dim=1), 1.0)
    mean = torch.sum(y * mask, dim=1) / cnt
    var = torch.sum(((y - mean[:, None]) * mask) ** 2, dim=1) / cnt
    sigma = torch.where(n > 0, sigma, torch.sqrt(var))
    return torch.where((n > 0) | (var > 0), torch.clamp_min(sigma, 1e-6), 1.0)


def health_fallback(y, mask, yhat, lo, hi, horizon: int, min_points: int,
                    season: int = 7):
    """Flag series with a non-finite forecast or fewer than ``min_points``
    observations, and splice the seasonal-naive fallback into them with a
    95% band whose variance grows one innovation per season ahead.
    Returns ``(yhat, lo, hi, ok)``."""
    finite = (
        torch.all(torch.isfinite(yhat), dim=1)
        & torch.all(torch.isfinite(lo), dim=1)
        & torch.all(torch.isfinite(hi), dim=1)
    )
    enough = torch.sum(mask, dim=1) >= min_points
    ok = finite & enough

    fb = seasonal_naive(y, mask, horizon, season=season)
    fb_sigma = seasonal_naive_sigma(y, mask, season=season)
    T = y.shape[1]
    h_fut = torch.arange(1, horizon + 1, dtype=torch.float32, device=y.device)
    widen = torch.cat([y.new_ones(T), torch.sqrt(torch.ceil(h_fut / season))])
    band = 1.96 * fb_sigma[:, None] * widen[None, :]
    keep = ok[:, None]
    return (torch.where(keep, yhat, fb), torch.where(keep, lo, fb - band),
            torch.where(keep, hi, fb + band), ok)


def day_grid(day, horizon: int):
    """History + horizon day grid on the batch's device (the day axis is
    contiguous: tensorize builds it with arange)."""
    return day[0] + torch.arange(day.shape[0] + horizon, dtype=day.dtype,
                                 device=day.device)


def validate_xreg(fns, model: str, config, xreg, expected_T, what: str,
                  trim_to=None):
    """Entry-point validation of exogenous-regressor tensors, shared by
    ``fit_forecast`` and ``cross_validate``.  Returns the float32 tensor, or
    None when no regressors are in play.  ``expected_T``: the required time
    length; ``trim_to`` instead requires at least that many steps and trims
    to them (the CV contract)."""
    if xreg is None:
        if config is not None and getattr(config, "n_regressors", 0):
            raise ValueError(
                f"config.n_regressors={config.n_regressors} but no xreg "
                f"was passed to {what}"
            )
        return None
    if not fns.supports_xreg:
        raise ValueError(
            f"model {model!r} does not accept exogenous regressors; "
            f"use the curve model ('prophet') or the AR-Net family "
            f"('arnet')"
        )
    xreg = torch.as_tensor(xreg, dtype=torch.float32)
    if xreg.dim() not in (2, 3):
        raise ValueError(
            f"xreg must be (T, R) shared or (S, T, R) per-series, got "
            f"{xreg.dim()}-D"
        )
    if expected_T is not None and xreg.shape[-2] != expected_T:
        raise ValueError(
            f"xreg time axis is {xreg.shape[-2]}, expected history + "
            f"horizon = {expected_T} (future regressor values must be known)"
        )
    if trim_to is not None:
        if xreg.shape[-2] < trim_to:
            raise ValueError(
                f"xreg time axis is {xreg.shape[-2]}, expected at least the "
                f"history length {trim_to}"
            )
        xreg = xreg[:trim_to] if xreg.dim() == 2 else xreg[:, :trim_to]
    return xreg


_CALENDAR_DAILY_MODELS = frozenset({"prophet", "curve", "prophet_ar"})


def validate_grid_cadence(model: str, batch) -> None:
    """The curve family's weekly/yearly Fourier periods and holiday day
    math are calendar-daily: on a week or month grid they would silently
    fit a 7-week "weekly" cycle, so such a batch raises."""
    if model in _CALENDAR_DAILY_MODELS and getattr(batch, "freq", "D") != "D":
        raise ValueError(
            f"model {model!r} is calendar-daily (weekly/yearly Fourier, "
            f"holiday day-math) but the batch's grid cadence is "
            f"{batch.freq!r}; use a cadence-agnostic family "
            f"(holt_winters) or tensorize at freq='D'"
        )


def validate_changepoint_days(config, day) -> None:
    """Explicit changepoint sites must fall within the training days
    (Prophet's 'Changepoints must fall within training data'); catches raw
    ``toordinal()`` values, ~719163 days past the range."""
    days = getattr(config, "changepoint_days", ()) if config is not None else ()
    if not days:
        return
    lo, hi = int(day[0]), int(day[-1])
    bad = [int(d) for d in days if not lo <= int(d) <= hi]
    if bad:
        raise ValueError(
            f"changepoint_days {bad} fall outside the training data "
            f"(day range [{lo}, {hi}]); days are unix epoch days — "
            f"pd.Timestamp(d).toordinal() - 719163"
        )


def _apply_autoprep(batch: SeriesBatch, autoprep) -> SeriesBatch:
    """The prep the fit entry points share: when the process-wide
    ``engine.autoprep`` block is armed (or a config is forced), run its
    CLEANING stages over the batch.  The stages that shape configs (season
    detection, holiday regressors) stay off here: the training pipeline
    owns them.  ``autoprep=False`` skips prep (the pipeline passes it after
    prepping once)."""
    if autoprep is False:
        return batch
    from distributed_forecasting_tpu_torch.engine.autoprep import (
        AutoprepConfig,
        autoprep_batch,
        autoprep_config,
    )

    apcfg = autoprep if isinstance(autoprep, AutoprepConfig) \
        else autoprep_config()
    if not apcfg.enabled:
        return batch
    # the fit sees the repaired tensor; the stored history is untouched
    apcfg = dataclasses.replace(apcfg, season_detect=False,
                                holiday_regressors=False)
    if not apcfg.any_stage:
        return batch
    return autoprep_batch(batch, apcfg).batch


def fit_forecast(
    batch: SeriesBatch,
    model: str = "prophet",
    config=None,
    horizon: int = 90,
    min_points: int = DEFAULT_MIN_POINTS,
    xreg=None,
    autoprep=None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[object, ForecastResult]:
    """Fit every series of ``batch`` and forecast ``horizon`` steps past the
    end of history, on the batch's device.  Returns ``(params, result)``.

    ``generator``: the draws of a family that samples (the curve model's
    Monte-Carlo intervals); ``None`` seeds one as the reference seeds its
    default key (``utils/rng.py``).  An arnet fit routes to the engine
    path (``engine.gradfit.gradfit_fit_forecast``) when the process-wide
    ``engine.gradfit`` block is armed; an arima ``method='hr'`` fit without
    ``xreg`` to ``engine.windowed.windowed_fit_forecast`` when the
    ``engine.windowed`` block is armed and the history reaches its
    threshold (its result covers the tail window + horizon).

    ``xreg``: exogenous regressor values over history AND horizon,
    (T + horizon, R) shared or (S, T + horizon, R) per series, for a model
    that takes them (the curve model, with ``config.n_regressors == R``):
    the fit sees the history slice, the forecast the whole window.

    ``autoprep``: ``None`` applies the process-wide ``engine.autoprep``
    CLEANING stages (zero-run masking, outlier repair, level-shift
    alignment) when that block is armed; ``False`` skips prep; an
    :class:`~distributed_forecasting_tpu_torch.engine.autoprep.AutoprepConfig`
    forces one.
    """
    fns = get_model(model)
    validate_grid_cadence(model, batch)
    config = config if config is not None else fns.config_cls()
    batch = _apply_autoprep(batch, autoprep)
    if (model == "arima" and xreg is None
            and getattr(config, "method", None) == "hr"):
        # ultra-long auto-activation (the engine.windowed conf block): at
        # or above its threshold the fit runs over windows of the history
        # (engine/windowed.py); the result's grid covers the tail window +
        # horizon
        from distributed_forecasting_tpu_torch.engine.windowed import (
            should_window,
            windowed_fit_forecast,
        )

        if should_window(batch.n_time):
            return windowed_fit_forecast(
                batch, model=model, config=config, horizon=horizon,
                generator=generator, min_points=min_points)
    y, mask, day = batch.y, batch.mask, batch.day
    validate_changepoint_days(config, day)
    xreg = validate_xreg(fns, model, config, xreg, batch.n_time + horizon,
                         "fit_forecast")
    if model == "arnet":
        from distributed_forecasting_tpu_torch.engine.gradfit import (
            gradfit_config,
            gradfit_fit_forecast,
        )

        if gradfit_config().enabled:
            return gradfit_fit_forecast(batch, config=config, horizon=horizon,
                                        min_points=min_points, xreg=xreg)
    # the reference's AOT entry point (engine/compile_cache.aot_call): an
    # aot.call span and the dispatch charged to the cost registry
    params, yhat, lo, hi, ok, day_all = aot_call(
        f"fit_forecast:{model}", _fit_forecast_impl,
        args=(y, mask, day),
        static_kwargs=dict(model=model, config=config, horizon=horizon,
                           min_points=min_points),
        dynamic_kwargs=dict(xreg=xreg, generator=generator),
    )
    return params, ForecastResult(yhat=yhat, lo=lo, hi=hi, ok=ok,
                                  day_all=day_all)


def _fit_forecast_impl(y, mask, day, model, config, horizon, min_points,
                       xreg=None, generator=None):
    """The family's fit, its forecast over history + horizon and the
    fail-safe: ``(params, yhat, lo, hi, ok, day_all)``."""
    fns = get_model(model)
    day_all = day_grid(day, horizon)
    t_end = day[-1].to(torch.float32)
    gkw = generator_kwargs(fns, generator)
    if xreg is not None:
        xreg = xreg.to(y.device)
        T = y.shape[1]
        params = fns.fit(y, mask, day, config,
                         xreg=xreg[:T] if xreg.dim() == 2 else xreg[:, :T])
        yhat, lo, hi = fns.forecast(params, day_all, t_end, config, xreg=xreg,
                                    **gkw)
    else:
        params = fns.fit(y, mask, day, config)
        yhat, lo, hi = fns.forecast(params, day_all, t_end, config, **gkw)
    yhat, lo, hi, ok = health_fallback(y, mask, yhat, lo, hi, horizon,
                                       min_points)
    return params, yhat, lo, hi, ok, day_all


def fit_forecast_chunked(
    batch: SeriesBatch,
    model: str = "prophet",
    config=None,
    horizon: int = 90,
    chunk_size: int = 4096,
    min_points: int = DEFAULT_MIN_POINTS,
    dispatch: str = "scan",
    xreg=None,
    autoprep=None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[object, ForecastResult]:
    """Memory-bounded fit for very large batches (the 50k-series regime).

    The series axis splits into equal ``chunk_size`` blocks (the last one
    padded with masked rows), so the device holds one block's intermediates
    at a time and every chunk runs at one shape.  Per-series parameter
    fields come back concatenated along axis 0 and cut to S; shared fields
    (the curve model's 0-d ``t0``/``t1``, empty regressor or AR fields) come
    from any one chunk.  ``xreg`` is a shared (T + horizon, R) calendar or
    per-series (S, T + horizon, R) values, padded with the series.

    ``dispatch`` takes the reference's two values, ``'scan'`` (there one
    compiled ``lax.scan`` over the chunks) and ``'loop'`` (a host loop).  On
    the card both are one host loop over chunks of one shape: PyTorch
    launches every chunk's kernels as they come, and no launch round trip
    is there for a scan to save.  ``autoprep`` as in :func:`fit_forecast`:
    the whole batch is prepped once, before it is cut into chunks.  One
    ``generator`` draws for every chunk in turn, where the reference folds
    its key per chunk.
    """
    if dispatch not in ("scan", "loop"):
        raise ValueError(f"unknown dispatch {dispatch!r}; 'scan' or 'loop'")
    batch = _apply_autoprep(batch, autoprep)
    S = batch.n_series
    if S <= chunk_size:
        return fit_forecast(batch, model=model, config=config, horizon=horizon,
                            min_points=min_points, xreg=xreg, autoprep=False,
                            generator=generator)
    fns = get_model(model)
    config = config if config is not None else fns.config_cls()
    validate_changepoint_days(config, batch.day)
    xreg = validate_xreg(fns, model, config, xreg, batch.n_time + horizon,
                         "fit_forecast_chunked")
    if generator is None and fns.draws:
        generator = resolve_generator(None, batch.y.device, 0)
    n_chunks = -(-S // chunk_size)
    padded = batch.pad_series_to(n_chunks * chunk_size)
    per_series_x = xreg is not None and xreg.dim() == 3
    if per_series_x:
        xreg = xreg.to(batch.y.device)
        xreg = torch.cat([xreg, xreg.new_zeros(
            (n_chunks * chunk_size - S,) + tuple(xreg.shape[1:]))])

    chunks = []
    for c in range(n_chunks):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        sub = dataclasses.replace(padded, y=padded.y[sl], mask=padded.mask[sl],
                                  keys=padded.keys[sl])
        chunks.append(fit_forecast(
            sub, model=model, config=config, horizon=horizon,
            min_points=min_points, xreg=xreg[sl] if per_series_x else xreg,
            autoprep=False, generator=generator))

    first = chunks[0][0]
    params = type(first)(**{
        f.name: (torch.cat([getattr(p, f.name) for p, _ in chunks])[:S]
                 if v.dim() > 0 and v.shape[0] == chunk_size else v)
        for f in dataclasses.fields(first)
        for v in (getattr(first, f.name),)
    })
    cat = lambda k: torch.cat([getattr(r, k) for _, r in chunks])[:S]  # noqa: E731
    result = ForecastResult(yhat=cat("yhat"), lo=cat("lo"), hi=cat("hi"),
                            ok=cat("ok"), day_all=chunks[0][1].day_all)
    return params, result


def fit_forecast_bucketed(
    batch: SeriesBatch,
    model: str = "prophet",
    config=None,
    horizon: int = 90,
    min_points: int = DEFAULT_MIN_POINTS,
    max_buckets: int = 4,
    xreg=None,
    autoprep=None,
    generator: Optional[torch.Generator] = None,
):
    """Fit a ragged batch in span buckets (``data.tensorize.bucket_by_span``):
    each bucket fits on its trimmed grid, one ``fit_forecast`` a bucket, so a
    batch where most series started recently does proportionally less work.
    Returns ``(buckets, result)``:

    * ``buckets``: ``(indices, sub_batch, params)`` per bucket; the params'
      time-shaped fields have bucket length, and the sub-batch carries the
      trimmed grid they were fit on, which ``serving.BucketedForecaster``
      rebuilds its predictors from;
    * ``result``: a full-grid ``ForecastResult`` over history + horizon;
      the rows before a bucket's window (fully masked by construction)
      carry that series' earliest in-window value.

    A bucket's xreg is the tail ``xreg[T - L:]`` of the full (T + horizon)
    window.  The reference double-buffers each bucket's host-to-device copy
    (its ``prefetch_to_device``); here the sub-batches are slices of tensors
    already on the device, so there is nothing to prefetch.  ``autoprep``
    as in :func:`fit_forecast`, once on the shared grid before bucketing
    (repairs on a trimmed grid would see truncated neighborhoods).  One
    ``generator`` draws for every bucket in turn.
    """
    batch = _apply_autoprep(batch, autoprep)
    buckets = bucket_by_span(batch, max_buckets=max_buckets)
    S, T = batch.n_series, batch.n_time
    T_all = T + horizon
    fns = get_model(model)
    validate_changepoint_days(config, batch.day)
    xreg = validate_xreg(
        fns, model, config if config is not None else fns.config_cls(),
        xreg, T_all, "fit_forecast_bucketed",
    )
    if xreg is not None:
        xreg = xreg.to(batch.y.device)
    dev = batch.y.device
    if generator is None and fns.draws:
        generator = resolve_generator(None, dev, 0)
    yhat = torch.zeros((S, T_all), device=dev)
    lo = torch.zeros((S, T_all), device=dev)
    hi = torch.zeros((S, T_all), device=dev)
    ok = torch.zeros((S,), dtype=torch.bool, device=dev)
    bucket_params = []
    for idx, sub in buckets:
        rows = torch.as_tensor(idx, dtype=torch.long, device=dev)
        xr = None
        if xreg is not None:
            L = sub.n_time
            xr = xreg[T - L:] if xreg.dim() == 2 else xreg[rows][:, T - L:]
        p, r = fit_forecast(sub, model=model, config=config, horizon=horizon,
                            min_points=min_points, xreg=xr, autoprep=False,
                            generator=generator)
        lead = T_all - r.yhat.shape[1]

        def fill(M):
            return torch.cat([M[:, :1].expand(len(idx), lead), M], dim=1)

        yhat[rows] = fill(r.yhat)
        lo[rows] = fill(r.lo)
        hi[rows] = fill(r.hi)
        ok[rows] = r.ok
        bucket_params.append((idx, sub, p))
    result = ForecastResult(yhat=yhat, lo=lo, hi=hi, ok=ok,
                            day_all=day_grid(batch.day, horizon))
    return bucket_params, result


def long_frame_skeleton(keys, key_names, day_all, freq: str = "D") -> dict:
    """``[ds, *keys]`` columns of a long (series x day) table."""
    keys = np.asarray(keys)
    day_np = day_all.cpu().numpy() if torch.is_tensor(day_all) else day_all
    T_all = int(day_np.shape[0])
    dates = ordinals_to_dates(np.asarray(day_np, dtype="int64"), freq)
    frame = {"ds": np.tile(dates.values, keys.shape[0])}
    for j, name in enumerate(key_names):
        frame[name] = np.repeat(keys[:, j], T_all)
    return frame


def forecast_frame(
    batch: SeriesBatch,
    result: ForecastResult,
    training_date: Optional[str] = None,
) -> pd.DataFrame:
    """Long output table ``[ds, store, item, y, yhat, yhat_upper,
    yhat_lower, training_date]`` over ``result.day_all``.  A windowed fit's
    grid starts at its tail window, not at the history's first day: ``y``
    then holds the history from that day on."""
    S = batch.n_series
    T_all = int(result.day_all.shape[0])
    skip = int(result.day_all[0]) - int(batch.day[0])
    T_hist = batch.n_time - skip
    y_full = np.full((S, T_all), np.nan)
    y_hist = batch.y[:, skip:].cpu().numpy()
    m_hist = batch.mask[:, skip:].cpu().numpy() > 0
    y_full[:, :T_hist] = np.where(m_hist, y_hist, np.nan)

    frame = long_frame_skeleton(batch.keys, batch.key_names, result.day_all,
                                freq=batch.freq)
    frame["y"] = y_full.reshape(-1)
    frame["yhat"] = result.yhat.cpu().numpy().reshape(-1)
    frame["yhat_upper"] = result.hi.cpu().numpy().reshape(-1)
    frame["yhat_lower"] = result.lo.cpu().numpy().reshape(-1)
    df = pd.DataFrame(frame)
    df["training_date"] = pd.Timestamp(
        training_date if training_date else pd.Timestamp.now().date()
    )
    return df
