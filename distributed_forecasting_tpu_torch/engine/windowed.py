"""Window-parallel fitting for ultra-long series, DARIMA split-and-combine
(port of the reference's ``engine/windowed.py``).

*Distributed ARIMA Models for Ultra-long Time Series* (arXiv 2007.09577)
turns the sequential T axis into a batch: partition each series into K
overlapping windows of length W, fit every window of every series
independently, and reconcile the per-window coefficient estimates with one
closed-form weighted-least-squares solve.  An (S, T) problem becomes an
(S*K, W) problem; window rows are rows like any other series.

Three stages, as in the reference:

- the window statistics: ``models/arima.window_stats`` over the flat
  (S*K, W) window batch, the per-window HR sufficient statistics (library
  calls: reductions, the Gram's batched GEMM, ``solve_dense``);
- the combine: ``ops/combine.wls_combine``, one (S, F, F) batched solve
  over O(F^2) statistics;
- the finalize: PACF-stabilize the combined coefficients, run the
  post-estimation Kalman pass over the LAST window only (one
  ``arima_filter`` launch over (S, W) on the card), forecast (one
  ``arima_predict`` launch) and apply the health fallback.

Each stage runs at the reference's entry point
(``engine/compile_cache.aot_call``: ``windowed_fit:arima``,
``windowed_combine:arima``, ``windowed_finalize:arima``,
``windowed_refit:arima``) under its span (``windowed.fit``,
``windowed.combine``, ``windowed.finalize``, ``windowed.refit``) and a
``device_annotation`` of the entry, which marks its kernels in a
``torch.profiler`` trace.  The finalize always filters with
``kalman='scan'``: W sits
far below the parallel filter's long-series tier.  The reference's
``ops/fused_scan.select_filter`` also reads the windowed scan length to
rule ``pscan`` out; the port's ``select_filter`` reads no shape and never
picks ``pscan``, so it has no windowed tier to port.

Exactness contract (the reference's ``docs/windowed.md``): the combined
estimator is tolerance-grade against the whole-series HR fit, not
bitwise.  The returned ``ArimaParams`` are anchored at the TAIL window
(``day0`` = tail start) and ``ForecastResult.day_all`` covers tail window +
horizon, not the whole history; the Kalman pass covers W steps however
long the series.

Streaming: :class:`WindowedSeriesStateStore` refits only the newest
window, reusing the frozen prefix windows' statistics, so a refit costs
O(W) device work however long the history is.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine.compile_cache import aot_call
from distributed_forecasting_tpu_torch.engine.fit import (
    DEFAULT_MIN_POINTS,
    ForecastResult,
    day_grid,
    health_fallback,
)
from distributed_forecasting_tpu_torch.engine.state_store import (
    SeriesStateStore,
    _pad_time,
    store_device,
    time_cap,
    to_device,
)
from distributed_forecasting_tpu_torch.models import arima
from distributed_forecasting_tpu_torch.models.base import get_model
from distributed_forecasting_tpu_torch.monitoring.trace import (
    device_annotation,
    get_tracer,
)
from distributed_forecasting_tpu_torch.ops.combine import combine_estimates
from distributed_forecasting_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass(frozen=True)
class WindowedConfig:
    """The ``engine.windowed`` conf block.

    ``enabled`` arms the auto-activation in ``engine.fit_forecast``: an
    arima fit whose history reaches ``window_len * min_windows`` periods
    routes through :func:`windowed_fit_forecast` instead of the sequential
    whole-series fit.  Shorter series keep the exact sequential path: the
    threshold is where the windowed estimator has enough windows for the
    WLS reconciliation to mean something.
    """

    enabled: bool = False
    window_len: int = 8192
    overlap: int = 256
    min_windows: int = 4

    def __post_init__(self):
        if self.window_len < 128:
            # the HR long-AR needs K=max(hr_ar_order, p+q+m) leading rows
            # per window just for lag features; below ~128 the per-window
            # regression is noise
            raise ValueError(
                f"window_len must be >= 128, got {self.window_len}")
        if not 0 <= self.overlap < self.window_len:
            raise ValueError(
                f"overlap must be in [0, window_len), got {self.overlap} "
                f"with window_len={self.window_len}")
        if self.min_windows < 2:
            raise ValueError(
                f"min_windows must be >= 2 (one window is just the "
                f"sequential fit), got {self.min_windows}")

    @property
    def stride(self) -> int:
        return self.window_len - self.overlap

    @property
    def auto_threshold(self) -> int:
        """History length at/above which auto-activation kicks in."""
        return self.window_len * self.min_windows

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "WindowedConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like windw_len must not silently fall back to defaults
            raise ValueError(
                f"unknown engine.windowed conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


_active_config = WindowedConfig()


def configure_windowed(conf) -> WindowedConfig:
    """Install the process-wide windowed config (``tasks/common`` parses the
    ``engine.windowed`` conf block into this).  Accepts a dict or a
    :class:`WindowedConfig`; returns the installed config."""
    global _active_config
    cfg = conf if isinstance(conf, WindowedConfig) \
        else WindowedConfig.from_conf(conf)
    _active_config = cfg
    return cfg


def windowed_config() -> WindowedConfig:
    return _active_config


def should_window(n_time: int, config: Optional[WindowedConfig] = None) -> bool:
    """Auto-activation predicate for ``engine.fit_forecast``; ``n_time`` is
    a batch's time length."""
    cfg = config if config is not None else _active_config
    return bool(cfg.enabled) and int(n_time) >= cfg.auto_threshold


def plan_windows(n_time: int, window_len: int, overlap: int) -> Tuple[int, ...]:
    """Start offsets of K windows, EVERY one exactly ``window_len`` long.

    Regular windows start at multiples of ``stride = window_len - overlap``;
    the final window is RIGHT-ALIGNED at ``n_time - window_len`` so the
    newest data always has full-window support and the tail window's shape
    never varies: the property the streaming store leans on.  Consecutive
    windows overlap by at least ``overlap`` periods (more for the tail),
    which the WLS combine handles like DARIMA's overlapping sub-series.
    """
    W, T = int(window_len), int(n_time)
    if T < W:
        raise ValueError(
            f"series length {T} is below window_len={W}; windowed fitting "
            f"needs at least one full window")
    if T == W:
        return (0,)
    stride = W - int(overlap)
    starts = list(range(0, T - W, stride))
    starts.append(T - W)
    return tuple(starts)


def _validate_model(model: str, config) -> object:
    """Windowed fitting is arima-only (the HR path has closed-form
    sufficient statistics; no other family does).  Returns the effective
    config, ``kalman`` forced to 'scan' so that the finalize's pass is the
    ``arima_filter`` kernel: it covers at most ``window_len`` steps, where
    a parallel prefix filter could never pay for its tree."""
    if model != "arima":
        raise ValueError(
            f"windowed fitting supports model='arima' only (the DARIMA "
            f"estimator combines HR sufficient statistics); got {model!r}")
    fns = get_model(model)
    config = config if config is not None else fns.config_cls()
    if config.method != "hr":
        raise ValueError(
            "windowed fitting requires ArimaConfig.method='hr'; the MLE "
            "path has no closed-form statistics to combine")
    if config.kalman == "pscan":
        config = dataclasses.replace(config, kalman="scan")
    return config


def _check_window_len(config, window_len: int) -> None:
    _, _, p_eff, q_eff = arima._lag_sets(config)
    K = max(config.hr_ar_order, p_eff + q_eff + config.m)
    if window_len < 4 * K:
        raise ValueError(
            f"window_len={window_len} is too short for the HR long-AR "
            f"order K={K} (need >= {4 * K}): each window loses K leading "
            f"rows to lag features and the remainder must dominate")


def _gather_windows(y, mask, starts: Tuple[int, ...], W: int):
    """(S, T) -> flat (S*K, W) window batch, windows of one series
    CONTIGUOUS (series-major): the layout ``ops/combine.wls_combine``
    regroups."""
    yw = torch.stack([y[:, s:s + W] for s in starts], dim=1)
    mw = torch.stack([mask[:, s:s + W] for s in starts], dim=1)
    S, K = yw.shape[0], yw.shape[1]
    return yw.reshape(S * K, W), mw.reshape(S * K, W)


def _window_fit(model: str, config, yw, mw) -> dict:
    """One batched per-window statistics call at the AOT entry
    ``windowed_fit:<model>``."""
    entry = f"windowed_fit:{model}"
    with get_tracer().span("windowed.fit", model=model,
                           rows=int(yw.shape[0]),
                           window_len=int(yw.shape[1])):
        with device_annotation(entry):
            return aot_call(entry, arima.window_stats, args=(yw, mw),
                            static_kwargs={"config": config})


def _tail_params(y_tail, mask_tail, day_tail, coef, mean, config):
    """Combined coefficients -> tail-anchored params: the stabilized
    polynomials, then the Kalman and integration pass over the tail window
    (``arima_filter`` on the card)."""
    ar_lags, ma_lags, p_eff, q_eff = arima._lag_sets(config)
    phi, theta = arima.coef_to_poly(coef, ar_lags, ma_lags, p_eff, q_eff)
    return arima.params_from_estimates(y_tail, mask_tail, day_tail, config,
                                       phi, theta, mean)


def _finalize(model: str, config, y_tail, mask_tail, day_tail, coef, mean,
              horizon: int, min_points: int):
    """The tail finalize at the AOT entry ``windowed_finalize:<model>``."""
    entry = f"windowed_finalize:{model}"
    with get_tracer().span("windowed.finalize", model=model,
                           series=int(y_tail.shape[0]),
                           window_len=int(y_tail.shape[1])):
        with device_annotation(entry):
            return aot_call(
                entry, _windowed_finalize_impl,
                args=(y_tail, mask_tail, day_tail, coef, mean),
                static_kwargs=dict(config=config, horizon=horizon,
                                   min_points=min_points))


def _windowed_finalize_impl(y_tail, mask_tail, day_tail, coef, mean, config,
                            horizon: int, min_points: int):
    """Tail-anchored params, forecast and health fallback; the forecast is
    one ``arima_predict`` launch on the card."""
    params = _tail_params(y_tail, mask_tail, day_tail, coef, mean, config)
    day_all = day_grid(day_tail, horizon)
    t_end = day_tail[-1].to(torch.float32)
    yhat, lo, hi = arima.forecast(params, day_all, t_end, config)
    yhat, lo, hi, ok = health_fallback(y_tail, mask_tail, yhat, lo, hi,
                                       horizon, min_points)
    return params, yhat, lo, hi, ok, day_all


def windowed_fit_forecast(
    batch: SeriesBatch,
    model: str = "arima",
    config=None,
    horizon: int = 90,
    generator: Optional[torch.Generator] = None,
    min_points: int = DEFAULT_MIN_POINTS,
    mesh=None,
    wconfig: Optional[WindowedConfig] = None,
) -> Tuple[object, ForecastResult]:
    """DARIMA split-and-combine fit over an ultra-long batch, on the
    batch's device.

    Partition -> one batched window-statistics call -> WLS combine -> tail
    finalize.  Returns tail-anchored ``ArimaParams`` (they route through
    the serving predictor unchanged) and a :class:`ForecastResult` whose
    grid covers TAIL WINDOW + horizon (``day_all[0]`` is the tail window's
    start, not the history's).

    ``generator`` is what the port's ``fit_forecast`` takes where the
    reference takes ``key``; arima draws nothing, so it is not read.

    ``mesh``: a series mesh (``parallel.make_mesh``).  Each rank takes its
    block of the series padded to a mesh multiple, with all their windows
    (windows are rows of their series), and runs the window statistics,
    the combine and the tail finalize on it; then the params and results
    are all-gathered and trimmed to the batch's S, so every rank returns
    the whole result, as the reference's replicated one.
    """
    wcfg = wconfig if wconfig is not None else _active_config
    config = _validate_model(model, config)
    _check_window_len(config, wcfg.window_len)
    W = wcfg.window_len
    starts = plan_windows(batch.n_time, W, wcfg.overlap)
    y, mask, day = batch.y, batch.mask, batch.day
    S = batch.n_series
    if mesh is not None:
        from distributed_forecasting_tpu_torch.parallel.sharded import (
            shard_batch,
        )

        local = shard_batch(batch, mesh)
        y, mask, day = local.y, local.mask, local.day

    yw, mw = _gather_windows(y, mask, starts, W)
    stats = _window_fit(model, config, yw, mw)
    comb = combine_estimates(model, stats, len(starts))

    t0 = starts[-1]
    params, yhat, lo, hi, ok, day_all = _finalize(
        model, config, y[:, t0:t0 + W], mask[:, t0:t0 + W], day[t0:t0 + W],
        comb["coef"], comb["mean"], horizon, min_points)
    if mesh is not None:
        params, (yhat, lo, hi, ok) = _gather_series(
            mesh, y.shape[0], S, params, (yhat, lo, hi, ok))
    return params, ForecastResult(yhat=yhat, lo=lo, hi=hi, ok=ok,
                                  day_all=day_all)


def _gather_series(mesh, rows: int, S: int, params, results):
    """Every rank's ``rows``-row block of the params and results,
    all-gathered in rank order and trimmed to ``S``: each per-series leaf
    (leading axis ``rows``) becomes the whole batch's; the rest (the
    grid's scalars) is replicated already.  ``ok`` travels as float32."""
    from distributed_forecasting_tpu_torch.parallel.mesh import (
        all_gather_rows,
        mesh_group,
    )

    group = mesh_group(mesh)

    def gather(x):
        if x.dim() == 0 or x.shape[0] != rows:
            return x
        if x.dtype == torch.bool:
            return all_gather_rows(x.to(torch.float32), group)[:S] > 0
        return all_gather_rows(x, group)[:S]

    params = dataclasses.replace(params, **{
        f.name: gather(getattr(params, f.name))
        for f in dataclasses.fields(params)})
    return params, tuple(gather(x) for x in results)


# ---------------------------------------------------------------------------
# streaming composition: tail-window-only refit
# ---------------------------------------------------------------------------

class WindowedSeriesStateStore(SeriesStateStore):
    """Streaming state store for a windowed (ultra-long) arima forecaster.

    Arima has no incremental filter kernel, so the base store rejects it;
    here ingest folds points into the history buffers only, and a REFIT
    recomputes the TAIL WINDOW alone: the per-window statistics of the
    frozen prefix windows are cached at their first computation and reused
    verbatim, so every refit costs O(window_len) device work however long
    the history is.  ``serving/refit.RefitScheduler`` drives it through the
    same ``refit_stages`` protocol as the base store.

    Exactness: a cached-prefix refit is BITWISE equal to the same refit
    with a cold cache (the same calls at the (S, W) shape over the same
    slices).  Late points landing inside a frozen window invalidate the
    whole cache (the next refit recomputes every window).

    ``device``: where the store lives, the card unless the caller passes
    ``device="cpu"``; the forecaster's parameters must already be there.
    A refit's statistics and tail params run at the ``windowed_fit`` and
    ``windowed_refit`` entries under their spans, and its install under a
    ``refit.swap`` span (``tail_window=True``).
    """

    def __init__(self, forecaster, history_y, history_mask,
                 history_day0: int, wconfig: Optional[WindowedConfig] = None,
                 time_bucket: int = 32, metrics=None,
                 max_pending_days: int = 366, device=None):
        # deliberately NOT calling super().__init__: the base requires a
        # streaming update kernel (arima has none) and anchors history at
        # forecaster.day0 (here the TAIL window start, not the history
        # start).  The attributes below are what the inherited
        # ingest() / stats() / _grow_history() read.
        if history_y is None or history_mask is None:
            raise ValueError(
                "WindowedSeriesStateStore needs the full training history "
                "(refits are its only freshness mechanism)")
        self._wcfg = wconfig if wconfig is not None else _active_config
        self.config = _validate_model(forecaster.model, forecaster.config)
        _check_window_len(self.config, self._wcfg.window_len)
        self.device = store_device(forecaster, device)
        self._fc = forecaster
        self.model = forecaster.model
        self.day0 = int(history_day0)   # HISTORY grid anchor (ingest rows)
        self.time_bucket = max(int(time_bucket), 1)
        self.max_pending_days = max(int(max_pending_days), 1)
        self.metrics = metrics
        self.logger = get_logger("WindowedSeriesStateStore")

        self._lock = threading.Lock()
        self._apply_gate = threading.BoundedSemaphore(1)
        # one snapshot: params is consumed below, day1 here
        params, day1 = forecaster._state_snapshot()
        self._day_cur = int(day1)
        self._pending: Dict[int, Dict[int, float]] = {}
        self._applied_since_refit = 0
        self._late_points = 0
        self._late_seen = 0
        self._last_refit_monotonic = time.monotonic()

        history_y = np.asarray(history_y, np.float32)
        history_mask = np.asarray(history_mask, np.float32)
        S, T0 = history_y.shape
        if T0 < self._wcfg.window_len:
            raise ValueError(
                f"history length {T0} is below "
                f"window_len={self._wcfg.window_len}")
        self.n_series = S
        t_cap = time_cap(T0, self.time_bucket)
        self._y = np.zeros((S, t_cap), np.float32)
        self._mask = np.zeros((S, t_cap), np.float32)
        self._y[:, :T0] = history_y
        self._mask[:, :T0] = history_mask

        # frozen per-window statistics, keyed by window start offset
        # (history-grid rows).  Regular windows never move (starts at
        # stride multiples), so an entry stays valid until a late point
        # lands inside it.
        self._frozen: Dict[int, dict] = {}

        w_fit = int(params.fitted.shape[1])
        self._params = dataclasses.replace(params, fitted=_pad_time(
            params.fitted, time_cap(w_fit, self.time_bucket)))
        forecaster.time_bucket = self.time_bucket
        forecaster.swap_state(params=self._params, day1=self._day_cur)

    # -- the batched apply ---------------------------------------------------
    def apply_pending(self) -> Dict[str, int]:
        """Fold every pending point into the history buffers and advance
        the frontier, with NO device work.  Freshness comes from the
        tail-window refit; the applied-points counter feeds the scheduler's
        backlog trigger as in the base store."""
        with self._apply_gate:
            with self._lock:
                if not self._pending:
                    return {"days": 0, "points": 0}
                day_cur = self._day_cur
                pending, self._pending = self._pending, {}
            max_day = max(pending)
            horizon = day_cur + self.max_pending_days
            if max_day > horizon:
                dropped = sum(len(p) for d, p in pending.items()
                              if d > horizon)
                self.logger.warning(
                    "dropping %d pending point(s) beyond the %d-day "
                    "horizon (max day %d, frontier %d)", dropped,
                    self.max_pending_days, max_day, day_cur)
                pending = {d: p for d, p in pending.items() if d <= horizon}
                if not pending:
                    return {"days": 0, "points": 0}
                max_day = max(pending)
            k = max_day - day_cur
            n_points = sum(len(p) for p in pending.values())
            self._grow_history(max_day - self.day0 + 1)
            for day, points in pending.items():
                col = day - self.day0
                for sidx, yv in points.items():
                    self._y[sidx, col] = yv
                    self._mask[sidx, col] = 1.0
            with self._lock:
                self._day_cur = max_day
                self._applied_since_refit += n_points
            # params unchanged: days past t_fit_end serve as model-future
            # forecasts until the next tail refit swaps fresh params in
            self._fc.swap_state(day1=max_day)
            if self.metrics is not None:
                self.metrics.applied_points_total.inc(n_points)
            return {"days": k, "points": n_points}

    # -- background tail-window refit ----------------------------------------
    def refit_stages(self):
        """(prep, dispatch, complete) closures: a TAIL-WINDOW refit.

        prep re-plans the windows over the grown grid and snapshots ONLY
        the slices whose statistics are not cached (new prefix windows and
        the tail); dispatch computes those statistics (on the card on the
        scheduler's stream), combines them with the frozen prefix and
        finalizes tail-anchored params; complete freezes the new prefix
        statistics and swaps the params in.  Every refit is O(window_len)
        device work.
        """
        W = self._wcfg.window_len

        def prep():
            with self._lock:
                day_snap = self._day_cur
                t_len = day_snap - self.day0 + 1
                starts = plan_windows(t_len, W, self._wcfg.overlap)
                if self._late_points != self._late_seen:
                    # late points rewrote history inside some window; the
                    # cache cannot know which: recompute everything
                    self._frozen.clear()
                    self._late_seen = self._late_points
                missing = [s for s in starts[:-1] if s not in self._frozen]
                snap = {
                    s: (self._y[:, s:s + W].copy(),
                        self._mask[:, s:s + W].copy())
                    for s in missing + [starts[-1]]
                }
            return {"day_snap": day_snap, "starts": starts,
                    "missing": missing, "snap": snap,
                    "t0": time.monotonic()}

        def dispatch(prepared):
            dev = self.device
            starts = prepared["starts"]
            tail_start = starts[-1]
            # per-window statistics at the (S, W) shape, ONE call for every
            # window, cached or fresh, so a warm-cache refit and a
            # cold-cache refit are bitwise equal
            fresh = {}
            for s in prepared["missing"] + [tail_start]:
                ys, ms = prepared["snap"][s]
                fresh[s] = self._window_stats_one(to_device(ys, dev),
                                                  to_device(ms, dev))
            per_window = [fresh[s] if s in fresh else self._frozen[s]
                          for s in starts]
            # the flat series-major (S*K, ...) layout the combine expects:
            # window axis second, then flatten
            stats = {k: torch.stack([w[k] for w in per_window], dim=1)
                     .reshape((self.n_series * len(starts),)
                              + tuple(per_window[0][k].shape[1:]))
                     for k in per_window[0]}
            comb = combine_estimates(self.model, stats, len(starts))
            ys, ms = prepared["snap"][tail_start]
            day_tail = torch.arange(
                self.day0 + tail_start, self.day0 + tail_start + W,
                dtype=torch.int32, device=dev)
            params = self._refit_params(to_device(ys, dev),
                                        to_device(ms, dev), day_tail,
                                        comb["coef"], comb["mean"])
            return {**prepared, "params": params,
                    "fresh": {s: fresh[s] for s in prepared["missing"]}}

        def complete(state):
            with self._apply_gate:
                self._install_tail_refit(state)
            return {"day_snap": state["day_snap"],
                    "tail_start": state["starts"][-1]}

        return prep, dispatch, complete

    def _window_stats_one(self, ys, ms):
        """One window's statistics at the (S, W) shape (a method, so that
        a test can count the calls)."""
        return _window_fit(self.model, self.config, ys, ms)

    def _refit_params(self, ys, ms, day_tail, coef, mean):
        """The tail-anchored params at the AOT entry
        ``windowed_refit:<model>``."""
        entry = f"windowed_refit:{self.model}"
        with get_tracer().span("windowed.refit", model=self.model,
                               series=int(ys.shape[0])):
            with device_annotation(entry):
                return aot_call(entry, _tail_params,
                                args=(ys, ms, day_tail, coef, mean),
                                static_kwargs={"config": self.config})

    def _install_tail_refit(self, state) -> None:
        """Freeze-and-swap, under ``_apply_gate`` (the caller holds it)."""
        params = state["params"]
        if self.device.type == "cuda":
            # the refit ran on the scheduler's stream; from here the
            # default stream reads these tensors
            reader = torch.cuda.current_stream(self.device)
            for f in dataclasses.fields(params):
                getattr(params, f.name).record_stream(reader)
        w_fit = int(params.fitted.shape[1])
        params = dataclasses.replace(params, fitted=_pad_time(
            params.fitted, time_cap(w_fit, self.time_bucket)))
        with get_tracer().span("refit.swap", model=self.model,
                               day_snap=int(state["day_snap"]),
                               tail_window=True):
            with self._lock:
                self._frozen.update(state["fresh"])
                day_now = self._day_cur
                self._params = params
                self._applied_since_refit = 0
                self._last_refit_monotonic = time.monotonic()
            self._fc.swap_state(params=params, day1=day_now)
        if self.metrics is not None:
            self.metrics.refits_total.inc()
            if getattr(self.metrics, "tail_window_refits_total",
                       None) is not None:
                self.metrics.tail_window_refits_total.inc()
            self.metrics.refit_seconds.observe(
                time.monotonic() - state["t0"])
        self.logger.info(
            "tail-window refit installed through day %d "
            "(window start %d, %d frozen window(s) cached)",
            int(state["day_snap"]), state["starts"][-1], len(self._frozen))
