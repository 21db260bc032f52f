"""Port parity: windowed (DARIMA split-and-combine) arima fitting —
``ops/combine`` and ``engine/windowed`` — against the JAX reference on the
CPU, and the reference's own contracts (``tests/unit/test_windowed.py``)
held by the port: plan exactness, config errors, the threshold, the WLS
combine against the whole-series fit, horizon parity, the predictor route,
auto-activation and the CV refusal, and the streaming tail refit (warm
equal to cold bit for bit, a late point recomputing every window).

Inputs are AR(2) + level series made with numpy from a seed, as the
reference's ``_ar2_batch`` makes them.  Tolerances and why:

- ``wls_combine`` against the reference's on the same statistics: within
  1e-5 relative.  The precision sums and the (S, F, F) solve are float32;
  the port's CPU solve is a pivoted LU twin, the reference's XLA's LU, and
  the sums run in another order.
- ``windowed_fit_forecast`` against the reference's (W 512, overlap 64,
  T 3,000): coefficients within 1e-4 and every other output within 1e-4
  of its scale.  The window statistics are the HR estimate's float32 Grams
  and Yule-Walker solves, summed in another order than XLA sums them and
  without its fused multiply-adds (``test_torch_arima.py``; ROADMAP Queue
  3); the Kalman pass carries their ~1e-6 relative change through the
  tail window.  Measured here: ~3e-6.
- the reference's statistical contracts at its own shape (S 3, T 20,000,
  W 4,096, overlap 128): the combined coefficients within 0.02 of the
  whole-series HR fit, the mean within 0.05, the horizon within 10% of its
  RMS level (``PARITY_REL_TOL``, ``docs/windowed.md``).
- the streaming refit, warm cache against cold: bitwise (the same calls at
  the (S, W) shape over the same slices).

The reference's 8-way mesh case runs over three ranks in
``test_torch_parallel.py``; here a one-rank mesh is the unsharded fit bit
for bit.  Its 10^6-period case runs on the card (``chip_smoke.py`` phase
17).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu.data.tensorize import SeriesBatch as JBatch
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.engine import windowed as jwin
from distributed_forecasting_tpu.models.arima import ArimaConfig as JArimaConfig
from distributed_forecasting_tpu.models.arima import ArimaParams as JArimaParams
from distributed_forecasting_tpu.ops import combine as jcomb
from distributed_forecasting_tpu.serving import BatchForecaster as JForecaster
from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine import (
    WindowedSeriesStateStore,
    configure_windowed,
    cross_validate,
    fit_forecast,
    forecast_frame,
    plan_windows,
    should_window,
    windowed_config,
    windowed_fit_forecast,
)
from distributed_forecasting_tpu_torch.engine.windowed import WindowedConfig
from distributed_forecasting_tpu_torch.models.arima import ArimaConfig
from distributed_forecasting_tpu_torch.monitoring import IngestMetrics
from distributed_forecasting_tpu_torch.ops import combine as tcomb
from distributed_forecasting_tpu_torch.serving import BatchForecaster
from distributed_forecasting_tpu_torch.serving.refit import (
    RefitConfig,
    RefitScheduler,
)

torch.set_num_threads(1)

PARITY_REL_TOL = 0.10
COEF_ATOL = 1e-4
REL = 1e-4
COMBINE_RTOL = 1e-5
SMALL = WindowedConfig(enabled=True, window_len=512, overlap=64,
                       min_windows=2)


def _ar2(S, T, seed, level=10.0):
    """(S, T) float32 AR(2) + level, the reference's ``_ar2_batch``."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, 1.0, (S, T))
    y = np.zeros((S, T))
    for t in range(2, T):
        y[:, t] = 0.55 * y[:, t - 1] + 0.20 * y[:, t - 2] + eps[:, t]
    return (y + level).astype(np.float32)


def _batch(y):
    S, T = y.shape
    return SeriesBatch(
        y=torch.from_numpy(y), mask=torch.ones(S, T),
        day=torch.arange(T, dtype=torch.int32),
        keys=np.arange(S)[:, None], key_names=("series",),
        start_date="1970-01-01")


def _jbatch(y):
    S, T = y.shape
    return JBatch(
        y=jnp.asarray(y), mask=jnp.ones((S, T), jnp.float32),
        day=jnp.arange(T, dtype=jnp.int32),
        keys=jnp.arange(S, dtype=jnp.int32)[:, None], key_names=("series",),
        start_date="1970-01-01")


def _close_to_scale(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


# -- window plan and config ---------------------------------------------------

@pytest.mark.parametrize("T,W,overlap", [
    (20_000, 4096, 128),
    (8192, 8192, 256),      # exactly one window
    (10_000, 4096, 0),      # no overlap, remainder tail
    (12_289, 4096, 1024),   # T = k*stride + 1: minimal tail advance
])
def test_plan_windows_match_reference(T, W, overlap):
    starts = plan_windows(T, W, overlap)
    assert starts == jwin.plan_windows(T, W, overlap)
    stride = W - overlap
    assert starts[0] == 0 and starts[-1] == T - W   # tail RIGHT-ALIGNED
    gaps = np.diff(starts)
    if len(gaps) > 1:
        assert (gaps[:-1] == stride).all()
    assert (gaps > 0).all() and (gaps <= stride).all()
    covered = np.zeros(T, bool)
    for s in starts:
        covered[s:s + W] = True
    assert covered.all()


def test_config_and_plan_errors_match_reference():
    for mod in (jwin, None):
        cls = mod.WindowedConfig if mod else WindowedConfig
        plan = mod.plan_windows if mod else plan_windows
        with pytest.raises(ValueError, match="below window_len"):
            plan(100, 8192, 256)
        with pytest.raises(ValueError, match="unknown engine.windowed"):
            cls.from_conf({"windw_len": 4096})
        with pytest.raises(ValueError, match="overlap"):
            cls(window_len=512, overlap=512)
        with pytest.raises(ValueError, match="min_windows"):
            cls(min_windows=1)
        cfg = cls.from_conf({"enabled": True, "window_len": 4096,
                             "overlap": 128})
        assert cfg.enabled and cfg.stride == 3968
        assert cfg.auto_threshold == 4096 * cfg.min_windows
    batch = _batch(_ar2(1, 600, 0))
    with pytest.raises(ValueError, match="model='arima' only"):
        windowed_fit_forecast(batch, model="theta", wconfig=SMALL)
    with pytest.raises(ValueError, match="method='hr'"):
        windowed_fit_forecast(batch, config=ArimaConfig(method="mle"),
                              wconfig=SMALL)
    with pytest.raises(ValueError, match="too short for the HR long-AR"):
        windowed_fit_forecast(batch, config=ArimaConfig(hr_ar_order=200),
                              wconfig=SMALL)
    # the mesh path is ported: on a one-rank mesh (a gloo group over an
    # in-process store) it is the unsharded fit bit for bit, whole
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.parallel import mesh as tmesh

    joined = not dist.is_initialized()
    try:
        p1, r1 = windowed_fit_forecast(batch, wconfig=SMALL,
                                       mesh=tmesh.make_mesh(device="cpu"))
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
            tmesh._RANK_DEVICE = None
    p0, r0 = windowed_fit_forecast(batch, wconfig=SMALL)
    for f in dataclasses.fields(p0):
        assert torch.equal(getattr(p1, f.name), getattr(p0, f.name)), f.name
    for k in ("yhat", "lo", "hi", "ok", "day_all"):
        assert torch.equal(getattr(r1, k), getattr(r0, k)), k


def test_should_window_threshold():
    off = WindowedConfig(enabled=False)
    on = WindowedConfig(enabled=True, window_len=512, overlap=64,
                        min_windows=4)
    for fn in (should_window, jwin.should_window):
        cfg_off = off if fn is should_window else jwin.WindowedConfig()
        cfg_on = on if fn is should_window else jwin.WindowedConfig(
            enabled=True, window_len=512, overlap=64, min_windows=4)
        assert not fn(10 ** 6, cfg_off)
        assert fn(2048, cfg_on)
        assert not fn(2047, cfg_on)


# -- the WLS combine ------------------------------------------------------------

def _stats(S, K, F, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S * K, 64, F)).astype(np.float32)
    gram = np.einsum("btf,btg->bfg", X, X) + 0.1 * np.eye(F, dtype=np.float32)
    return {"coef": rng.normal(0.3, 0.2, (S * K, F)).astype(np.float32),
            "gram": gram.astype(np.float32),
            "n_valid": rng.integers(400, 512, S * K).astype(np.float32),
            "sigma2": rng.uniform(0.5, 2.0, S * K).astype(np.float32),
            "mean": rng.normal(0.0, 0.1, S * K).astype(np.float32),
            "n_obs": rng.integers(450, 512, S * K).astype(np.float32)}


@pytest.mark.parametrize("F", [3, 0])
def test_wls_combine_matches_reference(F):
    S, K = 5, 7
    stats = _stats(S, K, F, seed=F)
    want = jcomb.wls_combine({k: jnp.asarray(v) for k, v in stats.items()},
                             n_windows=K)
    got = tcomb.combine_estimates(
        "arima", {k: torch.from_numpy(v) for k, v in stats.items()}, K)
    for k in ("coef", "mean", "sigma2"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=COMBINE_RTOL, atol=1e-7, err_msg=k)
    with pytest.raises(ValueError, match="not a multiple of n_windows=4"):
        tcomb.wls_combine({k: torch.from_numpy(v) for k, v in stats.items()},
                          4)


# -- windowed_fit_forecast against the reference ------------------------------

@pytest.fixture(scope="module")
def small():
    """The port's and the reference's windowed fit of one AR(2) batch (W
    512, overlap 64, T 3,000, horizon 28)."""
    y = _ar2(3, 3000, seed=0)
    got = windowed_fit_forecast(_batch(y), horizon=28, wconfig=SMALL)
    want = jwin.windowed_fit_forecast(
        _jbatch(y), horizon=28, key=jax.random.PRNGKey(0),
        wconfig=jwin.WindowedConfig(enabled=True, window_len=512, overlap=64,
                                    min_windows=2))
    return y, got, want


def test_windowed_fit_forecast_matches_reference(small):
    _, (got_p, got), (want_p, want) = small
    for f in dataclasses.fields(got_p):
        g, w = getattr(got_p, f.name), np.asarray(getattr(want_p, f.name))
        if f.name in ("phi", "theta"):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=COEF_ATOL,
                                       err_msg=f.name)
        else:
            _close_to_scale(g.numpy(), w, REL, f.name)
    for k in ("yhat", "lo", "hi"):
        _close_to_scale(getattr(got, k).numpy(), getattr(want, k), REL, k)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_array_equal(got.day_all.numpy(),
                                  np.asarray(want.day_all))
    assert got.day_all.dtype == torch.int32
    assert got.day_all.shape[0] == 512 + 28
    assert float(got_p.day0) == 3000 - 512 and float(got_p.t_fit_end) == 2999


def test_forecast_frame_covers_the_tail_window(small):
    """The frame of a windowed result covers its grid, tail window +
    horizon, with the history's values on it.  The reference's
    ``forecast_frame`` raises on such a result (a pinned difference,
    ROADMAP Queue 3)."""
    y, (_, res), (_, jres) = small
    df = forecast_frame(_batch(y), res, training_date="2020-01-01")
    assert len(df) == 3 * (512 + 28)
    rows = df[df["series"] == 1]
    np.testing.assert_array_equal(rows["y"].to_numpy()[:512], y[1, -512:])
    assert rows["y"].isna().sum() == 28
    np.testing.assert_array_equal(rows["yhat"].to_numpy(),
                                  res.yhat[1].numpy())
    assert rows["ds"].iloc[0] == pd.Timestamp("1970-01-01") + pd.Timedelta(
        days=3000 - 512)
    with pytest.raises(ValueError, match="could not broadcast"):
        jfit.forecast_frame(_jbatch(y), jres)


# -- the reference's statistical contracts, held by the port ------------------

WIDE = WindowedConfig(enabled=True, window_len=4096, overlap=128)


@pytest.fixture(scope="module")
def fits():
    batch = _batch(_ar2(3, 20_000, seed=0))
    wcfg = WIDE
    seq_p, seq_r = fit_forecast(batch, model="arima", horizon=28)
    win_p, win_r = windowed_fit_forecast(batch, horizon=28, wconfig=wcfg)
    return batch, seq_p, seq_r, win_p, win_r


def test_combine_matches_whole_series_coefficients():
    # the well-identified pure-AR config, as in the reference: the default
    # (2, 1, 1) over-differences an AR(2) + level series into a near
    # phi-theta cancellation (its forecasts are held below)
    batch = _batch(_ar2(3, 20_000, seed=0))
    cfg = ArimaConfig(p=2, d=0, q=0)
    seq_p, _ = fit_forecast(batch, model="arima", config=cfg, horizon=28)
    win_p, _ = windowed_fit_forecast(batch, config=cfg, horizon=28,
                                     wconfig=WIDE)
    assert float((seq_p.phi - win_p.phi).abs().max()) < 0.02
    assert float((seq_p.mean - win_p.mean).abs().max()) < 0.05


def test_forecast_parity_within_documented_tolerance(fits):
    _, _, seq_r, _, win_r = fits
    H = 28
    assert bool(seq_r.ok.all()) and bool(win_r.ok.all())
    assert int(seq_r.day_all[-1]) == int(win_r.day_all[-1])
    assert win_r.day_all.shape[0] == 4096 + H
    seq_h = seq_r.yhat[:, -H:].double().numpy()
    win_h = win_r.yhat[:, -H:].double().numpy()
    rel = np.max(np.abs(seq_h - win_h)) / np.sqrt(np.mean(seq_h ** 2))
    assert rel < PARITY_REL_TOL


def test_windowed_params_route_through_predictor(fits):
    batch, _, _, win_p, win_r = fits
    T = batch.n_time
    fc = BatchForecaster("arima", ArimaConfig(), win_p, batch.keys,
                         batch.key_names, day0=T - 4096, day1=T - 1)
    out = fc.predict(pd.DataFrame({"series": [0, 1, 2]}), horizon=7)
    assert len(out) == 3 * 7
    for s in range(3):
        got = out[out["series"] == s]["yhat"].to_numpy()
        np.testing.assert_allclose(got, win_r.yhat[s, 4096:4096 + 7].numpy(),
                                   rtol=1e-4)
    # the reference's predictor on the same params serves the same rows
    jparams = JArimaParams(**{f.name: jnp.asarray(getattr(win_p, f.name)
                                                  .numpy())
                              for f in dataclasses.fields(win_p)})
    jfc = JForecaster("arima", JArimaConfig(), jparams, batch.keys,
                      batch.key_names, day0=T - 4096, day1=T - 1)
    want = jfc.predict(pd.DataFrame({"series": [0, 1, 2]}), horizon=7)
    _close_to_scale(out["yhat"].to_numpy(), want["yhat"].to_numpy(), 1e-5,
                    "yhat")


def test_auto_activation_routes_to_windowed():
    batch = _batch(_ar2(2, 4096, seed=1))
    configure_windowed({"enabled": True, "window_len": 512, "overlap": 64,
                        "min_windows": 4})
    try:
        assert windowed_config().auto_threshold == 2048
        _, res = fit_forecast(batch, model="arima", horizon=14)
        assert res.day_all.shape[0] == 512 + 14
        with pytest.raises(ValueError, match="windowed"):
            cross_validate(batch, model="arima")
        # a shorter history keeps the sequential path
        short = dataclasses.replace(batch, y=batch.y[:, :2047],
                                    mask=batch.mask[:, :2047],
                                    day=batch.day[:2047])
        _, res = fit_forecast(short, model="arima", horizon=14)
        assert res.day_all.shape[0] == 2047 + 14
    finally:
        configure_windowed(WindowedConfig())


# -- streaming: the tail-window refit -----------------------------------------

def _store(y, metrics=None):
    batch = _batch(y)
    params, _ = windowed_fit_forecast(batch, horizon=14, wconfig=SMALL)
    T = batch.n_time
    fc = BatchForecaster("arima", ArimaConfig(), params, batch.keys,
                         batch.key_names, day0=T - SMALL.window_len,
                         day1=T - 1)
    return WindowedSeriesStateStore(fc, y, np.ones_like(y), history_day0=0,
                                    wconfig=SMALL, metrics=metrics,
                                    device="cpu")


def _refit(store):
    """One forced refit through the scheduler, as serving drives it."""
    sched = RefitScheduler(store, RefitConfig())
    try:
        assert sched.maybe_refit(force=True) == "forced"
        return sched.wait(timeout=60)
    finally:
        sched.stop()


def _count_stats_calls(monkeypatch):
    calls = []
    orig = WindowedSeriesStateStore._window_stats_one
    monkeypatch.setattr(
        WindowedSeriesStateStore, "_window_stats_one",
        lambda self, ys, ms: calls.append(1) or orig(self, ys, ms))
    return calls


def test_streaming_tail_refit_bitwise_and_tail_only(monkeypatch):
    y = _ar2(2, 2000, seed=2)
    new_points = [(s, 2000 + d, 10.0 + 0.1 * s + 0.01 * d)
                  for s in range(2) for d in range(3)]

    # WARM store: refit once (freezes the prefix), ingest, refit again
    metrics = IngestMetrics()
    warm = _store(y, metrics=metrics)
    assert _refit(warm) == {"day_snap": 1999, "tail_start": 2000 - 512}
    assert len(warm._frozen) == len(plan_windows(2000, 512, 64)) - 1
    warm.ingest(new_points)
    assert warm.apply_pending() == {"days": 3, "points": 6}
    calls = _count_stats_calls(monkeypatch)
    assert _refit(warm)["tail_start"] == 2003 - 512
    monkeypatch.undo()
    # only the tail window was recomputed (3 new days open no regular
    # window at stride 448)
    assert len(calls) == 1
    assert metrics.refits_total.value == 2
    assert metrics.tail_window_refits_total.value == 2
    assert metrics.applied_points_total.value == len(new_points)
    assert warm.day_cur == 2002 and warm._fc.day1 == 2002

    # COLD store: the same history and points, a fresh statistics cache
    cold = _store(y)
    cold.ingest(new_points)
    cold.apply_pending()
    _refit(cold)
    for f in dataclasses.fields(warm._params):
        a, b = getattr(warm._params, f.name), getattr(cold._params, f.name)
        assert torch.equal(a, b), f.name

    # the refit equals a windowed fit of the extended history (held to
    # the reference's above)
    y_ext = np.concatenate([y, np.array([[10.0 + 0.1 * s + 0.01 * d
                                           for d in range(3)]
                                          for s in range(2)], np.float32)],
                           axis=1)
    fit_p, _ = windowed_fit_forecast(_batch(y_ext), horizon=14,
                                     wconfig=SMALL)
    for f in ("phi", "theta", "sigma2", "a_last", "P_last", "level_end"):
        torch.testing.assert_close(getattr(cold._params, f),
                                   getattr(fit_p, f), rtol=1e-5, atol=1e-6)


def test_streaming_late_point_invalidates_cache(monkeypatch):
    store = _store(_ar2(2, 2000, seed=4))
    _refit(store)
    # a late point inside a frozen prefix window rewrites history: the
    # next refit must recompute EVERY window, not serve stale statistics
    assert store.ingest([(0, 100, 42.0)]) == {"accepted": 0, "late": 1,
                                              "rejected": 0}
    calls = _count_stats_calls(monkeypatch)
    _refit(store)
    assert len(calls) == len(plan_windows(2000, 512, 64))
    calls.clear()
    _refit(store)  # and the cache holds again after it
    assert len(calls) == 1


# -- the train task -----------------------------------------------------------

def test_train_task_runs_windowed(tmp_path):
    """``engine.windowed`` armed, CV off: the train task routes the arima
    fit through the windowed path and writes its frame (tail window +
    horizon per series) and its artifact; the frame's forecast is the
    engine's windowed forecast of the same batch."""
    from distributed_forecasting_tpu_torch import tasks
    from distributed_forecasting_tpu_torch.data import tensorize
    from distributed_forecasting_tpu_torch.tracking import FileTracker

    root = str(tmp_path)
    tasks.IngestTask(init_conf={
        "env": {"root": root},
        "input": {"synthetic": {"n_stores": 1, "n_items": 2, "n_days": 2100}},
        "output": {"table": "hackathon.sales.raw"}}, device="cpu").launch()
    conf = {"env": {"root": root},
            "input": {"table": "hackathon.sales.raw"},
            "output": {"table": "hackathon.sales.finegrain_forecasts"},
            "training": {"model": "arima", "horizon": 30,
                         "run_cross_validation": False},
            "engine": {"windowed": {"enabled": True, "window_len": 512,
                                    "overlap": 64}}}
    try:
        task = tasks.TrainTask(init_conf=conf, device="cpu")
        out = task.launch()
        batch = tensorize(task.catalog.read_table("hackathon.sales.raw"),
                          device="cpu")
        params, res = fit_forecast(batch, model="arima", horizon=30)
    finally:
        configure_windowed(WindowedConfig())
    assert res.day_all.shape[0] == 512 + 30 and out["n_failed"] == 0
    df = task.catalog.read_table("hackathon.sales.finegrain_forecasts")
    assert len(df) == 2 * (512 + 30)
    np.testing.assert_array_equal(df["yhat"].to_numpy(),
                                  res.yhat.numpy().reshape(-1))
    run = FileTracker(str(tmp_path / "mlruns")).get_run(
        out["experiment_id"], out["run_id"])
    loaded = BatchForecaster.load(run.artifact_path("forecaster"),
                                  device="cpu")
    # the artifact is anchored as the reference's train task anchors it:
    # day0 at the history's first day, its params at the tail window
    assert (loaded.day0, loaded.day1) == (int(batch.day[0]),
                                          int(batch.day[-1]))
    assert float(loaded.params.day0) == float(params.day0)
    got = loaded.predict(pd.DataFrame({"store": [1], "item": [2]}),
                         horizon=30)
    _close_to_scale(got["yhat"].to_numpy(), res.yhat[1, 512:].numpy(), 1e-5,
                    "served yhat")
