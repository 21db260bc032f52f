"""Port parity: the arima family (Hannan-Rissanen fit, the Kalman pass and
its d = 1 integration, forecast, quantiles, CV, ``kalman='pscan'``, the
windowed-path statistics) against the JAX reference, its plain twins
against the reference's scans, and weights carried across with ``convert``.

Tolerances and why:
- coefficients (phi, theta) within 1e-4: the HR estimate is two float32
  solves (the Yule-Walker Toeplitz system and the ridge regression) whose
  Gram sums run in another order than XLA's and whose products XLA
  contracts into FMAs; their ~1e-5 relative change is what the rest
  carries;
- sigma2 within 1e-3 relative; states, the fitted path and its variance and
  the forecast within 1e-3 of each output's scale: the Kalman pass carries
  the coefficients' change through T = 400 steps (fits near the PACF clip at
  0.97 move most).  The port's twin itself is the reference's arithmetic
  (its structured products are the dense products' non-zero terms): on the
  reference's own coefficients it agrees within 1e-5 of scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import arima as ja
from distributed_forecasting_tpu.models import base as jbase
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu_torch import convert
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.models import arima as ta
from distributed_forecasting_tpu_torch.models import base as tbase
from distributed_forecasting_tpu_torch.ops import kalman as tk
from distributed_forecasting_tpu_torch.serving import predictor as tpred

torch.set_num_threads(1)

COEF_ATOL = 1e-4
REL = 1e-3

CONFIGS = {
    "211": dict(p=2, d=1, q=1),
    "102": dict(p=1, d=0, q=2),
    "seasonal_111_101_7": dict(p=1, d=1, q=1, P=1, Q=1, m=7),
}


def _series(S=8, T=400, seed=0):
    """Trending weekly-seasonal unit sales with AR(1) noise, 5% of cells
    missing, a leading masked stretch (row 0) and a trailing one (row 1)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    e = np.zeros((S, T))
    for i in range(1, T):
        e[:, i] = 0.6 * e[:, i - 1] + rng.normal(0, 3, S)
    y = np.round(60 + rng.uniform(-0.02, 0.05, (S, 1)) * t
                 + rng.uniform(2, 8, (S, 1)) * np.sin(2 * np.pi * t / 7)[None]
                 + e)
    mask = (rng.random((S, T)) >= 0.05).astype(np.float32)
    mask[0, :25] = 0
    mask[1, -15:] = 0
    day = np.arange(16_000, 16_000 + T, dtype=np.int32)
    return (y * mask).astype(np.float32), mask, day


def _fit_both(y, mask, day, **cfg):
    jp = ja.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                ja.ArimaConfig(**cfg))
    tp = ta.fit(torch.from_numpy(y), torch.from_numpy(mask),
                torch.from_numpy(day), ta.ArimaConfig(**cfg))
    return jp, tp


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def fits():
    y, mask, day = _series()
    return (y, mask, day), {name: _fit_both(y, mask, day, **cfg)
                            for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_matches_reference(fits, name):
    _, out = fits
    jp, tp = out[name]
    for f in ("phi", "theta"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=0,
                                   atol=COEF_ATOL, err_msg=f)
    np.testing.assert_allclose(tp.sigma2.numpy(), np.asarray(jp.sigma2),
                               rtol=REL)
    for f in ("mean", "a_last", "P_last", "level_end", "var_end", "fitted",
              "fitted_var", "day0", "t_fit_end"):
        _close(getattr(tp, f).numpy(), getattr(jp, f), f)
    assert all(torch.isfinite(getattr(tp, f.name)).all()
               for f in dataclasses.fields(tp))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forecast_and_quantiles_match_reference(fits, name):
    (y, _, day), out = fits
    jp, tp = out[name]
    cfg = CONFIGS[name]
    day_all = np.arange(day[0], day[-1] + 31, dtype=np.int32)
    want = ja.forecast(jp, jnp.asarray(day_all), jnp.float32(day[-1]),
                       ja.ArimaConfig(**cfg))
    got = ta.forecast(tp, torch.from_numpy(day_all), float(day[-1]),
                      ta.ArimaConfig(**cfg))
    for what, g, w in zip(("yhat", "lo", "hi"), got, want):
        _close(g.numpy(), w, what)
    q = (0.05, 0.5, 0.9)
    jq = jbase.MODEL_REGISTRY["arima"].forecast_quantiles(
        jp, jnp.asarray(day_all), jnp.float32(day[-1]),
        ja.ArimaConfig(**cfg), quantiles=q)
    tq = tbase.MODEL_REGISTRY["arima"].forecast_quantiles(
        tp, torch.from_numpy(day_all), float(day[-1]), ta.ArimaConfig(**cfg),
        quantiles=q)
    _close(tq.numpy(), jq, "quantiles")
    # a future-only grid (shorter than the fit grid) reads the same path
    fut = day_all[-30:]
    short = ta.forecast(tp, torch.from_numpy(fut), float(day[-1]),
                        ta.ArimaConfig(**cfg))
    for g, s in zip(got, short):
        torch.testing.assert_close(s, g[:, -30:], rtol=1e-6, atol=1e-4)


def test_kernel_twins_are_the_reference_scans():
    """On the reference's own coefficients the port's plain twins are its
    scans: the Kalman pass (``_kalman_loglik_impl``), the d = 1 integration
    (seeded at each row's first observed value: row 0's leading masked
    stretch) and the forecast recursion."""
    y, mask, day = _series(S=4, T=300, seed=3)
    jp = ja.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                ja.ArimaConfig())
    phi, theta = np.asarray(jp.phi), np.asarray(jp.theta)
    zc, zmask, mean = ta._centered(torch.from_numpy(y), torch.from_numpy(mask),
                                   1)
    r = ta._effective_r(ta.ArimaConfig())
    want = jax.jit(jax.vmap(
        lambda z, m, p, t: ja._kalman_loglik(z, m, p, t, r)))(
        jnp.asarray(zc.numpy()), jnp.asarray(zmask.numpy()),
        jnp.asarray(phi), jnp.asarray(theta))
    got = tk.arima_filter(zc, zmask, torch.from_numpy(y),
                          torch.from_numpy(mask), torch.from_numpy(phi),
                          torch.from_numpy(theta), mean, r, 1)
    # on the CPU the wrapper is the twin
    twin = tk.arima_filter_reference(
        zc, zmask, torch.from_numpy(y), torch.from_numpy(mask),
        torch.from_numpy(phi), torch.from_numpy(theta), mean, r, 1)
    assert all(torch.equal(g, w) for g, w in zip(got, twin))
    for what, g, w in zip(("ssq", "ldet", "n", "preds", "Fs", "a_T", "P_T"),
                          got, want):
        _close(g.numpy(), w, what, rel=1e-5)
    assert float(mask[0, :25].sum()) == 0
    first = y[0, 25:][mask[0, 25:] > 0][0]
    assert float(tk.first_observed(torch.from_numpy(y),
                                   torch.from_numpy(mask))[0]) == first
    np.testing.assert_allclose(
        float(got.fitted[0, 0]), first + float(got.preds[0, 0] + mean[0]),
        rtol=1e-6)
    for what, g, w in zip(("fitted", "fitted_var", "level_end", "var_end"),
                          got[7:], (jp.fitted, jp.fitted_var, jp.level_end,
                                    jp.var_end)):
        _close(g.numpy(), w, what, rel=1e-5)
    # the forecast recursion from the reference's final state
    zf, vf = tk.arima_predict(torch.from_numpy(phi), torch.from_numpy(theta),
                              torch.from_numpy(np.asarray(jp.a_last)),
                              torch.from_numpy(np.asarray(jp.P_last)),
                              torch.from_numpy(np.asarray(jp.sigma2)), r, 40)
    assert tuple(zf.shape) == tuple(vf.shape) == (4, 40)
    params = convert.arima_params_from_numpy(
        {f.name: np.asarray(getattr(jp, f.name))
         for f in dataclasses.fields(jp)}, device="cpu")
    day_all = np.arange(day[0], day[-1] + 40, dtype=np.int32)
    got_fc = ta.forecast(params, torch.from_numpy(day_all), None,
                         ta.ArimaConfig())
    want_fc = ja.forecast(jp, jnp.asarray(day_all), None, ja.ArimaConfig())
    for what, g, w in zip(("yhat", "lo", "hi"), got_fc, want_fc):
        _close(g.numpy(), w, what, rel=1e-5)


def test_pscan_kalman_equals_scan():
    """``kalman='pscan'`` is the same fit within float tolerance (the
    reference's own bounds between its two filters)."""
    y, mask, day = _series(S=4, T=300, seed=2)
    t = [torch.from_numpy(a) for a in (y, mask, day)]
    for d in (0, 1):
        p1 = ta.fit(*t, ta.ArimaConfig(d=d, kalman="scan"))
        p2 = ta.fit(*t, ta.ArimaConfig(d=d, kalman="pscan"))
        assert torch.equal(p1.phi, p2.phi) and torch.equal(p1.theta, p2.theta)
        np.testing.assert_allclose(p2.sigma2.numpy(), p1.sigma2.numpy(),
                                   rtol=1e-3)
        np.testing.assert_allclose(p2.fitted.numpy(), p1.fitted.numpy(),
                                   rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(p2.fitted_var.numpy(),
                                   p1.fitted_var.numpy(), rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(p2.a_last.numpy(), p1.a_last.numpy(),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(p2.level_end.numpy(),
                                   p1.level_end.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="kalman"):
        ta.fit(*t, ta.ArimaConfig(kalman="bogus"))


def test_cv_matches_reference():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=360,
                                          seed=4, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    jb, tb = jdata.tensorize(df), tdata.tensorize(df, device="cpu")
    cv = dict(initial=200, period=60, horizon=30)
    want = jcv.cross_validate(jb, model="arima", cv=jcv.CVConfig(**cv))
    got = tcv.cross_validate(tb, model="arima", cv=tcv.CVConfig(**cv))
    assert got["_n_cutoffs"] == want["_n_cutoffs"] == 3
    for k in ("mse", "rmse", "mae", "mape", "smape", "mdape", "coverage",
              "mase"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=REL, err_msg=k)


def test_window_stats_and_params_from_estimates_match_reference():
    y, mask, day = _series(S=6, T=200, seed=4)
    cfg = dict(p=2, d=1, q=1)
    want = ja.window_stats(jnp.asarray(y), jnp.asarray(mask),
                           ja.ArimaConfig(**cfg))
    got = ta.window_stats(torch.from_numpy(y), torch.from_numpy(mask),
                          ta.ArimaConfig(**cfg))
    assert set(got) == set(want)
    for k in ("coef", "n_valid", "mean", "n_obs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=COEF_ATOL, err_msg=k)
    for k in ("gram", "sigma2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=REL, err_msg=k)
    phi = np.full((6, 2), 0.3, np.float32)
    theta = np.full((6, 1), -0.2, np.float32)
    mean = np.asarray(want["mean"])
    jp = ja.params_from_estimates(
        jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
        ja.ArimaConfig(**cfg), jnp.asarray(phi), jnp.asarray(theta),
        jnp.asarray(mean))
    tp = ta.params_from_estimates(
        torch.from_numpy(y), torch.from_numpy(mask), torch.from_numpy(day),
        ta.ArimaConfig(**cfg), torch.from_numpy(phi), torch.from_numpy(theta),
        torch.from_numpy(mean))
    for f in ("sigma2", "a_last", "P_last", "fitted", "fitted_var",
              "level_end", "var_end"):
        _close(getattr(tp, f).numpy(), getattr(jp, f), f, rel=1e-5)
    with pytest.raises(ValueError, match="method='hr'"):
        ta.window_stats(torch.from_numpy(y), torch.from_numpy(mask),
                        ta.ArimaConfig(method="mle"))


def test_pacf_maps_match_reference():
    """The stationarity maps, batched over rows: Durbin-Levinson both ways,
    the Monahan map and the PACF-clip projection (boundary and exterior
    coefficients included)."""
    rng = np.random.default_rng(6)
    u = rng.normal(size=(12, 4)).astype(np.float32)
    c = (rng.normal(size=(12, 4)) * 0.8).astype(np.float32)
    for name in ("_pacf_to_coef", "_coef_to_pacf", "_stabilize"):
        x = u if name == "_pacf_to_coef" else c
        got = getattr(ta, name)(torch.from_numpy(x)).numpy()
        want = np.stack([np.asarray(getattr(ja, name)(jnp.asarray(row)))
                         for row in x])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    back = ta._coef_to_pacf(ta._pacf_to_coef(torch.from_numpy(u)))
    np.testing.assert_allclose(back.numpy(), np.tanh(u), rtol=1e-4,
                               atol=1e-5)


def test_unported_and_invalid_options_raise():
    """Every option of the reference runs (``method='mle'`` since slice 14:
    finite coefficients inside the stationary region, ``tests/
    test_torch_arima_mle.py`` holds it to the reference); invalid ones raise
    the reference's errors."""
    y, mask, day = (torch.from_numpy(a) for a in _series(S=2, T=60))
    mle = ta.fit(y, mask, day, ta.ArimaConfig(method="mle", fit_steps=3))
    assert torch.isfinite(mle.phi).all() and torch.isfinite(mle.fitted).all()
    assert (ta._coef_to_pacf(mle.phi).abs() < 1).all()
    with pytest.raises(ValueError, match="unknown ARIMA fit method"):
        ta.fit(y, mask, day, ta.ArimaConfig(method="newton"))
    with pytest.raises(ValueError, match="m >= 1"):
        ta.fit(y, mask, day, ta.ArimaConfig(P=1, m=0))


def test_weights_cross_with_convert(fits):
    _, out = fits
    jp, tp = out["211"]
    fields = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    back = convert.arima_params_from_numpy(fields, device="cpu")
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(back, k).numpy(), v)
    assert set(convert.arima_params_to_numpy(tp)) == set(fields)
    assert convert.params_type_name(tp) == (
        "distributed_forecasting_tpu.models.arima:ArimaParams")


@pytest.fixture(scope="module")
def sales():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=300,
                                          seed=6, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    return df


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_artifact_written_by_one_package_serves_in_the_other(sales, tmp_path,
                                                             writer):
    """The serving grid (history + horizon) is longer than the fit grid: the
    forecast runs horizon + 1 predict steps from the final state."""
    cfg_kw = dict(p=1, d=1, q=1, interval_width=0.9)
    if writer == "port":
        b = tdata.tensorize(sales, device="cpu")
        cfg = ta.ArimaConfig(**cfg_kw)
        params, _ = tfit.fit_forecast(b, "arima", config=cfg, horizon=14)
        tpred.BatchForecaster.from_fit(b, params, "arima", cfg).save(
            str(tmp_path))
    else:
        b = jdata.tensorize(sales)
        cfg = ja.ArimaConfig(**cfg_kw)
        params, _ = jfit.fit_forecast(b, model="arima", config=cfg,
                                      horizon=14)
        jpred.BatchForecaster.from_fit(b, params, "arima", cfg).save(
            str(tmp_path))
    got = tpred.BatchForecaster.load(str(tmp_path), device="cpu")
    want = jpred.BatchForecaster.load(str(tmp_path))
    assert got.config == ta.ArimaConfig(**cfg_kw)
    request = pd.DataFrame({"store": [2, 1, 2], "item": [3, 1, 1]})
    for horizon, hist in ((14, True), (400, False)):
        g = got.predict(request, horizon=horizon, include_history=hist)
        w = want.predict(request, horizon=horizon, include_history=hist)
        assert list(g.columns) == list(w.columns)
        for col in ("yhat", "yhat_upper", "yhat_lower"):
            _close(g[col].to_numpy(), w[col].to_numpy(), col)
    q = (0.1, 0.9)
    g = got.predict_quantiles(request, quantiles=q, horizon=14)
    w = want.predict_quantiles(request, quantiles=q, horizon=14)
    for col in ("q0.1", "q0.9"):
        _close(g[col].to_numpy(), w[col].to_numpy(), col)


def test_serving_horizon_longer_than_training_is_not_flat():
    """A future-only request past the fit grid's length keeps moving and
    widening (reference tests/unit/test_pkalman.py:121)."""
    df = tdata.synthetic_store_item_sales(n_stores=1, n_items=3, n_days=40,
                                          seed=5)
    b = tdata.tensorize(df, device="cpu")
    cfg = ta.ArimaConfig(hr_ar_order=10)
    params, _ = tfit.fit_forecast(b, "arima", config=cfg, horizon=5,
                                  min_points=5)
    bf = tpred.BatchForecaster.from_fit(b, params, "arima", cfg)
    out = bf.predict(pd.DataFrame({"store": [1], "item": [1]}), horizon=80)
    assert len(out) == 80
    width = (out.yhat_upper - out.yhat_lower).to_numpy()
    assert width[79] > width[45] > width[10]
    assert np.ptp(out.yhat.to_numpy()[45:]) > 0.0
