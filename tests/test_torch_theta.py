"""Port parity: the theta family against the JAX reference — fit, forecast,
quantiles, the CV path, the serving artifact and weights carried across
with ``convert``.

Inputs are daily series with a weekly cycle, a trend and noise, made with
numpy from a seed, with randomly masked days, a series that starts late
(its SES level starts from its first seven *observed* days), a series with
one weekday always zero (its seasonal index falls back to 1 before the
renormalisation), an all-zero series and a fully masked one.

Tolerances:
  * values within rtol 1e-5 / atol 1e-5 of the data's scale: the SES step
    is the reference's expression, but XLA on the CPU contracts
    ``alpha*z + (1-alpha)*level`` into an FMA and torch does not, and the
    seasonal slot sums (a one-hot GEMM here, a reduction of a one-hot
    product there) and the trend's moments sum in another order: a few
    float32 roundings carried over T steps (measured under 6e-6 at a scale
    of ~25);
  * the alpha winner (the argmin over 7 float32 SSEs) by index wherever a
    series' best two SSEs differ by more than ``TIE_RTOL`` = 1e-4 relative
    (ten times the value tolerance); below it either winner is accepted,
    and that series' paths are not compared (another alpha is another
    path);
  * the winner's fitted path, gathered from the candidates' paths, equal
    bit for bit to a second SES run at the winning alpha (the reference's
    way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import theta as jth
from distributed_forecasting_tpu.models.base import get_model as jget_model
from distributed_forecasting_tpu.serving import predictor as jpred
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu_torch import convert
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.models import get_model
from distributed_forecasting_tpu_torch.models import theta as tth
from distributed_forecasting_tpu_torch.serving import predictor as tpred

torch.set_num_threads(1)

RTOL = 1e-5
TIE_RTOL = 1e-4
LATE, ZERO_SLOT, ALL_ZERO, ALL_MASKED = 1, 2, 3, 4


def _series(S=12, T=360, seed=0):
    rng = np.random.default_rng(seed)
    day = np.arange(17_000, 17_000 + T, dtype=np.int32)
    week = 1.0 + 0.3 * np.sin(2 * np.pi * (day % 7) / 7.0)
    base = rng.uniform(5, 30, size=(S, 1))
    drift = rng.uniform(-0.02, 0.05, size=(S, 1)) * np.arange(T)[None]
    y = (base + drift) * week[None] + rng.normal(0, 1.5, (S, T))
    y = np.maximum(y, 0.0)
    mask = (rng.random((S, T)) > 0.07).astype(np.float32)
    mask[LATE, :150] = 0.0              # starts late
    y[ZERO_SLOT, day % 7 == 3] = 0.0    # one weekday never sells
    y[ALL_ZERO] = 0.0
    mask[ALL_MASKED] = 0.0
    return (y * mask).astype(np.float32), mask, day


def _fit_both(y, mask, day, **cfg):
    jp = jth.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                 jth.ThetaConfig(**cfg))
    tp = tth.fit(torch.from_numpy(y), torch.from_numpy(mask),
                 torch.from_numpy(day), tth.ThetaConfig(**cfg))
    return jp, tp


def _candidate_sses(y, mask, day, cfg: tth.ThetaConfig) -> np.ndarray:
    """(S, A) masked SSE of every alpha candidate (the winner is their
    argmin)."""
    return tth.candidate_sses(*(torch.from_numpy(a) for a in (y, mask, day)),
                              cfg).numpy().astype(np.float64)


def _apart(sses: np.ndarray) -> np.ndarray:
    """(S,) True where the best two SSEs differ by more than TIE_RTOL."""
    s = np.sort(sses, axis=1)
    return (s[:, 1] - s[:, 0]) > TIE_RTOL * np.maximum(s[:, 0], 1e-30)


def _close(got, want, scale, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


CONFIGS = [dict(theta=2.0), dict(theta=2.0, deseasonalize=False),
           dict(theta=3.0), dict(theta=1.5, deseasonalize=False)]
IDS = ["th2", "th2_raw", "th3", "th1.5_raw"]


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_fit_matches_reference(cfg):
    y, mask, day = _series()
    jp, tp = _fit_both(y, mask, day, **cfg)
    apart = _apart(_candidate_sses(y, mask, day, tth.ThetaConfig(**cfg)))
    assert apart.sum() >= 8, apart
    np.testing.assert_array_equal(tp.alpha.numpy()[apart],
                                  np.asarray(jp.alpha)[apart])
    scale = float(np.abs(y).max())
    for f in ("intercept", "slope", "seas"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.shape == b.shape, f
        _close(b, a, max(scale, 1.0), f)
    for f in ("level", "sigma", "fitted"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), f
        _close(b[apart], a[apart], scale, f)
    for f in ("day0", "t_fit_end"):
        assert float(getattr(jp, f)) == float(getattr(tp, f))


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_forecast_and_quantiles_match_reference(cfg):
    y, mask, day = _series(seed=1)
    cfg = dict(cfg, interval_width=0.8)
    jp, tp = _fit_both(y, mask, day, **cfg)
    apart = _apart(_candidate_sses(y, mask, day, tth.ThetaConfig(**cfg)))
    day_all = np.arange(int(day[0]), int(day[-1]) + 31, dtype=np.int32)
    t_end = np.float32(day[-1])
    want = jth.forecast(jp, jnp.asarray(day_all), jnp.asarray(t_end),
                        jth.ThetaConfig(**cfg))
    got = tth.forecast(tp, torch.from_numpy(day_all), float(t_end),
                       tth.ThetaConfig(**cfg))
    scale = float(np.abs(y).max())
    for name, a, b in zip(("yhat", "lo", "hi"), want, got):
        _close(b.numpy()[apart], np.asarray(a)[apart], scale, name)
    yhat, lo, hi = (x.numpy() for x in got)
    assert (lo <= yhat).all() and (yhat <= hi).all()

    q = (0.05, 0.5, 0.95)
    jq = jget_model("theta").forecast_quantiles(
        jp, jnp.asarray(day_all), jnp.asarray(t_end), jth.ThetaConfig(**cfg),
        quantiles=q)
    tq = get_model("theta").forecast_quantiles(
        tp, torch.from_numpy(day_all), float(t_end), tth.ThetaConfig(**cfg),
        quantiles=q)
    assert tq.shape == (y.shape[0], 3, day_all.size)
    _close(tq.numpy()[apart], np.asarray(jq)[apart], scale, "quantiles")
    # the median is the point forecast; the band widens with the horizon
    np.testing.assert_allclose(tq[:, 1].numpy(), yhat, rtol=1e-6, atol=1e-5)
    width = (hi - lo)[:, -30:]
    assert (np.diff(width[tp.sigma.numpy() > 0], axis=1) >= 0).all()


def test_edge_series():
    """Late start, a zero weekday slot, all-zero and all-masked rows."""
    y, mask, day = _series(seed=2)
    jp, tp = _fit_both(y, mask, day)
    # the late series' level starts from its first seven observed days: a
    # first-seven-calendar-days start would be the mean of nothing (0)
    _close(tp.fitted[LATE].numpy(), np.asarray(jp.fitted)[LATE],
           float(np.abs(y).max()), "late start")
    first = np.flatnonzero(mask[LATE])[0]
    assert first >= 150 and float(tp.fitted[LATE, first]) > 1.0
    # the zero slot's index fell back to 1, then the renormalisation
    slot = int(np.flatnonzero(day % 7 == 3)[0] % 7)
    seas = tp.seas[ZERO_SLOT].numpy()
    np.testing.assert_allclose(seas.mean(), 1.0, rtol=1e-6)
    assert seas[(3 - int(day[0]) % 7) % 7] == seas[slot] > 0
    _close(seas, np.asarray(jp.seas)[ZERO_SLOT], 1.0, "zero slot")
    for row in (ALL_ZERO, ALL_MASKED):
        for f in ("level", "sigma", "slope", "intercept"):
            assert float(getattr(tp, f)[row]) == float(
                np.asarray(getattr(jp, f))[row]) == 0.0, (row, f)
        assert float(tp.fitted[row].abs().max()) == 0.0
        # every candidate's SSE is 0: the first alpha wins in both
        assert float(tp.alpha[row]) == float(np.asarray(jp.alpha)[row]) == (
            np.float32(0.02))
    np.testing.assert_array_equal(tp.seas[ALL_MASKED].numpy(), 1.0)


@pytest.mark.parametrize("cfg", [dict(), dict(theta=3.0)], ids=["th2", "th3"])
def test_gathered_path_is_the_recomputed_one(cfg):
    """The winner's path and level gathered from the candidates' SES
    buffer are the floats a second SES run at the winning alpha gives."""
    cfg = tth.ThetaConfig(**cfg)
    y, mask, day = (torch.from_numpy(a) for a in _series(seed=3))
    p = tth.fit(y, mask, day, cfg)
    _, si, _, _, trend, zline = tth._lines(y, mask, day, cfg)
    buf = tth.ses_paths(zline, mask, p.alpha[:, None])      # (T + 1, S, 1)
    w = 1.0 / cfg.theta
    fitted = (w * buf[:-1, :, 0].t() + (1.0 - w) * trend) * si
    assert torch.equal(fitted, p.fitted)
    assert torch.equal(buf[-1, :, 0], p.level)


def test_cv_path_matches_reference():
    """Rolling-origin CV: the forecast splices the fitted path at the fit
    grid's end and widens the band from each cutoff, so the eval windows'
    paths and bands depend on both; per-cutoff paths and the CV metric
    means against the reference's, on series whose winners are apart in
    every cutoff."""
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=4, n_days=400,
                                          seed=4, missing_rate=0.05)
    jb, tb = jdata.tensorize(df), tdata.tensorize(df, device="cpu")
    cv = dict(initial=200, period=60, horizon=30)
    cfg = tth.ThetaConfig()
    want = jcv.cross_validate(jb, model="theta", cv=jcv.CVConfig(**cv))
    got = tcv.cross_validate(tb, model="theta", cv=tcv.CVConfig(**cv))
    assert got["_n_cutoffs"] == 3
    cuts = tcv.cutoff_indices(tb.n_time, tcv.CVConfig(**cv))
    train = tcv.cv_windows(tb.mask, tb.day, cuts, 30)[0]
    S, T = tb.y.shape
    rows = train.reshape(-1, T).numpy()
    apart = _apart(_candidate_sses(tb.y.repeat(len(cuts), 1).numpy(), rows,
                                   tb.day.numpy(), cfg))
    ok = apart.reshape(len(cuts), S).all(0)
    assert ok.sum() >= 5, ok
    for k in ("mse", "rmse", "mae", "mape", "smape", "mdape", "coverage",
              "mase"):
        np.testing.assert_allclose(got[k].numpy()[ok],
                                   np.asarray(want[k])[ok], rtol=1e-4,
                                   err_msg=k)
    tpaths = tcv._cv_paths(tb, "theta", cfg, cuts, 30)
    jpaths = jcv._cv_paths_impl(jb.y, jb.mask, jb.day, jax.random.PRNGKey(0),
                                "theta", jth.ThetaConfig(), tuple(cuts), 30)
    scale = float(tb.y.abs().max())
    for name, a, b in zip(("yhat", "lo", "hi"), jpaths[:3], tpaths[:3]):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape == (len(cuts), S, T), name
        _close(b[:, ok], a[:, ok], scale, name)


def test_weights_cross_with_convert():
    y, mask, day = _series(seed=5)
    jp, tp = _fit_both(y, mask, day)
    fields = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    back = convert.theta_params_from_numpy(fields, device="cpu")
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(back, k).numpy(), v)
    out = convert.theta_params_to_numpy(tp)
    assert set(out) == set(fields)
    assert convert.params_type_name(tp) == (
        "distributed_forecasting_tpu.models.theta:ThetaParams")


@pytest.fixture(scope="module")
def sales():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=300,
                                          seed=6, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    return df


def _frames_close(got, want, scale, cols):
    assert list(got.columns) == list(want.columns)
    for col in ("ds", "store", "item"):
        pd.testing.assert_series_equal(got[col], want[col])
    for col in cols:
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                   rtol=RTOL, atol=RTOL * scale, err_msg=col)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_artifact_written_by_one_package_serves_in_the_other(sales, tmp_path,
                                                             writer):
    cfg_kw = dict(theta=2.5, interval_width=0.9)
    if writer == "port":
        b = tdata.tensorize(sales, device="cpu")
        cfg = tth.ThetaConfig(**cfg_kw)
        params, _ = tfit.fit_forecast(b, "theta", config=cfg, horizon=14)
        tpred.BatchForecaster.from_fit(b, params, "theta", cfg).save(
            str(tmp_path))
    else:
        b = jdata.tensorize(sales)
        cfg = jth.ThetaConfig(**cfg_kw)
        params, _ = jfit.fit_forecast(b, model="theta", config=cfg,
                                      horizon=14)
        jpred.BatchForecaster.from_fit(b, params, "theta", cfg).save(
            str(tmp_path))
    got = tpred.BatchForecaster.load(str(tmp_path), device="cpu")
    want = jpred.BatchForecaster.load(str(tmp_path))
    assert got.config == tth.ThetaConfig(**cfg_kw)
    request = pd.DataFrame({"store": [2, 1, 2], "item": [3, 1, 1]})
    scale = float(sales["sales"].max())
    for horizon, hist in ((14, False), (7, True)):
        _frames_close(got.predict(request, horizon=horizon,
                                  include_history=hist),
                      want.predict(request, horizon=horizon,
                                   include_history=hist),
                      scale, ("yhat", "yhat_upper", "yhat_lower"))
    q = (0.1, 0.9)
    _frames_close(got.predict_quantiles(request, quantiles=q, horizon=14),
                  want.predict_quantiles(request, quantiles=q, horizon=14),
                  scale, ("q0.1", "q0.9"))
