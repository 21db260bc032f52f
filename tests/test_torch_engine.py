"""Port parity: the fit engine (fit_forecast, fail-safe, forecast_frame) and
rolling-origin CV against the JAX reference, at S = 16.

Inputs are whole-number unit sales (as in the committed dataset) made with
numpy from a seed.  Discrete outputs are equal: ``ok`` flags, ``ds``, keys,
cutoff counts.  Forecast values agree within 1e-5 of the data's scale (the
frameworks round the filter's float32 steps differently: see
test_torch_hw_score.py); CV metric means, which average squared and
percentage errors of those forecasts, within rtol 1e-4.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.models import holt_winters as thw

torch.set_num_threads(1)

HORIZON = 30


@pytest.fixture(scope="module")
def sales():
    """16 series x 400 days with 5% gaps; the last series keeps only every
    40th row, below the fail-safe's 14 points."""
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=8, n_days=400,
                                          seed=4, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    sparse = (df["store"] == 2) & (df["item"] == 8)
    return df[~sparse | (df.index % 40 == 0)].reset_index(drop=True)


@pytest.fixture(scope="module")
def batches(sales):
    return jdata.tensorize(sales), tdata.tensorize(sales, device="cpu")


@pytest.fixture(scope="module")
def fits(batches):
    jb, tb = batches
    # the reference scans: its Pallas route is bitwise the same fit
    # (tests/unit/test_donation.py) and its interpreter is slow at T = 400
    jp, jr = jfit.fit_forecast(jb, model="holt_winters",
                               config=jhw.HoltWintersConfig(filter="scan"),
                               horizon=HORIZON, autoprep=False)
    tp, tr = tfit.fit_forecast(tb, "holt_winters",
                               config=thw.HoltWintersConfig(filter="pallas"),
                               horizon=HORIZON)
    return jr, tr


def _reference_band_steps_off(T, season=7):
    """Horizon steps where the reference's fallback band takes one more
    seasonal step than ceil(h / season): XLA computes h / season as
    h * (1 / season) in float32, which rounds above the integer at some
    exact multiples (h = 21 at season 7).  The port computes ceil(h / season)
    exactly; these steps are compared against that formula instead."""
    h = np.arange(1, HORIZON + 1, dtype=np.float32)
    approx = np.ceil(h * np.float32(1.0 / season))
    exact = np.ceil(h.astype(np.float64) / season)
    return T + np.nonzero(approx != exact)[0]


def test_fit_forecast_matches_reference_with_fallback(batches, fits):
    jb, tb = batches
    jr, tr = fits
    ok = tr.ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jr.ok))
    assert ok[:-1].all() and not ok[-1]  # the sparse series fell back
    np.testing.assert_array_equal(tr.day_all.numpy(), np.asarray(jr.day_all))
    scale = float(np.abs(np.asarray(jb.y)).max())
    tol = dict(rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(tr.yhat.numpy(), np.asarray(jr.yhat), **tol)
    off = _reference_band_steps_off(tb.n_time)
    assert off.size  # the quirk is present at this horizon
    keep = np.setdiff1d(np.arange(tr.yhat.shape[1]), off)
    for k in ("lo", "hi"):
        got, want = getattr(tr, k).numpy(), np.asarray(getattr(jr, k))
        np.testing.assert_allclose(got[ok], want[ok], **tol)
        np.testing.assert_allclose(got[~ok][:, keep], want[~ok][:, keep], **tol)
    # the fallback band at those steps: 1.96 sigma sqrt(ceil(h / 7))
    h = np.arange(1, HORIZON + 1)
    sigma = tfit.seasonal_naive_sigma(tb.y, tb.mask)[~tr.ok].numpy()
    band = 1.96 * sigma[:, None] * np.sqrt(np.ceil(h / 7.0))[None, :]
    np.testing.assert_allclose((tr.hi - tr.yhat)[~tr.ok][:, -HORIZON:].numpy(),
                               band, rtol=1e-5)


def test_forecast_frame_matches_reference(batches, fits):
    jb, tb = batches
    jr, tr = fits
    want = jfit.forecast_frame(jb, jr, training_date="2024-01-01")
    got = tfit.forecast_frame(tb, tr, training_date="2024-01-01")
    assert list(got.columns) == list(want.columns)
    assert len(got) == 16 * (tb.n_time + HORIZON)
    for col in ("ds", "store", "item", "training_date"):
        pd.testing.assert_series_equal(got[col], want[col])
    np.testing.assert_array_equal(got["y"].to_numpy(), want["y"].to_numpy())
    ok_rows = np.repeat(tr.ok.numpy(), tb.n_time + HORIZON)
    scale = float(np.abs(np.asarray(jb.y)).max())
    for col in ("yhat", "yhat_upper", "yhat_lower"):
        np.testing.assert_allclose(got[col].to_numpy()[ok_rows],
                                   want[col].to_numpy()[ok_rows],
                                   rtol=1e-5, atol=1e-5 * scale)


def test_fit_forecast_rejects_regressors(batches):
    _, tb = batches
    with pytest.raises(ValueError, match="regressors"):
        tfit.fit_forecast(tb, "holt_winters", xreg=torch.zeros(430, 1))


def test_cutoffs_and_windows_match_reference(batches):
    jb, tb = batches
    for cfg in ((200, 60, 30), (730, 360, 90)):
        jc = jcv.CVConfig(initial=cfg[0], period=cfg[1], horizon=cfg[2])
        tc = tcv.CVConfig(initial=cfg[0], period=cfg[1], horizon=cfg[2])
        for n in (900, 1826):
            assert tcv.cutoff_indices(n, tc) == jcv.cutoff_indices(n, jc)
    with pytest.raises(ValueError, match="too short"):
        tcv.cutoff_indices(400, tcv.CVConfig())
    cuts = tcv.cutoff_indices(400, tcv.CVConfig(200, 60, 30))
    want = jcv.cv_windows(jb.mask, jb.day, cuts, 30)
    got = tcv.cv_windows(tb.mask, tb.day, cuts, 30)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("filt", ["scan", "pallas"])
def test_cross_validate_matches_reference(batches, filt, monkeypatch):
    jb, tb = batches
    calls = []
    real = thw.hw_score
    monkeypatch.setattr(thw, "hw_score",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    cv = dict(initial=200, period=60, horizon=30)
    want = jcv.cross_validate(jb, model="holt_winters",
                              config=jhw.HoltWintersConfig(filter="scan"),
                              cv=jcv.CVConfig(**cv))
    got = tcv.cross_validate(tb, "holt_winters",
                             config=thw.HoltWintersConfig(filter=filt),
                             cv=tcv.CVConfig(**cv))
    assert got["_n_cutoffs"] == want["_n_cutoffs"] == 3
    # every cutoff scored in one call over the (C*S, T) rows
    assert calls == ([] if filt == "scan" else [(3 * 16, 400)])
    assert set(got) == set(want)
    for k in sorted(set(got) - {"_n_cutoffs"}):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_cross_validate_calibrate_waits_for_its_port(batches):
    """The calibrate route is ported (its parity with the reference is in
    test_torch_calibrate.py): it adds the conformal scale and the
    calibrated coverage, and leaves every metric mean as it was."""
    _, tb = batches
    cv = tcv.CVConfig(initial=200, period=60, horizon=30)
    plain = tcv.cross_validate(tb, "holt_winters", cv=cv)
    out = tcv.cross_validate(tb, "holt_winters", cv=cv, calibrate=True)
    assert set(out) - set(plain) == {"_interval_scale", "_coverage_calibrated"}
    for k in set(plain) - {"_n_cutoffs"}:
        torch.testing.assert_close(out[k], plain[k], rtol=0, atol=0,
                                   equal_nan=True)
    scale = out["_interval_scale"]
    assert scale.shape == (16,)
    assert torch.isfinite(scale).all() and (scale > 0).all()


# -- the curve model (model: prophet, the default) ---------------------------
#
# Forecasts within 2e-4 of each row's scale on healthy rows (the float32
# solves' beta differences: see test_torch_prophet.py), the fallback rows as
# above; CV metric means, averages of those forecasts' errors, within rtol
# 1e-3, and coverage (a fraction of points inside the band) within one
# point in a cutoff's window of 30 days.  The CV runs without the yearly
# terms: at the first cutoff only 200 days are observed, where a 365.25-day
# wave is nearly collinear with the trend; with yearly order 10 (4) the
# system's condition number is ~1.5e6 (~8e5), and both packages' float32
# solves land ~0.14 (~0.01) log units from the float64 solution 30 days
# out, in different directions.  Without it the condition number is ~140.

from distributed_forecasting_tpu.models import prophet_glm as jpg  # noqa: E402
from distributed_forecasting_tpu.pipelines import training as jtrain  # noqa: E402
from distributed_forecasting_tpu_torch.models import prophet_glm as tpg  # noqa: E402
from distributed_forecasting_tpu_torch.pipelines import training as ttrain  # noqa: E402

CURVE_RTOL = 2e-4


def _curve_configs(jb, tb):
    conf = {"seasonality_mode": "multiplicative", "holidays": "US"}
    jconf = jtrain._resolve_holidays_conf(conf, jb, HORIZON)
    tconf = ttrain._resolve_holidays_conf(conf, tb, HORIZON)
    return jpg.CurveModelConfig(**jconf), tpg.CurveModelConfig(**tconf)


@pytest.mark.parametrize("conf", [
    None,
    {"holidays": "US", "seasonality_mode": "multiplicative"},
    {"holidays": {"calendar": "US", "lower_window": 1, "upper_window": 1,
                  "custom": {"promo": ["2016-11-25", "2017-01-03"]}}},
    {"holidays": (("x", (16000, 16001)),)},
])
def test_resolve_holidays_conf_matches_reference(batches, conf):
    jb, tb = batches
    assert (ttrain._resolve_holidays_conf(conf, tb, HORIZON)
            == jtrain._resolve_holidays_conf(conf, jb, HORIZON))


def test_resolve_holidays_conf_rejects_empty_calendar(batches):
    _, tb = batches
    with pytest.raises(ValueError, match="empty calendar"):
        ttrain._resolve_holidays_conf({"holidays": {}}, tb, HORIZON)


def _assert_rows_close(got, want, rtol):
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_array_less(np.abs(got - want),
                                 np.broadcast_to(rtol * scale + 1e-6, want.shape))


@pytest.mark.parametrize("xreg", [None, "shared", "per_series"])
def test_curve_fit_forecast_matches_reference(batches, xreg):
    jb, tb = batches
    jc, tc = _curve_configs(jb, tb)
    S, T = tb.y.shape
    rng = np.random.default_rng(2)
    x = None
    if xreg is not None:
        shape = (T + HORIZON, 2) if xreg == "shared" else (S, T + HORIZON, 2)
        x = rng.normal(size=shape).astype(np.float32)
        jc = dataclasses.replace(jc, n_regressors=2)
        tc = dataclasses.replace(tc, n_regressors=2)
    _, jr = jfit.fit_forecast(jb, model="prophet", config=jc, horizon=HORIZON,
                              autoprep=False, xreg=x)
    _, tr = tfit.fit_forecast(tb, config=tc, horizon=HORIZON,
                              xreg=None if x is None else torch.from_numpy(x))
    ok = tr.ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jr.ok))
    assert ok[:-1].all() and not ok[-1]
    off = _reference_band_steps_off(T)
    keep = np.setdiff1d(np.arange(T + HORIZON), off)
    for k in ("yhat", "lo", "hi"):
        got, want = getattr(tr, k).numpy(), np.asarray(getattr(jr, k))
        _assert_rows_close(got[ok], want[ok], CURVE_RTOL)
        cols = keep if k != "yhat" else slice(None)
        _assert_rows_close(got[~ok][:, cols], want[~ok][:, cols], 1e-5)


@pytest.mark.parametrize("xreg", [None, "per_series"])
def test_curve_cross_validate_matches_reference(batches, xreg):
    jb, tb = batches
    jc, tc = _curve_configs(jb, tb)
    jc = dataclasses.replace(jc, yearly_order=0)
    tc = dataclasses.replace(tc, yearly_order=0)
    x = None
    if xreg is not None:
        x = np.random.default_rng(3).normal(
            size=(tb.n_series, tb.n_time + HORIZON, 1)).astype(np.float32)
        jc = dataclasses.replace(jc, n_regressors=1)
        tc = dataclasses.replace(tc, n_regressors=1)
    cv = dict(initial=200, period=60, horizon=30)
    want = jcv.cross_validate(jb, model="prophet", config=jc,
                              cv=jcv.CVConfig(**cv), xreg=x)
    got = tcv.cross_validate(tb, config=tc, cv=tcv.CVConfig(**cv),
                             xreg=None if x is None else torch.from_numpy(x))
    assert got["_n_cutoffs"] == want["_n_cutoffs"] == 3
    assert set(got) == set(want)
    for k in sorted(set(got) - {"_n_cutoffs", "coverage"}):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["coverage"].numpy(),
                               np.asarray(want["coverage"]), atol=1 / 30 / 3)


def test_curve_guards_match_reference(batches):
    jb, tb = batches
    weekly = dataclasses.replace(tb, freq="W")
    with pytest.raises(ValueError, match="calendar-daily"):
        tfit.fit_forecast(weekly)
    with pytest.raises(ValueError, match="calendar-daily"):
        tcv.cross_validate(weekly)
    cfg = tpg.CurveModelConfig(changepoint_days=(int(tb.day[5]), 800_000))
    with pytest.raises(ValueError, match="outside the training data"):
        tfit.fit_forecast(tb, config=cfg)
    with pytest.raises(ValueError, match="history length"):
        tcv.cross_validate(tb, config=tpg.CurveModelConfig(n_regressors=1),
                           xreg=torch.zeros(10, 1))
    with pytest.raises(ValueError, match="history \\+ horizon"):
        tfit.fit_forecast(tb, config=tpg.CurveModelConfig(n_regressors=1),
                          xreg=torch.zeros(tb.n_time, 1))
    with pytest.raises(ValueError, match="no xreg"):
        tfit.fit_forecast(tb, config=tpg.CurveModelConfig(n_regressors=1))
