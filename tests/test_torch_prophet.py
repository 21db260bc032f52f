"""Port parity: the curve model (``models/prophet_glm``) against the JAX
reference, at S = 8 series x T = 400 days, 30 days of horizon.

Inputs are whole-number unit sales made with numpy from a seed (5% of the
cells missing) and, for the regressor cases, numpy regressors.  Each
growth x seasonality mode runs, with holidays, Huber IRLS, AR(1), extra
seasonalities with their own prior scale, explicit changepoints, and shared
and per-series regressors.

Tolerances and why:
- sigma within rtol 2e-6 (l2): it is a mean of squared residuals, stable to
  float32 rounding of the solve; with Huber within rtol 1e-3, since it is a
  median of |r| and a residual that moves by an ulp can swap neighbours.
- beta within atol 5e-4: the normal equations are ill-conditioned in
  float32 (intercept, slope and the first hinges are nearly collinear, with
  a 1e-8 ridge on the fixed columns), so the two frameworks' solves land
  up to ~1e-4 apart along those directions.
- paths (yhat, lo, hi, quantiles, fit-space components) within rtol 2e-4 of
  each row's scale: the beta differences above, mapped through the design
  (and exp in multiplicative mode).  The ``sin``/``cos`` of the Fourier
  columns differ by ~1 float32 ulp (their angles are bitwise equal:
  test_torch_features.py).
- With the reference's own parameters carried across (``convert``), only
  the forecast arithmetic differs: rtol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.data.holidays import us_holiday_spec_for_range
from distributed_forecasting_tpu.models import prophet_glm as jp
from distributed_forecasting_tpu_torch import convert
from distributed_forecasting_tpu_torch.models import prophet_glm as tp

torch.set_num_threads(1)

H = 30
PATH_RTOL = 2e-4


@pytest.fixture(scope="module")
def data():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=4, n_days=400,
                                          seed=3, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    jb, tb = jdata.tensorize(df), tdata.tensorize(df, device="cpu")
    S, T = tb.y.shape
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(T + H, 2)).astype(np.float32)
    xs[:, 1] = rng.random(T + H) > 0.8          # a 0/1 promo flag
    xp = rng.normal(size=(S, T + H, 1)).astype(np.float32)
    day_all = np.arange(int(tb.day[0]), int(tb.day[-1]) + H + 1, dtype=np.int32)
    return dict(jb=jb, tb=tb, xs=xs, xp=xp, day_all=day_all, T=T)


def _cases(tb):
    hol = us_holiday_spec_for_range(tb.dates()[0],
                                    tb.dates()[-1] + pd.Timedelta(days=H))
    return {
        "linear_multiplicative": dict(),
        "linear_additive": dict(seasonality_mode="additive"),
        "flat_multiplicative": dict(growth="flat"),
        "flat_additive": dict(growth="flat", seasonality_mode="additive"),
        "logistic": dict(growth="logistic", seasonality_mode="additive"),
        "logistic_cap_floor": dict(growth="logistic", cap_value=150.0,
                                   floor_value=2.0),
        "holidays": dict(holidays=hol),
        "huber": dict(loss="huber"),
        "ar1": dict(ar_order=1, holidays=hol),
        "extra_seasonality_changepoints": dict(
            extra_seasonalities=(("monthly", 30.5, 3, 2.0),),
            changepoint_days=(int(tb.day[100]), int(tb.day[250]))),
        "xreg_shared": dict(n_regressors=2),
        "xreg_per_series": dict(n_regressors=1),
    }


CASES = ["linear_multiplicative", "linear_additive", "flat_multiplicative",
         "flat_additive", "logistic", "logistic_cap_floor", "holidays",
         "huber", "ar1", "extra_seasonality_changepoints", "xreg_shared",
         "xreg_per_series"]


@pytest.fixture(scope="module")
def runs(data):
    """Both packages' fit, forecast, quantiles and components per case."""
    jb, tb, T = data["jb"], data["tb"], data["T"]
    day_all = data["day_all"]
    out = {}
    for name, kw in _cases(tb).items():
        xr = {"xreg_shared": data["xs"], "xreg_per_series": data["xp"]}.get(name)
        xh = None if xr is None else (xr[:T] if xr.ndim == 2 else xr[:, :T])
        jc, tc = jp.CurveModelConfig(**kw), tp.CurveModelConfig(**kw)
        te = float(tb.day[-1])
        jx = (lambda a: None if a is None else jnp.asarray(a))
        tx = (lambda a: None if a is None else torch.from_numpy(a))
        P = jp.fit(jb.y, jb.mask, jb.day, jc, xreg=jx(xh))
        Q = tp.fit(tb.y, tb.mask, tb.day, tc, xreg=tx(xh))
        jd, td = jnp.asarray(day_all), torch.from_numpy(day_all)
        out[name] = dict(
            jc=jc, tc=tc, P=P, Q=Q, xr=xr,
            fc=(jp.forecast(P, jd, jnp.float32(te), jc, xreg=jx(xr)),
                tp.forecast(Q, td, te, tc, xreg=tx(xr))),
            q=(jp.forecast_quantiles(P, jd, jnp.float32(te), jc,
                                     quantiles=(0.05, 0.5, 0.8), xreg=jx(xr)),
               tp.forecast_quantiles(Q, td, te, tc, quantiles=(0.05, 0.5, 0.8),
                                     xreg=tx(xr))),
            comps=(jp.decompose(P, jd, jc, xreg=jx(xr), t_end=jnp.float32(te)),
                   tp.decompose(Q, td, tc, xreg=tx(xr), t_end=te)),
        )
    return out


def _close_rows(got, want, rtol=PATH_RTOL, scale=None):
    """Each row within ``rtol`` of that row's largest magnitude (or of the
    given per-row ``scale``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if scale is None:
        scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    scale = np.maximum(scale, 1e-6).reshape((-1,) + (1,) * (want.ndim - 1))
    bound = np.broadcast_to(rtol * scale + 1e-7, want.shape)
    np.testing.assert_array_less(np.abs(got - want), bound)


@pytest.mark.parametrize("case", CASES)
def test_fit_matches_reference(runs, case):
    r = runs[case]
    P, Q = r["P"], r["Q"]
    rtol = 1e-3 if case == "huber" else 2e-6
    np.testing.assert_allclose(Q.sigma.numpy(), np.asarray(P.sigma), rtol=rtol)
    np.testing.assert_allclose(Q.beta.numpy(), np.asarray(P.beta), atol=5e-4)
    # masked maxima and day numbers are exact; regressor means and sds are
    # sums of 400 terms taken in another order (atol 1e-7)
    for f in ("y_scale", "cap", "t0", "t1", "reg_mu", "reg_sd", "ar_last_day"):
        np.testing.assert_allclose(getattr(Q, f).numpy(),
                                   np.asarray(getattr(P, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    for f in ("ar_phi", "ar_tail", "ar_sigma"):
        np.testing.assert_allclose(getattr(Q, f).numpy(),
                                   np.asarray(getattr(P, f)), rtol=1e-3,
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("case", CASES)
def test_forecast_matches_reference(runs, case):
    want, got = runs[case]["fc"]
    for w, g in zip(want, got):
        _close_rows(g.numpy(), w)
    assert bool((got[1] <= got[0]).all() and (got[0] <= got[2]).all())


@pytest.mark.parametrize("case", CASES)
def test_quantiles_match_reference(runs, case):
    want, got = runs[case]["q"]
    _close_rows(got.numpy(), want)
    assert bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.parametrize("case", CASES)
def test_decompose_matches_reference(runs, case):
    want, got = runs[case]["comps"]
    assert list(got) == list(want)
    # every component against the row's largest component: a small one
    # (a holiday, the decayed AR term) carries the others' rounding
    scale = np.max([np.abs(np.asarray(v)).max(axis=1) for v in want.values()],
                   axis=0)
    for k in want:
        _close_rows(got[k].numpy(), want[k], scale=scale)
    if runs[case]["tc"].ar_order:
        assert "ar" in got


def test_per_row_t_end_matches_scalar_calls(data, runs):
    """The CV's folded call — one forecast start per row — against the
    reference's scalar call for each cutoff's block of rows."""
    tb = data["tb"]
    r = runs["ar1"]
    day = tb.day
    cuts = (199, 259, 319)
    S = tb.n_series
    rows = torch.cat([day[c].float().expand(S) for c in cuts])
    Q = r["Q"]
    Qc = dataclasses.replace(Q, **{
        f.name: getattr(Q, f.name).repeat((len(cuts),) + (1,) * (getattr(Q, f.name).dim() - 1))
        for f in dataclasses.fields(Q) if getattr(Q, f.name).dim() >= 1
        and getattr(Q, f.name).shape[0] == S})
    got = tp.forecast(Qc, day, rows, r["tc"])
    for i, c in enumerate(cuts):
        want = tp.forecast(Q, day, float(day[c]), r["tc"])
        ref = jp.forecast(r["P"], data["jb"].day, jnp.float32(float(day[c])),
                          r["jc"])
        for g, w, j in zip(got, want, ref):
            block = g[i * S:(i + 1) * S]
            torch.testing.assert_close(block, w, rtol=1e-6, atol=1e-6)
            _close_rows(block.numpy(), j)


@pytest.mark.parametrize("case", ["linear_multiplicative", "ar1",
                                  "xreg_per_series", "logistic_cap_floor"])
def test_reference_params_carried_across_forecast_the_same(data, runs, case):
    r = runs[case]
    fields = {f.name: np.asarray(getattr(r["P"], f.name))
              for f in dataclasses.fields(r["P"])}
    Q = convert.curve_params_from_numpy(fields, device="cpu")
    back = convert.curve_params_to_numpy(Q)
    assert set(back) == set(fields)
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k])
    xr = r["xr"]
    te = float(data["tb"].day[-1])
    got = tp.forecast(Q, torch.from_numpy(data["day_all"]), te, r["tc"],
                      xreg=None if xr is None else torch.from_numpy(xr))
    for g, w in zip(got, r["fc"][0]):
        _close_rows(g.numpy(), w, rtol=1e-5)


def test_artifact_without_new_fields_backfills(runs):
    P = runs["linear_multiplicative"]["P"]
    fields = {k: np.asarray(getattr(P, k))
              for k in ("beta", "sigma", "y_scale", "cap", "t0", "t1")}
    Q = convert.curve_params_from_numpy(fields, device="cpu")
    assert Q.reg_mu.shape == (0, 0) and Q.ar_sigma.shape == (0,)
    assert bool((Q.reg_sd == 1).all())


def test_monte_carlo_intervals_raise(data, runs):
    Q = runs["linear_multiplicative"]["Q"]
    cfg = tp.CurveModelConfig(uncertainty_samples=100)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp.forecast(Q, torch.from_numpy(data["day_all"]), 0.0, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp.forecast_quantiles(Q, torch.from_numpy(data["day_all"]), 0.0, cfg)


def test_extract_params_and_component_frame_match_reference(data, runs):
    r = runs["extra_seasonality_changepoints"]
    assert tp.extract_params(r["Q"], r["tc"]) == jp.extract_params(r["P"], r["jc"])
    want = jp.component_frame(data["jb"], r["P"], r["jc"], horizon=H)
    got = tp.component_frame(data["tb"], r["Q"], r["tc"], horizon=H)
    assert list(got.columns) == list(want.columns)
    for col in ("ds", "store", "item"):
        pd.testing.assert_series_equal(got[col], want[col])
    for col in ("trend", "weekly", "yearly", "monthly"):
        np.testing.assert_allclose(got[col], want[col], rtol=PATH_RTOL,
                                   atol=PATH_RTOL * np.abs(want[col]).max())


@pytest.mark.parametrize("bad", [
    dict(extra_seasonalities=(("trend", 30.5, 3),)),
    dict(extra_seasonalities=(("m", 30.5, 3), ("m", 7.0, 1))),
    dict(extra_seasonalities=(("m", 30.5, 0),)),
    dict(loss="l1"),
    dict(growth="logistic", cap_value=1.0, floor_value=2.0),
    dict(growth="logistic", floor_value=2.0),
])
def test_bad_configs_raise_like_reference(data, bad):
    tb, jb = data["tb"], data["jb"]
    with pytest.raises(ValueError) as want:
        jp.fit(jb.y, jb.mask, jb.day, jp.CurveModelConfig(**bad))
    with pytest.raises(ValueError) as got:
        tp.fit(tb.y, tb.mask, tb.day, tp.CurveModelConfig(**bad))
    assert str(got.value) == str(want.value)


def test_xreg_contract(data):
    tb = data["tb"]
    with pytest.raises(ValueError, match="n_regressors == 0"):
        tp.fit(tb.y, tb.mask, tb.day, tp.CurveModelConfig(),
               xreg=torch.zeros(tb.n_time, 1))
    with pytest.raises(ValueError, match="no xreg"):
        tp.fit(tb.y, tb.mask, tb.day, tp.CurveModelConfig(n_regressors=1))
    with pytest.raises(ValueError, match="columns"):
        tp.fit(tb.y, tb.mask, tb.day, tp.CurveModelConfig(n_regressors=2),
               xreg=torch.zeros(tb.n_time, 1))
