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
    """The Monte-Carlo branch refuses what the analytic one refuses (levels
    outside (0, 1)) and draws that do not fit its paths."""
    Q = runs["linear_multiplicative"]["Q"]
    cfg = tp.CurveModelConfig(uncertainty_samples=10)
    day_all = torch.from_numpy(data["day_all"])
    with pytest.raises(ValueError, match="quantiles must lie in"):
        tp.forecast_quantiles(Q, day_all, 0.0, cfg, quantiles=(0.5, 1.0))
    S = Q.beta.shape[0]
    bad = (torch.zeros(S, 10, 25), torch.zeros(S, 10, 25),
           torch.zeros(S, 10, 3))
    with pytest.raises(RuntimeError):
        tp.forecast(Q, day_all, 0.0, cfg, draws=bad)


# -- the Monte-Carlo branch (uncertainty_samples > 0) ---------------------------
#
# The port draws from a torch.Generator, the reference from threefry
# (utils/rng.py).  With the reference's draws handed to the port and the
# reference's parameters carried across, the branch is held within float32:
# the simulated deviations plus noise (paths minus the point path) within
# 1e-6 of each row's path scale (measured 2.4e-7), the bands and quantiles
# within rtol 1e-5 of the row's scale (measured 2.3e-6: the point path is the
# forecast arithmetic the analytic tests above hold at 1e-5; in logistic fit
# space its cancellations reach 7.6e-4 absolute before the sigmoid).  The
# port's own draws are held by distribution.

MC_CASES = ["linear_multiplicative", "linear_additive", "logistic", "ar1",
            "xreg_shared"]


def _reference_draws(P, jc, day_all, t_end, S, N):
    """The reference's (occur, laplace, noise) for ``PRNGKey(0)``, drawn as
    its ``_trend_deviation_samples`` and ``_predictive`` draw them."""
    import jax

    from distributed_forecasting_tpu.ops.features import scaled_time

    key = jax.random.PRNGKey(0)
    k_bern, k_lap = jax.random.split(key)
    t_all = scaled_time(jnp.asarray(day_all), P.t0, P.t1)
    tes = (jnp.float32(t_end) - P.t0) / jnp.maximum(P.t1 - P.t0, 1.0)
    span = jnp.maximum(t_all[-1] - tes, 0.0)
    L = jp._FUTURE_CP_GRID
    p_cp = jnp.clip(jp._n_cp(jc) * span / jp._cp_range(jc) / L, 0.0, 1.0)
    occur = jax.random.bernoulli(k_bern, p_cp, (S, N, L)).astype(jnp.float32)
    lap = jax.random.laplace(k_lap, (S, N, L))
    noise = jax.random.normal(jax.random.fold_in(key, 1),
                              (S, N, len(day_all)))
    return key, tuple(torch.from_numpy(np.array(a)) for a in (occur, lap,
                                                              noise))


@pytest.mark.parametrize("case", MC_CASES)
def test_monte_carlo_matches_reference_with_its_draws(data, runs, case):
    r = runs[case]
    N = 200
    jc = dataclasses.replace(r["jc"], uncertainty_samples=N)
    tc = dataclasses.replace(r["tc"], uncertainty_samples=N)
    P = r["P"]
    Q = convert.curve_params_from_numpy(
        {f.name: np.asarray(getattr(P, f.name))
         for f in dataclasses.fields(P)}, device="cpu")
    te = float(data["tb"].day[-1])
    S = Q.beta.shape[0]
    key, draws = _reference_draws(P, jc, data["day_all"], te, S, N)
    xr = r["xr"]
    jx = None if xr is None else jnp.asarray(xr)
    tx = None if xr is None else torch.from_numpy(xr)
    jd, td = jnp.asarray(data["day_all"]), torch.from_numpy(data["day_all"])
    zj, _, pj = jp._predictive(P, jd, jnp.float32(te), jc, key, jx)
    zt, sd, pt = tp._predictive(Q, td, te, tc, tx, draws=draws)
    assert sd is None and pt.shape == (S, N, len(data["day_all"]))
    dev_j = np.asarray(pj) - np.asarray(zj)[:, None, :]
    dev_t = (pt - zt[:, None, :]).numpy()
    _close_rows(dev_t, dev_j, rtol=1e-6,
                scale=np.abs(np.asarray(pj)).reshape(S, -1).max(axis=1))
    got = tp.forecast(Q, td, te, tc, xreg=tx, draws=draws)
    want = jp.forecast(P, jd, jnp.float32(te), jc, key, xreg=jx)
    for g, w in zip(got, want):
        _close_rows(g, w, rtol=1e-5)
    qs = (0.05, 0.5, 0.9)
    _close_rows(tp.forecast_quantiles(Q, td, te, tc, qs, xreg=tx,
                                      draws=draws),
                jp.forecast_quantiles(P, jd, jnp.float32(te), jc, qs, key,
                                      xreg=jx), rtol=1e-5)


def test_monte_carlo_deviations_have_the_closed_form_variance(data, runs):
    """The port's own draws: the sample second moment of the simulated
    trend deviations matches ``_trend_deviation_variance`` (the reference's
    closed form, 2 b^2 p sum_l max(0, t - s_l)^2) in every future cell
    within 5 of its own standard errors (measured 2.5 at most), and their
    mean is ~0."""
    Q = runs["linear_multiplicative"]["Q"]
    tc = tp.CurveModelConfig(uncertainty_samples=4000)
    td = torch.from_numpy(data["day_all"])
    t_all = tp.scaled_time(td, Q.t0, Q.t1)
    te = (torch.tensor([[float(data["tb"].day[-1])]]) - Q.t0) / (Q.t1 - Q.t0)
    S, N, L = Q.beta.shape[0], 4000, tp._FUTURE_CP_GRID
    gen = torch.Generator().manual_seed(1)
    draws = tp.draw_standard((S, N, L), (S, N, 1),
                             tp._cp_process(Q, t_all, te, tc)[1], gen)
    dev = tp._trend_deviation_samples(Q, t_all, te, tc, draws)
    var = tp._trend_deviation_variance(Q, t_all, te, tc)
    m2 = (dev ** 2).mean(dim=1)
    se = (dev ** 2).std(dim=1) / np.sqrt(N)
    future = var > 0
    assert int(future.sum()) == S * H
    assert float(((m2 - var).abs() / se)[future].max()) < 5.0
    assert float(dev[:, :, ~future[0]].abs().max()) == 0.0
    sd = var.sqrt()[future]
    assert float((dev.mean(dim=1)[future].abs() / sd).max()) < 0.2


def test_monte_carlo_band_near_the_analytic_band(data, runs):
    """On its own draws the Monte-Carlo band (2,000 paths) is the analytic
    band up to sampling: on history days both price Gaussian noise alone
    and on future days the deviations' variance is the closed form's, so
    every half-width lies within 15% of the analytic one (measured 0.93 to
    1.07; a 2.5% quantile of 2,000 draws moves ~3% of the width) and the
    point paths are equal."""
    Q = runs["linear_additive"]["Q"]
    td = torch.from_numpy(data["day_all"])
    te = float(data["tb"].day[-1])
    mc = tp.CurveModelConfig(seasonality_mode="additive",
                             uncertainty_samples=2000)
    got = tp.forecast(Q, td, te, mc, generator=torch.Generator().manual_seed(0))
    want = tp.forecast(Q, td, te, dataclasses.replace(
        mc, uncertainty_samples=0))
    assert torch.equal(got[0], want[0])
    ratio = (got[2] - got[1]) / (want[2] - want[1])
    assert 0.85 < float(ratio.min()) and float(ratio.max()) < 1.15
    # the draws are the generator's: one seed, one band; another, another
    again = tp.forecast(Q, td, te, mc,
                        generator=torch.Generator().manual_seed(0))
    other = tp.forecast(Q, td, te, mc,
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(again[2], got[2]) and not torch.equal(other[2], got[2])
    # no generator: seeded 0, as the reference's default PRNGKey(0)
    assert torch.equal(tp.forecast(Q, td, te, mc)[2], got[2])


def test_monte_carlo_generator_threads_through_the_engine(data):
    """``generator`` reaches the Monte-Carlo branch from ``fit_forecast``,
    the CV and the predictor: one seed, one band; none, the seed 0."""
    from distributed_forecasting_tpu_torch.engine import cv as tcv
    from distributed_forecasting_tpu_torch.engine import fit as tfit
    from distributed_forecasting_tpu_torch.serving import predictor as tpred

    tb = data["tb"]
    cfg = tp.CurveModelConfig(uncertainty_samples=50, yearly_order=0)
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    P, r0 = tfit.fit_forecast(tb, "prophet", cfg, horizon=H, generator=gen(0))
    _, r_default = tfit.fit_forecast(tb, "prophet", cfg, horizon=H)
    _, r1 = tfit.fit_forecast(tb, "prophet", cfg, horizon=H, generator=gen(1))
    assert torch.equal(r0.hi, r_default.hi) and not torch.equal(r0.hi, r1.hi)
    assert torch.equal(r0.yhat, r1.yhat)
    cv = tcv.CVConfig(initial=250, period=60, horizon=30)
    m0 = tcv.cross_validate(tb, "prophet", cfg, cv=cv, generator=gen(3))
    m1 = tcv.cross_validate(tb, "prophet", cfg, cv=cv, generator=gen(3))
    assert torch.equal(m0["coverage"], m1["coverage"])
    fc = tpred.BatchForecaster.from_fit(tb, P, "prophet", cfg)
    assert not fc.coalesce_safe  # a series' draws depend on its batch
    req = tb.key_frame().iloc[:3]
    a = fc.predict(req, horizon=H, generator=gen(5))
    b = fc.predict(req, horizon=H, generator=gen(5))
    assert a.equals(b)
    q = fc.predict_quantiles(req, quantiles=(0.1, 0.9), horizon=H,
                             generator=gen(5))
    assert (q["q0.1"] <= q["q0.9"]).all()


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
