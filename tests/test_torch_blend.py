"""Port parity: cross-family selection (``model: auto``) and blending
(``model: blend``) against the JAX reference, and the composite serving
artifacts written by one package and loaded by the other.

Pool: ``[prophet, holt_winters, croston]`` at 12 series x 400 days, CV
200/60/30 (3 cutoffs).  A third of the series are intermittent (most days
zero) so that croston carries weight; one series keeps every 40th day
only, below the fit engine's 14 points, so its fits fall back.  A row of
scores that no family makes finite is made by marking one series' CV
metric non-finite in both packages.  The curve member
runs without yearly terms: at the first cutoff only 200 days are observed,
where a 365.25-day wave is nearly collinear with the trend and the float32
normal equations are ill-conditioned (test_torch_engine.py).

Tolerances:
  * per-family CV scores (smape) within rtol 1e-3: the curve model's means
    within 1e-3 (test_torch_engine.py), Holt-Winters' and croston's within
    1e-5;
  * assignments (the argmin of the scores) equal wherever a series' best
    and second-best scores differ by more than 2e-3 relative (twice the
    score tolerance); below it either winner is accepted;
  * weights, ``w_f ∝ s_f^-t``, within ``2 t d`` relative, where ``d`` is
    the largest relative difference of that series' own scores between the
    packages (a relative change d of every score moves each weight by at
    most 2 t d, to first order), plus 1e-7;
  * forecasts within 2e-4 of each series' scale on healthy rows (the curve
    member's float32 solves, test_torch_prophet.py), and the pooled
    conformal scale within 1e-3 relative (an order statistic of residual
    ratios over paths that move by up to the scores' tolerance; measured
    here 2.5e-5, the scores 3.5e-5, the weights 7.7e-6 absolute).
"""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import blend as jblend
from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.engine import select as jselect
from distributed_forecasting_tpu.models import croston as jcr
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.models import prophet_glm as jpg
from distributed_forecasting_tpu.serving import ensemble as jens
from distributed_forecasting_tpu_torch.engine import blend as tblend
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.engine import select as tselect
from distributed_forecasting_tpu_torch.models import croston as tcr
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.models import prophet_glm as tpg
from distributed_forecasting_tpu_torch.serving import ensemble as tens
from distributed_forecasting_tpu_torch.serving import loader as tloader

torch.set_num_threads(1)

FAMILIES = ("prophet", "holt_winters", "croston")
CV = dict(initial=200, period=60, horizon=30)
HORIZON = 30
SCORE_RTOL = 1e-3
TIE_RTOL = 2e-3
PATH_RTOL = 2e-4
SCALE_RTOL = 1e-3
DEAD = 11  # the series with too few points for any fit


@pytest.fixture(scope="module")
def batches():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=6, n_days=400,
                                          seed=7, missing_rate=0.03)
    rng = np.random.default_rng(7)
    sparse = df["item"].isin([2, 5]) & (rng.random(len(df)) < 0.8)
    df.loc[sparse, "sales"] = 0.0
    df["sales"] = df["sales"].round()
    dead = (df["store"] == 2) & (df["item"] == 6)
    df = df[~dead | (df.index % 40 == 0)].reset_index(drop=True)
    return jdata.tensorize(df), tdata.tensorize(df, device="cpu")


def _configs():
    # the reference scans (its Pallas route is the same fit and its
    # interpreter is slow); the port's default resolves to the scan here
    return ({"prophet": jpg.CurveModelConfig(yearly_order=0),
             "holt_winters": jhw.HoltWintersConfig(filter="scan"),
             "croston": jcr.CrostonConfig()},
            {"prophet": tpg.CurveModelConfig(yearly_order=0),
             "holt_winters": thw.HoltWintersConfig(),
             "croston": tcr.CrostonConfig()})


@pytest.fixture(scope="module")
def selections(batches):
    jb, tb = batches
    jc, tc = _configs()
    want = jselect.select_model(jb, models=FAMILIES, configs=jc,
                                cv=jcv.CVConfig(**CV))
    got = tselect.select_model(tb, models=FAMILIES, configs=tc,
                               cv=tcv.CVConfig(**CV))
    return got, want


def _score_table(sel):
    return sel.scores[list(FAMILIES)].to_numpy(np.float64)


def _score_diff(got, want):
    """(S,) largest relative difference of each series' finite scores."""
    g, w = _score_table(got), _score_table(want)
    fin = np.isfinite(w)
    rel = np.where(fin, np.abs(g - w) / np.maximum(np.abs(w), 1e-12), 0.0)
    return rel.max(axis=1)


def _apart(sel):
    """Series whose best and second-best finite scores differ by more than
    TIE_RTOL relative."""
    t = np.sort(np.where(np.isfinite(_score_table(sel)), _score_table(sel),
                         np.inf), axis=1)
    return (t[:, 1] - t[:, 0]) > TIE_RTOL * np.abs(t[:, 0])


def test_selection_matches_reference(selections):
    got, want = selections
    g, w = _score_table(got), _score_table(want)
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=SCORE_RTOL)
    apart = _apart(want)
    assert apart.sum() >= 8  # the comparison below has teeth
    np.testing.assert_array_equal(got.assignment[apart],
                                  want.assignment[apart])
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.models == want.models == FAMILIES
    assert len(set(got.chosen)) >= 2
    np.testing.assert_allclose(got.best_score[apart], want.best_score[apart],
                               rtol=SCORE_RTOL)
    assert got.counts() == {k: int(v) for k, v in
                            pd.Series(got.chosen).value_counts().items()}


def test_coverage_selection_is_argmax(batches):
    _, tb = batches
    _, tc = _configs()
    sel = tselect.select_model(tb, models=("holt_winters", "croston"),
                               configs=tc, metric="coverage",
                               cv=tcv.CVConfig(**CV))
    t = _score_table_of(sel, ("holt_winters", "croston"))
    ok = sel.valid
    np.testing.assert_array_equal(
        sel.assignment[ok],
        np.argmax(np.where(np.isfinite(t), t, -np.inf), axis=1)[ok])


def _score_table_of(sel, models):
    return sel.scores[list(models)].to_numpy(np.float64)


def _rows_close(got, want, rtol, rows):
    got, want = np.asarray(got)[rows], np.asarray(want)[rows]
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_array_less(np.abs(got - want),
                                 np.broadcast_to(rtol * scale + 1e-5,
                                                 want.shape))


def test_fit_forecast_auto_matches_reference(batches, selections):
    jb, tb = batches
    jc, tc = _configs()
    got_sel, want_sel = selections
    # the same assignment in both packages, so the gathers compare
    forced = dataclasses.replace(got_sel)
    jp, js, jr = jselect.fit_forecast_auto(
        jb, configs=jc, horizon=HORIZON, selection=forced)
    tp, ts, tr = tselect.fit_forecast_auto(
        tb, configs=tc, horizon=HORIZON, selection=forced)
    assert set(tp) == set(jp)
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    assert not tr.ok[DEAD]
    ok = tr.ok.numpy()
    for k in ("yhat", "lo", "hi"):
        _rows_close(getattr(tr, k).numpy(), getattr(jr, k), PATH_RTOL, ok)
    np.testing.assert_array_equal(tr.day_all.numpy(), np.asarray(jr.day_all))


def _weights_close(got, want, diff, temperature):
    tol = 2 * temperature * diff[:, None] * np.abs(want.weights) + 1e-7
    assert (np.abs(got.weights - want.weights) <= tol).all(), (
        np.abs(got.weights - want.weights).max())


@pytest.mark.parametrize("temperature", [0.0, 1.0, 3.0])
def test_blend_weights_match_reference(batches, selections, temperature):
    jb, tb = batches
    jc, tc = _configs()
    want = jblend.blend_weights(jb, models=FAMILIES, configs=jc,
                                cv=jcv.CVConfig(**CV), temperature=temperature)
    got = tblend.blend_weights(tb, models=FAMILIES, configs=tc,
                               cv=tcv.CVConfig(**CV), temperature=temperature)
    _weights_close(got, want, _score_diff(*selections), temperature)
    np.testing.assert_allclose(got.weights.sum(axis=1), 1.0, rtol=1e-12)
    if temperature == 0.0:
        np.testing.assert_array_equal(got.weights, np.full_like(got.weights,
                                                                1 / 3))
    if temperature == 3.0:
        # sharper than the classical rule: the winner's weight grows
        classic = tblend.blend_weights(tb, models=FAMILIES, configs=tc,
                                       cv=tcv.CVConfig(**CV))
        best = np.argmax(classic.weights, axis=1)
        rows = np.arange(len(best))[got.valid]
        assert (got.weights[rows, best[rows]]
                >= classic.weights[rows, best[rows]] - 1e-12).all()


@pytest.fixture(scope="module")
def blends(batches, selections):
    jb, tb = batches
    jc, tc = _configs()
    want = jblend.fit_forecast_blend(jb, models=FAMILIES, configs=jc,
                                     cv=jcv.CVConfig(**CV), horizon=HORIZON,
                                     calibrate=True)
    got = tblend.fit_forecast_blend(tb, models=FAMILIES, configs=tc,
                                    cv=tcv.CVConfig(**CV), horizon=HORIZON,
                                    calibrate=True)
    return got, want


def test_fit_forecast_blend_matches_reference(blends, selections):
    (tp, tbl, tr), (jp, jbl, jr) = blends
    assert set(tp) == set(jp) == set(FAMILIES)
    _weights_close(tbl, jbl, _score_diff(*selections), 1.0)
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    ok = tr.ok.numpy()
    assert not ok[DEAD] and ok[:DEAD].all()
    for k in ("yhat", "lo", "hi"):
        _rows_close(getattr(tr, k).numpy(), getattr(jr, k), PATH_RTOL, ok)
    yhat, lo, hi = (getattr(tr, k).numpy() for k in ("yhat", "lo", "hi"))
    assert (lo[ok] <= yhat[ok]).all() and (yhat[ok] <= hi[ok]).all()
    # the pooled floor: none, since prophet and holt_winters have none
    assert tblend.blend_band_floor(FAMILIES) is None
    assert tblend.blend_band_floor(("croston",)) == 0.0


def test_pooled_conformal_scale_matches_reference(blends):
    (_, tbl, _), (_, jbl, _) = blends
    got, want = tbl.interval_scale, np.asarray(jbl.interval_scale)
    assert got.shape == want.shape == (12,)
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=SCALE_RTOL)
    assert not np.allclose(got, 1.0)


@pytest.fixture
def nan_row(monkeypatch):
    """Every family's CV metric is non-finite for series 3, in both
    packages."""
    for module, as_array in ((tselect, torch.from_numpy),
                             (jselect, jax.numpy.asarray)):
        def cv_nan(*a, _cv=module.cross_validate, _as=as_array, **k):
            out = dict(_cv(*a, **k))
            bad = np.zeros(out["smape"].shape[0], bool)
            bad[3] = True
            out["smape"] = out["smape"] * _as(np.where(bad, np.nan, 1.0)
                                              .astype(np.float32))
            return out
        monkeypatch.setattr(module, "cross_validate", cv_nan)
    return 3


def test_all_non_finite_row_takes_equal_weights(batches, nan_row):
    jb, tb = batches
    jc, tc = _configs()
    kw = dict(models=("holt_winters", "croston"), horizon=HORIZON)
    jp, jbl, jr = jblend.fit_forecast_blend(jb, configs=jc,
                                            cv=jcv.CVConfig(**CV), **kw)
    tp, tbl, tr = tblend.fit_forecast_blend(tb, configs=tc,
                                            cv=tcv.CVConfig(**CV), **kw)
    np.testing.assert_array_equal(tbl.weights[nan_row], [0.5, 0.5])
    np.testing.assert_array_equal(tbl.valid, np.asarray(jbl.valid))
    assert not tbl.valid[nan_row] and tbl.valid.sum() == tb.n_series - 1
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    assert not tr.ok[nan_row]  # surfaced through ok
    # and the auto path: the series keeps family 0 and is not ok
    _, tsel, ta = tselect.fit_forecast_auto(tb, configs=tc,
                                            cv=tcv.CVConfig(**CV), **kw)
    assert tsel.assignment[nan_row] == 0 and not ta.ok[nan_row]


def test_ok_ands_over_weight_carrying_members(batches, monkeypatch):
    """A member whose fit fell back spoils only the series it carries
    weight on, in both packages: the members' ``ok`` are forced here."""
    jb, tb = batches
    jc, tc = _configs()
    S = tb.n_series
    weights = np.tile([0.5, 0.5, 0.0], (S, 1))
    weights[0] = [0.5, 0.0, 0.5]  # series 0 carries no holt_winters weight
    forced = dict(models=FAMILIES, weights=weights,
                  scores=pd.DataFrame({f: np.ones(S) for f in FAMILIES}),
                  metric="smape", valid=np.ones(S, bool))

    def spoil(module, fit, as_array):
        def fit_spoiled(batch, model, **kw):
            params, res = fit(batch, model=model, **kw)
            if model == "holt_winters":
                bad = np.zeros(S, bool)
                bad[[0, 1]] = True
                res = dataclasses.replace(res, ok=res.ok & ~as_array(bad))
            return params, res
        monkeypatch.setattr(module, "fit_forecast", fit_spoiled)

    spoil(tblend, tblend.fit_forecast, torch.from_numpy)
    spoil(jblend, jblend.fit_forecast, jax.numpy.asarray)
    _, _, tr = tblend.fit_forecast_blend(
        tb, configs=tc, horizon=HORIZON,
        blend=tblend.BlendResult(**forced))
    _, _, jr = jblend.fit_forecast_blend(
        jb, configs=jc, horizon=HORIZON,
        blend=jblend.BlendResult(**forced))
    ok = tr.ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jr.ok))
    assert ok[0] and not ok[1]
    assert not ok[DEAD]  # too few points in every member


def test_unported_family_raises_before_any_cv(batches, monkeypatch):
    _, tb = batches
    calls = []
    monkeypatch.setattr(tselect, "cross_validate",
                        lambda *a, **k: calls.append(1))
    for fn in (tselect.select_model, tselect.fit_forecast_auto,
               tblend.fit_forecast_blend):
        # every reference family is ported (arnet came last): a family the
        # registry does not know is the one refusal, named alone, before
        # any CV pass
        with pytest.raises(KeyError, match="unknown model 'nope'") as err:
            fn(tb, models=(*tselect.DEFAULT_FAMILIES, "arnet", "nope"))
        assert "arima" not in str(err.value).split(";")[0]
        with pytest.raises(KeyError, match="'nope'"):
            fn(tb, models=("croston", "nope"))
    # the whole reference pool passes the checks
    tselect.require_models((*tselect.DEFAULT_FAMILIES, "arnet"))
    assert calls == []


# -- the composite serving artifacts ------------------------------------------

REQUEST = pd.DataFrame({"store": [2, 1, 1, 2], "item": [5, 1, 2, 3]})


def _frames_close(got, want, cols):
    pd.testing.assert_frame_equal(
        got.drop(columns=cols).reset_index(drop=True),
        want.drop(columns=cols).reset_index(drop=True), check_dtype=False)
    for c in cols:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        scale = np.abs(w).max()
        np.testing.assert_array_less(np.abs(g - w), PATH_RTOL * scale + 1e-5,
                                     err_msg=c)


@pytest.fixture(scope="module")
def composites(batches, selections, blends, tmp_path_factory):
    """Each composite saved by each package: ``{kind: {package: dir}}``."""
    jb, tb = batches
    jc, tc = _configs()
    got_sel, _ = selections
    (tp, tbl, _), (jp, jbl, _) = blends
    jpa, _, _ = jselect.fit_forecast_auto(jb, configs=jc, horizon=HORIZON,
                                          selection=got_sel)
    tpa, _, _ = tselect.fit_forecast_auto(tb, configs=tc, horizon=HORIZON,
                                          selection=got_sel)
    # the reference's blend weights in both, so the pools compare exactly
    tbl = dataclasses.replace(tbl, weights=jbl.weights,
                              interval_scale=np.asarray(jbl.interval_scale))
    made = {
        "ensemble": {
            "port": tens.MultiModelForecaster.from_fit(tb, tpa, tc, got_sel),
            "ref": jens.MultiModelForecaster.from_fit(jb, jpa, jc, got_sel)},
        "blend": {
            "port": tens.BlendedForecaster.from_fit(tb, tp, tc, tbl),
            "ref": jens.BlendedForecaster.from_fit(jb, jp, jc, jbl)},
    }
    out = {}
    for kind, pair in made.items():
        out[kind] = {}
        for pkg, fc in pair.items():
            d = str(tmp_path_factory.mktemp(f"{kind}_{pkg}"))
            fc.save(d)
            out[kind][pkg] = d
    return out


@pytest.mark.parametrize("kind, meta", [("ensemble", "ensemble.json"),
                                        ("blend", "blend.json")])
def test_composite_layout_matches_reference(composites, kind, meta):
    import os

    dirs = composites[kind]
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["ref"]))
    assert meta in os.listdir(dirs["port"])
    import json

    with open(os.path.join(dirs["port"], meta)) as f:
        got = json.load(f)
    with open(os.path.join(dirs["ref"], meta)) as f:
        want = json.load(f)
    assert got == want


@pytest.mark.parametrize("kind", ["ensemble", "blend"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_composites_load_and_predict_in_either_package(composites, kind,
                                                       writer):
    from distributed_forecasting_tpu.serving import (
        load_forecaster as jload,
    )

    d = composites[kind][writer]
    got = tloader.load_forecaster(d, device="cpu")
    want = jload(d)
    assert type(got).__name__ == type(want).__name__
    assert got.family == want.family
    assert got.serving_schema == want.serving_schema
    assert (got.n_series, got.day0, got.day1) == (want.n_series, want.day0,
                                                 want.day1)
    for horizon, hist in ((HORIZON, False), (10, True)):
        p = got.predict(REQUEST, horizon=horizon, include_history=hist)
        r = want.predict(REQUEST, horizon=horizon, include_history=hist)
        assert list(p.columns) == list(r.columns)
        _frames_close(p, r, ["yhat", "yhat_upper", "yhat_lower"])
        assert (p["yhat_lower"] <= p["yhat"]).all()
        assert (p["yhat"] <= p["yhat_upper"]).all()
    q = (0.1, 0.9)
    p = got.predict_quantiles(REQUEST, quantiles=q, horizon=HORIZON)
    r = want.predict_quantiles(REQUEST, quantiles=q, horizon=HORIZON)
    assert list(p.columns) == list(r.columns)
    _frames_close(p, r, ["q0.1", "q0.9"])
    assert (p["q0.1"] <= p["q0.9"]).all()


def test_composite_requests_skip_and_raise(composites):
    fc = tloader.load_forecaster(composites["blend"]["port"], device="cpu")
    unknown = pd.DataFrame({"store": [9], "item": [9]})
    with pytest.raises(KeyError, match="not in the training set"):
        fc.predict(unknown)
    assert fc.predict(unknown, on_missing="skip").empty
    mm = tloader.load_forecaster(composites["ensemble"]["port"], device="cpu")
    assert list(mm.predict(unknown, on_missing="skip").columns) == [
        "ds", "store", "item", "yhat", "yhat_upper", "yhat_lower", "model"]
    # neither held family takes regressors: both packages refuse xreg
    from distributed_forecasting_tpu.serving import load_forecaster as jload

    ref = jload(composites["ensemble"]["ref"])
    for fc in (mm, ref):
        with pytest.raises(ValueError, match="accepts exogenous regressors"):
            fc.predict(REQUEST, xreg=np.zeros((40, 1)))


def test_broken_composite_raises(composites, tmp_path):
    """A composite whose member is missing fails to load; it does not fall
    back to a single-family artifact."""
    import shutil

    d = tmp_path / "broken"
    shutil.copytree(composites["blend"]["port"], d)
    shutil.rmtree(d / "croston")
    with pytest.raises(FileNotFoundError):
        tloader.load_forecaster(str(d), device="cpu")
    with pytest.raises(ValueError, match="weights must be"):
        tens.BlendedForecaster(
            tloader.load_forecaster(composites["blend"]["port"],
                                    device="cpu").forecasters,
            np.ones((3, 3)), models=FAMILIES)


# -- a pool holding theta -----------------------------------------------------

THETA_POOL = ("holt_winters", "theta", "croston")


def test_pool_with_theta_matches_reference(batches):
    """``[holt_winters, theta, croston]``: theta's CV scores as the other
    recurrences', within 1e-5 relative, on the series whose theta alpha
    winner is apart from the runner-up in every cutoff (test_torch_theta's
    TIE_RTOL; elsewhere another alpha is another path and either is
    accepted); weights within ``2 d w``, forecasts within PATH_RTOL of each
    series' scale and the pooled scale within SCALE_RTOL on those series."""
    from test_torch_theta import _apart as theta_apart
    from test_torch_theta import _candidate_sses

    from distributed_forecasting_tpu.models import theta as jth
    from distributed_forecasting_tpu_torch.models import theta as tth

    jb, tb = batches
    jc, tc = _configs()
    jc = {"holt_winters": jc["holt_winters"], "theta": jth.ThetaConfig(),
          "croston": jc["croston"]}
    tc = {"holt_winters": tc["holt_winters"], "theta": tth.ThetaConfig(),
          "croston": tc["croston"]}
    kw = dict(models=THETA_POOL, horizon=HORIZON, calibrate=True)
    jp, jbl, jr = jblend.fit_forecast_blend(jb, configs=jc,
                                            cv=jcv.CVConfig(**CV), **kw)
    tp, tbl, tr = tblend.fit_forecast_blend(tb, configs=tc,
                                            cv=tcv.CVConfig(**CV), **kw)
    assert set(tp) == set(jp) == set(THETA_POOL)
    S, T = tb.y.shape
    cuts = tcv.cutoff_indices(T, tcv.CVConfig(**CV))
    train = tcv.cv_windows(tb.mask, tb.day, cuts, CV["horizon"])[0]
    apart = np.ones(S, bool)
    for mask in (tb.mask, *train):
        apart &= theta_apart(_candidate_sses(
            tb.y.numpy(), mask.numpy(), tb.day.numpy(), tth.ThetaConfig()))
    rows = apart & np.asarray(jbl.valid)
    assert rows.sum() >= 8, rows
    g = tbl.scores[list(THETA_POOL)].to_numpy(np.float64)[rows]
    w = np.asarray(jbl.scores[list(THETA_POOL)].to_numpy(np.float64))[rows]
    np.testing.assert_allclose(g, w, rtol=1e-5)
    d = (np.abs(g - w) / np.abs(w)).max(axis=1)
    tol = 2 * d[:, None] * np.abs(jbl.weights[rows]) + 1e-7
    assert (np.abs(tbl.weights[rows] - jbl.weights[rows]) <= tol).all()
    assert (tbl.weights[rows, 1] > 0.05).any()  # theta carries weight
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    ok = tr.ok.numpy() & rows
    for k in ("yhat", "lo", "hi"):
        _rows_close(getattr(tr, k).numpy(), getattr(jr, k), PATH_RTOL, ok)
    np.testing.assert_allclose(tbl.interval_scale[rows],
                               np.asarray(jbl.interval_scale)[rows],
                               rtol=SCALE_RTOL)
