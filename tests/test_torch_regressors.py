"""Port parity: the curve model's regressors end to end — covariate rows to
tensors (``tensorize_regressors``, ``regressors_for_grid``), serving with
xreg (``BatchForecaster`` and the composites) — and the CV artifact
(``cv_forecast_frame``, ``cross_validate(return_frame=True)``), against the
JAX reference at 2 stores x 5 items x 400 days, horizon 30.

Covariates are made with numpy from a seed: a promo calendar shared by all
series (0/1, left unstandardized by the fit) and a per-series price (a
step path, standardized under each series' mask), as in the reference's
``examples/07_regressors.py``.  Tensors built from the same rows are equal
bit for bit (the same numpy fills, one float32 rounding).  A predictor
loaded from the other package's artifact serves the same parameters, so
its frames agree within 1e-5 of the data's scale (test_torch_predictor.py);
each package's own fit agrees within 2e-4 of each row's scale (the float32
normal equations, test_torch_engine.py), without yearly terms (a yearly
wave over 400 days is nearly collinear with the trend).  The CV frame's
keys, dates, cutoffs and y are equal; its forecasts agree at the curve
tolerance, and its metric means within rtol 1e-3 (test_torch_engine.py).
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
from distributed_forecasting_tpu.models import prophet_glm as jpg
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu.serving.ensemble import (
    BlendedForecaster as JBlended,
    MultiModelForecaster as JMulti,
)
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.models import prophet_glm as tpg
from distributed_forecasting_tpu_torch.serving import predictor as tpred
from distributed_forecasting_tpu_torch.serving.ensemble import (
    BlendedForecaster,
    MultiModelForecaster,
)

torch.set_num_threads(1)

HORIZON = 30
CURVE_RTOL = 2e-4


@pytest.fixture(scope="module")
def sales():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=5, n_days=400,
                                          seed=12, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    return df


@pytest.fixture(scope="module")
def batches(sales):
    return jdata.tensorize(sales), tdata.tensorize(sales, device="cpu")


def _covariates(batch, seed=3):
    """A shared promo calendar over history + horizon, quoted on every
    day, and a per-series price quoted on some days only (forward-filled),
    with one row for a key outside the batch."""
    rng = np.random.default_rng(seed)
    dates = pd.date_range(batch.start_date, periods=batch.n_time + HORIZON)
    promo = pd.DataFrame({"date": dates,
                          "promo": (rng.random(len(dates)) < 0.15) * 1.0})
    rows = []
    for store, item in batch.keys.tolist():
        quoted = np.sort(rng.choice(len(dates), 40, replace=False))
        rows.append(pd.DataFrame({
            "date": dates[quoted], "store": store, "item": item,
            "price": np.round(rng.uniform(1.0, 5.0, 40), 2)}))
    rows.append(pd.DataFrame({"date": dates[:1], "store": 99, "item": 99,
                              "price": [9.0]}))
    return promo, pd.concat(rows, ignore_index=True)


@pytest.fixture(scope="module")
def covariates(batches):
    return _covariates(batches[1])


def test_tensorize_regressors_matches_reference(batches, covariates):
    jb, tb = batches
    promo, price = covariates
    for frame, cols, per in ((promo, ["promo"], False),
                             (price, ["price"], True)):
        got = tdata.tensorize_regressors(frame, tb, cols, horizon=HORIZON,
                                         per_series=per)
        want = jdata.tensorize_regressors(frame, jb, cols, horizon=HORIZON,
                                          per_series=per)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = tdata.tensorize_regressors(price, tb, ["price"], horizon=HORIZON,
                                   per_series=True).numpy()
    assert x.shape == (tb.n_series, tb.n_time + HORIZON, 1)
    assert np.isfinite(x).all() and (x > 0).all()  # filled both ways


def test_regressors_for_grid_matches_batch_variant_and_reference(batches,
                                                                 covariates):
    jb, tb = batches
    _, price = covariates
    day0, n = int(tb.day[0]) + 5, tb.n_time + HORIZON - 5
    kw = dict(day0=day0, n_days=n, regressor_cols=["price"], per_series=True,
              keys=tb.keys, key_names=tb.key_names)
    got = tdata.regressors_for_grid(price, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdata.regressors_for_grid(price,
                                                                       **kw)))
    full = tdata.tensorize_regressors(price, tb, ["price"], horizon=HORIZON,
                                      per_series=True)
    # a later grid start re-fills from its own first quote onwards
    np.testing.assert_array_equal(got.numpy()[:, 40:], full.numpy()[:, 45:])


def test_regressor_frames_the_reference_refuses(batches, covariates):
    _, tb = batches
    promo, price = covariates
    with pytest.raises(ValueError, match="duplicate dates"):
        tdata.tensorize_regressors(pd.concat([promo, promo.iloc[:3]]), tb,
                                   ["promo"])
    with pytest.raises(ValueError, match="duplicate \\(key, date\\)"):
        tdata.tensorize_regressors(pd.concat([price, price.iloc[:2]]), tb,
                                   ["price"], per_series=True)
    with pytest.raises(ValueError, match="empty"):
        tdata.tensorize_regressors(promo, tb, [])
    with pytest.raises(ValueError, match="keys/key_names"):
        tdata.regressors_for_grid(price, 0, 10, ["price"], per_series=True,
                                  device="cpu")
    weekly = dataclasses.replace(tb, freq="W")
    with pytest.raises(ValueError, match="freq='D'"):
        tdata.tensorize_regressors(promo, weekly, ["promo"])


def _configs(R):
    return (jpg.CurveModelConfig(yearly_order=0, n_regressors=R),
            tpg.CurveModelConfig(yearly_order=0, n_regressors=R))


def _xreg(batches, covariates, kind):
    jb, tb = batches
    promo, price = covariates
    if kind == "shared":
        return tdata.tensorize_regressors(promo, tb, ["promo"],
                                          horizon=HORIZON).numpy()
    return tdata.tensorize_regressors(price, tb, ["price"], horizon=HORIZON,
                                      per_series=True).numpy()


@pytest.fixture(scope="module", params=["shared", "per_series"])
def reference_artifact(request, batches, covariates, tmp_path_factory):
    jb, _ = batches
    x = _xreg(batches, covariates, request.param)
    jc, _ = _configs(1)
    params, _ = jfit.fit_forecast(jb, model="prophet", config=jc,
                                  horizon=HORIZON, xreg=x, autoprep=False)
    fc = jpred.BatchForecaster.from_fit(jb, params, "prophet", jc)
    path = str(tmp_path_factory.mktemp(f"artifact_{request.param}"))
    fc.save(path)
    return request.param, x, fc, path


def _request(keys):
    return pd.DataFrame(np.asarray(keys), columns=["store", "item"])


def _assert_frames_match(got, want, scale, cols):
    assert list(got.columns) == list(want.columns)
    for col in ("ds", "store", "item"):
        np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy())
    for col in cols:
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=col)


def test_reference_artifact_serves_xreg_like_reference(reference_artifact,
                                                       batches):
    kind, x, jfc, path = reference_artifact
    fc = tpred.BatchForecaster.load(path, device="cpu")
    # the fit's standardization travels with the artifact
    np.testing.assert_array_equal(fc.params.reg_mu.numpy(),
                                  np.asarray(jfc.params.reg_mu))
    np.testing.assert_array_equal(fc.params.reg_sd.numpy(),
                                  np.asarray(jfc.params.reg_sd))
    if kind == "shared":  # the promo column is 0/1: left as it is
        assert (fc.params.reg_mu.numpy() == 0).all()
        assert (fc.params.reg_sd.numpy() == 1).all()
    scale = float(batches[1].y.abs().max())
    req = _request(jfc.keys[[6, 0, 3, 6]])
    xt = torch.from_numpy(x)
    _assert_frames_match(fc.predict(req, horizon=HORIZON, xreg=xt,
                                    include_history=True),
                         jfc.predict(req, horizon=HORIZON, xreg=x,
                                     include_history=True),
                         scale, ("yhat", "yhat_upper", "yhat_lower"))
    _assert_frames_match(fc.predict_quantiles(req, horizon=HORIZON, xreg=xt),
                         jfc.predict_quantiles(req, horizon=HORIZON, xreg=x),
                         scale, ("q0.1", "q0.5", "q0.9"))
    # the same rows whatever the request's size bucket
    one = fc.predict(_request(jfc.keys[[3]]), horizon=HORIZON, xreg=xt)
    full = fc.predict(req, horizon=HORIZON, xreg=xt)
    mine = (full["store"] == jfc.keys[3, 0]) & (full["item"] == jfc.keys[3, 1])
    pd.testing.assert_frame_equal(one, full[mine].reset_index(drop=True))


def test_port_fit_serves_like_reference_fit(batches, covariates, tmp_path):
    """fit_forecast with xreg in each package, the port's artifact saved
    and loaded, served with the same covariates."""
    jb, tb = batches
    x = _xreg(batches, covariates, "per_series")
    jc, tc = _configs(1)
    jp, jr = jfit.fit_forecast(jb, model="prophet", config=jc, horizon=HORIZON,
                               xreg=x, autoprep=False)
    tp, tr = tfit.fit_forecast(tb, config=tc, horizon=HORIZON,
                               xreg=torch.from_numpy(x))
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    for k in ("yhat", "lo", "hi"):
        want = np.asarray(getattr(jr, k))
        scale = np.abs(want).max(axis=1, keepdims=True)
        np.testing.assert_array_less(
            np.abs(getattr(tr, k).numpy() - want),
            np.broadcast_to(CURVE_RTOL * scale + 1e-6, want.shape))
    fc = tpred.BatchForecaster.from_fit(tb, tp, "prophet", tc)
    fc.save(str(tmp_path))
    ref = jpred.BatchForecaster.load(str(tmp_path))
    req = _request(tb.keys[[2, 9, 5]])
    scale = float(tb.y.abs().max())
    _assert_frames_match(fc.predict(req, horizon=HORIZON,
                                    xreg=torch.from_numpy(x)),
                         ref.predict(req, horizon=HORIZON, xreg=x), scale,
                         ("yhat", "yhat_upper", "yhat_lower"))


def test_serving_xreg_is_validated_as_the_reference_does(reference_artifact):
    kind, x, jfc, path = reference_artifact
    fc = tpred.BatchForecaster.load(path, device="cpu")
    req = _request(jfc.keys[[1]])
    T_all = x.shape[-2]
    bad = {
        "history only": (x[..., :T_all - HORIZON, :], "full history"),
        "4-D": (x[None, None], "xreg must be"),
    }
    if kind == "per_series":
        bad["rows"] = (x[:3], "expected all 10 trained series")
    for name, (xr, match) in bad.items():
        with pytest.raises(ValueError, match=match):
            fc.predict(req, horizon=HORIZON, xreg=torch.from_numpy(xr))
        with pytest.raises(ValueError):
            jfc.predict(req, horizon=HORIZON, xreg=xr)
    # a regressor model without its covariates is a hard error
    with pytest.raises(ValueError, match="no xreg"):
        fc.predict(req, horizon=HORIZON)


def test_warmup_runs_a_regressor_model(reference_artifact):
    _, _, jfc, path = reference_artifact
    fc = tpred.BatchForecaster.load(path, device="cpu")
    assert fc.warmup(horizon=HORIZON, sizes=(1, 5, 40)) == jfc.warmup(
        horizon=HORIZON, sizes=(1, 5, 40))


def test_model_without_regressors_refuses_xreg(batches):
    _, tb = batches
    cfg = thw.HoltWintersConfig()
    params, _ = tfit.fit_forecast(tb, "holt_winters", config=cfg,
                                  horizon=HORIZON)
    fc = tpred.BatchForecaster.from_fit(tb, params, "holt_winters", cfg)
    with pytest.raises(ValueError, match="does not accept exogenous"):
        fc.predict(_request(tb.keys[[0]]), horizon=HORIZON,
                   xreg=torch.zeros(tb.n_time + HORIZON, 1))


def test_composites_forward_xreg_to_the_curve_member(reference_artifact,
                                                      batches):
    """Mixed-family and blended forecasters hand xreg to the families that
    take it (the curve model) and not to the others, as the reference's."""
    kind, x, jfc, path = reference_artifact
    jb, tb = batches
    from distributed_forecasting_tpu.models import holt_winters as jhw

    jhp, _ = jfit.fit_forecast(jb, model="holt_winters",
                               config=jhw.HoltWintersConfig(filter="scan"),
                               horizon=HORIZON, autoprep=False)
    jhfc = jpred.BatchForecaster.from_fit(jb, jhp, "holt_winters",
                                          jhw.HoltWintersConfig(filter="scan"))
    hpath = path + "_hw"
    jhfc.save(hpath)
    members = {"prophet": tpred.BatchForecaster.load(path, device="cpu"),
               "holt_winters": tpred.BatchForecaster.load(hpath,
                                                          device="cpu")}
    jmembers = {"prophet": jfc, "holt_winters": jhfc}
    S = tb.n_series
    assignment = np.arange(S) % 2
    weights = np.tile([0.7, 0.3], (S, 1))
    req = _request(tb.keys[[0, 3, 4, 9]])
    scale = float(tb.y.abs().max())
    xt = torch.from_numpy(x)
    got = MultiModelForecaster(members, assignment).predict(
        req, horizon=HORIZON, xreg=xt)
    want = JMulti(jmembers, assignment).predict(req, horizon=HORIZON, xreg=x)
    _assert_frames_match(got, want, scale, ("yhat", "yhat_upper", "yhat_lower"))
    assert list(got["model"]) == list(want["model"])
    got = BlendedForecaster(members, weights).predict_quantiles(
        req, horizon=HORIZON, xreg=xt)
    want = JBlended(jmembers, weights).predict_quantiles(req, horizon=HORIZON,
                                                         xreg=x)
    _assert_frames_match(got, want, scale, ("q0.1", "q0.5", "q0.9"))
    only_hw = MultiModelForecaster({"holt_winters": members["holt_winters"]},
                                   np.zeros(S, int))
    with pytest.raises(ValueError, match="none of the held families"):
        only_hw.predict(req, horizon=HORIZON, xreg=xt)


# -- the CV artifact ----------------------------------------------------------

CV = dict(initial=200, period=60, horizon=30)


@pytest.fixture(scope="module", params=[None, "per_series"])
def cv_runs(request, batches, covariates):
    jb, tb = batches
    R = 0 if request.param is None else 1
    jc, tc = _configs(R)
    x = None if request.param is None else _xreg(batches, covariates,
                                                 "per_series")
    jm, jf = jcv.cross_validate(jb, model="prophet", config=jc,
                                cv=jcv.CVConfig(**CV), xreg=x,
                                return_frame=True, calibrate=True)
    tx = None if x is None else torch.from_numpy(x)
    tm, tf = tcv.cross_validate(tb, config=tc, cv=tcv.CVConfig(**CV), xreg=tx,
                                return_frame=True, calibrate=True)
    frame = tcv.cv_forecast_frame(tb, config=tc, cv=tcv.CVConfig(**CV),
                                  xreg=tx)
    plain = tcv.cross_validate(tb, config=tc, cv=tcv.CVConfig(**CV), xreg=tx,
                               calibrate=True)
    return (jm, jf), (tm, tf), frame, plain, tb


def test_cv_frame_matches_reference(cv_runs):
    (_, want), (_, got), _, _, tb = cv_runs
    assert list(got.columns) == ["ds", "store", "item", "cutoff", "y", "yhat",
                                 "yhat_lower", "yhat_upper"]
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in ("ds", "store", "item", "cutoff", "y"):
        np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy(),
                                      err_msg=col)
    # one row per series, cutoff and observed scored day
    cuts = tcv.cutoff_indices(tb.n_time, tcv.CVConfig(**CV))
    em = tcv.cv_windows(tb.mask, tb.day, cuts, CV["horizon"])[1]
    assert len(got) == int(em.sum())
    for col in ("yhat", "yhat_lower", "yhat_upper"):
        g, w = got[col].to_numpy(), want[col].to_numpy()
        scale = want.groupby(["store", "item", "cutoff"])[col].transform(
            lambda v: np.abs(v).max()).to_numpy()
        np.testing.assert_array_less(np.abs(g - w), CURVE_RTOL * scale + 1e-6)


def test_return_frame_is_one_cv_pass(cv_runs):
    (jm, _), (tm, tf), frame, plain, _ = cv_runs
    # the frame alone, and the metrics alone, equal what one pass returns
    pd.testing.assert_frame_equal(frame, tf)
    assert set(plain) == set(tm)
    for k in sorted(set(tm) - {"_n_cutoffs"}):
        assert torch.equal(plain[k], tm[k]), k
    assert set(tm) == set(jm)
    assert tm["_n_cutoffs"] == jm["_n_cutoffs"] == 3
    for k in sorted(set(tm) - {"_n_cutoffs", "coverage",
                               "_coverage_calibrated"}):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)
    # coverage: within one point per series and cutoff (a point on the edge)
    for k in ("coverage", "_coverage_calibrated"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1 / 30 / 3, err_msg=k)
