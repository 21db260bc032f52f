"""Port parity: the batched forecaster and its artifacts.

An artifact directory written by the reference's ``BatchForecaster`` loads
into the port's and serves the same frames: equal columns, keys and ``ds``;
values within rtol 1e-5 / atol 1e-5 of the data's scale (the parameters are
the reference's own, so only the forecast arithmetic — ``pow``, ``cumsum``,
``ndtri`` — rounds differently).  The port writes the same layout, which the
reference loads back.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.serving import predictor as tpred

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sales():
    df = tdata.synthetic_store_item_sales(n_stores=3, n_items=4, n_days=200,
                                          seed=8, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    return df


@pytest.fixture(scope="module")
def reference_artifact(sales, tmp_path_factory):
    jb = jdata.tensorize(sales)
    cfg = jhw.HoltWintersConfig(damped=True, interval_width=0.9)
    params, _ = jfit.fit_forecast(jb, model="holt_winters", config=cfg,
                                  horizon=20, autoprep=False)
    scale = np.linspace(0.8, 1.4, jb.n_series).astype(np.float32)
    fc = jpred.BatchForecaster.from_fit(jb, params, "holt_winters", cfg,
                                        interval_scale=scale)
    path = str(tmp_path_factory.mktemp("ref_artifact"))
    fc.save(path)
    return fc, path, float(np.abs(np.asarray(jb.y)).max())


def _request(keys):
    return pd.DataFrame(np.asarray(keys), columns=["store", "item"])


def _assert_frames_match(got, want, scale, value_cols):
    assert list(got.columns) == list(want.columns)
    for col in ("ds", "store", "item"):
        pd.testing.assert_series_equal(got[col], want[col])
    for col in value_cols:
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=col)


@pytest.mark.parametrize("rows", [[5], [11, 0, 3, 0], list(range(12))])
def test_reference_artifact_serves_like_reference(reference_artifact, rows):
    jfc, path, scale = reference_artifact
    tfc = tpred.BatchForecaster.load(path, device="cpu")
    # the config the artifact records, its filter the reference's default
    assert tfc.config == thw.HoltWintersConfig(damped=True, interval_width=0.9,
                                               filter="scan")
    np.testing.assert_array_equal(tfc.keys, jfc.keys)
    req = _request(jfc.keys[rows])
    for horizon, hist in ((20, False), (7, True)):
        _assert_frames_match(
            tfc.predict(req, horizon=horizon, include_history=hist),
            jfc.predict(req, horizon=horizon, include_history=hist),
            scale, ("yhat", "yhat_upper", "yhat_lower"))
    qs = (0.1, 0.9)  # the median is priced alongside: the artifact is scaled
    _assert_frames_match(tfc.predict_quantiles(req, quantiles=qs, horizon=20),
                         jfc.predict_quantiles(req, quantiles=qs, horizon=20),
                         scale, ("q0.1", "q0.9"))


def test_port_artifact_round_trips_and_loads_in_reference(sales, tmp_path):
    tb = tdata.tensorize(sales, device="cpu")
    cfg = thw.HoltWintersConfig()
    params, _ = tfit.fit_forecast(tb, "holt_winters", config=cfg, horizon=20)
    fc = tpred.BatchForecaster.from_fit(tb, params, "holt_winters", cfg)
    fc.save(str(tmp_path))
    back = tpred.BatchForecaster.load(str(tmp_path), device="cpu")
    req = _request(tb.keys[[7, 2]])
    pd.testing.assert_frame_equal(back.predict(req), fc.predict(req))
    pd.testing.assert_frame_equal(back.predict_quantiles(req),
                                  fc.predict_quantiles(req))
    # the recorded params_type is the reference's: it loads there as well
    ref = jpred.BatchForecaster.load(str(tmp_path))
    _assert_frames_match(fc.predict(req, include_history=True),
                         ref.predict(req, include_history=True),
                         float(tb.y.abs().max()),
                         ("yhat", "yhat_upper", "yhat_lower"))


def test_unknown_series_and_bad_options(reference_artifact):
    _, path, _ = reference_artifact
    fc = tpred.BatchForecaster.load(path, device="cpu")
    req = pd.DataFrame({"store": [1, 99], "item": [1, 1]})
    with pytest.raises(tpred.UnknownSeriesError):
        fc.predict(req)
    out = fc.predict(req, on_missing="skip", horizon=5)
    assert len(out) == 5 and set(out["store"]) == {1}
    empty = fc.predict(req.iloc[1:], on_missing="skip")
    assert list(empty.columns) == ["ds", "store", "item", "yhat",
                                   "yhat_upper", "yhat_lower"] and empty.empty
    with pytest.raises(ValueError, match="on_missing"):
        fc.predict(req, on_missing="Raise")


def test_request_buckets_match_reference():
    assert [tpred._ladder_value(k) for k in range(1, 300)] == [
        jpred._ladder_value(k) for k in range(1, 300)]
    fc = tpred.BatchForecaster(
        "holt_winters", thw.HoltWintersConfig(), params=None,
        keys=np.arange(40).reshape(20, 2), key_names=("store", "item"),
        day0=0, day1=10)
    assert [fc._bucket(k) for k in (1, 5, 13, 17, 20)] == [1, 6, 16, 20, 20]


def test_unknown_params_type_is_refused(tmp_path):
    np.savez(tmp_path / "p.npz", alpha=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="no counterpart"):
        tpred.load_params_npz(str(tmp_path / "p.npz"),
                              "distributed_forecasting_tpu.models.nope:NopeParams",
                              device="cpu")


# -- curve-model artifacts (model: prophet) -----------------------------------
#
# The reference's own parameters serve through the port: only the forecast
# arithmetic differs (exp, ndtri, the Fourier sin/cos by an ulp): rtol 1e-5.

from distributed_forecasting_tpu.models import prophet_glm as jpg  # noqa: E402
from distributed_forecasting_tpu.pipelines import training as jtrain  # noqa: E402
from distributed_forecasting_tpu_torch.models import prophet_glm as tpg  # noqa: E402
from distributed_forecasting_tpu_torch.pipelines import training as ttrain  # noqa: E402


def _curve_conf(batch, training):
    return training._resolve_holidays_conf(
        {"holidays": "US", "extra_seasonalities": (("monthly", 30.5, 3, 2.0),)},
        batch, 20)


@pytest.mark.parametrize("model,ar", [("prophet", 0), ("prophet_ar", 1)])
def test_reference_curve_artifact_serves_like_reference(sales, tmp_path, model,
                                                        ar):
    jb = jdata.tensorize(sales)
    conf = _curve_conf(jb, jtrain)
    cls = jpg.CurveModelConfigAR if model == "prophet_ar" else jpg.CurveModelConfig
    cfg = cls(**conf, ar_order=ar)
    params, _ = jfit.fit_forecast(jb, model=model, config=cfg, horizon=20,
                                  autoprep=False)
    jfc = jpred.BatchForecaster.from_fit(jb, params, model, cfg)
    jfc.save(str(tmp_path))
    tfc = tpred.BatchForecaster.load(str(tmp_path), device="cpu")
    assert tfc.config.holidays == cfg.holidays
    assert tfc.config.extra_seasonalities == cfg.extra_seasonalities
    assert isinstance(tfc.params, tpg.CurveParams)
    req = _request(jfc.keys[[4, 0, 9]])
    scale = float(np.abs(np.asarray(jb.y)).max())
    _assert_frames_match(tfc.predict(req, horizon=20, include_history=True),
                         jfc.predict(req, horizon=20, include_history=True),
                         scale, ("yhat", "yhat_upper", "yhat_lower"))
    _assert_frames_match(tfc.predict_quantiles(req, horizon=20),
                         jfc.predict_quantiles(req, horizon=20),
                         scale, ("q0.1", "q0.5", "q0.9"))


def test_port_curve_artifact_loads_in_reference(sales, tmp_path):
    tb = tdata.tensorize(sales, device="cpu")
    cfg = tpg.CurveModelConfig(**_curve_conf(tb, ttrain))
    params, _ = tfit.fit_forecast(tb, config=cfg, horizon=20)
    fc = tpred.BatchForecaster.from_fit(tb, params, "prophet", cfg)
    fc.save(str(tmp_path))
    back = tpred.BatchForecaster.load(str(tmp_path), device="cpu")
    assert back.config == cfg
    req = _request(tb.keys[[7, 2, 11, 2]])
    pd.testing.assert_frame_equal(back.predict(req), fc.predict(req))
    ref = jpred.BatchForecaster.load(str(tmp_path))
    assert isinstance(ref.params, jpg.CurveParams)
    scale = float(tb.y.abs().max())
    _assert_frames_match(fc.predict(req, include_history=True),
                         ref.predict(req, include_history=True), scale,
                         ("yhat", "yhat_upper", "yhat_lower"))
    _assert_frames_match(fc.predict_quantiles(req), ref.predict_quantiles(req),
                         scale, ("q0.1", "q0.5", "q0.9"))


def test_curve_gather_params_passes_scalars_and_empty_fields(sales):
    tb = tdata.tensorize(sales, device="cpu")
    cfg = tpg.CurveModelConfig()
    params, _ = tfit.fit_forecast(tb, config=cfg, horizon=20)
    fc = tpred.BatchForecaster.from_fit(tb, params, "prophet", cfg)
    sub = fc.gather_params(np.array([3, 3, 1]))
    assert sub.beta.shape == (3, params.beta.shape[1])
    assert torch.equal(sub.t0, params.t0) and torch.equal(sub.t1, params.t1)
    assert sub.reg_mu.shape == (0, 0) and sub.ar_phi.shape == (0, 0)
    torch.testing.assert_close(sub.sigma, params.sigma[[3, 3, 1]])


def test_curve_regressor_serving_waits_for_its_port(sales):
    """Serving with xreg is ported: a regressor model serves the fit's own
    forecast from the same covariates (within 1e-5: the request's 1-row
    product sums in another order than the fit's 12-row one), and refuses
    to serve without them (test_torch_regressors.py holds it to the
    reference)."""
    tb = tdata.tensorize(sales, device="cpu")
    T = tb.n_time
    cfg = tpg.CurveModelConfig(n_regressors=1)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(T + 20, 1)).astype(np.float32))
    params, result = tfit.fit_forecast(tb, config=cfg, horizon=20, xreg=x)
    fc = tpred.BatchForecaster.from_fit(tb, params, "prophet", cfg)
    req = _request(tb.keys[[0]])
    got = fc.predict(req, horizon=20, xreg=x, include_history=True)
    np.testing.assert_allclose(got["yhat"].to_numpy(),
                               result.yhat[0].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="no xreg"):
        fc.predict(req)
    with pytest.raises(ValueError, match=r"history\+horizon"):
        fc.predict_quantiles(req, xreg=torch.zeros(T + 90, 1), horizon=20)