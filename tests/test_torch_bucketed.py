"""Port parity: span buckets on trimmed grids (``bucket_by_span``,
``fit_forecast_bucketed``, ``BucketedForecaster``) against the JAX
reference, at 2 stores x 8 items x 400 days.

The ragged batch has four spans: items 1-3 observed from day 0, items 4-5
from day 150, items 6-8 from day 300, and one series with its last 10 days
only (below the fail-safe's 14 points).  Host-side outputs are equal: the
bucket indices, each sub-batch's grid, keys, start date and tensors
(tensorize is bit-identical, and a bucket is a slice), the artifact's
files and the frames' keys and dates.  Forecast values agree within the
tolerances of test_torch_engine.py: 1e-5 of the data's scale for
Holt-Winters (the frameworks round the filter's float32 steps differently)
and 2e-4 of each row's scale for the curve model (its float32 normal
equations).  The curve model runs without yearly terms here: a 16- to
256-day window is shorter than a year, and the yearly wave's columns are
then nearly collinear with the trend.  A predictor loaded from the other
package's artifact serves the same parameters, so its frames agree within
1e-5 of the data's scale (as in test_torch_predictor.py).
"""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.models import prophet_glm as jpg
from distributed_forecasting_tpu.serving import BucketedForecaster as JBucketed
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.models import prophet_glm as tpg
from distributed_forecasting_tpu_torch.serving import BucketedForecaster
from distributed_forecasting_tpu_torch.serving import loader as tloader
from distributed_forecasting_tpu_torch.serving import predictor as tpred

torch.set_num_threads(1)

HORIZON = 14
CURVE_RTOL = 2e-4


def _ragged_frame(freq_days: int = 400):
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=8,
                                          n_days=freq_days, seed=11,
                                          missing_rate=0.03)
    df["sales"] = df["sales"].round()
    day = (pd.to_datetime(df["date"]) - pd.Timestamp("2013-01-01")).dt.days
    start = np.select([df["item"] <= 3, df["item"] <= 5], [0, 150], 300)
    keep = day >= start
    sparse = (df["store"] == 2) & (df["item"] == 8)
    keep &= ~sparse | (day >= freq_days - 10)
    return df[keep].reset_index(drop=True)


@pytest.fixture(scope="module")
def ragged():
    return _ragged_frame()


@pytest.fixture(scope="module")
def batches(ragged):
    return jdata.tensorize(ragged), tdata.tensorize(ragged, device="cpu")


def _assert_sub_equal(got, want):
    for k in ("y", "mask", "day"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    np.testing.assert_array_equal(got.keys, np.asarray(want.keys))
    assert got.start_date == want.start_date
    assert got.freq == want.freq and got.key_names == want.key_names


@pytest.mark.parametrize("max_buckets", [4, 2, 1])
def test_bucket_by_span_matches_reference(batches, max_buckets):
    jb, tb = batches
    want = jdata.bucket_by_span(jb, max_buckets=max_buckets)
    got = tdata.bucket_by_span(tb, max_buckets=max_buckets)
    assert len(got) == len(want) == max_buckets
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        _assert_sub_equal(gs, ws)
    # the buckets partition the series and lose no observation
    idx = np.concatenate([i for i, _ in got])
    assert sorted(idx.tolist()) == list(range(tb.n_series))
    assert sum(float(s.mask.sum()) for _, s in got) == float(tb.mask.sum())
    if max_buckets == 4:
        assert [s.n_time for _, s in got] == [16, 128, 256, 400]


def test_bucket_by_span_weekly_origin_matches_reference(ragged):
    jb = jdata.tensorize(ragged, freq="W")
    tb = tdata.tensorize(ragged, freq="W", device="cpu")
    want = jdata.bucket_by_span(jb)
    got = tdata.bucket_by_span(tb)
    assert len(got) == len(want) > 1
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        _assert_sub_equal(gs, ws)


def test_bucket_by_span_refuses_zero_buckets(batches):
    with pytest.raises(ValueError, match="max_buckets"):
        tdata.bucket_by_span(batches[1], max_buckets=0)


def _configs(model):
    if model == "holt_winters":
        # the reference scans: its Pallas route is bitwise the same fit
        return (jhw.HoltWintersConfig(filter="scan"),
                thw.HoltWintersConfig(filter="pallas"))
    return jpg.CurveModelConfig(yearly_order=0), tpg.CurveModelConfig(
        yearly_order=0)


def _band_steps_off(T, season=7):
    """The reference's fallback band takes one more seasonal step than
    ceil(h / season) where XLA's h * (1 / season) rounds above an integer
    (test_torch_engine.py); those steps are left out of the band check."""
    h = np.arange(1, HORIZON + 1, dtype=np.float32)
    approx = np.ceil(h * np.float32(1.0 / season))
    return T + np.nonzero(approx != np.ceil(h.astype(np.float64) / season))[0]


def _assert_rows_close(got, want, rtol=CURVE_RTOL):
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_array_less(
        np.abs(got - want), np.broadcast_to(rtol * scale + 1e-6, want.shape))


def _assert_result_close(tr, jr, model, scale, T):
    ok = tr.ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jr.ok))
    np.testing.assert_array_equal(tr.day_all.numpy(), np.asarray(jr.day_all))
    keep = np.setdiff1d(np.arange(T + HORIZON), _band_steps_off(T))
    for k in ("yhat", "lo", "hi"):
        got, want = getattr(tr, k).numpy(), np.asarray(getattr(jr, k))
        assert got.shape == want.shape == (len(ok), T + HORIZON)
        if model == "holt_winters":
            tol = dict(rtol=1e-5, atol=1e-5 * scale)
            np.testing.assert_allclose(got[ok], want[ok], **tol, err_msg=k)
        else:
            _assert_rows_close(got[ok], want[ok])
        cols = keep if k != "yhat" else slice(None)
        np.testing.assert_allclose(got[~ok][:, cols], want[~ok][:, cols],
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("max_buckets", [4, 2])
@pytest.mark.parametrize("model", ["prophet", "holt_winters"])
def test_fit_forecast_bucketed_matches_reference(batches, model, max_buckets):
    jb, tb = batches
    jc, tc = _configs(model)
    jbk, jr = jfit.fit_forecast_bucketed(jb, model=model, config=jc,
                                         horizon=HORIZON,
                                         max_buckets=max_buckets,
                                         autoprep=False)
    tbk, tr = tfit.fit_forecast_bucketed(tb, model=model, config=tc,
                                         horizon=HORIZON,
                                         max_buckets=max_buckets)
    assert len(tbk) == len(jbk) == max_buckets
    for (gi, gs, gp), (wi, ws, wp) in zip(tbk, jbk):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        _assert_sub_equal(gs, ws)
        assert type(gp).__name__ == type(wp).__name__
    T = tb.n_time
    scale = float(tb.y.abs().max())
    _assert_result_close(tr, jr, model, scale, T)
    assert not tr.ok.numpy().all()  # the 10-day series fell back
    # the rows before each bucket's window repeat its first value
    for idx, sub, _ in tbk:
        lead = T - sub.n_time
        for k in ("yhat", "lo", "hi"):
            M = getattr(tr, k)[torch.as_tensor(idx)]
            assert torch.equal(M[:, :lead], M[:, lead:lead + 1].expand(-1, lead))


@pytest.mark.parametrize("xreg", ["shared", "per_series"])
def test_fit_forecast_bucketed_with_regressors_matches_reference(batches,
                                                                 xreg):
    jb, tb = batches
    jc, tc = _configs("prophet")
    jc = dataclasses.replace(jc, n_regressors=1)
    tc = dataclasses.replace(tc, n_regressors=1)
    S, T = tb.y.shape
    rng = np.random.default_rng(6)
    shape = (T + HORIZON, 1) if xreg == "shared" else (S, T + HORIZON, 1)
    x = rng.normal(size=shape).astype(np.float32)
    _, jr = jfit.fit_forecast_bucketed(jb, model="prophet", config=jc,
                                       horizon=HORIZON, xreg=x, autoprep=False)
    tbk, tr = tfit.fit_forecast_bucketed(tb, config=tc, horizon=HORIZON,
                                         xreg=torch.from_numpy(x))
    _assert_result_close(tr, jr, "prophet", float(tb.y.abs().max()), T)
    if xreg == "shared":
        # each bucket's fit standardized the tail of the window it saw
        for _, sub, p in tbk:
            np.testing.assert_allclose(p.reg_mu[0].numpy(),
                                       x[T - sub.n_time:T].mean(0),
                                       rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="history \\+ horizon"):
        tfit.fit_forecast_bucketed(tb, config=tc, horizon=HORIZON,
                                   xreg=torch.zeros(T, 1))


@pytest.fixture(scope="module")
def bucket_fits(batches):
    jb, tb = batches
    jc, tc = _configs("prophet")
    jbk, _ = jfit.fit_forecast_bucketed(jb, model="prophet", config=jc,
                                        horizon=HORIZON, autoprep=False)
    tbk, _ = tfit.fit_forecast_bucketed(tb, config=tc, horizon=HORIZON)
    return (JBucketed.from_bucketed_fit(jbk, "prophet", jc),
            BucketedForecaster.from_bucketed_fit(tbk, "prophet", tc))


def _request(keys):
    return pd.DataFrame(np.asarray(keys), columns=["store", "item"])


# one series of each bucket (the 10-day one included), in scrambled order
SPAN_KEYS = [(2, 7), (1, 1), (2, 8), (1, 4), (2, 2)]


def _assert_frames_match(got, want, scale, cols):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in ("ds", "store", "item"):
        np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy())
    for col in cols:
        np.testing.assert_allclose(got[col].to_numpy(dtype=float),
                                   want[col].to_numpy(dtype=float),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=col)


def test_artifacts_load_across_packages(bucket_fits, batches, tmp_path):
    """Each package's buckets.json artifact loads in the other and serves
    the same frames; both write the same files."""
    jfc, tfc = bucket_fits
    scale = float(batches[1].y.abs().max())
    req = _request(SPAN_KEYS)
    jfc.save(str(tmp_path / "ref"))
    tfc.save(str(tmp_path / "port"))
    files = {k: sorted(os.path.relpath(os.path.join(d, f), tmp_path / k)
                       for d, _, fs in os.walk(tmp_path / k) for f in fs)
             for k in ("ref", "port")}
    assert files["ref"] == files["port"]
    assert "buckets.json" in files["port"]

    port_of_ref = tloader.load_forecaster(str(tmp_path / "ref"), device="cpu")
    assert isinstance(port_of_ref, BucketedForecaster)
    assert port_of_ref.n_series == jfc.n_series == batches[1].n_series
    _assert_frames_match(port_of_ref.predict(req, horizon=HORIZON),
                         jfc.predict(req, horizon=HORIZON), scale,
                         ("yhat", "yhat_upper", "yhat_lower"))
    _assert_frames_match(
        port_of_ref.predict_quantiles(req, horizon=HORIZON,
                                      include_history=True),
        jfc.predict_quantiles(req, horizon=HORIZON, include_history=True),
        scale, ("q0.1", "q0.5", "q0.9"))

    ref_of_port = JBucketed.load(str(tmp_path / "port"))
    _assert_frames_match(tfc.predict(req, horizon=HORIZON),
                         ref_of_port.predict(req, horizon=HORIZON), scale,
                         ("yhat", "yhat_upper", "yhat_lower"))


def test_request_routes_one_predict_per_bucket(bucket_fits, monkeypatch):
    _, fc = bucket_fits
    calls = []
    orig = tpred.BatchForecaster.predict

    def spy(self, request, **kw):
        calls.append(len(request))
        return orig(self, request, **kw)

    monkeypatch.setattr(tpred.BatchForecaster, "predict", spy)
    req = _request(SPAN_KEYS + [(1, 2), (2, 3)])
    out = fc.predict(req, horizon=HORIZON)
    # 7 series over the 4 buckets: one predict per bucket, never per series
    assert sorted(calls) == [1, 1, 1, 4]
    assert len(out) == 7 * HORIZON
    assert set(map(tuple, out[["store", "item"]].drop_duplicates()
                   .to_numpy().tolist())) == set(SPAN_KEYS + [(1, 2), (2, 3)])


def test_unknown_keys_raise_or_skip(bucket_fits):
    jfc, fc = bucket_fits
    unknown = _request([(9, 9)])
    with pytest.raises(tpred.UnknownSeriesError):
        fc.predict(unknown)
    assert fc.predict(unknown, on_missing="skip").empty
    assert list(fc.predict(unknown, on_missing="skip").columns) == list(
        jfc.predict(unknown, on_missing="skip").columns)
    with pytest.raises(ValueError, match="on_missing"):
        fc.predict(unknown, on_missing="Raise")
    with pytest.raises(KeyError, match="key column"):
        fc.predict(pd.DataFrame({"store": [1]}))


def test_warmup_counts_the_references_buckets(bucket_fits):
    jfc, fc = bucket_fits
    assert fc.warmup(horizon=HORIZON, sizes=(3,)) == jfc.warmup(
        horizon=HORIZON, sizes=(3,))


def test_shared_regressor_calendar_is_served_per_bucket(batches):
    """A shared (T, R) calendar over the union grid is sliced to each
    bucket's window, as the reference slices it."""
    jb, tb = batches
    jc, tc = _configs("prophet")
    jc = dataclasses.replace(jc, n_regressors=1)
    tc = dataclasses.replace(tc, n_regressors=1)
    T = tb.n_time
    x = np.random.default_rng(4).normal(size=(T + HORIZON, 1)).astype(
        np.float32)
    jbk, _ = jfit.fit_forecast_bucketed(jb, model="prophet", config=jc,
                                        horizon=HORIZON, xreg=x,
                                        autoprep=False)
    jfc = JBucketed.from_bucketed_fit(jbk, "prophet", jc)
    tbk, _ = tfit.fit_forecast_bucketed(tb, config=tc, horizon=HORIZON,
                                        xreg=torch.from_numpy(x))
    tfc = BucketedForecaster.from_bucketed_fit(tbk, "prophet", tc)
    req = _request(SPAN_KEYS)
    got = tfc.predict(req, horizon=HORIZON, xreg=torch.from_numpy(x))
    want = jfc.predict(req, horizon=HORIZON, xreg=x)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got["ds"].to_numpy(), want["ds"].to_numpy())
    for col in ("yhat", "yhat_upper", "yhat_lower"):
        _assert_rows_close(got[col].to_numpy().reshape(len(SPAN_KEYS), -1),
                           want[col].to_numpy().reshape(len(SPAN_KEYS), -1))
    with pytest.raises(ValueError, match="union grid"):
        tfc.predict(req, horizon=HORIZON, xreg=torch.zeros(T + HORIZON + 1, 1))
    with pytest.raises(ValueError, match="shared"):
        tfc.predict(req, horizon=HORIZON,
                    xreg=torch.zeros(tb.n_series, T + HORIZON, 1))
