"""Port parity: ``fit_forecast_chunked``, the memory-bounded fit of the
50k-series regime, at 16 series x 400 days in chunks of 5 (four chunks, the
last padded with 4 masked rows), under both dispatches.

Against the port's own unchunked ``fit_forecast`` the chunked results are
bitwise equal: every row's fit is arithmetic on that row alone, so the
chunk it lands in does not change it.  Against the JAX reference's
``fit_forecast_chunked`` (its ``'scan'`` one compiled ``lax.scan``, its
``'loop'`` a host loop) they agree within the tolerances of
test_torch_engine.py: 1e-5 of the data's scale for Holt-Winters, 2e-4 of
each row's scale for the curve model (its float32 normal equations; here
without yearly terms, a 365-day wave over 400 days being nearly collinear
with the trend).  The params' fields have the reference's shapes: the
per-series ones cut to S, the shared ones (the curve model's 0-d t0 / t1,
its empty AR fields) taken from one chunk.
"""

import dataclasses

import numpy as np
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.models import prophet_glm as jpg
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.models import prophet_glm as tpg

torch.set_num_threads(1)

HORIZON = 30
CHUNK = 5
CURVE_RTOL = 2e-4


@pytest.fixture(scope="module")
def batches():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=8, n_days=400,
                                          seed=21, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    return jdata.tensorize(df), tdata.tensorize(df, device="cpu")


def _configs(model, R=0):
    if model == "holt_winters":
        # the reference scans: its Pallas route is bitwise the same fit
        return (jhw.HoltWintersConfig(filter="scan"),
                thw.HoltWintersConfig(filter="pallas"))
    return (jpg.CurveModelConfig(yearly_order=0, n_regressors=R),
            tpg.CurveModelConfig(yearly_order=0, n_regressors=R))


def _assert_close(got, want, model, scale):
    if model == "holt_winters":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
        return
    rows = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_array_less(
        np.abs(got - want), np.broadcast_to(CURVE_RTOL * rows + 1e-6,
                                            want.shape))


def _assert_results_equal(a, b):
    for k in ("yhat", "lo", "hi", "ok", "day_all"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("dispatch", ["scan", "loop"])
@pytest.mark.parametrize("model", ["prophet", "holt_winters"])
def test_chunked_equals_unchunked_and_matches_reference(batches, model,
                                                        dispatch):
    jb, tb = batches
    jc, tc = _configs(model)
    tp, tr = tfit.fit_forecast_chunked(tb, model=model, config=tc,
                                       horizon=HORIZON, chunk_size=CHUNK,
                                       dispatch=dispatch)
    up, ur = tfit.fit_forecast(tb, model=model, config=tc, horizon=HORIZON)
    _assert_results_equal(tr, ur)
    for f in dataclasses.fields(up):
        assert torch.equal(getattr(tp, f.name), getattr(up, f.name)), f.name

    jp, jr = jfit.fit_forecast_chunked(jb, model=model, config=jc,
                                       horizon=HORIZON, chunk_size=CHUNK,
                                       dispatch=dispatch, autoprep=False)
    for f in dataclasses.fields(tp):
        assert tuple(getattr(tp, f.name).shape) == tuple(
            np.shape(getattr(jp, f.name))), f.name
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    np.testing.assert_array_equal(tr.day_all.numpy(), np.asarray(jr.day_all))
    ok = tr.ok.numpy()
    scale = float(tb.y.abs().max())
    for k in ("yhat", "lo", "hi"):
        _assert_close(getattr(tr, k).numpy()[ok],
                      np.asarray(getattr(jr, k))[ok], model, scale)


@pytest.mark.parametrize("xreg", ["shared", "per_series"])
def test_chunked_with_regressors(batches, xreg):
    jb, tb = batches
    jc, tc = _configs("prophet", R=2)
    S, T = tb.y.shape
    shape = (T + HORIZON, 2) if xreg == "shared" else (S, T + HORIZON, 2)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    tp, tr = tfit.fit_forecast_chunked(tb, config=tc, horizon=HORIZON,
                                       chunk_size=CHUNK,
                                       xreg=torch.from_numpy(x))
    _, ur = tfit.fit_forecast(tb, config=tc, horizon=HORIZON,
                              xreg=torch.from_numpy(x))
    _assert_results_equal(tr, ur)
    assert tp.reg_mu.shape == (S, 2)
    _, jr = jfit.fit_forecast_chunked(jb, model="prophet", config=jc,
                                      horizon=HORIZON, chunk_size=CHUNK,
                                      xreg=x, autoprep=False)
    ok = tr.ok.numpy()
    for k in ("yhat", "lo", "hi"):
        _assert_close(getattr(tr, k).numpy()[ok],
                      np.asarray(getattr(jr, k))[ok], "prophet", 0.0)
    with pytest.raises(ValueError, match="history \\+ horizon"):
        tfit.fit_forecast_chunked(tb, config=tc, horizon=HORIZON,
                                  chunk_size=CHUNK,
                                  xreg=torch.from_numpy(x)[..., :T, :])


def test_chunked_refuses_an_unknown_dispatch(batches):
    _, tb = batches
    with pytest.raises(ValueError, match="dispatch"):
        tfit.fit_forecast_chunked(tb, horizon=HORIZON, chunk_size=CHUNK,
                                  dispatch="vmap")


def test_one_chunk_is_the_plain_fit(batches):
    _, tb = batches
    _, tc = _configs("holt_winters")
    _, a = tfit.fit_forecast_chunked(tb, "holt_winters", config=tc,
                                     horizon=HORIZON, chunk_size=tb.n_series)
    _, b = tfit.fit_forecast(tb, "holt_winters", config=tc, horizon=HORIZON)
    _assert_results_equal(a, b)
