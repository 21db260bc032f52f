"""Port parity: the curve model's design matrix (``ops/features``) and the
holiday calendars (``data/holidays``) against the JAX reference.

The reference builds its design inside ``jit`` (``fit``/``forecast``), so it
is called jitted here.  Columns that are exact in float32 — intercept,
scaled time, hinges, holiday indicators, the layout — are bitwise equal.
The Fourier columns' float32 angles are bitwise equal too (the port repeats
XLA's multiplication by the period's reciprocal); their ``sin``/``cos``
differ by ~1 ulp, so they are held within atol 1e-6 (values in [-1, 1]).
Holiday specs are host-side and equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu.data import holidays as jhol
from distributed_forecasting_tpu.ops import features as jf
from distributed_forecasting_tpu_torch.data import holidays as thol
from distributed_forecasting_tpu_torch.ops import features as tf

torch.set_num_threads(1)

DAY0, T, H = 15706, 400, 30  # 2013-01-01, 400 days of history
DAY = np.arange(DAY0, DAY0 + T + H, dtype=np.int32)
HOL = jhol.us_holiday_spec_for_range("2013-01-01", "2014-03-06")
FOURIER_ATOL = 1e-6

CASES = {
    "default": dict(),
    "holidays": dict(holidays=HOL),
    "extra_seasonalities": dict(extra_seasonalities=(("monthly", 30.5, 5),
                                                     ("quarterly", 91.3, 2))),
    "changepoint_days": dict(changepoint_days=(DAY0 + 40, DAY0 + 150,
                                               DAY0 + 301)),
    "orders": dict(weekly_order=0, yearly_order=4, n_changepoints=10,
                   changepoint_range=0.9),
}


@partial(jax.jit, static_argnames=("kw",))
def _reference_design(day, kw):
    X, layout = jf.curve_design_matrix(day, day[0].astype(jnp.float32),
                                       day[T - 1].astype(jnp.float32),
                                       **dict(kw))
    return X, layout["changepoint_grid"]


def _reference_layout(kw):
    _, layout = jf.curve_design_matrix(jnp.asarray(DAY), float(DAY0),
                                       float(DAY0 + T - 1), **kw)
    return layout


def _fourier_columns(layout):
    cols = np.zeros(layout["n_features"], bool)
    for k in ("weekly", "yearly", "extra_seas"):
        cols[layout[k]] = True
    return cols


@pytest.mark.parametrize("case", list(CASES))
def test_design_matrix_matches_reference(case):
    kw = CASES[case]
    Xj, sj = _reference_design(jnp.asarray(DAY), tuple(kw.items()))
    Xj = np.asarray(Xj)
    day = torch.from_numpy(DAY)
    Xt, lt = tf.curve_design_matrix(day, day[0].float(), day[T - 1].float(), **kw)
    lj = _reference_layout(kw)
    assert {k: v for k, v in lt.items() if k != "changepoint_grid"} == {
        k: v for k, v in lj.items() if k != "changepoint_grid"}
    np.testing.assert_array_equal(lt["changepoint_grid"].numpy(), np.asarray(sj))
    Xt = Xt.numpy()
    assert Xt.shape == Xj.shape == (T + H, lj["n_features"])
    four = _fourier_columns(lj)
    np.testing.assert_array_equal(Xt[:, ~four], Xj[:, ~four])
    np.testing.assert_allclose(Xt[:, four], Xj[:, four], rtol=0,
                               atol=FOURIER_ATOL)


@pytest.mark.parametrize("period,order", [(7.0, 3), (365.25, 10), (30.5, 5)])
def test_fourier_angles_and_values(period, order):
    """The columns at the extreme angles of absolute epoch days (~1e5 rad at
    yearly order 10): the angles as the reference's jitted program forms
    them, so the values differ only by sin/cos rounding."""
    f = jax.jit(jf.fourier_features, static_argnums=(1, 2))
    want = np.asarray(f(jnp.asarray(DAY), period, order))
    got = tf.fourier_features(torch.from_numpy(DAY), period, order).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FOURIER_ATOL)


def test_scaled_time_and_hinges_equal():
    day = torch.from_numpy(DAY)
    t = tf.scaled_time(day, float(DAY0), float(DAY0 + T - 1))
    tj = jax.jit(jf.scaled_time)(jnp.asarray(DAY), jnp.float32(DAY0),
                                 jnp.float32(DAY0 + T - 1))
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    A, s = tf.changepoint_features(t, 25, 0.8)
    Aj, sj = jax.jit(jf.changepoint_features, static_argnums=(1, 2))(tj, 25, 0.8)
    np.testing.assert_array_equal(A.numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_holiday_columns_and_regressors():
    day = torch.from_numpy(DAY)
    np.testing.assert_array_equal(
        tf.holiday_features(day, HOL).numpy(),
        np.asarray(jf.holiday_features(jnp.asarray(DAY), HOL)))
    cond = (np.arange(T + H) % 3 == 0)
    np.testing.assert_allclose(
        tf.conditional_seasonality_columns(day, 7.0, 2, cond).numpy(),
        np.asarray(jax.jit(jf.conditional_seasonality_columns,
                           static_argnums=(1, 2, 3))(jnp.asarray(DAY), 7.0, 2,
                                                     tuple(cond))),
        rtol=0, atol=FOURIER_ATOL)
    with pytest.raises(ValueError, match="boolean"):
        tf.conditional_seasonality_columns(day, 7.0, 2, cond * 0.5)
    X, layout = tf.curve_design_matrix(day, float(DAY0), float(DAY0 + T - 1))
    xreg = torch.ones(3, T + H, 2)
    Xr, lr = tf.with_regressors(X, layout, xreg)
    assert Xr.shape == (3, T + H, layout["n_features"] + 2)
    assert lr["regressors"] == slice(layout["n_features"], lr["n_features"])
    _, lj = jf.with_regressors(jnp.asarray(X.numpy()), _reference_layout({}),
                               jnp.ones((3, T + H, 2)))
    assert lr["regressors"] == lj["regressors"]


@pytest.mark.parametrize("kw", [
    dict(start="2013-01-01", end="2018-03-31"),
    dict(start="2016-12-01", end="2017-01-31", lower_window=1, upper_window=2),
    dict(start="2015-01-01", end="2015-12-31", calendar="none",
         custom={"promo": ["2015-11-27", "2015-12-26"]}),
    dict(start="2015-01-01", end="2015-12-31", calendar="US",
         custom={"promo": "2015-11-27"}),
])
def test_holiday_specs_equal_reference(kw):
    assert thol.holiday_spec_for_range(**kw) == jhol.holiday_spec_for_range(**kw)


def test_holiday_calendar_errors_match_reference():
    for bad in (dict(calendar="XX"), dict(custom={"christmas": ["2015-01-02"]}),
                dict(custom={"x": ["not a date"]})):
        with pytest.raises(ValueError) as want:
            jhol.holiday_spec_for_range("2015-01-01", "2015-12-31", **bad)
        with pytest.raises(ValueError) as got:
            thol.holiday_spec_for_range("2015-01-01", "2015-12-31", **bad)
        assert str(got.value) == str(want.value)
    years = range(2013, 2019)
    assert thol.us_federal_holidays(years) == jhol.us_federal_holidays(years)
    assert thol.us_holiday_spec_for_range(pd.Timestamp("2013-01-01"),
                                          "2014-03-06") == HOL
