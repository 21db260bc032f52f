"""The port's Prophet MAP oracle (``models/prophet_map.py``) against the
reference's.

Both are the same float64 numpy / scipy program (the port keeps its own
copy: it imports nothing of the reference), so on the same inputs in one
process every output is bitwise the reference's: the objective and its
gradient, ``fit_map``'s parameters, ``predict``'s forecasts,
``cv_cutoff_days`` and ``cv_mape``.  The inputs: three seeded synthetic
series of the oracle's own family and one series of the committed
dataset cut to its first 800 days (too short for the default 730 / 360 /
90 protocol, which both refuse alike; its CV runs at 365 / 180 / 90).
"""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest

from distributed_forecasting_tpu.models import prophet_map as ref
from distributed_forecasting_tpu_torch.models import prophet_map as pm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "datasets", "store_item_demand.csv.gz")
SHORT_CV = dict(initial=365, period=180, horizon=90)


def _synthetic(seed: int, T: int = 1100):
    """The reference tests' series family: multiplicative weekly and yearly
    seasonality on a trend with one slope change, lognormal noise."""
    rng = np.random.default_rng(seed)
    day = np.arange(T, dtype=np.float64) + 10957 + 37 * seed
    t = np.arange(T)
    base = 50 + 0.02 * t + 0.0006 * np.maximum(t - 500 - 40 * seed, 0)
    season = (1 + 0.25 * np.sin(2 * np.pi * t / 7)
              + 0.15 * np.sin(2 * np.pi * t / 365.25))
    return day, base * season * np.exp(rng.normal(0, 0.03 * (seed + 1), T))


def _real(days: int = 800):
    """Store 1, item 1 of the committed dataset, its first ``days`` days,
    as ``scripts/prophet_parity.oracle_cv_mape`` reads a series."""
    df = pd.read_csv(DATA)
    sub = df[(df["store"] == 1) & (df["item"] == 1)].sort_values("date")
    sub = sub.head(days)
    day = (pd.to_datetime(sub["date"]) - pd.Timestamp("1970-01-01")
           ).dt.days.to_numpy(np.float64)
    return day, sub["sales"].to_numpy(np.float64)


SERIES = {"synthetic_0": lambda: _synthetic(0),
          "synthetic_1": lambda: _synthetic(1),
          "synthetic_2": lambda: _synthetic(2),
          "real_800": _real}


def _assert_params_equal(got, want) -> None:
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_the_config_is_the_reference_s():
    assert dataclasses.asdict(pm.ProphetMAPConfig()) == dataclasses.asdict(
        ref.ProphetMAPConfig())


def test_objective_and_gradient_are_bitwise_the_reference_s():
    day, y = _synthetic(0, T=240)
    cfg = pm.ProphetMAPConfig(yearly_order=2, weekly_order=2,
                              n_changepoints=5)
    t = (day - day[0]) / (day[-1] - day[0])
    tc = pm._changepoints(t, cfg)
    assert np.array_equal(tc, ref._changepoints(t, cfg))
    X = pm._design(day, cfg)
    assert np.array_equal(X, ref._design(day, cfg))
    A = (t[:, None] >= tc[None, :]).astype(np.float64)
    y_s = y / np.abs(y).max()
    theta = np.random.default_rng(3).normal(0, 0.1, 2 + len(tc)
                                            + X.shape[1] + 1)
    mine = pm._objective_fn(t, A, A * tc[None, :], X, y_s, 0.05, 10.0,
                            0.5)(theta)
    theirs = ref._objective_fn(t, A, A * tc[None, :], X, y_s, 0.05, 10.0,
                               0.5)(theta)
    assert mine[0] == theirs[0] and np.array_equal(mine[1], theirs[1])


@pytest.mark.parametrize("name", sorted(SERIES))
def test_fit_and_predict_are_bitwise_the_reference_s(name):
    day, y = SERIES[name]()
    fit, hold = slice(0, len(day) - 90), slice(len(day) - 90, None)
    mine = pm.fit_map(day[fit], y[fit])
    theirs = ref.fit_map(day[fit], y[fit])
    _assert_params_equal(mine, theirs)
    for part in (day[fit], day[hold], day[-1] + np.arange(1.0, 31.0)):
        got, want = pm.predict(mine, part), ref.predict(theirs, part)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got, want)
    assert np.isfinite(pm.predict(mine, day[hold])).all()


@pytest.mark.parametrize("name", sorted(SERIES))
def test_cv_is_bitwise_the_reference_s(name):
    day, y = SERIES[name]()
    if name == "real_800":
        # 800 days: short of 730 + 90, refused alike by both
        for mod in (pm, ref):
            with pytest.raises(ValueError, match="too short"):
                mod.cv_cutoff_days(day)
        cv = SHORT_CV
    else:
        cv = {}
    cuts = pm.cv_cutoff_days(day, **cv)
    assert np.array_equal(cuts, ref.cv_cutoff_days(day, **cv))
    assert cuts.size >= 1
    got = pm.cv_mape(day, y, **cv)
    assert got == ref.cv_mape(day, y, **cv)
    assert np.isfinite(got) and got > 0
