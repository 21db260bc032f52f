"""Port parity: season detection (``season_length: auto``) against the JAX
reference — the masked ACF of the differenced series by FFT, the detected
period, and the per-cadence default of the training pipeline.

The ACF scores agree within atol 1e-6 (they are correlations, in [-1, 1]):
XLA's CPU FFT and PyTorch's pocketfft round the float32 transforms
differently (on these inputs by at most 1.2e-7, a few float32 ulps of the
lag-0 normaliser); the 6-MAD clip and the mean divide the same way in
both.  The detected period must be equal.  The period selection itself is host numpy in both packages,
so it is held to equal answers on the same score vector.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import season as jseason
from distributed_forecasting_tpu.pipelines import training as jtraining
from distributed_forecasting_tpu_torch.engine import season as tseason
from distributed_forecasting_tpu_torch.pipelines import training as ttraining

torch.set_num_threads(1)

ATOL = 1e-6
S, T = 12, 400


def _batch(period, seed=0, intermittent=False, spikes=False):
    """(S, T) whole-number series: level + trend + a cycle of ``period``
    days (none when 0) + noise, 5% of days masked."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    y = rng.uniform(20, 60, (S, 1)) + 0.02 * t + rng.normal(0, 2, (S, T))
    if period:
        y = y + rng.uniform(4, 10, (S, 1)) * np.sin(2 * np.pi * t / period)
    if intermittent:
        # demand on one weekday in seven, zero otherwise: the median
        # |diff| is 0, so the 6-MAD winsorising must leave it unclipped
        y = np.where((t % 7 == 3)[None] & (rng.random((S, T)) < 0.9),
                     np.round(rng.uniform(2, 9, (S, T))), 0.0)
    if spikes:
        y = y + np.where(rng.random((S, T)) < 0.03, 40 * y, 0.0)
    mask = (rng.random((S, T)) > 0.05).astype(np.float32)
    y = np.round(np.maximum(y, 0.0)).astype(np.float32) * mask
    return y, mask


def _scores(y, mask, max_lag):
    want = np.asarray(jseason.acf_scores_impl(jnp.asarray(y),
                                              jnp.asarray(mask), max_lag))
    got = tseason.acf_scores_impl(torch.from_numpy(y), torch.from_numpy(mask),
                                  max_lag).numpy()
    return got, want


@pytest.mark.parametrize("period, expect", [(7, 7), (30, 30), (0, None)],
                         ids=["weekly", "monthly", "none"])
def test_scores_and_period_match_reference(period, expect):
    y, mask = _batch(period, seed=period)
    max_lag = tseason.clamp_max_lag(400, T)
    assert max_lag == jseason.clamp_max_lag(400, T) == T // 3
    got, want = _scores(y, mask, max_lag)
    assert got.shape == want.shape == (max_lag + 1,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    p_got = tseason.select_period(got, max_lag)
    p_want = jseason.select_period(want, max_lag)
    assert p_got == p_want
    if expect is not None:
        assert p_got == expect
    else:
        assert p_got == 7  # nothing passes the comb gate: the default


def test_intermittent_series_is_not_clipped():
    y, mask = _batch(0, seed=3, intermittent=True)
    dy = torch.from_numpy(y[:, 1:] - y[:, :-1])
    dm = torch.from_numpy(mask[:, 1:] * mask[:, :-1])
    from distributed_forecasting_tpu_torch.ops.solve import masked_mad_scale

    assert float(masked_mad_scale(dy, dm).max()) == 0.0  # median |diff| 0
    r_got, ne_got = tseason.acf_scores_per_series(
        torch.from_numpy(y), torch.from_numpy(mask), 60)
    r_want, ne_want = jseason.acf_scores_per_series(
        jnp.asarray(y), jnp.asarray(mask), 60)
    np.testing.assert_allclose(r_got.numpy(), np.asarray(r_want), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(ne_got.numpy(), np.asarray(ne_want))
    # the spikes are the signal: a strong weekly peak survives
    assert float(r_got[:, 7].mean()) > 0.3
    assert tseason.select_period(r_got.mean(0).numpy(), 60) == 7


def test_spiky_monthly_batch_is_winsorised_alike():
    y, mask = _batch(30, seed=5, spikes=True)
    got, want = _scores(y, mask, T // 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert tseason.select_period(got, T // 3) == jseason.select_period(
        want, T // 3)


def test_select_period_matches_reference_on_edge_inputs():
    rng = np.random.default_rng(9)
    for max_lag in (3, 4, 7, 40, 133):
        raw = rng.normal(0, 0.3, max_lag + 1)
        raw[0] = 1.0
        for min_score in (0.0, 0.1, 5.0):
            assert tseason.select_period(raw, max_lag, min_score=min_score) == \
                jseason.select_period(raw, max_lag, min_score=min_score)
    assert tseason.select_period(np.ones(3), 10) == 7  # too short a vector


def _frame(y, mask, freq):
    dates = pd.date_range("2015-01-04", periods=y.shape[1], freq={
        "D": "D", "W": "W-SUN", "M": "MS"}[freq])
    rows = []
    for s in range(y.shape[0]):
        keep = mask[s] > 0
        rows.append(pd.DataFrame({"date": dates[keep], "store": 1,
                                  "item": s + 1, "sales": y[s, keep]}))
    return pd.concat(rows, ignore_index=True)


@pytest.mark.parametrize("freq, period, expect", [
    ("D", 7, 7), ("D", 0, 7), ("W", 0, 52), ("M", 0, 12)],
    ids=["daily", "daily_flat", "weekly_default", "monthly_default"])
def test_cadence_defaults_match_reference(freq, period, expect):
    """``season_length: auto`` through each pipeline's conf resolution: a
    batch with no detectable period falls back to the grid's own yearly
    cycle (7 days, 52 weeks, 12 months)."""
    y, mask = _batch(period, seed=11)
    df = _frame(y, mask, freq)
    conf = {"season_length": "auto", "n_alpha": 3}
    jb = jdata.tensorize(df, freq=freq)
    tb = tdata.tensorize(df, freq=freq, device="cpu")
    want = jtraining._resolve_season_conf(conf, jb)
    got = ttraining._resolve_model_conf("holt_winters", conf, tb, 30)
    assert got == want == {"season_length": expect, "n_alpha": 3}
    # other values pass through untouched
    assert ttraining._resolve_model_conf(
        "holt_winters", {"season_length": 12}, tb, 30) == {"season_length": 12}


def test_short_batch_takes_the_default():
    y, mask = _batch(7, seed=2)
    tb = tdata.tensorize(_frame(y[:, :11], mask[:, :11], "D"), device="cpu")
    jb = jdata.tensorize(_frame(y[:, :11], mask[:, :11], "D"))
    assert tseason.detect_season_length(tb, default=9) == \
        jseason.detect_season_length(jb, default=9) == 9
