"""Port parity: the budgeted cross-family successive-halving sweep
(``engine/select.successive_halving_select``) and its conf block's install
(``engine/hyper.configure_automl`` / ``automl_config``), against the JAX
reference on the same data.

What is compared: the rungs (family, rung, ``n_series``, ``n_cutoffs`` of
every leaderboard row, in order), the survivors, the budget gate's outcome
and the final assignment.  The seconds are each package's own wall clock
and are not compared.  Rung means are compared within 1e-4 relative: each
is a mean of float32 smape values of fits that agree within float32
rounding (``tests/test_torch_theta.py``, ``test_torch_croston.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.data.tensorize import SeriesBatch as JBatch
from distributed_forecasting_tpu.engine import hyper as jhyper
from distributed_forecasting_tpu.engine import select as jselect
from distributed_forecasting_tpu.engine.cv import CVConfig as JCV
from distributed_forecasting_tpu_torch.data.tensorize import (
    SeriesBatch as TBatch,
)
from distributed_forecasting_tpu_torch.engine import hyper as thyper
from distributed_forecasting_tpu_torch.engine import select as tselect
from distributed_forecasting_tpu_torch.engine.cv import CVConfig as TCV

torch.set_num_threads(1)

T = 400
CV = dict(initial=200, period=60, horizon=30)
COLUMNS = ["family", "rung", "n_series", "n_cutoffs"]


def _mixed(n_series, seed):
    """The reference test's separable pair: smooth weekly-seasonal series
    (theta territory), which croston's flat level misspecifies."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    y = (50.0 + 0.02 * t[None, :]
         + 8.0 * np.sin(2 * np.pi * t / 7 + rng.uniform(0, 6, (n_series, 1)))
         + 1.5 * rng.normal(size=(n_series, T))).astype(np.float32)
    mask = np.ones((n_series, T), np.float32)
    day = np.arange(T, dtype=np.float32)
    keys = np.array([f"s{i}" for i in range(n_series)])
    common = dict(keys=keys, key_names=("id",), start_date="2020-01-01",
                  freq="D")
    return (JBatch(y=jnp.asarray(y), mask=jnp.asarray(mask),
                   day=jnp.asarray(day), **common),
            TBatch(y=torch.from_numpy(y), mask=torch.from_numpy(mask),
                   day=torch.from_numpy(day), **common))


def _both(jb, tb, **cfg):
    jres = jselect.successive_halving_select(
        jb, config=jhyper.AutoMLConfig(**cfg), cv=JCV(**CV))
    tres = tselect.successive_halving_select(
        tb, config=thyper.AutoMLConfig(**cfg), cv=TCV(**CV))
    return jres, tres


def _same_rungs(jres, tres):
    got = tres.leaderboard[COLUMNS].astype(str).values.tolist()
    want = jres.leaderboard[COLUMNS].astype(str).values.tolist()
    assert got == want
    np.testing.assert_allclose(tres.leaderboard["mean_smape"].to_numpy(),
                               jres.leaderboard["mean_smape"].to_numpy(),
                               rtol=1e-4)


def test_rung_ranking_matches_full_selection():
    """The reference's test on both packages: rung 0 (a 4-series subset,
    the last cutoff) ranks the separable pair as the full selection does,
    theta first; then the survivors' full pass assigns per series."""
    jb, tb = _mixed(8, seed=7)
    cfg = dict(enabled=True, families=("theta", "croston"), rungs=2,
               base_series=4, base_cutoffs=1, budget_device_seconds=600.0)
    jres, tres = _both(jb, tb, **cfg)
    assert not tres.budget_exhausted and not jres.budget_exhausted
    assert tres.survivors == jres.survivors == ("theta",)
    _same_rungs(jres, tres)

    board = tres.leaderboard
    rung0 = board[board.rung == 0]
    assert rung0.n_series.tolist() == [4, 4]
    assert rung0.n_cutoffs.tolist() == [1, 1]
    rank_rung = rung0.sort_values("mean_smape").family.tolist()
    full = tselect.select_model(tb, models=("theta", "croston"), cv=TCV(**CV))
    rank_full = full.scores.mean(axis=0).sort_values().index.tolist()
    assert rank_rung == rank_full == ["theta", "croston"]

    np.testing.assert_array_equal(tres.selection.chosen,
                                  jres.selection.chosen)
    assert tres.selection.counts().get("theta", 0) >= 6
    assert tres.spent_device_seconds > 0.0
    assert board.cumulative_device_seconds.is_monotonic_increasing


def test_budget_gate_halts_launches():
    """A 1e-6 s budget closes the gate after the first evaluation: at most
    one row per family, the best-so-far family broadcast uniformly."""
    jb, tb = _mixed(6, seed=8)
    cfg = dict(enabled=True, families=("theta", "croston"), rungs=3,
               base_series=4, base_cutoffs=1, budget_device_seconds=1e-6)
    jres, tres = _both(jb, tb, **cfg)
    assert tres.budget_exhausted and jres.budget_exhausted
    assert len(tres.leaderboard) <= len(cfg["families"])
    _same_rungs(jres, tres)
    assert len(set(tres.selection.chosen.tolist())) == 1
    assert tres.selection.assignment.shape == (6,)
    np.testing.assert_array_equal(tres.selection.chosen,
                                  jres.selection.chosen)
    assert tres.survivors == jres.survivors


def test_rung_helpers_match_reference():
    """The rung subset (strided rows) and the last-cutoffs CV variant."""
    jb, tb = _mixed(10, seed=1)
    for n_sub in (3, 4, 10, 16):
        sub_t = tselect._rung_subset(tb, n_sub)
        sub_j = jselect._rung_subset(jb, n_sub)
        np.testing.assert_array_equal(sub_t.y.numpy(), np.asarray(sub_j.y))
        np.testing.assert_array_equal(sub_t.keys, sub_j.keys)
    for n in (1, 2, 3, 8):
        got = tselect._rung_cv(TCV(**CV), T, n)
        want = jselect._rung_cv(JCV(**CV), T, n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_configure_automl_round_trips():
    """``configure_automl`` takes a conf block or a config and installs it
    process-wide, as the reference's does; bad blocks raise its errors."""
    try:
        block = {"enabled": True, "families": ["theta", "croston"],
                 "rungs": 2, "budget_device_seconds": 5.0}
        got = thyper.configure_automl(block)
        want = jhyper.AutoMLConfig.from_conf(block)
        assert thyper.automl_config() is got
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        cfg = thyper.AutoMLConfig(eta=3)
        assert thyper.configure_automl(cfg) is cfg
        assert thyper.automl_config().eta == 3
        for bad in ({"eta": 1}, {"budget_device_secs": 1.0}):
            with pytest.raises(ValueError) as want_err:
                jhyper.AutoMLConfig.from_conf(bad)
            with pytest.raises(ValueError) as got_err:
                thyper.configure_automl(bad)
            assert str(got_err.value) == str(want_err.value)
    finally:
        thyper.configure_automl(thyper.AutoMLConfig())
    assert thyper.automl_config() == thyper.AutoMLConfig()


def test_sweep_reads_the_installed_block():
    """With no ``config`` the sweep reads the process-wide block."""
    _, tb = _mixed(6, seed=8)
    try:
        thyper.configure_automl({"families": ["theta", "croston"],
                                 "rungs": 1, "base_series": 4,
                                 "budget_device_seconds": 1e-6})
        res = tselect.successive_halving_select(tb, cv=TCV(**CV))
    finally:
        thyper.configure_automl(thyper.AutoMLConfig())
    assert res.budget_exhausted
    assert set(res.leaderboard.family) <= {"theta", "croston"}
    with pytest.raises(KeyError):
        tselect.successive_halving_select(
            tb, config=thyper.AutoMLConfig(families=("nope",)),
            cv=TCV(**CV))
