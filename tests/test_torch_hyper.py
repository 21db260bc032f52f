"""Port parity: the curve model's hyper search (``engine/hyper.py``), its
prior-scale overrides (``prophet_glm.fit(prior_scales=...)``) and the
tuned train task, against the JAX reference.

Inputs: the synthetic store-item sales at 2 stores x 3 items x 400 days
(whole-number units, 5% missing, from a seed); CV 250/60/30 (3 cutoffs).
The searched configurations drop the yearly terms (``yearly_order: 0``), as
the curve model's parity tests do below a year of history: at a 250-day
cutoff the float32 normal equations with yearly terms are too
ill-conditioned for the two frameworks' solves to agree (ROADMAP Queue 3).

The port draws its trials from a ``torch.Generator`` seeded ``search.seed``
and the reference from threefry (``utils/rng.py``), so the parity tests
hand the reference's standard draws (the round's uniforms, or the zoom
rounds' normals, from its split keys) to the port: as ``draws``, or in
place of ``hyper._trial_draws`` for the train task.  Tolerances and why:

* fits with overrides as the curve model's own parity tests hold them
  (``test_torch_prophet.py``): beta within atol 5e-4 (ill-conditioned
  float32 normal equations), paths within 2e-4 of each row's scale;
* trial values within rtol 1e-6 (``exp``/``log`` of the same uniforms);
* CV scores per (trial, series) within rtol 1e-3 (smape of paths held at
  2e-4 of scale, measured under 2e-4);
* each series' best score within rtol 1e-3 (a minimum of scores held at
  1e-3; with zoom rounds only where round 0's winner is clear, since a
  tie there centres the zoom elsewhere); winners (trial, mode) equal
  wherever a series' best two scores are more than 2e-3 apart (relative),
  as the pools' tests compare assignments — prior scales often barely
  move a series' score, so most series here are such ties, and for them
  either winner is accepted;
* the tuned task's run params equal, its frames' keys and dates equal,
  ``val_smape`` within rtol 1e-3 and the forecast table within 2e-4 of
  each series' scale where the series' winner is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu.tasks as jtasks
import distributed_forecasting_tpu_torch.data as tdata
import distributed_forecasting_tpu_torch.tasks as ttasks
from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.engine import hyper as jh
from distributed_forecasting_tpu.models import prophet_glm as jp
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.engine import hyper as th
from distributed_forecasting_tpu_torch.models import prophet_glm as tp

torch.set_num_threads(1)

CV = dict(initial=250, period=60, horizon=30)
TIE = 2e-3
BASE = dict(yearly_order=0)


@pytest.fixture(scope="module")
def data():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=400,
                                          seed=5, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    return dict(df=df, jb=jdata.tensorize(df),
                tb=tdata.tensorize(df, device="cpu"))


def _close_rows(got, want, rtol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.maximum(np.abs(want).reshape(want.shape[0], -1).max(axis=1),
                       1e-6).reshape((-1,) + (1,) * (want.ndim - 1))
    np.testing.assert_array_less(np.abs(got - want),
                                 np.broadcast_to(rtol * scale + 1e-7,
                                                 want.shape))


@pytest.mark.parametrize("scales", ["scalar_pair", "scalar_triple",
                                    "per_series"])
def test_fit_with_prior_scale_overrides_matches_reference(data, scales):
    jb, tb = data["jb"], data["tb"]
    S = tb.n_series
    per = np.geomspace(0.005, 0.3, S).astype(np.float32)
    over = {"scalar_pair": (0.2, 1.0), "scalar_triple": (0.01, 3.0, 0.5),
            "per_series": (per, per[::-1] * 20, per * 10)}[scales]
    cfg = dict(seasonality_mode="additive")
    P = jp.fit(jb.y, jb.mask, jb.day, jp.CurveModelConfig(**cfg),
               prior_scales=tuple(jnp.asarray(v) for v in over))
    Q = tp.fit(tb.y, tb.mask, tb.day, tp.CurveModelConfig(**cfg),
               prior_scales=tuple(torch.as_tensor(v) for v in over))
    np.testing.assert_allclose(Q.beta.numpy(), np.asarray(P.beta), atol=5e-4)
    day_all = np.arange(int(tb.day[0]), int(tb.day[-1]) + 31, dtype=np.int32)
    te = float(tb.day[-1])
    got = tp.forecast(Q, torch.from_numpy(day_all), te,
                      tp.CurveModelConfig(**cfg))
    want = jp.forecast(P, jnp.asarray(day_all), jnp.float32(te),
                       jp.CurveModelConfig(**cfg))
    for g, w in zip(got, want):
        _close_rows(g, w)
    # the overrides change the fit, and the config's own scales are the
    # default
    base = tp.fit(tb.y, tb.mask, tb.day, tp.CurveModelConfig(**cfg))
    assert not torch.allclose(base.beta, Q.beta)
    same = tp.fit(tb.y, tb.mask, tb.day, tp.CurveModelConfig(**cfg),
                  prior_scales=(0.05, 10.0, 10.0))
    assert torch.equal(same.beta, base.beta)


def _reference_draws(search, S):
    """The standard draws the reference's ``tune_curve_model`` takes from
    its keys, round by round: uniforms (3, n), then normals (3, n, S)."""
    key = jax.random.PRNGKey(search.seed)
    out = []
    for r in range(max(1, search.adaptive_rounds)):
        key, *ks = jax.random.split(key, 4)
        if r == 0:
            out.append(np.stack([np.asarray(jax.random.uniform(
                k, (search.n_trials,))) for k in ks]))
        else:
            out.append(np.stack([np.asarray(jax.random.normal(
                k, (search.n_trials, S))) for k in ks]))
    return out


def _round0_trials(search, u):
    """Round 0's trial values from its uniforms (3, n), as both packages
    compute them."""
    ranges = (search.cp_scale_range, search.seas_scale_range,
              search.hol_scale_range)
    return [np.asarray(th._log_uniform(torch.from_numpy(u[i]), lo, hi))
            for i, (lo, hi) in enumerate(ranges)]


def _reference_table(jb, search, trials):
    """The reference's (modes x trials, S) CV scores for round-0 trials."""
    return np.concatenate([np.asarray(jh._cv_scores(
        jb, jp.CurveModelConfig(seasonality_mode=m, **BASE),
        jcv.CVConfig(**CV),
        *[jnp.asarray(v) for v in trials], search.metric))
        for m in search.modes])


def test_cv_scores_match_reference(data):
    """Every (trial, series) CV score from the same trial scales; the
    port fits trials x cutoffs x series as rows of one batch, in blocks."""
    jb, tb = data["jb"], data["tb"]
    search = jh.HyperSearchConfig(n_trials=5, seed=2)
    trials = _round0_trials(search, _reference_draws(search, tb.n_series)[0])
    # the reference's own trial values from the same uniforms
    key = jax.random.PRNGKey(2)
    _, *ks = jax.random.split(key, 4)
    for k, v, (lo, hi) in zip(ks, trials, (search.cp_scale_range,
                                           search.seas_scale_range,
                                           search.hol_scale_range)):
        np.testing.assert_allclose(v, np.asarray(jh._log_uniform(k, lo, hi, 5)),
                                   rtol=1e-6)
    cfg = dict(BASE, seasonality_mode="multiplicative")
    want = np.asarray(jh._cv_scores(
        jb, jp.CurveModelConfig(**cfg), jcv.CVConfig(**CV),
        *[jnp.asarray(v) for v in trials], "smape"))
    got = th._cv_scores(tb, tp.CurveModelConfig(**cfg), tcv.CVConfig(**CV),
                        *[torch.from_numpy(v) for v in trials],
                        "smape").numpy()
    assert got.shape == want.shape == (5, tb.n_series)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # in blocks of trials (a small row budget) the same scores
    old = th._TRIAL_ELEMS
    try:
        th._TRIAL_ELEMS = 1
        blocked = th._cv_scores(tb, tp.CurveModelConfig(**cfg),
                                tcv.CVConfig(**CV),
                                *[torch.from_numpy(v) for v in trials],
                                "smape").numpy()
    finally:
        th._TRIAL_ELEMS = old
    np.testing.assert_array_equal(blocked, got)


def _clear(table):
    """(S,) series whose best two scores over the candidates (rows of
    ``table``) are more than TIE apart, relative."""
    s = np.sort(table, axis=0)
    return (s[1] - s[0]) > TIE * np.abs(s[0])


@pytest.mark.parametrize("rounds", [1, 2])
def test_tune_curve_model_matches_reference(data, rounds):
    """With the reference's draws: the trial table, each series' best
    score, and — where the series' round-0 winner is clear of its
    runner-up — its mode and scales (one round) or its best score (two
    rounds, the zoom centred on the same incumbent)."""
    jb, tb = data["jb"], data["tb"]
    S = tb.n_series
    kw = dict(n_trials=4, seed=1, adaptive_rounds=rounds)
    jsearch, tsearch = jh.HyperSearchConfig(**kw), th.HyperSearchConfig(**kw)
    draws = _reference_draws(jsearch, S)
    want = jh.tune_curve_model(jb, jp.CurveModelConfig(**BASE),
                               search=jsearch, cv=jcv.CVConfig(**CV))
    got = th.tune_curve_model(tb, tp.CurveModelConfig(**BASE),
                              search=tsearch, cv=tcv.CVConfig(**CV),
                              draws=draws)
    assert list(got.trials.columns) == list(want.trials.columns)
    assert len(got.trials) == len(want.trials) == rounds * 2 * 4
    r0 = want.trials["round"].to_numpy() == 0
    for col in ("changepoint_prior_scale", "seasonality_prior_scale",
                "holidays_prior_scale"):
        np.testing.assert_allclose(got.trials[col].to_numpy()[r0],
                                   want.trials[col].to_numpy()[r0], rtol=1e-6)
    np.testing.assert_allclose(got.trials["mean_smape"].to_numpy()[r0],
                               want.trials["mean_smape"].to_numpy()[r0],
                               rtol=1e-3)
    clear = _clear(_reference_table(jb, jsearch,
                                    _round0_trials(jsearch, draws[0])))
    assert clear.any()
    held = clear if rounds > 1 else np.ones(S, bool)
    np.testing.assert_allclose(got.best_score[held], want.best_score[held],
                               rtol=1e-3)
    if rounds == 1:
        assert (got.best_mode[clear] == want.best_mode[clear]).all()
        for name in ("best_cp_scale", "best_seas_scale", "best_hol_scale"):
            np.testing.assert_allclose(getattr(got, name)[clear],
                                       getattr(want, name)[clear], rtol=1e-6)
        assert got.config.seasonality_mode == want.config.seasonality_mode
    assert set(got.mode_params) == set(tsearch.modes)
    assert got.mode_params[got.config.seasonality_mode] is got.params


def test_tuned_train_task_matches_reference(data, tmp_path, monkeypatch):
    """Both packages' train task with ``tuning.enabled`` over one stored
    table, the port on the reference's draws: its run params, trial and
    per-series tables, artifact and forecast table."""
    search = jh.HyperSearchConfig(n_trials=3, seed=4)
    draws = _reference_draws(search, 6)
    monkeypatch.setattr(th, "_trial_draws",
                        lambda gen, r, n, S: torch.from_numpy(draws[r]))
    out = {}
    for name, tasks, device in (("jax", jtasks, {}),
                                ("torch", ttasks, {"device": "cpu"})):
        root = str(tmp_path / name)
        tasks.IngestTask(init_conf={
            "env": {"root": root},
            "input": {"synthetic": {"n_stores": 2, "n_items": 3,
                                    "n_days": 400, "seed": 5}},
            "output": {"table": "hackathon.sales.raw"}}, **device).launch()
        conf = {"env": {"root": root},
                "input": {"table": "hackathon.sales.raw"},
                "output": {"table": "hackathon.sales.finegrain_forecasts"},
                "training": {"horizon": 30, "cv": CV, "model_conf": BASE,
                             "tuning": {
                    "enabled": True, "n_trials": 3, "seed": 4}}}
        task = tasks.TrainTask(init_conf=conf, **device)
        res = task.launch()
        run = task.tracker.get_run(res["experiment_id"], res["run_id"])
        out[name] = dict(res=res, run=run, table=task.catalog.read_table(
            "hackathon.sales.finegrain_forecasts"))
    j, t = out["jax"], out["torch"]
    assert t["run"].params() == j["run"].params()
    assert t["run"].meta()["tags"] == j["run"].meta()["tags"]
    np.testing.assert_allclose(t["res"]["metrics"]["val_smape"],
                               j["res"]["metrics"]["val_smape"], rtol=1e-3)
    def table(r, name):
        return pd.read_parquet(r["run"].artifact_path(name))

    jt, tt = table(j, "trials.parquet"), table(t, "trials.parquet")
    assert list(tt.columns) == list(jt.columns)
    np.testing.assert_allclose(tt["mean_smape"], jt["mean_smape"], rtol=1e-3)
    js = table(j, "series_metrics.parquet")
    ts = table(t, "series_metrics.parquet")
    assert list(ts.columns) == list(js.columns)
    same = (ts["best_mode"] == js["best_mode"]).to_numpy()
    assert same.sum() >= 5
    jf, tf = j["table"], t["table"]
    assert list(tf.columns) == list(jf.columns)
    assert (tf[["ds", "store", "item"]].astype(str).to_numpy()
            == jf[["ds", "store", "item"]].astype(str).to_numpy()).all()
    T_all = len(tf) // 6
    for col in ("yhat", "yhat_lower", "yhat_upper"):
        g = tf[col].to_numpy().reshape(6, T_all)[same]
        w = jf[col].to_numpy().reshape(6, T_all)[same]
        _close_rows(g, w)
