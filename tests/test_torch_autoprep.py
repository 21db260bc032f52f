"""Port parity and behaviour: automatic data prep (``engine/autoprep``) and
its uses in the fit entry points and the training task.

The behaviour cases are the reference's ``tests/unit/test_autoprep.py``
run on the port (all but its AOT-store case: the port has no executable
store).  The parity cases run the same batches through both packages:

* Inputs are whole-number sales made with numpy from a seed, with planted
  x8 spikes, 30-day zero runs and level shifts.  Through the outlier stage
  the arithmetic is exact in float32 in both packages (test_torch_clean.py),
  so masks, outlier scores, scales and repair flags are equal; repaired
  values are held within 2 ulps (XLA may contract the interpolation into
  an FMA).
* The CUSUM stage runs on the repaired, fractional tensor, where the two
  packages' running sums round differently: its tie rule is
  test_torch_clean's (``assert_cusum_close``).  ``cp_shift`` / ``cp_score``
  are held within ``T * 2**-24`` of their magnitude (plus the row's scale
  for the shift), the float32 bound of a sum of T terms.
* One case keeps the generator's fractional sales: there the box sums
  round differently too, so outlier scores are held within 1e-4 relative
  plus 2e-3 absolute (6.2e-4 at most measured on such inputs; the float32
  bound of the sums is far looser), and the inputs are checked to have no
  score within that band of the threshold, so the flags are equal.
* The season length and holiday columns are discrete and equal.
* Fits on a prepped batch are held as test_torch_engine.py holds
  Holt-Winters fits: within 1e-5 of the data's scale, ``ok`` equal.

``configure_autoprep`` installs a process-wide config; every test here
leaves both packages' defaults installed (the autouse fixture).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import autoprep as jap
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu_torch.engine import autoprep as tap
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from test_torch_clean import assert_cusum_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = 2.0 ** -24
CP_TIE = 1e-6
HORIZON = 30
ALL_STAGES = dict(enabled=True, season_detect=True, holiday_regressors=True)


@pytest.fixture(autouse=True)
def _default_autoprep():
    yield
    tap.configure_autoprep(tap.AutoprepConfig())
    jap.configure_autoprep(jap.AutoprepConfig())


# -- inputs -------------------------------------------------------------------

def _sales(n_stores=2, n_items=4, n_days=400, seed=3, whole=True):
    df = tdata.synthetic_store_item_sales(n_stores=n_stores, n_items=n_items,
                                          n_days=n_days, seed=seed)
    if whole:
        df["sales"] = df["sales"].round()
    return df


def _batch(n_days=220, n_stores=2, n_items=2, seed=3):
    """The reference test's batch, on the port (CPU)."""
    df = tdata.synthetic_store_item_sales(
        n_stores=n_stores, n_items=n_items, n_days=n_days, seed=seed)
    return tdata.tensorize(df, device="cpu")


def _with_y(batch, y):
    return dataclasses.replace(batch, y=torch.from_numpy(
        np.ascontiguousarray(y, dtype=np.float32)))


def _contaminate(batch, spikes=((0, 40), (1, 100), (2, 160)), scale=12.0):
    """Plant large point outliers; returns (dirty batch, clean y)."""
    y = batch.y.numpy().copy()
    level = np.nanmean(np.where(batch.mask.numpy() > 0, y, np.nan))
    for s, t in spikes:
        y[s, t] += scale * level * (1 if (s + t) % 2 else -1)
    return _with_y(batch, y), batch.y.numpy()


def _planted(df, seed=0):
    """Both packages' batches of ``df``, with an x8 spike per series, a
    30-day zero run in series 0 and a +20 shift over the last 150 days in
    series 1 (whole numbers stay whole)."""
    jb, tb = jdata.tensorize(df), tdata.tensorize(df, device="cpu")
    y = tb.y.numpy().copy()
    rng = np.random.default_rng(seed)
    S, T = y.shape
    y[np.arange(S), rng.integers(20, T - 20, S)] *= 8
    y[0, 100:130] = 0.0
    y[1, T - 150:] += 20.0
    y *= tb.mask.numpy()
    return (dataclasses.replace(jb, y=jnp.asarray(y)), _with_y(tb, y))


# -- config strictness ---------------------------------------------------------

def _raises_like_reference(conf):
    with pytest.raises(ValueError) as want:
        jap.AutoprepConfig.from_conf(conf)
    with pytest.raises(ValueError) as got:
        tap.AutoprepConfig.from_conf(conf)
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_config_rejects_unknown_keys():
    assert "outlier_treshold" in _raises_like_reference(
        {"outlier_treshold": 5})


@pytest.mark.parametrize("bad", [
    {"zero_run_min": 1},
    {"outlier_threshold": 0},
    {"changepoint_threshold": -1},
    {"outlier_window": 0},
    {"season_max_lag": 3},
    {"holiday_lower_window": -1},
])
def test_config_validates_ranges(bad):
    _raises_like_reference(bad)


def test_configure_installs_process_config():
    cfg = tap.configure_autoprep({"enabled": True, "outlier_threshold": 4.0})
    assert tap.autoprep_config() is cfg
    assert cfg.outlier_threshold == 4.0
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jap.AutoprepConfig.from_conf({"enabled": True,
                                      "outlier_threshold": 4.0}))


def test_shipped_conf_block_parses():
    """The committed train_config.yml block parses through the strict
    loader, to the reference's values."""
    with open(os.path.join(ROOT, "conf", "tasks", "train_config.yml")) as fh:
        conf = yaml.safe_load(fh)
    cfg = tap.AutoprepConfig.from_conf(conf["engine"]["autoprep"])
    assert not cfg.enabled  # shipped off by default
    assert cfg.zero_run_mask and cfg.outlier_repair and cfg.changepoints
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jap.AutoprepConfig.from_conf(conf["engine"]["autoprep"]))


# -- no-op identity ------------------------------------------------------------

def test_disabled_returns_input_batch_object():
    batch = _batch()
    res = tap.autoprep_batch(batch, tap.AutoprepConfig(enabled=False))
    assert res.batch is batch
    assert res.report is None and res.xreg is None


def test_all_gates_off_returns_input_batch_object():
    batch = _batch()
    cfg = tap.AutoprepConfig(
        enabled=True, zero_run_mask=False, outlier_repair=False,
        changepoints=False, holiday_regressors=False, season_detect=False)
    assert not cfg.any_stage
    assert tap.autoprep_batch(batch, cfg).batch is batch


# -- the stages, on planted data ----------------------------------------------

def test_outlier_repair_flags_and_repairs_planted_spikes():
    batch = _batch()
    dirty, clean_y = _contaminate(batch)
    cfg = tap.AutoprepConfig(enabled=True, zero_run_mask=False,
                             changepoints=False, outlier_threshold=6.0)
    res = tap.autoprep_batch(dirty, cfg)
    rep = res.report
    for s, t in ((0, 40), (1, 100), (2, 160)):
        assert rep.repaired[s, t], f"spike at ({s},{t}) not repaired"
        fixed = float(res.batch.y[s, t])
        dirty_v = float(dirty.y[s, t])
        assert abs(fixed - clean_y[s, t]) < 0.2 * abs(dirty_v - clean_y[s, t])
    # the input is never modified
    assert float(dirty.y[0, 40]) != float(res.batch.y[0, 40])
    untouched = torch.from_numpy(~rep.repaired)
    assert torch.equal(res.batch.y[untouched], dirty.y[untouched])


def test_repairs_frame_records_raw_and_repaired():
    batch = _batch()
    dirty, _ = _contaminate(batch, spikes=((0, 50),))
    cfg = tap.AutoprepConfig(enabled=True, zero_run_mask=False,
                             changepoints=False)
    res = tap.autoprep_batch(dirty, cfg)
    frame = res.report.repairs_frame(dirty)
    assert {"store", "item", "ds", "y_raw", "y_repaired",
            "outlier_score"} <= set(frame.columns)
    planted = frame[frame["ds"] == batch.dates()[50]]
    assert len(planted) >= 1
    row = planted.iloc[0]
    assert row["y_raw"] == pytest.approx(float(dirty.y[0, 50]))
    assert row["y_raw"] != row["y_repaired"]
    assert row["outlier_score"] > cfg.outlier_threshold


def test_zero_run_masking_drops_long_runs_keeps_short():
    batch = _batch()
    y = batch.y.numpy().copy()
    y[0, 30:60] = 0.0     # 30-day dead stretch: a feed outage
    y[1, 80:84] = 0.0     # 4-day zero run: ordinary intermittency
    cfg = tap.AutoprepConfig(enabled=True, outlier_repair=False,
                             changepoints=False, zero_run_min=14)
    res = tap.autoprep_batch(_with_y(batch, y), cfg)
    mask = res.batch.mask.numpy()
    assert (mask[0, 30:60] == 0).all()
    assert (mask[1, 80:84] > 0).all()
    assert res.report.summary()["prep_masked_zero_cells"] == 30


def test_cusum_finds_planted_level_shift():
    batch = _batch(n_days=200)
    y = batch.y.numpy().copy()
    y[0, 120:] += 8.0 * max(float(np.std(y[0])), 1.0)
    cfg = tap.AutoprepConfig(enabled=True, zero_run_mask=False,
                             outlier_repair=False, changepoint_threshold=8.0)
    rep = tap.autoprep_batch(_with_y(batch, y), cfg).report
    assert rep.cp_index[0] == pytest.approx(120, abs=3)
    assert rep.cp_shift[0] > 0
    assert rep.cp_score[0] > cfg.changepoint_threshold


def test_align_level_shifts_relevels_pre_segment():
    batch = _batch(n_days=200)
    y = batch.y.numpy().copy()
    shift = 8.0 * max(float(np.std(y[0])), 1.0)
    y[0, 120:] += shift
    cfg = tap.AutoprepConfig(enabled=True, zero_run_mask=False,
                             outlier_repair=False, align_level_shifts=True)
    res = tap.autoprep_batch(_with_y(batch, y), cfg)
    pre_mean_before = float(y[0, :120].mean())
    pre_mean_after = float(res.batch.y[0, :120].mean())
    assert pre_mean_after == pytest.approx(pre_mean_before + shift, rel=0.1)


def test_season_detection_finds_weekly_period():
    rng = np.random.default_rng(0)
    t = np.arange(400)
    rows = []
    for item in (1, 2):
        y = 50 + 10 * np.sin(2 * np.pi * t / 7 + item) + rng.normal(size=400)
        rows.append(pd.DataFrame(
            {"date": pd.date_range("2020-01-01", periods=400), "store": 1,
             "item": item, "sales": y}))
    batch = tdata.tensorize(pd.concat(rows, ignore_index=True), device="cpu")
    cfg = tap.AutoprepConfig(enabled=True, zero_run_mask=False,
                             outlier_repair=False, changepoints=False,
                             season_detect=True)
    res = tap.autoprep_batch(batch, cfg)
    assert res.season_length == 7
    assert res.report.summary()["prep_season_length"] == 7


def test_holiday_regressors_cover_history_and_horizon():
    batch = _batch(n_days=400)
    cfg = tap.AutoprepConfig(enabled=True, zero_run_mask=False,
                             outlier_repair=False, changepoints=False,
                             holiday_regressors=True)
    res = tap.autoprep_batch(batch, cfg, horizon=30)
    assert res.xreg.shape == (batch.n_time + 30,
                              len(res.report.holiday_names))
    assert res.xreg.device == batch.y.device
    x = res.xreg.numpy()
    assert set(np.unique(x)) <= {0.0, 1.0}
    assert x.sum() > 0


def test_repaired_fit_beats_unrepaired_on_contaminated_data():
    from distributed_forecasting_tpu_torch.models import CurveModelConfig

    batch = _batch(n_days=260, seed=11)
    spikes = tuple((s, t) for s in range(batch.n_series)
                   for t in (40, 90, 150, 200))
    dirty, clean_y = _contaminate(batch, spikes=spikes, scale=15.0)
    cfg = CurveModelConfig()
    prep = tap.AutoprepConfig(enabled=True, zero_run_mask=False,
                              changepoints=False, outlier_threshold=6.0)
    _, raw = tfit.fit_forecast(dirty, model="prophet", config=cfg,
                               horizon=14, autoprep=False)
    _, fixed = tfit.fit_forecast(dirty, model="prophet", config=cfg,
                                 horizon=14, autoprep=prep)
    T = batch.n_time
    mask = batch.mask.numpy() > 0
    err_raw = np.abs(raw.yhat.numpy()[:, :T] - clean_y)[mask].mean()
    err_fixed = np.abs(fixed.yhat.numpy()[:, :T] - clean_y)[mask].mean()
    assert err_fixed <= err_raw


# -- autoprep_batch against the reference, report for report -----------------

def _score_band(fractional):
    if fractional:
        return lambda s: 1e-4 * np.abs(s) + 2e-3
    return lambda s: np.zeros_like(s)


def assert_prep_matches(tres, jres, y_raw, fractional=False):
    """Both packages' PrepResults of the batch ``y_raw``, field by field
    (module docstring)."""
    trep, jrep = tres.report, jres.report
    assert trep.n_series == jrep.n_series and trep.n_time == jrep.n_time
    np.testing.assert_array_equal(trep.masked_zero_cells,
                                  jrep.masked_zero_cells)
    band = _score_band(fractional)(np.asarray(jrep.outlier_score))
    assert (np.abs(trep.outlier_score - jrep.outlier_score) <= band).all()
    np.testing.assert_allclose(trep.outlier_scale, jrep.outlier_scale,
                               rtol=1e-4 if fractional else 0,
                               atol=1e-4 if fractional else 0)
    np.testing.assert_array_equal(trep.repaired, jrep.repaired)
    want_v = np.asarray(jrep.repair_value)
    assert (np.abs(trep.repair_value - want_v)
            <= 2 * np.spacing(np.abs(want_v))).all()
    # the CUSUM ran on the reference's repaired tensor and cleaned mask
    assert_cusum_close(
        (torch.from_numpy(trep.cp_index), torch.from_numpy(trep.cp_shift),
         torch.from_numpy(trep.cp_score)),
        (jrep.cp_index, jrep.cp_shift, jrep.cp_score),
        np.where(jrep.repaired, want_v, y_raw), np.asarray(jres.batch.mask),
        jrep.config.changepoint_threshold)
    assert trep.season_length == jrep.season_length == tres.season_length
    assert trep.holiday_names == jrep.holiday_names
    assert trep.summary() == jrep.summary()
    # the fit tensor
    np.testing.assert_array_equal(tres.batch.mask.numpy(),
                                  np.asarray(jres.batch.mask))
    want_y = np.asarray(jres.batch.y)
    same_cp = trep.cp_index == jrep.cp_index
    scale = np.abs(want_y).max(axis=1, keepdims=True)
    tol = 2 * np.spacing(np.abs(want_y)) + (
        tres.batch.n_time * EPS32 * scale
        if jrep.config.align_level_shifts else 0.0)
    assert (np.abs(tres.batch.y.numpy() - want_y)[same_cp]
            <= tol[same_cp]).all()
    if jres.xreg is None:
        assert tres.xreg is None
    else:
        np.testing.assert_array_equal(tres.xreg.numpy(), np.asarray(jres.xreg))


@pytest.mark.parametrize("conf", [
    ALL_STAGES,
    dict(enabled=True, align_level_shifts=True, changepoint_threshold=6.0),
    dict(enabled=True, outlier_repair=False, zero_run_min=3,
         outlier_window=3),
    dict(enabled=True, zero_run_mask=False, changepoints=False,
         holiday_regressors=True, holiday_lower_window=1,
         holiday_upper_window=2),
], ids=["all_stages", "align", "zero_runs", "holidays_windowed"])
def test_autoprep_batch_matches_reference(conf):
    jb, tb = _planted(_sales())
    jres = jap.autoprep_batch(jb, jap.AutoprepConfig(**conf), horizon=HORIZON)
    tres = tap.autoprep_batch(tb, tap.AutoprepConfig(**conf),
                              horizon=HORIZON)
    assert_prep_matches(tres, jres, tb.y.numpy())
    assert tres.report.repaired.sum() >= (
        tb.n_series if conf.get("outlier_repair", True) else 0)
    if conf.get("zero_run_mask", True):
        assert tres.report.masked_zero_cells[0] == 30
    # the frames both packages would log, against the raw batches
    for name in ("to_frame", "repairs_frame"):
        got = getattr(tres.report, name)(tb)
        want = getattr(jres.report, name)(jb)
        assert list(got.columns) == list(want.columns)
        assert dict(got.dtypes) == dict(want.dtypes)
        assert len(got) == len(want)


def test_autoprep_batch_matches_reference_on_fractional_sales():
    jb, tb = _planted(_sales(whole=False), seed=1)
    cfg = dict(enabled=True, season_detect=True)
    jres = jap.autoprep_batch(jb, jap.AutoprepConfig(**cfg))
    tres = tap.autoprep_batch(tb, tap.AutoprepConfig(**cfg))
    score = np.asarray(jres.report.outlier_score)
    band = _score_band(True)(score)
    # margins clear the tolerance: no score inside the band at 6.0
    assert not (np.abs(score - 6.0) <= band).any()
    assert_prep_matches(tres, jres, tb.y.numpy(), fractional=True)


# -- the fit entry points ------------------------------------------------------

CLEANING = dict(enabled=True, align_level_shifts=True)


def _hw_configs():
    return (jhw.HoltWintersConfig(filter="scan"),
            thw.HoltWintersConfig(filter="pallas"))


def _assert_fits_close(tr, jr, jb):
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    np.testing.assert_array_equal(tr.day_all.numpy(), np.asarray(jr.day_all))
    scale = float(np.abs(np.asarray(jb.y)).max())
    for k in ("yhat", "lo", "hi"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


def _ragged(df):
    """Items 3-4 start at day 250: two span buckets."""
    day = (df["date"] - df["date"].min()).dt.days
    return df[(df["item"] < 3) | (day >= 250)].reset_index(drop=True)


@pytest.mark.parametrize("entry", ["fit_forecast", "chunked", "bucketed"])
@pytest.mark.parametrize("mode", ["armed", "off", "explicit"])
def test_fit_entry_points_prep_like_the_reference(entry, mode):
    df = _sales()
    if entry == "bucketed":
        df = _ragged(df)
    jb, tb = _planted(df)
    jcfg, tcfg = _hw_configs()
    if mode == "armed":
        jap.configure_autoprep(CLEANING)
        tap.configure_autoprep(CLEANING)
        jarg = targ = None
    elif mode == "off":
        jap.configure_autoprep(CLEANING)
        tap.configure_autoprep(CLEANING)
        jarg = targ = False
    else:
        jarg, targ = (jap.AutoprepConfig(**CLEANING),
                      tap.AutoprepConfig(**CLEANING))
    kw = dict(model="holt_winters", horizon=HORIZON)
    if entry == "fit_forecast":
        _, jr = jfit.fit_forecast(jb, config=jcfg, autoprep=jarg, **kw)
        _, tr = tfit.fit_forecast(tb, config=tcfg, autoprep=targ, **kw)
    elif entry == "chunked":
        _, jr = jfit.fit_forecast_chunked(jb, config=jcfg, chunk_size=3,
                                          dispatch="loop", autoprep=jarg, **kw)
        _, tr = tfit.fit_forecast_chunked(tb, config=tcfg, chunk_size=3,
                                          dispatch="loop", autoprep=targ, **kw)
    else:
        jbk, jr = jfit.fit_forecast_bucketed(jb, config=jcfg, autoprep=jarg,
                                             **kw)
        tbk, tr = tfit.fit_forecast_bucketed(tb, config=tcfg, autoprep=targ,
                                             **kw)
        assert [list(i) for i, _, _ in tbk] == [list(i) for i, _, _ in jbk]
        assert len(tbk) == 2
    _assert_fits_close(tr, jr, jb)
    # prepped or not, as asked: the raw fit differs at the planted spike
    _, raw = tfit.fit_forecast(tb, config=tcfg, autoprep=False, **kw)
    assert torch.equal(raw.yhat, tr.yhat) == (mode == "off")


# -- the training task ---------------------------------------------------------

HW_TRAINING = {"model": "holt_winters", "horizon": HORIZON,
               "model_conf": {"season_length": "auto"},
               "cv": {"initial": 250, "period": 100, "horizon": 30}}
HW_PREP = {"enabled": True, "season_detect": True, "align_level_shifts": True}


def _train(package, root, raw, training=HW_TRAINING, autoprep=HW_PREP,
           tables=()):
    """One train task of ``package`` over the table ``raw`` (and the extra
    catalog ``tables``, (name, frame) pairs); returns its tracked run."""
    if package == "ref":
        from distributed_forecasting_tpu import tasks
        from distributed_forecasting_tpu.data import DatasetCatalog
        kw = {}
    else:
        from distributed_forecasting_tpu_torch import tasks
        from distributed_forecasting_tpu_torch.data import DatasetCatalog
        kw = {"device": "cpu"}
    catalog = DatasetCatalog(os.path.join(root, "warehouse"))
    for name, frame in (("hackathon.sales.raw", raw), *tables):
        catalog.save_table(name, frame)
    task = tasks.TASK_TYPES["train"](init_conf={
        "env": {"root": root},
        "input": {"table": "hackathon.sales.raw"},
        "output": {"table": "hackathon.sales.finegrain_forecasts"},
        "training": training,
        "engine": {"autoprep": autoprep}}, **kw)
    summary = task.launch()
    return task.tracker.get_run(summary["experiment_id"], summary["run_id"])


def _raw_table(tb):
    """The long sales table of a batch's observed cells."""
    raw = tb.key_frame().merge(pd.DataFrame({"date": tb.dates()}),
                               how="cross")
    raw["sales"] = tb.y.numpy().reshape(-1)
    return raw[tb.mask.numpy().reshape(-1) > 0].reset_index(drop=True)


def test_train_task_logs_the_references_prep_artifacts(tmp_path):
    jb, tb = _planted(_sales())
    raw = _raw_table(tb)
    runs = {p: _train(p, str(tmp_path / p), raw) for p in ("ref", "port")}
    got, want = runs["port"], runs["ref"]
    gm, wm = got.metrics(), want.metrics()
    prep = {k for k in wm if k.startswith("prep_")}
    assert prep and prep <= set(gm)
    assert {k: gm[k] for k in prep} == {k: wm[k] for k in prep}
    assert gm["prep_season_length"] == 7 and gm["prep_repaired_points"] >= 8
    assert "phase_autoprep_seconds" in gm
    assert got.params()["season_length"] == want.params()["season_length"]
    for name, discrete, floats in (
            ("prep_report.parquet",
             ["store", "item", "masked_zero_cells", "repaired_points",
              "cp_index"],
             ["max_outlier_score", "outlier_scale", "cp_shift", "cp_score"]),
            ("prep_repairs.parquet", ["store", "item", "ds", "y_raw"],
             ["y_repaired", "outlier_score"])):
        g = pd.read_parquet(got.artifact_path(name))
        w = pd.read_parquet(want.artifact_path(name))
        assert list(g.columns) == list(w.columns)
        pd.testing.assert_frame_equal(g[discrete], w[discrete])
        # whole-number inputs: the outlier stage is exact (repairs within
        # 2 ulps); the CUSUM's shift and score within T * 2**-24
        rtol = 2 * EPS32 if name == "prep_repairs.parquet" \
            else tb.n_time * EPS32
        for col in floats:
            np.testing.assert_allclose(g[col], w[col], rtol=rtol,
                                       atol=1e-6, err_msg=col)


@pytest.mark.parametrize("covariates", [None, "shared", "per_series"])
def test_train_task_joins_holiday_columns_to_the_regressors(tmp_path,
                                                           covariates):
    """``holiday_regressors: true`` on the curve model: the prep's holiday
    columns join the conf's regressors (none, a shared calendar, or
    per-series values broadcast against the holidays) and their names the
    config, as in the reference.  Forecasts are held as
    test_torch_tasks.py holds the curve model's slice runs (5e-4 of each
    row's scale: the float32 normal equations)."""
    _, tb = _planted(_sales(n_items=2))
    raw = _raw_table(tb)
    training = {"model": "prophet", "horizon": HORIZON,
                "model_conf": {"yearly_order": 0},
                "cv": {"initial": 250, "period": 100, "horizon": 30}}
    tables = ()
    if covariates:
        rng = np.random.default_rng(7)
        dates = pd.date_range(tb.start_date, periods=tb.n_time + HORIZON)
        frame = pd.DataFrame({"date": dates,
                              "promo": (rng.random(len(dates)) < 0.2) * 1.0})
        per_series = covariates == "per_series"
        if per_series:
            frame = tb.key_frame().merge(frame, how="cross")
            frame["promo"] = rng.random(len(frame)).round(2)
        tables = (("hackathon.sales.covariates", frame),)
        training["regressors"] = {"table": "hackathon.sales.covariates",
                                  "columns": ["promo"],
                                  "per_series": per_series}
    prep = {"enabled": True, "holiday_regressors": True}
    runs = {p: _train(p, str(tmp_path / p), raw, training, prep, tables)
            for p in ("ref", "port")}
    got, want = runs["port"], runs["ref"]
    gp, wp = got.params(), want.params()
    assert gp == wp
    n_hol = int(want.metrics()["prep_holiday_regressors"])
    assert n_hol > 0 and got.metrics()["prep_holiday_regressors"] == n_hol
    assert int(gp["n_regressors"]) == int(wp["n_regressors"]) \
        == n_hol + (1 if covariates else 0)
    g, w = (pd.read_parquet(r.artifact_path("series_metrics.parquet"))
            for r in (got, want))
    pd.testing.assert_frame_equal(g[["store", "item", "fit_ok"]],
                                  w[["store", "item", "fit_ok"]])
    from distributed_forecasting_tpu_torch.data import DatasetCatalog

    g, w = (DatasetCatalog(str(tmp_path / p / "warehouse")).read_table(
        "hackathon.sales.finegrain_forecasts") for p in ("port", "ref"))
    pd.testing.assert_frame_equal(g[["ds", "store", "item"]],
                                  w[["ds", "store", "item"]])
    for col in ("yhat", "yhat_lower", "yhat_upper"):
        gv = g[col].to_numpy().reshape(tb.n_series, -1)
        wv = w[col].to_numpy().reshape(tb.n_series, -1)
        scale = np.abs(wv).max(axis=1, keepdims=True)
        assert (np.abs(gv - wv) <= 5e-4 * scale + 1e-6).all(), col


def test_pooled_fit_preps_like_the_reference():
    """``model: auto`` fits each family through ``fit_forecast``, which
    takes the armed block's cleaning stages, as the reference's does.  The
    same assignment is forced in both packages (test_torch_blend.py), and
    the Holt-Winters and croston paths are held as Holt-Winters fits are."""
    from distributed_forecasting_tpu.engine import select as jselect
    from distributed_forecasting_tpu.models import croston as jcr
    from distributed_forecasting_tpu_torch.engine import cv as tcv
    from distributed_forecasting_tpu_torch.engine import select as tselect
    from distributed_forecasting_tpu_torch.models import croston as tcr

    jb, tb = _planted(_sales())
    families = ("holt_winters", "croston")
    jhw_cfg, thw_cfg = _hw_configs()
    jc = {"holt_winters": jhw_cfg, "croston": jcr.CrostonConfig()}
    tc = {"holt_winters": thw_cfg, "croston": tcr.CrostonConfig()}
    sel = tselect.select_model(tb, models=families, configs=tc,
                               cv=tcv.CVConfig(initial=250, period=60,
                                               horizon=30))
    assert len(set(sel.chosen)) == 2
    _, _, raw = tselect.fit_forecast_auto(tb, configs=tc, horizon=HORIZON,
                                          selection=sel)
    jap.configure_autoprep(CLEANING)
    tap.configure_autoprep(CLEANING)
    _, _, jr = jselect.fit_forecast_auto(jb, configs=jc, horizon=HORIZON,
                                         selection=sel)
    _, _, tr = tselect.fit_forecast_auto(tb, configs=tc, horizon=HORIZON,
                                         selection=sel)
    _assert_fits_close(tr, jr, jb)
    assert not torch.equal(raw.yhat, tr.yhat)  # the prep ran
