"""Port parity: the ``forecasting-e2e`` workflow (catalog -> ingest -> train
with conformal bands -> deploy -> inference) through both packages' task
layers, on the CPU, at the reference task tests' size
(``tests/unit/test_tasks.py``: 2 stores x 3 items x 800 days, CV
400/180/60, calibrated).

Both runs load ``conf/workflows.yml`` and change the spec in memory only:
the ingest size and the CV windows; the parity fixture runs without the
``monitor`` node (test_torch_monitor.py holds the monitor's tables to the
reference's), and one test runs the workflow with it to its end.

Host-side results are equal: table keys, dates, row counts, the logged
parameter keys and values (``tensorize_backend`` included: both packages
tensorize on the native data plane), the run's metric names, the series
table's keys and ``fit_ok``, the registry's tags and stage.  Forecast values agree
within 5e-4 of each series' scale: the curve model's float32 normal
equations differ between the packages by up to ~1e-4 of the path's scale
(test_torch_prophet.py), and the band's conformal scale moves by up to its
scores' change (test_torch_calibrate.py), here ~1e-4 relative.  CV metric
means agree within rtol 1e-3; the calibrated coverage within one point per
series and cutoff (the point on the band's edge).

One test per option the port does not run yet checks that it raises
``NotImplementedError`` naming its ROADMAP item; the options that came with
the curve model's remaining entry points (``bucketed``, ``regressors``,
``cv_artifact``), and since slice 13 arnet (plain, allocated, in a pool)
and ``tuning.enabled``, run there instead.  ``training.bucketed`` (on a ragged
batch), ``training.regressors`` with ``inference.regressors`` and
``inference.quantiles``, and ``training.cv_artifact`` run train, deploy and
inference through both packages at 2 x 4 x 400 days, the curve model
without yearly terms, CV 200/60/30, horizon 30: tables, params and the CV
frame's keys are equal, values within 5e-4 of each series' scale as above.

The ``forecasting-blend`` workflow (train with ``model: blend`` over
prophet, holt_winters at ``season_length: auto`` and croston, calibrated ->
deploy -> inference -> promote) runs through both packages at 2 x 3 x 400
days, CV 200/60/30, horizon 30, and once more with ``model: auto``.  The
curve member runs without yearly terms there: at a 200-day first cutoff the
yearly wave is nearly collinear with the trend and the float32 normal
equations are ill-conditioned (test_torch_engine.py).  Forecasts agree
within 5e-4 of each series' scale (as above), the logged CV scores and
weights within rtol 1e-3 (the curve member's scores, test_torch_blend.py).
The promote task's decisions and tags are equal.

The allocated path (``allocated-baseline``'s train task) runs through both
packages at 2 stores x 4 items x 400 days, horizon 30: the curve model on
the item-level batch, without yearly terms (a 365.25-day wave over 400
days is nearly collinear with the trend, and the float32 normal equations
are ill-conditioned, test_torch_engine.py).  Its table's keys, dates and
store shares are equal, its values within 5e-4 of each series' scale.
``sample_ml`` logs the reference's r2 (scikit-learn on the same table).
Each of the five workflows of ``conf/workflows.yml`` runs its task
sequence to its end through the port's runner at 2 x 4 x 400 days.
"""

import copy
import logging
import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from distributed_forecasting_tpu.workflows import runner as jrunner
from distributed_forecasting_tpu_torch import tasks as ttasks
from distributed_forecasting_tpu_torch.serving import loader as tloader
from distributed_forecasting_tpu_torch.workflows import runner as trunner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 5e-4
MODEL = "ForecastingBatchModel"


def _spec(monitor: bool = False):
    with open(os.path.join(ROOT, "conf", "workflows.yml")) as f:
        spec = yaml.safe_load(f)
    spec["workflows"] = [w for w in spec["workflows"]
                         if w["name"] == "forecasting-e2e"]
    wf = spec["workflows"][0]
    for node in wf["tasks"]:
        if node["task"] == "ingest":
            node["conf"]["input"]["synthetic"] = {
                "n_stores": 2, "n_items": 3, "n_days": 800, "seed": 5}
        if node["task"] == "train":
            node["conf"]["training"]["cv"] = {
                "initial": 400, "period": 180, "horizon": 60}
    if not monitor:
        wf["tasks"] = [t for t in wf["tasks"] if t["task"] != "monitor"]
    return spec


def _conf_file_paths(spec):
    """conf_file entries are relative to the repo root."""
    for wf in spec["workflows"]:
        for node in wf["tasks"]:
            if node.get("conf_file"):
                node["conf_file"] = os.path.join(ROOT, node["conf_file"])
    return spec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    roots = {k: str(tmp_path_factory.mktemp(k)) for k in ("ref", "port")}
    spec = _conf_file_paths(_spec())
    want = jrunner.WorkflowRunner(copy.deepcopy(spec),
                                  env={"root": roots["ref"]}).run()
    got = trunner.WorkflowRunner(copy.deepcopy(spec), env={"root": roots["port"]},
                                 device="cpu").run()
    return {"ref": (want, roots["ref"]), "port": (got, roots["port"])}


def _handles(root):
    from distributed_forecasting_tpu_torch.data import DatasetCatalog
    from distributed_forecasting_tpu_torch.tracking import (
        FileTracker,
        ModelRegistry,
    )

    return (DatasetCatalog(os.path.join(root, "warehouse")),
            FileTracker(os.path.join(root, "mlruns")),
            ModelRegistry(os.path.join(root, "registry")))


def _run(root, result):
    _, tracker, _ = _handles(root)
    train = result["train"]["result"]
    return tracker.get_run(train["experiment_id"], train["run_id"])


def test_every_task_runs_ok(runs):
    for name in ("ref", "port"):
        results, _ = runs[name]
        assert list(results) == ["catalog", "etl", "train", "deploy",
                                 "inference"]
        assert all(r["status"] == "OK" for r in results.values())
    got, want = runs["port"][0], runs["ref"][0]
    for k in ("n_series", "n_failed"):
        assert got["train"]["result"][k] == want["train"]["result"][k]
    assert got["train"]["result"]["n_series"] == 6
    assert got["deploy"]["result"]["version"] == 1
    assert got["inference"]["result"]["rows"] == want["inference"]["result"][
        "rows"] == 6 * 90


def _rows_close(got, want, cols, keys):
    """Values per series within RTOL of the series' own scale."""
    for col in cols:
        g = got[col].to_numpy().reshape(len(keys), -1)
        w = want[col].to_numpy().reshape(len(keys), -1)
        scale = np.nanmax(np.abs(w), axis=1, keepdims=True)
        np.testing.assert_array_less(
            np.abs(g - w), np.broadcast_to(RTOL * scale + 1e-6, w.shape),
            err_msg=col)


@pytest.mark.parametrize("table", ["hackathon.sales.finegrain_forecasts",
                                   "hackathon.sales.test_finegrain_forecasts"])
def test_tables_match_reference(runs, table):
    got = _handles(runs["port"][1])[0].read_table(table)
    want = _handles(runs["ref"][1])[0].read_table(table)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    exact = [c for c in ("ds", "store", "item", "y", "training_date")
             if c in want.columns]
    pd.testing.assert_frame_equal(got[exact], want[exact])
    vals = ["yhat", "yhat_upper", "yhat_lower"]
    assert np.isfinite(got[vals].to_numpy()).all()
    assert (got["yhat_lower"] <= got["yhat"]).all()
    assert (got["yhat"] <= got["yhat_upper"]).all()
    keys = want[["store", "item"]].drop_duplicates().to_numpy()
    _rows_close(got, want, vals, keys)


def test_run_params_metrics_and_series_table_match_reference(runs):
    got, want = (_run(runs[k][1], runs[k][0]) for k in ("port", "ref"))
    gp, wp = got.params(), want.params()
    assert set(gp) == set(wp)
    assert gp["tensorize_backend"] == "native"
    assert gp == wp
    # metric names: both executors add their stage timings (pipeline_*)
    gm, wm = got.metrics(), want.metrics()
    assert set(gm) == set(wm)
    assert {"pipeline_prep_seconds", "pipeline_dispatch_seconds",
            "pipeline_pull_seconds"} <= set(gm)
    assert gm["n_cv_cutoffs"] == wm["n_cv_cutoffs"] == 2
    for k in ("val_mse", "val_rmse", "val_mae", "val_mape", "val_smape",
              "val_mdape", "val_mase", "interval_scale_mean"):
        np.testing.assert_allclose(gm[k], wm[k], rtol=1e-3, err_msg=k)
    assert got.meta()["tags"] == want.meta()["tags"]
    assert got.meta()["run_name"] == want.meta()["run_name"]

    gt = pd.read_parquet(got.artifact_path("series_metrics.parquet"))
    wt = pd.read_parquet(want.artifact_path("series_metrics.parquet"))
    assert list(gt.columns) == list(wt.columns)
    pd.testing.assert_frame_equal(gt[["store", "item", "fit_ok"]],
                                  wt[["store", "item", "fit_ok"]])
    for col in ("mse", "rmse", "mae", "mape", "smape", "mdape", "mase",
                "interval_scale"):
        np.testing.assert_allclose(gt[col], wt[col], rtol=1e-3, err_msg=col)
    # coverage: fractions of 60-day windows, 2 cutoffs
    flip = 1.0 / (2 * 60) + 1e-6
    for col in ("coverage", "coverage_calibrated"):
        np.testing.assert_array_less(np.abs(gt[col] - wt[col]), flip,
                                     err_msg=col)
    assert (gt["interval_scale"] > 0).all()
    np.testing.assert_allclose(gm["val_coverage_calibrated"],
                               wm["val_coverage_calibrated"], atol=flip)


def test_artifact_and_registry_match_reference(runs):
    got_reg, want_reg = (_handles(runs[k][1])[2] for k in ("port", "ref"))
    g = got_reg.latest_version(MODEL)
    w = want_reg.latest_version(MODEL)
    assert (g.version, g.stage) == (w.version, w.stage) == (1, "Staging")
    assert g.tags == w.tags
    assert g.tags["model_family"] == "prophet"
    files = sorted(os.listdir(os.path.join(g.artifact_dir)))
    assert files == sorted(os.listdir(w.artifact_dir))
    # the registered artifact loads in either package and predicts alike
    from distributed_forecasting_tpu.serving import (
        load_forecaster as jload,
    )

    request = pd.DataFrame({"store": [2, 1], "item": [3, 1]})
    for art in (g.artifact_dir, w.artifact_dir):
        p = tloader.load_forecaster(art, device="cpu").predict(request,
                                                               horizon=30)
        r = jload(art).predict(request, horizon=30)
        pd.testing.assert_frame_equal(p[["ds", "store", "item"]],
                                      r[["ds", "store", "item"]])
        _rows_close(p, r, ["yhat", "yhat_upper", "yhat_lower"],
                    request.to_numpy())


def test_shipped_bands_are_the_calibrated_ones(runs):
    """The train task's table and artifact carry the CV-conformal bands:
    the artifact's scales are the series table's, and the served band is
    the raw band scaled by them."""
    root = runs["port"][1]
    run = _run(root, runs["port"][0])
    art = run.artifact_path("forecaster")
    scale = np.load(os.path.join(art, "interval_scale.npy"))
    table = pd.read_parquet(run.artifact_path("series_metrics.parquet"))
    np.testing.assert_array_equal(scale, table["interval_scale"].to_numpy(
        np.float32))
    assert not np.allclose(scale, 1.0)
    fc = tloader.load_forecaster(art, device="cpu")
    request = table[["store", "item"]]
    cal = fc.predict(request, horizon=90)
    fc.interval_scale = None
    raw = fc.predict(request, horizon=90)
    s = np.repeat(scale, 90)
    np.testing.assert_allclose(
        cal["yhat_upper"] - cal["yhat"], s * (raw["yhat_upper"] - raw["yhat"]),
        rtol=1e-5, atol=1e-4)
    forecasts = _handles(root)[0].read_table(
        "hackathon.sales.finegrain_forecasts")
    last = forecasts.groupby(["store", "item"]).tail(90)
    np.testing.assert_allclose(last["yhat_upper"].to_numpy(),
                               cal["yhat_upper"].to_numpy(), rtol=1e-5)


def test_quantile_inference_matches_reference(runs, tmp_path):
    conf = {"input": {"table": "hackathon.sales.raw"},
            "output": {"table": "hackathon.sales.q_forecasts"},
            "inference": {"model_name": MODEL, "horizon": 30,
                          "quantiles": [0.1, 0.5, 0.9], "promote_to": None}}
    out = {}
    for name, mod in (("port", ttasks), ("ref", None)):
        root = runs[name][1]
        env = {"env": {"root": root}}
        if mod is None:
            from distributed_forecasting_tpu.tasks import InferenceTask
            task = InferenceTask(init_conf={**env, **conf})
        else:
            task = mod.InferenceTask(init_conf={**env, **conf}, device="cpu")
        assert task.launch()["rows"] == 6 * 30
        out[name] = task.catalog.read_table("hackathon.sales.q_forecasts")
    got, want = out["port"], out["ref"]
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got[["ds", "store", "item"]],
                                  want[["ds", "store", "item"]])
    _rows_close(got, want, ["q0.1", "q0.5", "q0.9"],
                want[["store", "item"]].drop_duplicates().to_numpy())
    assert (got["q0.1"] <= got["q0.5"]).all() and (
        got["q0.5"] <= got["q0.9"]).all()


def test_workflow_stops_at_monitor_like_the_reference(tmp_path):
    """The monitor node no longer stops the workflow: it runs to its end,
    as the reference's does.  A node of a task type neither package knows
    stops it there, after the nodes before it ran."""
    spec = _conf_file_paths(_spec(monitor=True))
    res = trunner.WorkflowRunner(copy.deepcopy(spec),
                                 env={"root": str(tmp_path)},
                                 device="cpu").run("forecasting-e2e")
    assert list(res) == ["catalog", "etl", "train", "deploy", "inference",
                         "monitor"]
    assert all(r["status"] == "OK" for r in res.values())
    assert "n_drifted" not in res["monitor"]["result"]  # the first version
    spec["workflows"][0]["tasks"].append(
        {"name": "serve", "task": "serve", "depends_on": ["monitor"]})
    with pytest.raises(trunner.WorkflowError,
                       match="unknown task type 'serve'") as err:
        trunner.WorkflowRunner(spec, env={"root": str(tmp_path / "b")},
                               device="cpu").run("forecasting-e2e")
    assert str(sorted(ttasks.TASK_TYPES)) in str(err.value)
    reg = _handles(str(tmp_path / "b"))[2]
    assert reg.latest_version(MODEL).stage == "Staging"


def test_cli_honours_the_platform_switch(tmp_path, monkeypatch, capsys):
    spec = _conf_file_paths(_spec(monitor=True))
    path = tmp_path / "workflows.yml"
    path.write_text(yaml.safe_dump(spec))
    monkeypatch.setenv("DFTPU_PLATFORM", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trunner.main(["-f", str(path), "-w", "forecasting-e2e",
                  "--env-root", str(tmp_path / "root")])
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in printed] == [
        "catalog", "etl", "train", "deploy", "inference", "monitor"]
    assert all(": OK (" in line for line in printed)
    assert _handles(str(tmp_path / "root"))[2].latest_version(MODEL)
    monkeypatch.setenv("DFTPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="DFTPU_PLATFORM"):
        trunner.WorkflowRunner(spec)


def test_task_types_are_the_ported_five():
    """Every task type of the reference's runner, nine in all."""
    from distributed_forecasting_tpu.tasks import TASK_TYPES as REF_TYPES

    assert sorted(ttasks.TASK_TYPES) == sorted(REF_TYPES) == [
        "catalog", "deploy", "inference", "ingest", "monitor", "promote",
        "reconcile", "sample_ml", "train"]
    for mod in ("catalog", "ingest", "train", "deploy", "inference",
                "promote", "monitor", "reconcile", "sample_ml"):
        module = __import__(f"distributed_forecasting_tpu_torch.tasks.{mod}",
                            fromlist=["entrypoint"])
        assert callable(module.entrypoint)


# -- options the port does not run yet ---------------------------------------

def _train_conf(root, **training):
    base = {"model": "prophet", "horizon": 30,
            "cv": {"initial": 400, "period": 180, "horizon": 60}}
    return {"env": {"root": root},
            "input": {"table": "hackathon.sales.raw"},
            "output": {"table": "hackathon.sales.finegrain_forecasts"},
            "training": {**base, **training}}


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ingested"))
    ttasks.IngestTask(init_conf={
        "env": {"root": root},
        "input": {"synthetic": {"n_stores": 1, "n_items": 2, "n_days": 500}},
        "output": {"table": "hackathon.sales.raw"}}, device="cpu").launch()
    return root


# every training option of the reference now runs: arnet (plain, allocated,
# in a pool) and the tuned path since slice 13, arima's method: mle (plain,
# allocated, in a pool; few Adam steps: the CPU twin's filter is a Python
# loop) since slice 14.  ``item`` names a ROADMAP item for an option that
# would raise; none is left.
MLE = {"method": "mle", "fit_steps": 5}
ARNET = {"lags": 7, "epochs": 3}


@pytest.mark.parametrize("training, item", [
    ({"path": "allocated", "model": "arnet", "model_conf": ARNET}, None),
    ({"model": "auto", "model_conf": {"families": ["holt_winters", "arnet"],
                                      "configs": {"arnet": ARNET}}}, None),
    ({"model": "blend", "calibrate_intervals": True,
      "model_conf": {"families": ["croston", "arnet"],
                     "configs": {"arnet": ARNET}}}, None),
    ({"model": "arima", "model_conf": MLE}, None),
    ({"model": "blend", "model_conf": {"families": ["croston", "theta",
                                                     "arnet"],
                                       "configs": {"arnet": ARNET}}}, None),
    ({"tuning": {"enabled": True, "n_trials": 2}}, None),
    ({"bucketed": True}, None),
    ({"regressors": {"table": "hackathon.sales.promo", "columns": ["p"]}},
     None),
    ({"cv_artifact": True}, None),
    ({"model": "auto", "model_conf": {
        "families": ["holt_winters", "arnet"],
        "configs": {"holt_winters": {"season_length": "auto"},
                    "arnet": ARNET}}}, None),
    ({"model": "arnet", "model_conf": ARNET}, None),
    ({"path": "allocated", "model": "arima", "model_conf": MLE}, None),
    ({"model": "auto", "model_conf": {"configs": {"arima": MLE}}}, None),
], ids=["allocated", "auto", "blend", "arima", "croston", "tuning",
        "bucketed", "regressors", "cv_artifact", "season_auto", "arnet",
        "allocated_mle", "auto_mle"])
def test_unported_training_options_raise(ingested, training, item):
    """An option still unported would raise naming its ROADMAP item; the
    ported ones (``item`` None: all of them since arima's ``method: mle``)
    run, every series healthy.  A regressor table missing from the catalog
    raises the catalog's own error, as in the reference."""
    task = ttasks.TrainTask(init_conf=_train_conf(ingested, **training),
                            device="cpu")
    if item is not None:
        with pytest.raises(NotImplementedError,
                           match=rf"ROADMAP Queue 1: {item}"):
            task.launch()
    elif "regressors" in training:
        from distributed_forecasting_tpu_torch.data import TableNotFoundError

        with pytest.raises(TableNotFoundError):
            task.launch()
    elif training.get("path") == "allocated":
        # the allocated summary counts items, not failed series
        assert task.launch()["n_items"] == 2
    else:
        assert task.launch()["n_failed"] == 0


@pytest.mark.parametrize("training, match", [
    ({"calibrate_intervals": True, "bucketed": True}, "bucketed"),
    ({"calibrate_intervals": True, "run_cross_validation": False},
     "run_cross_validation"),
    ({"model": "auto", "calibrate_intervals": True}, "calibrate_intervals"),
    ({"path": "allocated", "calibrate_intervals": True}, "allocated"),
    ({"model": "holt_winters",
      "regressors": {"table": "t.s.x", "columns": ["p"]}},
     "does not accept exogenous"),
    ({"cv_artifact": True, "tuning": {"enabled": True}}, "cv_artifact"),
    ({"freq": "W"}, "calendar-daily"),
], ids=["calibrate_bucketed", "calibrate_without_cv", "calibrate_auto",
        "calibrate_allocated", "regressors_hw", "cv_artifact_tuned",
        "weekly_curve"])
def test_invalid_combinations_raise_the_references_errors(ingested, training,
                                                          match):
    task = ttasks.TrainTask(init_conf=_train_conf(ingested, **training),
                            device="cpu")
    with pytest.raises(ValueError, match=match):
        task.launch()


@pytest.mark.parametrize("conf, item", [
    ({"distributed": {"num_processes": 2, "coordinator_address": "h0:9999",
                      "process_id": 1}}, None),
    ({"precision": {"bf16_scoring": True}}, None),
    ({"engine": {"windowed": {"enabled": True, "window_len": 4096}}}, None),
    ({"engine": {"autoprep": {"enabled": True, "outlier_threshold": 5.0}}},
     None),
    ({"engine": {"gradfit": {"enabled": True, "series_bucket": 8}}}, None),
    ({"engine": {"automl": {"enabled": True, "rungs": 2}}}, None),
], ids=["distributed", "bf16", "windowed", "autoprep", "gradfit", "automl"])
def test_unported_task_blocks_raise(tmp_path, ingested, monkeypatch, conf,
                                    item):
    """Each unported block raises naming its item; ``distributed``,
    ``precision``, ``engine.windowed``, ``engine.autoprep``,
    ``engine.gradfit`` and ``engine.automl`` (``item`` None) are ported:
    the block arms the process-wide config, or, for ``distributed``, brings
    the process into a group through ``initialize_distributed`` with the
    reference's three keys (the reference's
    ``test_task_distributed_conf_plumbing``, held against it).  As in the
    reference, the train task does not call the sweep: armed, its forecast
    is byte-equal to the unarmed one."""
    from distributed_forecasting_tpu_torch.engine import autoprep as tap
    from distributed_forecasting_tpu_torch.engine import gradfit as tgf
    from distributed_forecasting_tpu_torch.engine import hyper as thyper
    from distributed_forecasting_tpu_torch.engine import windowed as twin
    from distributed_forecasting_tpu_torch.ops import precision as tprec

    init_conf = {"env": {"root": str(tmp_path)}, **conf}
    if "distributed" in conf:
        _distributed_block_plumbing(monkeypatch, tmp_path, conf)
        return
    if item is None:
        try:
            ttasks.CatalogTask(init_conf=init_conf, device="cpu")
            if "precision" in conf:
                assert tprec.get_precision().bf16_scoring
                assert tprec.scoring_dtype() is torch.bfloat16
            elif "windowed" in conf["engine"]:
                cfg = twin.windowed_config()
                assert cfg.enabled and cfg.window_len == 4096
                assert twin.should_window(4096 * cfg.min_windows)
            elif "autoprep" in conf["engine"]:
                cfg = tap.autoprep_config()
                assert cfg.enabled and cfg.outlier_threshold == 5.0
            elif "gradfit" in conf["engine"]:
                cfg = tgf.gradfit_config()
                assert cfg.enabled and cfg.series_bucket == 8
            else:
                cfg = thyper.automl_config()
                assert cfg.enabled and cfg.rungs == 2
                tables = []
                for armed in (False, True):
                    thyper.configure_automl(thyper.AutoMLConfig())
                    task_conf = _train_conf(ingested)
                    if armed:
                        task_conf.update(conf)
                    task = ttasks.TrainTask(init_conf=task_conf, device="cpu")
                    assert thyper.automl_config().enabled is armed
                    task.launch()
                    tables.append(task.catalog.read_table(
                        "hackathon.sales.finegrain_forecasts").drop(
                            columns=["training_date"]))
                pd.testing.assert_frame_equal(tables[0], tables[1])
        finally:
            twin.configure_windowed(twin.WindowedConfig())
            tap.configure_autoprep(tap.AutoprepConfig())
            tgf.configure_gradfit(tgf.GradFitConfig())
            thyper.configure_automl(thyper.AutoMLConfig())
            tprec.configure_precision(tprec.PrecisionConfig())
        return
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP Queue 1: {item}"):
        ttasks.CatalogTask(init_conf=init_conf, device="cpu")


def _distributed_block_plumbing(monkeypatch, tmp_path, conf):
    """A task without the block joins no group; with it, the port forwards
    the reference's three keys to ``init_process_group`` (the gloo backend
    for a CPU task, the coordinator as a tcp:// init method) where the
    reference forwards them to ``jax.distributed.initialize``."""
    import jax
    import torch.distributed as dist

    from distributed_forecasting_tpu.parallel import mesh as jmesh
    from distributed_forecasting_tpu.tasks.catalog import CatalogTask
    from distributed_forecasting_tpu_torch.parallel import mesh as tmesh

    jcalls, tcalls = [], []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: jcalls.append(kw))
    monkeypatch.setattr(jmesh, "_DISTRIBUTED_UP", False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: tcalls.append(kw))
    monkeypatch.setattr(tmesh, "_DISTRIBUTED_UP", False)
    monkeypatch.setattr(tmesh, "_RANK_DEVICE", None)
    env = {"env": {"root": str(tmp_path)}}
    CatalogTask(init_conf=env)
    ttasks.CatalogTask(init_conf=env, device="cpu")
    assert jcalls == tcalls == []
    CatalogTask(init_conf={**env, **conf})
    ttasks.CatalogTask(init_conf={**env, **conf}, device="cpu")
    # a second task in the process joins nothing again
    ttasks.CatalogTask(init_conf={**env, **conf}, device="cpu")
    (want,) = jcalls
    assert want == {"coordinator_address": "h0:9999", "num_processes": 2,
                    "process_id": 1}
    assert tcalls == [{
        "backend": "gloo",
        "init_method": f"tcp://{want['coordinator_address']}",
        "world_size": want["num_processes"], "rank": want["process_id"]}]


def _block_conf(block, value):
    """A conf holding ``value`` at the dotted ``block`` path."""
    conf = {}
    node = conf
    *parents, leaf = block.split(".")
    for key in parents:
        node = node.setdefault(key, {})
    node[leaf] = value
    return conf


def _reference_parse(block, conf, root):
    """Where the reference parses ``block``: the Task base for the top-level
    and engine blocks, the serve task for serving.cache, the ingest
    runtime's parser for serving.ingest and build_quality_runtime for
    monitoring.cost (both of which the reference reaches only after the
    model load)."""
    from distributed_forecasting_tpu import tasks as jtasks
    from distributed_forecasting_tpu.monitoring.quality import (
        build_quality_runtime,
    )
    from distributed_forecasting_tpu.serving.ingest import IngestConfig
    from distributed_forecasting_tpu.tasks.serve import ServeTask

    if block == "serving.cache":
        ServeTask(init_conf={"env": {"root": root}, **conf}).launch()
    elif block == "serving.ingest":
        IngestConfig.from_conf(conf["serving"]["ingest"])
    elif block == "monitoring.cost":
        build_quality_runtime(conf["monitoring"], None)
    else:
        jtasks.CatalogTask(init_conf={"env": {"root": root}, **conf})


BAD_VALUES = {
    "compile_cache": {"eviction_policy": "fifo"},
    "pipeline": {"max_in_flight": 0},
    "engine.windowed": {"window_len": 64},
    "engine.autoprep": {"zero_run_min": 1},
    "engine.gradfit": {"series_bucket": 0},
    "engine.automl": {"eta": 1},
    "serving.cache": {"max_horizons": 0},
    "serving.ingest": {"apply_mode": "lazy"},
    "monitoring.cost": {"saturation_window_s": 0},
}


@pytest.mark.parametrize("bad", ["key", "value"])
@pytest.mark.parametrize("block", list(BAD_VALUES))
def test_conf_blocks_parse_like_the_reference(tmp_path, monkeypatch, block,
                                              bad):
    """An unknown key, or one bad value, in each strictly parsed block
    raises the reference's ValueError with the reference's message, before
    any model load."""
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    value = ({"enabled": False, "typo_key": 1} if bad == "key"
             else BAD_VALUES[block])
    conf = _block_conf(block, value)
    with pytest.raises(ValueError) as want:
        _reference_parse(block, conf, str(tmp_path / "ref"))
    monkeypatch.setattr(tserve, "resolve_from_registry", None)
    init_conf = {"env": {"root": str(tmp_path / "port")}, **conf}
    with pytest.raises(ValueError) as got:
        if block.startswith(("serving.", "monitoring.")):
            tserve.ServeTask(init_conf=init_conf, device="cpu").launch()
        else:
            ttasks.CatalogTask(init_conf=init_conf, device="cpu")
    assert str(got.value) == str(want.value)
    if bad == "key":
        assert "typo_key" in str(got.value)


def test_result_neutral_blocks_are_accepted_and_logged(ingested):
    """The training conf's own blocks (conf/tasks/train_config.yml):
    compile_cache and pipeline are armed — the store at
    <env.root>/compile_cache/kernels, the executor config as shipped — and
    no longer logged as having no effect; the engine blocks, all disabled
    there, pass."""
    from distributed_forecasting_tpu_torch.engine import compile_cache as tcc
    from distributed_forecasting_tpu_torch.engine import executor as tex

    with open(os.path.join(ROOT, "conf", "tasks", "train_config.yml")) as f:
        conf = yaml.safe_load(f)
    conf["env"] = {"root": ingested}
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("TrainTask")
    logger.addHandler(handler)
    try:
        tex.configure_pipeline(tex.PipelineConfig(max_in_flight=1))
        ttasks.TrainTask(init_conf=conf, device="cpu")
        store = tcc.get_store()
        assert store is not None
        assert store.directory == os.path.join(ingested, "compile_cache",
                                               "kernels")
        assert os.path.isdir(store.directory)
        assert tcc.get_config() == tcc.CompileCacheConfig.from_conf(
            conf["compile_cache"], default_root=ingested)
        assert tex.pipeline_config() == tex.PipelineConfig.from_conf(
            conf["pipeline"])
    finally:
        logger.removeHandler(handler)
        tcc.configure_compile_cache(tcc.CompileCacheConfig())
        tex.configure_pipeline(tex.PipelineConfig())
    text = [r.getMessage() for r in records]
    for block in ("compile_cache", "pipeline"):
        assert not any(m.startswith(f"{block}: accepted") for m in text), text
    with pytest.raises(ValueError, match="unknown engine conf key"):
        ttasks.TrainTask(init_conf={**conf, "engine": {"turbo": {}}},
                         device="cpu")
    with pytest.raises(ValueError, match="unknown precision conf key"):
        ttasks.TrainTask(init_conf={**conf, "precision": {"bf16": True}},
                         device="cpu")


@pytest.mark.parametrize("meta, error, match", [
    ("ensemble.json", KeyError, "models"), ("blend.json", KeyError, "models"),
    ("buckets.json", KeyError, "n_buckets"),
], ids=["ensemble", "blend", "bucketed"])
def test_composite_artifacts_refuse_to_load(tmp_path, meta, error, match):
    """A composite artifact is recognised by its metadata file: a broken
    one raises; it never loads as a single-family artifact."""
    (tmp_path / meta).write_text("{}")
    with pytest.raises(error, match=match):
        tloader.load_forecaster(str(tmp_path), device="cpu")


def test_inference_regressors_raise(runs):
    """``inference.regressors`` on an artifact fit without regressors: both
    packages read the covariate table, then refuse to forecast with it; a
    table missing from the catalog raises the catalog's error."""
    from distributed_forecasting_tpu.tasks import InferenceTask

    reg = {"table": "hackathon.sales.promo", "columns": ["promo"]}
    conf = {"input": {"table": "hackathon.sales.raw"},
            "inference": {"model_name": MODEL, "horizon": 30,
                          "promote_to": None, "regressors": reg}}
    for name in ("port", "ref"):
        env = {"env": {"root": runs[name][1]}}
        task = (ttasks.InferenceTask(init_conf={**env, **conf}, device="cpu")
                if name == "port" else InferenceTask(init_conf={**env, **conf}))
        with pytest.raises(KeyError):  # the catalog's TableNotFoundError
            task.launch()
        dates = pd.date_range("2013-01-01", periods=1000)
        task.catalog.save_table(reg["table"], pd.DataFrame(
            {"date": dates, "promo": np.arange(1000) % 2 * 1.0}))
        with pytest.raises(ValueError, match="n_regressors == 0"):
            task.launch()


# -- bucketed, regressors, cv_artifact: train, deploy, inference --------------

SLICE_TRAINING = {"model": "prophet", "horizon": 30,
                  "model_conf": {"yearly_order": 0},
                  "cv": {"initial": 200, "period": 60, "horizon": 30}}
COVARIATES = {"table": "hackathon.sales.covariates",
              "columns": ["promo", "price"], "per_series": True}


def _slice_inputs(catalog, option):
    """Reshape the ingested table for ``option``: items 3-4 start at day
    300 (a ragged batch) for ``bucketed``; a covariate table over history
    and horizon, made with numpy from a seed, for ``regressors``."""
    df = catalog.read_table("hackathon.sales.raw")
    if option == "bucketed":
        day = (pd.to_datetime(df["date"]) - pd.to_datetime(df["date"]).min()
               ).dt.days
        catalog.save_table("hackathon.sales.raw",
                           df[(df["item"] < 3) | (day >= 300)]
                           .reset_index(drop=True))
    if option == "regressors":
        rng = np.random.default_rng(7)
        dates = pd.date_range(pd.to_datetime(df["date"]).min(),
                              periods=400 + 30)
        promo = (rng.random(len(dates)) < 0.2) * 1.0
        rows = [pd.DataFrame({"date": dates, "store": s, "item": i,
                              "promo": promo,
                              "price": np.round(rng.uniform(1, 5), 2)
                              + np.cumsum(rng.random(len(dates)) < 0.02)})
                for s, i in df[["store", "item"]].drop_duplicates()
                .itertuples(index=False)]
        catalog.save_table(COVARIATES["table"],
                           pd.concat(rows, ignore_index=True))


def _slice_run(root, package, option):
    from distributed_forecasting_tpu import tasks as jtasks

    types = jtasks.TASK_TYPES if package == "ref" else ttasks.TASK_TYPES
    kw = {} if package == "ref" else {"device": "cpu"}
    env = {"env": {"root": root}}
    types["ingest"](init_conf={
        **env, "input": {"synthetic": {"n_stores": 2, "n_items": 4,
                                       "n_days": 400, "seed": 5}},
        "output": {"table": "hackathon.sales.raw"}}, **kw).launch()
    train = types["train"](init_conf={
        **env, "input": {"table": "hackathon.sales.raw"},
        "output": {"table": "hackathon.sales.finegrain_forecasts"},
        "training": {**SLICE_TRAINING, option: (
            COVARIATES if option == "regressors" else True)}}, **kw)
    _slice_inputs(train.catalog, option)
    out = {"train": train.launch()}
    out["deploy"] = types["deploy"](init_conf={
        **env, "deploy": {"experiment": "finegrain_forecasting",
                          "model_name": MODEL}}, **kw).launch()
    inference = {"model_name": MODEL, "horizon": 30, "promote_to": None}
    if option == "regressors":
        inference.update(regressors=COVARIATES, quantiles=[0.1, 0.5, 0.9])
    out["inference"] = types["inference"](init_conf={
        **env, "input": {"table": "hackathon.sales.raw"},
        "output": {"table": "hackathon.sales.test_finegrain_forecasts"},
        "inference": inference}, **kw).launch()
    return out


@pytest.fixture(scope="module", params=["bucketed", "regressors",
                                        "cv_artifact"])
def slice_runs(request, tmp_path_factory):
    out = {}
    for package in ("ref", "port"):
        root = str(tmp_path_factory.mktemp(f"{request.param}_{package}"))
        out[package] = (_slice_run(root, package, request.param), root)
    return request.param, out


def test_slice_options_run_like_the_reference(slice_runs):
    option, runs = slice_runs
    (got, g_root), (want, w_root) = runs["port"], runs["ref"]
    for k in ("n_series", "n_failed"):
        assert got["train"][k] == want["train"][k]
    assert got["train"]["n_series"] == 8
    assert got["inference"]["rows"] == want["inference"]["rows"]
    gr = _handles(g_root)[1].get_run(got["train"]["experiment_id"],
                                     got["train"]["run_id"])
    wr = _handles(w_root)[1].get_run(want["train"]["experiment_id"],
                                     want["train"]["run_id"])
    gp = gr.params()
    assert gp == wr.params()
    assert gp["tensorize_backend"] == "native"
    if option == "bucketed":
        assert int(gp["n_buckets"]) == 2
    if option == "regressors":
        assert int(gp["n_regressors"]) == 2
    if option == "cv_artifact":
        _check_cv_artifact(runs)
    for table in ("hackathon.sales.finegrain_forecasts",
                  "hackathon.sales.test_finegrain_forecasts"):
        g = _handles(g_root)[0].read_table(table)
        w = _handles(w_root)[0].read_table(table)
        assert list(g.columns) == list(w.columns)
        keyed = [c for c in ("ds", "store", "item", "y") if c in w.columns]
        pd.testing.assert_frame_equal(g[keyed], w[keyed])
        vals = [c for c in w.columns if c.startswith(("yhat", "q0"))]
        _rows_close(g, w, vals,
                    w[["store", "item"]].drop_duplicates().to_numpy())


def test_slice_artifacts_serve_the_inference_table(slice_runs):
    """The registered artifact (buckets.json for the bucketed fit) loads in
    either package and reproduces the port's inference table."""
    from distributed_forecasting_tpu.data import (
        regressors_for_grid as jregressors,
    )
    from distributed_forecasting_tpu.serving.server import (
        load_forecaster as jload,
    )

    option, runs = slice_runs
    root = runs["port"][1]
    catalog, _, registry = _handles(root)
    fc, version = tloader.resolve_from_registry(registry, MODEL, device="cpu")
    served = catalog.read_table("hackathon.sales.test_finegrain_forecasts")
    request = served[["store", "item"]].drop_duplicates().reset_index(
        drop=True)
    art = version.artifact_dir
    if os.path.isdir(os.path.join(art, "forecaster")):
        art = os.path.join(art, "forecaster")
    if option == "bucketed":
        assert os.path.exists(os.path.join(art, "buckets.json"))
        assert type(fc).__name__ == "BucketedForecaster"
    kw = {"horizon": 30}
    if option == "regressors":
        kw["xreg"] = tdata_regressors(catalog, fc)
        got = fc.predict_quantiles(request, quantiles=[0.1, 0.5, 0.9], **kw)
    else:
        got = fc.predict(request, **kw)
    cols = list(served.columns)
    pd.testing.assert_frame_equal(got[cols], served, check_dtype=False)
    ref = jload(art)
    if option == "regressors":
        kw["xreg"] = np.asarray(jregressors(
            catalog.read_table(COVARIATES["table"]), day0=ref.day0,
            n_days=ref.day1 + 30 - ref.day0 + 1,
            regressor_cols=COVARIATES["columns"], per_series=True,
            keys=ref.keys, key_names=ref.key_names))
        want = ref.predict_quantiles(request, quantiles=[0.1, 0.5, 0.9], **kw)
    else:
        want = ref.predict(request, **kw)
    assert list(want.columns) == cols
    vals = [c for c in cols if c.startswith(("yhat", "q0"))]
    _rows_close(got, want, vals, request.to_numpy())


def tdata_regressors(catalog, fc):
    from distributed_forecasting_tpu_torch.data import regressors_for_grid

    return regressors_for_grid(
        catalog.read_table(COVARIATES["table"]), day0=fc.day0,
        n_days=fc.day1 + 30 - fc.day0 + 1,
        regressor_cols=COVARIATES["columns"], per_series=True, keys=fc.keys,
        key_names=fc.key_names, device="cpu")


def _check_cv_artifact(runs):
    """cv_forecasts.parquet: one row per series, cutoff and scored day (the
    ingested history has no gaps), keys, dates, cutoffs and y equal to the
    reference's, forecasts within RTOL of each series' scale."""
    frames, cutoffs = {}, {}
    for package in ("port", "ref"):
        result, root = runs[package]
        run = _handles(root)[1].get_run(result["train"]["experiment_id"],
                                        result["train"]["run_id"])
        frames[package] = pd.read_parquet(
            run.artifact_path("cv_forecasts.parquet"))
        cutoffs[package] = run.metrics()["n_cv_cutoffs"]
    got, want = frames["port"], frames["ref"]
    assert cutoffs["port"] == cutoffs["ref"] == 3
    assert list(got.columns) == ["ds", "store", "item", "cutoff", "y", "yhat",
                                 "yhat_lower", "yhat_upper"]
    assert len(got) == 8 * 3 * 30
    keyed = ["ds", "store", "item", "cutoff", "y"]
    pd.testing.assert_frame_equal(got[keyed], want[keyed])
    for col in ("yhat", "yhat_lower", "yhat_upper"):
        scale = want.groupby(["store", "item"])[col].transform(
            lambda v: np.abs(v).max()).to_numpy()
        np.testing.assert_array_less(
            np.abs(got[col].to_numpy() - want[col].to_numpy()),
            RTOL * scale + 1e-6, err_msg=col)


# -- the ingest task's quality report and the conf loaders --------------------

def _feed(kind):
    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
    )

    df = synthetic_store_item_sales(n_stores=2, n_items=2, n_days=120, seed=3)
    if kind == "duplicates":
        df = pd.concat([df, df.head(5)], ignore_index=True)
    elif kind == "bad_values":
        df.loc[[3, 7], "sales"] = [-1.0, np.nan]
    elif kind == "gaps":
        df = df[df.index % 3 == 0].reset_index(drop=True)
    elif kind == "constant_short":
        df = df[df["date"] < df["date"].min() + pd.Timedelta(days=30)].copy()
        df.loc[df["item"] == 1, "sales"] = 4.0
    elif kind == "empty":
        df = df.head(0)
    return df


@pytest.mark.parametrize("kind", ["clean", "duplicates", "bad_values",
                                  "gaps", "constant_short", "empty"])
@pytest.mark.parametrize("freq", ["D", "W"])
def test_quality_report_matches_reference(kind, freq):
    from distributed_forecasting_tpu.data.quality import (
        quality_report as jreport,
    )
    from distributed_forecasting_tpu_torch.data.quality import (
        quality_report as treport,
    )

    df = _feed(kind)
    got = treport(df, min_days=10 if freq == "W" else 60, freq=freq)
    want = jreport(df, min_days=10 if freq == "W" else 60, freq=freq)
    assert got.to_dict() == want.to_dict()
    assert got.ok == want.ok == (not got.issues)
    # a daily feed checked at weekly precision has same-week duplicates
    assert got.ok == (kind == "clean" and freq == "D")


def test_conf_loaders_match_reference(tmp_path):
    from distributed_forecasting_tpu.utils import config as jconfig
    from distributed_forecasting_tpu_torch.utils import config as tconfig

    path = tmp_path / "c.yml"
    path.write_text("training: {model: prophet, cv: {initial: 730}}\n")
    argv = ["--conf-file", str(path), "--job-id", "7"]
    assert tconfig.parse_conf_args(argv) == jconfig.parse_conf_args(argv) == {
        "training": {"model": "prophet", "cv": {"initial": 730}}}
    for argv in ([], ["--conf-file", str(tmp_path / "missing.yml")]):
        assert tconfig.parse_conf_args(argv) == jconfig.parse_conf_args(argv) == {}
    (tmp_path / "empty.yml").write_text("")
    assert tconfig.load_conf(str(tmp_path / "empty.yml")) == {}
    spec = os.path.join(ROOT, "conf", "workflows.yml")
    assert tconfig.load_conf(spec) == jconfig.load_conf(spec)


def test_phase_timer_and_device_trace(tmp_path):
    from distributed_forecasting_tpu_torch.utils.profiling import (
        PhaseTimer,
        device_trace,
    )

    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("fit"):
            torch.ones(8).sum()
    assert list(timer.metrics()) == ["phase_fit_seconds"]
    assert timer.total() >= 0.0
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


# -- forecasting-blend: model blend | auto, and the promote task -------------

BLEND_MODEL = "ForecastingBlendModel"
BLEND_TASKS = ["catalog", "etl", "train", "deploy", "inference", "promote"]


def _blend_spec(model="blend"):
    """``forecasting-blend`` at the test size; ``model: auto`` runs the
    same pool without calibration (the reference refuses it there)."""
    with open(os.path.join(ROOT, "conf", "workflows.yml")) as f:
        spec = yaml.safe_load(f)
    spec["workflows"] = [w for w in spec["workflows"]
                         if w["name"] == "forecasting-blend"]
    for node in spec["workflows"][0]["tasks"]:
        conf = node.get("conf", {})
        if node["task"] == "ingest":
            conf["input"]["synthetic"] = {
                "n_stores": 2, "n_items": 3, "n_days": 400, "seed": 5}
        if node["task"] == "train":
            tr = conf["training"]
            tr.update(model=model, horizon=30,
                      cv={"initial": 200, "period": 60, "horizon": 30})
            tr["model_conf"]["configs"]["prophet"] = {"yearly_order": 0}
            if model == "auto":
                tr["calibrate_intervals"] = False
        if node["task"] == "inference":
            conf["inference"]["horizon"] = 30
    return _conf_file_paths(spec)


@pytest.fixture(scope="module")
def blend_runs(tmp_path_factory):
    out = {}
    for model in ("blend", "auto"):
        spec = _blend_spec(model)
        for name, runner, kw in (("ref", jrunner, {}),
                                 ("port", trunner, {"device": "cpu"})):
            root = str(tmp_path_factory.mktemp(f"{model}_{name}"))
            res = runner.WorkflowRunner(copy.deepcopy(spec),
                                        env={"root": root}, **kw).run()
            out[model, name] = (res, root)
    return out


@pytest.mark.parametrize("model", ["blend", "auto"])
def test_serve_task_warms_and_serves_a_pooled_artifact(blend_runs, model,
                                                       monkeypatch):
    """The shipped serve conf (``warmup_sizes: [1, 8]``) on a ``model:
    blend`` or ``model: auto`` artifact: the task warms every member and
    serves /invocations.  The warmup runs as many buckets as the
    reference's composite warmup counts on the same artifact (its members'
    predicts stubbed: the count is the composite's logic, the reference's
    ``BatchForecaster.warmup`` counts the buckets it runs): the whole
    ladder to 8 in every family for auto, the two sizes for blend."""
    import json
    import urllib.request

    from distributed_forecasting_tpu.serving import ensemble as jensemble
    from distributed_forecasting_tpu.serving import predictor as jpredictor
    from distributed_forecasting_tpu_torch.serving import ensemble as tens
    from distributed_forecasting_tpu_torch.serving import predictor as tpred
    from distributed_forecasting_tpu_torch.serving import server as tserver
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    _, root = blend_runs[model, "port"]
    conf = _serve_conf(root)
    assert conf["serving"]["warmup_sizes"] == [1, 8]
    conf["serving"].update(model_name=BLEND_MODEL, stage="Production",
                           warmup_horizon=30)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    task = tserve.ServeTask(init_conf=conf, device="cpu")
    task.logger.addHandler(handler)
    try:
        kw = task.server_args()
    finally:
        task.logger.removeHandler(handler)
    fc = kw.pop("forecaster")
    kind = tens.BlendedForecaster if model == "blend" else \
        tens.MultiModelForecaster
    assert isinstance(fc, kind)
    warmed = [r.getMessage() for r in records
              if r.getMessage().startswith("warmed ")]
    assert len(warmed) == 1, warmed

    version = _handles(root)[2].latest_version(BLEND_MODEL,
                                               stage="Production")
    art = os.path.join(version.artifact_dir, "forecaster")
    art = art if os.path.isdir(art) else version.artifact_dir
    monkeypatch.setattr(jpredictor.BatchForecaster, "predict",
                        lambda self, *a, **k: None)
    jkind = jensemble.BlendedForecaster if model == "blend" else \
        jensemble.MultiModelForecaster
    want = jkind.load(art).warmup(horizon=30, sizes=[1, 8])
    assert warmed[0].startswith(f"warmed {want} request-size bucket")
    sizes = [1, 8] if model == "blend" else list(tpred._bucket_ladder([8]))
    assert fc.warmup(horizon=30, sizes=[1, 8]) == sum(
        m.warmup(horizon=30, sizes=sizes) for m in fc.forecasters.values())

    srv = tserver.start_server(fc, host="127.0.0.1", port=0, **{
        k: v for k, v in kw.items() if k not in ("host", "port")})
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        keys = [dict(zip(fc.key_names, map(int, k))) for k in fc.keys[:3]]
        req = urllib.request.Request(
            url + "/invocations",
            data=json.dumps({"inputs": keys, "horizon": 7}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
        assert body == tserver._encode_predictions(
            fc.predict(pd.DataFrame(keys), horizon=7), fc.key_names)
    finally:
        srv.shutdown()


@pytest.mark.parametrize("model", ["blend", "auto"])
def test_pooled_workflow_runs_like_the_reference(blend_runs, model):
    (got, root), (want, _) = blend_runs[model, "port"], blend_runs[model,
                                                                    "ref"]
    for res in (got, want):
        assert list(res) == BLEND_TASKS
        assert all(r["status"] == "OK" for r in res.values())
    g, w = got["train"]["result"], want["train"]["result"]
    assert (g["n_series"], g["n_failed"]) == (w["n_series"], w["n_failed"])
    assert set(g) == set(w)
    for k in g["metrics"]:
        np.testing.assert_allclose(g["metrics"][k], w["metrics"][k],
                                   rtol=1e-3, err_msg=k)
    if model == "auto":
        assert g["chosen_counts"] == w["chosen_counts"]
    p, r = got["promote"]["result"], want["promote"]["result"]
    assert p["promoted"] and r["promoted"]
    assert p["reason"] == r["reason"] == "no champion in Production yet"
    catalog, tracker, registry = _handles(root)
    v = registry.latest_version(BLEND_MODEL)
    assert (v.version, v.stage) == (1, "Production")
    fam = "blend:prophet,holt_winters,croston" if model == "blend" else (
        "auto:" + ",".join(sorted(g["chosen_counts"])))
    assert v.tags["model_family"] == fam
    assert v.tags["promotion_decision"] == "promoted"
    ref_v = _handles(blend_runs[model, "ref"][1])[2].latest_version(
        BLEND_MODEL)
    # the logged metric, printed to 6 digits, within its tolerance
    value = "promotion_candidate_value"
    np.testing.assert_allclose(float(v.tags.pop(value)),
                               float(ref_v.tags.pop(value)), rtol=1e-3)
    assert v.tags == ref_v.tags
    for table in ("hackathon.sales.blend_forecasts",
                  "hackathon.sales.test_blend_forecasts"):
        gt = catalog.read_table(table)
        wt = _handles(blend_runs[model, "ref"][1])[0].read_table(table)
        assert list(gt.columns) == list(wt.columns)
        pd.testing.assert_frame_equal(gt[["ds", "store", "item"]],
                                      wt[["ds", "store", "item"]])
        _rows_close(gt, wt, ["yhat", "yhat_upper", "yhat_lower"],
                    wt[["store", "item"]].drop_duplicates().to_numpy())


@pytest.mark.parametrize("model", ["blend", "auto"])
def test_pooled_run_logs_what_the_reference_logs(blend_runs, model):
    runs = {k: _run(blend_runs[model, k][1], blend_runs[model, k][0])
            for k in ("port", "ref")}
    got, want = runs["port"], runs["ref"]
    assert got.params() == want.params()
    assert got.meta()["tags"] == want.meta()["tags"]
    assert got.meta()["run_name"] == want.meta()["run_name"]
    gm, wm = got.metrics(), want.metrics()
    # the pooled paths log no stage timings, in either package
    assert set(gm) == set(wm)
    for k in gm:
        if k != "fit_seconds":
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-3, err_msg=k)
    gt = pd.read_parquet(got.artifact_path("series_metrics.parquet"))
    wt = pd.read_parquet(want.artifact_path("series_metrics.parquet"))
    assert list(gt.columns) == list(wt.columns)
    exact = ["store", "item"] + (["chosen_model"] if model == "auto" else [])
    pd.testing.assert_frame_equal(gt[exact], wt[exact])
    rest = [c for c in gt.columns if c not in exact]
    np.testing.assert_allclose(gt[rest].to_numpy(float),
                               wt[rest].to_numpy(float), rtol=1e-3)
    meta = "blend.json" if model == "blend" else "ensemble.json"
    art = got.artifact_path("forecaster")
    assert sorted(os.listdir(art)) == sorted(
        os.listdir(want.artifact_path("forecaster")))
    assert meta in os.listdir(art)
    if model == "blend":
        # season_length: auto resolved to the synthetic data's weekly cycle
        fc = tloader.load_forecaster(art, device="cpu")
        assert fc.forecasters["holt_winters"].config.season_length == 7
        assert gt["interval_scale"].gt(0).all()
        w = gt[[f"weight_{f}" for f in ("prophet", "holt_winters",
                                        "croston")]].to_numpy()
        np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-6)


def _promote(root, package, **promote):
    conf = {"env": {"root": root},
            "promote": {"model_name": BLEND_MODEL, **promote}}
    if package == "ref":
        from distributed_forecasting_tpu.tasks.promote import PromoteTask

        return PromoteTask(init_conf=conf).launch()
    return ttasks.PromoteTask(init_conf=conf, device="cpu").launch()


def _second_candidate(root, package):
    """Register the train run once more, as a retrain would, in Staging."""
    conf = {"env": {"root": root},
            "deploy": {"experiment": "blend_forecasting",
                       "model_name": BLEND_MODEL}}
    if package == "ref":
        from distributed_forecasting_tpu.tasks.deploy import DeployTask

        v = DeployTask(init_conf=conf).launch()["version"]
    else:
        v = ttasks.DeployTask(init_conf=conf, device="cpu").launch()["version"]
    _handles(root)[2].transition_stage(BLEND_MODEL, v, "Staging")
    return v


@pytest.mark.parametrize("rule, tolerance, promoted", [
    ("not_worse", 0.02, True), ("improved", 0.0, False)],
    ids=["not_worse", "improved"])
def test_promote_rules_match_reference(blend_runs, tmp_path, rule,
                                       tolerance, promoted):
    """A second candidate with the champion's own metric: ``not_worse``
    promotes it, ``improved`` rejects it; decisions and tags as the
    reference's, each package on its own copy of the store."""
    import shutil

    out = {}
    for package in ("port", "ref"):
        root = str(tmp_path / package)
        shutil.copytree(blend_runs["blend", package][1], root)
        v = _second_candidate(root, package)
        res = _promote(root, package, rule=rule, tolerance=tolerance)
        assert res["candidate_version"] == v == 2
        assert res["promoted"] is promoted
        assert res["baseline_value"] == res["candidate_value"]
        reg = _handles(root)[2]
        out[package] = (res, reg.get_version(BLEND_MODEL, 2))
    (g, gv), (w, wv) = out["port"], out["ref"]
    assert g["reason"].split(":")[0] == w["reason"].split(":")[0]
    assert gv.stage == wv.stage == ("Production" if promoted else "Staging")
    tags = {k: v for k, v in gv.tags.items() if k.startswith("promotion_")}
    assert tags["promotion_decision"] == (
        "promoted" if promoted else "rejected")
    assert tags["promotion_baseline_version"] == "1"
    assert set(tags) == {k for k in wv.tags if k.startswith("promotion_")}
    if not promoted:
        with pytest.raises(RuntimeError, match="promotion gate failed"):
            _promote(str(tmp_path / "port"), "port", rule=rule,
                     candidate_version=2, fail_on_reject=True)


def test_promote_refuses_a_nan_metric_and_bad_confs(blend_runs, tmp_path):
    import json
    import shutil

    root = str(tmp_path / "store")
    shutil.copytree(blend_runs["blend", "port"][1], root)
    v = _second_candidate(root, "port")
    # a candidate that already holds the target stage
    with pytest.raises(ValueError, match="already holds Production"):
        _promote(root, "port", candidate_version=1)
    with pytest.raises(ValueError, match="unknown promote.rule"):
        _promote(root, "port", rule="better")
    with pytest.raises(KeyError, match="has no metric 'val_nope'"):
        _promote(root, "port", metric="val_nope")
    # both versions point at one run: its metric goes NaN for both
    _, tracker, registry = _handles(root)
    run = tracker.get_run(tracker.get_experiment_by_name("blend_forecasting"),
                          registry.get_version(BLEND_MODEL, v).run_id)
    path = os.path.join(run._dir, "metrics.json")
    with open(path) as f:
        metrics = json.load(f)
    metrics["val_smape"] = [[0, float("nan")]]
    with open(path, "w") as f:
        json.dump(metrics, f)
    with pytest.raises(ValueError, match="non-finite val_smape"):
        _promote(root, "port")
    assert registry.get_version(BLEND_MODEL, v).stage == "Staging"


def test_auto_with_default_families_raises_before_any_fit(tmp_path,
                                                          monkeypatch):
    """Every reference family runs through the port since arnet came in: a
    family the registry does not know, added to the default pool, is
    refused by the train task, naming it alone, before the task reads its
    input (the table here does not exist) or runs any CV pass; the pool
    with arnet passes the checks and fails only at the read."""
    from distributed_forecasting_tpu_torch.engine import select as tselect

    calls = []
    monkeypatch.setattr(tselect, "cross_validate",
                        lambda *a, **k: calls.append(1))
    conf = {"env": {"root": str(tmp_path)},
            "input": {"table": "no.such.table"},
            "training": {"model": "auto", "model_conf": {
                "families": [*tselect.DEFAULT_FAMILIES, "arnet", "nope"]}}}
    with pytest.raises(KeyError, match=r"unknown model 'nope'") as err:
        ttasks.TrainTask(init_conf=conf, device="cpu").launch()
    assert "arima" not in str(err.value).split(";")[0]
    conf["training"] = {"model": "blend", "model_conf": {
        "families": ["prophet", "nope"]}}
    with pytest.raises(KeyError, match="'nope'"):
        ttasks.TrainTask(init_conf=conf, device="cpu").launch()
    # the default pool and arnet pass the checks and fail only at the read
    from distributed_forecasting_tpu_torch.data import TableNotFoundError

    for training in ({"model": "auto"}, {"model": "blend", "model_conf": {
            "families": [*tselect.DEFAULT_FAMILIES, "arnet"]}}):
        conf["training"] = training
        with pytest.raises(TableNotFoundError):
            ttasks.TrainTask(init_conf=conf, device="cpu").launch()
    assert calls == []


@pytest.mark.parametrize("model", ["auto", "blend"])
def test_default_pool_trains_on_the_port(ingested, model):
    """No ``families`` key: the pool is the reference's five default
    families, arima among them, and the train task scores and fits every
    one of them on the CPU, then serves the composite artifact."""
    from distributed_forecasting_tpu_torch.engine.select import (
        DEFAULT_FAMILIES,
    )
    from distributed_forecasting_tpu_torch.serving.loader import (
        load_forecaster,
    )

    conf = _train_conf(ingested, model=model, experiment=f"default_{model}",
                       model_conf={"configs": {"prophet": {
                           "yearly_order": 0}}})
    conf["output"]["table"] = f"hackathon.sales.default_{model}"
    res = ttasks.TrainTask(init_conf=conf, device="cpu").launch()
    assert (res["n_series"], res["n_failed"]) == (2, 0)
    _, tracker, _ = _handles(ingested)
    run = tracker.get_run(res["experiment_id"], res["run_id"])
    assert run.params()["families"] == list(DEFAULT_FAMILIES)
    table = pd.read_parquet(os.path.join(run._dir, "artifacts",
                                         "series_metrics.parquet"))
    for name in DEFAULT_FAMILIES:
        assert np.isfinite(table[f"smape_{name}"]).all(), name
    if model == "auto":
        assert set(res["chosen_counts"]) <= set(DEFAULT_FAMILIES)
    else:
        assert set(res["mean_weights"]) == set(DEFAULT_FAMILIES)
        np.testing.assert_allclose(sum(res["mean_weights"].values()), 1.0,
                                   rtol=1e-6)
    fc = load_forecaster(os.path.join(run._dir, "artifacts", "forecaster"),
                         device="cpu")
    out = fc.predict(pd.DataFrame({"store": [1, 1], "item": [2, 1]}),
                     horizon=30)
    assert len(out) == 60 and np.isfinite(out["yhat"]).all()


def test_pooled_cadence_and_bucketed_refusals(ingested):
    conf = _train_conf(ingested, model="blend", freq="W",
                       model_conf={"families": ["prophet", "croston"]})
    with pytest.raises(ValueError, match=r"calendar-daily.*\['prophet'\]"):
        ttasks.TrainTask(init_conf=conf, device="cpu").launch()
    conf = _train_conf(ingested, model="auto", bucketed=True,
                       model_conf={"families": ["croston"]})
    with pytest.raises(ValueError, match="pooled fits run on the shared grid"):
        ttasks.TrainTask(init_conf=conf, device="cpu").launch()


# -- the allocated path, sample_ml, and every workflow to its end ------------

ALLOC_TRAINING = {"path": "allocated", "model": "prophet", "horizon": 30,
                  "model_conf": {"yearly_order": 0}}


def _ingest_and(root, package, task, conf):
    """Ingest 2 stores x 4 items x 400 days into ``root``, then launch
    ``task`` (a task type name) of ``package`` with ``conf``."""
    from distributed_forecasting_tpu import tasks as jtasks

    env = {"env": {"root": root}}
    types = jtasks.TASK_TYPES if package == "ref" else ttasks.TASK_TYPES
    kw = {} if package == "ref" else {"device": "cpu"}
    types["ingest"](init_conf={
        **env, "input": {"synthetic": {"n_stores": 2, "n_items": 4,
                                       "n_days": 400, "seed": 5}},
        "output": {"table": "hackathon.sales.raw"}}, **kw).launch()
    return types[task](init_conf={**env, **conf}, **kw).launch()


@pytest.fixture(scope="module")
def allocated_runs(tmp_path_factory):
    conf = {"input": {"table": "hackathon.sales.raw"},
            "output": {"table": "hackathon.sales.allocated_forecasts"},
            "training": ALLOC_TRAINING}
    out = {}
    for package in ("ref", "port"):
        root = str(tmp_path_factory.mktemp(f"alloc_{package}"))
        out[package] = (_ingest_and(root, package, "train", conf), root)
    return out


def test_allocated_path_matches_reference(allocated_runs):
    (got, groot), (want, wroot) = allocated_runs["port"], allocated_runs["ref"]
    assert set(got) == set(want)
    assert got["n_items"] == want["n_items"] == 4
    table = "hackathon.sales.allocated_forecasts"
    g = _handles(groot)[0].read_table(table)
    w = _handles(wroot)[0].read_table(table)
    assert list(g.columns) == list(w.columns) == [
        "ds", "store", "item", "y", "yhat", "yhat_upper", "yhat_lower",
        "training_date"]
    assert len(g) == len(w) == 8 * 430
    exact = ["ds", "store", "item", "y", "training_date"]
    pd.testing.assert_frame_equal(g[exact], w[exact])
    keys = w[["store", "item"]].drop_duplicates().to_numpy()
    g = g.sort_values(["store", "item", "ds"]).reset_index(drop=True)
    w = w.sort_values(["store", "item", "ds"]).reset_index(drop=True)
    _rows_close(g, w, ["yhat", "yhat_upper", "yhat_lower"], keys)
    assert np.isfinite(g[["yhat", "yhat_upper", "yhat_lower"]]).all().all()

    # each store's rows are the item forecast times its historical share,
    # and the shares of an item sum to 1
    raw = _handles(groot)[0].read_table("hackathon.sales.raw")
    totals = raw.groupby(["store", "item"])["sales"].sum()
    share = totals / totals.groupby(level="item").transform("sum")
    np.testing.assert_allclose(share.groupby(level="item").sum(), 1.0,
                               rtol=1e-12)
    _, tracker, _ = _handles(groot)
    run = tracker.get_run(got["experiment_id"], got["run_id"])
    assert run.params() == {"n_items": 4, "horizon": 30}
    assert run.meta()["run_name"] == "allocated_prophet_fit"
    fc = tloader.load_forecaster(run.artifact_path("forecaster"),
                                 device="cpu")
    assert fc.key_names == ("item",)
    items = pd.DataFrame({"item": [1, 2, 3, 4]})
    item_fc = fc.predict(items, horizon=30)
    future = g[g["ds"] > raw["date"].max()]
    merged = future.merge(item_fc, on=["ds", "item"], suffixes=("", "_item"))
    assert len(merged) == 8 * 30
    ratio = share.loc[list(zip(merged["store"], merged["item"]))].to_numpy()
    np.testing.assert_allclose(merged["yhat"], merged["yhat_item"] * ratio,
                               rtol=1e-5)


def test_allocated_artifact_serves_in_either_package(allocated_runs):
    """The item-keyed artifact (``key_names=("item",)``) written by each
    package predicts alike in both."""
    from distributed_forecasting_tpu.serving import load_forecaster as jload

    items = pd.DataFrame({"item": [3, 1]})
    for package in ("port", "ref"):
        summary, root = allocated_runs[package]
        run = _handles(root)[1].get_run(summary["experiment_id"],
                                        summary["run_id"])
        art = run.artifact_path("forecaster")
        p = tloader.load_forecaster(art, device="cpu").predict(items,
                                                               horizon=30)
        r = jload(art).predict(items, horizon=30)
        assert list(p.columns) == list(r.columns) == [
            "ds", "item", "yhat", "yhat_upper", "yhat_lower"]
        pd.testing.assert_frame_equal(p[["ds", "item"]], r[["ds", "item"]])
        _rows_close(p, r, ["yhat", "yhat_upper", "yhat_lower"],
                    items.to_numpy())


def test_sample_ml_matches_reference(tmp_path):
    conf = {"input": {"table": "hackathon.sales.raw"},
            "experiment": "sample_ml"}
    r2 = {}
    for package in ("port", "ref"):
        root = str(tmp_path / package)
        r2[package] = _ingest_and(root, package, "sample_ml", conf)
        tracker = _handles(root)[1]
        runs = tracker.search_runs(tracker.get_experiment_by_name(
            "sample_ml"))
        assert len(runs) == 1
        assert runs[0].params() == {"n_estimators": 25, "rows": 8 * 400}
        assert runs[0].metrics()["r2"] == r2[package]
    assert r2["port"] == r2["ref"]
    assert 0.0 < r2["port"] <= 1.0


def _small_workflows():
    """Every workflow of conf/workflows.yml at 2 x 4 x 400 days: synthetic
    ingest in place of the committed dataset, CV 200/60/30, horizons of at
    most 30 days, the curve model without yearly terms (see above)."""
    with open(os.path.join(ROOT, "conf", "workflows.yml")) as f:
        spec = yaml.safe_load(f)
    for wf in spec["workflows"]:
        for node in wf["tasks"]:
            conf = node.get("conf", {})
            if node["task"] == "ingest":
                conf["input"] = {"synthetic": {
                    "n_stores": 2, "n_items": 4, "n_days": 400, "seed": 3}}
            if node["task"] == "train":
                tr = conf["training"]
                tr["horizon"] = min(int(tr["horizon"]), 30)
                if "cv" in tr:
                    tr["cv"] = {"initial": 200, "period": 60, "horizon": 30}
                if tr["model"] == "prophet":
                    tr["model_conf"] = {"yearly_order": 0}
                if tr["model"] == "blend":
                    tr["model_conf"].setdefault("configs", {})[
                        "prophet"] = {"yearly_order": 0}
            if node["task"] == "reconcile":
                conf["reconcile"]["cv"] = {"initial": 200, "period": 60,
                                           "horizon": 30}
            if node["task"] == "inference":
                conf["inference"]["horizon"] = 30
    return _conf_file_paths(spec)


WORKFLOWS = ["forecasting-e2e", "forecasting-blend", "real-data-e2e",
             "hierarchical-m5", "allocated-baseline"]


@pytest.mark.parametrize("name", WORKFLOWS)
def test_every_workflow_runs_to_its_end(tmp_path, name):
    spec = _small_workflows()
    assert [w["name"] for w in spec["workflows"]] == WORKFLOWS
    nodes = next(w["tasks"] for w in spec["workflows"] if w["name"] == name)
    res = trunner.WorkflowRunner(spec, env={"root": str(tmp_path)},
                                 device="cpu").run(name)
    assert list(res) == [n["name"] for n in nodes]
    assert all(r["status"] == "OK" for r in res.values())
    last = res[nodes[-1]["name"]]["result"]
    if name == "hierarchical-m5":
        assert (last["method"], last["weights"], last["n_nodes"],
                last["n_days"]) == ("mint", "cv", 1 + 2 + 4 + 8, 28)
    if name == "allocated-baseline":
        assert last["n_items"] == 4
    if nodes[-1]["task"] == "monitor":
        assert last["rows"] > 0 and "n_anomalies" in last


# -- the serve task (tasks/serve.py) ------------------------------------------


def _serve_conf(root, **serving):
    """conf/tasks/serve_config.yml as shipped, on ``root``, port 0 on
    localhost."""
    with open(os.path.join(ROOT, "conf", "tasks", "serve_config.yml")) as f:
        conf = yaml.safe_load(f)
    conf["env"] = {"root": root}
    conf["serving"].update(host="127.0.0.1", port=0, model_name=MODEL,
                           **serving)
    return conf


@pytest.mark.parametrize("block, item", [
    ("serving.ingest", None), ("serving.cache", None),
    ("serving.tracing.debug_endpoints", "served"),
], ids=["ingest", "cache", "debug_endpoints"])
def test_serve_task_refuses_unported_blocks_before_loading(tmp_path,
                                                           monkeypatch,
                                                           request,
                                                           block, item):
    """The registry under tmp_path is empty: had the task reached the model
    load, it would fail there instead.  ``serving.ingest`` and
    ``serving.cache`` are ported: each block parses and the task goes on to
    the load (here a stub that raises).  ``tracing.debug_endpoints: true``
    is ported too: on the forecasting-e2e store the task starts and
    ``/debug/trace`` answers with the ``http.request`` span of a request
    before it."""
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    if item == "served":
        _serve_with_debug_endpoints(request.getfixturevalue("runs"),
                                    monkeypatch)
        return

    def load(*args, **kwargs):
        raise LookupError("reached the model load")

    monkeypatch.setattr(tserve, "resolve_from_registry", load)
    conf = _serve_conf(str(tmp_path))
    section, *path = block.split(".")
    node = conf[section]
    for key in path[:-1]:
        node = node[key]
    node[path[-1]]["enabled"] = True
    with pytest.raises(LookupError, match="reached the model load"):
        tserve.ServeTask(init_conf=conf, device="cpu").launch()


def _serve_with_debug_endpoints(runs, monkeypatch):
    """The shipped serve conf with ``tracing.debug_endpoints: true`` on the
    port's forecasting-e2e store: the task configures the tracer, starts,
    and ``GET /debug/trace`` holds the span tree of a ``/invocations``
    sent before it."""
    import json
    import urllib.request

    from distributed_forecasting_tpu_torch.monitoring import trace as ttrace
    from distributed_forecasting_tpu_torch.serving import server as tserver
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    started = {}

    def start(forecaster, host, port, **kw):
        started["srv"] = tserver.start_server(forecaster, host=host,
                                              port=port, **kw)

    monkeypatch.setattr(tserve, "serve", start)
    _, root = runs["port"]
    conf = _serve_conf(root, warmup_sizes=[1])
    conf["serving"]["tracing"]["debug_endpoints"] = True
    conf["monitoring"]["quality_store"]["directory"] = os.path.join(
        root, "quality_store_debug")
    try:
        tserve.ServeTask(init_conf=conf, device="cpu").launch()
        srv = started["srv"]
        assert ttrace.get_tracer().config.debug_endpoints
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            fc = srv.forecaster
            key = dict(zip(fc.key_names, map(int, fc.keys[0])))
            req = urllib.request.Request(
                url + "/invocations",
                data=json.dumps({"inputs": [key], "horizon": 7}).encode(),
                headers={"X-Trace-Id": "debugtrace01"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.headers["X-Trace-Id"] == "debugtrace01"
            with urllib.request.urlopen(url + "/debug/trace",
                                        timeout=60) as r:
                assert r.status == 200
                doc = json.loads(r.read())
        finally:
            srv.shutdown()
    finally:
        ttrace.configure_tracing(ttrace.TraceConfig())
    mine = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"
            and e["args"].get("trace_id") == "debugtrace01"}
    assert {"http.request", "serving.predict", "aot.call"} <= mine, mine


def test_serve_task_serves_through_the_forecast_cache(runs, monkeypatch):
    """The shipped serve conf with ``serving.cache`` on (one quantile set)
    on the port's forecasting-e2e store: the task builds the cache and
    hands it to the server; a point and a quantile ``/invocations`` each
    answer twice from it with the body of the forecaster's own dispatch,
    and ``/metrics`` carries the ``dftpu_cache_*`` families."""
    import json
    import urllib.request

    from distributed_forecasting_tpu_torch.serving import server as tserver
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    started = {}

    def start(forecaster, host, port, **kw):
        started["srv"] = tserver.start_server(forecaster, host=host,
                                              port=port, **kw)

    monkeypatch.setattr(tserve, "serve", start)
    _, root = runs["port"]
    conf = _serve_conf(root, warmup_sizes=[1])
    conf["serving"]["cache"].update(enabled=True,
                                    quantile_sets=[[0.9, 0.1, 0.5]])
    conf["monitoring"]["quality_store"]["directory"] = os.path.join(
        root, "quality_store_cache")
    tserve.ServeTask(init_conf=conf, device="cpu").launch()
    srv = started["srv"]
    try:
        fc, cache = srv.forecaster, srv.cache
        assert cache is not None and cache.config.mmap_dir is None
        assert cache.config.quantile_sets == ((0.1, 0.5, 0.9),)
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        inputs = [dict(zip(fc.key_names, map(int, k))) for k in fc.keys[:3]]
        req = pd.DataFrame(fc.keys[:3], columns=list(fc.key_names))
        for body, want in (
                ({"inputs": inputs, "horizon": 7},
                 fc.predict(req, horizon=7)),
                ({"inputs": inputs, "horizon": 7,
                  "quantiles": [0.5, 0.1, 0.9]},
                 fc.predict_quantiles(req, quantiles=(0.1, 0.5, 0.9),
                                      horizon=7))):
            for _ in range(2):
                call = urllib.request.Request(
                    url + "/invocations", data=json.dumps(body).encode())
                with urllib.request.urlopen(call, timeout=60) as r:
                    assert r.read() == tserver._encode_predictions(
                        want, fc.key_names)
        assert cache.metrics.hits.value == 4
        assert cache.metrics.rebuilds.value == 2
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
        assert "dftpu_cache_hits_total 4" in text
        assert "dftpu_cache_entries 2" in text
    finally:
        srv.shutdown()


@pytest.mark.parametrize("serving, match", [
    ({"batching": {"max_batchsize": 8}}, "unknown batching conf key"),
    ({"http": {"pool_sizes": 2}}, "unknown serving.http conf key"),
    ({"tracing": {"ring": 1}}, "unknown tracing conf key"),
    ({"anomaly": {"enabled": True, "treshold": 1}},
     "unknown serving.anomaly conf key"),
    ({"cache": {"enabled": True, "max_horizon": 4}},
     "unknown serving.cache conf key"),
], ids=["batching", "http", "tracing", "anomaly", "cache"])
def test_serve_task_conf_typos_fail_before_loading(tmp_path, monkeypatch,
                                                   serving, match):
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    monkeypatch.setattr(tserve, "resolve_from_registry", None)
    with pytest.raises(ValueError, match=match):
        tserve.ServeTask(init_conf=_serve_conf(str(tmp_path), **serving),
                         device="cpu").launch()


def test_serve_task_serves_the_registered_model(runs, monkeypatch):
    """The shipped serve conf on the forecasting-e2e store: the task resolves
    the Staging version, warms, starts the quality store's scrape loop and
    the SLO evaluator (store under ``<env.root>/quality_store``, staleness
    from the env's tracking root), serves /invocations and /observe, and
    configures the tracer and the cost layer from their blocks."""
    import json
    import urllib.request

    from distributed_forecasting_tpu_torch.engine import compile_cache as tcc
    from distributed_forecasting_tpu_torch.monitoring import cost as tcost
    from distributed_forecasting_tpu_torch.monitoring import trace as ttrace
    from distributed_forecasting_tpu_torch.serving import server as tserver
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    started = {}

    def start(forecaster, host, port, **kw):  # serve() without blocking
        started["srv"] = tserver.start_server(forecaster, host=host,
                                              port=port, **kw)

    monkeypatch.setattr(tserve, "serve", start)
    _, root = runs["port"]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("ServeTask").addHandler(handler)
    try:
        tserve.ServeTask(init_conf=_serve_conf(root), device="cpu").launch()
    finally:
        logging.getLogger("ServeTask").removeHandler(handler)
    srv = started["srv"]
    try:
        text = [r.getMessage() for r in records]
        # compile_cache is armed by the Task base (its store under the env
        # root, the cache's counts logged after the warmup); tracing and
        # the cost block take effect: the tracer and the cost layer are
        # configured from the shipped blocks and nothing logs them as
        # having no effect
        assert not any("no effect" in m for m in text), text
        tracer = ttrace.get_tracer()
        assert tracer.config == ttrace.TraceConfig.from_conf(
            _serve_conf(root)["serving"]["tracing"])
        assert tcost.get_cost_config() == tcost.CostConfig.from_conf(
            _serve_conf(root)["monitoring"]["cost"])
        assert not any(m.startswith("compile_cache: accepted")
                       for m in text), text
        assert tcc.get_store().directory == os.path.join(
            root, "compile_cache", "kernels")
        assert any(m.startswith("compile cache after warmup: ")
                   for m in text), text
        assert any(m.startswith("warmed 2 request-size bucket") for m in text)
        assert ("quality observability on (monitor=True store=True "
                "slo=True)") in text
        quality = srv.quality
        assert quality.store.directory == os.path.join(root, "quality_store")
        assert os.path.isdir(os.path.join(root, "quality_store"))
        assert quality.scrape._thread.is_alive()
        assert quality.slo._thread.is_alive()
        assert quality.slo._latency is srv.metrics.latency
        assert srv.anomaly is None  # serving.anomaly ships disabled
        state = quality.slo.evaluate_once()
        stale = next(r for r in state["rules"]
                     if r["name"] == "model_staleness")
        assert stale["bad"] is False and 0 <= stale["sli"] < 3600
        fc = srv.forecaster
        assert srv.model_version == str(_handles(root)[2].latest_version(
            MODEL, stage="Staging").version)
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        keys = [dict(zip(fc.key_names, map(int, k))) for k in fc.keys[:2]]
        req = urllib.request.Request(
            url + "/invocations",
            data=json.dumps({"inputs": keys, "horizon": 7}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
        want = tserver._encode_predictions(
            fc.predict(pd.DataFrame(keys), horizon=7), fc.key_names)
        assert body == want
        catalog = _handles(root)[0]
        hist = catalog.read_table("hackathon.sales.finegrain_forecasts")
        hist = hist[hist["y"].notna()].tail(20)
        obs = [{"store": int(r.store), "item": int(r.item),
                "ds": str(pd.Timestamp(r.ds).date()), "y": float(r.y)}
               for r in hist.itertuples()]
        req = urllib.request.Request(
            url + "/observe", data=json.dumps({"observations": obs}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            summary = json.loads(r.read())
        assert summary["observations"] == 20
        assert summary["nominal_coverage"] == 0.95
    finally:
        srv.shutdown()
    assert not quality.scrape._thread and not quality.slo._thread
    names = {p["name"] for p in quality.store.query()}
    assert {"dftpu_quality_wape", "serving_requests_total",
            "dftpu_slo_evaluations_total", "dftpu_slo_bad"} <= names


def test_serve_task_runs_the_anomaly_scorer(runs, monkeypatch):
    """``serving.anomaly.enabled: true`` on the shipped conf: the scorer is
    built with its stream under ``<env.root>/anomaly_stream`` and answers
    /detect_anomalies with the in-process scorer's body."""
    import json
    import urllib.request

    from distributed_forecasting_tpu_torch.serving import server as tserver
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    started = {}

    def start(forecaster, host, port, **kw):
        started["srv"] = tserver.start_server(forecaster, host=host,
                                              port=port, **kw)

    monkeypatch.setattr(tserve, "serve", start)
    _, root = runs["port"]
    conf = _serve_conf(root, warmup_sizes=[1])
    conf["serving"]["anomaly"]["enabled"] = True
    conf["monitoring"]["quality_store"]["directory"] = os.path.join(
        root, "quality_store_anomaly")
    tserve.ServeTask(init_conf=conf, device="cpu").launch()
    srv = started["srv"]
    try:
        scorer = srv.anomaly
        assert scorer.store.directory == os.path.join(root, "anomaly_stream")
        assert scorer._execute == srv.execute
        fc = srv.forecaster
        catalog = _handles(root)[0]
        hist = catalog.read_table("hackathon.sales.finegrain_forecasts")
        hist = hist[hist["y"].notna()].tail(30)
        pts = [{"store": int(r.store), "item": int(r.item),
                "ds": str(pd.Timestamp(r.ds).date()),
                "y": float(r.y) * (8.0 if i % 10 == 0 else 1.0) + (
                    200.0 if i % 10 == 0 else 0.0)}
               for i, r in enumerate(hist.itertuples())]
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        req = urllib.request.Request(
            url + "/detect_anomalies",
            data=json.dumps({"points": pts}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
        from distributed_forecasting_tpu_torch.serving.anomaly import (
            AnomalyScorer,
        )

        want = AnomalyScorer(fc, scorer.config).score(pd.DataFrame(pts))
        assert body == json.dumps(want).encode()
        out = json.loads(body)
        assert out["n_scored"] == 30
        assert all(out["results"][i]["is_anomaly"] for i in (0, 10, 20))
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
        assert "dftpu_anomaly_requests_total 1" in text
        assert scorer.store.query(name="dftpu_anomaly_point")
    finally:
        srv.shutdown()


def _register_streamed(root, sidecar: bool):
    """A Holt-Winters artifact fit by the port on a synthetic table,
    registered in Staging under ``root`` (with a ``history.npz`` sidecar of
    its training y / mask when ``sidecar``, as whoever registers a
    streamed model writes it)."""
    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
        tensorize,
    )
    from distributed_forecasting_tpu_torch.models.base import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    batch = tensorize(synthetic_store_item_sales(n_stores=2, n_items=3,
                                                 n_days=200, seed=4),
                      device="cpu")
    fns = get_model("holt_winters")
    cfg = fns.config_cls()
    params = fns.fit(batch.y, batch.mask, batch.day, cfg)
    art = os.path.join(root, "artifact")
    BatchForecaster.from_fit(batch, params, "holt_winters", cfg).save(art)
    if sidecar:
        np.savez(os.path.join(art, "history.npz"), y=batch.y.numpy(),
                 mask=batch.mask.numpy())
    registry = _handles(root)[2]
    version = registry.register_model(MODEL, art)
    registry.transition_stage(MODEL, version.version, "Staging")
    return batch


@pytest.mark.parametrize("sidecar", [True, False],
                         ids=["sidecar", "no_sidecar"])
def test_serve_task_runs_streaming_ingest(tmp_path, monkeypatch, sidecar):
    """The shipped serve conf with ``serving.ingest.enabled: true`` and its
    refit block on: the task builds the runtime (WAL under
    ``<env.root>/ingest_wal``); with the ``history.npz`` sidecar the refit
    scheduler runs, without it the refit block is dropped with the
    reference's warning and the incremental path serves alone.  POST
    /ingest then freshens /invocations."""
    import json
    import urllib.request

    from distributed_forecasting_tpu_torch.serving import server as tserver
    from distributed_forecasting_tpu_torch.tasks import serve as tserve

    root = str(tmp_path)
    _register_streamed(root, sidecar)
    conf = _serve_conf(root, warmup_sizes=[1])
    conf["serving"]["ingest"]["enabled"] = True
    conf["serving"]["ingest"]["refit"]["enabled"] = True
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("ServeTask").addHandler(handler)
    try:
        kw = tserve.ServeTask(init_conf=conf, device="cpu").server_args()
    finally:
        logging.getLogger("ServeTask").removeHandler(handler)
    text = [r.getMessage() for r in records]
    ingest = kw["ingest"]
    assert ingest.wal.directory == os.path.join(root, "ingest_wal")
    warning = ("serving.ingest.refit is enabled but the artifact has no "
               "history.npz sidecar; serving incremental-only")
    if sidecar:
        assert ingest.refit is not None and ingest.store.can_refit
        assert warning not in text
    else:
        assert ingest.refit is None and not ingest.store.can_refit
        assert warning in text
    kw.update(port=0, host="127.0.0.1")
    srv = tserver.start_server(**kw)
    try:
        fc = srv.forecaster
        day1 = int(fc.day1)
        keys = [dict(zip(fc.key_names, map(int, k))) for k in fc.keys]
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        points = [{**k, "d": day1 + 1, "y": 20.0} for k in keys]
        req = urllib.request.Request(
            url + "/ingest", data=json.dumps({"points": points}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            ack = json.loads(r.read())
        assert ack["written"] == len(keys)
        assert ack["applied"]["points"] == len(keys)
        req = urllib.request.Request(
            url + "/invocations",
            data=json.dumps({"inputs": keys[:1], "horizon": 3}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            preds = json.loads(r.read())["predictions"]
        first = pd.Timestamp(preds[0]["ds"])
        assert first == pd.Timestamp("1970-01-01") + pd.Timedelta(
            days=day1 + 2)
    finally:
        srv.shutdown()



# -- the fleet task (tasks/fleet.py) ------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fleet_task_hands_its_children_the_store_failpoints_and_device(
        tmp_path, monkeypatch, device):
    """The shipped serve conf, unchanged apart from the env root, sharding
    on and a failpoint spec, run by ``FleetTask`` with
    ``subprocess.Popen`` replaced by fakes that record what each replica
    child is started with and answer ``/readyz`` on its port: every child
    runs ``-m distributed_forecasting_tpu_torch.serving.replica`` with its
    shard assignment, the kernel store's directory, the failpoint spec
    and seed, and the task's device switch (``cpu`` only when the task
    was asked for the CPU; ``torch.cuda.is_available`` is patched for the
    ``cuda`` case, so nothing touches a card).  The front door answers and
    holds no CUDA context."""
    import json
    import urllib.request

    from distributed_forecasting_tpu_torch.engine import compile_cache as tcc
    from distributed_forecasting_tpu_torch.monitoring import failpoints as fp
    from distributed_forecasting_tpu_torch.serving import fleet as tfleet
    from distributed_forecasting_tpu_torch.tasks.fleet import FleetTask
    from distributed_forecasting_tpu_torch.tracking import ModelRegistry
    from test_torch_fleet import _FakeProc, _make_fake_replica

    if device == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    root = str(tmp_path)
    art = tmp_path / "artifact"
    art.mkdir()
    (art / "meta.json").write_text("{}")
    registry = ModelRegistry(os.path.join(root, "registry"))
    version = registry.register_model(MODEL, str(art))
    registry.transition_stage(MODEL, version.version, "Staging")
    conf = _serve_conf(root)
    conf["serving"]["sharding"]["enabled"] = True
    conf["serving"]["resilience"].update(
        failpoints="wal.read=sleep 1:0.5", failpoint_seed=5)
    conf["serving"]["fleet"].update(health_poll_interval_s=0.05)
    children = []

    def popen(argv, env):
        rconf = json.loads(argv[argv.index("--conf") + 1])
        children.append((argv, env, rconf))
        return _FakeProc(_make_fake_replica(rconf["port"]))

    monkeypatch.setattr(tfleet.subprocess, "Popen", popen)
    task = FleetTask(init_conf=conf, device=None if device == "cuda"
                     else "cpu")
    sup, front = task.start()
    try:
        assert len(children) == 2
        owned = set()
        for argv, env, rconf in children:
            assert argv[1:3] == ["-m",
                                 "distributed_forecasting_tpu_torch.serving."
                                 "replica"]
            assert env["DFTPU_COMPILE_CACHE"] == os.path.join(
                root, "compile_cache")
            assert env["DFTPU_FAILPOINTS"] == "wal.read=sleep 1:0.5"
            assert env["DFTPU_FAILPOINTS_SEED"] == "5"
            assert env["DFTPU_PLATFORM"] == device
            assert rconf["artifact_dir"] == version.artifact_dir
            assert rconf["sharding"]["num_shards"] == 8
            assert rconf["monitoring"]["tracking_root"] == os.path.join(
                root, "mlruns")
            owned |= set(rconf["shards"])
        assert owned == set(range(8))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{front.server_address[1]}/readyz",
                timeout=30) as r:
            assert json.loads(r.read())["ready_replicas"] == 2
        assert not torch.cuda.is_initialized()
        assert "CUDA initialized in this process: False" in task.cuda_note()
    finally:
        front.shutdown()
        sup.stop()
        fp.deactivate()
        tcc.configure_compile_cache(tcc.CompileCacheConfig(enabled=False))


def test_fleet_task_refuses_conf_typos_before_the_registry(tmp_path):
    from distributed_forecasting_tpu_torch.tasks.fleet import FleetTask

    for block, bad, match in (
            ("fleet", {"replica": 2}, "serving.fleet"),
            ("sharding", {"num_shard": 4}, "serving.sharding"),
            ("resilience", {"breaker_failues": 3}, "serving.resilience"),
            ("http", {"pool_sizes": 2}, "serving.http")):
        conf = _serve_conf(str(tmp_path))
        conf["serving"][block] = bad
        with pytest.raises(ValueError, match=match):
            FleetTask(init_conf=conf, device="cpu").start(
                spawn_fn=lambda *a: None)
