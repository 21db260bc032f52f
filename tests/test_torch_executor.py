"""The port's pipelined training executor (``engine/executor.py``) and the
training path through it, against the reference's.

The executor's mechanics are the reference's unit cases, run on the port:
the strict ``pipeline:`` parse (with the reference's messages),
submission-order completion, the in-flight bound, the error contract, the
serial mode, ``prefetch_to_device``'s order, values and lookahead, the
``pipeline_*`` families on the scorer's ``/metrics``.  ``stage_metrics``
carries the reference's keys, and a pipelined experiment's four
``pipeline.*`` spans share one trace id across the caller and writer
threads.

The training path: the train task from ``conf/tasks/train_config.yml``
(as shipped: the curve model; and ``model: holt_winters``) writes the same
frame, artifact and tracking rows byte for byte pipelined and with
``async_tracking: false`` (the run's timings aside: ``fit_seconds``,
``series_per_second``, ``phase_*``, ``pipeline_*``) and logs the
reference's ``pipeline_*`` run metrics.  ``run_many`` of three
experiments (theta, croston, Holt-Winters) returns the reference's
structure; its forecasts agree with the reference's within 1e-5 of each
series' scale (the families' float32 recurrences round differently from
XLA's fused ones by up to ~6e-6 of scale, test_torch_engine.py and
test_torch_theta.py) and its CV means within rtol 1e-4 (averages of
those forecasts' errors).  Every test puts the process-wide pipeline
config back.
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from distributed_forecasting_tpu.engine import executor as jex
from distributed_forecasting_tpu_torch.engine import executor as tex

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5      # forecasts, of each series' scale
CV_RTOL = 1e-4   # CV metric means


@pytest.fixture(autouse=True)
def reset_pipeline():
    try:
        yield
    finally:
        tex.configure_pipeline(tex.PipelineConfig())
        jex.configure_pipeline(jex.PipelineConfig())


def _noop_prep():
    return {}


# -- conf ------------------------------------------------------------------------

def test_pipeline_config_defaults_and_from_conf():
    c = tex.PipelineConfig.from_conf(None)
    assert c.enabled and c.async_tracking
    assert c.max_in_flight == 2 and c.prefetch_depth == 1
    c = tex.PipelineConfig.from_conf(
        {"enabled": False, "max_in_flight": 4, "prefetch_depth": 0,
         "async_tracking": False})
    assert not c.enabled and not c.async_tracking
    assert c.max_in_flight == 4 and c.prefetch_depth == 0


@pytest.mark.parametrize("conf", [
    {"max_inflight": 3}, {"max_in_flight": 0}, {"prefetch_depth": -1},
    [1, 2],
], ids=["key", "in_flight", "depth", "not_a_mapping"])
def test_pipeline_config_refuses_what_the_reference_refuses(conf):
    with pytest.raises(ValueError) as want:
        jex.PipelineConfig.from_conf(conf)
    with pytest.raises(ValueError) as got:
        tex.PipelineConfig.from_conf(conf)
    assert str(got.value) == str(want.value)


def test_configure_pipeline_is_process_wide():
    cfg = tex.PipelineConfig(max_in_flight=3, async_tracking=False)
    assert tex.configure_pipeline(cfg) is cfg
    assert tex.pipeline_config() is cfg
    assert tex.TrainingExecutor().config is cfg


def test_sanctioned_pull_marker():
    assert getattr(tex.device_pull, "__dftpu_sanctioned_pull__", False)

    @tex.sanctioned_pull
    def my_pull(x):
        return x

    assert my_pull.__dftpu_sanctioned_pull__
    tex.device_pull(None)  # a dispatch that queued nothing waits for nothing


# -- mechanics -------------------------------------------------------------------

def test_executor_completes_in_submission_order():
    completed = []

    def make(i, delay):
        def dispatch(state):
            state["i"], state["delay"] = i, delay
            return state

        def complete(state):
            time.sleep(state["delay"])  # earlier, slower ones still first
            completed.append(state["i"])
            return state["i"]

        return dispatch, complete

    ex = tex.TrainingExecutor(tex.PipelineConfig(max_in_flight=3))
    with ex:
        handles = []
        for i, delay in enumerate([0.05, 0.0, 0.02, 0.0]):
            d, c = make(i, delay)
            handles.append(ex.submit(f"e{i}", _noop_prep, d, c))
        ex.flush()
    assert completed == [0, 1, 2, 3]
    assert [h.result(timeout=5) for h in handles] == [0, 1, 2, 3]


def test_executor_bounds_in_flight():
    peak = {"now": 0, "max": 0}
    lock = threading.Lock()

    def dispatch(state):
        with lock:
            peak["now"] += 1
            peak["max"] = max(peak["max"], peak["now"])
        return state

    def complete(state):
        time.sleep(0.02)
        with lock:
            peak["now"] -= 1

    ex = tex.TrainingExecutor(tex.PipelineConfig(max_in_flight=2))
    with ex:
        for i in range(6):
            ex.submit(f"e{i}", _noop_prep, dispatch, complete)
    assert peak["max"] <= 2


def test_executor_error_propagates_from_flush_and_handle():
    boom = RuntimeError("tracking write failed")

    def complete(state):
        raise boom

    ex = tex.TrainingExecutor(tex.PipelineConfig())
    h = ex.submit("bad", _noop_prep, lambda s: s, complete)
    with pytest.raises(RuntimeError, match="tracking write failed") as ei:
        ex.flush()
    assert ei.value is boom  # the original exception object
    with pytest.raises(RuntimeError, match="tracking write failed"):
        h.result(timeout=5)
    with pytest.raises(RuntimeError):
        ex.close()


def test_executor_error_does_not_skip_later_experiments():
    done = []

    def bad_complete(state):
        raise ValueError("first fails")

    def good_complete(state):
        done.append(True)
        return "ok"

    ex = tex.TrainingExecutor(tex.PipelineConfig(max_in_flight=2))
    h1 = ex.submit("bad", _noop_prep, lambda s: s, bad_complete)
    h2 = ex.submit("good", _noop_prep, lambda s: s, good_complete)
    with pytest.raises(ValueError):
        ex.flush()
    assert h2.result(timeout=5) == "ok" and done == [True]
    with pytest.raises(ValueError):
        h1.result(timeout=5)
    with pytest.raises(ValueError):
        ex.close()


def test_executor_prep_error_raises_on_caller_thread():
    def prep():
        raise KeyError("bad prep")

    ex = tex.TrainingExecutor(tex.PipelineConfig())
    with pytest.raises(KeyError):
        ex.submit("bad", prep, lambda s: s, lambda s: None)
    h = ex.submit("good", _noop_prep, lambda s: s, lambda s: "ok")
    ex.flush()  # the slot was released
    assert h.result(timeout=5) == "ok"
    ex.close()


def test_executor_serial_mode_runs_inline():
    thread_ids = []

    def complete(state):
        thread_ids.append(threading.get_ident())
        return "done"

    ex = tex.TrainingExecutor(tex.PipelineConfig(async_tracking=False))
    h = ex.submit("s", _noop_prep, lambda s: s, complete)
    assert h.done() and h.result() == "done"
    assert thread_ids == [threading.get_ident()]  # no writer thread
    ex.close()


def test_executor_close_idempotent_and_submit_after_close():
    ex = tex.TrainingExecutor(tex.PipelineConfig())
    ex.submit("a", _noop_prep, lambda s: s, lambda s: None)
    ex.close()
    ex.close()
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit("b", _noop_prep, lambda s: s, lambda s: None)


@pytest.mark.parametrize("async_tracking", [True, False],
                         ids=["pipelined", "serial"])
def test_stage_metrics_carry_the_references_keys(async_tracking):
    stages = {}
    for tag, mod in (("port", tex), ("ref", jex)):
        ex = mod.TrainingExecutor(
            mod.PipelineConfig(async_tracking=async_tracking))
        with ex:
            for i in range(2):
                ex.submit(f"e{i}", _noop_prep, lambda s: s, lambda s: None)
            ex.flush()
        stages[tag] = ex.stage_metrics()
    got, want = stages["port"], stages["ref"]
    assert list(got) == list(want)
    for k in ("pipeline_n_experiments", "pipeline_n_completed",
              "pipeline_max_in_flight", "pipeline_async"):
        assert got[k] == want[k], k
    assert 0.0 <= got["pipeline_device_idle_fraction"] <= 1.0


def test_stage_seconds_reach_the_completion_as_the_references_do():
    seen = {}
    for tag, mod in (("port", tex), ("ref", jex)):
        for async_tracking in (True, False):
            ex = mod.TrainingExecutor(
                mod.PipelineConfig(async_tracking=async_tracking))
            with ex:
                h = ex.submit("e", _noop_prep, lambda s: s,
                              lambda s: s["pipeline_stage_seconds"])
            seen[tag, async_tracking] = h.result(timeout=5)
    for a in (True, False):
        assert list(seen["port", a]) == list(seen["ref", a]) == [
            "prep", "dispatch", "pull"]
    # pipelined, the writer knows only the pull (as the reference's)
    assert seen["port", True]["prep"] == seen["port", True]["dispatch"] == 0.0


def test_device_idle_fraction_is_the_union_of_busy_intervals():
    """[dispatch start, pull end] per experiment on the host clock: apart,
    the gap is idle, as in the reference; overlapping (experiment 1
    dispatched while experiment 0 still runs — the pipelined case), the
    union leaves no gap.  The reference's accounting moves its union's end
    to the later dispatch's start there and reports a third of the window
    idle: a pinned difference (ROADMAP Queue 3)."""
    def idle(mod, intervals, port):
        ex = mod.TrainingExecutor(mod.PipelineConfig())
        events = sorted([(a, 0, a) for a, _ in intervals]
                        + [(b, 1, a) for a, b in intervals])
        for t, is_pull, start in events:  # in the order they happen
            if not is_pull:
                ex._record_dispatch(t)
            elif port:
                ex._record_pull_end(t, start)
            else:
                ex._record_pull_end(t)
        return ex.device_idle_fraction()

    assert tex.TrainingExecutor(tex.PipelineConfig()) \
        .device_idle_fraction() == 0.0
    apart, overlapping = [(0.0, 1.0), (2.0, 3.0)], [(0.0, 2.0), (1.0, 3.0)]
    assert idle(tex, apart, True) == pytest.approx(1.0 / 3.0)
    assert idle(jex, apart, False) == pytest.approx(1.0 / 3.0)
    assert idle(tex, overlapping, True) == 0.0
    assert idle(jex, overlapping, False) == pytest.approx(1.0 / 3.0)


def test_pipelined_spans_share_one_trace_across_threads():
    from distributed_forecasting_tpu_torch.monitoring import trace

    tr = trace.configure_tracing(trace.TraceConfig(enabled=True,
                                                   ring_size=64))
    try:
        ex = tex.TrainingExecutor(tex.PipelineConfig())
        with ex:
            ex.submit("e0", _noop_prep, lambda s: s, lambda s: None)
        spans = [s for s in tr.recorder.snapshot()
                 if s.name.startswith("pipeline.")]
    finally:
        trace.configure_tracing(trace.TraceConfig())
    assert sorted(s.name for s in spans) == [
        "pipeline.complete", "pipeline.dispatch", "pipeline.prep",
        "pipeline.pull"]
    assert len({s.trace_id for s in spans}) == 1
    threads = {s.name: s.thread_name for s in spans}
    assert threads["pipeline.pull"] == threads["pipeline.complete"] == \
        "dftpu-pipeline-writer"
    assert threads["pipeline.prep"] == threads["pipeline.dispatch"] != \
        "dftpu-pipeline-writer"
    assert all(s.attrs["experiment"] == "e0" for s in spans)
    pull = next(s for s in spans if s.name == "pipeline.pull")
    assert pull.attrs["device_seconds"] >= 0.0


def test_each_experiment_is_charged_to_the_cost_registry(monkeypatch):
    from distributed_forecasting_tpu_torch.monitoring import cost

    monkeypatch.setattr(cost, "_cost_metrics", None)
    ex = tex.TrainingExecutor(tex.PipelineConfig())
    with ex:
        for name in ("a", "b", "a"):
            ex.submit(name, _noop_prep, lambda s: s, lambda s: None)
    snap = cost.cost_metrics().dispatches_total.snapshot()
    assert snap == {"entry=pipeline.dispatch,family=a": 2.0,
                    "entry=pipeline.dispatch,family=b": 1.0}


def test_prefetch_to_device_preserves_order_and_values():
    items = [np.full((3,), i, dtype=np.float32) for i in range(7)]
    for depth in (0, 1, 3, 10):
        out = list(tex.prefetch_to_device(items, depth=depth, device="cpu"))
        assert len(out) == 7
        for i, t in enumerate(out):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), items[i])
    pairs = [(np.arange(3) + i, np.ones((2, 2)) * i) for i in range(4)]
    got = list(tex.prefetch_to_device(pairs, depth=2, device="cpu"))
    for (a, b), (ta, tb) in zip(pairs, got):
        np.testing.assert_array_equal(ta.numpy(), a)
        np.testing.assert_array_equal(tb.numpy(), b)


def test_prefetch_depth_limits_lookahead():
    placed = []

    def place(x):
        placed.append(x)
        return x

    gen = tex.prefetch_to_device(range(10), depth=2, place=place)
    next(gen)
    assert len(placed) <= 3  # one yielded, at most two in flight
    tex.configure_pipeline(tex.PipelineConfig(prefetch_depth=0))
    placed.clear()
    gen = tex.prefetch_to_device(range(10), place=place)
    next(gen)
    assert len(placed) == 1  # the config's depth when none is given


def test_pipeline_metrics_on_serving_metrics_endpoint():
    from distributed_forecasting_tpu_torch.monitoring.monitor import (
        pipeline_metrics,
    )
    from distributed_forecasting_tpu_torch.serving.batcher import (
        ServingMetrics,
    )

    ex = tex.TrainingExecutor(tex.PipelineConfig(),
                              metrics=pipeline_metrics())
    with ex:
        ex.submit("m", _noop_prep, lambda s: s, lambda s: None)
        ex.flush()
    text = ServingMetrics().render()
    assert "pipeline_stage_complete_seconds_bucket" in text
    assert "pipeline_device_idle_fraction" in text
    assert "pipeline_experiments_total" in text
    assert "compile_cache_hits_total" in text
    assert "dftpu_cost_device_saturation" in text


def test_pipeline_metrics_families_equal_the_references():
    from distributed_forecasting_tpu.monitoring.monitor import (
        PipelineMetrics as JPipelineMetrics,
    )
    from distributed_forecasting_tpu_torch.monitoring.monitor import (
        PipelineMetrics,
    )

    assert (PipelineMetrics().registry.render_prometheus()
            == JPipelineMetrics().registry.render_prometheus())


# -- the training path -------------------------------------------------------------

TIMINGS = ("fit_seconds", "series_per_second")


def _timing(name: str) -> bool:
    return name in TIMINGS or name.startswith(("phase_", "pipeline_"))


@pytest.fixture(scope="module")
def raw_sales():
    from distributed_forecasting_tpu_torch import data as tdata

    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=2, n_days=300,
                                          seed=11)
    df["sales"] = df["sales"].round()
    return df


def _train(root, df, model, pipeline):
    """The shipped train conf on ``df``: ``model`` (the shipped curve model
    conf, or Holt-Winters), CV 150/60/30, horizon 30, ``pipeline`` as
    given; returns (catalog, tracker, summary)."""
    from distributed_forecasting_tpu_torch import tasks as ttasks
    from distributed_forecasting_tpu_torch.data import DatasetCatalog
    from distributed_forecasting_tpu_torch.engine import compile_cache

    with open(os.path.join(ROOT, "conf", "tasks", "train_config.yml")) as f:
        conf = yaml.safe_load(f)
    conf["env"] = {"root": root}
    conf["training"].update(horizon=30,
                            cv={"initial": 150, "period": 60, "horizon": 30})
    if model != "prophet":
        conf["training"].update(model=model, model_conf={})
    conf["pipeline"].update(pipeline)
    DatasetCatalog(os.path.join(root, "warehouse")).save_table(
        conf["input"]["table"], df)
    try:
        task = ttasks.TrainTask(init_conf=conf, device="cpu")
        summary = task.launch()
    finally:
        compile_cache.configure_compile_cache(
            compile_cache.CompileCacheConfig())
    return task.catalog, task.tracker, summary


def _assert_frames_identical(a: pd.DataFrame, b: pd.DataFrame):
    assert list(a.columns) == list(b.columns)
    for col in a.columns:
        x, y = a[col].to_numpy(), b[col].to_numpy()
        if x.dtype.kind in "fc":
            assert np.array_equal(x, y, equal_nan=True), col
        else:
            assert np.array_equal(x, y), col


def _assert_dirs_identical(dir_a: str, dir_b: str):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for name in names:
        pa, pb = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if os.path.isdir(pa):
            _assert_dirs_identical(pa, pb)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name


@pytest.mark.parametrize("model", ["prophet", "holt_winters"])
def test_pipelined_train_task_is_byte_identical_to_serial(tmp_path, raw_sales,
                                                          model):
    runs = {}
    for tag, pipeline in (("serial", {"async_tracking": False}),
                          ("piped", {"async_tracking": True})):
        runs[tag] = _train(str(tmp_path / tag), raw_sales, model, pipeline)
        tex.configure_pipeline(tex.PipelineConfig())
    (cs, ts, ss), (cp, tp, sp) = runs["serial"], runs["piped"]
    table = "hackathon.sales.finegrain_forecasts"
    _assert_frames_identical(cs.read_table(table), cp.read_table(table))
    rs = ts.get_run(ss["experiment_id"], ss["run_id"])
    rp = tp.get_run(sp["experiment_id"], sp["run_id"])
    assert rs.params() == rp.params()
    assert rs.meta()["tags"] == rp.meta()["tags"]
    ms, mp = rs.metrics(), rp.metrics()
    assert set(ms) == set(mp)
    assert {"pipeline_prep_seconds", "pipeline_dispatch_seconds",
            "pipeline_pull_seconds"} <= set(mp)
    assert {k: v for k, v in ms.items() if not _timing(k)} == \
        {k: v for k, v in mp.items() if not _timing(k)}
    _assert_frames_identical(
        pd.read_parquet(rs.artifact_path("series_metrics.parquet")),
        pd.read_parquet(rp.artifact_path("series_metrics.parquet")))
    _assert_dirs_identical(rs.artifact_path("forecaster"),
                           rp.artifact_path("forecaster"))


def _run_many(package, root, df, specs, max_in_flight=2):
    if package == "port":
        from distributed_forecasting_tpu_torch.data import DatasetCatalog
        from distributed_forecasting_tpu_torch.pipelines.training import (
            TrainingPipeline,
        )
        from distributed_forecasting_tpu_torch.tracking import FileTracker

        kw, cfg = {"device": "cpu"}, tex.PipelineConfig(
            max_in_flight=max_in_flight)
    else:
        from distributed_forecasting_tpu.data import DatasetCatalog
        from distributed_forecasting_tpu.pipelines.training import (
            TrainingPipeline,
        )
        from distributed_forecasting_tpu.tracking import FileTracker

        kw, cfg = {}, jex.PipelineConfig(max_in_flight=max_in_flight)
    cat = DatasetCatalog(os.path.join(root, "warehouse"))
    trk = FileTracker(os.path.join(root, "mlruns"))
    cat.save_table("t.raw.sales", df)
    got = TrainingPipeline(cat, trk, **kw).run_many(specs, pipeline=cfg)
    return cat, trk, got


def test_run_many_agrees_with_the_reference(tmp_path, raw_sales):
    specs = [
        {"source_table": "t.raw.sales", "output_table": f"t.fc.{m}",
         "model": m, "horizon": 30, "experiment": f"exp_{m}",
         "cv_conf": {"initial": 150, "period": 60, "horizon": 30}}
        for m in ("theta", "croston", "holt_winters")]
    out = {p: _run_many(p, str(tmp_path / p), raw_sales, specs)
           for p in ("port", "ref")}
    (tcat, ttrk, got), (jcat, jtrk, want) = out["port"], out["ref"]
    assert set(got) == set(want) == {"results", "pipeline"}
    assert list(got["pipeline"]) == list(want["pipeline"])
    assert got["pipeline"]["pipeline_n_experiments"] == 3.0
    assert got["pipeline"]["pipeline_n_completed"] == 3.0
    assert got["pipeline"]["pipeline_async"] == 1.0
    for g, w, spec in zip(got["results"], want["results"], specs):
        assert set(g) == set(w)
        assert (g["n_series"], g["n_failed"]) == (w["n_series"],
                                                  w["n_failed"])
        assert set(g["metrics"]) == set(w["metrics"])
        for k, v in w["metrics"].items():
            if not _timing(k):
                np.testing.assert_allclose(g["metrics"][k], v, rtol=CV_RTOL,
                                           err_msg=f"{spec['model']} {k}")
        gt, wt = (c.read_table(spec["output_table"]) for c in (tcat, jcat))
        assert list(gt.columns) == list(wt.columns)
        exact = ["ds", "store", "item", "y", "training_date"]
        pd.testing.assert_frame_equal(gt[exact], wt[exact])
        n = len(wt[["store", "item"]].drop_duplicates())
        for col in ("yhat", "yhat_upper", "yhat_lower"):
            gv = gt[col].to_numpy().reshape(n, -1)
            wv = wt[col].to_numpy().reshape(n, -1)
            scale = np.nanmax(np.abs(wv), axis=1, keepdims=True)
            np.testing.assert_array_less(
                np.abs(gv - wv),
                np.broadcast_to(RTOL * scale + 1e-6, wv.shape),
                err_msg=f"{spec['model']} {col}")
    # the experiments' runs were written in submission order in both
    for trk in (ttrk, jtrk):
        eids = [trk.get_experiment_by_name(f"exp_{m}")
                for m in ("theta", "croston", "holt_winters")]
        assert all(eids)


def test_tracking_failure_fails_the_experiment(tmp_path, raw_sales,
                                               monkeypatch):
    from distributed_forecasting_tpu_torch.data import DatasetCatalog
    from distributed_forecasting_tpu_torch.pipelines.training import (
        TrainingPipeline,
    )
    from distributed_forecasting_tpu_torch.tracking import FileTracker
    from distributed_forecasting_tpu_torch.tracking import filestore

    cat = DatasetCatalog(str(tmp_path / "warehouse"))
    trk = FileTracker(str(tmp_path / "mlruns"))
    cat.save_table("t.raw.sales", raw_sales)

    def boom(self, name, df):
        raise OSError("disk full")

    monkeypatch.setattr(filestore.Run, "log_table", boom)
    with pytest.raises(OSError, match="disk full"):
        TrainingPipeline(cat, trk, device="cpu").fine_grained(
            "t.raw.sales", "t.fc.out", model="theta", horizon=7,
            cv_conf={"initial": 150, "period": 60, "horizon": 7})
    eid = trk.get_experiment_by_name("finegrain_forecasting")
    runs = trk.search_runs(eid)
    assert runs and all(r.meta()["status"] == "FAILED" for r in runs)
    with pytest.raises(Exception):
        cat.read_table("t.fc.out")
