"""Port parity: the dataset catalog, the experiment tracker and the model
registry write the reference's on-disk layout.

The same operations run through both packages into two roots; the two
trees must hold the same files with the same JSON contents, ids and times
aside (experiment and run ids are random, versions and times are stamped
from the clock).  Tables and artifacts written by either package read back
through the other.
"""

import json
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu.data import catalog as jcatalog
from distributed_forecasting_tpu.tracking import filestore as jfs
from distributed_forecasting_tpu.tracking import registry as jreg
from distributed_forecasting_tpu_torch.data import catalog as tcatalog
from distributed_forecasting_tpu_torch.tracking import filestore as tfs
from distributed_forecasting_tpu_torch.tracking import registry as treg
from distributed_forecasting_tpu_torch.utils.config import freeze

torch.set_num_threads(1)

_TIME_KEYS = {"created_at", "start_time", "end_time", "written_at"}
_STAMP = re.compile(r"\d{8}T\d{6}")


def _sales(n_days=30, seed=0):
    rng = np.random.default_rng(seed)
    dates = pd.date_range("2017-01-01", periods=n_days)
    return pd.DataFrame({
        "date": np.tile(dates.values, 2),
        "store": np.repeat([1, 2], n_days),
        "item": 1,
        "sales": rng.integers(0, 50, 2 * n_days).astype(float),
    })


def _scrub(obj, ids):
    """JSON contents with times dropped and ids / clock stamps replaced."""
    if isinstance(obj, dict):
        return {k: _scrub(v, ids) for k, v in obj.items()
                if k not in _TIME_KEYS}
    if isinstance(obj, list):
        return [_scrub(v, ids) for v in obj]
    if isinstance(obj, str):
        return _STAMP.sub("<ts>", ids.get(obj, obj))
    return obj


def _ids(root):
    """Random ids in a tracker tree -> stable names (experiment name, run
    name), read from the tree's own meta files."""
    ids = {}
    base = os.path.join(root, "experiments")
    if not os.path.isdir(base):
        return ids
    for eid in os.listdir(base):
        with open(os.path.join(base, eid, "meta.json")) as f:
            ids[eid] = "<exp:" + json.load(f)["name"] + ">"
        runs = os.path.join(base, eid, "runs")
        for rid in os.listdir(runs):
            with open(os.path.join(runs, rid, "meta.json")) as f:
                ids[rid] = "<run:" + json.load(f)["run_name"] + ">"
    return ids


def _tree(root):
    """{normalized relative path: contents} of every file under root."""
    ids = _ids(root)
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            key = "/".join(_STAMP.sub("<ts>", ids.get(p, p))
                           for p in rel.split(os.sep))
            if name.endswith(".json"):
                with open(path) as f:
                    out[key] = _scrub(json.load(f), ids)
            elif name.endswith(".parquet"):
                out[key] = pd.read_parquet(path).to_dict("list")
            else:
                with open(path, "rb") as f:
                    out[key] = f.read()
    return out


def _catalog_ops(mod, root):
    cat = mod.DatasetCatalog(root)
    cat.create_catalog("hackathon", grants=["CREATE", "USAGE"])
    cat.create_schema("hackathon", "sales")
    cat.create_schema("other", "misc")
    cat.save_table("hackathon.sales.raw", _sales())
    cat.save_table("hackathon.sales.raw", _sales(seed=1))
    cat.save_table("hackathon.sales.raw", _sales(n_days=5, seed=2),
                   mode="append")
    return cat


def test_catalog_trees_match_reference(tmp_path):
    j = _catalog_ops(jcatalog, str(tmp_path / "j"))
    t = _catalog_ops(tcatalog, str(tmp_path / "t"))
    tree = _tree(t.root)
    assert len(tree) == 8 and tree == _tree(j.root)
    assert t.catalogs() == j.catalogs()
    assert t.schemas("hackathon") == j.schemas("hackathon")
    assert t.tables("hackathon", "sales") == j.tables("hackathon", "sales")
    assert t.grants("hackathon") == j.grants("hackathon") == ["CREATE", "USAGE"]
    assert len(t.table_versions("hackathon.sales.raw")) == 3
    assert t.table_exists("hackathon.sales.raw")
    assert not t.table_exists("hackathon.sales.nope")
    assert not t.table_exists("not_three_parts")
    with pytest.raises(tcatalog.TableNotFoundError):
        t.read_table("hackathon.sales.nope")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tables_read_back_across_packages(tmp_path, writer):
    mods = {"port": tcatalog, "reference": jcatalog}
    reader = mods["reference" if writer == "port" else "port"]
    w = mods[writer].DatasetCatalog(str(tmp_path))
    df = _sales(seed=3)
    v1 = w.save_table("hackathon.sales.raw", df)
    w.save_table("hackathon.sales.raw", df.head(4))
    r = reader.DatasetCatalog(str(tmp_path))
    pd.testing.assert_frame_equal(r.read_table("hackathon.sales.raw"),
                                  df.head(4))
    pd.testing.assert_frame_equal(
        r.read_table("hackathon.sales.raw", version=v1), df)
    assert r.table_versions("hackathon.sales.raw") == w.table_versions(
        "hackathon.sales.raw")


def _tracker_ops(mod, root, tmp):
    tr = mod.FileTracker(root)
    eid = tr.create_experiment("finegrain_forecasting")
    assert tr.create_experiment("finegrain_forecasting") == eid
    with tr.start_run(eid, run_name="batched_prophet_fit",
                      tags={"model": "prophet", "partial_model": False}) as run:
        run.log_params({"n_series": 6, "horizon": 60, "width": 0.95,
                        "holidays": freeze([["x", [1, 2]]]),
                        "np_int": np.int64(3), "np_arr": np.arange(3),
                        "cfg": freeze({"a": [1, 2]})})
        run.log_metrics({"val_mape": 0.25, "fit_seconds": np.float32(1.5)})
        run.log_metrics({"val_mape": 0.2}, step=1)
        run.set_tags({"stage": 2})
        run.log_table("series_metrics.parquet",
                      pd.DataFrame({"store": [1, 2], "mape": [0.1, 0.3]}))
        run.log_artifact_bytes("forecaster/blob.bin", b"\x00\x01")
        src = os.path.join(tmp, "note.txt")
        with open(src, "w") as f:
            f.write("hello")
        run.log_artifact(src)
    tr.log_runs_batch(eid, [
        {"run_name": "run_item_1_store_1", "tags": {"series_index": 0},
         "metrics": {"mape": 0.1}},
        {"run_name": "run_item_1_store_2", "params": {"k": (1, 2)}},
    ])
    failed = tr.start_run(eid, run_name="failed_run")
    try:
        with failed:
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    return tr, eid


def test_tracker_trees_match_reference(tmp_path):
    jt, jeid = _tracker_ops(jfs, str(tmp_path / "j"), str(tmp_path))
    tt, teid = _tracker_ops(tfs, str(tmp_path / "t"), str(tmp_path))
    tree = _tree(tt.root)
    assert len(tree) == 12 and tree == _tree(jt.root)
    runs = {r.meta()["run_name"]: r for r in tt.search_runs(teid)}
    assert set(runs) == {"batched_prophet_fit", "run_item_1_store_1",
                         "run_item_1_store_2", "failed_run"}
    assert runs["failed_run"].meta()["status"] == "FAILED"
    assert runs["batched_prophet_fit"].metrics() == {"val_mape": 0.2,
                                                     "fit_seconds": 1.5}
    assert [r.run_id for r in tt.search_runs(teid, tags={"model": "prophet"})
            ] == [runs["batched_prophet_fit"].run_id]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_runs_read_back_across_packages(tmp_path, writer):
    mods = {"port": tfs, "reference": jfs}
    reader = mods["reference" if writer == "port" else "port"]
    w, eid = _tracker_ops(mods[writer], str(tmp_path / "root"), str(tmp_path))
    r = reader.FileTracker(str(tmp_path / "root"))
    assert r.get_experiment_by_name("finegrain_forecasting") == eid
    got = {x.meta()["run_name"]: (x.params(), x.metrics(), x.meta()["tags"])
           for x in r.search_runs(eid)}
    want = {x.meta()["run_name"]: (x.params(), x.metrics(), x.meta()["tags"])
            for x in w.search_runs(eid)}
    assert got == want
    run = r.search_runs(eid, run_name="batched_prophet_fit")[0]
    pd.testing.assert_frame_equal(
        pd.read_parquet(run.artifact_path("series_metrics.parquet")),
        pd.DataFrame({"store": [1, 2], "mape": [0.1, 0.3]}))


def _registry_ops(mod, root, art):
    reg = mod.ModelRegistry(root)
    v1 = reg.register_model("ForecastingBatchModel", art, run_id="r1",
                            tags={"udf": "batched", "model_family": "prophet"})
    reg.set_version_tag("ForecastingBatchModel", v1.version, "reviewed", True)
    reg.transition_stage("ForecastingBatchModel", v1.version, "Staging")
    reg.register_model("ForecastingBatchModel", art, run_id="r2")
    reg.register_model("Other", art)
    reg.delete_model("Other")
    with pytest.raises(ValueError, match="unknown stage"):
        reg.transition_stage("ForecastingBatchModel", 1, "Live")
    return reg


def test_registry_trees_match_reference(tmp_path):
    art = tmp_path / "art"
    (art / "forecaster").mkdir(parents=True)
    (art / "forecaster" / "params.npz").write_bytes(b"npz")
    j = _registry_ops(jreg, str(tmp_path / "j"), str(art))
    t = _registry_ops(treg, str(tmp_path / "t"), str(art))
    tree = _tree(t.root)
    assert len(tree) == 5 and tree == _tree(j.root)
    for reg in (j, t):
        latest = reg.latest_version("ForecastingBatchModel")
        staged = reg.latest_version("ForecastingBatchModel", stage="Staging")
        assert (latest.version, latest.run_id) == (2, "r2")
        assert (staged.version, staged.tags) == (1, {
            "udf": "batched", "model_family": "prophet", "reviewed": "True"})
        assert reg.models() == ["ForecastingBatchModel"]
    # a registry written by the port resolves in the reference, and back
    for w, r in ((t, jreg), (j, treg)):
        other = r.ModelRegistry(w.root)
        got = other.latest_version("ForecastingBatchModel", stage="Staging")
        want = w.latest_version("ForecastingBatchModel", stage="Staging")
        assert (got.version, got.stage, got.run_id, got.tags) == (
            want.version, want.stage, want.run_id, want.tags)
        assert os.path.exists(os.path.join(got.artifact_dir, "forecaster",
                                           "params.npz"))
