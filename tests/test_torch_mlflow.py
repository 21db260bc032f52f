"""The port's MLflow adapters (``tracking/mlflow_compat.py``) against an
in-memory fake ``mlflow`` module, as the reference's
``tests/unit/test_mlflow_fake.py`` holds the reference's.

``mlflow`` is not installed, so the real interop path cannot run here.
What is tested is every piece of logic the adapters own: experiment
idempotency, the search-filter construction, the register-twice
already-exists path, the stage-as-tag emulation (including the legacy API's
truthy "None" string), and the cleanup helpers.  The fake implements the
MlflowClient method surface the adapters call, with state in memory; one
more case checks that, with no ``mlflow``, the ``auto`` factories return
the port's file-backed tracker and registry and the adapters raise
ImportError.
"""

from __future__ import annotations

import re
import sys
import types

import pytest
import torch

torch.set_num_threads(1)


class _FakeMlflowException(Exception):
    def __init__(self, msg, error_code=None):
        super().__init__(msg)
        self.error_code = error_code


class _Obj:
    """Attribute bag standing in for mlflow entity classes."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class _FakeClient:
    """In-memory stand-in for mlflow.tracking.MlflowClient."""

    # one shared store per (tracking_uri, registry_uri), like a real backend
    _stores: dict = {}

    def __init__(self, tracking_uri=None, registry_uri=None):
        key = (tracking_uri, registry_uri)
        store = self._stores.setdefault(
            key,
            {"experiments": {}, "runs": {}, "models": {}, "next_exp": 1,
             "next_run": 1},
        )
        self._s = store

    # -- experiments --------------------------------------------------------
    def get_experiment_by_name(self, name):
        for eid, e in self._s["experiments"].items():
            if e["name"] == name:
                return _Obj(experiment_id=eid, name=name)
        return None

    def create_experiment(self, name):
        eid = f"exp{self._s['next_exp']}"
        self._s["next_exp"] += 1
        self._s["experiments"][eid] = {"name": name}
        return eid

    # -- runs ---------------------------------------------------------------
    def create_run(self, experiment_id, run_name=None, tags=None):
        rid = f"run{self._s['next_run']}"
        self._s["next_run"] += 1
        self._s["runs"][rid] = {
            "experiment_id": experiment_id, "run_name": run_name,
            "tags": dict(tags or {}), "params": {}, "metrics": {},
            "status": "RUNNING",
        }
        return _Obj(info=_Obj(run_id=rid))

    def get_run(self, run_id):
        r = self._s["runs"][run_id]
        return _Obj(
            info=_Obj(run_id=run_id, run_name=r["run_name"],
                      status=r["status"]),
            data=_Obj(params=dict(r["params"]), metrics=dict(r["metrics"]),
                      tags=dict(r["tags"])),
        )

    def search_runs(self, experiment_ids, filter_string=""):
        out = []
        clauses = [c for c in filter_string.split(" and ") if c.strip()]
        for rid, r in self._s["runs"].items():
            if r["experiment_id"] not in experiment_ids:
                continue
            ok = True
            for c in clauses:
                m = re.match(
                    r"attributes\.run_name = '(.*)'|tags\.`(.*)` = '(.*)'", c
                )
                assert m, f"adapter produced unparseable clause {c!r}"
                if m.group(1) is not None:
                    ok &= r["run_name"] == m.group(1)
                else:
                    ok &= r["tags"].get(m.group(2)) == m.group(3)
            if ok:
                out.append(self.get_run(rid))
        return out

    def log_param(self, run_id, k, v):
        self._s["runs"][run_id]["params"][k] = str(v)

    def log_metric(self, run_id, k, v, step=0):
        self._s["runs"][run_id]["metrics"][k] = float(v)

    def set_tag(self, run_id, k, v):
        self._s["runs"][run_id]["tags"][k] = str(v)

    def set_terminated(self, run_id, status="FINISHED"):
        self._s["runs"][run_id]["status"] = status

    # -- registry -----------------------------------------------------------
    def create_registered_model(self, name):
        if name in self._s["models"]:
            raise _FakeMlflowException(
                f"Registered Model (name={name}) already exists",
                error_code="RESOURCE_ALREADY_EXISTS",
            )
        self._s["models"][name] = {"versions": {}, "next": 1}

    def create_model_version(self, name, source, run_id=None, tags=None):
        m = self._s["models"][name]
        v = m["next"]
        m["next"] += 1
        m["versions"][v] = {
            "source": source, "run_id": run_id, "tags": dict(tags or {}),
            # mimic the legacy API: current_stage is the STRING "None"
            # until a real transition happens (the truthy-pitfall case)
            "current_stage": "None", "creation_timestamp": 1700000000000 + v,
        }
        return self._mv(name, v)

    def _mv(self, name, v):
        d = self._s["models"][name]["versions"][v]
        return _Obj(name=name, version=str(v), **d)

    def get_model_version(self, name, version):
        return self._mv(name, int(version))

    def search_model_versions(self, filter_string):
        m = re.match(r"name='(.*)'", filter_string)
        name = m.group(1)
        if name not in self._s["models"]:
            return []
        return [self._mv(name, v) for v in self._s["models"][name]["versions"]]

    def set_model_version_tag(self, name, version, key, value):
        self._s["models"][name]["versions"][int(version)]["tags"][key] = value

    def search_registered_models(self):
        return [_Obj(name=n) for n in self._s["models"]]

    def delete_model_version(self, name, version):
        del self._s["models"][name]["versions"][int(version)]

    def delete_registered_model(self, name):
        del self._s["models"][name]


class _FakeClientWithStages(_FakeClient):
    """Variant exposing the legacy transition_model_version_stage API."""

    def transition_model_version_stage(self, name, version, stage):
        self._s["models"][name]["versions"][int(version)]["current_stage"] = stage
        return self._mv(name, int(version))


@pytest.fixture
def fake_mlflow(monkeypatch):
    """Install a minimal fake ``mlflow`` package into sys.modules."""
    _FakeClient._stores = {}
    mlflow = types.ModuleType("mlflow")
    tracking = types.ModuleType("mlflow.tracking")
    exceptions = types.ModuleType("mlflow.exceptions")
    tracking.MlflowClient = _FakeClient
    exceptions.MlflowException = _FakeMlflowException
    mlflow.tracking = tracking
    mlflow.exceptions = exceptions
    monkeypatch.setitem(sys.modules, "mlflow", mlflow)
    monkeypatch.setitem(sys.modules, "mlflow.tracking", tracking)
    monkeypatch.setitem(sys.modules, "mlflow.exceptions", exceptions)
    return mlflow


def test_fake_mlflow_tracker_surface(fake_mlflow, tmp_path):
    from distributed_forecasting_tpu_torch.tracking.mlflow_compat import (
        MlflowTracker,
        get_tracker,
    )

    t = get_tracker(str(tmp_path / "mlruns"), kind="auto")
    assert isinstance(t, MlflowTracker)  # auto detects the (fake) module

    eid = t.create_experiment("demand")
    assert t.create_experiment("demand") == eid  # idempotent
    assert t.get_experiment_by_name("demand") == eid
    assert t.get_experiment_by_name("missing") is None

    with t.start_run(eid, run_name="fit-1", tags={"kind": "train"}) as run:
        run.log_params({"model": "prophet", "horizon": 90})
        run.log_metrics({"val_mape": 0.065})
        run.set_tags({"partial_model": "False"})
    assert t.get_run(eid, run.run_id).metrics()["val_mape"] == 0.065
    assert t.get_run(eid, run.run_id).meta()["status"] == "FINISHED"

    # filter construction: by name, by tag, and both
    assert [r.run_id for r in t.search_runs(eid, run_name="fit-1")] == [run.run_id]
    assert t.search_runs(eid, run_name="other") == []
    assert [r.run_id for r in t.search_runs(eid, tags={"kind": "train"})] == [
        run.run_id
    ]
    assert t.search_runs(eid, run_name="fit-1", tags={"kind": "serve"}) == []

    # context-manager failure path marks the run FAILED
    with pytest.raises(RuntimeError):
        with t.start_run(eid, run_name="fit-2") as run2:
            raise RuntimeError("boom")
    assert t.get_run(eid, run2.run_id).meta()["status"] == "FAILED"


def test_fake_mlflow_registry_stage_tag_emulation(fake_mlflow, tmp_path):
    """MLflow 3.x shape: no transition API, stage lives in the emulation tag;
    the legacy 'None'-string current_stage must defer to the tag."""
    from distributed_forecasting_tpu_torch.tracking.mlflow_compat import MlflowRegistry

    r = MlflowRegistry(str(tmp_path / "reg.db"))
    art = tmp_path / "artifact"
    art.mkdir()
    v1 = r.register_model("ForecastingModelUDF", str(art), run_id="run1",
                          tags={"serving_schema": "[ds,yhat]"})
    assert (v1.version, v1.stage) == (1, "None")
    v2 = r.register_model("ForecastingModelUDF", str(art))  # already-exists path
    assert v2.version == 2

    r.transition_stage("ForecastingModelUDF", 2, "Staging")
    got = r.latest_version("ForecastingModelUDF", stage="Staging")
    assert (got.version, got.stage) == (2, "Staging")
    assert r.latest_version("ForecastingModelUDF").version == 2
    with pytest.raises(KeyError):
        r.latest_version("ForecastingModelUDF", stage="Production")

    r.set_version_tag("ForecastingModelUDF", 1, "reviewed", "no")
    assert r.get_version("ForecastingModelUDF", 1).tags["reviewed"] == "no"
    assert r.models() == ["ForecastingModelUDF"]

    # cleanup helpers: archive-then-delete every version, then the model
    r.delete_version("ForecastingModelUDF", 1)
    assert [v.version for v in r.list_versions("ForecastingModelUDF")] == [2]
    r.delete_model("ForecastingModelUDF")
    assert r.models() == []


def test_fake_mlflow_registry_legacy_stage_api(fake_mlflow, tmp_path, monkeypatch):
    """MLflow <3 shape: the real transition_model_version_stage is used and
    current_stage (not the tag) carries the stage."""
    import mlflow

    monkeypatch.setattr(
        mlflow.tracking, "MlflowClient", _FakeClientWithStages
    )
    from distributed_forecasting_tpu_torch.tracking.mlflow_compat import (
        _STAGE_TAG,
        MlflowRegistry,
    )

    r = MlflowRegistry(str(tmp_path / "reg2.db"))
    art = tmp_path / "artifact2"
    art.mkdir()
    r.register_model("m", str(art))
    got = r.transition_stage("m", 1, "Production")
    assert got.stage == "Production"
    assert _STAGE_TAG not in got.tags  # real API path, no emulation tag
    assert r.latest_version("m", stage="Production").version == 1


def test_without_mlflow_the_factories_fall_back(tmp_path, monkeypatch):
    from distributed_forecasting_tpu_torch.tracking import (
        FileTracker,
        ModelRegistry,
        get_registry,
        get_tracker,
        mlflow_available,
    )
    from distributed_forecasting_tpu_torch.tracking.mlflow_compat import (
        MlflowRegistry,
        MlflowTracker,
    )

    monkeypatch.setitem(sys.modules, "mlflow", None)  # import raises
    assert not mlflow_available()
    assert isinstance(get_tracker(str(tmp_path / "t")), FileTracker)
    assert isinstance(get_registry(str(tmp_path / "r")), ModelRegistry)
    for cls in (MlflowTracker, MlflowRegistry):
        with pytest.raises(ImportError, match="optional 'mlflow' package"):
            cls(str(tmp_path / "x"))
    with pytest.raises(ValueError, match="unknown tracker kind"):
        get_tracker(str(tmp_path / "t"), kind="sql")
    with pytest.raises(ValueError, match="unknown registry kind"):
        get_registry(str(tmp_path / "r"), kind="sql")
