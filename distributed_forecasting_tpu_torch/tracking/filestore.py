"""Experiment tracking — the MLflow-tracking stand-in, file/JSON-backed
(own copy of the reference's ``tracking/filestore.py``: the same layout, so
a run written by either package reads in the other).

The reference tracks every one of its 500 fits as an MLflow run named
``run_item_{item}_store_{store}`` with params, metrics and a model artifact
(reference ``notebooks/prophet/02_training.py:160-196``), then uses
``mlflow.search_runs`` as the inference-time model index
(``notebooks/prophet/model_wrapper.py:27-29``).  Those 500 HTTP round trips
from inside Spark workers are the reference's own tracking bottleneck
(SURVEY.md §2.3-2).

This implementation keeps the same concepts — experiments, runs, params,
metrics (with history), tags, artifacts, ``search_runs`` — as plain local
transactions, and supports the batched layout the batched engine prefers: ONE run
for the whole batched fit with a per-series metric table attached as an
artifact, alongside optional per-series runs for drill-down parity.  The
storage is a directory tree of JSON files (the same shape MLflow's own
file store uses in the reference's unit-test fixture,
reference ``tests/unit/conftest.py:56-62``), so tests run hermetically.

Layout::

    root/experiments/<eid>/meta.json
    root/experiments/<eid>/runs/<rid>/meta.json      # name, tags, status, times
    root/experiments/<eid>/runs/<rid>/params.json
    root/experiments/<eid>/runs/<rid>/metrics.json   # name -> [(step, value)]
    root/experiments/<eid>/runs/<rid>/artifacts/...
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Dict, List, Optional


def _now() -> float:
    return time.time()


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=_jsonable)
    os.replace(tmp, path)


def _jsonable(x):
    from distributed_forecasting_tpu_torch.utils.config import to_jsonable

    return to_jsonable(x, strict=False)


def _read_json(path: str, default=None):
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


class Run:
    """Handle to one tracked run.  Context-manager; mirrors the
    ``mlflow.start_run`` usage pattern of the reference trainer."""

    def __init__(self, tracker: "FileTracker", experiment_id: str, run_id: str):
        self._tracker = tracker
        self.experiment_id = experiment_id
        self.run_id = run_id

    # -- paths --------------------------------------------------------------
    @property
    def _dir(self) -> str:
        return self._tracker._run_dir(self.experiment_id, self.run_id)

    @property
    def artifact_dir(self) -> str:
        d = os.path.join(self._dir, "artifacts")
        os.makedirs(d, exist_ok=True)
        return d

    # -- logging ------------------------------------------------------------
    def log_params(self, params: Dict) -> None:
        path = os.path.join(self._dir, "params.json")
        cur = _read_json(path, {})
        cur.update({k: _jsonable(v) if not isinstance(v, (str, int, float, bool)) else v
                    for k, v in params.items()})
        _write_json(path, cur)

    def log_metrics(self, metrics: Dict[str, float], step: int = 0) -> None:
        path = os.path.join(self._dir, "metrics.json")
        cur = _read_json(path, {})
        for k, v in metrics.items():
            cur.setdefault(k, []).append([int(step), float(v)])
        _write_json(path, cur)

    def set_tags(self, tags: Dict[str, str]) -> None:
        meta_path = os.path.join(self._dir, "meta.json")
        meta = _read_json(meta_path, {})
        meta.setdefault("tags", {}).update({k: str(v) for k, v in tags.items()})
        _write_json(meta_path, meta)

    def log_artifact(self, local_path: str, name: Optional[str] = None) -> str:
        dst = os.path.join(self.artifact_dir, name or os.path.basename(local_path))
        shutil.copyfile(local_path, dst)
        return dst

    def log_artifact_bytes(self, name: str, data: bytes) -> str:
        dst = os.path.join(self.artifact_dir, name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(data)
        return dst

    def log_table(self, name: str, df) -> str:
        """Attach a pandas frame (e.g. the per-series metric table of a
        batched fit) as a parquet artifact."""
        dst = os.path.join(self.artifact_dir, name)
        df.to_parquet(dst, index=False)
        return dst

    def artifact_path(self, name: str) -> str:
        return os.path.join(self.artifact_dir, name)

    # -- lifecycle ----------------------------------------------------------
    def end(self, status: str = "FINISHED") -> None:
        meta_path = os.path.join(self._dir, "meta.json")
        meta = _read_json(meta_path, {})
        meta["status"] = status
        meta["end_time"] = _now()
        _write_json(meta_path, meta)

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end("FAILED" if exc_type else "FINISHED")

    # -- reads --------------------------------------------------------------
    def params(self) -> Dict:
        return _read_json(os.path.join(self._dir, "params.json"), {})

    def metrics(self) -> Dict[str, float]:
        """Latest value per metric (like MLflow's run.data.metrics)."""
        hist = _read_json(os.path.join(self._dir, "metrics.json"), {})
        return {k: v[-1][1] for k, v in hist.items() if v}

    def meta(self) -> Dict:
        return _read_json(os.path.join(self._dir, "meta.json"), {})


class FileTracker:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "experiments"), exist_ok=True)

    # -- experiments --------------------------------------------------------
    def create_experiment(self, name: str) -> str:
        existing = self.get_experiment_by_name(name)
        if existing is not None:
            return existing
        eid = uuid.uuid4().hex[:12]
        d = os.path.join(self.root, "experiments", eid)
        os.makedirs(os.path.join(d, "runs"), exist_ok=True)
        _write_json(
            os.path.join(d, "meta.json"),
            {"experiment_id": eid, "name": name, "created_at": _now()},
        )
        return eid

    def get_experiment_by_name(self, name: str) -> Optional[str]:
        base = os.path.join(self.root, "experiments")
        for eid in os.listdir(base):
            meta = _read_json(os.path.join(base, eid, "meta.json"))
            if meta and meta.get("name") == name:
                return eid
        return None

    # -- runs ---------------------------------------------------------------
    def _run_dir(self, eid: str, rid: str) -> str:
        return os.path.join(self.root, "experiments", eid, "runs", rid)

    def start_run(
        self,
        experiment_id: str,
        run_name: Optional[str] = None,
        tags: Optional[Dict[str, str]] = None,
    ) -> Run:
        rid = uuid.uuid4().hex[:16]
        d = self._run_dir(experiment_id, rid)
        os.makedirs(os.path.join(d, "artifacts"), exist_ok=True)
        _write_json(
            os.path.join(d, "meta.json"),
            {
                "run_id": rid,
                "run_name": run_name or rid,
                "status": "RUNNING",
                "start_time": _now(),
                "tags": {k: str(v) for k, v in (tags or {}).items()},
            },
        )
        return Run(self, experiment_id, rid)

    def log_runs_batch(self, experiment_id: str, rows: List[Dict]) -> List[str]:
        """Write many small finished runs in one buffered pass.

        ``rows``: dicts with ``run_name`` and optional ``tags`` / ``params``
        / ``metrics``.  Where :meth:`start_run` + ``log_metrics`` + ``end``
        costs ~5 file operations and 3 ``os.replace`` fsync-ish barriers per
        run (pathological for the per-series drill-down loop, which creates
        one run per SERIES), this writes each run's ``meta.json`` /
        ``params.json`` / ``metrics.json`` exactly once with plain buffered
        I/O and issues a single directory fsync at the end of the batch —
        one durability point per experiment batch, not per row.

        Runs are born ``FINISHED`` (their data is complete by construction),
        so the layout stays exactly what ``search_runs`` and the MLflow
        adapter already read.  Returns the new run ids in row order.
        """
        base = os.path.join(self.root, "experiments", experiment_id, "runs")
        os.makedirs(base, exist_ok=True)
        t = _now()
        rids: List[str] = []
        for row in rows:
            rid = uuid.uuid4().hex[:16]
            d = os.path.join(base, rid)
            os.makedirs(os.path.join(d, "artifacts"), exist_ok=True)
            meta = {
                "run_id": rid,
                "run_name": row.get("run_name") or rid,
                "status": "FINISHED",
                "start_time": t,
                "end_time": t,
                "tags": {k: str(v)
                         for k, v in (row.get("tags") or {}).items()},
            }
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2, default=_jsonable)
            params = row.get("params")
            if params:
                with open(os.path.join(d, "params.json"), "w") as f:
                    json.dump({k: _jsonable(v) for k, v in params.items()},
                              f, indent=2, default=_jsonable)
            metrics = row.get("metrics")
            if metrics:
                hist = {k: [[0, float(v)]] for k, v in metrics.items()}
                with open(os.path.join(d, "metrics.json"), "w") as f:
                    json.dump(hist, f, indent=2)
            rids.append(rid)
        # one durability barrier for the whole batch: flush the runs
        # directory so the new entries survive a crash (the per-file
        # contents went through buffered writes above)
        fd = os.open(base, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        return rids

    def get_run(self, experiment_id: str, run_id: str) -> Run:
        if not os.path.isdir(self._run_dir(experiment_id, run_id)):
            raise KeyError(f"run {run_id} not found in experiment {experiment_id}")
        return Run(self, experiment_id, run_id)

    def search_runs(
        self,
        experiment_id: str,
        run_name: Optional[str] = None,
        tags: Optional[Dict[str, str]] = None,
    ) -> List[Run]:
        """The reference's ``mlflow.search_runs`` analogue (its
        model_wrapper.py:27-29 builds the inference index from it)."""
        base = os.path.join(self.root, "experiments", experiment_id, "runs")
        if not os.path.isdir(base):
            return []
        out = []
        for rid in sorted(os.listdir(base)):
            run = Run(self, experiment_id, rid)
            meta = run.meta()
            if run_name is not None and meta.get("run_name") != run_name:
                continue
            if tags:
                rt = meta.get("tags", {})
                if any(rt.get(k) != str(v) for k, v in tags.items()):
                    continue
            out.append(run)
        return out
