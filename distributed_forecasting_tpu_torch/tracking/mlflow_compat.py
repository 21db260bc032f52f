"""Optional MLflow-backed tracker and registry, with the surfaces of
``FileTracker`` and ``ModelRegistry`` (port of the reference's
``tracking/mlflow_compat.py``).

MLflow stays an optional client behind the tracking interface: when the
``mlflow`` package is not installed the adapters raise a clear
ImportError and the ``auto`` factories fall back to the file store; when it
is, runs, params, metrics and artifacts land in a real MLflow tracking
store, interoperable with the reference's tooling.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

from distributed_forecasting_tpu_torch.tracking.filestore import FileTracker
from distributed_forecasting_tpu_torch.tracking.registry import ModelRegistry, ModelVersion


def mlflow_available() -> bool:
    try:
        import mlflow  # noqa: F401

        return True
    except ImportError:
        return False


def get_tracker(root: str, kind: str = "auto"):
    """Factory: 'file', 'mlflow', or 'auto' (mlflow when importable)."""
    if kind == "file":
        return FileTracker(root)
    if kind == "mlflow" or (kind == "auto" and mlflow_available()):
        return MlflowTracker(root)
    if kind == "auto":
        return FileTracker(root)
    raise ValueError(f"unknown tracker kind {kind!r}")


def get_registry(root: str, kind: str = "auto"):
    """Factory: 'file', 'mlflow', or 'auto' (mlflow when importable)."""
    if kind == "file":
        return ModelRegistry(root)
    if kind == "mlflow" or (kind == "auto" and mlflow_available()):
        return MlflowRegistry(root)
    if kind == "auto":
        return ModelRegistry(root)
    raise ValueError(f"unknown registry kind {kind!r}")


class MlflowTracker:
    """FileTracker-compatible adapter over the MLflow client API."""

    def __init__(self, root: str):
        try:
            import mlflow
        except ImportError as e:
            raise ImportError(
                "MlflowTracker requires the optional 'mlflow' package; "
                "install it or use FileTracker (tracking kind 'file')"
            ) from e
        self._mlflow = mlflow
        uri = root if "://" in root else f"file://{os.path.abspath(root)}"
        self._client = mlflow.tracking.MlflowClient(tracking_uri=uri)

    # -- experiments --------------------------------------------------------
    def create_experiment(self, name: str) -> str:
        existing = self._client.get_experiment_by_name(name)
        if existing is not None:
            return existing.experiment_id
        return self._client.create_experiment(name)

    def get_experiment_by_name(self, name: str) -> Optional[str]:
        exp = self._client.get_experiment_by_name(name)
        return None if exp is None else exp.experiment_id

    # -- runs ---------------------------------------------------------------
    def start_run(self, experiment_id: str, run_name: Optional[str] = None,
                  tags: Optional[Dict[str, str]] = None):
        run = self._client.create_run(
            experiment_id, run_name=run_name,
            tags={k: str(v) for k, v in (tags or {}).items()},
        )
        return _MlflowRun(self._client, experiment_id, run.info.run_id)

    def get_run(self, experiment_id: str, run_id: str):
        self._client.get_run(run_id)  # raises if missing
        return _MlflowRun(self._client, experiment_id, run_id)

    def search_runs(self, experiment_id: str, run_name: Optional[str] = None,
                    tags: Optional[Dict[str, str]] = None):
        clauses = []
        if run_name is not None:
            clauses.append(f"attributes.run_name = '{run_name}'")
        for k, v in (tags or {}).items():
            clauses.append(f"tags.`{k}` = '{v}'")
        runs = self._client.search_runs(
            [experiment_id], filter_string=" and ".join(clauses)
        )
        return [
            _MlflowRun(self._client, experiment_id, r.info.run_id) for r in runs
        ]


# stage-as-tag emulation key for MLflow versions without registry stages
_STAGE_TAG = "dftpu.stage"


class MlflowRegistry:
    """ModelRegistry-compatible adapter over the MLflow *model registry*.

    The Spark solution this framework rebuilds deploys and serves through
    ``mlflow.register_model`` (``notebooks/prophet/03_deploy.py:34-36``),
    model-version tags (``03_deploy.py:44-58``), latest-version resolution
    and stage transitions (``notebooks/prophet/04_inference.py:10-12,72-76``).
    Same method surface and ``ModelVersion`` return type as the file-backed
    ``ModelRegistry``, so tasks/deploy.py and tasks/inference.py work against
    either.
    """

    def __init__(self, root: str):
        try:
            import mlflow
        except ImportError as e:
            raise ImportError(
                "MlflowRegistry requires the optional 'mlflow' package; "
                "install it or use ModelRegistry (registry kind 'file')"
            ) from e
        uri = root if "://" in root else f"sqlite:///{os.path.abspath(root)}"
        self._client = mlflow.tracking.MlflowClient(
            tracking_uri=uri, registry_uri=uri
        )

    def _to_version(self, mv) -> ModelVersion:
        source = mv.source or ""
        if source.startswith("file://"):
            source = source[len("file://"):]
        tags = dict(mv.tags or {})
        # registry stages were removed in MLflow 3.x; fall back to the
        # stage-as-tag emulation transition_stage() writes there.  The
        # legacy API's "nothing set" value is the STRING "None" (truthy!),
        # which must also defer to the tag.
        cur = getattr(mv, "current_stage", None)
        stage = cur if cur not in (None, "", "None") else tags.get(
            _STAGE_TAG, "None"
        )
        return ModelVersion(
            name=mv.name,
            version=int(mv.version),
            stage=stage or "None",
            run_id=mv.run_id,
            tags=tags,
            artifact_dir=source,
            created_at=(mv.creation_timestamp or 0) / 1000.0,
        )

    def register_model(self, name, artifact_dir, run_id=None, tags=None) -> ModelVersion:
        from mlflow.exceptions import MlflowException

        try:
            self._client.create_registered_model(name)
        except MlflowException as e:
            # error_code spelling varies across mlflow versions — attribute,
            # method, or message-only
            code = getattr(e, "error_code", None)
            if callable(code):  # pragma: no cover - version-dependent
                code = code()
            already = (code == "RESOURCE_ALREADY_EXISTS") or (
                code is None and "already exists" in str(e).lower()
            )
            if not already:
                raise  # real registry failure, don't mask it
        mv = self._client.create_model_version(
            name=name,
            source=f"file://{os.path.abspath(artifact_dir)}",
            run_id=run_id,
            tags={k: str(v) for k, v in (tags or {}).items()},
        )
        return self._to_version(mv)

    def get_version(self, name: str, version: int) -> ModelVersion:
        return self._to_version(self._client.get_model_version(name, str(version)))

    def list_versions(self, name: str):
        mvs = self._client.search_model_versions(f"name='{name}'")
        return sorted((self._to_version(m) for m in mvs), key=lambda v: v.version)

    def latest_version(self, name: str, stage: Optional[str] = None) -> ModelVersion:
        versions = self.list_versions(name)
        if stage is not None:
            versions = [v for v in versions if v.stage == stage]
        if not versions:
            raise KeyError(
                f"no versions of model {name}"
                + (f" in stage {stage}" if stage else "")
            )
        return versions[-1]

    def transition_stage(self, name: str, version: int, stage: str) -> ModelVersion:
        # MLflow <3: real registry stages; MLflow 3.x removed them — emulate
        # with a version tag that _to_version reads back as the stage
        transition = getattr(
            self._client, "transition_model_version_stage", None
        )
        if transition is not None:
            try:
                mv = transition(name, str(version), stage=stage)
                return self._to_version(mv)
            except Exception:  # pragma: no cover - deprecated-API removal path
                pass
        self._client.set_model_version_tag(name, str(version), _STAGE_TAG, stage)
        return self.get_version(name, version)

    def set_version_tag(self, name: str, version: int, key: str, value: str) -> None:
        self._client.set_model_version_tag(name, str(version), key, str(value))

    def models(self):
        return sorted(m.name for m in self._client.search_registered_models())

    def archive_version(self, name: str, version: int) -> ModelVersion:
        return self.transition_stage(name, version, "Archived")

    def delete_version(self, name: str, version: int) -> None:
        self._client.delete_model_version(name, str(version))

    def delete_model(self, name: str) -> None:
        for v in self.list_versions(name):
            self.archive_version(name, v.version)
        self._client.delete_registered_model(name)


class _MlflowRun:
    def __init__(self, client, experiment_id: str, run_id: str):
        self._client = client
        self.experiment_id = experiment_id
        self.run_id = run_id

    def log_params(self, params: Dict) -> None:
        for k, v in params.items():
            self._client.log_param(self.run_id, k, v)

    def log_metrics(self, metrics: Dict[str, float], step: int = 0) -> None:
        for k, v in metrics.items():
            self._client.log_metric(self.run_id, k, float(v), step=step)

    def set_tags(self, tags: Dict[str, str]) -> None:
        for k, v in tags.items():
            self._client.set_tag(self.run_id, k, str(v))

    def log_artifact(self, local_path: str, name: Optional[str] = None) -> str:
        self._client.log_artifact(self.run_id, local_path)
        return local_path

    def log_artifact_bytes(self, name: str, data: bytes) -> str:
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, os.path.basename(name))
            with open(p, "wb") as f:
                f.write(data)
            self._client.log_artifact(self.run_id, p)
        return name

    def log_table(self, name: str, df) -> str:
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, name)
            df.to_parquet(p, index=False)
            self._client.log_artifact(self.run_id, p)
        return name

    def artifact_path(self, name: str) -> str:
        return self._client.download_artifacts(self.run_id, name)

    def params(self) -> Dict:
        return dict(self._client.get_run(self.run_id).data.params)

    def metrics(self) -> Dict[str, float]:
        return dict(self._client.get_run(self.run_id).data.metrics)

    def meta(self) -> Dict:
        info = self._client.get_run(self.run_id)
        return {
            "run_id": self.run_id,
            "run_name": info.info.run_name,
            "status": info.info.status,
            "tags": dict(info.data.tags),
        }

    def end(self, status: str = "FINISHED") -> None:
        self._client.set_terminated(self.run_id, status=status)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end("FAILED" if exc_type else "FINISHED")
