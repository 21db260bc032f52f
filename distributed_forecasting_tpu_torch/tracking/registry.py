"""Model registry — versions, stages, tags; the MLflow-registry stand-in
(own copy of the reference's ``tracking/registry.py``, same layout).

Reference usage being reproduced: ``mlflow.register_model(model_uri,
"ForecastingModelUDF")`` after deploy (``notebooks/prophet/03_deploy.py:34-36``),
model-version tags carrying serving metadata incl. the schema string
(``03_deploy.py:44-58``), latest-version resolution at inference time
(``notebooks/prophet/04_inference.py:10-12``), and stage transitions
None -> Staging (``04_inference.py:66-76``).

Versions point at an artifact directory (typically a run's artifacts) by
copy, so a registered model is immutable even if the run is deleted.

Layout::

    root/models/<name>/meta.json            # next_version, description
    root/models/<name>/v<version>/meta.json # stage, tags, source, run_id
    root/models/<name>/v<version>/artifacts/...
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Dict, List, Optional

STAGES = ("None", "Staging", "Production", "Archived")


@dataclasses.dataclass
class ModelVersion:
    name: str
    version: int
    stage: str
    run_id: Optional[str]
    tags: Dict[str, str]
    artifact_dir: str
    created_at: float


class ModelRegistry:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "models"), exist_ok=True)

    def _model_dir(self, name: str) -> str:
        return os.path.join(self.root, "models", name)

    def register_model(
        self,
        name: str,
        artifact_dir: str,
        run_id: Optional[str] = None,
        tags: Optional[Dict[str, str]] = None,
    ) -> ModelVersion:
        """Snapshot ``artifact_dir`` as a new version of ``name``."""
        d = self._model_dir(name)
        os.makedirs(d, exist_ok=True)
        meta_path = os.path.join(d, "meta.json")
        meta = self._read(meta_path) or {"name": name, "next_version": 1}
        version = meta["next_version"]
        meta["next_version"] = version + 1
        vdir = os.path.join(d, f"v{version}")
        shutil.copytree(artifact_dir, os.path.join(vdir, "artifacts"))
        self._write(
            os.path.join(vdir, "meta.json"),
            {
                "name": name,
                "version": version,
                "stage": "None",
                "run_id": run_id,
                "tags": {k: str(v) for k, v in (tags or {}).items()},
                "created_at": time.time(),
            },
        )
        self._write(meta_path, meta)
        return self.get_version(name, version)

    def get_version(self, name: str, version: int) -> ModelVersion:
        vdir = os.path.join(self._model_dir(name), f"v{version}")
        meta = self._read(os.path.join(vdir, "meta.json"))
        if meta is None:
            raise KeyError(f"model {name} version {version} not found")
        return ModelVersion(
            name=name,
            version=version,
            stage=meta["stage"],
            run_id=meta.get("run_id"),
            tags=meta.get("tags", {}),
            artifact_dir=os.path.join(vdir, "artifacts"),
            created_at=meta.get("created_at", 0.0),
        )

    def list_versions(self, name: str) -> List[ModelVersion]:
        d = self._model_dir(name)
        if not os.path.isdir(d):
            return []
        versions = sorted(
            int(entry[1:])
            for entry in os.listdir(d)
            if entry.startswith("v") and entry[1:].isdigit()
        )  # numeric sort: lexical would put v10 before v2 (latest == wrong)
        return [self.get_version(name, v) for v in versions]

    def latest_version(
        self, name: str, stage: Optional[str] = None
    ) -> ModelVersion:
        """Latest version, optionally restricted to a stage — the resolution
        rule the reference's ``predict_udf`` uses (``04_inference.py:10-12``:
        ``latest_versions[0]``)."""
        versions = self.list_versions(name)
        if stage is not None:
            versions = [v for v in versions if v.stage == stage]
        if not versions:
            raise KeyError(f"no versions of model {name}" + (f" in stage {stage}" if stage else ""))
        return versions[-1]

    def transition_stage(self, name: str, version: int, stage: str) -> ModelVersion:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; valid: {STAGES}")
        vdir = os.path.join(self._model_dir(name), f"v{version}")
        meta_path = os.path.join(vdir, "meta.json")
        meta = self._read(meta_path)
        if meta is None:
            raise KeyError(f"model {name} version {version} not found")
        meta["stage"] = stage
        self._write(meta_path, meta)
        return self.get_version(name, version)

    def set_version_tag(self, name: str, version: int, key: str, value: str) -> None:
        vdir = os.path.join(self._model_dir(name), f"v{version}")
        meta_path = os.path.join(vdir, "meta.json")
        meta = self._read(meta_path)
        if meta is None:
            raise KeyError(f"model {name} version {version} not found")
        meta.setdefault("tags", {})[key] = str(value)
        self._write(meta_path, meta)

    def models(self) -> List[str]:
        base = os.path.join(self.root, "models")
        return sorted(
            d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d))
        )

    # -- cleanup (reference 05_monitoring_wip.py:40-59 archives every version
    # then deletes the registered model) ------------------------------------
    def archive_version(self, name: str, version: int) -> ModelVersion:
        """Stage transition to Archived — the reference's pre-delete step."""
        return self.transition_stage(name, version, "Archived")

    def delete_version(self, name: str, version: int) -> None:
        vdir = os.path.join(self._model_dir(name), f"v{version}")
        if not os.path.isdir(vdir):
            raise KeyError(f"model {name} version {version} not found")
        shutil.rmtree(vdir)

    def delete_model(self, name: str) -> None:
        """Archive-and-delete every version, then the model itself."""
        d = self._model_dir(name)
        if not os.path.isdir(d):
            raise KeyError(f"model {name} not found")
        for v in self.list_versions(name):
            self.archive_version(name, v.version)
        shutil.rmtree(d)

    @staticmethod
    def _read(path: str):
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def _write(path: str, obj) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=2)
        os.replace(tmp, path)
