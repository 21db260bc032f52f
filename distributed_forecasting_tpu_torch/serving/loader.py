"""Artifact loading for the task layer: ``load_forecaster`` and
``resolve_from_registry`` (the reference keeps both in its HTTP server
module, ``serving/server.py``; the port has no server, so they live here).

An artifact directory is recognised by its metadata file, as the reference
does: ``ensemble.json`` (mixed-family), ``blend.json`` (blended),
``buckets.json`` (span-bucketed), else a single-family
:class:`BatchForecaster`.  A composite whose members fail to load raises;
nothing falls back.
"""

from __future__ import annotations

import os
from typing import Optional

from distributed_forecasting_tpu_torch.serving.bucketed import (
    BucketedForecaster,
)
from distributed_forecasting_tpu_torch.serving.ensemble import (
    BlendedForecaster,
    MultiModelForecaster,
)
from distributed_forecasting_tpu_torch.serving.predictor import BatchForecaster


def load_forecaster(artifact_dir: str, device=None):
    """Load the serving artifact in ``artifact_dir`` onto ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    if os.path.exists(os.path.join(artifact_dir, "ensemble.json")):
        return MultiModelForecaster.load(artifact_dir, device=device)
    if os.path.exists(os.path.join(artifact_dir, "blend.json")):
        return BlendedForecaster.load(artifact_dir, device=device)
    if os.path.exists(os.path.join(artifact_dir, "buckets.json")):
        return BucketedForecaster.load(artifact_dir, device=device)
    return BatchForecaster.load(artifact_dir, device=device)


def resolve_from_registry(registry, model_name: str,
                          stage: Optional[str] = None, device=None):
    """Registry -> ``(forecaster, version)``: the latest version (of
    ``stage``, when given), loaded once.  A version whose artifacts hold a
    ``forecaster/`` directory loads that directory."""
    version = registry.latest_version(model_name, stage=stage)
    sub = os.path.join(version.artifact_dir, "forecaster")
    art = sub if os.path.isdir(sub) else version.artifact_dir
    return load_forecaster(art, device=device), version
