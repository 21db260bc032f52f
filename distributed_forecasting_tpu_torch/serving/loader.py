"""Artifact loading for the task layer: ``load_forecaster`` and
``resolve_from_registry`` (the reference keeps both in its HTTP server
module, ``serving/server.py``; the port has no server, so they live here).

Only single-family :class:`BatchForecaster` artifacts load.  The reference's
composite artifacts — mixed-family, blended and span-bucketed — are
recognised by their metadata file and refused, naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import os
from typing import Optional

from distributed_forecasting_tpu_torch.serving.predictor import BatchForecaster

# metadata file of each composite artifact -> the ROADMAP item porting it
_COMPOSITE = {
    "ensemble.json": "mixed-family artifacts, serving/ensemble.py "
                     "(ROADMAP Queue 1: P8)",
    "blend.json": "blended artifacts, engine/blend.py and serving/ensemble.py "
                  "(ROADMAP Queue 1: P8)",
    "buckets.json": "span-bucketed artifacts, serving/bucketed.py "
                    "(ROADMAP Queue 1: Slice 4, fit_forecast_bucketed)",
}


def load_forecaster(artifact_dir: str, device=None) -> BatchForecaster:
    """Load the serving artifact in ``artifact_dir`` onto ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    for meta, item in _COMPOSITE.items():
        if os.path.exists(os.path.join(artifact_dir, meta)):
            raise NotImplementedError(
                f"{artifact_dir} holds {meta}: loading {item} is not ported "
                f"yet"
            )
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
