"""Deploy task: register the batched forecaster of a training run (port of
the reference's ``tasks/deploy.py``).  The training run already saved the
serving artifact, so deploy = resolve the run -> load its ``forecaster/``
artifact (which checks that it loads before any version points at it) ->
register it -> tag the version with its serving metadata.

Conf::

    deploy:
      experiment: finegrain_forecasting
      run_id: <optional — defaults to the newest run with a forecaster>
      model_name: ForecastingBatchModel
      tags: {reviewed: "false"}
"""

from __future__ import annotations

import os

from distributed_forecasting_tpu_torch.serving.loader import load_forecaster
from distributed_forecasting_tpu_torch.tasks.common import Task


class DeployTask(Task):
    def launch(self) -> dict:
        dep = self.conf.get("deploy", {})
        experiment = dep.get("experiment", "finegrain_forecasting")
        model_name = dep.get("model_name", "ForecastingBatchModel")

        eid = self.tracker.get_experiment_by_name(experiment)
        if eid is None:
            raise KeyError(f"experiment {experiment!r} not found")
        run_id = dep.get("run_id")
        if run_id is None:
            runs = [
                r for r in self.tracker.search_runs(eid)
                if os.path.isdir(r.artifact_path("forecaster"))
            ]
            if not runs:
                raise KeyError(f"no runs with a forecaster artifact in {experiment!r}")
            runs.sort(key=lambda r: r.meta().get("start_time", 0.0))
            run = runs[-1]
        else:
            run = self.tracker.get_run(eid, run_id)

        art = run.artifact_path("forecaster")
        fc = load_forecaster(art, device=self.device)
        version = self.registry.register_model(
            model_name,
            art,
            run_id=run.run_id,
            tags={
                "udf": "batched",  # one batched model, not one per series
                "reviewed": dep.get("tags", {}).get("reviewed", "false"),
                "serving_schema": fc.serving_schema,
                "source_experiment": experiment,
                "model_family": fc.family,
            },
        )
        for k, v in dep.get("tags", {}).items():
            self.registry.set_version_tag(model_name, version.version, k, v)
        self.logger.info(
            "registered %s v%d from run %s", model_name, version.version, run.run_id
        )
        return {"model_name": model_name, "version": version.version,
                "run_id": run.run_id}


def entrypoint():
    DeployTask().launch()


if __name__ == "__main__":
    entrypoint()
