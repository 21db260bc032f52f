"""Batch inference task: predict from the registry (port of the reference's
``tasks/inference.py``).  Loads the registered model's latest version once
onto the task's device, forecasts every (store, item) of the input table in
one batched call, writes the forecast table, then moves the version to a
stage.

Conf::

    input:
      table: hackathon.sales.test_raw
    output:
      table: hackathon.sales.test_finegrain_forecasts
    inference:
      model_name: ForecastingBatchModel
      stage: null           # resolve latest of this stage; null = any
      horizon: 90
      promote_to: Staging   # stage transition after a successful batch
      on_missing: raise     # or 'skip' for unseen (store, item)
      quantiles: null       # e.g. [0.1, 0.5, 0.9] -> one q<level> column
                            # per level instead of yhat/yhat_upper/yhat_lower

``inference.regressors`` (a regressor model's future covariates) is not
ported yet and raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from distributed_forecasting_tpu_torch.serving.loader import resolve_from_registry
from distributed_forecasting_tpu_torch.tasks.common import Task


class InferenceTask(Task):
    def launch(self) -> dict:
        inp = self.conf.get("input", {})
        out = self.conf.get("output", {})
        inf = self.conf.get("inference", {})
        model_name = inf.get("model_name", "ForecastingBatchModel")
        if inf.get("regressors"):
            raise NotImplementedError(
                "inference.regressors (serving with xreg) is not ported yet "
                "(ROADMAP Queue 1: Slice 4)")

        forecaster, version = resolve_from_registry(
            self.registry, model_name, stage=inf.get("stage"),
            device=self.device,
        )
        self.logger.info(
            "loaded %s v%d (%d series) on %s", model_name, version.version,
            forecaster.n_series, self.device,
        )

        request = self.catalog.read_table(inp.get("table", "hackathon.sales.test_raw"))
        kwargs = dict(
            horizon=int(inf.get("horizon", 90)),
            on_missing=inf.get("on_missing", "raise"),
        )
        quantiles = inf.get("quantiles")
        if quantiles:
            pred = forecaster.predict_quantiles(
                request, quantiles=quantiles, **kwargs
            )
        else:
            pred = forecaster.predict(request, **kwargs)
        table = out.get("table", "hackathon.sales.test_finegrain_forecasts")
        tversion = self.catalog.save_table(table, pred)
        self.logger.info("wrote %d forecast rows -> %s (v%s)", len(pred), table, tversion)

        promote = inf.get("promote_to", "Staging")
        if promote:
            self.registry.transition_stage(model_name, version.version, promote)
            self.logger.info("promoted %s v%d -> %s", model_name, version.version, promote)
        return {
            "model_version": version.version,
            "rows": len(pred),
            "table_version": tversion,
        }


def entrypoint():
    InferenceTask().launch()


if __name__ == "__main__":
    entrypoint()
