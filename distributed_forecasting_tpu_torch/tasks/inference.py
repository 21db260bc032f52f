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
      regressors:           # required when the model was fit with
        table: hackathon.sales.promo_calendar   # n_regressors > 0: the
        columns: [promo, price]                 # covariate table, covering
        per_series: false                       # day0 .. day1 + horizon
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

        forecaster, version = resolve_from_registry(
            self.registry, model_name, stage=inf.get("stage"),
            device=self.device,
        )
        self.logger.info(
            "loaded %s v%d (%d series) on %s", model_name, version.version,
            forecaster.n_series, self.device,
        )

        request = self.catalog.read_table(inp.get("table", "hackathon.sales.test_raw"))
        horizon = int(inf.get("horizon", 90))
        xreg = None
        reg = inf.get("regressors")
        if reg:
            if not hasattr(forecaster, "day0"):
                # a bucketed artifact has no single shared grid to resolve
                # the covariates onto
                raise ValueError(
                    "inference.regressors requires a single-batch forecaster "
                    f"artifact; {type(forecaster).__name__} has no shared "
                    "day grid"
                )
            # the covariates over the artifact's full grid: the future
            # values the curve model needs, read from the catalog
            from distributed_forecasting_tpu_torch.data import (
                regressors_for_grid,
            )

            xreg = regressors_for_grid(
                self.catalog.read_table(reg["table"]),
                day0=forecaster.day0,
                n_days=forecaster.day1 + horizon - forecaster.day0 + 1,
                regressor_cols=list(reg["columns"]),
                per_series=bool(reg.get("per_series", False)),
                keys=forecaster.keys,
                key_names=forecaster.key_names,
                device=self.device,
            )
        kwargs = dict(
            horizon=horizon,
            on_missing=inf.get("on_missing", "raise"),
            xreg=xreg,
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
