"""Training task: the fine-grained fit as a job (port of the reference's
``tasks/train.py``), wired through :class:`TrainingPipeline` on the task's
device.  Conf::

    input:
      table: hackathon.sales.raw
    output:
      table: hackathon.sales.finegrain_forecasts
    training:
      model: prophet                # prophet | curve | prophet_ar |
                                    #   holt_winters | croston | theta |
                                    #   arima | auto (per-series best-of) |
                                    #   blend (per-series inverse-CV-error
                                    #   pool); auto and blend default to
                                    #   prophet, holt_winters, theta,
                                    #   croston and arima
      model_conf: {...}             # fields of the model's config dataclass;
                                    # the curve model also takes a named
                                    # holiday calendar (holidays: US, or
                                    # {calendar: US, lower_window: 1,
                                    #  upper_window: 1, custom: {...}});
                                    # holt_winters takes season_length:
                                    # auto (the detected period); arima
                                    # takes order: auto (the CV winner of
                                    # 22 orders, or order_candidates, by
                                    # order_metric) or order: [p, d, q].
                                    # For auto
                                    # and blend: {families: [...], metric:
                                    # smape, temperature: 1.0 (blend),
                                    # configs: {family: {...}}}
      cv: {initial: 730, period: 360, horizon: 90}
      horizon: 90
      freq: D                       # D | W | M (the curve model is daily)
      experiment: finegrain_forecasting
      run_cross_validation: true
      per_series_runs: false
      calibrate_intervals: false    # split-conformal band calibration from
                                    # the CV residuals (engine/calibrate;
                                    # for blend, of the pooled band)
      path: fine_grained            # or 'allocated' (item-level fit scaled
                                    # to stores by historical share; not
                                    # with regressors or calibrate_intervals)
      bucketed: false               # ragged batches: fit span buckets on
                                    # trimmed grids (CV stays on the shared
                                    # grid); the artifact is buckets.json
      regressors:                   # covariates of the curve model: a
        table: hackathon.sales.promo  # catalog table with date (+ the key
        columns: [promo, price]     # columns when per_series), covering
        per_series: false           # history and horizon
      cv_artifact: false            # log cv_forecasts.parquet, the raw
                                    # per-cutoff forecasts of the CV pass
      tuning:                       # per-series prior-scale search of the
        enabled: false              # curve model (engine/hyper.py): n_trials,
                                    # metric, seed, adaptive_rounds, ...

``model: arnet`` (also in a pool) trains by batched gradient descent
(``engine/gradfit.py``; ``engine.gradfit`` arms its engine path); arima's
``method: mle`` (also in a pool) by Adam on the exact Kalman likelihood,
the whole fit one launch of a hand kernel on the card
(``ops/kalman.arima_mle_fit``).
"""

from __future__ import annotations

from distributed_forecasting_tpu_torch.pipelines.training import TrainingPipeline
from distributed_forecasting_tpu_torch.tasks.common import Task


class TrainTask(Task):
    def launch(self) -> dict:
        tr = self.conf.get("training", {})
        pipeline = TrainingPipeline(self.catalog, self.tracker,
                                    device=self.device)
        path = tr.get("path", "fine_grained")
        if path == "allocated":
            if tr.get("regressors"):
                raise ValueError(
                    "training.regressors is not supported on the allocated "
                    "path — covariates would be fit at item level and then "
                    "ratio-scaled; use path: fine_grained"
                )
            if tr.get("calibrate_intervals"):
                raise ValueError(
                    "training.calibrate_intervals is not supported on the "
                    "allocated path (item-level bands are ratio-scaled to "
                    "stores, so per-series CV calibration does not apply); "
                    "use path: fine_grained"
                )
            return pipeline.allocated(**allocated_options(self.conf))
        return pipeline.fine_grained(**fine_grained_options(self.conf))


def allocated_options(conf: dict) -> dict:
    """The allocated path's arguments from a train task conf."""
    inp = conf.get("input", {})
    out = conf.get("output", {})
    tr = conf.get("training", {})
    return dict(
        source_table=inp.get("table", "hackathon.sales.raw"),
        output_table=out.get("table", "hackathon.sales.allocated_forecasts"),
        model=tr.get("model", "prophet"),
        model_conf=tr.get("model_conf"),
        experiment=tr.get("experiment", "allocated_forecasting"),
        horizon=int(tr.get("horizon", 90)),
        freq=str(tr.get("freq", "D")),
    )


def fine_grained_options(conf: dict) -> dict:
    """The fine-grained path's arguments from a train task conf."""
    inp = conf.get("input", {})
    out = conf.get("output", {})
    tr = conf.get("training", {})
    return dict(
        source_table=inp.get("table", "hackathon.sales.raw"),
        output_table=out.get("table", "hackathon.sales.finegrain_forecasts"),
        model=tr.get("model", "prophet"),
        model_conf=tr.get("model_conf"),
        cv_conf=tr.get("cv"),
        experiment=tr.get("experiment", "finegrain_forecasting"),
        horizon=int(tr.get("horizon", 90)),
        run_cross_validation=bool(tr.get("run_cross_validation", True)),
        per_series_runs=bool(tr.get("per_series_runs", False)),
        tuning=tr.get("tuning"),
        bucketed=bool(tr.get("bucketed", False)),
        regressors=tr.get("regressors"),
        cv_artifact=bool(tr.get("cv_artifact", False)),
        calibrate_intervals=bool(tr.get("calibrate_intervals", False)),
        freq=str(tr.get("freq", "D")),
    )


def entrypoint():
    TrainTask().launch()


if __name__ == "__main__":
    entrypoint()
