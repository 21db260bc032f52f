"""Training pipeline (port of the reference's ``pipelines/training.py``:
the fine-grained path, plain and over a pool of families, and the
allocated path).

:meth:`TrainingPipeline.fine_grained` is the headline per-(store, item)
workload: history -> tensorize -> rolling-origin CV (optionally with
split-conformal band calibration) -> one batched fit + forecast -> one
tracked run (params, aggregate metrics, the per-series metric table, the
serving artifact) -> the forecast table.  Options: the curve model's
covariates from a catalog table (``regressors``), span buckets on trimmed
grids for ragged batches (``bucketed``; the artifact is a
``BucketedForecaster``) and the CV pass's raw forecasts as a run table
(``cv_artifact``).  ``model: arnet`` trains by batched gradient descent
(``engine/gradfit``).  ``tuning.enabled`` runs the per-series prior-scale
search of the curve model instead (``engine/hyper``, the reference's
tuned path: a refit per seasonality mode, each series served by its
winning mode).  ``model: auto`` serves each
series from the family that won its CV (``engine/select``), ``model:
blend`` from the per-series weighted pool of all of them
(``engine/blend``); their artifacts are the composite forecasters of
``serving/ensemble``.  :meth:`TrainingPipeline.allocated` fits one model
per item and scales the item forecasts to stores by historical share.

With the ``engine.autoprep`` block armed (``tasks/common`` installs it),
the plain fine-grained path preps the batch once before its config
(``engine/autoprep``): the fit and the CV pass see the cleaned tensor, a
detected period replaces ``season_length: auto``, holiday indicator columns
join the regressors, and the run logs the ``prep_*`` metrics and the
``prep_report`` / ``prep_repairs`` tables.  The pooled and allocated paths
get the cleaning stages inside ``fit_forecast``.

The fine-grained path runs in three stages, as the reference's serial
path does: ``prep`` (read, tensorize, prep, resolve the config), ``dispatch``
(the CV pass and the fit, launched on the card) and ``complete`` (every
host pull, then the tracking and table writes).  The reference's
executor, which overlaps the stages of several experiments, is not ported
(ROADMAP Queue 1: P11); its contract makes the pipelined path
byte-identical to this one.

Options the port does not run yet raise ``NotImplementedError`` naming the
ROADMAP item that ports them; none is ignored.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.data import holidays as H
from distributed_forecasting_tpu_torch.data.catalog import DatasetCatalog
from distributed_forecasting_tpu_torch.data.tensorize import (
    resolved_backend,
    tensorize,
    tensorize_regressors,
)
from distributed_forecasting_tpu_torch.engine.calibrate import (
    apply_interval_scale,
)
from distributed_forecasting_tpu_torch.engine.autoprep import (
    autoprep_batch,
    autoprep_config,
)
from distributed_forecasting_tpu_torch.engine.blend import fit_forecast_blend
from distributed_forecasting_tpu_torch.engine.cv import CVConfig, cross_validate
from distributed_forecasting_tpu_torch.engine.fit import (
    DEFAULT_MIN_POINTS,
    ForecastResult,
    day_grid,
    fit_forecast,
    fit_forecast_bucketed,
    forecast_frame,
    health_fallback,
)
from distributed_forecasting_tpu_torch.engine.hyper import (
    HyperSearchConfig,
    tune_curve_model,
)
from distributed_forecasting_tpu_torch.engine.order import resolve_order_conf
from distributed_forecasting_tpu_torch.engine.season import (
    detect_season_length,
)
from distributed_forecasting_tpu_torch.engine.select import (
    DEFAULT_FAMILIES,
    fit_forecast_auto,
)
from distributed_forecasting_tpu_torch.models import prophet_glm
from distributed_forecasting_tpu_torch.models.base import (
    MODEL_REGISTRY,
    get_model,
    require_models,
)
from distributed_forecasting_tpu_torch.serving.bucketed import (
    BucketedForecaster,
)
from distributed_forecasting_tpu_torch.serving.ensemble import (
    BlendedForecaster,
    MultiModelForecaster,
)
from distributed_forecasting_tpu_torch.serving.predictor import BatchForecaster
from distributed_forecasting_tpu_torch.tracking import FileTracker
from distributed_forecasting_tpu_torch.utils.config import freeze
from distributed_forecasting_tpu_torch.utils.device import resolve_device
from distributed_forecasting_tpu_torch.utils.logging import get_logger
from distributed_forecasting_tpu_torch.utils.profiling import (
    PhaseTimer,
    device_trace,
)

_METRICS = ("mse", "rmse", "mae", "mape", "smape", "mdape", "coverage",
            "mase")

# per-series drill-down runs: warn above this count (O(S) host loop)
_PER_SERIES_RUNS_WARN = 2000

_CALENDAR_DAILY_FAMILIES = frozenset({"prophet", "curve", "prophet_ar"})


def _comparability_params(batch, cv):
    """The CV protocol and data span behind this run's ``val_*`` metrics:
    scores measured on different history windows or CV configs are not
    comparable, and a promotion gate reads these to tell.  ``cv``: the
    CVConfig that ran; None when CV was skipped."""
    dates = batch.dates()
    return {
        "cv_protocol": (f"{cv.initial}/{cv.period}/{cv.horizon}"
                        if cv is not None else "none"),
        "data_span": (f"{dates[0].date()}..{dates[-1].date()}"
                      f":{getattr(batch, 'freq', 'D')}"),
    }


def _config_from_conf(model: str, model_conf: Optional[Dict[str, Any]]):
    fns = get_model(model)
    # YAML sequences arrive as lists; configs stay hashable
    return fns.config_cls(
        **{k: freeze(v) for k, v in (model_conf or {}).items()}
    )


def _pool_families(model: str, model_conf) -> tuple:
    """The families of a ``model: auto | blend`` pool (the conf's
    ``families``, else the default pool); empty for a single model."""
    if model not in ("auto", "blend"):
        return ()
    return tuple((model_conf or {}).get("families", DEFAULT_FAMILIES))


def _check_cadence(freq: str, model: str, model_conf,
                   regressors=None, tuning=None) -> None:
    """The curve model's weekly/yearly Fourier terms, holiday calendars,
    conf-driven regressor grids and the tuned path are calendar-daily: on a
    week or month grid they raise here, also when the curve model is in a
    pool, rather than fit a 7-step "weekly" cycle."""
    if freq == "D":
        return
    bad = ({model} | set(_pool_families(model, model_conf))) & (
        _CALENDAR_DAILY_FAMILIES)
    if bad or (tuning and tuning.get("enabled")):
        raise ValueError(
            f"training.freq={freq!r}: the curve model's seasonalities and "
            f"the tuned path are calendar-daily; use the cadence-agnostic "
            f"families (holt_winters/arima/theta/croston) or freq: D"
            + (f" (conf names {sorted(bad)})" if bad else "")
        )
    if regressors:
        raise ValueError(
            f"training.freq={freq!r}: conf-driven regressors resolve on a "
            f"daily calendar grid; use freq: D"
        )
    if isinstance((model_conf or {}).get("holidays"), (str, dict)):
        raise ValueError(
            f"training.freq={freq!r}: holiday calendars are daily; "
            f"use freq: D"
        )


def _resolve_model_conf(model: str, model_conf: Optional[Dict[str, Any]],
                        batch, horizon: int,
                        cv_conf: Optional[Dict[str, Any]] = None
                        ) -> Optional[Dict[str, Any]]:
    """The conf translations applied before a config is built, on every
    path (plain, allocated, and each member of a pool): a named holiday
    calendar, ``season_length: auto`` and arima's ``order: auto`` (or
    ``order: [p, d, q]``; selected by CV under ``cv_conf``)."""
    out = _resolve_season_conf(
        _resolve_holidays_conf(model_conf, batch, horizon), batch)
    # any order* key: resolve_order_conf owns the refusal of
    # order_candidates / order_metric without an order
    if model == "arima" and any(
            k in (out or {}) for k in ("order", "order_candidates",
                                       "order_metric")):
        out = resolve_order_conf(out, batch, cv_conf)
    return out


def _resolve_season_conf(
    model_conf: Optional[Dict[str, Any]], batch
) -> Optional[Dict[str, Any]]:
    """Turn ``season_length: auto`` into the batch's detected dominant
    period (``engine/season``), a plain int: the config field is static.
    With no detectable period the default follows the grid's cadence: 7
    days, 52 weeks or 12 months."""
    if not model_conf or model_conf.get("season_length") != "auto":
        return model_conf
    out = dict(model_conf)
    default = {"D": 7, "W": 52, "M": 12}.get(batch.freq, 7)
    out["season_length"] = detect_season_length(batch, default=default)
    return out


def _resolve_holidays_conf(
    model_conf: Optional[Dict[str, Any]], batch, horizon: int
) -> Optional[Dict[str, Any]]:
    """Turn a NAMED holiday calendar in a model conf into the static
    epoch-day spec the curve model carries::

        holidays: US                 # or the expanded form:
        holidays:
          calendar: US
          lower_window: 1            # widen each occurrence like Prophet
          upper_window: 1
          custom:                    # extra events, Prophet-dict style
            promo: ["2017-11-24", "2017-12-26"]

    The calendar covers the batch's dates extended by ``horizon``, so the
    forecast window's occurrences get indicator columns too.  An explicit
    epoch-day spec (a sequence of (name, days) pairs) passes through.
    """
    if not model_conf or not isinstance(model_conf.get("holidays"), (str, dict)):
        return model_conf
    spec = model_conf["holidays"]
    if isinstance(spec, str):
        spec = {"calendar": spec}
    lower = int(spec.get("lower_window", 0))
    upper = int(spec.get("upper_window", 0))
    epoch = pd.Timestamp("1970-01-01")
    start = epoch + pd.Timedelta(days=int(batch.day[0]))
    end = epoch + pd.Timedelta(days=int(batch.day[-1]) + horizon)
    name = spec.get("calendar")
    custom = spec.get("custom") or {}
    if not name and not custom:
        raise ValueError(
            "holidays conf resolved to an empty calendar: give 'calendar: "
            "US', a 'custom' dates dict, or both"
        )
    out = dict(model_conf)
    out["holidays"] = H.holiday_spec_for_range(
        start, end, calendar=(name or "none"), custom=custom,
        lower_window=lower, upper_window=upper)
    return out


def _load_regressors(catalog, regressors: Dict[str, Any], batch,
                     horizon: int, config):
    """Conf-driven covariates: read the catalog table, tensorize it onto the
    batch's grid extended by ``horizon``, and stamp the column count and
    names into the config.  Returns ``(xreg, config)``."""
    cols = list(regressors["columns"])
    xreg = tensorize_regressors(
        catalog.read_table(regressors["table"]), batch, cols, horizon=horizon,
        per_series=bool(regressors.get("per_series", False)),
    )
    config = dataclasses.replace(config, n_regressors=len(cols),
                                 regressor_names=tuple(cols))
    return xreg, config


class TrainingPipeline:
    """The fine-grained and allocated training paths on ``device``
    (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, catalog: DatasetCatalog, tracker: FileTracker,
                 device=None):
        self.catalog = catalog
        self.tracker = tracker
        self.device = resolve_device(device)
        self.logger = get_logger("TrainingPipeline")

    # ------------------------------------------------------------------ fine
    def fine_grained(self, source_table: str, output_table: str,
                     **options) -> Dict[str, Any]:
        """Run the fine-grained path: ``prep``, ``dispatch`` and ``complete``
        in order (:meth:`fine_grained_stages` takes the same arguments).
        Returns the run summary: ids, table version, series counts,
        ``fit_seconds`` and the logged metrics."""
        prep, dispatch, complete = self.fine_grained_stages(
            source_table, output_table, **options)
        return complete(dispatch(prep()))

    def fine_grained_stages(
        self,
        source_table: str,
        output_table: str,
        model: str = "prophet",
        model_conf: Optional[Dict[str, Any]] = None,
        cv_conf: Optional[Dict[str, Any]] = None,
        experiment: str = "finegrain_forecasting",
        horizon: int = 90,
        key_cols=("store", "item"),
        run_cross_validation: bool = True,
        per_series_runs: bool = False,
        tuning: Optional[Dict[str, Any]] = None,
        trace_dir: Optional[str] = None,
        bucketed: bool = False,
        regressors: Optional[Dict[str, Any]] = None,
        cv_artifact: bool = False,
        calibrate_intervals: bool = False,
        freq: str = "D",
    ):
        """Validate the options and return the path's three stages:
        ``prep() -> state`` (read, tensorize, config), ``dispatch(state) ->
        state`` (the CV pass and the fit, launched on the device, and the
        calibrated bands) and ``complete(state) -> summary`` (the host
        pulls, then the tracked run, the artifact and the table)."""
        tuned = bool(tuning and tuning.get("enabled"))
        # the reference's checks of invalid combinations, as they are
        if regressors:
            if model in ("auto", "blend"):
                raise ValueError(
                    f"training.regressors is not supported together with "
                    f"model={model!r} — the non-curve families in the "
                    f"selection/blend pool cannot use covariates; fit the "
                    f"curve model directly with regressors"
                )
            if model in MODEL_REGISTRY and not get_model(model).supports_xreg:
                raise ValueError(
                    f"model {model!r} does not accept exogenous regressors; "
                    f"use the curve model ('prophet')"
                )
        if cv_artifact and (model in ("auto", "blend") or tuned):
            raise ValueError(
                "training.cv_artifact is only supported on the plain "
                "fine-grained path (not model='auto'/'blend' or "
                "tuning.enabled)"
            )
        if calibrate_intervals:
            if model == "auto" or tuned:
                raise ValueError(
                    "training.calibrate_intervals is supported on the plain "
                    "and model='blend' paths (not model='auto' or "
                    "tuning.enabled)"
                )
            if bucketed:
                raise ValueError(
                    "training.calibrate_intervals is not supported together "
                    "with training.bucketed — the bucketed artifact has no "
                    "shared series axis to carry per-series scales"
                )
            if not run_cross_validation and model != "blend":
                raise ValueError(
                    "training.calibrate_intervals requires "
                    "run_cross_validation: the CV residuals ARE the "
                    "calibration set"
                )
        if tuned:
            # the tuned path is the curve model's, whatever ``model`` says
            _check_cadence(freq, model, model_conf, regressors=regressors,
                           tuning=tuning)
            if bucketed:
                raise ValueError(
                    "training.bucketed is not supported together with "
                    "tuning.enabled — the tuned path fits on the shared grid"
                )
            return self._tuned_stages(
                source_table, output_table, model_conf, cv_conf, tuning,
                experiment, horizon, key_cols, regressors, trace_dir)
        # every family of a pool is checked here, before any data is read
        pool = _pool_families(model, model_conf)
        require_models(pool or (model,))
        if bucketed and pool:
            raise ValueError(
                f"training.bucketed is not supported together with "
                f"model={model!r} — pooled fits run on the shared grid"
            )
        _check_cadence(freq, model, model_conf, regressors=regressors)
        if pool:
            return self._pool_stages(
                model, pool, source_table, output_table, model_conf, cv_conf,
                experiment, horizon, key_cols, freq, calibrate_intervals,
                trace_dir)

        def prep() -> Dict[str, Any]:
            timer = PhaseTimer()
            with timer.phase("read"):
                df = self.catalog.read_table(source_table)
            with timer.phase("tensorize"):
                batch = tensorize(df, key_cols=key_cols, freq=freq,
                                  device=self.device)
            # automatic data prep BEFORE the config: the fit sees the
            # cleaned tensor, and a detected season feeds the config as
            # season_length: auto would, but from the repaired series
            mconf = model_conf
            prep_report = prep_xreg = prep_frames = None
            apcfg = autoprep_config()
            if apcfg.enabled and apcfg.any_stage:
                with timer.phase("autoprep"):
                    prep_res = autoprep_batch(batch, apcfg, horizon=horizon)
                prep_report = prep_res.report
                prep_xreg = prep_res.xreg
                # the artifact frames against the RAW batch, before it is
                # swapped for the cleaned one: y_raw is the original value
                prep_frames = {
                    "prep_report.parquet": prep_report.to_frame(batch),
                    "prep_repairs.parquet": prep_report.repairs_frame(batch),
                }
                batch = prep_res.batch
                if (prep_res.season_length is not None
                        and (mconf or {}).get("season_length") == "auto"):
                    mconf = {**mconf,
                             "season_length": int(prep_res.season_length)}
                self.logger.info("autoprep: %s", prep_report.summary())
            # config after tensorize: a named holiday calendar resolves over
            # the batch's actual date range (+ horizon)
            config = _config_from_conf(
                model, _resolve_model_conf(model, mconf, batch, horizon,
                                           cv_conf))
            if (model_conf or {}).get("season_length") == "auto":
                self.logger.info("season_length: auto -> detected period %d",
                                 config.season_length)
            if (model_conf or {}).get("order") == "auto":
                self.logger.info(
                    "arima order: auto -> selected (p, d, q) = (%d, %d, %d)",
                    config.p, config.d, config.q)
            xreg = None
            if regressors:
                # a catalog table with date (+ the key columns per series)
                # and the named columns, covering history and horizon
                with timer.phase("tensorize_regressors"):
                    xreg, config = _load_regressors(
                        self.catalog, regressors, batch, horizon, config)
            if prep_xreg is not None:
                # the holiday indicator columns join the regressors as a
                # shared (T + H, R) calendar; their names go into the
                # config, so the artifact records what the fit saw
                hnames = tuple(prep_report.holiday_names)
                if xreg is None:
                    xreg = prep_xreg
                elif xreg.dim() == 3:
                    hx = prep_xreg[None].expand(
                        (xreg.shape[0],) + tuple(prep_xreg.shape))
                    xreg = torch.cat([xreg, hx], dim=-1)
                else:
                    xreg = torch.cat([xreg, prep_xreg], dim=-1)
                config = dataclasses.replace(
                    config,
                    n_regressors=int(config.n_regressors) + len(hnames),
                    regressor_names=tuple(config.regressor_names) + hnames)
            self.logger.info(
                "fine-grained fit: %d series x %d days, model=%s%s on %s",
                batch.n_series, batch.n_time, model,
                f", {config.n_regressors} regressors" if xreg is not None
                else "", self.device,
            )
            return {"timer": timer, "batch": batch, "config": config,
                    "xreg": xreg, "prep_report": prep_report,
                    "prep_frames": prep_frames}

        def dispatch(state: Dict[str, Any]) -> Dict[str, Any]:
            timer, batch, config = state["timer"], state["batch"], state["config"]
            xreg = state["xreg"]
            t_start = time.time()
            cv = CVConfig(**(cv_conf or {})) if run_cross_validation else None
            cv_metrics = cv_frame = None
            buckets = params = None
            # CUDA launches are asynchronous: these phases time the host
            # side; the device's time lands in fit_seconds at the pulls
            with device_trace(trace_dir):
                if run_cross_validation:
                    with timer.phase("cross_validation"):
                        # with cv_artifact, one CV pass gives the metrics
                        # and the frame
                        out = cross_validate(
                            batch, model=model, config=config, cv=cv,
                            xreg=xreg, return_frame=cv_artifact,
                            calibrate=calibrate_intervals,
                        )
                        cv_metrics, cv_frame = (out if cv_artifact
                                                else (out, None))
                with timer.phase("fit_forecast"):
                    if bucketed:
                        # span buckets on trimmed grids; CV above stays on
                        # the shared grid (a short bucket may not cover the
                        # CV's initial window, and the masks keep it right)
                        buckets, result = fit_forecast_bucketed(
                            batch, model=model, config=config,
                            horizon=horizon, xreg=xreg,
                            autoprep=False,  # prep() already cleaned
                        )
                    else:
                        params, result = fit_forecast(
                            batch, model=model, config=config,
                            horizon=horizon, xreg=xreg,
                            autoprep=False,  # prep() already cleaned
                        )
            interval_scale = None
            if calibrate_intervals:
                # the table and the artifact ship the calibrated bands; the
                # logged val_coverage stays the raw band's, beside
                # val_coverage_calibrated
                interval_scale = cv_metrics["_interval_scale"]
                _, lo_c, hi_c = apply_interval_scale(
                    result.yhat, result.lo, result.hi, interval_scale,
                    floor=get_model(model).band_floor,
                )
                result = dataclasses.replace(result, lo=lo_c, hi=hi_c)
            state.update(t_start=t_start, cv=cv, cv_metrics=cv_metrics,
                         cv_frame=cv_frame, buckets=buckets, params=params,
                         result=result, interval_scale=interval_scale)
            return state

        def complete(state: Dict[str, Any]) -> Dict[str, Any]:
            timer, batch = state["timer"], state["batch"]
            config, params, result = state["config"], state["params"], state["result"]
            cv, cv_metrics = state["cv"], state["cv_metrics"]
            # every host pull of the run, first: fit_seconds spans the
            # device work
            ok = result.ok.cpu().numpy()
            cv_host = None
            if cv_metrics is not None:
                cv_host = {k: v.cpu().numpy() for k, v in cv_metrics.items()
                           if not k.startswith("_")}
            scales = cov_c = None
            if state["interval_scale"] is not None:
                scales = state["interval_scale"].cpu().numpy()
                cov_c = cv_metrics["_coverage_calibrated"].cpu().numpy()
            fit_seconds = time.time() - state["t_start"]

            n_failed = int((~ok).sum())
            if n_failed == batch.n_series:
                raise RuntimeError("no series trained successfully")

            eid = self.tracker.create_experiment(experiment)
            with self.tracker.start_run(
                eid,
                run_name=f"batched_{model}_fit",
                tags={"model": model, "partial_model": str(n_failed > 0)},
            ) as run:
                if bucketed:
                    run.log_params(dataclasses.asdict(config))
                    run.log_params({"n_buckets": len(state["buckets"])})
                elif model in ("prophet", "curve"):
                    run.log_params(prophet_glm.extract_params(params, config))
                else:
                    run.log_params(dataclasses.asdict(config))
                run.log_params(
                    {
                        "n_series": batch.n_series,
                        "n_time": batch.n_time,
                        "horizon": horizon,
                        "n_failed_series": n_failed,
                        # the host data plane that built the tensor (the
                        # native path is daily only)
                        "tensorize_backend": (
                            resolved_backend(n_keys=len(key_cols))
                            if batch.freq == "D" else "pandas"
                        ),
                        **_comparability_params(batch, cv),
                    }
                )
                agg = {"fit_seconds": fit_seconds,
                       "series_per_second":
                           batch.n_series / max(fit_seconds, 1e-9)}
                agg.update(timer.metrics())
                series_table = batch.key_frame()
                series_table["fit_ok"] = ok
                if cv_host is not None:
                    for name in _METRICS:
                        vals = cv_host[name]
                        series_table[name] = vals
                        # nanmean: a per-series NaN (mase on a constant
                        # training window) must not poison the aggregate
                        agg[f"val_{name}"] = (float(np.nanmean(vals[ok]))
                                              if ok.any() else float("nan"))
                    agg["n_cv_cutoffs"] = cv_metrics["_n_cutoffs"]
                if scales is not None:
                    series_table["interval_scale"] = scales
                    agg["interval_scale_mean"] = (float(np.mean(scales[ok]))
                                                  if ok.any() else float("nan"))
                    series_table["coverage_calibrated"] = cov_c
                    agg["val_coverage_calibrated"] = (
                        float(np.mean(cov_c[ok])) if ok.any() else float("nan"))
                if state["prep_report"] is not None:
                    # what autoprep did, per batch (metrics), per series
                    # (prep_report) and per repaired point (prep_repairs):
                    # repairs exist in the fit tensor and in these
                    # artifacts, never in the stored history
                    agg.update(state["prep_report"].summary())
                    for name, frame in state["prep_frames"].items():
                        if len(frame):
                            run.log_table(name, frame)
                run.log_metrics(agg)
                run.log_table("series_metrics.parquet", series_table)
                if cv_artifact and run_cross_validation:
                    # the raw per-cutoff forecasts (Prophet's diagnostics
                    # shape), from the CV pass above
                    run.log_table("cv_forecasts.parquet", state["cv_frame"])

                if bucketed:
                    forecaster = BucketedForecaster.from_bucketed_fit(
                        state["buckets"], model, config)
                else:
                    forecaster = BatchForecaster.from_fit(
                        batch, params, model, config, interval_scale=scales)
                forecaster.save(run.artifact_path("forecaster"))

                if per_series_runs:
                    self._log_per_series_runs(eid, series_table, run.run_id)
                run_id = run.run_id

            table_df = forecast_frame(batch, result)
            version = self.catalog.save_table(output_table, table_df)
            self.logger.info(
                "wrote %s (version %s): %d rows; fit %.2fs (%.1f series/s); "
                "%d/%d series ok",
                output_table, version, len(table_df), fit_seconds,
                agg["series_per_second"], batch.n_series - n_failed,
                batch.n_series,
            )
            if n_failed:
                self.logger.warning(
                    "partial model: %d series fell back", n_failed)
            return {
                "experiment_id": eid,
                "run_id": run_id,
                "table_version": version,
                "n_series": batch.n_series,
                "n_failed": n_failed,
                "fit_seconds": fit_seconds,
                "metrics": dict(agg),
            }

        return prep, dispatch, complete

    # --------------------------------------------------------------- tuned
    def _tuned_stages(self, source_table, output_table, model_conf, cv_conf,
                      tuning, experiment, horizon, key_cols, regressors,
                      trace_dir):
        """The stages of the tuned curve-model path (the reference's
        ``_fine_grained_tuned``, the AutoML notebook's per-series tuning):
        the search (``engine/hyper.tune_curve_model``), a forecast per
        mode, each series' winning mode gathered on the device, the
        fail-safe, then the ``tuned_curve_fit`` run with its trial and
        per-series tables and the artifact (the majority mode's params)."""
        def prep() -> Dict[str, Any]:
            df = self.catalog.read_table(source_table)
            batch = tensorize(df, key_cols=key_cols, device=self.device)
            base = _config_from_conf(
                "prophet", _resolve_holidays_conf(model_conf, batch, horizon))
            xreg = None
            if regressors:
                xreg, base = _load_regressors(self.catalog, regressors, batch,
                                              horizon, base)
            search = HyperSearchConfig(
                n_trials=int(tuning.get("n_trials", 8)),
                metric=tuning.get("metric", "smape"),
                seed=int(tuning.get("seed", 0)),
                adaptive_rounds=int(tuning.get("adaptive_rounds", 1)),
                zoom_sigma=float(tuning.get("zoom_sigma", 0.8)),
                zoom_factor=float(tuning.get("zoom_factor", 0.5)),
            )
            return {"batch": batch, "base": base, "xreg": xreg,
                    "search": search, "cv": CVConfig(**(cv_conf or {}))}

        def dispatch(state: Dict[str, Any]) -> Dict[str, Any]:
            batch, base = state["batch"], state["base"]
            xreg, search = state["xreg"], state["search"]
            t_start = time.time()
            with device_trace(trace_dir):
                # the search sees the history slice of xreg; the refit
                # params carry the regressor coefficients for serving
                tuned = tune_curve_model(batch, base_config=base,
                                         search=search, cv=state["cv"],
                                         xreg=xreg)
                day_all = day_grid(batch.day, horizon)
                t_end = batch.day[-1].to(torch.float32)
                modes = list(tuned.mode_params)
                outs = [prophet_glm.forecast(
                    params, day_all, t_end,
                    dataclasses.replace(base, seasonality_mode=mode),
                    xreg=xreg) for mode, params in tuned.mode_params.items()]
                # each series' winning mode, gathered on the device
                sel = np.asarray(tuned.best_mode)
                pick = torch.as_tensor([modes.index(m) for m in sel],
                                       device=batch.y.device)
                rows = torch.arange(pick.shape[0], device=batch.y.device)
                yhat, lo, hi = (torch.stack([o[i] for o in outs])[pick, rows]
                                for i in range(3))
                yhat, lo, hi, ok = health_fallback(
                    batch.y, batch.mask, yhat, lo, hi, horizon,
                    min_points=DEFAULT_MIN_POINTS)
            state.update(t_start=t_start, tuned=tuned, modes=modes, sel=sel,
                         result=ForecastResult(yhat=yhat, lo=lo, hi=hi, ok=ok,
                                               day_all=day_all))
            return state

        def complete(state: Dict[str, Any]) -> Dict[str, Any]:
            batch, search, cv = state["batch"], state["search"], state["cv"]
            tuned, modes, sel = state["tuned"], state["modes"], state["sel"]
            result = state["result"]
            ok = result.ok.cpu().numpy()
            fit_seconds = time.time() - state["t_start"]
            n_failed = int((~ok).sum())
            if n_failed == batch.n_series:
                raise RuntimeError("no series trained successfully")
            if n_failed:
                self.logger.warning(
                    "tuned partial model: %d series fell back", n_failed)
            eid = self.tracker.create_experiment(experiment)
            with self.tracker.start_run(
                eid, run_name="tuned_curve_fit",
                tags={"model": "prophet", "tuned": "true",
                      "partial_model": str(n_failed > 0)},
            ) as run:
                run.log_params({
                    "n_trials": search.n_trials,
                    "selection_metric": search.metric,
                    "n_series": batch.n_series,
                    "horizon": horizon,
                    **_comparability_params(batch, cv),
                })
                # over healthy series with a finite CV score (a series with
                # no observed CV eval point scores +inf)
                scores = np.asarray(tuned.best_score)[ok]
                scores = scores[np.isfinite(scores)]
                val_score = (float(np.mean(scores)) if scores.size
                             else float("nan"))
                run.log_metrics({f"val_{search.metric}": val_score,
                                 "fit_seconds": fit_seconds,
                                 "n_failed_series": float(n_failed)})
                run.log_table("trials.parquet", tuned.trials)
                series_table = batch.key_frame()
                series_table["best_mode"] = sel
                series_table["best_changepoint_prior_scale"] = tuned.best_cp_scale
                series_table["best_seasonality_prior_scale"] = tuned.best_seas_scale
                series_table["best_holidays_prior_scale"] = tuned.best_hol_scale
                series_table[f"best_{search.metric}"] = tuned.best_score
                run.log_table("series_metrics.parquet", series_table)
                BatchForecaster.from_fit(
                    batch, tuned.params, "prophet", tuned.config,
                ).save(run.artifact_path("forecaster"))
                run_id = run.run_id
            version = self.catalog.save_table(output_table,
                                              forecast_frame(batch, result))
            self.logger.info(
                "tuned fit: %d series, %d trials x %d modes x %d rounds in "
                "%.2fs -> %s v%s", batch.n_series, search.n_trials,
                len(modes), search.adaptive_rounds, fit_seconds,
                output_table, version)
            return {
                "experiment_id": eid,
                "run_id": run_id,
                "table_version": version,
                "n_series": batch.n_series,
                "n_failed": n_failed,
                "fit_seconds": fit_seconds,
                "metrics": {f"val_{search.metric}": val_score},
            }

        return prep, dispatch, complete

    # ------------------------------------------------------- pooled families
    def _pool_stages(self, model, families, source_table, output_table,
                     model_conf, cv_conf, experiment, horizon, key_cols, freq,
                     calibrate_intervals, trace_dir):
        """The stages of ``model: auto`` (each series' CV winner,
        ``engine/select``) and ``model: blend`` (the inverse-CV-error pool,
        ``engine/blend``).  ``model_conf`` may carry ``{"families": [...],
        "metric": ..., "temperature": ... (blend), "configs": {family:
        {...}}}``; each family's conf resolves as the plain path's does."""
        mc = model_conf or {}
        metric = mc.get("metric", "smape")
        temperature = float(mc.get("temperature", 1.0))

        def prep() -> Dict[str, Any]:
            cv = CVConfig(**(cv_conf or {}))
            df = self.catalog.read_table(source_table)
            batch = tensorize(df, key_cols=key_cols, freq=freq,
                              device=self.device)
            configs = {}
            for name, c in (mc.get("configs") or {}).items():
                configs[name] = _config_from_conf(
                    name, _resolve_model_conf(name, c, batch, horizon,
                                              cv_conf))
                if (c or {}).get("season_length") == "auto":
                    self.logger.info(
                        "%s season_length: auto -> detected period %d",
                        name, configs[name].season_length)
            self.logger.info(
                "%s fit: %d series x %d days over %s on %s", model,
                batch.n_series, batch.n_time, list(families), self.device)
            return {"cv": cv, "batch": batch, "configs": configs}

        def dispatch(state: Dict[str, Any]) -> Dict[str, Any]:
            t_start = time.time()
            kw = dict(models=families, configs=state["configs"],
                      metric=metric, cv=state["cv"], horizon=horizon)
            with device_trace(trace_dir):
                if model == "blend":
                    params_by_family, pool, result = fit_forecast_blend(
                        state["batch"], temperature=temperature,
                        calibrate=calibrate_intervals, **kw)
                else:
                    params_by_family, pool, result = fit_forecast_auto(
                        state["batch"], **kw)
            state.update(t_start=t_start, params_by_family=params_by_family,
                         pool=pool, result=result)
            return state

        def complete(state: Dict[str, Any]) -> Dict[str, Any]:
            # the host pull first: fit_seconds spans the device work
            ok = state["result"].ok.cpu().numpy()
            fit_seconds = time.time() - state["t_start"]
            eid = self.tracker.create_experiment(experiment)
            args = (eid, state["batch"], state["cv"], state["configs"],
                    state["params_by_family"], state["pool"], state["result"],
                    ok, fit_seconds, families, metric)
            if model == "blend":
                return self._complete_blend(*args, temperature, horizon,
                                            output_table)
            return self._complete_auto(*args, horizon, output_table)

        return prep, dispatch, complete

    def _complete_auto(self, eid, batch, cv, configs, params_by_family,
                       selection, result, ok, fit_seconds, families, metric,
                       horizon, output_table) -> Dict[str, Any]:
        with self.tracker.start_run(
            eid, run_name="auto_select_fit",
            tags={"model": "auto", "families": ",".join(families)},
        ) as run:
            run.log_params({
                "families": list(families),
                "selection_metric": metric,
                "n_series": batch.n_series,
                "horizon": horizon,
                **_comparability_params(batch, cv),
            })
            counts = selection.counts()
            valid = selection.valid
            # over the series with at least one finite CV score
            val_metric = (float(np.mean(selection.best_score[valid]))
                          if valid.any() else float("nan"))
            run.log_metrics({
                f"val_{metric}": val_metric,
                "n_invalid_series": float((~valid).sum()),
                "fit_seconds": fit_seconds,
                **{f"n_chosen_{name}": float(counts.get(name, 0))
                   for name in families},
            })
            series_table = batch.key_frame()
            series_table["chosen_model"] = selection.chosen
            series_table[f"best_{metric}"] = selection.best_score
            for name in families:
                series_table[f"{metric}_{name}"] = (
                    selection.scores[name].to_numpy())
            run.log_table("series_metrics.parquet", series_table)
            MultiModelForecaster.from_fit(
                batch, params_by_family, configs, selection
            ).save(run.artifact_path("forecaster"))
            run_id = run.run_id

        version = self.catalog.save_table(output_table,
                                          forecast_frame(batch, result))
        self.logger.info(
            "auto-select fit: %d series over %s in %.2fs (chosen: %s) -> "
            "%s v%s", batch.n_series, list(families), fit_seconds, counts,
            output_table, version)
        return {
            "experiment_id": eid,
            "run_id": run_id,
            "table_version": version,
            "n_series": batch.n_series,
            "n_failed": int((~ok).sum()),
            "fit_seconds": fit_seconds,
            "chosen_counts": counts,
            "metrics": {f"val_{metric}": val_metric},
        }

    def _complete_blend(self, eid, batch, cv, configs, params_by_family,
                        blend, result, ok, fit_seconds, families, metric,
                        temperature, horizon, output_table) -> Dict[str, Any]:
        with self.tracker.start_run(
            eid, run_name="blended_fit",
            tags={"model": "blend", "families": ",".join(families)},
        ) as run:
            run.log_params({
                "families": list(families),
                "blend_metric": metric,
                "temperature": temperature,
                "n_series": batch.n_series,
                "horizon": horizon,
                **_comparability_params(batch, cv),
            })
            valid = blend.valid
            # the pool's CV score as the weighted member scores (the pool's
            # own CV error is at most this for a convex metric): what the
            # promotion gate compares.  A row with no finite score is NaN,
            # not nansum's "perfect" 0
            score_mat = blend.scores[list(blend.models)].to_numpy(float)
            blended_score = np.where(
                valid, np.nansum(blend.weights * score_mat, axis=1), np.nan)
            val_metric = (float(np.nanmean(blended_score[valid]))
                          if valid.any() else float("nan"))
            run.log_metrics({
                f"val_{metric}": val_metric,
                "n_invalid_series": float((~valid).sum()),
                "fit_seconds": fit_seconds,
                **{f"mean_weight_{name}": w
                   for name, w in blend.mean_weights().items()},
            })
            series_table = batch.key_frame()
            series_table[f"blended_{metric}"] = blended_score
            if blend.interval_scale is not None:
                series_table["interval_scale"] = blend.interval_scale
                run.log_metrics({"interval_scale_mean": float(
                    np.nanmean(blend.interval_scale[valid])
                ) if valid.any() else float("nan")})
            for i, name in enumerate(blend.models):
                series_table[f"weight_{name}"] = blend.weights[:, i]
                series_table[f"{metric}_{name}"] = blend.scores[name].to_numpy()
            run.log_table("series_metrics.parquet", series_table)
            BlendedForecaster.from_fit(
                batch, params_by_family, configs, blend
            ).save(run.artifact_path("forecaster"))
            run_id = run.run_id

        version = self.catalog.save_table(output_table,
                                          forecast_frame(batch, result))
        mean_weights = blend.mean_weights()
        self.logger.info(
            "blended fit: %d series over %s in %.2fs (mean weights: %s) -> "
            "%s v%s", batch.n_series, list(families), fit_seconds,
            {k: round(v, 3) for k, v in mean_weights.items()}, output_table,
            version)
        return {
            "experiment_id": eid,
            "run_id": run_id,
            "table_version": version,
            "n_series": batch.n_series,
            "n_failed": int((~ok).sum()),
            "fit_seconds": fit_seconds,
            "mean_weights": mean_weights,
            "metrics": {f"val_{metric}": val_metric,
                        **{f"mean_weight_{k}": v
                           for k, v in mean_weights.items()}},
        }

    # ------------------------------------------------------------- allocated
    def allocated(
        self,
        source_table: str,
        output_table: str,
        model: str = "prophet",
        model_conf: Optional[Dict[str, Any]] = None,
        experiment: str = "allocated_forecasting",
        horizon: int = 90,
        freq: str = "D",
    ) -> Dict[str, Any]:
        """Item-level fit + store-share allocation: sum sales per item
        across stores, fit one model per item (one batched fit on the
        device), compute each store's historical share ``sales / SUM(sales)
        OVER (PARTITION BY item)`` and scale the item forecasts down to
        (store, item) rows on the host.  The tracked run's artifact is the
        item-level ``BatchForecaster`` (key ``item``)."""
        _check_cadence(freq, model, model_conf)
        get_model(model)  # an unported family raises before any read
        df = self.catalog.read_table(source_table)

        item_df = df.groupby(["date", "item"], as_index=False)["sales"].sum()
        batch = tensorize(item_df, key_cols=("item",), freq=freq,
                          device=self.device)
        config = _config_from_conf(
            model, _resolve_model_conf(model, model_conf, batch, horizon))
        params, result = fit_forecast(batch, model=model, config=config,
                                      horizon=horizon)
        item_fc = forecast_frame(batch, result)  # [ds, item, y, yhat, ...]

        # store share of each item's historical sales
        totals = df.groupby(["store", "item"], as_index=False)["sales"].sum()
        item_totals = totals.groupby("item")["sales"].transform("sum")
        totals["ratio"] = totals["sales"] / item_totals
        ratios = totals[["store", "item", "ratio"]]

        merged = item_fc.merge(ratios, on="item", how="inner")
        for col in ("y", "yhat", "yhat_upper", "yhat_lower"):
            merged[col] = merged[col] * merged["ratio"]
        out = merged[
            ["ds", "store", "item", "y", "yhat", "yhat_upper", "yhat_lower",
             "training_date"]
        ]

        eid = self.tracker.create_experiment(experiment)
        with self.tracker.start_run(eid,
                                    run_name=f"allocated_{model}_fit") as run:
            run.log_params({"n_items": batch.n_series, "horizon": horizon})
            forecaster = BatchForecaster.from_fit(batch, params, model, config)
            forecaster.save(run.artifact_path("forecaster"))
            run_id = run.run_id

        version = self.catalog.save_table(output_table, out)
        self.logger.info(
            "allocated forecasts: %d items -> %d (store,item) rows -> %s v%s",
            batch.n_series, len(out), output_table, version,
        )
        return {
            "experiment_id": eid,
            "run_id": run_id,
            "table_version": version,
            "n_items": batch.n_series,
        }

    def _log_per_series_runs(self, eid: str, series_table: pd.DataFrame,
                             parent: str):
        """Optional drill-down: one run per series, named
        ``run_item_{item}_store_{store}``, linking the parent run's batched
        artifact and the series' row in it, with its CV metrics.  An O(S)
        host loop: warns above ``_PER_SERIES_RUNS_WARN`` series and raises
        above ``DFTPU_PER_SERIES_RUNS_MAX`` (default 20,000)."""
        n = len(series_table)
        cap = int(os.environ.get("DFTPU_PER_SERIES_RUNS_MAX", "20000"))
        if n > cap:
            raise ValueError(
                f"per_series_runs requested for {n} series, above the "
                f"{cap}-run cap: one filesystem run-dir per series does not "
                f"scale. The parent run's series_metrics.parquet artifact "
                f"already holds every per-series metric; raise "
                f"DFTPU_PER_SERIES_RUNS_MAX to override."
            )
        if n > _PER_SERIES_RUNS_WARN:
            self.logger.warning(
                "per_series_runs: creating %d tracker run directories (an "
                "O(S) host loop) — prefer the batched run's "
                "series_metrics.parquet at this scale", n,
            )
        rows = []
        for i, row in enumerate(series_table.itertuples(index=False)):
            d = row._asdict()
            rows.append({
                "run_name": f"run_item_{d.get('item')}_store_{d.get('store')}",
                "tags": {
                    "parent_run_id": parent,
                    "artifact_run_id": parent,
                    "artifact_path": "forecaster",
                    "series_index": str(i),
                },
                "metrics": {k: float(v) for k, v in d.items()
                            if k in _METRICS and np.isfinite(v)},
            })
        self.tracker.log_runs_batch(eid, rows)
