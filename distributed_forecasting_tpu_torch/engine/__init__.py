from distributed_forecasting_tpu_torch.engine.autoprep import (
    AutoprepConfig,
    PrepReport,
    PrepResult,
    autoprep_batch,
    autoprep_config,
    configure_autoprep,
)
from distributed_forecasting_tpu_torch.engine.blend import (
    BlendResult,
    blend_weights,
    fit_forecast_blend,
)
from distributed_forecasting_tpu_torch.engine.calibrate import (
    apply_interval_scale,
    conformal_interval_scale,
)
from distributed_forecasting_tpu_torch.engine.compile_cache import (
    AOTStore,
    CompileCacheConfig,
    aot_call,
    cache_stats,
    configure_compile_cache,
)
from distributed_forecasting_tpu_torch.engine.cv import (
    CVConfig,
    cross_validate,
    cv_forecast_frame,
)
from distributed_forecasting_tpu_torch.engine.executor import (
    ExperimentHandle,
    PipelineConfig,
    TrainingExecutor,
    configure_pipeline,
    device_pull,
    pipeline_config,
    prefetch_to_device,
    sanctioned_pull,
)
from distributed_forecasting_tpu_torch.engine.fit import (
    ForecastResult,
    fit_forecast,
    fit_forecast_bucketed,
    fit_forecast_chunked,
    forecast_frame,
    seasonal_naive,
)
from distributed_forecasting_tpu_torch.engine.hyper import (
    AutoMLConfig,
    HyperSearchConfig,
    TuneResult,
    automl_config,
    configure_automl,
    tune_curve_model,
)
from distributed_forecasting_tpu_torch.engine.order import select_arima_order
from distributed_forecasting_tpu_torch.engine.season import (
    detect_season_length,
)
from distributed_forecasting_tpu_torch.engine.select import (
    AutoMLResult,
    SelectionResult,
    fit_forecast_auto,
    select_model,
    successive_halving_select,
)
from distributed_forecasting_tpu_torch.engine.windowed import (
    WindowedConfig,
    WindowedSeriesStateStore,
    configure_windowed,
    plan_windows,
    should_window,
    windowed_config,
    windowed_fit_forecast,
)

__all__ = ["AutoprepConfig", "PrepReport", "PrepResult", "autoprep_batch",
           "autoprep_config", "configure_autoprep", "CVConfig", "cross_validate", "cv_forecast_frame",
           "ForecastResult", "fit_forecast", "fit_forecast_auto",
           "fit_forecast_blend", "fit_forecast_bucketed",
           "fit_forecast_chunked", "forecast_frame", "select_model",
           "SelectionResult", "AutoMLResult", "successive_halving_select",
           "HyperSearchConfig", "TuneResult", "tune_curve_model",
           "AutoMLConfig", "configure_automl", "automl_config",
           "seasonal_naive", "apply_interval_scale",
           "conformal_interval_scale", "detect_season_length",
           "select_arima_order", "BlendResult", "blend_weights",
           "ExperimentHandle", "PipelineConfig", "TrainingExecutor",
           "device_pull", "configure_pipeline", "pipeline_config",
           "prefetch_to_device", "sanctioned_pull", "AOTStore",
           "CompileCacheConfig", "aot_call", "cache_stats",
           "configure_compile_cache", "WindowedConfig",
           "WindowedSeriesStateStore", "configure_windowed", "plan_windows",
           "should_window", "windowed_config", "windowed_fit_forecast"]
