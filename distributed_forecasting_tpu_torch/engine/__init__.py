from distributed_forecasting_tpu_torch.engine.autoprep import (
    AutoprepConfig,
    PrepReport,
    PrepResult,
    autoprep_batch,
    autoprep_config,
    configure_autoprep,
)
from distributed_forecasting_tpu_torch.engine.blend import fit_forecast_blend
from distributed_forecasting_tpu_torch.engine.cv import (
    CVConfig,
    cross_validate,
    cv_forecast_frame,
)
from distributed_forecasting_tpu_torch.engine.fit import (
    ForecastResult,
    fit_forecast,
    fit_forecast_bucketed,
    fit_forecast_chunked,
    forecast_frame,
)
from distributed_forecasting_tpu_torch.engine.hyper import (
    AutoMLConfig,
    HyperSearchConfig,
    TuneResult,
    automl_config,
    configure_automl,
    tune_curve_model,
)
from distributed_forecasting_tpu_torch.engine.select import (
    AutoMLResult,
    SelectionResult,
    fit_forecast_auto,
    select_model,
    successive_halving_select,
)

__all__ = ["AutoprepConfig", "PrepReport", "PrepResult", "autoprep_batch",
           "autoprep_config", "configure_autoprep", "CVConfig", "cross_validate", "cv_forecast_frame",
           "ForecastResult", "fit_forecast", "fit_forecast_auto",
           "fit_forecast_blend", "fit_forecast_bucketed",
           "fit_forecast_chunked", "forecast_frame", "select_model",
           "SelectionResult", "AutoMLResult", "successive_halving_select",
           "HyperSearchConfig", "TuneResult", "tune_curve_model",
           "AutoMLConfig", "configure_automl", "automl_config"]
