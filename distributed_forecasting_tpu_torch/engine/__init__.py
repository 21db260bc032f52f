from distributed_forecasting_tpu_torch.engine.cv import CVConfig, cross_validate
from distributed_forecasting_tpu_torch.engine.fit import (
    ForecastResult,
    fit_forecast,
    forecast_frame,
)

__all__ = ["CVConfig", "cross_validate", "ForecastResult", "fit_forecast",
           "forecast_frame"]
