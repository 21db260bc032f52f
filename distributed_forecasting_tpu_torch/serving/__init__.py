from distributed_forecasting_tpu_torch.serving.predictor import (
    BatchForecaster,
    UnknownSeriesError,
)

__all__ = ["BatchForecaster", "UnknownSeriesError"]
