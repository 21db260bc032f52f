from distributed_forecasting_tpu_torch.serving.bucketed import (
    BucketedForecaster,
)
from distributed_forecasting_tpu_torch.serving.ensemble import (
    BlendedForecaster,
    MultiModelForecaster,
)
from distributed_forecasting_tpu_torch.serving.loader import (
    load_forecaster,
    resolve_from_registry,
)
from distributed_forecasting_tpu_torch.serving.predictor import (
    BatchForecaster,
    UnknownSeriesError,
)

__all__ = ["BatchForecaster", "BlendedForecaster", "BucketedForecaster",
           "MultiModelForecaster",
           "UnknownSeriesError", "load_forecaster", "resolve_from_registry"]
