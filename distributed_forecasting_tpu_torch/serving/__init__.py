from distributed_forecasting_tpu_torch.serving.batcher import (
    BatchingConfig,
    QueueFullError,
    RequestBatcher,
    ServingMetrics,
    ShuttingDownError,
)
from distributed_forecasting_tpu_torch.serving.bucketed import (
    BucketedForecaster,
)
from distributed_forecasting_tpu_torch.serving.dataplane import (
    ConnectionPool,
    HttpConfig,
    PooledHTTPServer,
)
from distributed_forecasting_tpu_torch.serving.ensemble import (
    BlendedForecaster,
    MultiModelForecaster,
)
from distributed_forecasting_tpu_torch.serving.fleet import (
    FleetConfig,
    FleetSupervisor,
    FrontDoorServer,
    aggregate_prometheus,
    start_fleet,
)
from distributed_forecasting_tpu_torch.serving.forecast_cache import (
    CacheConfig,
    ForecastCache,
    build_forecast_cache,
)
from distributed_forecasting_tpu_torch.serving.loader import (
    load_forecaster,
    resolve_from_registry,
)
from distributed_forecasting_tpu_torch.serving.predictor import (
    BatchForecaster,
    UnknownSeriesError,
)
from distributed_forecasting_tpu_torch.serving.server import (
    ForecastServer,
    serve,
    start_server,
)

__all__ = ["BatchForecaster", "BatchingConfig", "BlendedForecaster",
           "CacheConfig", "ConnectionPool", "FleetConfig", "FleetSupervisor",
           "ForecastCache", "FrontDoorServer", "aggregate_prometheus",
           "build_forecast_cache", "start_fleet",
           "BucketedForecaster", "ForecastServer", "HttpConfig",
           "MultiModelForecaster", "PooledHTTPServer", "QueueFullError",
           "RequestBatcher", "ServingMetrics", "ShuttingDownError",
           "UnknownSeriesError", "load_forecaster", "resolve_from_registry",
           "serve", "start_server"]
