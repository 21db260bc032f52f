from distributed_forecasting_tpu_torch.tracking.filestore import FileTracker, Run
from distributed_forecasting_tpu_torch.tracking.registry import ModelRegistry, ModelVersion
from distributed_forecasting_tpu_torch.tracking.mlflow_compat import (
    get_registry,
    get_tracker,
    mlflow_available,
)

__all__ = [
    "FileTracker",
    "Run",
    "ModelRegistry",
    "ModelVersion",
    "get_registry",
    "get_tracker",
    "mlflow_available",
]
