from distributed_forecasting_tpu_torch.tracking.filestore import FileTracker, Run
from distributed_forecasting_tpu_torch.tracking.registry import ModelRegistry, ModelVersion

__all__ = ["FileTracker", "Run", "ModelRegistry", "ModelVersion"]
