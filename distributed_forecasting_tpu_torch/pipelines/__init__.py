from distributed_forecasting_tpu_torch.pipelines.catalog import CatalogPipeline
from distributed_forecasting_tpu_torch.pipelines.training import (
    TrainingPipeline,
)

__all__ = ["CatalogPipeline", "TrainingPipeline"]
