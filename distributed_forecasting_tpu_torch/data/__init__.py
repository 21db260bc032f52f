from distributed_forecasting_tpu_torch.data.tensorize import (
    SeriesBatch,
    ordinals_to_dates,
    period_ordinals,
    tensorize,
)
from distributed_forecasting_tpu_torch.data.dataset import (
    load_sales_csv,
    synthetic_series_batch,
    synthetic_store_item_sales,
)

__all__ = [
    "SeriesBatch",
    "ordinals_to_dates",
    "period_ordinals",
    "tensorize",
    "load_sales_csv",
    "synthetic_series_batch",
    "synthetic_store_item_sales",
]
