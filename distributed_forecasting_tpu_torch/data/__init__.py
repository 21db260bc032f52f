from distributed_forecasting_tpu_torch.data.tensorize import (
    SeriesBatch,
    bucket_by_span,
    ordinals_to_dates,
    period_ordinals,
    regressors_for_grid,
    resolved_backend,
    tensorize,
    tensorize_regressors,
)
from distributed_forecasting_tpu_torch.data.catalog import (
    DatasetCatalog,
    TableNotFoundError,
)
from distributed_forecasting_tpu_torch.data.dataset import (
    load_sales_csv,
    load_sales_parquet,
    synthetic_series_batch,
    synthetic_store_item_sales,
)

__all__ = [
    "DatasetCatalog",
    "TableNotFoundError",
    "SeriesBatch",
    "bucket_by_span",
    "ordinals_to_dates",
    "period_ordinals",
    "regressors_for_grid",
    "resolved_backend",
    "tensorize",
    "tensorize_regressors",
    "load_sales_csv",
    "load_sales_parquet",
    "synthetic_series_batch",
    "synthetic_store_item_sales",
]
