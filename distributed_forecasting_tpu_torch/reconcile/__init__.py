from distributed_forecasting_tpu_torch.reconcile.hierarchy import (
    Hierarchy,
    aggregate_bottom_up,
    coherency_error,
    reconcile_forecasts,
    reconciliation_report,
    top_down_allocate,
)

__all__ = ["Hierarchy", "aggregate_bottom_up", "coherency_error",
           "reconcile_forecasts", "reconciliation_report", "top_down_allocate"]
