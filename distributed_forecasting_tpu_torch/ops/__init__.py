from distributed_forecasting_tpu_torch.ops import features, metrics, solve

__all__ = ["features", "metrics", "solve"]
