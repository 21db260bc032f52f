from distributed_forecasting_tpu_torch.models.base import (
    MODEL_REGISTRY,
    get_model,
    register_model,
)
from distributed_forecasting_tpu_torch.models import arima  # noqa: F401 (registration)
from distributed_forecasting_tpu_torch.models import arnet  # noqa: F401 (registration)
from distributed_forecasting_tpu_torch.models import croston  # noqa: F401 (registration)
from distributed_forecasting_tpu_torch.models import holt_winters  # noqa: F401 (registration)
from distributed_forecasting_tpu_torch.models import prophet_glm  # noqa: F401 (registration)
from distributed_forecasting_tpu_torch.models import theta  # noqa: F401 (registration)
from distributed_forecasting_tpu_torch.models.arima import ArimaConfig
from distributed_forecasting_tpu_torch.models.arnet import ArnetConfig
from distributed_forecasting_tpu_torch.models.croston import CrostonConfig
from distributed_forecasting_tpu_torch.models.holt_winters import HoltWintersConfig
from distributed_forecasting_tpu_torch.models.prophet_glm import CurveModelConfig
from distributed_forecasting_tpu_torch.models.theta import ThetaConfig

__all__ = ["MODEL_REGISTRY", "get_model", "register_model", "ArimaConfig",
           "ArnetConfig", "CrostonConfig",
           "HoltWintersConfig", "CurveModelConfig", "ThetaConfig"]
