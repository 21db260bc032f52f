from distributed_forecasting_tpu_torch.utils.config import (
    load_conf,
    parse_conf_args,
)
from distributed_forecasting_tpu_torch.utils.logging import get_logger

__all__ = ["get_logger", "load_conf", "parse_conf_args"]
