from distributed_forecasting_tpu_torch.utils.config import (
    load_conf,
    parse_conf_args,
)
from distributed_forecasting_tpu_torch.utils.logging import get_logger
from distributed_forecasting_tpu_torch.utils.platform import (
    apply_platform_override,
)

__all__ = ["apply_platform_override", "get_logger", "load_conf",
           "parse_conf_args"]
