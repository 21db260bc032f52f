"""Task ABC — the job harness (port of the reference's ``tasks/common.py``).

Conf comes from ``--conf-file`` YAML (unknown arguments pass through) or an
injected dict; the infrastructure handles — dataset catalog, tracker,
registry — are built lazily from the conf's ``env:`` section:

    env:
      root: ./dftpu_store               # default root of the three below
      warehouse: /path/to/warehouse     # DatasetCatalog root
      tracking:  /path/to/mlruns        # FileTracker root
      registry:  /path/to/registry      # ModelRegistry root

A task runs on ``device``: ``cuda`` unless the caller asks for the CPU,
with ``device="cpu"`` or, from the command line, the reference's own switch
``DFTPU_PLATFORM=cpu``.  It passes the device to the training pipeline and
to every forecaster it loads.

The reference's other top-level conf blocks, each parsed as strictly as
the reference parses it (an unknown key or a bad value raises
``ValueError``):
  * ``engine.autoprep`` installs the process-wide autoprep config
    (``engine/autoprep.configure_autoprep``) that the training pipeline and
    the fit entry points read;
  * ``engine.gradfit`` installs the process-wide gradfit config
    (``engine/gradfit.configure_gradfit``): armed, an arnet fit trains on
    the engine path;
  * ``engine.automl`` installs the process-wide sweep config
    (``engine/hyper.configure_automl``), which
    ``engine/select.successive_halving_select`` reads; as in the reference,
    the train task itself does not call the sweep;
  * ``precision:`` installs the process-wide precision policy
    (``ops/precision.configure_precision``) before any fit:
    ``bf16_scoring: true`` scores the HW grid in bf16 on the scan and pscan
    routes;
  * ``compile_cache:`` installs the kernel library's store
    (``engine/compile_cache.configure_compile_cache``; a store configured
    after the library loaded in this process is logged and counted, and
    serves the next process);
  * ``pipeline:`` installs the process-wide executor config
    (``engine/executor.configure_pipeline``) the training pipeline runs its
    stages under;
  * ``engine.windowed`` installs the process-wide windowed config
    (``engine/windowed.configure_windowed``): armed, an arima fit whose
    history reaches its threshold runs over windows;
  * ``distributed:`` brings this process into a ``torch.distributed``
    group (``parallel/mesh.initialize_distributed``) from the reference's
    three keys, before the task body::

        distributed:
          num_processes: 4
          coordinator_address: host0:1234
          process_id: 0            # usually injected per host

    A single-process block (``num_processes`` absent, 0 or 1) is a no-op,
    and a second task in the process with the same block joins nothing
    again.  The rank runs on the task's device: a card of its own when
    each rank on the host has one (NCCL), else gloo.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

from distributed_forecasting_tpu_torch.data.catalog import DatasetCatalog
from distributed_forecasting_tpu_torch.engine.autoprep import configure_autoprep
from distributed_forecasting_tpu_torch.engine.compile_cache import (
    CompileCacheConfig,
    configure_compile_cache,
)
from distributed_forecasting_tpu_torch.engine.executor import (
    PipelineConfig,
    configure_pipeline,
)
from distributed_forecasting_tpu_torch.engine.gradfit import configure_gradfit
from distributed_forecasting_tpu_torch.engine.hyper import configure_automl
from distributed_forecasting_tpu_torch.engine.windowed import (
    configure_windowed,
)
from distributed_forecasting_tpu_torch.ops.precision import (
    PrecisionConfig,
    configure_precision,
)
from distributed_forecasting_tpu_torch.parallel.mesh import (
    initialize_distributed,
)
from distributed_forecasting_tpu_torch.tracking import FileTracker, ModelRegistry
from distributed_forecasting_tpu_torch.utils.config import parse_conf_args
from distributed_forecasting_tpu_torch.utils.device import (
    platform_device,
    resolve_device,
)
from distributed_forecasting_tpu_torch.utils.logging import get_logger
from distributed_forecasting_tpu_torch.utils.platform import (
    apply_platform_override,
)

_DEFAULT_ROOT = "./dftpu_store"

# engine: blocks the port installs -> their configure function
_ENGINE_INSTALLERS = {
    "windowed": configure_windowed,
    "autoprep": configure_autoprep,
    "gradfit": configure_gradfit,
    "automl": configure_automl,
}


def _apply_conf_blocks(conf: Dict[str, Any], root: str, logger,
                       device) -> None:
    """Parse every top-level block strictly; bring up ``distributed``, and
    install ``compile_cache``, ``pipeline``, ``precision`` and the
    ``engine`` blocks."""
    dist = conf.get("distributed")
    if dist:
        initialize_distributed(
            coordinator_address=dist.get("coordinator_address"),
            num_processes=dist.get("num_processes"),
            process_id=dist.get("process_id"),
            device=device,
        )
    # installed before the task body, so its first kernel launch loads the
    # library through the store
    if conf.get("compile_cache") is not None:
        configure_compile_cache(
            CompileCacheConfig.from_conf(conf["compile_cache"],
                                         default_root=root))
    if conf.get("pipeline") is not None:
        configure_pipeline(PipelineConfig.from_conf(conf["pipeline"]))
    # installed before any fit in launch(), as the reference does
    if conf.get("precision") is not None:
        configure_precision(PrecisionConfig.from_conf(conf["precision"]))
    eng = conf.get("engine")
    if eng is not None:
        unknown = set(eng) - set(_ENGINE_INSTALLERS)
        if unknown:
            raise ValueError(
                f"unknown engine conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(_ENGINE_INSTALLERS)}")
        for name, install in _ENGINE_INSTALLERS.items():
            if eng.get(name) is not None:
                install(eng[name])


class Task(ABC):
    def __init__(
        self,
        init_conf: Optional[Dict[str, Any]] = None,
        catalog: Optional[DatasetCatalog] = None,
        tracker: Optional[FileTracker] = None,
        registry: Optional[ModelRegistry] = None,
        device=None,
    ):
        self.logger = get_logger(self.__class__.__name__)
        plat = apply_platform_override()
        if plat:
            self.logger.info("platform override: %s (DFTPU_PLATFORM)", plat)
        self.device = resolve_device(platform_device(device))
        if init_conf is not None:
            self.conf = init_conf
        else:
            self.conf = parse_conf_args()
        self._log_conf()
        conf = self.conf if isinstance(self.conf, dict) else {}
        env = conf.get("env", {})
        root = env.get("root", _DEFAULT_ROOT)
        self._catalog = catalog
        self._tracker = tracker
        self._registry = registry
        self._paths = {
            "warehouse": env.get("warehouse", os.path.join(root, "warehouse")),
            "tracking": env.get("tracking", os.path.join(root, "mlruns")),
            "registry": env.get("registry", os.path.join(root, "registry")),
        }
        _apply_conf_blocks(conf, root, self.logger, self.device)

    # lazy infra handles ----------------------------------------------------
    @property
    def catalog(self) -> DatasetCatalog:
        if self._catalog is None:
            self._catalog = DatasetCatalog(self._paths["warehouse"])
        return self._catalog

    @property
    def tracker(self) -> FileTracker:
        if self._tracker is None:
            self._tracker = FileTracker(self._paths["tracking"])
        return self._tracker

    @property
    def registry(self) -> ModelRegistry:
        if self._registry is None:
            self._registry = ModelRegistry(self._paths["registry"])
        return self._registry

    def _log_conf(self) -> None:
        self.logger.info("Launching task on %s with configuration:",
                         self.device)
        for key, item in (self.conf or {}).items():
            self.logger.info("\t%s: %s", key, item)

    @abstractmethod
    def launch(self) -> Any:
        """Run the task's business logic."""
