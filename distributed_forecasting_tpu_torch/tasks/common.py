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
  * ``compile_cache:`` and ``pipeline:`` change no result (a compile cache,
    and an executor byte-identical to the serial path); they are logged as
    having no effect in the port yet (ROADMAP Queue 1: P11);
  * ``distributed:`` and ``engine.windowed`` with ``enabled: true`` change
    what runs; they raise ``NotImplementedError`` naming their item.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

from distributed_forecasting_tpu_torch.data.catalog import DatasetCatalog
from distributed_forecasting_tpu_torch.engine.autoprep import configure_autoprep
from distributed_forecasting_tpu_torch.engine.compile_cache import (
    CompileCacheConfig,
)
from distributed_forecasting_tpu_torch.engine.executor import PipelineConfig
from distributed_forecasting_tpu_torch.engine.gradfit import configure_gradfit
from distributed_forecasting_tpu_torch.engine.hyper import configure_automl
from distributed_forecasting_tpu_torch.engine.windowed import WindowedConfig
from distributed_forecasting_tpu_torch.ops.precision import (
    PrecisionConfig,
    configure_precision,
)
from distributed_forecasting_tpu_torch.tracking import FileTracker, ModelRegistry
from distributed_forecasting_tpu_torch.utils.config import parse_conf_args
from distributed_forecasting_tpu_torch.utils.device import (
    platform_device,
    resolve_device,
)
from distributed_forecasting_tpu_torch.utils.logging import get_logger

_DEFAULT_ROOT = "./dftpu_store"

# engine: blocks whose runtime is not ported -> (parser, the reference
# module, the ROADMAP item porting it)
_UNPORTED_ENGINE_BLOCKS = {
    "windowed": (WindowedConfig.from_conf, "engine/windowed.py", "P9"),
}
# engine: blocks the port installs -> their configure function
_ENGINE_INSTALLERS = {
    "autoprep": configure_autoprep,
    "gradfit": configure_gradfit,
    "automl": configure_automl,
}
_ENGINE_KEYS = frozenset(_UNPORTED_ENGINE_BLOCKS) | frozenset(
    _ENGINE_INSTALLERS)


def _apply_conf_blocks(conf: Dict[str, Any], root: str, logger) -> None:
    """Parse every top-level block strictly; install ``precision``,
    ``engine.autoprep``, ``engine.gradfit`` and ``engine.automl``, refuse
    the blocks that would change what runs, and log the result-neutral
    ones."""
    if conf.get("distributed"):
        raise NotImplementedError(
            "distributed: multi-process bring-up (parallel/*) is not ported "
            "yet (ROADMAP Queue 1: P12)")
    for block, parse, what in (
            ("compile_cache",
             lambda c: CompileCacheConfig.from_conf(c, default_root=root),
             "the compile cache (engine/compile_cache.py)"),
            ("pipeline", PipelineConfig.from_conf,
             "the pipelined executor (engine/executor.py)")):
        if conf.get(block) is not None:
            parse(conf[block])
            logger.info("%s: accepted; %s is not ported, so the block has no "
                        "effect in the port yet (ROADMAP Queue 1: P11)",
                        block, what)
    # installed before any fit in launch(), as the reference does
    if conf.get("precision") is not None:
        configure_precision(PrecisionConfig.from_conf(conf["precision"]))
    eng = conf.get("engine")
    if eng is not None:
        unknown = set(eng) - _ENGINE_KEYS
        if unknown:
            raise ValueError(
                f"unknown engine conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(_ENGINE_KEYS)}")
        for name, (parse, module, item) in _UNPORTED_ENGINE_BLOCKS.items():
            if eng.get(name) is not None and parse(eng[name]).enabled:
                raise NotImplementedError(
                    f"engine.{name}.enabled: true ({module}) is not ported "
                    f"yet (ROADMAP Queue 1: {item})")
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
        _apply_conf_blocks(conf, root, self.logger)

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
