"""The ``pipeline`` conf block (port of the reference's
``engine/executor.py``, its :class:`PipelineConfig` only).

This module holds only the block's strict parse for now: the pipelined
training executor is not ported (ROADMAP Queue 1: P11), so
``tasks/common.Task`` parses the block, then logs it as having no effect.
The executor's contract makes its output byte-identical to the serial path
the port runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Conf-wired knobs for the pipelined training executor, built from the
    ``pipeline:`` conf block by the Task base."""

    enabled: bool = True
    max_in_flight: int = 2
    prefetch_depth: int = 1
    async_tracking: bool = True

    def __post_init__(self):
        if self.max_in_flight < 1:
            raise ValueError(
                f"pipeline.max_in_flight must be >= 1, got {self.max_in_flight}")
        if self.prefetch_depth < 0:
            raise ValueError(
                f"pipeline.prefetch_depth must be >= 0, got {self.prefetch_depth}")

    @classmethod
    def from_conf(cls, conf: Optional[Dict[str, Any]]) -> "PipelineConfig":
        if conf is None:
            return cls()
        if not isinstance(conf, dict):
            raise ValueError(f"pipeline conf must be a mapping, got {type(conf)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            raise ValueError(
                f"unknown pipeline conf keys: {sorted(unknown)} "
                f"(known: {sorted(known)})")
        return cls(
            enabled=bool(conf.get("enabled", True)),
            max_in_flight=int(conf.get("max_in_flight", 2)),
            prefetch_depth=int(conf.get("prefetch_depth", 1)),
            async_tracking=bool(conf.get("async_tracking", True)),
        )
