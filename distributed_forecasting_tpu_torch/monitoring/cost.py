"""The ``monitoring.cost`` conf block (port of the reference's
``monitoring/cost.py``, its :class:`CostConfig` only).

This module holds only the block's strict parse for now: cost attribution,
the ``dftpu_cost_*`` registry and ``/debug/cost`` are not ported (ROADMAP
Queue 1: P11), so ``monitoring/quality.build_quality_runtime`` parses the
block and the serve task logs it as having no effect.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """The ``monitoring.cost`` conf block."""

    enabled: bool = True
    peak_flops: float = 0.0        # 0: no roofline placement
    peak_bytes_per_s: float = 0.0  # 0: no roofline placement
    saturation_window_s: float = 60.0

    def __post_init__(self):
        if self.saturation_window_s <= 0:
            raise ValueError(
                f"saturation_window_s must be > 0, got "
                f"{self.saturation_window_s}")
        if self.peak_flops < 0:
            raise ValueError(
                f"peak_flops must be >= 0, got {self.peak_flops}")
        if self.peak_bytes_per_s < 0:
            raise ValueError(
                f"peak_bytes_per_s must be >= 0, got "
                f"{self.peak_bytes_per_s}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "CostConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like peak_flop must not silently disable the roofline
            raise ValueError(
                f"unknown monitoring.cost conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)
