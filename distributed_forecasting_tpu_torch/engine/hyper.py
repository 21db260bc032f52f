"""The ``engine.automl`` conf block (port of the reference's
``engine/hyper.py``, its :class:`AutoMLConfig` only).

This module holds only the block's strict parse for now: hyper search and
the successive-halving sweep are not ported (ROADMAP Queue 1: P8), so
``tasks/common.Task`` parses the block and refuses ``enabled: true`` with
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AutoMLConfig:
    """The strict ``engine.automl`` conf block: the reference's cross-family
    successive-halving sweep.  Rung r evaluates the surviving families on a
    ``base_series * eta**r``-sized series subset and the last
    ``base_cutoffs * eta**r`` CV cutoffs, then keeps the best ``1/eta``
    fraction; ``budget_device_seconds`` gates new evaluations."""

    enabled: bool = False
    budget_device_seconds: float = 60.0
    eta: int = 2
    rungs: int = 3
    base_series: int = 64
    base_cutoffs: int = 1
    metric: str = "smape"
    families: tuple = ("prophet", "holt_winters", "theta", "croston",
                       "arima", "arnet")

    def __post_init__(self):
        if self.eta < 2:
            raise ValueError(f"eta must be >= 2, got {self.eta}")
        if self.rungs < 1:
            raise ValueError(f"rungs must be >= 1, got {self.rungs}")
        if self.budget_device_seconds <= 0:
            raise ValueError(
                f"budget_device_seconds must be > 0, got "
                f"{self.budget_device_seconds}")
        if self.base_series < 1:
            raise ValueError(
                f"base_series must be >= 1, got {self.base_series}")
        if self.base_cutoffs < 1:
            raise ValueError(
                f"base_cutoffs must be >= 1, got {self.base_cutoffs}")
        if not self.families:
            raise ValueError("families must name at least one family")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "AutoMLConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            raise ValueError(
                f"unknown engine.automl conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)
