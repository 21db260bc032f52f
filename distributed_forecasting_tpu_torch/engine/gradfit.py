"""The ``engine.gradfit`` conf block (port of the reference's
``engine/gradfit.py``, its :class:`GradFitConfig` only).

This module holds only the block's strict parse for now: the arnet family
and its batched-gradient trainer are not ported (ROADMAP Queue 1: P8), so
``tasks/common.Task`` parses the block and refuses ``enabled: true`` with
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GradFitConfig:
    """The strict ``engine.gradfit`` conf block (tasks/common.py)."""

    enabled: bool = False
    #: series rows are padded up to ``series_bucket * 2^k`` so the step
    #: executable is shared per (series-bucket, lag-window, xreg-count)
    series_bucket: int = 64
    #: minibatch lookahead for the epoch loop (0 = no overlap)
    prefetch_depth: int = 2
    #: donate params + optimizer state into each step
    donate: bool = True

    def __post_init__(self):
        if self.series_bucket < 1:
            raise ValueError(
                f"series_bucket must be >= 1, got {self.series_bucket}")
        if self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0, got {self.prefetch_depth}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "GradFitConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like series_bucet must not silently fall back
            raise ValueError(
                f"unknown engine.gradfit conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)
