"""The ``engine.windowed`` conf block (port of the reference's
``engine/windowed.py``, its :class:`WindowedConfig` only).

This module holds only the block's strict parse for now: window-parallel
arima fitting is not ported (ROADMAP Queue 1: P9), so ``tasks/common.Task``
parses the block and refuses ``enabled: true`` with
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class WindowedConfig:
    """The ``engine.windowed`` conf block.

    ``enabled`` arms the reference's auto-activation in
    ``engine.fit_forecast``: an arima fit whose history reaches
    ``window_len * min_windows`` periods runs over overlapping windows.
    """

    enabled: bool = False
    window_len: int = 8192
    overlap: int = 256
    min_windows: int = 4

    def __post_init__(self):
        if self.window_len < 128:
            # the HR long-AR needs K=max(hr_ar_order, p+q+m) leading rows
            # per window just for lag features; below ~128 the per-window
            # regression is noise
            raise ValueError(
                f"window_len must be >= 128, got {self.window_len}")
        if not 0 <= self.overlap < self.window_len:
            raise ValueError(
                f"overlap must be in [0, window_len), got {self.overlap} "
                f"with window_len={self.window_len}")
        if self.min_windows < 2:
            raise ValueError(
                f"min_windows must be >= 2 (one window is just the "
                f"sequential fit), got {self.min_windows}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "WindowedConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like windw_len must not silently fall back to defaults
            raise ValueError(
                f"unknown engine.windowed conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)
