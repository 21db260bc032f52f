"""The ``compile_cache`` conf block (port of the reference's
``engine/compile_cache.py``, its :class:`CompileCacheConfig` only).

This module holds only the block's strict parse for now: the persistent
compile cache and the AOT executable store are not ported (ROADMAP Queue 1:
P11), so ``tasks/common.Task`` parses the block, then logs it as having no
effect.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CompileCacheConfig:
    """The ``compile_cache`` conf block (parsed by tasks/common.Task)."""

    enabled: bool = False
    directory: Optional[str] = None   # None -> <default_root>/compile_cache
    max_size_mb: int = 1024           # cap for EACH layer's directory
    eviction_policy: str = "lru"      # 'lru' | 'none'
    aot_store: bool = True            # layer 2 (explicit executable store)
    min_compile_time_s: float = 0.0   # layer-1 persistent-cache threshold

    def __post_init__(self):
        if self.eviction_policy not in ("lru", "none"):
            raise ValueError(
                f"eviction_policy must be 'lru' or 'none', got "
                f"{self.eviction_policy!r}")
        if self.max_size_mb < 1:
            raise ValueError(
                f"max_size_mb must be >= 1, got {self.max_size_mb}")
        if self.min_compile_time_s < 0:
            raise ValueError(
                f"min_compile_time_s must be >= 0, got "
                f"{self.min_compile_time_s}")

    @classmethod
    def from_conf(cls, conf: Optional[dict],
                  default_root: str = ".") -> "CompileCacheConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like max_sizemb must not silently run uncapped
            raise ValueError(
                f"unknown compile_cache conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        directory = conf.get("directory") or os.path.join(
            default_root, "compile_cache")
        return cls(
            enabled=bool(conf.get("enabled", False)),
            directory=directory,
            max_size_mb=int(conf.get("max_size_mb", 1024)),
            eviction_policy=str(conf.get("eviction_policy", "lru")),
            aot_store=bool(conf.get("aot_store", True)),
            min_compile_time_s=float(conf.get("min_compile_time_s", 0.0)),
        )
