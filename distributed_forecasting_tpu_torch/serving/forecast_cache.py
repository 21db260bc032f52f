"""The ``serving.cache`` conf block (port of the reference's
``serving/forecast_cache.py``: :class:`CacheConfig` and the quantile
canonicalization it shares with the scorer).

This module holds only these for now: the materialized forecast cache is
not ported (ROADMAP Queue 1: P12), so ``tasks/serve.ServeTask`` parses the
block and refuses ``enabled: true`` with ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def canonical_quantiles(quantiles) -> Tuple[float, ...]:
    """The scorer's quantile canonicalization (sort, dedupe, round to 3
    decimals): one function, so a cache signature cannot drift from what
    the server dispatches."""
    return tuple(sorted({round(float(q), 3) for q in quantiles}))


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """The ``serving.cache`` conf block (tasks/serve.py)."""

    enabled: bool = False
    max_horizons: int = 4          # distinct horizons admitted per process
    quantile_sets: tuple = ()      # canonical quantile tuples served cached
    mmap_dir: Optional[str] = None  # persistence directory (None = memory)
    max_bytes: int = 256 * 1024 * 1024

    def __post_init__(self):
        if self.max_horizons < 1:
            raise ValueError(
                f"max_horizons must be >= 1, got {self.max_horizons}")
        if self.max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {self.max_bytes}")
        for qs in self.quantile_sets:
            if not qs or not all(0.0 < q < 1.0 for q in qs):
                raise ValueError(
                    f"quantile_sets entries must be non-empty levels in "
                    f"(0, 1), got {qs!r}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "CacheConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like max_horizon must not silently serve uncached
            raise ValueError(
                f"unknown serving.cache conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        qsets = conf.get("quantile_sets") or ()
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}

        def pick(key):
            # explicit 0 must reach validation, not fall back to a default
            value = conf.get(key)
            return defaults[key] if value is None else value

        return cls(
            enabled=bool(conf.get("enabled", False)),
            max_horizons=int(pick("max_horizons")),
            quantile_sets=tuple(canonical_quantiles(qs) for qs in qsets),
            mmap_dir=conf.get("mmap_dir"),
            max_bytes=int(pick("max_bytes")),
        )
