"""The ``serving.ingest`` conf block (port of the reference's
``serving/ingest.py``, its :class:`IngestConfig` only).

This module holds only the block's strict parse for now: streaming ingest
(the write-ahead log, ``POST /ingest``, the state store and refits) is not
ported (ROADMAP Queue 1: P9), so ``tasks/serve.ServeTask`` parses the block
and refuses ``enabled: true`` with ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """The ``serving.ingest`` conf block (see conf/tasks/serve_config.yml)."""

    enabled: bool = False
    wal_dir: str = ""                 # "" -> caller supplies a default root
    max_segment_bytes: int = 4194304
    apply_mode: str = "sync"          # "sync": apply inline with POST /ingest
                                      # "interval": background follower poll
    apply_interval_ms: float = 200.0
    time_bucket: int = 32             # fitted/predict-grid growth increment
    observe_feeds_ingest: bool = False  # POST /observe actuals also ingest
    max_points_per_request: int = 10000
    max_pending_days: int = 366       # reject days past frontier + this:
                                      # the apply densifies that many
                                      # columns, so one typo'd far-future
                                      # ordinal must not exhaust memory
    refit: dict = dataclasses.field(default_factory=dict)  # serving/refit.py

    def __post_init__(self):
        if self.apply_mode not in ("sync", "interval"):
            raise ValueError(
                f"apply_mode must be 'sync' or 'interval', "
                f"got {self.apply_mode!r}")
        if self.apply_interval_ms <= 0:
            raise ValueError("apply_interval_ms must be > 0")
        if self.time_bucket < 1:
            raise ValueError("time_bucket must be >= 1")
        if self.max_segment_bytes < 1024:
            raise ValueError("max_segment_bytes must be >= 1024")
        if self.max_points_per_request < 1:
            raise ValueError("max_points_per_request must be >= 1")
        if self.max_pending_days < 1:
            raise ValueError("max_pending_days must be >= 1")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "IngestConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like aply_mode must not silently fall back to sync
            raise ValueError(
                f"unknown serving.ingest conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in conf or conf[f.name] is None:
                continue
            if f.name == "refit":
                kwargs[f.name] = dict(conf[f.name])
            else:
                kwargs[f.name] = type(f.default)(conf[f.name])
        return cls(**kwargs)
