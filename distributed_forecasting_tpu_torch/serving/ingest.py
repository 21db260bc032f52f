"""Streaming ingest: WAL-backed always-fresh forecasts (port of the
reference's ``serving/ingest.py``).

New rows flow into the served model between full refits:

    POST /ingest --> WriteAheadLog (append-only JSONL segments)
                          | follower read (torn-line tolerant)
                          v
                 SeriesStateStore.ingest --> apply_pending
                          |                   (one batched update of
                          v                    every dirty series)
                 BatchForecaster.swap_state --> /invocations is fresh

The WAL is the source of truth and the only route into model state:
``submit`` appends and then (sync mode) polls the log like any other
follower, so a single replica and replicas sharing ``wal_dir`` run the
same code path.  Segment naming, ``O_APPEND`` whole-line appends and the
torn-line-tolerant follower read are the ``monitoring/store`` machinery.
A record is ``{"k": [<key values>], "d": <day ordinal>, "y": <value>}``,
serialized as the reference serializes it, so both packages write the
same bytes and either can follow the other's directory.

Locks: the append lock covers the segment-cursor bookkeeping only — the
``os.write`` happens outside it, so an ingest burst never queues behind
the disk.  Followers are serialized by a capacity-1 semaphore, because a
poll spans file reads and a device update.

The append runs under an ``ingest.append`` span (``points``,
``wal_dir``); :meth:`IngestRuntime.snapshot` is the ``/debug/ingest``
body.

Not here yet: the reference's failpoints (``wal.roll``,
``wal.append.enospc``) and the dftsan attach (ROADMAP Queue 1: P12), the
sharded replicas' WAL facade (P12).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from distributed_forecasting_tpu_torch.data.tensorize import period_ordinals
from distributed_forecasting_tpu_torch.engine.state_store import (
    SeriesStateStore,
)
from distributed_forecasting_tpu_torch.monitoring.monitor import IngestMetrics
from distributed_forecasting_tpu_torch.monitoring.store import (
    read_segments_from,
    segment_indices,
    segment_path,
)
from distributed_forecasting_tpu_torch.monitoring.trace import get_tracer
from distributed_forecasting_tpu_torch.serving.refit import (
    RefitConfig,
    RefitScheduler,
)
from distributed_forecasting_tpu_torch.utils.logging import get_logger

# How long stop() waits for the WAL follower before declaring the drain
# stuck (module-level so tests can shrink it without a 10s wall stall).
_JOIN_TIMEOUT_S = 10.0


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


class WriteAheadLog:
    """Append-only JSONL record log over numbered segments.

    Same on-disk format and discipline as the quality store's segments —
    one atomic ``O_APPEND`` write per batch, whole lines only, roll to a
    new segment past ``max_segment_bytes`` — but holding ingest RECORDS,
    and read through the follower API (:meth:`read_new`) instead of
    time-range queries.  Multiple processes may append to the same
    directory: ``O_APPEND`` keeps single-write lines atomic on POSIX, and
    the follower's rfind-newline read tolerates whatever interleaving
    lands.
    """

    def __init__(self, directory: str, max_segment_bytes: int = 4194304):
        self.directory = str(directory)
        self.max_segment_bytes = int(max_segment_bytes)
        os.makedirs(self.directory, exist_ok=True)
        idxs = segment_indices(self.directory)
        seg = idxs[-1] if idxs else 0
        seg_bytes = self._seal_torn_tail(segment_path(self.directory, seg))
        self._lock = threading.Lock()  # segment-cursor bookkeeping ONLY
        self._seg = seg
        self._seg_bytes = seg_bytes

    @staticmethod
    def _seal_torn_tail(path: str) -> int:
        """Recovery hygiene: if the live segment ends mid-line (the writer
        was SIGKILLed inside its ``os.write``), append a newline BEFORE
        this process's first append.  Without the seal, the new writer's
        first line would glue onto the torn fragment into one undecodable
        line and an acked batch would silently vanish on replay; with it,
        the fragment becomes its own skippable junk line.  Returns the
        segment's size (post-seal), the append cursor's starting point."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return 0
        if size == 0:
            return 0
        try:
            with open(path, "rb") as f:
                f.seek(size - 1)
                last = f.read(1)
            if last != b"\n":
                fd = os.open(path, os.O_WRONLY | os.O_APPEND)
                try:
                    os.write(fd, b"\n")
                finally:
                    os.close(fd)
                size += 1
        except OSError:
            pass  # read-only media etc.: appends will fail loudly anyway
        return size

    def append(self, records: List[Dict]) -> int:
        """Append record dicts as JSONL; one ``os.write``, outside the
        lock (snapshot-then-write, the TimeSeriesStore.append idiom)."""
        if not records:
            return 0
        payload = "".join(
            json.dumps(r, separators=(",", ":")) + "\n" for r in records
        ).encode()
        with self._lock:
            if self._seg_bytes >= self.max_segment_bytes:
                self._seg += 1
                self._seg_bytes = 0
            seg = self._seg
            path = segment_path(self.directory, seg)
            self._seg_bytes += len(payload)
        written = 0
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                while written < len(payload):
                    written += os.write(fd, payload[written:])
            finally:
                os.close(fd)
        except OSError:
            # ENOSPC/EIO: compensate the cursor for bytes that never hit
            # disk, so roll decisions and stats() keep tracking durable
            # bytes instead of drifting ahead of the file forever
            with self._lock:
                if self._seg == seg:
                    self._seg_bytes = max(
                        self._seg_bytes - (len(payload) - written), 0)
            raise
        return len(records)

    def read_new(self, cursor: Optional[Dict[int, int]] = None,
                 ) -> Tuple[List[Dict], Dict[int, int]]:
        """(decoded records past ``cursor``, advanced cursor).  Lines that
        fail to decode (foreign writers, disk corruption) are skipped —
        the log must stay replayable end to end."""
        lines, cursor = read_segments_from(self.directory, cursor)
        records = []
        for line in lines:
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
        return records, cursor

    def stats(self) -> Dict[str, int]:
        idxs = segment_indices(self.directory)
        total = 0
        for i in idxs:
            try:
                total += os.path.getsize(segment_path(self.directory, i))
            except OSError:
                continue
        return {"segments": len(idxs), "bytes": total}


class IngestRuntime:
    """Glue between HTTP, the WAL, and the state store.

    ``submit`` validates + appends; applying ALWAYS goes through the
    follower read (:meth:`poll_apply`) so replicas sharing the WAL and
    the appending replica itself converge through one code path.
    """

    def __init__(self, config: IngestConfig, forecaster,
                 store: SeriesStateStore, wal: WriteAheadLog,
                 metrics: Optional[IngestMetrics] = None,
                 refit_scheduler=None):
        self.config = config
        self.forecaster = forecaster
        self.store = store
        self.wal = wal
        self.metrics = metrics if metrics is not None else IngestMetrics()
        self.refit = refit_scheduler
        # optional streaming anomaly leg (serving/anomaly.AnomalyScorer),
        # late-bound by ForecastServer when serving.anomaly.stream_scoring
        # is on: validated batches score against the CURRENT bands before
        # the sync apply moves the frontier
        self.anomaly = None
        self.logger = get_logger("IngestRuntime")
        self.key_names = tuple(forecaster.key_names)
        self._key_index = {
            tuple(k): i for i, k in enumerate(forecaster.keys.tolist())
        }
        self._cursor: Dict[int, int] = {}
        # capacity-1 semaphore, not a Lock: a poll spans file reads and a
        # device dispatch, the capacity-limiter case the lock lint exempts
        self._poll_gate = threading.BoundedSemaphore(1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- record parsing ------------------------------------------------------
    def _parse_record(self, rec: Dict) -> Tuple[Optional[Tuple], str]:
        """One request item -> ((sidx, day, y), "") or (None, reason).

        Accepts ``{"keys": {...}|[...], "ds": <date>|"d": <ordinal>,
        "y": <float>}``, or the flat ``/observe`` record shape with the
        key columns inline (``{"store": 1, "item": 2, "ds": ..., "y":
        ...}``); WAL rows use the compact ``{"k": [...], "d": n, "y": v}``
        form, which parses through the same path on replay.
        """
        try:
            raw = rec.get("k", rec.get("keys"))
            if raw is None:
                raw = {n: rec[n] for n in self.key_names}
            if isinstance(raw, dict):
                key = tuple(int(raw[n]) for n in self.key_names)
            else:
                key = tuple(int(v) for v in raw)
            if len(key) != len(self.key_names):
                return None, "key_arity"
            if "d" in rec:
                day = int(rec["d"])
            else:
                day = int(period_ordinals(
                    pd.DatetimeIndex([pd.Timestamp(rec["ds"])]),
                    self.forecaster.freq)[0])
            y = float(rec["y"])
        except (KeyError, TypeError, ValueError):
            return None, "malformed"
        if not np.isfinite(y):
            return None, "malformed"
        sidx = self._key_index.get(key)
        if sidx is None:
            return None, "unknown_series"
        return (sidx, day, y), ""

    # -- write path ----------------------------------------------------------
    def submit(self, records: List[Dict]) -> Dict:
        """Validate, WAL-append, and (sync mode) apply a request batch.

        Only points whose key matches a fitted series AND whose day falls
        inside ``[day0, frontier + max_pending_days]`` reach the WAL — the
        keyset and grid are frozen at fit time and shared by every
        replica, so filtering before the append keeps the log replayable
        anywhere: a typo'd far-future ordinal (or a wrong-century ``ds``)
        must never become a durable line that every restart and every
        fleet follower re-reads into a multi-GB apply allocation.
        """
        if len(records) > self.config.max_points_per_request:
            raise ValueError(
                f"request has {len(records)} points; "
                f"max_points_per_request={self.config.max_points_per_request}")
        horizon = self.store.day_cur + self.config.max_pending_days
        day0 = self.store.day0
        rows, unknown, malformed, out_of_range = [], 0, 0, 0
        for rec in records:
            parsed, reason = self._parse_record(rec)
            if parsed is None:
                if reason == "unknown_series":
                    unknown += 1
                else:
                    malformed += 1
                continue
            sidx, day, y = parsed
            if day < day0 or day > horizon:
                out_of_range += 1
                continue
            rows.append({"k": list(self._row_key(sidx)), "d": day, "y": y})
        out = {"written": len(rows), "unknown_series": unknown,
               "malformed": malformed, "out_of_range": out_of_range}
        if rows:
            # outside _poll_gate, so appends never queue behind an apply
            with get_tracer().span("ingest.append", points=len(rows),
                                   wal_dir=self.wal.directory):
                self.wal.append(rows)
            self.metrics.points_total.inc(len(rows))
            self.metrics.wal_appends_total.inc()
        if unknown:
            self.metrics.unknown_series_total.inc(unknown)
        if out_of_range:
            self.metrics.out_of_range_total.inc(out_of_range)
        if rows and self.anomaly is not None:
            # streaming anomaly leg: score the batch against the bands as
            # they stand BEFORE this batch applies (a point must not
            # vouch for itself).  The WAL append above is already
            # durable, so a scoring failure must never fail the ingest.
            try:
                out["anomalies"] = self.anomaly.score_ingest(rows)
            except Exception:  # noqa: BLE001
                self.logger.exception("ingest anomaly scoring failed")
        if rows and self.config.apply_mode == "sync":
            out["applied"] = self.poll_apply()
        return out

    def _row_key(self, sidx: int) -> Tuple:
        return tuple(int(v) for v in self.forecaster.keys[sidx])

    # -- read/apply path (the follower) --------------------------------------
    def poll_apply(self) -> Dict:
        """Consume new WAL lines into the state store, then apply pending
        points in one batched dispatch.  Safe to call from any thread; the
        gate serializes concurrent followers, and a blocked caller re-reads
        after acquiring, so its own freshly appended lines are never missed.
        """
        with self._poll_gate:
            records, self._cursor = self.wal.read_new(self._cursor)
            counts = {"accepted": 0, "late": 0, "rejected": 0}
            if records:
                points = []
                for rec in records:
                    parsed, _ = self._parse_record(rec)
                    if parsed is not None:
                        points.append(parsed)
                routed = self.store.ingest(points)
                for k in counts:
                    counts[k] += routed[k]
                if counts["late"]:
                    self.metrics.late_points_total.inc(counts["late"])
            applied = self.store.apply_pending()
        self._publish_gauges()
        return {**counts, **applied}

    def _publish_gauges(self) -> None:
        st = self.store.stats()
        wal = self.wal.stats()
        m = self.metrics
        m.dirty_series.set(st["dirty_series"])
        m.pending_days.set(st["pending_days"])
        m.applied_day.set(st["day_cur"])
        m.refit_backlog.set(st["applied_since_refit"])
        m.wal_bytes.set(wal["bytes"])
        m.wal_segments.set(wal["segments"])

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.config.apply_mode == "interval" and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="ingest-follower", daemon=True)
            self._thread.start()
        if self.refit is not None:
            self.refit.start()

    def _run(self) -> None:
        interval = self.config.apply_interval_ms / 1000.0
        while not self._stop.wait(interval):
            try:
                self.poll_apply()
            except Exception:
                self.logger.exception("WAL follower poll failed")

    def stop(self) -> None:
        if self.refit is not None:
            self.refit.stop()
        self._stop.set()
        thread = self._thread
        if thread is not None:
            # NOT under _poll_gate: the follower takes the gate inside
            # poll_apply, so joining while holding it would deadlock
            thread.join(timeout=_JOIN_TIMEOUT_S)
            if thread.is_alive():
                # the poll is wedged (hung disk, stuck device dispatch):
                # the daemon thread leaks past this shutdown and may still
                # mutate state while teardown proceeds — say so loudly
                # instead of pretending the drain succeeded
                self.metrics.ingest_shutdown_stuck_total.inc()
                self.logger.error(
                    "WAL follower thread still alive after %.0fs join; "
                    "leaking it (daemon) — shutdown is NOT clean",
                    _JOIN_TIMEOUT_S)
            else:
                self._thread = None

    # -- exposition ----------------------------------------------------------
    def render_metrics(self) -> str:
        self._publish_gauges()
        return self.metrics.registry.render_prometheus()

    def snapshot(self) -> Dict:
        out = {"store": self.store.stats(), "wal": self.wal.stats(),
               "apply_mode": self.config.apply_mode}
        if self.refit is not None:
            out["refit"] = self.refit.snapshot()
        return out


def build_ingest_runtime(conf: Optional[dict], forecaster,
                         history_y=None, history_mask=None,
                         quality=None,
                         default_wal_dir: Optional[str] = None,
                         device=None,
                         ) -> Optional[IngestRuntime]:
    """``serving.ingest`` conf block -> a runtime ready to start (or None
    when the block is absent or disabled).  ``history_y`` /
    ``history_mask`` enable full refits; without them only the incremental
    path runs (a bare-artifact deployment).  ``device``: where the state
    lives, the card unless the caller passes ``device="cpu"``.  (The
    reference's ``wal_factory``, the sharded replicas' per-shard log, is
    ROADMAP Queue 1: P12.)"""
    config = IngestConfig.from_conf(conf)
    if not config.enabled:
        return None
    wal_dir = config.wal_dir or default_wal_dir
    if not wal_dir:
        raise ValueError(
            "serving.ingest.wal_dir is empty and no default was supplied")
    metrics = IngestMetrics()
    store = SeriesStateStore(
        forecaster, time_bucket=config.time_bucket,
        history_y=history_y, history_mask=history_mask, metrics=metrics,
        max_pending_days=config.max_pending_days, device=device)
    wal = WriteAheadLog(wal_dir, max_segment_bytes=config.max_segment_bytes)
    refit_scheduler = None
    if config.refit:
        refit_config = RefitConfig.from_conf(config.refit)
        if refit_config.enabled:
            if not store.can_refit:
                raise ValueError(
                    "serving.ingest.refit is enabled but no training "
                    "history was supplied to build_ingest_runtime")
            refit_scheduler = RefitScheduler(
                store, refit_config, quality=quality, metrics=metrics)
    return IngestRuntime(config, forecaster, store, wal, metrics=metrics,
                         refit_scheduler=refit_scheduler)
