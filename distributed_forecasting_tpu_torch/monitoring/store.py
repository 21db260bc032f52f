"""Append-only on-disk time-series store: ``/metrics`` gains history (port
of the reference's ``monitoring/store.py``; framework-free, so this is its
own copy, with the same on-disk format byte for byte: segments written by
either package are read by the other).

Every metric surface is point-in-time: a scrape of ``GET /metrics`` says
what the counters read now, and a restart loses the story.  The quality and
SLO layer needs history: burn rates are window averages, and a post-mortem
wants the coverage curve around the incident.  This module is the smallest
store that serves those reads:

  * :class:`TimeSeriesStore` — points ``(ts, name, labels, value)`` as JSON
    lines in numbered segment files.  Appends are a single
    ``os.write(O_APPEND)`` of whole lines (atomic on POSIX regular files),
    so concurrent writers never interleave mid-record, and the store's lock
    only guards in-memory segment bookkeeping: no file I/O happens under it.
  * retention + compaction — ``compact()`` rewrites SEALED segments (never
    the live append target), dropping points older than ``retention_s``,
    via write-tmp-then-``os.replace`` so a crash mid-compaction loses
    nothing.
  * :class:`ScrapeLoop` — a background thread that snapshots
    ``MetricsRegistry`` objects (their own internal locks, held only for
    the in-memory copy) and appends the flattened samples outside any lock:
    counters and gauges as they are, histograms as ``_count``/``_sum`` plus
    p50/p95/p99 from ``Histogram.snapshot_quantiles()``.

The reference's two fault-injection sites are here
(``monitoring/failpoints.py``): ``wal.read`` in :func:`read_segments_from`
and ``store.append`` in :meth:`TimeSeriesStore.append`.

Conf block ``monitoring.quality_store`` (strict — unknown keys raise)::

    monitoring:
      quality_store:
        enabled: true
        directory: null          # default <env.root>/quality_store
        retention_s: 604800      # 7 days of history
        compact_interval_s: 3600
        scrape_interval_s: 30
        max_segment_bytes: 4194304
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from distributed_forecasting_tpu_torch.monitoring.failpoints import failpoint
from distributed_forecasting_tpu_torch.utils.logging import get_logger

_SEG_RE = re.compile(r"^seg-(\d{8})\.jsonl$")


# -- segment-file machinery (module level: the reference's serving/ingest WAL
#    shares it) --

def segment_path(directory: str, index: int) -> str:
    """Path of numbered segment ``index`` under ``directory``."""
    return os.path.join(directory, f"seg-{index:08d}.jsonl")


def segment_indices(directory: str) -> List[int]:
    """Sorted indices of the on-disk ``seg-NNNNNNNN.jsonl`` files."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _SEG_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def read_segments_from(
    directory: str, cursor: Optional[Dict[int, int]] = None,
) -> Tuple[List[str], Dict[int, int]]:
    """Follower read: every COMPLETE line appended past ``cursor``.

    ``cursor`` maps segment index -> consumed byte offset; the returned
    cursor is the input advanced past every fully ``\\n``-terminated line
    read this poll.  A torn tail (a writer's ``os.write`` still in flight,
    or a crash mid-write) is left unconsumed — the next poll re-reads it
    once the newline lands — so a follower never sees a partial record.
    This is the replay half of the WAL contract (serving/ingest): appends
    are single ``O_APPEND`` writes of whole lines, reads consume whole
    lines, and the pair is torn-line tolerant end to end.
    """
    failpoint("wal.read")
    new_cursor = dict(cursor or {})
    lines: List[str] = []
    for idx in segment_indices(directory):
        path = segment_path(directory, idx)
        offset = new_cursor.get(idx, 0)
        try:
            if os.path.getsize(path) <= offset:
                continue
            with open(path, "rb") as f:
                f.seek(offset)
                chunk = f.read()
        except OSError:
            continue  # unlinked between listdir and open
        end = chunk.rfind(b"\n")
        if end < 0:
            continue  # only a torn tail so far; retry next poll
        complete = chunk[:end + 1]
        new_cursor[idx] = offset + len(complete)
        for raw in complete.split(b"\n"):
            if raw.strip():
                lines.append(raw.decode("utf-8", "replace"))
    return lines, new_cursor


@dataclasses.dataclass(frozen=True)
class QualityStoreConfig:
    """The ``monitoring.quality_store`` conf block."""

    enabled: bool = False
    directory: str = ""              # "" -> caller supplies a default root
    retention_s: float = 604800.0    # 7 days
    compact_interval_s: float = 3600.0
    scrape_interval_s: float = 30.0
    max_segment_bytes: int = 4194304

    def __post_init__(self):
        if self.retention_s <= 0:
            raise ValueError("retention_s must be > 0")
        if self.scrape_interval_s <= 0:
            raise ValueError("scrape_interval_s must be > 0")
        if self.compact_interval_s <= 0:
            raise ValueError("compact_interval_s must be > 0")
        if self.max_segment_bytes < 1024:
            raise ValueError("max_segment_bytes must be >= 1024")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "QualityStoreConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like retension_s must not silently disable retention
            raise ValueError(
                f"unknown monitoring.quality_store conf key(s) "
                f"{sorted(unknown)}; valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


class TimeSeriesStore:
    """Append-only JSONL segments with retention-driven compaction.

    Thread-safety contract: ``_lock`` guards ONLY the in-memory segment
    cursor (``_seg``, ``_seg_bytes``) and the compaction flag; every file
    operation — append, query read, compaction rewrite — runs outside it.
    Appends are safe concurrently because each is one ``os.write`` with
    ``O_APPEND``; compaction is safe concurrently with appends because it
    only touches segments strictly below the live cursor.
    """

    def __init__(self, directory: str,
                 retention_s: float = 604800.0,
                 max_segment_bytes: int = 4194304):
        if retention_s <= 0:
            raise ValueError("retention_s must be > 0")
        self.directory = directory
        self.retention_s = float(retention_s)
        self.max_segment_bytes = int(max_segment_bytes)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._compacting = False
        segs = self._segment_indices()
        self._seg = (segs[-1] if segs else 1)
        path = self._seg_path(self._seg)
        self._seg_bytes = os.path.getsize(path) if os.path.exists(path) else 0

    # -- layout (delegates to the module-level segment machinery) ------------
    def _seg_path(self, index: int) -> str:
        return segment_path(self.directory, index)

    def _segment_indices(self) -> List[int]:
        return segment_indices(self.directory)

    # -- writes --------------------------------------------------------------
    def append(self, points: List[Dict]) -> int:
        """Append ``{"ts", "name", "labels", "value"}`` dicts; returns the
        number written.  One serialized payload, one atomic ``os.write``."""
        if not points:
            return 0
        payload = "".join(
            json.dumps({
                "ts": float(p["ts"]),
                "name": str(p["name"]),
                "labels": dict(p.get("labels") or {}),
                "value": float(p["value"]),
            }, separators=(",", ":")) + "\n"
            for p in points
        ).encode()
        with self._lock:
            # cursor bookkeeping only — the write itself happens below,
            # outside the critical section (snapshot-then-write)
            if self._seg_bytes >= self.max_segment_bytes:
                self._seg += 1
                self._seg_bytes = 0
            path = self._seg_path(self._seg)
            self._seg_bytes += len(payload)
        failpoint("store.append")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, payload)
        finally:
            os.close(fd)
        return len(points)

    # -- reads ---------------------------------------------------------------
    def query(
        self,
        name: Optional[str] = None,
        since: Optional[float] = None,
        until: Optional[float] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> List[Dict]:
        """Time-ordered points matching the filters.  ``labels`` is a
        SUBSET match (every given pair must be present).  Malformed lines
        (a crash mid-``os.write`` can truncate at most the final line of a
        segment) are skipped, not raised — history must stay readable."""
        out: List[Dict] = []
        for idx in self._segment_indices():
            path = self._seg_path(idx)
            try:
                with open(path) as f:
                    text = f.read()
            except OSError:
                continue  # compaction unlinked it between listdir and open
            for line in text.splitlines():
                if not line.strip():
                    continue
                try:
                    p = json.loads(line)
                    ts = float(p["ts"])
                except (ValueError, TypeError, KeyError):
                    continue
                if name is not None and p.get("name") != name:
                    continue
                if since is not None and ts < since:
                    continue
                if until is not None and ts > until:
                    continue
                if labels:
                    have = p.get("labels") or {}
                    if any(have.get(k) != v for k, v in labels.items()):
                        continue
                out.append(p)
        out.sort(key=lambda p: p["ts"])
        return out

    def names(self) -> List[str]:
        return sorted({p["name"] for p in self.query()})

    # -- compaction ----------------------------------------------------------
    def compact(self, now: Optional[float] = None) -> int:
        """Drop points older than ``retention_s`` from SEALED segments and
        merge the survivors into the lowest sealed segment; returns points
        dropped.  The live append segment is never touched, so appends
        proceed concurrently; a second concurrent compact() is a no-op."""
        with self._lock:
            if self._compacting:
                return 0
            self._compacting = True
            live = self._seg
        try:
            if now is None:
                now = time.time()  # dflint: disable=nondeterminism — retention horizon is wall-clock by definition
            floor = now - self.retention_s
            sealed = [i for i in self._segment_indices() if i < live]
            if not sealed:
                return 0
            kept_lines: List[str] = []
            dropped = 0
            for idx in sealed:
                try:
                    with open(self._seg_path(idx)) as f:
                        text = f.read()
                except OSError:
                    continue
                for line in text.splitlines():
                    if not line.strip():
                        continue
                    try:
                        ts = float(json.loads(line)["ts"])
                    except (ValueError, TypeError, KeyError):
                        dropped += 1  # truncated tail of a crashed write
                        continue
                    if ts >= floor:
                        kept_lines.append(line)
                    else:
                        dropped += 1
            target = self._seg_path(sealed[0])
            tmp = target + ".tmp"
            with open(tmp, "w") as f:
                f.write("".join(ln + "\n" for ln in kept_lines))
            os.replace(tmp, target)  # crash-safe: old data until the rename
            for idx in sealed[1:]:
                try:
                    os.remove(self._seg_path(idx))
                except OSError:
                    pass
            if not kept_lines:
                try:
                    os.remove(target)
                except OSError:
                    pass
            return dropped
        finally:
            with self._lock:
                self._compacting = False

    def stats(self) -> Dict:
        segs = self._segment_indices()
        return {
            "directory": self.directory,
            "segments": len(segs),
            "bytes": sum(
                os.path.getsize(self._seg_path(i))
                for i in segs if os.path.exists(self._seg_path(i))
            ),
            "retention_s": self.retention_s,
        }


def flatten_registry_snapshot(
    registry, at: float, prefix_labels: Optional[Dict[str, str]] = None
) -> List[Dict]:
    """One ``MetricsRegistry`` -> flat store points, shared by the scrape
    loop and tests.  Histograms flatten to ``_count``/``_sum`` plus
    ``_p50/_p95/_p99`` (from :meth:`Histogram.snapshot_quantiles`, one
    locked snapshot per histogram); labeled families carry their label
    string parsed back into the point's labels."""
    from distributed_forecasting_tpu_torch.monitoring.monitor import (
        Histogram,
        LabeledCounter,
        LabeledGauge,
    )

    base = dict(prefix_labels or {})
    points: List[Dict] = []
    for name, _, metric in registry.items():
        if isinstance(metric, Histogram):
            snap = metric.snapshot()
            qs = metric.snapshot_quantiles((0.5, 0.95, 0.99))
            points.append({"ts": at, "name": f"{name}_count",
                           "labels": base, "value": snap["count"]})
            points.append({"ts": at, "name": f"{name}_sum",
                           "labels": base, "value": snap["sum"]})
            for q, v in qs.items():
                if v == v:  # NaN (empty histogram) has no point to store
                    points.append({
                        "ts": at, "name": f"{name}_p{int(round(q * 100))}",
                        "labels": base, "value": v})
        elif isinstance(metric, (LabeledCounter, LabeledGauge)):
            for label_str, v in metric.snapshot().items():
                labels = dict(base)
                for part in label_str.split(","):
                    k, _, val = part.partition("=")
                    labels[k] = val
                points.append({"ts": at, "name": name,
                               "labels": labels, "value": v})
        else:
            points.append({"ts": at, "name": name,
                           "labels": base, "value": metric.snapshot()})
    return points


class ScrapeLoop:
    """Background thread feeding the store from live registries.

    ``sources``: ``(labels, registry_fn)`` pairs — the callable indirection
    lets a source registry appear lazily (e.g. the serving registry, which
    exists once the server constructs).  Each tick snapshots every registry
    (their own locks, in-memory only) and THEN appends the batch to disk, so
    no metric lock is ever held across file I/O; compaction piggybacks on
    the same thread at ``compact_interval_s``.
    """

    def __init__(
        self,
        store: TimeSeriesStore,
        sources: List[Tuple[Dict[str, str], Callable[[], object]]],
        scrape_interval_s: float = 30.0,
        compact_interval_s: float = 3600.0,
    ):
        self._store = store
        self._sources = list(sources)
        self._interval = float(scrape_interval_s)
        self._compact_interval = float(compact_interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_compact = 0.0
        self.logger = get_logger("ScrapeLoop")

    def add_source(self, labels: Dict[str, str],
                   registry_fn: Callable[[], object]) -> None:
        """Register a late-appearing registry (e.g. the serving metrics
        that only exist once the server constructs) — call before
        ``start()``."""
        self._sources.append((dict(labels), registry_fn))

    def scrape_once(self, now: Optional[float] = None) -> int:
        """One snapshot-then-write pass; returns points written."""
        if now is None:
            now = time.time()  # dflint: disable=nondeterminism — store rows are wall-clock telemetry, not numerics
        points: List[Dict] = []
        for labels, registry_fn in self._sources:
            try:
                registry = registry_fn()
            except Exception:  # noqa: BLE001 — one dead source must not stop the scrape
                self.logger.exception("scrape source failed")
                continue
            if registry is not None:
                points.extend(
                    flatten_registry_snapshot(registry, now, labels))
        written = self._store.append(points)
        if now - self._last_compact >= self._compact_interval:
            self._last_compact = now
            dropped = self._store.compact(now)
            if dropped:
                self.logger.info("compaction dropped %d point(s)", dropped)
        return written

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the loop must outlive one bad tick
                self.logger.exception("scrape tick failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="quality-scrape", daemon=True)
        self._thread.start()

    def stop(self, final_scrape: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_scrape:
            # flush the last window so short-lived processes (tests, the
            # CI smoke) leave their history behind
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001
                self.logger.exception("final scrape failed")
