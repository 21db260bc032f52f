"""Materialized forecast cache: reads as row gathers, write-path epochs
(port of the reference's ``serving/forecast_cache.py``).

The read-heavy scorer answers many identical ``/invocations`` between rare
writes, and each read would otherwise pay a batched predict and its JSON
encoding.  This module materializes the forecast once per state:

* after a state install (``BatchForecaster.swap_state``, the one commit
  point every writer goes through: the streaming apply, the full-refit
  install, the windowed tail refit, a day1-only grid advance), the writer's
  thread recomputes each resident signature's frame in ONE full-S predict
  through the unchanged ``serving/predictor.py`` path, so a rebuild launches
  the hand kernels a predict of that family launches;
* reads become row gathers out of that frame.  ``BatchForecaster``'s predict
  returns request-order per-series blocks that are bit-identical across
  request-size buckets (``coalesce_safe``, the property the coalescer
  scatters on), so a gather of rows out of the full-S frame is byte for
  byte what a dispatch of that request serves;
* misses (a cold signature, a rebuild in flight, a raced epoch) and exotic
  requests (xreg, include_history, an unlisted quantile set, a horizon past
  the admission cap) fall through to the batcher or a direct dispatch.

No torn or stale read: an entry is tagged with the state generation read in
the same locked snapshot as the state the rebuild's predict used
(``_state_snapshot_versioned``), a read serves an entry only while its epoch
is the current generation, and a rebuild that a writer overtakes is
discarded at publish.  A read sees the pre-install frame before the install
commits or the post-install state after it, never a mix.

The rebuild runs on the writer's thread and on its current stream.  A
refit's install runs after the executor's refit-stream context has closed
(``engine/state_store._install_refit`` records the new tensors on the
default stream), so the rebuild's predict reads them on the default stream,
as every serving predict does.

Entries optionally persist under ``mmap_dir``: one ``.npy`` payload and one
``.meta.json`` commit record per signature, each written temp-then-rename
with a ``cache.persist`` failpoint first, and checked at boot
(``cache.load``) against a sha256 of the payload and a fingerprint of the
live model state, so a restart on changed state discards the frame and
falls through to dispatch.  The fingerprint hashes the param dataclass's
tensors field by field after a tag naming this package, so a frame the
reference persisted (its own float rounding) is never adopted here, nor
this package's there.

Conf is the strict ``serving.cache`` block (unknown keys raise)::

    serving:
      cache:
        enabled: true
        max_horizons: 4          # distinct horizons admitted per process
        quantile_sets: [[0.1, 0.5, 0.9]]   # quantile reads served cached
        mmap_dir: null           # persistence off by default
        max_bytes: 268435456     # in-memory budget; oldest entries evicted

Telemetry: ``dftpu_cache_*`` counters (hits, misses by reason,
invalidations, rebuilds, evictions, persist and load outcomes), entry-count
and resident-bytes gauges, and an entry-age gauge the fleet aggregator
max-merges.  Lookups, rebuilds, persists and loads are ``cache.*`` spans.
The thread sanitizer (``monitoring/sanitizer.py``, a no-op unless armed)
guards the entry table and its byte accounting with ``_lock``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.monitoring import sanitizer
from distributed_forecasting_tpu_torch.monitoring.failpoints import failpoint
from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.monitoring.trace import get_tracer
from distributed_forecasting_tpu_torch.utils.logging import get_logger

_META_SUFFIX = ".meta.json"
_PAYLOAD_SUFFIX = ".npy"
_PERSIST_FORMAT = "dftpu-forecast-cache-v1"
# which implementation computed a persisted frame (its state fingerprint's
# first field): the reference hashes the same state's bytes without it
_FINGERPRINT_TAG = "distributed_forecasting_tpu_torch"


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


class CacheMetrics:
    """``dftpu_cache_*`` telemetry, one registry per cache instance,
    appended to the scorer's ``GET /metrics``.

    In a fleet the counters sum across replicas; the ``entry_age_seconds``
    gauge is max-merged by ``serving/fleet.aggregate_prometheus`` (the
    fleet's staleness headline is its oldest cached frame).
    """

    def __init__(self) -> None:
        r = MetricsRegistry()
        self.registry = r
        self.hits = r.counter(
            "dftpu_cache_hits_total",
            "reads served as row gathers from a current-epoch cached frame")
        self.misses = r.labeled_counter(
            "dftpu_cache_misses_total", ("reason",),
            "reads that fell through to dispatch, by reason (cold: no "
            "entry yet; stale: entry epoch behind a write; rebuilding: "
            "another thread held the rebuild gate; bypass: xreg/"
            "include_history/unlisted quantile set; horizon_cap: distinct-"
            "horizon admission bound)")
        self.invalidations = r.counter(
            "dftpu_cache_invalidations_total",
            "resident entries invalidated by state installs (epoch bumps)")
        self.rebuilds = r.counter(
            "dftpu_cache_rebuilds_total",
            "full-S batched dispatches that materialized a cache frame")
        self.evictions = r.counter(
            "dftpu_cache_evictions_total",
            "entries evicted to hold the max_bytes budget")
        self.persists = r.counter(
            "dftpu_cache_persists_total",
            "entries durably persisted to the mmap directory")
        self.persist_errors = r.counter(
            "dftpu_cache_persist_errors_total",
            "persist attempts that failed (cache kept serving from memory)")
        self.loads = r.counter(
            "dftpu_cache_loads_total",
            "persisted entries adopted at boot after fingerprint + digest "
            "validation")
        self.load_errors = r.counter(
            "dftpu_cache_load_errors_total",
            "persisted entries discarded at boot (torn payload, digest or "
            "state-fingerprint mismatch) — served via dispatch instead")
        self.entries = r.gauge(
            "dftpu_cache_entries", "resident materialized frames")
        self.bytes = r.gauge(
            "dftpu_cache_bytes", "resident bytes across cached frames")
        self.entry_age = r.gauge(
            "dftpu_cache_entry_age_seconds",
            "age of the oldest resident frame since its rebuild (fleet "
            "mode: max-merged by the aggregator)")


#: distinct request shapes (series subsets) whose assembled frames and
#: encoded bodies are memoized per entry: the read-heavy regime repeats a
#: small set of requests
_FRAME_MEMO_MAX = 512


class _Entry:
    """One materialized frame: the full-S forecast for a signature.

    The payload (``ds`` / ``columns`` / ``values``) is immutable after
    construction: readers hold a reference and gather outside any lock, so
    an invalidation cannot tear a frame a read is part-way through.
    ``memo`` caches assembled request frames and ``body_memo`` their
    encoded HTTP bodies, both by series-index key; they die with the entry
    at the next epoch bump, and their dict get / set are atomic under the
    GIL, so no lock guards them."""

    __slots__ = ("sig", "epoch", "day1", "ds", "columns", "values",
                 "built_at", "nbytes", "memo", "body_memo")

    def __init__(self, sig, epoch, day1, ds, columns, values, built_at):
        self.sig = sig            # (horizon, quantile tuple | None)
        self.epoch = epoch        # state generation the frame was built from
        self.day1 = day1
        self.ds = ds              # (T,) date tile, one series' ds column
        self.columns = columns    # value column names in predict's order
        self.values = values      # (ncols, S, T) float32, host memory
        self.built_at = built_at  # monotonic clock
        self.nbytes = int(values.nbytes) + int(ds.nbytes)
        self.memo: Dict[bytes, pd.DataFrame] = {}
        self.body_memo: Dict[bytes, bytes] = {}


def _host_bytes(value) -> bytes:
    """A param field's bytes on the host (a tensor is pulled once)."""
    if torch.is_tensor(value):
        return value.detach().cpu().contiguous().numpy().tobytes()
    return np.ascontiguousarray(value).tobytes()


class ForecastCache:
    """Shard-local materialized forecast frames over a ``BatchForecaster``.

    ``_lock`` guards the entry map and the admission bookkeeping; reads take
    a reference to the (immutable) entry under it and gather rows outside
    it.  Rebuild dispatches and persist I/O are serialized by
    ``_rebuild_gate`` (a capacity semaphore) and never run under ``_lock``.
    """

    def __init__(self, forecaster, config: CacheConfig,
                 metrics: Optional[CacheMetrics] = None):
        self._fc = forecaster
        self.config = config
        self.metrics = metrics if metrics is not None else CacheMetrics()
        self.logger = get_logger("ForecastCache")
        self._lock = threading.Lock()
        self._entries: Dict[tuple, _Entry] = {}
        self._horizons: set = set()   # distinct horizons ever admitted
        self._bytes = 0
        # one rebuild / persist at a time: a capacity limiter, not a mutex
        # around shared attributes (dispatches run outside _lock)
        self._rebuild_gate = threading.BoundedSemaphore(1)
        self._fp_cache: Tuple[int, str] = (-1, "")
        if config.mmap_dir:
            self._load_persisted()
        # subscribe after the persisted adoption, so a boot-time WAL replay
        # (a replica replays before ready) invalidates adopted entries too
        forecaster.register_state_listener(self._on_state_install)
        # dftsan (no-op unless DFTPU_TSAN armed): the entry table and byte
        # accounting every lookup / install / invalidate touches
        sanitizer.attach(self, cls=ForecastCache, guards={
            "_lock": ("_entries", "_horizons", "_bytes")})

    # -- read path -----------------------------------------------------------

    def lookup(self, frame: pd.DataFrame, horizon: int,
               include_history: bool, quantiles, on_missing: str,
               xreg) -> Optional[pd.DataFrame]:
        """Serve one parsed ``/invocations`` request from the cache, or
        return None to fall through to dispatch.  Raises what dispatch
        raises for unknown series, so the HTTP status is the same on both
        paths."""
        entry, sidx = self._lookup_entry(frame, horizon, include_history,
                                         quantiles, on_missing, xreg)
        if entry is None:
            return None
        return self._gather(entry, sidx)

    def lookup_response(self, frame: pd.DataFrame, horizon: int,
                        include_history: bool, quantiles, on_missing: str,
                        xreg, encode) -> Optional[bytes]:
        """Serve the encoded response body from the cache, or None to fall
        through to dispatch.  ``encode(frame) -> bytes`` is the caller's
        serializer (the server passes its ``_encode_predictions``), run at
        most once per (entry, series subset): a repeat hit returns the
        memoized bytes and skips both the frame assembly and the encoding.
        Admission, metrics, epochs and ``UnknownSeriesError`` as in
        :meth:`lookup`; the memo dies with its entry at every epoch bump."""
        entry, sidx = self._lookup_entry(frame, horizon, include_history,
                                         quantiles, on_missing, xreg)
        if entry is None:
            return None
        memo_key = sidx.tobytes()
        body = entry.body_memo.get(memo_key)
        if body is None:
            body = encode(self._gather(entry, sidx))
            if len(entry.body_memo) < _FRAME_MEMO_MAX:
                entry.body_memo[memo_key] = body
        return body

    def _lookup_entry(self, frame, horizon, include_history, quantiles,
                      on_missing, xreg):
        """The read path behind :meth:`lookup` and :meth:`lookup_response`:
        admission, series resolution, the epoch-checked entry fetch (with
        the inline cold rebuild) and the hit / miss metrics.  Returns
        ``(entry, sidx)`` on a current-epoch hit, ``(None, None)`` on a
        miss or a bypass."""
        if not self.config.enabled:
            return None, None
        if xreg is not None or include_history:
            self.metrics.misses.inc(reason="bypass")
            return None, None
        if quantiles is not None:
            quantiles = canonical_quantiles(quantiles)
            if quantiles not in self.config.quantile_sets:
                self.metrics.misses.inc(reason="bypass")
                return None, None
        sig = (int(horizon), quantiles)
        with get_tracer().span("cache.lookup", horizon=int(horizon),
                               quantiles=len(quantiles or ())) as span:
            # the resolution (and UnknownSeriesError) dispatch would do
            sidx = self._fc.series_indices(frame, on_missing=on_missing)
            if sidx.size == 0:
                # dispatch's empty frame is family-specific: dispatch it
                span.set_attribute("outcome", "bypass")
                self.metrics.misses.inc(reason="bypass")
                return None, None
            entry, reason = self._current_entry(sig)
            if entry is None and reason == "cold":
                entry = self._rebuild_for_miss(sig)
                if entry is None:
                    reason = "rebuilding"
            if entry is None:
                span.set_attribute("outcome", reason)
                self.metrics.misses.inc(reason=reason)
                return None, None
            span.set_attribute("outcome", "hit")
            self.metrics.hits.inc()
            return entry, sidx

    def _current_entry(self, sig):
        """``(entry, miss_reason)``: the resident entry iff its epoch is the
        current state generation (the no-stale-read invariant)."""
        gen = self._fc.state_generation()
        with self._lock:
            entry = self._entries.get(sig)
            if entry is not None and entry.epoch == gen:
                return entry, ""
            if sig[0] not in self._horizons and (
                    len(self._horizons) >= self.config.max_horizons):
                return None, "horizon_cap"
            return None, ("stale" if entry is not None else "cold")

    def _gather(self, entry: _Entry, sidx: np.ndarray) -> pd.DataFrame:
        """Row-gather the requested series out of the materialized frame:
        byte-equal to a dispatch, since predict's per-series blocks are
        bit-identical across request-size buckets.

        Returns a shallow copy of the memoized frame: the handler replaces
        the ``ds`` column of the response, and a column replacement on a
        fresh shallow copy never reaches the cached original."""
        memo_key = sidx.tobytes()
        frame = entry.memo.get(memo_key)
        if frame is None:
            T = entry.ds.shape[0]
            out = {"ds": np.tile(entry.ds, len(sidx))}
            keys = self._fc.keys
            for j, name in enumerate(self._fc.key_names):
                out[name] = np.repeat(keys[sidx, j], T)
            for ci, col in enumerate(entry.columns):
                out[col] = np.asarray(entry.values[ci][sidx]).reshape(-1)
            frame = pd.DataFrame(out)
            if len(entry.memo) < _FRAME_MEMO_MAX:
                entry.memo[memo_key] = frame
        return frame.copy(deep=False)

    # -- write path ----------------------------------------------------------

    def _on_state_install(self) -> None:
        """``swap_state`` listener (the writer's thread, outside the state
        lock): count the now-stale residents, then re-materialize each
        resident signature in one predict apiece.  A reader meanwhile sees
        the pre-install frame rejected by the epoch check (dispatch) or the
        new frame, never the old values."""
        with self._lock:
            sigs = [e.sig for e in self._entries.values()]
        if not sigs:
            return
        self.metrics.invalidations.inc(len(sigs))
        for sig in sigs:
            self.rebuild(sig)

    def rebuild(self, sig) -> bool:
        """Materialize ``sig``'s full-S frame (blocking on the gate);
        returns True iff the frame was published (False: a newer install
        overtook the predict, or the forecaster raised)."""
        with self._rebuild_gate:
            return self._rebuild_locked(sig)

    def _rebuild_for_miss(self, sig) -> Optional[_Entry]:
        """The cold miss's inline rebuild, on a non-blocking gate: when
        another thread is materializing, this read falls through to
        dispatch instead of queueing behind a predict."""
        if not self._rebuild_gate.acquire(blocking=False):
            return None
        try:
            self._rebuild_locked(sig)
        finally:
            self._rebuild_gate.release()
        entry, _ = self._current_entry(sig)
        return entry

    def _rebuild_locked(self, sig) -> bool:
        horizon, quantiles = sig
        fc = self._fc
        epoch = fc.state_generation()
        req = pd.DataFrame(fc.keys, columns=fc.key_names)
        with get_tracer().span("cache.rebuild", horizon=int(horizon),
                               series=int(fc.keys.shape[0])) as span:
            try:
                if quantiles is None:
                    frame = fc.predict(req, horizon=horizon)
                else:
                    frame = fc.predict_quantiles(
                        req, quantiles=quantiles, horizon=horizon)
            except Exception:  # noqa: BLE001 — reads keep dispatching
                self.logger.exception("cache rebuild dispatch failed")
                span.set_attribute("outcome", "error")
                return False
            self.metrics.rebuilds.inc()
            _, day1, gen_after = fc._state_snapshot_versioned()
            if gen_after != epoch:
                # a writer overtook the predict: drop the frame; the
                # writer's own listener pass rebuilds from the newer state
                span.set_attribute("outcome", "superseded")
                return False
            S = int(fc.keys.shape[0])
            key_cols = set(fc.key_names) | {"ds"}
            columns = [c for c in frame.columns if c not in key_cols]
            T = len(frame) // S
            # float32 as predict pulls them, so nbytes, the eviction order
            # and dftpu_cache_bytes equal the reference's
            values = np.stack(
                [frame[c].to_numpy().reshape(S, T) for c in columns])
            entry = _Entry(sig, epoch, int(day1),
                           frame["ds"].to_numpy()[:T].copy(), columns,
                           values, time.monotonic())
            span.set_attribute("outcome", "published")
        if not self._publish(entry):
            return False
        if self.config.mmap_dir:
            self._persist(entry)
        return True

    def _publish(self, entry: _Entry) -> bool:
        evicted = []
        with self._lock:
            if entry.epoch != self._fc.state_generation():
                return False  # raced a writer between predict and publish
            if entry.nbytes > self.config.max_bytes:
                # a frame that alone exceeds the budget is never admitted
                self.metrics.evictions.inc()
                return False
            old = self._entries.get(entry.sig)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[entry.sig] = entry
            self._horizons.add(entry.sig[0])
            self._bytes += entry.nbytes
            while self._bytes > self.config.max_bytes:
                victim = min(
                    (e for e in self._entries.values() if e.sig != entry.sig),
                    key=lambda e: e.built_at, default=None)
                if victim is None:
                    break
                del self._entries[victim.sig]
                self._bytes -= victim.nbytes
                evicted.append(victim.sig)
            self._refresh_gauges_locked()
        for sig in evicted:
            self.metrics.evictions.inc()
            self._remove_persisted(sig)
        return True

    # -- persistence ---------------------------------------------------------

    def _sig_stem(self, sig) -> str:
        horizon, quantiles = sig
        stem = f"h{int(horizon)}"
        if quantiles:
            stem += "-q" + "_".join(f"{q:.3f}".rstrip("0").rstrip(".")
                                    for q in quantiles)
        return stem.replace(".", "p")

    def _state_fingerprint(self) -> str:
        """sha256 over the live (model, day1, keys, params): what a
        persisted frame must have been computed from to be adopted.  The
        param dataclass's fields are hashed in order, each tensor's host
        bytes once per generation; a writer landing mid-hash restarts it.
        The hash starts with :data:`_FINGERPRINT_TAG`: the reference's
        frames of the same state hold its own rounding, which is not this
        package's dispatch, so neither package adopts the other's."""
        while True:
            params, day1, gen = self._fc._state_snapshot_versioned()
            with self._lock:
                if self._fp_cache[0] == gen:
                    return self._fp_cache[1]
            h = hashlib.sha256()
            h.update(f"{_FINGERPRINT_TAG}|{self._fc.model}|{day1}|".encode())
            h.update(np.ascontiguousarray(self._fc.keys).tobytes())
            for f in dataclasses.fields(params):
                h.update(_host_bytes(getattr(params, f.name)))
            digest = h.hexdigest()
            if self._fc.state_generation() == gen:
                with self._lock:
                    self._fp_cache = (gen, digest)
                return digest
            # a writer landed mid-hash; recompute from the new snapshot

    def _persist(self, entry: _Entry) -> None:
        """Record ``entry`` under ``mmap_dir``: the payload written to a
        temporary file and renamed, then the meta JSON as the commit
        record.  A kill -9 in between leaves nothing visible or a payload
        with no meta, both of which the loader ignores."""
        cfg_dir = self.config.mmap_dir
        stem = self._sig_stem(entry.sig)
        try:
            with get_tracer().span("cache.persist", sig=stem):
                failpoint("cache.persist")
                os.makedirs(cfg_dir, exist_ok=True)
                payload = np.ascontiguousarray(entry.values)
                ppath = os.path.join(cfg_dir, stem + _PAYLOAD_SUFFIX)
                tmp = ppath + ".tmp"
                with open(tmp, "wb") as f:
                    np.save(f, payload)
                os.replace(tmp, ppath)
                with open(ppath, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                ds = entry.ds
                meta = {
                    "format": _PERSIST_FORMAT,
                    "horizon": int(entry.sig[0]),
                    "quantiles": (None if entry.sig[1] is None
                                  else list(entry.sig[1])),
                    "columns": list(entry.columns),
                    "day1": int(entry.day1),
                    "ds_i8": np.asarray(ds).view("i8").tolist(),
                    "ds_dtype": str(np.asarray(ds).dtype),
                    "payload_sha256": digest,
                    "state_fingerprint": self._state_fingerprint(),
                }
                mpath = os.path.join(cfg_dir, stem + _META_SUFFIX)
                tmp = mpath + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(meta, f)
                os.replace(tmp, mpath)
            self.metrics.persists.inc()
        except Exception:  # noqa: BLE001 — memory serving survives disk loss
            self.metrics.persist_errors.inc()
            self.logger.exception("cache persist failed (sig %s)", stem)

    def _remove_persisted(self, sig) -> None:
        if not self.config.mmap_dir:
            return
        stem = self._sig_stem(sig)
        for suffix in (_META_SUFFIX, _PAYLOAD_SUFFIX):
            try:
                os.remove(os.path.join(self.config.mmap_dir, stem + suffix))
            except OSError:
                pass

    def _load_persisted(self) -> None:
        """Adopt persisted frames whose state fingerprint matches the live
        model state; anything torn, corrupt or computed from other state is
        discarded, and dispatch serves those reads instead."""
        cfg_dir = self.config.mmap_dir
        try:
            names = sorted(n for n in os.listdir(cfg_dir)
                           if n.endswith(_META_SUFFIX))
        except OSError:
            return
        fingerprint = self._state_fingerprint() if names else ""
        epoch = self._fc.state_generation()
        for name in names:
            stem = name[: -len(_META_SUFFIX)]
            try:
                with get_tracer().span("cache.load", sig=stem):
                    failpoint("cache.load")
                    with open(os.path.join(cfg_dir, name)) as f:
                        meta = json.load(f)
                    if (meta.get("format") != _PERSIST_FORMAT
                            or meta.get("state_fingerprint") != fingerprint):
                        raise ValueError("state fingerprint mismatch")
                    ppath = os.path.join(cfg_dir, stem + _PAYLOAD_SUFFIX)
                    with open(ppath, "rb") as f:
                        digest = hashlib.sha256(f.read()).hexdigest()
                    if digest != meta.get("payload_sha256"):
                        raise ValueError("payload digest mismatch")
                    values = np.load(ppath, mmap_mode="r")
                    quantiles = meta.get("quantiles")
                    sig = (int(meta["horizon"]),
                           None if quantiles is None
                           else tuple(float(q) for q in quantiles))
                    ds = np.asarray(meta["ds_i8"], dtype="i8").view(
                        np.dtype(meta["ds_dtype"]))
                    S = int(self._fc.keys.shape[0])
                    if values.shape[1:] != (S, ds.shape[0]):
                        raise ValueError(
                            f"payload shape {values.shape} does not cover "
                            f"{S} series x {ds.shape[0]} steps")
                    entry = _Entry(sig, epoch, int(meta["day1"]), ds,
                                   list(meta["columns"]), values,
                                   time.monotonic())
                self.metrics.loads.inc()
                self._publish(entry)
            except Exception:  # noqa: BLE001 — discard, never serve torn
                self.metrics.load_errors.inc()
                self.logger.warning(
                    "discarding persisted cache entry %s (torn or stale)",
                    stem)
                for suffix in (_META_SUFFIX, _PAYLOAD_SUFFIX):
                    try:
                        os.remove(os.path.join(cfg_dir, stem + suffix))
                    except OSError:
                        pass

    # -- introspection -------------------------------------------------------

    def _refresh_gauges_locked(self) -> None:
        self.metrics.entries.set(float(len(self._entries)))  # dflint: disable=unlocked-shared-state — _locked suffix contract: every caller holds self._lock
        self.metrics.bytes.set(float(self._bytes))  # dflint: disable=unlocked-shared-state — _locked suffix contract: every caller holds self._lock

    def render_metrics(self) -> str:
        now = time.monotonic()
        with self._lock:
            oldest = min((e.built_at for e in self._entries.values()),
                         default=None)
            self._refresh_gauges_locked()
        self.metrics.entry_age.set(0.0 if oldest is None else now - oldest)
        return self.metrics.registry.render_prometheus()

    def describe(self) -> dict:
        gen = self._fc.state_generation()
        with self._lock:
            entries = [{
                "horizon": e.sig[0],
                "quantiles": list(e.sig[1]) if e.sig[1] else None,
                "epoch": e.epoch,
                "current": e.epoch == gen,
                "bytes": e.nbytes,
            } for e in self._entries.values()]
            total = self._bytes
        return {"enabled": self.config.enabled, "generation": gen,
                "entries": entries, "bytes": total}


def build_forecast_cache(conf, forecaster,
                         default_mmap_dir: Optional[str] = None):
    """``serving.cache`` conf -> :class:`ForecastCache` (None when off).

    A forecaster that is not ``coalesce_safe`` serves uncached: composites
    (ensemble, bucketed) reorder rows by member, and an instance with
    Monte-Carlo intervals draws a series' paths beside the rows of its
    request (the reference caches the latter)."""
    config = CacheConfig.from_conf(conf)
    if not config.enabled:
        return None
    if not getattr(forecaster, "coalesce_safe", False):
        get_logger("ForecastCache").warning(
            "%s is not coalesce-safe; forecast cache disabled",
            type(forecaster).__name__)
        return None
    if config.mmap_dir is None and default_mmap_dir is not None:
        config = dataclasses.replace(config, mmap_dir=default_mmap_dir)
    return ForecastCache(forecaster, config)
