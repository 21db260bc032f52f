"""Series-partitioned fleet: consistent-hash routing + per-shard state
(port of the reference's ``serving/sharding.py``).

The workload is per-key fan-out over independent series (PAPER.md §0:
``groupBy().applyInPandas`` over 500+ models).  Without partitioning every
fleet replica would hold the FULL param/filter-state set and follow EVERY
tenant's WAL writes, so per-replica memory and ingest-apply work would
scale with total S whatever the replica count.  This module makes the
fleet data-parallel over series:

    series key ──(stable hash)──► shard ──(HashRing over replicas,
                                           vnodes, replication)──► owners

* **key → shard** is a pure stable hash mod ``num_shards`` — fixed for
  the lifetime of a deployment, so a key's WAL/state namespace
  (``wal_dir/shard-<k>/``) never moves when the replica set changes;
* **shard → replica set** rides a consistent-hash ring over replica
  indices with ``vnodes`` virtual points each: adding one replica to an
  N-replica ring remaps ~1/(N+1) of the shards (and therefore of the
  keys), never reshuffles everything;
* each replica loads ONLY its shards' params/state
  (:func:`subset_for_shards`) and follows ONLY its shards' WAL
  directories (:class:`ShardedWAL`), so resident series per replica is
  ~S * owned_shards / num_shards and tenant A's ingest is never applied
  by a non-owning replica;
* the front door routes single-shard requests straight to an owner and
  scatter-gathers multi-shard ones (:func:`plan_invocations`,
  :func:`merge_invocation_responses` — merge is in key order, partial
  failure degrades to per-key error entries, not a whole-request 5xx);
* per-tenant admission (:class:`TokenBucket`) reuses the batcher's
  429/Retry-After posture at the front door.

The kernel library's store entry (``engine/compile_cache``) is NOT
shard-suffixed: the library is keyed by its sources, flags, toolchain and
card, and a shard subset only changes runtime *data*, so every replica of
the fleet loads the one stored library.  State sidecars (history rows, WAL
segments) ARE data and live under shard-suffixed namespaces.

:func:`subset_for_shards` is the one function here that touches tensors:
a row gather of the forecaster's parameters on their own device
(``BatchForecaster.gather_params``), in :func:`shard_indices` order.

Everything here is hash-deterministic (hashlib, never ``hash()``) so two
processes — or the same process across restarts — always agree on the
routing table without coordination.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distributed_forecasting_tpu_torch.monitoring.failpoints import failpoint
from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.serving.ingest import WriteAheadLog


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """The ``serving.sharding`` conf block (see conf/tasks/serve_config.yml)."""

    enabled: bool = False
    num_shards: int = 8        # fixed key->shard partition count; state
    #                            namespaces are per shard, so changing this
    #                            is a redeploy, not a rebalance
    replication: int = 1       # replicas owning each shard (reads can land
    #                            on any owner; all owners follow the WAL)
    vnodes: int = 64           # virtual ring points per replica: higher =
    #                            smoother shard spread, slower ring build
    quota_rps: float = 0.0     # per-tenant admitted series-rows/s at the
    #                            front door; 0 disables admission control
    quota_burst: float = 0.0   # token-bucket capacity; 0 -> 2 * quota_rps

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if self.replication < 1:
            raise ValueError(
                f"replication must be >= 1, got {self.replication}")
        if self.vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {self.vnodes}")
        if self.quota_rps < 0:
            raise ValueError("quota_rps must be >= 0")
        if self.quota_burst < 0:
            raise ValueError("quota_burst must be >= 0")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "ShardingConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like num_shard must not silently serve unpartitioned
            raise ValueError(
                f"unknown serving.sharding conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


# -- deterministic hashing ----------------------------------------------------

def stable_hash(token: str) -> int:
    """64-bit hash that is identical across processes and Python runs —
    ``hash()`` is salted per process and would split the fleet's brain."""
    return int.from_bytes(
        hashlib.md5(token.encode("utf-8")).digest()[:8], "big")


def shard_of_key(key: Sequence[int], num_shards: int) -> int:
    """Series key tuple -> owning shard.  Pure function of the key values
    and the shard count: every replica, the front door, and a WAL replayed
    on a different host all route a key identically."""
    token = "key:" + ",".join(str(int(v)) for v in key)
    return stable_hash(token) % int(num_shards)


class HashRing:
    """Consistent-hash ring over opaque node ids with virtual nodes.

    Immutable once built — rebalance = build a NEW ring and swap it under
    the owner's lock (see FleetSupervisor), never mutate one in place
    under concurrent readers.
    """

    def __init__(self, nodes: Sequence, vnodes: int = 64):
        if not nodes:
            raise ValueError("ring needs at least one node")
        points: List[Tuple[int, object]] = []
        for node in nodes:
            for v in range(int(vnodes)):
                points.append((stable_hash(f"node:{node}:vnode:{v}"), node))
        points.sort(key=lambda p: p[0])
        self._hashes = [h for h, _ in points]
        self._nodes = [n for _, n in points]
        self.size = len(set(nodes))

    def lookup(self, token: str):
        """First node clockwise of the token's hash."""
        i = bisect_right(self._hashes, stable_hash(token)) % len(self._hashes)
        return self._nodes[i]

    def lookup_n(self, token: str, n: int) -> List:
        """``n`` DISTINCT nodes walking clockwise (the replication set)."""
        start = bisect_right(self._hashes, stable_hash(token))
        out: List = []
        for step in range(len(self._hashes)):
            node = self._nodes[(start + step) % len(self._hashes)]
            if node not in out:
                out.append(node)
                if len(out) >= min(int(n), self.size):
                    break
        return out


def compute_assignments(
    config: ShardingConfig, replica_indices: Sequence[int],
) -> Dict[int, List[int]]:
    """shard -> ordered owner replica-index list, deterministic in
    (config, replica set).  The first owner is the shard's primary (ingest
    routes there); the rest are read replicas following the shard WAL."""
    ring = HashRing(list(replica_indices), vnodes=config.vnodes)
    return {
        k: ring.lookup_n(f"shard:{k}", config.replication)
        for k in range(config.num_shards)
    }


# -- per-shard artifact subsetting -------------------------------------------

def shard_indices(keys, shards: Sequence[int], num_shards: int):
    """Row indices of ``keys`` (S, n_key_cols) whose shard is owned."""
    owned = set(int(s) for s in shards)
    return np.asarray(
        [i for i, k in enumerate(np.asarray(keys).tolist())
         if shard_of_key(k, num_shards) in owned],
        dtype=np.int64)


def subset_for_shards(forecaster, shards: Sequence[int], num_shards: int):
    """(forecaster restricted to its owned shards, owned row indices).

    Gathers every parameter field whose leading axis is the series axis —
    the convention ``BatchForecaster.gather_params`` routes on — on the
    parameters' own device, plus the key table and the per-series
    conformal scales.  The result is a first-class forecaster: predict,
    warmup and the streaming state swap all work on the subset, and for
    an owned key its predict is bitwise the full forecaster's (every
    family's forecast works row by row).
    """
    idx = shard_indices(forecaster.keys, shards, num_shards)
    params, day1 = forecaster._state_snapshot()
    scale = forecaster.interval_scale
    sub = type(forecaster)(
        model=forecaster.model,
        config=forecaster.config,
        params=forecaster.gather_params(idx, params=params),
        keys=np.asarray(forecaster.keys)[idx],
        key_names=forecaster.key_names,
        day0=forecaster.day0,
        day1=day1,
        interval_scale=None if scale is None else np.asarray(scale)[idx],
        freq=forecaster.freq,
    )
    sub.time_bucket = forecaster.time_bucket
    return sub, idx


# -- per-shard WAL namespaces -------------------------------------------------

class ShardedWAL:
    """``WriteAheadLog`` facade over ``wal_dir/shard-<k>/`` namespaces.

    Duck-types the single-log API the ingest runtime consumes (``append``
    / ``read_new`` / ``stats`` / ``directory``) but keeps one real WAL per
    shard: appends route each record by its key's shard, and the follower
    read covers ONLY the owned shards — a record for tenant A is durable
    in shard(A)'s directory the moment any replica accepts it, and only
    shard(A)'s owners ever replay it into model state.  Rows for shards
    this replica does NOT own still append durably (a mis-routed request
    must never lose a write); they are simply never followed here.
    """

    def __init__(self, directory: str, owned_shards: Sequence[int],
                 num_shards: int, max_segment_bytes: int = 4194304,
                 on_read: Optional[Callable[[int, int], None]] = None):
        self.directory = str(directory)
        self.num_shards = int(num_shards)
        self.owned_shards = tuple(sorted(int(s) for s in owned_shards))
        self.max_segment_bytes = int(max_segment_bytes)
        self._on_read = on_read
        self._lock = threading.Lock()   # lazily opened per-shard WAL map
        self._wals: Dict[int, WriteAheadLog] = {}
        for k in self.owned_shards:     # owned namespaces exist up front
            self._wal(k)

    def shard_dir(self, shard: int) -> str:
        return os.path.join(self.directory, f"shard-{int(shard)}")

    def _wal(self, shard: int) -> WriteAheadLog:
        with self._lock:
            wal = self._wals.get(shard)
            if wal is None:
                wal = WriteAheadLog(
                    self.shard_dir(shard),
                    max_segment_bytes=self.max_segment_bytes)
                self._wals[shard] = wal
            return wal

    def append(self, records: List[Dict]) -> int:
        """Route each record to its shard's log.  Records carry the compact
        WAL shape (``{"k": [...], ...}``) — the shard is a pure function of
        ``k``, so every appender agrees on the namespace."""
        by_shard: Dict[int, List[Dict]] = {}
        for rec in records:
            shard = shard_of_key(rec["k"], self.num_shards)
            by_shard.setdefault(shard, []).append(rec)
        written = 0
        for shard, rows in sorted(by_shard.items()):
            # per-shard-leg site: a mid-loop fault models one shard's disk
            # failing while the earlier shards already acked their rows —
            # exactly the partial-append case replay has to reconcile
            failpoint("wal.shard.append")
            written += self._wal(shard).append(rows)
        return written

    def read_new(self, cursor: Optional[Dict] = None,
                 ) -> Tuple[List[Dict], Dict]:
        """Follower read across the OWNED shards only; the cursor is a
        per-shard map of the underlying segment cursors."""
        cursor = dict(cursor or {})
        records: List[Dict] = []
        for shard in self.owned_shards:
            rows, sub = self._wal(shard).read_new(cursor.get(str(shard)))
            cursor[str(shard)] = sub
            if rows and self._on_read is not None:
                self._on_read(shard, len(rows))
            records.extend(rows)
        return records, cursor

    def stats(self) -> Dict[str, int]:
        total = {"segments": 0, "bytes": 0}
        for shard in self.owned_shards:
            st = self._wal(shard).stats()
            total["segments"] += st["segments"]
            total["bytes"] += st["bytes"]
        return total


# -- per-tenant admission -----------------------------------------------------

class TokenBucket:
    """Per-tenant token buckets: ``allow(tenant, n)`` admits ``n`` series
    rows or answers False (the caller's 429).  Monotonic-clock refill;
    ``time_fn`` is injectable so tests drive the clock by hand."""

    def __init__(self, rate: float, burst: float = 0.0,
                 time_fn: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError("token bucket needs rate > 0")
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else 2.0 * self.rate
        self._time = time_fn
        self._lock = threading.Lock()
        self._state: Dict[str, Tuple[float, float]] = {}  # tenant ->
        #                                                   (tokens, stamp)

    def allow(self, tenant: str, n: float = 1.0) -> bool:
        now = self._time()
        with self._lock:
            tokens, stamp = self._state.get(tenant, (self.burst, now))
            tokens = min(self.burst, tokens + (now - stamp) * self.rate)
            if tokens >= n:
                self._state[tenant] = (tokens - n, now)
                return True
            self._state[tenant] = (tokens, now)
            return False


def tenant_of_input(item: Dict, key_names: Sequence[str]) -> str:
    """Admission key: the series prefix — the FIRST key column's value
    (store/tenant id in the reference's store-item scheme).  Falls back to
    a shared bucket for inputs that don't carry the key columns."""
    name = key_names[0]
    if isinstance(item, dict):
        raw = item.get("keys", item.get("k"))
        if isinstance(raw, dict) and name in raw:
            return str(raw[name])
        if isinstance(raw, (list, tuple)) and raw:
            return str(raw[0])
        if name in item:
            return str(item[name])
    return "_unkeyed"


# -- request planning (front door) -------------------------------------------

def _input_key(item: Dict, key_names: Sequence[str]) -> Optional[Tuple]:
    try:
        raw = item.get("keys", item.get("k"))
        if raw is None:
            raw = {n: item[n] for n in key_names}
        if isinstance(raw, dict):
            return tuple(int(raw[n]) for n in key_names)
        key = tuple(int(v) for v in raw)
        return key if len(key) == len(key_names) else None
    except (KeyError, TypeError, ValueError):
        return None


@dataclasses.dataclass
class RoutePlan:
    """One routed POST: which shards, and the sub-body per shard."""

    field: str                       # "inputs" | "points" | "observations"
    shard_items: Dict[int, List]     # shard -> that shard's items, in order
    shard_keys: Dict[int, List]      # shard -> unique key tuples, in order
    key_order: List[Tuple]           # unique keys in request order
    tenants: Dict[str, int]          # tenant -> charged rows

    @property
    def shards(self) -> List[int]:
        return sorted(self.shard_items)

    def sub_body(self, base: Dict, shard: int) -> Dict:
        out = dict(base)
        out[self.field] = self.shard_items[shard]
        return out


_ROUTED_FIELDS = {
    "/invocations": "inputs",
    "/predict": "inputs",
    "/ingest": "points",
    "/observe": "observations",
    "/detect_anomalies": "points",
}


def plan_request(path: str, body: Dict, key_names: Sequence[str],
                 num_shards: int) -> Optional[RoutePlan]:
    """Parse a routed POST into a per-shard plan, or None when the body is
    not shardable (unknown path, missing key columns, malformed items) —
    the caller then falls back to round-robin over the full fleet."""
    field = _ROUTED_FIELDS.get(path)
    if field is None or not isinstance(body, dict):
        return None
    items = body.get(field)
    if not isinstance(items, list) or not items:
        return None
    shard_items: Dict[int, List] = {}
    shard_keys: Dict[int, List] = {}
    key_order: List[Tuple] = []
    seen = set()
    tenants: Dict[str, int] = {}
    for item in items:
        key = _input_key(item, key_names)
        if key is None:
            return None  # let the replica's own parser shape the error
        shard = shard_of_key(key, num_shards)
        shard_items.setdefault(shard, []).append(item)
        if key not in seen:
            seen.add(key)
            key_order.append(key)
            shard_keys.setdefault(shard, []).append(key)
        tenant = tenant_of_input(item, key_names)
        tenants[tenant] = tenants.get(tenant, 0) + 1
    return RoutePlan(field=field, shard_items=shard_items,
                     shard_keys=shard_keys, key_order=key_order,
                     tenants=tenants)


def merge_invocation_responses(
    plan: RoutePlan,
    key_names: Sequence[str],
    responses: Dict[int, Tuple[int, bytes]],
) -> Tuple[int, Dict]:
    """Scatter-gather merge for ``/invocations``.

    Successful shards' prediction records regroup by key tuple and emerge
    in the ORIGINAL request key order, so the merged body is byte-identical
    to what one unsharded replica answers for the same request (records
    preserve their JSON field order; per-series forecasts are independent
    of batch composition, the predictor's coalescing contract).  A failed shard
    degrades to per-key ``errors`` entries — the other tenants' forecasts
    still ship, which is the whole point of partitioning the fleet.
    Status: 200 unless EVERY shard failed (503, retryable).
    """
    by_key: Dict[Tuple, List] = {}
    n_series = 0
    errors: List[Dict] = []
    key_names = list(key_names)
    for shard, (status, payload) in sorted(responses.items()):
        if status == 200:
            try:
                parsed = json.loads(payload)
            except ValueError:
                parsed = None
            if not isinstance(parsed, dict):
                status, parsed = 502, {"error": "unparseable shard response"}
            else:
                n_series += int(parsed.get("n_series", 0))
                for rec in parsed.get("predictions", []):
                    try:
                        key = tuple(int(rec[n]) for n in key_names)
                    except (KeyError, TypeError, ValueError):
                        continue
                    by_key.setdefault(key, []).append(rec)
                continue
        try:
            detail = json.loads(payload).get("error", "")
        except (ValueError, AttributeError):
            detail = ""
        for key in plan.shard_keys.get(shard, []):
            entry = dict(zip(key_names, (int(v) for v in key)))
            entry["error"] = detail or f"shard {shard} unavailable"
            entry["status"] = int(status)
            entry["shard"] = int(shard)
            errors.append(entry)
    predictions: List = []
    for key in plan.key_order:
        predictions.extend(by_key.get(key, []))
    merged: Dict = {"predictions": predictions, "n_series": n_series}
    if errors:
        merged["errors"] = errors
        merged["n_failed_series"] = len(errors)
    if not any(status == 200 for status, _ in responses.values()):
        return 503, merged
    return 200, merged


def merge_detect_responses(
    plan: RoutePlan,
    key_names: Sequence[str],
    responses: Dict[int, Tuple[int, bytes]],
) -> Tuple[int, Dict]:
    """Scatter-gather merge for ``/detect_anomalies``.

    Same shape as :func:`merge_invocation_responses`: successful shards'
    per-point results regroup by key tuple in the ORIGINAL request key
    order (scores are per-series computations, independent of batch
    composition), summary counts sum, and a failed shard degrades to
    per-key ``errors`` entries while the other shards' verdicts still
    ship.  Status: 200 unless EVERY shard failed (503, retryable)."""
    by_key: Dict[Tuple, List] = {}
    totals = {"n_scored": 0, "n_flagged": 0, "n_skipped": 0}
    threshold = None
    errors: List[Dict] = []
    key_names = list(key_names)
    for shard, (status, payload) in sorted(responses.items()):
        if status == 200:
            try:
                parsed = json.loads(payload)
            except ValueError:
                parsed = None
            if not isinstance(parsed, dict):
                status, parsed = 502, {"error": "unparseable shard response"}
            else:
                for k in totals:
                    totals[k] += int(parsed.get(k, 0))
                if threshold is None:
                    threshold = parsed.get("threshold")
                for rec in parsed.get("results", []):
                    try:
                        key = tuple(int(rec[n]) for n in key_names)
                    except (KeyError, TypeError, ValueError):
                        continue
                    by_key.setdefault(key, []).append(rec)
                continue
        try:
            detail = json.loads(payload).get("error", "")
        except (ValueError, AttributeError):
            detail = ""
        for key in plan.shard_keys.get(shard, []):
            entry = dict(zip(key_names, (int(v) for v in key)))
            entry["error"] = detail or f"shard {shard} unavailable"
            entry["status"] = int(status)
            entry["shard"] = int(shard)
            errors.append(entry)
    results: List = []
    for key in plan.key_order:
        results.extend(by_key.get(key, []))
    merged: Dict = {"results": results, **totals}
    if threshold is not None:
        merged["threshold"] = threshold
    if errors:
        merged["errors"] = errors
    if not any(status == 200 for status, _ in responses.values()):
        return 503, merged
    return 200, merged


def merge_ingest_responses(
    plan: RoutePlan, responses: Dict[int, Tuple[int, bytes]],
) -> Tuple[int, Dict]:
    """Merge per-shard ``/ingest`` acks: numeric fields sum (written /
    unknown_series / malformed / out_of_range and the nested apply
    counts); failed shards report per-shard error entries.  The append is
    durable on every 200 shard even when a sibling shard failed."""
    totals: Dict[str, float] = {}
    applied: Dict[str, float] = {}
    errors: List[Dict] = []
    ok = 0
    for shard, (status, payload) in sorted(responses.items()):
        if status == 200:
            try:
                parsed = json.loads(payload)
            except ValueError:
                parsed = {}
            ok += 1
            for k, v in parsed.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    totals[k] = totals.get(k, 0) + v
                elif k == "applied" and isinstance(v, dict):
                    for ak, av in v.items():
                        if isinstance(av, (int, float)):
                            applied[ak] = applied.get(ak, 0) + av
        else:
            try:
                detail = json.loads(payload).get("error", "")
            except (ValueError, AttributeError):
                detail = ""
            errors.append({"shard": int(shard), "status": int(status),
                           "points": len(plan.shard_items.get(shard, [])),
                           "error": detail or f"shard {shard} unavailable"})
    out: Dict = {k: int(v) if float(v).is_integer() else v
                 for k, v in totals.items()}
    if applied:
        out["applied"] = {k: int(v) if float(v).is_integer() else v
                          for k, v in applied.items()}
    if errors:
        out["errors"] = errors
    return (200 if ok else 503), out


# -- replica-side shard metrics ----------------------------------------------

class ShardMetrics:
    """``dftpu_shard_*`` replica gauges/counters, appended to the serving
    ``GET /metrics`` exposition and fleet-merged TYPE-aware (per-shard
    series gauges MAX-merge across owners — every owner reports the same
    resident count; the ingest counters SUM, and a non-owning replica
    simply never emits a shard's label)."""

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.series = self.registry.labeled_gauge(
            "dftpu_shard_series", ("shard",),
            "resident series per owned shard on this replica")
        self.resident_series = self.registry.gauge(
            "dftpu_shard_resident_series",
            "total series resident on this replica (~S*owned/num_shards)")
        self.owned_shards = self.registry.gauge(
            "dftpu_shard_owned", "shards this replica owns")
        self.ingest_points = self.registry.labeled_counter(
            "dftpu_shard_ingest_points_total", ("shard",),
            "WAL records this replica consumed per owned shard — only "
            "owners ever increment a shard's label")

    def observe_assignment(self, keys, shards: Sequence[int],
                           num_shards: int) -> None:
        keys = np.asarray(keys)
        self.owned_shards.set(len(set(int(s) for s in shards)))
        self.resident_series.set(int(keys.shape[0]))
        counts: Dict[int, int] = {int(s): 0 for s in shards}
        for k in keys.tolist():
            counts[shard_of_key(k, num_shards)] += 1
        for shard, n in sorted(counts.items()):
            self.series.set(n, shard=str(shard))

    def note_wal_read(self, shard: int, n: int) -> None:
        self.ingest_points.inc(n, shard=str(shard))

    def render(self) -> str:
        return self.registry.render_prometheus()
