"""Serving fleet: N replica processes behind one front door (port of the
reference's ``serving/fleet.py``).

The scale-out unit is a whole server process running the batched artifact
(``serving/server.py``); on one card, N replica processes share the H100
and the front door runs no model (it never touches the card, so it holds
no CUDA context):

  * :class:`FleetSupervisor` spawns N replicas (``serving/replica.py``
    subprocesses by default; tests inject in-process fakes), polls their
    ``/readyz``, restarts crashed ones with capped exponential backoff, and
    terminates the fleet gracefully on drain;
  * :class:`FrontDoorServer` is the single client-facing HTTP endpoint: it
    round-robins ``POST /invocations`` (and pass-through GETs) across READY
    replicas, retries connection-level failures on the next replica
    (predict is idempotent, so a replica dying mid-request is retriable,
    not an error the client sees), and serves ``GET /metrics`` as the SUM
    of every replica's exposition plus the fleet's own gauges/counters.

Replicas share one on-disk store of the kernel library
(``engine/compile_cache``, multi-process-safe writes: a private temp file
published by an atomic rename), handed to them as ``DFTPU_COMPILE_CACHE``
by ``tasks/fleet.py``: every replica after the first build, and every
restart, loads the library without ``nvcc``.

Lock discipline: the supervisor takes its lock only to snapshot or update
replica state; every blocking action — health probes, process spawn/wait,
sleeps — happens OUTSIDE the critical section on the snapshot.  The
thread sanitizer (``monitoring/sanitizer.py``, a no-op unless armed) guards
the supervisor's replica table, round-robin cursor and shard assignments
with ``_lock``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Callable, List, Optional

from distributed_forecasting_tpu_torch.monitoring import sanitizer
from distributed_forecasting_tpu_torch.monitoring.failpoints import failpoint
from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.monitoring.trace import get_tracer
from distributed_forecasting_tpu_torch.serving.dataplane import (
    ConnectionPool,
    HttpConfig,
    KeepAliveHandlerMixin,
    PooledHTTPServer,
    pooled_get,
)
from distributed_forecasting_tpu_torch.serving.resilience import (
    OPEN,
    CircuitBreaker,
    LatencyReservoir,
    ResilienceConfig,
    deadline_from_headers,
    remaining_ms,
)
from distributed_forecasting_tpu_torch.serving.sharding import (
    ShardingConfig,
    TokenBucket,
    compute_assignments,
    merge_detect_responses,
    merge_ingest_responses,
    merge_invocation_responses,
    plan_request,
)
from distributed_forecasting_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The ``serving.fleet`` conf block (see conf/tasks/serve_config.yml)."""

    enabled: bool = False
    replicas: int = 2
    replica_host: str = "127.0.0.1"   # replicas are local children
    base_port: int = 0                # 0: pick free ports; else base_port+i
    health_poll_interval_s: float = 0.5
    probe_timeout_s: float = 2.0
    ready_timeout_s: float = 300.0    # cold warmup can compile for minutes
    restart_backoff_s: float = 0.5    # first restart delay after a crash
    restart_backoff_max_s: float = 30.0
    drain_timeout_s: float = 10.0     # SIGTERM -> SIGKILL grace per drain
    proxy_timeout_s: float = 120.0    # per-attempt forward timeout
    retry_window_s: float = 10.0      # front-door budget to find a replica
    mesh_devices: int = 0             # >1: each replica shards predict over
                                      # a mesh of this many ranks (its own
                                      # follower processes, replica.py)

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.restart_backoff_s <= 0:
            raise ValueError("restart_backoff_s must be > 0")
        if self.restart_backoff_max_s < self.restart_backoff_s:
            raise ValueError(
                "restart_backoff_max_s must be >= restart_backoff_s")
        if self.health_poll_interval_s <= 0:
            raise ValueError("health_poll_interval_s must be > 0")
        if self.mesh_devices < 0:
            raise ValueError(
                f"mesh_devices must be >= 0, got {self.mesh_devices}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "FleetConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like restart_backof_s must not silently lose its value
            raise ValueError(
                f"unknown serving.fleet conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        # YAML already types the values; the cast normalizes "8080" -> 8080
        # in hand-built dicts and keeps every field its declared scalar type
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf
        }
        return cls(**kwargs)


def _free_port(host: str) -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _probe_ready(host: str, port: int, timeout: float,
                 pool: Optional[ConnectionPool] = None) -> bool:
    """One /readyz probe.  With a pool the probe rides (and health-checks)
    the same keep-alive sockets the forward path reuses; without one it
    dials fresh (boot-time callers that predate the supervisor's pool)."""
    if pool is not None:
        try:
            status, _ = pooled_get(pool, host, port, "/readyz", timeout)
            return status == 200
        except (OSError, http.client.HTTPException):
            return False
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", "/readyz")
        return conn.getresponse().status == 200
    except (OSError, http.client.HTTPException):
        return False
    finally:
        conn.close()


def _fetch(host: str, port: int, path: str, timeout: float,
           pool: Optional[ConnectionPool] = None) -> Optional[bytes]:
    if pool is not None:
        try:
            status, body = pooled_get(pool, host, port, path, timeout)
            return body if status == 200 else None
        except (OSError, http.client.HTTPException):
            return None
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        if resp.status != 200:
            return None
        return resp.read()
    except (OSError, http.client.HTTPException):
        return None
    finally:
        conn.close()


# -- Prometheus aggregation --------------------------------------------------

def _fmt_value(v: float) -> str:
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def _split_label_pairs(body: str) -> List[str]:
    """Split the inside of a ``{...}`` label block on commas OUTSIDE quoted
    values (label values may contain escaped commas/quotes)."""
    parts: List[str] = []
    buf: List[str] = []
    in_quotes = False
    escaped = False
    for ch in body:
        if escaped:
            buf.append(ch)
            escaped = False
            continue
        if ch == "\\":
            buf.append(ch)
            escaped = True
            continue
        if ch == '"':
            in_quotes = not in_quotes
            buf.append(ch)
            continue
        if ch == "," and not in_quotes:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return parts


def _le_value(raw: str) -> float:
    return float("inf") if raw == "+Inf" else float(raw)


#: gauges describing SHARED fleet state (the one ingest WAL on disk, the
#: converged applied frontier) — max-merged, not summed, across replicas
_GAUGE_MAX_MERGE = frozenset({
    "dftpu_ingest_wal_bytes",
    "dftpu_ingest_wal_segments",
    "dftpu_ingest_applied_day",
    # a FRACTION (pad rows / dispatched rows): summing is meaningless,
    # the worst replica is the capacity-waste signal — the underlying
    # dftpu_cost_padding_rows_total counters still SUM
    "dftpu_cost_padding_waste",
    # per-shard resident-series gauges: with replication > 1 every owner
    # of a shard reports the SAME resident count for that shard's label,
    # so summing would multiply series by the replication factor
    "dftpu_shard_series",
    # forecast-cache staleness headline: the fleet's oldest materialized
    # frame anywhere — summing per-replica ages would fabricate an age no
    # frame has (the hit/miss/invalidation counters still SUM)
    "dftpu_cache_entry_age_seconds",
    # ratios / thresholds / enum states: the fleet-level signal is the
    # worst (largest) replica's value, never the arithmetic sum
    "dftpu_anomaly_threshold",
    "dftpu_data_quality_gap_ratio",
    "dftpu_fleet_breaker_state",
    "dftpu_ingest_pending_days",
    "dftpu_quality_metric",
    "dftpu_quality_nominal_coverage",
})

#: gauges that are genuinely ADDITIVE across replicas (per-replica counts
#: and resource totals) — listed explicitly so every ``dftpu_*`` gauge has
#: a deliberate fleet-merge policy
_GAUGE_SUM_MERGE = frozenset({
    "dftpu_anomaly_last_batch_flagged",
    "dftpu_cache_bytes",
    "dftpu_cache_entries",
    # per-replica busy worker counts are additive: the fleet-level signal
    # is total in-flight handler occupancy across the worker pools
    "dftpu_http_workers_busy",
    # a fraction per replica, but summing is the HISTORICAL contract the
    # cost tests pin (callers divide by replica count downstream)
    "dftpu_cost_device_saturation",
    "dftpu_data_quality_rows",
    "dftpu_data_quality_series",
    "dftpu_data_quality_duplicate_rows",
    "dftpu_data_quality_negative_sales",
    "dftpu_data_quality_nonfinite_sales",
    "dftpu_data_quality_short_series",
    "dftpu_data_quality_constant_series",
    "dftpu_data_quality_issues",
    "dftpu_ingest_dirty_series",
    "dftpu_ingest_refit_backlog",
    "dftpu_quality_series_observed",
    "dftpu_shard_owned",
    "dftpu_shard_resident_series",
})

#: max-merged gauge FAMILIES: SLO burn/firing state (an SLO burning on ANY
#: replica is burning fleet-wide) and per-replica capacity watermarks
#: (host RSS, device bytes in use — fleet headroom is set by the WORST
#: replica, and summing would invent memory pressure no single process has)
_GAUGE_MAX_PREFIXES = ("dftpu_slo_", "dftpu_cost_watermark_")

#: program cost registry gauges — REPLICATED, not summed: every replica
#: runs the same kernels of the one stored library and reports the same
#: programs, so the first replica's copy stands for the fleet (summing
#: would multiply FLOPs by the replica count)
_GAUGE_REPLICATE_PREFIX = "dftpu_cost_program_"


def aggregate_prometheus(texts: List[str]) -> str:
    """Merge replica ``/metrics`` expositions, TYPE-aware.

    ``# HELP`` / ``# TYPE`` lines keep the first replica's wording, and the
    TYPE map drives the fold per family:

      * **histograms** merge BUCKET-WISE: ``_bucket`` samples group by
        family + non-``le`` labels, bounds union across replicas, and each
        replica contributes its cumulative count carried forward from its
        largest own bound at or below each merged bound — so replicas whose
        bucket ladders differ (a rolling config change mid-fleet) still
        produce one monotone cumulative ladder instead of an interleaved
        corrupt one.  ``_sum``/``_count`` sum as before.
      * **``dftpu_slo_*`` gauges** merge by MAX: an SLO burning or firing
        on ANY replica is burning fleet-wide — summing would overstate burn
        rates by the replica count, and averaging would hide a single
        burning replica behind healthy peers.  The shared-WAL ingest gauges
        (:data:`_GAUGE_MAX_MERGE`) merge the same way: every replica
        reports the SAME on-disk log and applied frontier, so summing a
        3-replica fleet would triple the WAL size and the convergence
        point is the furthest-ahead replica.  The per-replica capacity
        watermarks (:data:`_GAUGE_MAX_PREFIXES` — host RSS, device bytes)
        also merge by MAX: headroom is set by the worst replica.
      * **``dftpu_cost_program_*`` gauges** REPLICATE — first replica
        wins: every replica reports the same programs, and summing would
        multiply a program's FLOPs by the replica count.
      * everything else — counters and the additive gauges enumerated in
        :data:`_GAUGE_SUM_MERGE` (queue depth in flight across the fleet,
        ``dftpu_cost_device_saturation``) — sums by name+labels.
    ``tests/test_torch_fleet.py`` holds this section honest for the port:
    every ``dftpu_*`` gauge the port registers appears in exactly one
    policy set (or matches a policy prefix).
    """
    entries: List[tuple] = []      # ("meta", raw) | ("sample", key) |
    #                                ("hist", group_key), in first-seen order
    values: dict = {}              # sample key -> folded value
    seen_meta: set = set()
    types: dict = {}               # family name -> prometheus kind
    # (family, other-labels str) -> per-replica {le_float: cumulative}
    hist_groups: dict = {}
    hist_le_str: dict = {}         # le_float -> original le token
    for replica_i, text in enumerate(texts):
        for raw in text.splitlines():
            if not raw.strip():
                continue
            if raw.startswith("#"):
                parts = raw.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    if parts[1] == "TYPE" and len(parts) >= 4:
                        types[parts[2]] = parts[3].strip()
                    meta_key = (parts[1], parts[2])
                    if meta_key not in seen_meta:
                        seen_meta.add(meta_key)
                        entries.append(("meta", raw))
                continue
            key, _, val = raw.rpartition(" ")
            if not key:
                continue
            try:
                v = float(val)
            except ValueError:
                continue
            name = key.partition("{")[0]
            if name.endswith("_bucket") and \
                    types.get(name[: -len("_bucket")]) == "histogram":
                brace = key.find("{")
                body = key[brace + 1: key.rfind("}")] if brace >= 0 else ""
                pairs = _split_label_pairs(body)
                le_raw = None
                others = []
                for p in pairs:
                    k, _, lv = p.partition("=")
                    if k.strip() == "le":
                        le_raw = lv.strip().strip('"')
                    else:
                        others.append(p)
                if le_raw is None:
                    continue  # malformed bucket line; drop rather than guess
                le = _le_value(le_raw)
                hist_le_str[le] = le_raw
                gkey = (name, ",".join(others))
                group = hist_groups.setdefault(gkey, {})
                if not group:
                    entries.append(("hist", gkey))
                group.setdefault(replica_i, {})[le] = v
                continue
            if key in values:
                if (name.startswith(_GAUGE_MAX_PREFIXES)
                        or name in _GAUGE_MAX_MERGE) and \
                        types.get(name) == "gauge":
                    values[key] = max(values[key], v)
                elif (name.startswith(_GAUGE_REPLICATE_PREFIX)
                        and types.get(name) == "gauge"):
                    pass  # replicated registry value: keep the first copy
                else:
                    values[key] += v
            else:
                values[key] = v
                entries.append(("sample", key))
    out = []
    for kind, payload in entries:
        if kind == "meta":
            out.append(payload)
        elif kind == "sample":
            out.append(f"{payload} {_fmt_value(values[payload])}")
        else:
            name, others = payload
            per_replica = hist_groups[payload]
            bounds = sorted({le for m in per_replica.values() for le in m})
            for le in bounds:
                total = 0.0
                for m in per_replica.values():
                    own = [b for b in m if b <= le]
                    if own:  # carry the replica's last cumulative forward
                        total += m[max(own)]
                label_body = ",".join(
                    ([others] if others else []) +
                    [f'le="{hist_le_str[le]}"'])
                out.append(f"{name}{{{label_body}}} {_fmt_value(total)}")
    return "\n".join(out) + ("\n" if out else "")


# -- replica bookkeeping -----------------------------------------------------

class Replica:
    """Per-replica state.  Deliberately lock-free: every field except the
    immutable identity is read and written ONLY while the supervisor holds
    its lock (the supervisor snapshots under the lock and acts outside)."""

    def __init__(self, index: int, port: int):
        self.index = index
        self.port = port
        self.proc = None            # Popen-compatible handle (poll/terminate/
        self.ready = False          # kill/wait) or an injected fake
        self.restarts = 0
        self.backoff_s = 0.0        # current restart delay (0 = next crash
        self.next_restart_at = 0.0  # restarts immediately); monotonic clock
        self.shards: tuple = ()     # owned shards (sharded fleets only);
        #                             rewritten under the lock on rebalance

    def describe(self) -> dict:
        alive = self.proc is not None and self.proc.poll() is None
        return {
            "index": self.index,
            "port": self.port,
            "alive": alive,
            "ready": self.ready,
            "restarts": self.restarts,
            "shards": list(self.shards),
        }


#: spawn_fn(index, port) for round-robin fleets; sharded fleets call it as
#: spawn_fn(index, port, shards) so the child knows its assignment at boot
SpawnFn = Callable[..., object]


def default_spawn_fn(
    config: FleetConfig,
    artifact_dir: str,
    serving_conf: Optional[dict] = None,
    env_extra: Optional[dict] = None,
    sharding: Optional[ShardingConfig] = None,
) -> SpawnFn:
    """A spawn_fn launching ``serving/replica.py`` subprocesses
    (``python -m distributed_forecasting_tpu_torch.serving.replica``).

    Each child loads the artifact itself (no pickled state crosses the
    process boundary), binds its assigned port with ``/readyz`` at 503,
    warms the bucket ladder, then flips ready.  ``env_extra`` typically
    carries ``DFTPU_COMPILE_CACHE`` (the kernel library's shared store) and
    ``DFTPU_PLATFORM`` (``cpu`` only when the fleet was asked for the CPU:
    a replica runs on the card and raises where there is none).
    With ``sharding``, the supervisor passes each replica its shard
    assignment and the child subsets its params/state/WAL to those shards
    before marking ready.
    """
    serving_conf = dict(serving_conf or {})
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def spawn(index: int, port: int, shards=None):
        replica_conf = {
            "artifact_dir": artifact_dir,
            "host": config.replica_host,
            "port": port,
            "warmup_sizes": serving_conf.get("warmup_sizes"),
            "warmup_horizon": serving_conf.get("warmup_horizon", 90),
            "batching": serving_conf.get("batching"),
            "tracing": serving_conf.get("tracing"),
            "model_version": serving_conf.get("model_version"),
            "mesh_devices": config.mesh_devices,
            # quality/store/slo conf (tasks/fleet.py passes the top-level
            # monitoring block through); the replica suffixes its store
            # directory with the port so two processes never share a
            # segment cursor
            "monitoring": serving_conf.get("monitoring"),
            # streaming ingest conf: unlike the quality store, wal_dir is
            # shared verbatim — replicas converge by following one log
            # (the replica defaults apply_mode to "interval" in a fleet)
            "ingest": serving_conf.get("ingest"),
            # anomaly scoring conf: each replica scores its own shards'
            # points; the front door scatter-gathers /detect_anomalies
            "anomaly": serving_conf.get("anomaly"),
            # materialized forecast cache: each replica caches its owned
            # shards and persists under its own replica-<port> directory
            "cache": serving_conf.get("cache"),
            # HTTP data plane: one serving.http block tunes keep-alive,
            # worker-pool size and idle timeout on replica AND front door
            "http": serving_conf.get("http"),
            # series partition: the child subsets its forecaster/WAL to
            # these shards and follows only their wal_dir/shard-<k>/ logs
            "sharding": (None if sharding is None
                         else dataclasses.asdict(sharding)),
            "shards": None if shards is None else sorted(shards),
        }
        env = dict(os.environ)
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = (
            pkg_root + (os.pathsep + existing if existing else ""))
        if env_extra:
            env.update(env_extra)
        return subprocess.Popen(
            [sys.executable, "-m",
             "distributed_forecasting_tpu_torch.serving.replica",
             "--conf", json.dumps(replica_conf)],
            env=env,
        )

    return spawn


# -- the supervisor ----------------------------------------------------------

class FleetSupervisor:
    """Spawns, health-polls, and restarts the replica set.

    Thread-safety: ``_lock`` guards every Replica field and the round-robin
    cursor.  The poll loop snapshots under the lock, probes/spawns/waits
    OUTSIDE it, then applies observations under the lock again — no
    blocking call ever runs inside the critical section.
    """

    def __init__(self, config: FleetConfig, spawn_fn: SpawnFn,
                 sharding: Optional[ShardingConfig] = None,
                 key_names: Optional[tuple] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 request_timeout_s: Optional[float] = None,
                 http: Optional[HttpConfig] = None):
        self._config = config
        self._spawn = spawn_fn
        self.resilience = resilience or ResilienceConfig()
        self.http = http or HttpConfig()
        # satellite of the deadline work: every forwarded leg gets an
        # explicit timeout bounded by the replica's own request timeout
        # (plus slack for transport), so a hung socket can no longer pin
        # a front-door worker for the full proxy_timeout_s
        self.request_timeout_s = request_timeout_s
        self._breakers: dict = {}       # port -> CircuitBreaker, under _lock
        self.leg_latency = LatencyReservoir()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._rr = 0
        ports = [
            _free_port(config.replica_host) if config.base_port == 0
            else config.base_port + i
            for i in range(config.replicas)
        ]
        self._replicas = [Replica(i, p) for i, p in enumerate(ports)]
        # series partition (None = classic round-robin fleet).  The
        # assignment table and per-replica shard tuples are shared state
        # under _lock like every Replica field; the sharding config and
        # quota bucket are immutable/internally-locked.
        self.sharding = sharding
        self._assignments: dict = {}
        self._schema_key_names: Optional[tuple] = (
            tuple(key_names) if key_names else None)
        self.quota = None
        if sharding is not None:
            self._assignments = compute_assignments(
                sharding, range(config.replicas))
            for rep in self._replicas:
                rep.shards = tuple(sorted(
                    k for k, owners in self._assignments.items()
                    if rep.index in owners))
            if sharding.quota_rps > 0:
                self.quota = TokenBucket(
                    sharding.quota_rps, sharding.quota_burst)
        self.logger = get_logger("FleetSupervisor")
        self.registry = MetricsRegistry()
        # keep-alive connections to replicas, shared by every forward/
        # scatter/health leg; its dftpu_http_pool_* counters land on this
        # registry and ride the front door's /metrics exposition
        self.pool = ConnectionPool(self.http, registry=self.registry)
        self._g_total = self.registry.gauge(
            "fleet_replicas_total", "replicas the supervisor manages")
        self._g_ready = self.registry.gauge(
            "fleet_replicas_ready", "replicas currently passing /readyz")
        self._c_restarts = self.registry.counter(
            "fleet_restarts_total", "replica processes (re)spawned after "
            "the initial launch")
        self._c_conn_failures = self.registry.counter(
            "fleet_connection_failures_total",
            "front-door forwards that failed at the connection level")
        self._c_retries = self.registry.counter(
            "fleet_retries_total",
            "requests the front door retried on another replica")
        self._c_unrouted = self.registry.counter(
            "fleet_unrouted_total",
            "requests that exhausted the retry window with no ready replica")
        self._c_unowned = self.registry.counter(
            "fleet_unowned_shard_total",
            "requests for a shard with no owner in the assignment table — "
            "retryable (503 + Retry-After), distinct from no-ready-replica")
        self._c_routed = self.registry.counter(
            "dftpu_shard_routed_total",
            "single-shard requests forwarded straight to an owning replica")
        self._c_scatter = self.registry.counter(
            "dftpu_shard_scatter_total",
            "multi-shard requests fanned out to owners and merged")
        self._c_shard_unrouted = self.registry.counter(
            "dftpu_shard_unrouted_total",
            "POSTs that could not be shard-planned (missing key columns, "
            "unknown path) and fell back to round-robin")
        self._c_rebalance = self.registry.counter(
            "dftpu_shard_rebalance_total",
            "shard-assignment changes applied (resize or owner hand-off)")
        self._c_quota_rejected = self.registry.counter(
            "dftpu_shard_quota_rejected_total",
            "requests rejected 429 by per-tenant admission at the front "
            "door")
        self._g_breaker = self.registry.labeled_gauge(
            "dftpu_fleet_breaker_state", ("port",),
            "per-replica circuit breaker state "
            "(0 closed / 1 open / 2 half-open)")
        self._c_breaker_open = self.registry.counter(
            "dftpu_fleet_breaker_skipped_total",
            "forward attempts skipped because the replica's breaker was "
            "open")
        self._c_deadline_exhausted = self.registry.counter(
            "dftpu_fleet_deadline_exhausted_total",
            "requests shed at the front door with their deadline budget "
            "spent (HTTP 503)")
        self._c_hedges = self.registry.counter(
            "dftpu_fleet_hedges_total",
            "duplicate scatter legs fired after the hedge delay")
        self._c_hedge_wins = self.registry.counter(
            "dftpu_fleet_hedge_wins_total",
            "scatter legs where the hedged duplicate answered first")
        self._c_hedge_cancelled = self.registry.counter(
            "dftpu_fleet_hedge_cancelled_total",
            "losing duplicate legs discarded after first-response-wins")
        self._g_total.set(config.replicas)
        # dftsan (no-op unless DFTPU_TSAN armed): the routing tables, read
        # and rewritten by the poll loop, the front door and resize
        sanitizer.attach(self, cls=FleetSupervisor, guards={
            "_lock": ("_replicas", "_rr", "_assignments")})

    # -- introspection (snapshot under lock, return plain data) -------------
    @property
    def config(self) -> FleetConfig:
        return self._config

    @property
    def host(self) -> str:
        return self._config.replica_host

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._replicas)

    def describe(self) -> List[dict]:
        with self._lock:
            return [r.describe() for r in self._replicas]

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.ready)

    def all_ports(self) -> List[int]:
        with self._lock:
            return [r.port for r in self._replicas]

    def rotation(self) -> List[int]:
        """Ready ports, rotated round-robin per call: the first entry is
        this request's primary, the rest its retry order."""
        with self._lock:
            ports = [r.port for r in self._replicas if r.ready]
            if not ports:
                return []
            start = self._rr % len(ports)
            self._rr += 1
        return ports[start:] + ports[:start]

    # -- shard routing (sharded fleets only) ---------------------------------
    def assignments(self) -> dict:
        """shard -> owner replica-index list, one locked snapshot."""
        with self._lock:
            return {k: list(v) for k, v in self._assignments.items()}

    def shard_owners(self, shard: int) -> List[int]:
        with self._lock:
            return list(self._assignments.get(int(shard), ()))

    def owner_rotation(self, shard: int) -> List[int]:
        """Ready ports among the shard's owners, rotated per call — the
        shard-restricted analogue of :meth:`rotation`."""
        with self._lock:
            owners = set(self._assignments.get(int(shard), ()))
            ports = [r.port for r in self._replicas
                     if r.index in owners and r.ready]
            if not ports:
                return []
            start = self._rr % len(ports)
            self._rr += 1
        return ports[start:] + ports[:start]

    def key_names(self) -> Optional[tuple]:
        with self._lock:
            return self._schema_key_names

    def set_key_names(self, names) -> None:
        """Cache the artifact's key columns (the front door discovers them
        from a replica's ``/schema`` on the first routed request)."""
        with self._lock:
            self._schema_key_names = tuple(names)

    # -- front-door feedback ------------------------------------------------
    def report_failure(self, port: int) -> None:
        """A connection-level forward failure: stop routing to this replica
        until the next successful health probe flips it back.  Its pooled
        idle connections drain too — they point at a peer that just proved
        unreliable, and a later checkout must dial (and re-verify) fresh."""
        self._c_conn_failures.inc()
        self.pool.drain(self._config.replica_host, port)
        with self._lock:
            for r in self._replicas:
                if r.port == port:
                    r.ready = False

    # -- circuit breakers + deadline budgets ---------------------------------
    def breaker_for(self, port: int) -> Optional[CircuitBreaker]:
        """The port's breaker (created lazily), or None when disabled."""
        res = self.resilience
        if res.breaker_failures < 1:
            return None
        with self._lock:
            br = self._breakers.get(port)
            if br is None:
                br = CircuitBreaker(
                    res.breaker_failures, res.breaker_open_s,
                    slow_s=res.breaker_slow_s)
                self._breakers[port] = br
        return br

    def breaker_allow(self, port: int) -> bool:
        """Routing gate: False ejects the port from this attempt.  Every
        True MUST be followed by breaker_success/breaker_failure, or a
        half-open probe slot stays claimed forever."""
        br = self.breaker_for(port)
        if br is None:
            return True
        ok = br.allow()
        if not ok:
            self._c_breaker_open.inc()
        self._g_breaker.set(br.state, port=str(port))
        return ok

    def breaker_success(self, port: int, elapsed_s: float) -> None:
        self.leg_latency.observe(elapsed_s)
        br = self.breaker_for(port)
        if br is not None:
            br.record_success(elapsed_s)
            self._g_breaker.set(br.state, port=str(port))

    def breaker_failure(self, port: int) -> None:
        br = self.breaker_for(port)
        if br is not None:
            br.record_failure()
            self._g_breaker.set(br.state, port=str(port))
            if br.state == OPEN:
                # breaker-aware eviction: an ejected replica's idle
                # keep-alive sockets must not survive into its half-open
                # probe — the probe decides on a FRESH connection
                self.pool.drain(self._config.replica_host, port)

    def request_deadline(self, headers) -> Optional[float]:
        """Monotonic deadline for an incoming request (header or conf
        default), or None when unbounded."""
        return deadline_from_headers(
            headers, self.resilience.default_deadline_ms)

    def leg_timeout_s(self, deadline: Optional[float] = None) -> float:
        """Socket timeout for one forwarded leg: the proxy cap, tightened
        by the replica's own request timeout (+5s transport slack — we
        wait for the replica's 503, not for a hung socket) and by the
        request's remaining deadline budget."""
        leg = self._config.proxy_timeout_s
        if self.request_timeout_s is not None:
            leg = min(leg, self.request_timeout_s + 5.0)
        rem = remaining_ms(deadline)
        if rem is not None:
            leg = min(leg, max(
                rem / 1000.0,
                self.resilience.min_leg_timeout_ms / 1000.0))
        return leg

    def hedge_delay_s(self) -> float:
        """How long a scatter leg may stay silent before its duplicate
        fires: the conf's fixed delay, or the observed leg p95."""
        res = self.resilience
        if res.hedge_delay_ms > 0:
            return res.hedge_delay_ms / 1000.0
        floor = res.hedge_min_delay_ms / 1000.0
        p95 = self.leg_latency.p95()
        return max(p95, floor) if p95 is not None else floor

    def note_deadline_exhausted(self) -> None:
        self._c_deadline_exhausted.inc()

    def note_hedge(self) -> None:
        self._c_hedges.inc()

    def note_hedge_win(self) -> None:
        self._c_hedge_wins.inc()

    def note_hedge_cancelled(self) -> None:
        self._c_hedge_cancelled.inc()

    def note_retry(self) -> None:
        self._c_retries.inc()

    def note_unrouted(self) -> None:
        self._c_unrouted.inc()

    def note_unowned(self, shard: int) -> None:
        self._c_unowned.inc()
        self.logger.warning("request for shard %d, which has no owner "
                            "in the assignment table", shard)

    def note_routed(self) -> None:
        self._c_routed.inc()

    def note_scatter(self) -> None:
        self._c_scatter.inc()

    def note_shard_unrouted(self) -> None:
        self._c_shard_unrouted.inc()

    def note_quota_rejected(self) -> None:
        self._c_quota_rejected.inc()

    def render_metrics(self) -> str:
        return self.registry.render_prometheus()

    # -- lifecycle ----------------------------------------------------------
    def _spawn_replica(self, index: int, port: int, shards):
        """Sharded fleets pass the assignment; classic spawn fns (and every
        pre-sharding test fake) keep their two-argument signature."""
        if self.sharding is not None:
            return self._spawn(index, port, shards)
        return self._spawn(index, port)

    def start(self) -> None:
        """Spawn every replica and start the health-poll loop."""
        with self._lock:
            replicas = list(self._replicas)
        spawned = [(rep, self._spawn_replica(rep.index, rep.port, rep.shards))
                   for rep in replicas]
        thread = threading.Thread(
            target=self._poll_loop, name="fleet-health-poll", daemon=True)
        with self._lock:
            for rep, proc in spawned:
                rep.proc = proc
            self._poll_thread = thread
        self.logger.info(
            "spawned %d replica(s) on ports %s", len(spawned),
            [rep.port for rep, _ in spawned])
        thread.start()

    def wait_ready(self, min_ready: int = 1,
                   timeout: Optional[float] = None) -> bool:
        """Block until ``min_ready`` replicas pass /readyz (True) or the
        timeout/stop arrives (False)."""
        budget = self._config.ready_timeout_s if timeout is None else timeout
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if self.ready_count() >= min_ready:
                return True
            if self._stop.wait(timeout=0.05):
                return False
        return self.ready_count() >= min_ready

    def poll_once(self) -> None:
        """One health sweep: probe outside the lock, update under it,
        restart crashed replicas (capped exponential backoff) outside it."""
        with self._lock:
            snapshot = [(r, r.proc, r.port) for r in self._replicas]
        cfg = self._config
        observed = []
        for rep, proc, port in snapshot:
            alive = proc is not None and proc.poll() is None
            ready = alive and _probe_ready(cfg.replica_host, port,
                                           cfg.probe_timeout_s,
                                           pool=self.pool)
            if not alive:
                # a dead replica's pooled sockets are dead too; drop them
                # before the restart brings a new process up on the port
                self.pool.drain(cfg.replica_host, port)
            observed.append((rep, alive, ready))
        now = time.monotonic()
        to_restart = []
        with self._lock:
            if self._stop.is_set():
                # a sweep that straddled stop() must not write back its
                # pre-stop observations (or respawn a draining replica)
                return
            for rep, alive, ready in observed:
                if alive:
                    rep.ready = ready
                    if ready:
                        rep.backoff_s = 0.0  # healthy: reset the backoff
                else:
                    rep.ready = False
                    if now >= rep.next_restart_at:
                        rep.backoff_s = min(
                            cfg.restart_backoff_s if rep.backoff_s == 0.0
                            else rep.backoff_s * 2.0,
                            cfg.restart_backoff_max_s,
                        )
                        rep.next_restart_at = now + rep.backoff_s
                        rep.restarts += 1
                        to_restart.append(rep)
            n_ready = sum(1 for r in self._replicas if r.ready)
        self._g_ready.set(n_ready)
        for rep in to_restart:
            self._c_restarts.inc()
            self.logger.warning(
                "replica %d (port %d) is down; restarting "
                "(attempt %d, next backoff %.1fs)",
                rep.index, rep.port, rep.restarts, rep.backoff_s)
            with self._lock:
                shards = rep.shards  # current assignment, not spawn-time's
            try:
                proc = self._spawn_replica(rep.index, rep.port, shards)
            except Exception:
                self.logger.exception(
                    "respawn of replica %d failed; will retry after backoff",
                    rep.index)
                continue
            if self.sharding is not None:
                # the respawn IS the hand-off: the child replays its shard
                # WALs and loads the shard state before /readyz flips
                self._c_rebalance.inc()
            with self._lock:
                rep.proc = proc

    def kill_replica(self, index: int) -> None:
        """Chaos hook (chip_smoke.py): SIGKILL one replica's process.  The
        poll loop restarts it with its current shard assignment — in a
        sharded fleet that restart IS the hand-off path (shard WAL replay
        + state load before /readyz), which is exactly what the smoke
        gates on converging."""
        proc = None
        with self._lock:
            for r in self._replicas:
                if r.index == int(index):
                    proc = r.proc
                    r.ready = False
                    break
            else:
                raise ValueError(f"no replica with index {index}")
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass
        with self._lock:
            port = next((r.port for r in self._replicas
                         if r.index == int(index)), None)
        if port is not None:
            # pooled keep-alive sockets into the killed process would fail
            # on next reuse; drop them now so forwards dial the restart
            self.pool.drain(self._config.replica_host, port)

    def resize(self, replicas: int) -> None:
        """Grow or shrink the replica set and rebalance shard ownership.

        The consistent-hash ring makes the diff small (adding one replica
        to N remaps ~1/(N+1) of the shards); a replica whose assignment
        changed is terminated and the poll loop respawns it with the new
        shard set — the respawned owner replays the shard WALs and loads
        the shard state sidecar before ``/readyz`` flips, so hand-off
        never serves a half-loaded shard.  Ports/spawns happen OUTSIDE the
        lock; only the table/replica-list swap is inside it.
        """
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        cfg = self._config
        with self._lock:
            current = len(self._replicas)
        new_ports = [
            _free_port(cfg.replica_host) if cfg.base_port == 0
            else cfg.base_port + i
            for i in range(current, replicas)
        ]
        new_assign = (compute_assignments(self.sharding, range(replicas))
                      if self.sharding is not None else {})
        added = [Replica(current + i, p) for i, p in enumerate(new_ports)]
        to_terminate = []
        to_spawn = []
        changed = 0
        with self._lock:
            victims = self._replicas[replicas:]
            self._replicas = self._replicas[:replicas] + added
            self._assignments = new_assign
            for rep in self._replicas:
                shards = tuple(sorted(
                    k for k, owners in new_assign.items()
                    if rep.index in owners))
                if self.sharding is not None and shards != rep.shards:
                    rep.shards = shards
                    if rep not in added:
                        changed += 1
                        rep.ready = False
                        to_terminate.append(rep.proc)
                else:
                    rep.shards = shards
            for rep in victims:
                rep.ready = False
                to_terminate.append(rep.proc)
            to_spawn = list(added)
        if self.sharding is not None and (changed or added or victims):
            self._c_rebalance.inc(changed + len(added) + len(victims))
        self._g_total.set(replicas)
        for rep in to_spawn:
            try:
                proc = self._spawn_replica(rep.index, rep.port, rep.shards)
            except Exception:
                self.logger.exception(
                    "spawn of replica %d failed; the poll loop will retry",
                    rep.index)
                continue
            with self._lock:
                rep.proc = proc
        for proc in to_terminate:
            if proc is not None and proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass
        self.logger.info(
            "resized fleet to %d replica(s) (%d reassigned, %d added, "
            "%d removed)", replicas, changed, len(added), len(victims))

    def _poll_loop(self) -> None:
        while not self._stop.wait(
                timeout=self._config.health_poll_interval_s):
            self.poll_once()

    def stop(self) -> None:
        """Graceful drain: stop polling, SIGTERM every replica (each drains
        its own batcher — server.shutdown), escalate to SIGKILL after
        ``drain_timeout_s``."""
        self._stop.set()
        with self._lock:
            thread = self._poll_thread
            procs = [r.proc for r in self._replicas]
        if thread is not None:
            thread.join(timeout=5.0)
        with self._lock:
            # cleared AFTER the join: a health sweep in flight when _stop
            # was set can no longer resurrect a pre-stop ready=True
            for r in self._replicas:
                r.ready = False
        self._g_ready.set(0)
        # close idle keep-alive sockets BEFORE the SIGTERMs: a drain must
        # not leave half-open connections for the replicas to time out on
        self.pool.close()
        for proc in procs:
            if proc is not None and proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + self._config.drain_timeout_s
        for proc in procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except Exception:
                try:
                    proc.kill()
                except OSError:
                    pass
        self.logger.info("fleet stopped")


# -- the front door ----------------------------------------------------------

class _DeadlineExhausted(Exception):
    """A request's deadline budget ran out inside the front door — the
    routing loops raise it so every caller converges on one distinct 503
    (shed, not "no ready replica")."""


class _FrontDoorHandler(KeepAliveHandlerMixin, BaseHTTPRequestHandler):
    server_version = "dftpu-fleet/1.0"

    def log_message(self, fmt, *args):
        self.server.logger.info("%s " + fmt, self.address_string(), *args)

    def _send_json(self, code: int, payload: dict, extra_headers=()) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        tid = self._trace_id()
        if tid:
            # echo the sanitized correlation id on every front-door-built
            # response (sheds, scatter merges, health) — same contract as
            # the replica handler, so error bodies stay greppable by trace
            self.send_header("X-Trace-Id", tid)
        for name, value in extra_headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        sup = self.server.supervisor
        if self.path == "/healthz":
            # the front door's own liveness, independent of the fleet
            self._send_json(200, {"status": "ok"})
        elif self.path == "/readyz":
            n = sup.ready_count()
            self._send_json(
                200 if n > 0 else 503,
                {"ready": n > 0, "ready_replicas": n, "replicas": sup.size},
                extra_headers=(() if n > 0
                               else (("Retry-After", "1"),)))
        elif self.path == "/fleet":
            self._send_json(200, {"replicas": sup.describe()})
        elif self.path == "/metrics":
            # the aggregation legs deliberately run under probe_timeout_s,
            # not the request budget: a scrape should see every replica
            # even when the scraper sent a tight X-Deadline-Ms
            # dflint: disable=deadline-propagation — probe-budgeted scrape
            self._metrics()
        else:
            # /health, /schema, ... answer the same on any replica
            self._proxy("GET", None, sup.request_deadline(self.headers))

    def _send_deadline_shed(self) -> None:
        self.server.supervisor.note_deadline_exhausted()
        self._send_json(
            503,
            {"error": "deadline budget exhausted",
             "detail": "the request's X-Deadline-Ms budget ran out before "
                       "a replica answered; retry with a larger budget"},
            extra_headers=(("Retry-After", "1"),))

    def do_POST(self):
        sup = self.server.supervisor
        deadline = sup.request_deadline(self.headers)
        rem = remaining_ms(deadline)
        if rem is not None and rem <= 0:
            # shed before reading the body: exhausted work gets its
            # terminal status immediately instead of a doomed forward
            self._send_deadline_shed()
            return
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length)
        if sup.sharding is not None:
            if self._routed_post(body, deadline):
                return
        self._proxy("POST", body, deadline)

    def _metrics(self) -> None:
        sup = self.server.supervisor
        cfg = sup.config
        texts = []
        for port in sup.all_ports():
            # every live replica contributes, ready or not (a draining
            # replica's counters still belong in the fleet totals)
            payload = _fetch(cfg.replica_host, port, "/metrics",
                             cfg.probe_timeout_s, pool=sup.pool)
            if payload is not None:
                texts.append(payload.decode())
        body = (aggregate_prometheus(texts) + sup.render_metrics()).encode()
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _forward(self, host: int, port: int, method: str, body,
                 deadline: Optional[float] = None):
        sup = self.server.supervisor
        # fault site for EVERY front-door -> replica leg: an injected
        # OSError takes the callers' report-failure-and-retry path, an
        # injected sleep models a hung socket against the leg timeout
        failpoint("fleet.forward")
        timeout = sup.leg_timeout_s(deadline)
        headers = {"Content-Type": self.headers.get(
            "Content-Type", "application/json")} if body is not None else {}
        rem = remaining_ms(deadline)
        if rem is not None:
            # the remaining budget travels downstream; a replica that
            # receives <= 0 sheds before dispatch (serving/server.py)
            headers["X-Deadline-Ms"] = str(int(rem))
        tid = self._trace_id()
        if tid:
            # the correlation id crosses the fleet hop too, so replica
            # spans join the same trace the front door opened
            headers["X-Trace-Id"] = tid
        for attempt in (0, 1):
            conn, reused = sup.pool.acquire(host, port, timeout)
            try:
                conn.request(method, self.path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
            except (OSError, http.client.HTTPException):
                sup.pool.discard(conn)
                if reused and attempt == 0:
                    # the half-closed keep-alive race (replica restarted or
                    # reaped the idle socket a beat before us), not a sick
                    # replica: retry ONCE on a guaranteed-fresh connection
                    # so the race never becomes a client-visible failure.
                    # predict is idempotent, so the replay is safe.
                    continue
                raise
            # a response the server is about to close (HTTP/1.0 replica,
            # Connection: close) is not reusable; everything else is
            sup.pool.release(conn, healthy=not resp.will_close)
            return resp.status, resp.getheader(
                "Content-Type", "application/json"), payload

    # -- routed dispatch (sharded fleets) ------------------------------------

    def _trace_id(self) -> Optional[str]:
        """Same header sanitation as the replica handler: a hostile
        X-Trace-Id must not ride into span files."""
        raw = (self.headers.get("X-Trace-Id") or "").strip()
        if 1 <= len(raw) <= 64 and all(c.isalnum() or c in "-_" for c in raw):
            return raw
        return None

    def _schema_key_names(self) -> Optional[tuple]:
        """The artifact's key columns, discovered once from any ready
        replica's ``/schema`` and cached on the supervisor."""
        sup = self.server.supervisor
        names = sup.key_names()
        if names:
            return names
        cfg = sup.config
        for port in sup.rotation():
            payload = _fetch(cfg.replica_host, port, "/schema",
                             cfg.probe_timeout_s, pool=sup.pool)
            if payload is None:
                continue
            try:
                names = tuple(json.loads(payload).get("key_names") or ())
            except (ValueError, AttributeError):
                continue
            if names:
                sup.set_key_names(names)
                return names
        return None

    def _forward_with_retry(self, ports_fn, method: str, body,
                            deadline: Optional[float] = None):
        """Retry-on-next-port over ``ports_fn()`` until the retry window
        (or the request's deadline budget) closes.  Returns ``(status,
        ctype, payload, port)`` or ``None`` — unlike :meth:`_proxy` it
        never writes the response itself, so scatter threads can call it
        concurrently.  Raises :class:`_DeadlineExhausted` when the budget
        runs out with no response."""
        sup = self.server.supervisor
        cfg = sup.config
        window = time.monotonic() + cfg.retry_window_s
        attempts = 0
        while True:
            for port in ports_fn():
                rem = remaining_ms(deadline)
                if rem is not None and rem <= 0:
                    raise _DeadlineExhausted()
                if not sup.breaker_allow(port):
                    continue
                attempts += 1
                if attempts > 1:
                    sup.note_retry()
                t0 = time.monotonic()
                try:
                    status, ctype, payload = self._forward(
                        cfg.replica_host, port, method, body,
                        deadline=deadline)
                except (OSError, http.client.HTTPException):
                    sup.breaker_failure(port)
                    sup.report_failure(port)
                    continue
                sup.breaker_success(port, time.monotonic() - t0)
                return status, ctype, payload, port
            rem = remaining_ms(deadline)
            if rem is not None and rem <= 0:
                raise _DeadlineExhausted()
            if time.monotonic() >= window:
                return None
            # no ready owner right now; wait for the poll loop's hand-off
            time.sleep(0.05)

    def _routed_post(self, body, deadline: Optional[float] = None) -> bool:
        """Shard-route a POST.  Returns True when the request was fully
        handled here; False falls back to round-robin ``_proxy`` (body not
        shard-plannable: unknown path, missing key columns, non-JSON)."""
        sup = self.server.supervisor
        # once-per-boot cached /schema discovery bounded by probe_timeout_s;
        # not per-request work, so it does not spend the request's budget
        # dflint: disable=deadline-propagation — probe-budgeted discovery
        names = self._schema_key_names()
        if names is None:
            return False
        try:
            parsed = json.loads(body or b"{}")
        except ValueError:
            return False
        tid = self._trace_id()
        tracer = get_tracer()
        with tracer.root_span("route.lookup", trace_id=tid,
                              path=self.path) as span:
            plan = plan_request(self.path, parsed, names,
                                sup.sharding.num_shards)
            if plan is not None:
                span.set_attribute("shards", len(plan.shards))
                span.set_attribute("series", len(plan.key_order))
        if plan is None:
            sup.note_shard_unrouted()
            return False
        quota = sup.quota
        if quota is not None:
            for tenant, charge in sorted(plan.tenants.items()):
                if not quota.allow(tenant, charge):
                    sup.note_quota_rejected()
                    self._send_json(
                        429,
                        {"error": f"tenant {tenant} over admission quota",
                         "tenant": tenant, "charge": charge},
                        extra_headers=(("Retry-After", "1"),))
                    return True
        if len(plan.shards) == 1:
            return self._routed_single(plan, body, deadline)
        return self._scatter(plan, parsed, tid, deadline)

    def _routed_single(self, plan, body,
                       deadline: Optional[float] = None) -> bool:
        """Single-shard fast path: the original body forwards VERBATIM to
        an owning replica, so the client sees that replica's exact bytes —
        the round-robin path's contract, now shard-aware."""
        sup = self.server.supervisor
        shard = plan.shards[0]
        if not sup.shard_owners(shard):
            sup.note_unowned(shard)
            self._send_json(
                503,
                {"error": "shard has no owner", "shard": shard,
                 "detail": "assignment table maps this shard to no "
                           "replica; retry after rebalance"},
                extra_headers=(("Retry-After", "1"),))
            return True
        try:
            res = self._forward_with_retry(
                lambda: sup.owner_rotation(shard), "POST", body,
                deadline=deadline)
        except _DeadlineExhausted:
            self._send_deadline_shed()
            return True
        if res is None:
            sup.note_unrouted()
            self._send_json(
                503,
                {"error": "no ready replica for shard", "shard": shard},
                extra_headers=(("Retry-After", "1"),))
            return True
        sup.note_routed()
        status, ctype, payload, port = res
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.send_header("X-Fleet-Replica", str(port))
        self.send_header("X-Fleet-Shard", str(shard))
        self.end_headers()
        self.wfile.write(payload)
        return True

    def _hedged_forward(self, ports_fn, method: str, body,
                        deadline: Optional[float] = None):
        """First-response-wins over a primary leg and (after the hedge
        delay) a duplicate to the next owner.  Same return contract as
        :meth:`_forward_with_retry`, which is also the fallback when
        hedging is off, fewer than two owners are up, or both legs die.
        The losing duplicate is counted and discarded, never awaited —
        its thread still reports its breaker outcome when it lands."""
        sup = self.server.supervisor
        cfg = sup.config
        if not sup.resilience.hedge_enabled:
            return self._forward_with_retry(ports_fn, method, body,
                                            deadline=deadline)
        ports = ports_fn()
        if len(ports) < 2:
            return self._forward_with_retry(ports_fn, method, body,
                                            deadline=deadline)
        done = threading.Event()
        lock = threading.Lock()
        winner: list = []
        tracer = get_tracer()
        # hedge legs run on bare daemon threads: without this capture any
        # span a leg opens would detach from the request's trace
        ctx = tracer.current()

        def leg(port: int, is_hedge: bool):
            with tracer.context(ctx):
                t0 = time.monotonic()
                try:
                    status, ctype, payload = self._forward(
                        cfg.replica_host, port, method, body,
                        deadline=deadline)
                except (OSError, http.client.HTTPException):
                    sup.breaker_failure(port)
                    sup.report_failure(port)
                    return
                sup.breaker_success(port, time.monotonic() - t0)
                with lock:
                    if winner:
                        # the race is over: this duplicate's answer is
                        # discarded (the replica already did the work;
                        # predict is idempotent, so discarding is safe)
                        sup.note_hedge_cancelled()
                        return
                    winner.append((status, ctype, payload, port, is_hedge))
                done.set()

        threading.Thread(
            target=leg, args=(ports[0], False), daemon=True).start()
        if not done.wait(sup.hedge_delay_s()):
            sup.note_hedge()
            threading.Thread(
                target=leg, args=(ports[1], True), daemon=True).start()
        done.wait(sup.leg_timeout_s(deadline))
        with lock:
            res = winner[0] if winner else None
        if res is None:
            # both legs failed or are still hung: the classic retry loop
            # owns the remaining window (and the deadline bookkeeping)
            return self._forward_with_retry(ports_fn, method, body,
                                            deadline=deadline)
        status, ctype, payload, port, is_hedge = res
        if is_hedge:
            sup.note_hedge_win()
        return status, ctype, payload, port

    def _scatter(self, plan, parsed: dict, tid,
                 deadline: Optional[float] = None) -> bool:
        """Fan a multi-shard request out to one owner per shard and merge.

        A failed shard degrades to per-key ``errors`` entries in the merged
        body — the other shards' results still ship (partial failure is
        NOT a whole-request 5xx; only every-shard-failed is)."""
        sup = self.server.supervisor
        responses: dict = {}
        tracer = get_tracer()

        def one(shard: int):
            with tracer.context(ctx):
                return _one(shard)

        def _one(shard: int):
            if not sup.shard_owners(shard):
                sup.note_unowned(shard)
                return 503, json.dumps(
                    {"error": "shard has no owner"}).encode()
            sub = json.dumps(plan.sub_body(parsed, shard)).encode()
            try:
                res = self._hedged_forward(
                    lambda: sup.owner_rotation(shard), "POST", sub,
                    deadline=deadline)
            except _DeadlineExhausted:
                sup.note_deadline_exhausted()
                return 503, json.dumps(
                    {"error": "deadline budget exhausted"}).encode()
            if res is None:
                sup.note_unrouted()
                return 503, json.dumps(
                    {"error": "no ready replica for shard"}).encode()
            status, _, payload, _ = res
            return status, payload

        with tracer.root_span("route.scatter", trace_id=tid, path=self.path,
                              shards=len(plan.shards)):
            # per-shard work runs on bare threads: capture the scatter span
            # context here so each leg's forward spans stay under it
            ctx = tracer.current()
            threads = [
                threading.Thread(
                    target=lambda k=shard: responses.__setitem__(k, one(k)),
                    daemon=True)
                for shard in plan.shards
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        sup.note_scatter()
        # /ingest and /detect_anomalies share the "points" field, so the
        # merge dispatches on the path, not the plan's field name
        if plan.field == "inputs":
            status, merged = merge_invocation_responses(
                # dflint: disable=deadline-propagation — cached discovery
                plan, self._schema_key_names() or (), responses)
        elif self.path == "/detect_anomalies":
            status, merged = merge_detect_responses(
                # dflint: disable=deadline-propagation — cached discovery
                plan, self._schema_key_names() or (), responses)
        else:
            status, merged = merge_ingest_responses(plan, responses)
        headers = [("X-Fleet-Scatter", str(len(plan.shards)))]
        if status >= 500:
            headers.append(("Retry-After", "1"))
        self._send_json(status, merged, extra_headers=tuple(headers))
        return True

    def _proxy(self, method: str, body,
               deadline: Optional[float] = None) -> None:
        """Round-robin with retry-on-next-replica.

        Connection-level failures (refused/reset/timeout before a response
        arrives) mean the replica died or is mid-restart; predict is
        idempotent, so the request replays on the next ready replica and
        the client never sees the crash.  Application-level responses —
        including a replica's own 4xx/5xx — pass through untouched.
        Replicas with an open circuit breaker are skipped exactly like
        not-ready ones, and a spent deadline budget ends the loop with a
        distinct 503 instead of more doomed attempts.
        """
        sup = self.server.supervisor
        cfg = sup.config
        window = time.monotonic() + cfg.retry_window_s
        attempts = 0
        last_err: Optional[str] = None
        while True:
            for port in sup.rotation():
                rem = remaining_ms(deadline)
                if rem is not None and rem <= 0:
                    self._send_deadline_shed()
                    return
                if not sup.breaker_allow(port):
                    continue
                attempts += 1
                if attempts > 1:
                    sup.note_retry()
                t0 = time.monotonic()
                try:
                    status, ctype, payload = self._forward(
                        cfg.replica_host, port, method, body,
                        deadline=deadline)
                except (OSError, http.client.HTTPException) as e:
                    sup.breaker_failure(port)
                    sup.report_failure(port)
                    last_err = f"{type(e).__name__}: {e}"
                    continue
                sup.breaker_success(port, time.monotonic() - t0)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("X-Fleet-Replica", str(port))
                self.end_headers()
                self.wfile.write(payload)
                return
            rem = remaining_ms(deadline)
            if rem is not None and rem <= 0:
                self._send_deadline_shed()
                return
            if time.monotonic() >= window:
                break
            # no ready replica right now (all crashed or mid-restart):
            # wait for the supervisor's poll loop to bring one back
            time.sleep(0.05)
        sup.note_unrouted()
        self._send_json(
            503,
            {"error": "no ready replica",
             "detail": last_err or "fleet has no ready replicas",
             "attempts": attempts},
            extra_headers=(("Retry-After", "1"),),
        )


class FrontDoorServer(PooledHTTPServer):
    # keep-alive, TCP_NODELAY, backlog and the bounded worker pool come
    # from PooledHTTPServer — same serving.http block as the replicas.
    # No busy gauge here: the replicas already register
    # dftpu_http_workers_busy, and the front door's /metrics aggregates
    # their expositions — a second registration would duplicate the family.

    def __init__(self, addr, supervisor: FleetSupervisor,
                 http: Optional[HttpConfig] = None):
        super().__init__(addr, _FrontDoorHandler,
                         http=http if http is not None else supervisor.http)
        self.supervisor = supervisor
        self.logger = get_logger("FrontDoor")


def start_fleet(
    config: FleetConfig,
    artifact_dir: Optional[str] = None,
    serving_conf: Optional[dict] = None,
    front_host: str = "127.0.0.1",
    front_port: int = 0,
    env_extra: Optional[dict] = None,
    spawn_fn: Optional[SpawnFn] = None,
    wait: bool = True,
    sharding: Optional[ShardingConfig] = None,
    key_names: Optional[tuple] = None,
    resilience: Optional[ResilienceConfig] = None,
):
    """Boot the whole subsystem: supervisor + replicas + front door.

    Returns ``(supervisor, front_door_server)``; the front door runs on a
    daemon thread (its bound port is ``front.server_address[1]``).  Callers
    stop with ``front.shutdown(); supervisor.stop()``.  With ``sharding``
    the front door routes by series key instead of round-robinning
    (``key_names`` pre-seeds the routing schema; omitted, it is discovered
    from a replica's ``/schema``).  ``resilience`` arms the degradation
    layer (deadline budgets, breakers, hedging) and — when its
    ``failpoints`` spec is non-empty — the front door's OWN failpoint
    registry (replica children arm via the ``DFTPU_FAILPOINTS`` env var
    that tasks/fleet.py sets from the same conf block).
    """
    if sharding is not None and not sharding.enabled:
        sharding = None
    if resilience is not None and resilience.failpoints:
        from distributed_forecasting_tpu_torch.monitoring import (
            failpoints as _fp,
        )
        _fp.configure(resilience.failpoints, seed=resilience.failpoint_seed)
    # the replica's own request timeout bounds each forwarded leg
    # (satellite: a hung replica socket must not pin a front-door worker)
    request_timeout_s = None
    batching = (serving_conf or {}).get("batching") or {}
    if batching.get("request_timeout_s") is not None:
        request_timeout_s = float(batching["request_timeout_s"])
    # one serving.http block tunes the whole data plane: the supervisor's
    # outbound keep-alive pool, the front door's worker pool, and (via
    # default_spawn_fn's pass-through) every replica's server
    http = HttpConfig.from_conf((serving_conf or {}).get("http"))
    if spawn_fn is None:
        if artifact_dir is None:
            raise ValueError(
                "pass artifact_dir (for the default subprocess spawner) or "
                "an explicit spawn_fn")
        spawn_fn = default_spawn_fn(
            config, artifact_dir, serving_conf, env_extra=env_extra,
            sharding=sharding)
    supervisor = FleetSupervisor(config, spawn_fn, sharding=sharding,
                                 key_names=key_names,
                                 resilience=resilience,
                                 request_timeout_s=request_timeout_s,
                                 http=http)
    supervisor.start()
    if wait and not supervisor.wait_ready(min_ready=1):
        supervisor.stop()
        raise RuntimeError(
            f"no replica became ready within {config.ready_timeout_s}s")
    front = FrontDoorServer((front_host, front_port), supervisor, http=http)
    t = threading.Thread(target=front.serve_forever, daemon=True)
    t.start()
    supervisor.logger.info(
        "front door on %s:%d over %d replica(s)",
        front_host, front.server_address[1], supervisor.size)
    return supervisor, front
