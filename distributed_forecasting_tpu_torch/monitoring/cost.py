"""Runtime cost and capacity observability, ``dftpu_cost_*`` (port of the
reference's ``monitoring/cost.py``).

  * **Program cost registry** — ``dftpu_cost_program_*`` labeled gauges,
    one row per (entry, shape key).  The reference reads each compiled XLA
    program's ``cost_analysis()``; eager PyTorch compiles no program, so
    the port's rows are its kernels' own counts of float32 operations and
    bytes — ``ops/fused_scan.hw_score_work`` / ``hw_filter_work``,
    ``ops/kalman.arima_filter_work`` / ``arima_predict_work`` /
    ``arima_loglik_grad_work`` / ``mle_fit_work``, ``ops/solve.gram_work`` /
    ``cho_solve_work``, the counts ``chip_smoke.py``'s bounds and PERF.md's
    Bound column read — recorded by each function the first time it runs
    at a shape (:meth:`CostMetrics.record_work`), as ``flops`` and
    ``bytes_accessed``.  An entry with no count (a plain-torch program run
    through ``engine/compile_cache.aot_call``) has dispatch seconds only.
  * **Device-time attribution** — the training executor charges each
    experiment's dispatch-through-pull interval, ``aot_call`` each call's
    dispatch, the sweep each evaluation, into per-entry / per-family
    counters; a sliding window turns them into
    ``dftpu_cost_device_saturation`` (device-seconds per wall-second).
  * **Memory watermarks** — ``dftpu_cost_watermark_*`` gauges for host RSS
    (+ peak) from ``/proc/self/status`` and device bytes in use (+ peak)
    from ``torch.cuda.memory_stats()``.

The registry, its names, help texts (they name XLA, as the reference's
do: ``GET /metrics`` carries the reference's exposition) and merge notes,
``cost_table`` and ``snapshot`` are the reference's for the same recorded
calls.  Conf block
``monitoring.cost`` (strict: unknown keys raise)::

    monitoring:
      cost:
        enabled: true
        peak_flops: 0.0          # peak FLOP/s; 0 disables the roofline
        peak_bytes_per_s: 0.0    # placement in cost_table
        saturation_window_s: 60

The serve task applies the block (``monitoring/quality.
build_quality_runtime`` calls :func:`configure_cost`); the scorer charges
every predict's dispatch and padding, ``/debug/cost`` serves
:meth:`CostMetrics.snapshot`, and the quality store's scrape persists the
registry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.monitoring.trace import clock

#: cost fields captured per program, in the order the cost table shows
#: them.  Each becomes a ``dftpu_cost_program_<field>`` labeled gauge; the
#: port's kernel counts fill ``flops`` and ``bytes_accessed``.
PROGRAM_FIELDS = (
    "flops",
    "bytes_accessed",
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "peak_bytes",
    "alias_bytes",
)


def work_costs(work: tuple) -> Dict[str, float]:
    """A kernel's ``(float32 operations, bytes)`` count as program costs."""
    ops, nbytes = work
    return {"flops": float(ops), "bytes_accessed": float(nbytes)}


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """The ``monitoring.cost`` conf block."""

    enabled: bool = True
    peak_flops: float = 0.0        # 0: no roofline placement
    peak_bytes_per_s: float = 0.0  # 0: no roofline placement
    saturation_window_s: float = 60.0

    def __post_init__(self):
        if self.saturation_window_s <= 0:
            raise ValueError(
                f"saturation_window_s must be > 0, got "
                f"{self.saturation_window_s}")
        if self.peak_flops < 0:
            raise ValueError(
                f"peak_flops must be >= 0, got {self.peak_flops}")
        if self.peak_bytes_per_s < 0:
            raise ValueError(
                f"peak_bytes_per_s must be >= 0, got "
                f"{self.peak_bytes_per_s}")

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte at which the roofline bends; 0 when peaks unset."""
        if self.peak_flops > 0 and self.peak_bytes_per_s > 0:
            return self.peak_flops / self.peak_bytes_per_s
        return 0.0

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "CostConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like peak_flop must not silently disable the roofline
            raise ValueError(
                f"unknown monitoring.cost conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


def _read_host_rss() -> Dict[str, float]:
    """Current and peak RSS of THIS process, in bytes.

    ``/proc/self/status`` (VmRSS/VmHWM) where available; the ``resource``
    module's maxrss as the peak fallback elsewhere.  No psutil — the
    container doesn't ship it.
    """
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_bytes"] = float(line.split()[1]) * 1024.0
                elif line.startswith("VmHWM:"):
                    out["rss_peak_bytes"] = float(line.split()[1]) * 1024.0
    except OSError:
        pass
    if "rss_peak_bytes" not in out:
        try:
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF)
            # linux reports KiB, macOS bytes; this fallback only runs
            # where /proc is absent, i.e. the latter
            out["rss_peak_bytes"] = float(ru.ru_maxrss)
        except Exception:  # noqa: BLE001
            pass
    return out


def _read_device_memory() -> Dict[str, float]:
    """bytes in use / peak bytes in use of the current CUDA device, from
    ``torch.cuda.memory_stats()`` (the caching allocator's counts); empty
    where no card is in use."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    stats = torch.cuda.memory_stats()
    out: Dict[str, float] = {}
    if "allocated_bytes.all.current" in stats:
        out["device_bytes"] = float(stats["allocated_bytes.all.current"])
    if "allocated_bytes.all.peak" in stats:
        out["device_peak_bytes"] = float(stats["allocated_bytes.all.peak"])
    return out


class CostMetrics:
    """The ``dftpu_cost_*`` registry, one per process.

    Same discipline as :class:`monitor.PipelineMetrics`: every attribute is
    created in ``__init__`` and the metric objects are themselves
    thread-safe.  The only mutable state beyond them is the saturation
    window (``_recent``/``_recent_sum``), guarded by ``_lock`` — readers
    snapshot under the lock, never touch the deque unlocked.

    Fleet merge semantics (serving/fleet.aggregate_prometheus):

      * ``dftpu_cost_device_seconds_total`` / ``_dispatches_total``
        counters and the ``device_saturation`` gauge SUM — work is
        additive across replicas;
      * ``dftpu_cost_watermark_*`` gauges MAX — capacity headroom is set
        by the worst replica;
      * ``dftpu_cost_program_*`` gauges REPLICATE (first replica wins) —
        the fleet shares one AOT store, so every replica reports the same
        program fingerprints and summing would multiply FLOPs by the
        replica count;
      * ``dftpu_cost_padding_waste`` gauges MAX — the pad-row fraction is
        a ratio, so summing would be meaningless; the worst replica is the
        signal (the underlying ``_padding_rows_total`` counters SUM).
    """

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.device_seconds_total = self.registry.labeled_counter(
            "dftpu_cost_device_seconds_total", ("entry", "family"),
            "device-seconds attributed per AOT entry and model family "
            "(dispatch through host pull, span clock)")
        self.dispatches_total = self.registry.labeled_counter(
            "dftpu_cost_dispatches_total", ("entry", "family"),
            "attributed device dispatches per AOT entry and model family")
        self.device_saturation = self.registry.gauge(
            "dftpu_cost_device_saturation",
            "device-seconds consumed per wall-second over the saturation "
            "window (fleet-summed: 2.0 = two devices' worth of work)")
        self.program = {
            field: self.registry.labeled_gauge(
                f"dftpu_cost_program_{field}", ("entry", "key"),
                f"XLA {field.replace('_', ' ')} of the compiled program, "
                f"per AOT entry and shape-bucket key (replicated across a "
                f"fleet sharing one store)")
            for field in PROGRAM_FIELDS
        }
        self.host_rss_bytes = self.registry.gauge(
            "dftpu_cost_watermark_host_rss_bytes",
            "resident set size of this process (fleet: max-merged)")
        self.host_rss_peak_bytes = self.registry.gauge(
            "dftpu_cost_watermark_host_rss_peak_bytes",
            "high-water resident set size of this process "
            "(fleet: max-merged)")
        self.device_bytes = self.registry.gauge(
            "dftpu_cost_watermark_device_bytes",
            "device memory in use, first local device; 0 where the "
            "backend reports none (fleet: max-merged)")
        self.device_peak_bytes = self.registry.gauge(
            "dftpu_cost_watermark_device_peak_bytes",
            "peak device memory in use, first local device "
            "(fleet: max-merged)")
        self.padding_rows_total = self.registry.labeled_counter(
            "dftpu_cost_padding_rows_total", ("entry", "kind"),
            "dispatched batch rows per AOT entry, split kind=real|pad "
            "(pad rows are bucket-ladder fill whose FLOPs are pure waste)")
        self.padding_waste = self.registry.labeled_gauge(
            "dftpu_cost_padding_waste", ("entry",),
            "cumulative fraction of dispatched rows that were bucket "
            "padding, per AOT entry (fleet: max-merged)")
        self.saturation_window_s = 60.0
        self._lock = threading.Lock()
        self._recent: deque = deque()   # (span-clock ts, device_seconds)
        self._recent_sum = 0.0
        self._padding: Dict[str, List[float]] = {}  # entry -> [real+pad, pad]
        self._t0 = clock()
        self._tls = threading.local()
        self._programs_seen: set = set()  # (entry, key) with costs recorded

    # -- attribution ---------------------------------------------------------
    def record_dispatch(self, entry: str, family: str,
                        device_seconds: float, attribute: bool = True) -> None:
        """Attribute one dispatch's device interval; updates the counters,
        the saturation window, and (``attribute``) any open
        :meth:`attribution` scope on this thread.  ``attribute=False`` is
        for a call nested inside a dispatch that a scope already meters
        (``engine/compile_cache.aot_call``): it is counted per entry but
        not twice against the scope.  Two clock reads and a few dict ops —
        cheap enough for the request path."""
        dev = max(float(device_seconds), 0.0)
        self.device_seconds_total.inc(dev, entry=entry, family=family)
        self.dispatches_total.inc(1.0, entry=entry, family=family)
        acc = getattr(self._tls, "acc", None) if attribute else None
        if acc is not None:
            acc["device_seconds"] += dev
            acc["dispatches"] += 1
        now = clock()
        window = self.saturation_window_s
        with self._lock:
            self._recent.append((now, dev))
            self._recent_sum += dev
            floor = now - window
            while self._recent and self._recent[0][0] < floor:
                _, old = self._recent.popleft()
                self._recent_sum -= old
            # a young process has observed less than a full window;
            # dividing by the window would understate load during warmup
            elapsed = min(window, max(now - self._t0, 1e-9))
            saturation = self._recent_sum / elapsed
        self.device_saturation.set(saturation)

    def record_padding(self, entry: str, rows: int, pad_rows: int) -> None:
        """Attribute one dispatch's bucket-ladder padding: ``rows`` total
        batch rows dispatched, of which ``pad_rows`` were ladder fill.
        Updates the split counters and the per-entry cumulative waste
        fraction — the number the kernel round drives down by tightening
        the ladder (pow2 -> pow2x3)."""
        rows = max(int(rows), 0)
        pad = min(max(int(pad_rows), 0), rows)
        if rows == 0:
            return
        self.padding_rows_total.inc(rows - pad, entry=entry, kind="real")
        self.padding_rows_total.inc(pad, entry=entry, kind="pad")
        with self._lock:
            acc = self._padding.setdefault(entry, [0.0, 0.0])
            acc[0] += rows
            acc[1] += pad
            frac = acc[1] / acc[0]
        self.padding_waste.set(frac, entry=entry)

    @contextlib.contextmanager
    def attribution(self):
        """Scope that accumulates this THREAD's recorded dispatches —
        the batcher wraps a merged dispatch in one so the total device
        time lands on its ``batcher.dispatch`` span without threading a
        value through the predictor's return."""
        prev = getattr(self._tls, "acc", None)
        acc = {"device_seconds": 0.0, "dispatches": 0}
        self._tls.acc = acc
        try:
            yield acc
        finally:
            self._tls.acc = prev

    # -- program registry ----------------------------------------------------
    def record_program(self, entry: str, costs: Dict[str, float],
                       key: str = "") -> None:
        """Publish one compiled program's cost analysis.  ``key`` is the
        store fingerprint prefix distinguishing shape buckets of the same
        entry; empty for callers without one (offline tools)."""
        if not costs:
            return
        for field, gauge in self.program.items():
            v = costs.get(field)
            if v is not None and math.isfinite(float(v)):
                gauge.set(float(v), entry=entry, key=key)

    def record_work(self, entry: str, key: str,
                    work: Callable[[], tuple]) -> None:
        """Publish a kernel's ``(operations, bytes)`` count as the program
        costs of (``entry``, ``key``), the first time that pair is seen:
        ``work()`` runs once (a count may read its data, e.g. the mask of
        ``hw_score_work``), later calls cost one set lookup."""
        if (entry, key) in self._programs_seen:
            return
        self._programs_seen.add((entry, key))
        self.record_program(entry, work_costs(work()), key=key)

    # -- watermarks ----------------------------------------------------------
    def sample_watermarks(self) -> None:
        """Refresh the RSS/device-memory gauges.  All file I/O happens
        before any metric is touched and no CostMetrics lock is held —
        the scrape loop calls this on its tick."""
        host = _read_host_rss()
        dev = _read_device_memory()
        if "rss_bytes" in host:
            self.host_rss_bytes.set(host["rss_bytes"])
        if "rss_peak_bytes" in host:
            self.host_rss_peak_bytes.set(host["rss_peak_bytes"])
        if "device_bytes" in dev:
            self.device_bytes.set(dev["device_bytes"])
        if "device_peak_bytes" in dev:
            self.device_peak_bytes.set(dev["device_peak_bytes"])

    # -- the /debug/cost view ------------------------------------------------
    def cost_table(self, config: Optional[CostConfig] = None) -> List[Dict]:
        """Per-(entry, shape-bucket) rows joining the program registry with
        the attribution counters, plus roofline placement when the config
        carries backend peaks.

        Device seconds are attributed per ENTRY (the predictor doesn't see
        the store key), so rows of a multi-bucket entry share the entry's
        dispatch totals and the achieved-FLOP/s estimate uses each row's
        own program FLOPs — an estimate, exact when one bucket dominates.
        """
        config = config or get_cost_config()
        programs: Dict[tuple, Dict[str, float]] = {}
        for field, gauge in self.program.items():
            for label_str, v in gauge.snapshot().items():
                labels = dict(
                    part.partition("=")[::2] for part in label_str.split(","))
                programs.setdefault(
                    (labels.get("entry", ""), labels.get("key", "")), {},
                )[field] = v
        per_entry: Dict[str, Dict[str, float]] = {}
        for counter, out_field in ((self.device_seconds_total,
                                    "device_seconds"),
                                   (self.dispatches_total, "dispatches")):
            for label_str, v in counter.snapshot().items():
                labels = dict(
                    part.partition("=")[::2] for part in label_str.split(","))
                agg = per_entry.setdefault(
                    labels.get("entry", ""),
                    {"device_seconds": 0.0, "dispatches": 0.0,
                     "family": labels.get("family", "")})
                agg[out_field] += v
        rows: List[Dict] = []
        for (entry, key) in sorted(set(programs) | {
                (e, "") for e in per_entry if not any(
                    pe == e for pe, _ in programs)}):
            row: Dict[str, Any] = {"entry": entry, "key": key}
            row.update(programs.get((entry, key), {}))
            stats = per_entry.get(entry)
            if stats:
                row["family"] = stats["family"]
                row["device_seconds"] = stats["device_seconds"]
                row["dispatches"] = stats["dispatches"]
            flops = row.get("flops")
            byts = row.get("bytes_accessed")
            if flops and byts:
                row["operational_intensity"] = flops / byts
            if (stats and stats["device_seconds"] > 0 and flops
                    and stats["dispatches"] > 0):
                row["achieved_flops_per_s"] = (
                    flops * stats["dispatches"] / stats["device_seconds"])
            ridge = config.ridge_intensity
            if ridge and "operational_intensity" in row:
                oi = row["operational_intensity"]
                row["bound"] = "compute" if oi >= ridge else "memory"
                attainable = min(config.peak_flops,
                                 oi * config.peak_bytes_per_s)
                row["attainable_flops_per_s"] = attainable
                if "achieved_flops_per_s" in row and attainable > 0:
                    row["fraction_of_attainable"] = (
                        row["achieved_flops_per_s"] / attainable)
            rows.append(row)
        return rows

    def snapshot(self, config: Optional[CostConfig] = None) -> Dict:
        """The ``GET /debug/cost`` body: config echo, live saturation and
        watermarks, and the per-entry cost table."""
        config = config or get_cost_config()
        self.sample_watermarks()
        return {
            "config": {
                "peak_flops": config.peak_flops,
                "peak_bytes_per_s": config.peak_bytes_per_s,
                "ridge_intensity": config.ridge_intensity,
                "saturation_window_s": self.saturation_window_s,
            },
            "device_saturation": self.device_saturation.value,
            "watermarks": {
                "host_rss_bytes": self.host_rss_bytes.value,
                "host_rss_peak_bytes": self.host_rss_peak_bytes.value,
                "device_bytes": self.device_bytes.value,
                "device_peak_bytes": self.device_peak_bytes.value,
            },
            "entries": self.cost_table(config),
        }


_state_lock = threading.Lock()
_cost_metrics: Optional[CostMetrics] = None
_active_config: Optional[CostConfig] = None


def cost_metrics() -> CostMetrics:
    """Process-wide :class:`CostMetrics` singleton (lazy)."""
    global _cost_metrics
    with _state_lock:
        if _cost_metrics is None:
            _cost_metrics = CostMetrics()
        return _cost_metrics


def configure_cost(config: CostConfig) -> CostMetrics:
    """Apply the ``monitoring.cost`` conf block process-wide (peaks feed
    the /debug/cost roofline; the window resizes the saturation gauge)."""
    global _active_config
    with _state_lock:
        _active_config = config
    cm = cost_metrics()
    cm.saturation_window_s = float(config.saturation_window_s)
    return cm


def get_cost_config() -> CostConfig:
    """The active config; defaults (enabled, no peaks) when no conf block
    has been parsed — attribution is on unless explicitly disabled."""
    with _state_lock:
        return _active_config if _active_config is not None else CostConfig()


__all__ = [
    "PROGRAM_FIELDS",
    "CostConfig",
    "CostMetrics",
    "configure_cost",
    "cost_metrics",
    "get_cost_config",
    "work_costs",
]
