"""Micro-batching request coalescer (port of the reference's
``serving/batcher.py``).

The scorer's HTTP surface serves each connection on a worker thread, so N
concurrent clients would mean N small predicts contending for one card,
each paying its own launches and host round trip.  This module merges them:

  * handler threads ``submit()`` parsed requests into a bounded queue and
    wait on a ``Future`` (admission control: a request past
    ``max_queue_depth`` is refused at once — the server answers 429 — and a
    request that outlives ``request_timeout_s`` fails with ``TimeoutError``
    — 503);
  * ONE scheduler thread drains the queue each tick (waiting at most
    ``max_wait_ms`` after the first arrival, less what that request already
    waited, or until ``max_batch_size`` are pending), groups the drained
    requests by signature ``(horizon, include_history, quantiles,
    on_missing)``, concatenates each group's series keys into one merged
    ``predict`` / ``predict_quantiles`` call and scatters each request's
    rows back through its future (``predictor.result_block_index``);
  * the scatter relies on a series' rows being bit-identical whatever the
    request's size bucket, so requests merge only when the forecaster
    declares ``coalesce_safe`` (``BatchForecaster`` does; composites reorder
    rows by member family and go through the same scheduler one request a
    dispatch, with the same admission control, timeouts and metrics).
    Requests carrying ``xreg`` never merge: two requests' regressor tensors
    have no defined concatenation.

Failure isolation: when a merged call raises (say one request's unknown key
under ``on_missing='raise'``), each request of it is retried alone, so a
poisoned request cannot fail its neighbours.  This is the reference's rule
for bad requests; nothing falls back to another device.

Telemetry uses the Prometheus primitives of ``monitoring/monitor.py`` and is
rendered by the server's ``GET /metrics``: request, dispatch, rejection and
timeout counters, a queue-depth gauge, latency and batch-size histograms.
The reference's spans and thread-sanitizer hooks are not here (ROADMAP
Queue 1: P11, P12), nor are the compile-cache, training-pipeline and cost
registries it appends to ``/metrics`` (P11).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import pandas as pd

from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.serving.predictor import result_block_index
from distributed_forecasting_tpu_torch.utils.logging import get_logger


class QueueFullError(RuntimeError):
    """Admission control: the pending queue is at max_queue_depth (-> 429)."""


class ShuttingDownError(RuntimeError):
    """The batcher stopped accepting work (server shutdown in progress)."""


# latency: sub-millisecond hits through multi-second cold starts
_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# coalesced requests per dispatch
_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class ServingMetrics:
    """The scorer's live telemetry, one registry per server process (the
    reference's names, help texts and buckets).  The server counts request
    outcomes (it owns the HTTP status), the batcher dispatches, batch sizes
    and queue depth."""

    def __init__(self) -> None:
        r = MetricsRegistry()
        self.registry = r
        self.requests = r.counter(
            "serving_requests_total", "POST /invocations requests received")
        self.rejections = r.counter(
            "serving_rejections_total",
            "requests rejected by admission control (HTTP 429)")
        self.timeouts = r.counter(
            "serving_timeouts_total",
            "requests that exceeded request_timeout_s (HTTP 503)")
        self.errors = r.counter(
            "serving_errors_total", "requests that failed with HTTP 500")
        self.deadline_shed = r.counter(
            "serving_deadline_shed_total",
            "requests shed before dispatch because their X-Deadline-Ms "
            "budget was already exhausted (HTTP 503)")
        self.dispatches = r.counter(
            "serving_dispatches_total",
            "forecaster predict calls (coalesced device dispatches)")
        self.queue_depth = r.gauge(
            "serving_queue_depth", "requests waiting in the batching queue")
        self.http_workers_busy = r.gauge(
            "dftpu_http_workers_busy",
            "HTTP pool workers currently handling a request (fleet mode: "
            "summed across replicas — per-replica busy counts are additive)")
        self.latency = r.histogram(
            "serving_request_latency_seconds", _LATENCY_BUCKETS,
            "request latency, parse to response")
        self.batch_size = r.histogram(
            "serving_batch_size", _BATCH_BUCKETS,
            "requests coalesced into each dispatch")

    def render(self) -> str:
        return self.registry.render_prometheus()

    def snapshot(self) -> dict:
        return self.registry.snapshot()


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """The ``serving.batching`` conf block (tasks/serve.py)."""

    enabled: bool = False
    max_batch_size: int = 64      # requests merged into one dispatch
    max_wait_ms: float = 5.0      # coalescing window after first arrival
    max_queue_depth: int = 256    # admission-control bound (429 past it)
    request_timeout_s: float = 30.0

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {self.max_batch_size}")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.request_timeout_s <= 0:
            raise ValueError(
                f"request_timeout_s must be > 0, got {self.request_timeout_s}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "BatchingConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like max_batchsize must not silently serve unbatched
            raise ValueError(
                f"unknown batching conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        return cls(
            enabled=bool(conf.get("enabled", False)),
            max_batch_size=int(conf.get("max_batch_size", 64)),
            max_wait_ms=float(conf.get("max_wait_ms", 5.0)),
            max_queue_depth=int(conf.get("max_queue_depth", 256)),
            request_timeout_s=float(conf.get("request_timeout_s", 30.0)),
        )


@dataclasses.dataclass
class _Pending:
    frame: pd.DataFrame
    horizon: int
    include_history: bool
    quantiles: Optional[tuple]
    on_missing: str
    xreg: object
    future: Future
    enqueued_at: float
    deadline: float

    def signature(self, coalesce_safe: bool):
        """Requests merge iff their predict call and merge semantics match;
        xreg and forecasters that cannot merge get groups of their own."""
        if not coalesce_safe or self.xreg is not None:
            return ("solo", id(self))
        return (self.horizon, self.include_history, self.quantiles,
                self.on_missing)


class RequestBatcher:
    """Background scheduler draining a bounded queue into merged dispatches."""

    def __init__(self, forecaster, config: BatchingConfig,
                 metrics: Optional[ServingMetrics] = None):
        self.forecaster = forecaster
        self.config = config
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.logger = get_logger("RequestBatcher")
        self._coalesce_safe = bool(getattr(forecaster, "coalesce_safe", False))
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="dftpu-batcher", daemon=True)
        self._thread.start()

    # -- producer side (handler threads) ------------------------------------
    def submit(
        self,
        frame: pd.DataFrame,
        horizon: int = 90,
        include_history: bool = False,
        quantiles: Optional[tuple] = None,
        on_missing: str = "raise",
        xreg=None,
    ) -> Future:
        """Enqueue a parsed request; the returned future resolves to the
        result frame (or the exception a solo call would have raised)."""
        now = time.monotonic()
        item = _Pending(
            frame=frame,
            horizon=int(horizon),
            include_history=bool(include_history),
            quantiles=None if quantiles is None else tuple(quantiles),
            on_missing=on_missing,
            xreg=xreg,
            future=Future(),
            enqueued_at=now,
            deadline=now + self.config.request_timeout_s,
        )
        with self._cond:
            if self._closed:
                raise ShuttingDownError("server is shutting down")
            if len(self._queue) >= self.config.max_queue_depth:
                raise QueueFullError(
                    f"request queue is full "
                    f"({self.config.max_queue_depth} pending)")
            self._queue.append(item)
            self.metrics.queue_depth.set(len(self._queue))
            self._cond.notify()
        return item.future

    def close(self, timeout: float = 60.0) -> None:
        """Stop accepting work and DRAIN: everything already queued is
        dispatched and its future resolved before this returns."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():  # pragma: no cover - stuck device call
            self.logger.warning("batcher thread did not drain within %.1fs",
                                timeout)

    @property
    def accepting(self) -> bool:
        """False once close() has started — the server's /readyz input."""
        with self._cond:
            return not self._closed

    # -- scheduler side ------------------------------------------------------
    def _run(self) -> None:
        cfg = self.config
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._queue or self._closed)
                if not self._queue:
                    return  # closed and drained
                # coalescing window: measured from the FIRST waiter's arrival
                # (it may already have sat out a whole dispatch), cut short
                # when a full batch is pending or shutdown starts
                first = self._queue[0]
                budget = (first.enqueued_at + cfg.max_wait_ms / 1000.0
                          - time.monotonic())
                if budget > 0 and not self._closed:
                    self._cond.wait_for(
                        lambda: len(self._queue) >= cfg.max_batch_size
                        or self._closed,
                        timeout=budget,
                    )
                batch = list(self._queue)
                self._queue.clear()
                self.metrics.queue_depth.set(0)
            self._process(batch)

    def _process(self, batch: list) -> None:
        now = time.monotonic()
        live: dict = {}
        for item in batch:
            if now > item.deadline:
                # expired while queued: fail fast instead of spending a
                # dispatch on a response nobody is waiting for
                item.future.set_exception(TimeoutError(
                    f"request timed out after "
                    f"{self.config.request_timeout_s:g}s in queue"))
                continue
            live.setdefault(item.signature(self._coalesce_safe), []).append(item)
        for group in live.values():
            for i in range(0, len(group), self.config.max_batch_size):
                self._dispatch(group[i : i + self.config.max_batch_size])

    def _call(self, item: _Pending, frame: pd.DataFrame) -> pd.DataFrame:
        self.metrics.dispatches.inc()
        if item.quantiles is not None:
            return self.forecaster.predict_quantiles(
                frame,
                quantiles=item.quantiles,
                horizon=item.horizon,
                include_history=item.include_history,
                on_missing=item.on_missing,
                xreg=item.xreg,
            )
        return self.forecaster.predict(
            frame,
            horizon=item.horizon,
            include_history=item.include_history,
            on_missing=item.on_missing,
            xreg=item.xreg,
        )

    def _dispatch(self, chunk: list) -> None:
        self.metrics.batch_size.observe(len(chunk))
        if len(chunk) == 1:
            item = chunk[0]
            try:
                item.future.set_result(self._call(item, item.frame))
            except Exception as e:  # noqa: BLE001 - scatter to the waiter
                item.future.set_exception(e)
            return
        try:
            self._dispatch_merged(chunk)
        except Exception:  # noqa: BLE001
            # isolation: one poisoned request (an unknown key under
            # on_missing='raise', a payload the parser let through) must
            # not fail its coalesced neighbours — retry each alone
            self.logger.exception(
                "merged dispatch of %d requests failed; retrying solo",
                len(chunk))
            for item in chunk:
                try:
                    item.future.set_result(self._call(item, item.frame))
                except Exception as e:  # noqa: BLE001
                    item.future.set_exception(e)

    def _dispatch_merged(self, chunk: list) -> None:
        names = list(self.forecaster.key_names)
        per_request = [
            list(dict.fromkeys(
                tuple(r) for r in item.frame[names].itertuples(index=False)))
            for item in chunk
        ]
        merged_keys = list(dict.fromkeys(
            k for keys in per_request for k in keys))
        merged = pd.DataFrame(merged_keys, columns=names)
        out = self._call(chunk[0], merged)
        T, block_of = result_block_index(out, names)
        for item, keys in zip(chunk, per_request):
            blocks = [
                out.iloc[block_of[k] * T : (block_of[k] + 1) * T]
                for k in keys
                if k in block_of  # on_missing='skip' drops unknown keys
            ]
            if len(blocks) == 1:
                # the common one-series request: slice, don't concatenate
                # (the scatter runs on the one scheduler thread, so its cost
                # per request bounds coalesced throughput)
                part = blocks[0].reset_index(drop=True)
            elif blocks:
                part = pd.concat(blocks, ignore_index=True)
            else:
                part = out.iloc[0:0].reset_index(drop=True)
            item.future.set_result(part)
