"""Pipelined training executor: overlap host prep, device work and I/O
(port of the reference's ``engine/executor.py``).

CUDA launches are asynchronous: a dispatch stage returns while the card
still runs what it queued, and the host waits only where it reads a
result.  :class:`TrainingExecutor` runs each experiment as three stages:

* **stage A — prep** (caller thread): host-side input preparation
  (catalog read, tensorize, config resolution);
* **stage B — dispatch** (caller thread): device work launched without
  waiting for it — on the executor's own CUDA stream when one is given
  (the streaming refit's), else on the caller's current stream — with a
  CUDA event recorded after it where CUDA is in use;
* **stage C — pull + complete** (one writer thread): :func:`device_pull`
  waits on that event — the writer's own stream is another one, so no
  host read of the experiment's results may come before it — then
  ``complete`` runs: host pulls, conformal scaling, artifacts, tracker
  writes, table saves.

Stage C drains on a single writer thread in submission order, so tracking
and catalog writes stay as ordered as the serial path while the caller
thread preps and dispatches the next experiment.  How much overlaps is
what the dispatch stage leaves: a host sync inside it (``.item()``,
``.cpu()``, ``nonzero``) makes the caller wait for the card there.

Knobs (``pipeline:`` conf block, installed by the Task base through
:func:`configure_pipeline`):

* ``max_in_flight`` bounds dispatched-but-uncompleted experiments (the
  caller blocks in ``submit`` at the bound);
* ``prefetch_depth`` is the lookahead of :func:`prefetch_to_device`;
* ``async_tracking: false`` (or ``enabled: false``) runs every stage
  inline — the serial reference the byte-identity tests compare against.

Every experiment's four stages are timed (``pipeline_*_seconds``,
:class:`~distributed_forecasting_tpu_torch.monitoring.monitor.PipelineMetrics`),
traced as ``pipeline.*`` spans under one trace id across both threads, and
its dispatch-to-pull interval is charged to the cost registry.

Error contract: an exception in stage C fails that experiment — it is stored
on the handle (``handle.result()`` re-raises it), kept as the executor's
first error and re-raised from ``flush()`` / ``close()`` and any later
``submit()``.  ``close()`` is idempotent; as a context manager the executor
keeps the body's own exception when the body is already unwinding.

The pipelined path's contract is byte-identical outputs to the serial
path: what each experiment computes is unchanged, only when the host
waits moves.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from distributed_forecasting_tpu_torch.monitoring.trace import (
    TraceContext,
    device_annotation,
    get_tracer,
    new_trace_id,
)

logger = logging.getLogger(__name__)


def sanctioned_pull(fn):
    """Mark ``fn`` as a sanctioned device-synchronization point: the one
    function of a path that is supposed to block.  The marker attribute
    lets runtime code and tests check the annotation."""
    fn.__dftpu_sanctioned_pull__ = True
    return fn


@sanctioned_pull
def device_pull(done) -> None:
    """THE sanctioned wait: block until the CUDA event ``done`` (recorded
    after a dispatch) has fired; None (a dispatch that queued nothing on a
    card) waits for nothing."""
    if done is not None:
        done.synchronize()


def _record_done(stream=None):
    """An event recorded on ``stream`` (default: the current one) after a
    dispatch, or None where this process has not used CUDA."""
    if stream is None and not torch.cuda.is_initialized():
        return None
    done = torch.cuda.Event()
    done.record(stream)
    return done


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Conf-wired knobs for the pipelined training executor, built from the
    ``pipeline:`` conf block by the Task base and installed process-wide
    with :func:`configure_pipeline`."""

    enabled: bool = True
    max_in_flight: int = 2
    prefetch_depth: int = 1
    async_tracking: bool = True

    def __post_init__(self):
        if self.max_in_flight < 1:
            raise ValueError(
                f"pipeline.max_in_flight must be >= 1, got {self.max_in_flight}")
        if self.prefetch_depth < 0:
            raise ValueError(
                f"pipeline.prefetch_depth must be >= 0, got {self.prefetch_depth}")

    @classmethod
    def from_conf(cls, conf: Optional[Dict[str, Any]]) -> "PipelineConfig":
        if conf is None:
            return cls()
        if not isinstance(conf, dict):
            raise ValueError(f"pipeline conf must be a mapping, got {type(conf)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            raise ValueError(
                f"unknown pipeline conf keys: {sorted(unknown)} "
                f"(known: {sorted(known)})")
        return cls(
            enabled=bool(conf.get("enabled", True)),
            max_in_flight=int(conf.get("max_in_flight", 2)),
            prefetch_depth=int(conf.get("prefetch_depth", 1)),
            async_tracking=bool(conf.get("async_tracking", True)),
        )


_config_lock = threading.Lock()
_config: PipelineConfig = PipelineConfig()


def configure_pipeline(config: PipelineConfig) -> PipelineConfig:
    """Install ``config`` as the process-wide pipeline configuration."""
    global _config
    with _config_lock:
        _config = config
    return config


def pipeline_config() -> PipelineConfig:
    """Current process-wide :class:`PipelineConfig`."""
    with _config_lock:
        return _config


class ExperimentHandle:
    """Future-like handle for one submitted experiment."""

    def __init__(self, name: str):
        self.name = name
        self._done = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def _finish(self, result: Any = None,
                error: Optional[BaseException] = None) -> None:
        self._result = result
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until the experiment completes; re-raise its stage-C error."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"experiment {self.name!r} not complete after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


_STOP = object()


class TrainingExecutor:
    """Bounded three-stage pipeline over independent experiments.

    ``submit(name, prep, dispatch, complete)`` runs ``prep`` and
    ``dispatch`` on the caller thread (stages A/B), then hands the
    dispatched state to the single writer thread, which runs
    :func:`device_pull` and ``complete`` (stage C) in submission order.
    A semaphore bounds dispatched-but-uncompleted experiments at
    ``max_in_flight``.

    ``stream``: a ``torch.cuda.Stream`` the dispatch stage runs on (the
    streaming refit passes its own, so a refit's kernels queue beside the
    serving predicts instead of behind them); None runs it on the caller's
    current stream.  ``metrics``: the :class:`PipelineMetrics` to observe
    (default the process-wide one)."""

    def __init__(self, config: Optional[PipelineConfig] = None,
                 metrics: Optional[Any] = None,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.config = config if config is not None else pipeline_config()
        if metrics is None:
            from distributed_forecasting_tpu_torch.monitoring.monitor import (
                pipeline_metrics,
            )
            metrics = pipeline_metrics()
        self.metrics = metrics
        self.stream = stream
        self._async = bool(self.config.enabled and self.config.async_tracking)
        self._slots = threading.Semaphore(self.config.max_in_flight)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._closed = False
        self._first_error: Optional[BaseException] = None
        self._in_flight = 0
        # device-occupancy accounting: union of [dispatch start, pull end]
        # intervals on the host clock (the device may finish before the
        # pull observes it, so the idle fraction is a lower bound)
        self._busy_seconds = 0.0
        self._busy_until: Optional[float] = None
        self._first_dispatch: Optional[float] = None
        self._last_pull: Optional[float] = None
        self._stage_totals: Dict[str, float] = {
            "prep": 0.0, "dispatch": 0.0, "pull": 0.0, "complete": 0.0}
        self._n_submitted = 0
        self._n_completed = 0

    # -- accounting -------------------------------------------------------

    def _record_dispatch(self, t_start: float) -> None:
        with self._lock:
            if self._first_dispatch is None:
                self._first_dispatch = t_start

    def _record_pull_end(self, t_end: float, t_dispatch: float) -> None:
        """Add the experiment's [dispatch start, pull end] interval to the
        busy union.  Pulls end in submission order and dispatches start in
        it, so the intervals arrive sorted by start: each adds what it
        reaches past the union's end."""
        with self._lock:
            start = t_dispatch if self._busy_until is None else max(
                t_dispatch, self._busy_until)
            if t_end > start:
                self._busy_seconds += t_end - start
                self._busy_until = t_end
            self._last_pull = t_end

    def _record_device_seconds(self, name: str, seconds: float) -> None:
        # per-experiment device-time attribution (monitoring/cost.py)
        from distributed_forecasting_tpu_torch.monitoring.cost import (
            cost_metrics,
        )

        cost_metrics().record_dispatch("pipeline.dispatch", name, seconds)

    def _observe(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._stage_totals[stage] += seconds
        self.metrics.observe_stage(stage, seconds)

    def _set_in_flight(self, delta: int) -> None:
        with self._lock:
            self._in_flight += delta
            self.metrics.set_in_flight(self._in_flight)

    # -- submission -------------------------------------------------------

    def _dispatch(self, dispatch, prepared):
        """Run the dispatch stage; returns (state, the event recorded after
        it, or None)."""
        if self.stream is None:
            return dispatch(prepared), _record_done()
        with torch.cuda.stream(self.stream):
            state = dispatch(prepared)
            done = _record_done(self.stream)
        return state, done

    def _prep_and_dispatch(self, name, prep, dispatch, ctx):
        """Stages A and B on the caller thread, timed and traced; returns
        (state, done event, dispatch start)."""
        tracer = get_tracer()
        t0 = time.perf_counter()
        with tracer.span("pipeline.prep", ctx=ctx, experiment=name):
            prepared = prep()
        t1 = time.perf_counter()
        self._observe("prep", t1 - t0)
        self._record_dispatch(t1)
        with tracer.span("pipeline.dispatch", ctx=ctx, experiment=name):
            with device_annotation(f"pipeline_dispatch:{name}"):
                state, done = self._dispatch(dispatch, prepared)
        t2 = time.perf_counter()
        self._observe("dispatch", t2 - t1)
        return state, done, (t0, t1, t2)

    def submit(self, name: str,
               prep: Callable[[], Any],
               dispatch: Callable[[Any], Any],
               complete: Callable[[Any], Any]) -> ExperimentHandle:
        """Run one experiment through the pipeline; returns its handle.

        ``prep()`` -> prepared; ``dispatch(prepared)`` -> state (with work
        in flight on the card); ``complete(state)`` -> result, called after
        :func:`device_pull` on the writer thread (inline when the pipeline
        is off).  Errors in prep / dispatch raise here; errors in complete
        surface through the handle, ``flush`` and ``close``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("TrainingExecutor is closed")
            self._n_submitted += 1
        self._raise_if_failed()
        self.metrics.inc_experiments()
        handle = ExperimentHandle(name)
        ctx = self._experiment_ctx()
        if not self._async:
            return self._run_serial(handle, prep, dispatch, complete, ctx)
        self._ensure_worker()
        self._slots.acquire()
        try:
            state, done, (_, t1, _) = self._prep_and_dispatch(
                name, prep, dispatch, ctx)
        except BaseException:
            self._slots.release()
            raise
        self._set_in_flight(+1)
        # ctx rides along so the writer's pull / complete spans join this
        # thread's prep / dispatch spans in one trace; t1 (dispatch start)
        # so the writer charges the whole dispatch-to-drain interval
        self._queue.put((handle, state, done, complete, ctx, t1))
        return handle

    def _experiment_ctx(self) -> Optional[TraceContext]:
        """One trace per experiment: the caller's current context when a
        span is open (run_many under an outer span), a fresh trace id
        otherwise — so an experiment's four stage spans share one trace id
        although they run on two threads."""
        tracer = get_tracer()
        if not tracer.enabled:
            return None
        ctx = tracer.current()
        if ctx is None:
            ctx = TraceContext(new_trace_id(), None)
        return ctx

    def _pull_and_complete(self, handle, state, done, complete, ctx,
                           t_dispatch: float, stage_ab=None):
        """Stage C: the sanctioned pull, then ``complete``, timed and
        traced; returns complete's result."""
        tracer = get_tracer()
        t0 = time.perf_counter()
        # pull = the queue wait and the device wait of this experiment: it
        # starts when the writer takes the task and ends when the card has
        # run everything the dispatch queued
        with tracer.span("pipeline.pull", ctx=ctx,
                         experiment=handle.name) as pull_span:
            device_pull(done)
            t1 = time.perf_counter()
            pull_span.set_attribute("device_seconds", t1 - t_dispatch)
        self._record_pull_end(t1, t_dispatch)
        self._observe("pull", t1 - t0)
        self._record_device_seconds(handle.name, t1 - t_dispatch)
        prep_s, dispatch_s = stage_ab or (0.0, 0.0)
        self._inject_stage_seconds(state, prep_s, dispatch_s, t1 - t0)
        with tracer.span("pipeline.complete", ctx=ctx,
                         experiment=handle.name):
            result = complete(state)
        self._observe("complete", time.perf_counter() - t1)
        with self._lock:
            self._n_completed += 1
        return result

    def _run_serial(self, handle: ExperimentHandle, prep, dispatch,
                    complete, ctx=None) -> ExperimentHandle:
        # the inline reference path: the same stages and accounting, no
        # thread — what the byte-identity tests compare against
        state, done, (t0, t1, t2) = self._prep_and_dispatch(
            handle.name, prep, dispatch, ctx)
        try:
            result = self._pull_and_complete(
                handle, state, done, complete, ctx, t1,
                stage_ab=(t1 - t0, t2 - t1))
            handle._finish(result=result)
        except BaseException as exc:
            self._record_error(exc)
            handle._finish(error=exc)
            raise
        return handle

    def _inject_stage_seconds(self, state: Any, prep_s: float,
                              dispatch_s: float, pull_s: float) -> None:
        # per-stage timings to the completion closure (which merges them
        # into the run's metrics) without widening its signature; timing
        # metrics are outside the byte-identity contract
        if isinstance(state, dict):
            state["pipeline_stage_seconds"] = {
                "prep": prep_s, "dispatch": dispatch_s, "pull": pull_s}

    def _record_error(self, exc: BaseException) -> None:
        self.metrics.inc_errors()
        with self._lock:
            if self._first_error is None:
                self._first_error = exc

    # -- writer thread ----------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain, name="dftpu-pipeline-writer",
                    daemon=True)
                self._worker.start()

    def _drain(self) -> None:
        while True:
            task = self._queue.get()
            if task is _STOP:
                self._queue.task_done()
                return
            handle, state, done, complete, ctx, t_dispatch = task
            try:
                handle._finish(result=self._pull_and_complete(
                    handle, state, done, complete, ctx, t_dispatch))
            except BaseException as exc:  # noqa: BLE001 — must not kill the writer
                logger.exception("pipeline stage C failed for %r", handle.name)
                self._record_error(exc)
                handle._finish(error=exc)
            finally:
                self._set_in_flight(-1)
                self._slots.release()
                self._queue.task_done()

    # -- lifecycle --------------------------------------------------------

    def _raise_if_failed(self) -> None:
        with self._lock:
            err = self._first_error
        if err is not None:
            raise err

    def flush(self) -> None:
        """Wait for every submitted experiment's stage C; re-raise errors."""
        self._queue.join()
        self.metrics.set_device_idle_fraction(self.device_idle_fraction())
        self._raise_if_failed()

    def close(self) -> None:
        """Drain, stop the writer thread, re-raise the first stage-C error.
        Idempotent; after the first call ``submit`` raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
        if worker is not None:
            self._queue.put(_STOP)
            worker.join()
        self.metrics.set_device_idle_fraction(self.device_idle_fraction())
        self._raise_if_failed()

    def __enter__(self) -> "TrainingExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            # the body is already unwinding: drain quietly, keep its error
            try:
                self.close()
            except BaseException:  # noqa: BLE001 — deliberate: keep the body's
                logger.exception("pipeline close raised during unwind")
        else:
            self.close()

    # -- metrics ----------------------------------------------------------

    def device_idle_fraction(self) -> float:
        """Fraction of the first-dispatch -> last-pull window the device sat
        idle.  Busy time is the union of per-experiment [dispatch start,
        pull end] intervals on the host clock — an over-estimate of
        busyness (the device may drain before the pull observes it), so the
        idle fraction is a lower bound.  0.0 before any experiment
        completes.  (The reference's accounting moves the union's end to a
        later dispatch's start while an earlier experiment is still
        running, dropping that stretch; the port takes the union as its
        definition says: ROADMAP Queue 3.)"""
        with self._lock:
            if self._first_dispatch is None or self._last_pull is None:
                return 0.0
            window = self._last_pull - self._first_dispatch
            if window <= 0.0:
                return 0.0
            return max(0.0, min(1.0, 1.0 - self._busy_seconds / window))

    def stage_metrics(self) -> Dict[str, float]:
        """Aggregate per-stage seconds plus occupancy numbers (the
        reference's keys)."""
        with self._lock:
            out = {f"pipeline_{k}_seconds": round(v, 4)
                   for k, v in self._stage_totals.items()}
            out["pipeline_n_experiments"] = float(self._n_submitted)
            out["pipeline_n_completed"] = float(self._n_completed)
            out["pipeline_max_in_flight"] = float(self.config.max_in_flight)
            out["pipeline_async"] = 1.0 if self._async else 0.0
        out["pipeline_device_idle_fraction"] = round(
            self.device_idle_fraction(), 4)
        return out


def _place_on(device):
    """``place`` for :func:`prefetch_to_device`: numpy arrays and tensors
    (or a tuple of them) copied to ``device``, from pinned host memory with
    non-blocking copies on the card."""
    pin = torch.device(device).type == "cuda"

    def to_device(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def place(item):
        if isinstance(item, tuple):
            return tuple(to_device(a) for a in item)
        return to_device(item)

    return place


def prefetch_to_device(items: Iterable[Any], depth: Optional[int] = None,
                       place: Optional[Callable[[Any], Any]] = None,
                       device=None) -> Iterator[Any]:
    """Copies of ``items`` on ``device`` (default the card), issued up to
    ``depth`` items ahead of the consumer (default the pipeline config's
    ``prefetch_depth``): a copy from pinned memory does not block the host,
    so the next items are assembled while the card computes.  ``depth=0``
    places each item as it is taken.  Order is preserved.  ``place``
    replaces the copy (an item in, its placed form out)."""
    if depth is None:
        depth = pipeline_config().prefetch_depth
    if place is None:
        from distributed_forecasting_tpu_torch.utils.device import (
            resolve_device,
        )
        place = _place_on(resolve_device(device))
    tracer = get_tracer()
    buf: "collections.deque" = collections.deque()
    for item in items:
        # the span times the host's issue of the copy (non-blocking)
        with tracer.span("pipeline.prefetch", depth=depth):
            buf.append(place(item))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


__all__ = [
    "ExperimentHandle",
    "PipelineConfig",
    "TrainingExecutor",
    "configure_pipeline",
    "device_pull",
    "pipeline_config",
    "prefetch_to_device",
    "sanctioned_pull",
]
