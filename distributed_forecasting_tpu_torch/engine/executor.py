"""The ``pipeline`` conf block and the executor's submit path (port of the
reference's ``engine/executor.py``: :class:`PipelineConfig`,
:class:`ExperimentHandle` and the part of :class:`TrainingExecutor` the
streaming refit uses).

:class:`TrainingExecutor` runs one experiment as three stages:

* **prep** (caller thread): host-side input preparation;
* **dispatch** (caller thread): device work launched without waiting for
  it — on the executor's own CUDA stream when one is given, with an event
  recorded on that stream after it (else on the caller's stream, which
  the writer thread shares);
* **pull + complete** (one writer thread): :func:`device_pull` waits on
  that event, then ``complete`` runs, in submission order.

The writer thread drains in submission order, so completions stay as
ordered as a serial run while the caller preps and dispatches the next
experiment.  A semaphore bounds dispatched-but-uncompleted experiments at
``max_in_flight``.  ``async_tracking: false`` (or ``enabled: false``) runs
every stage inline.  An exception in stage C fails that experiment: it is
stored on the handle (``handle.result()`` re-raises it), kept as the
executor's first error and re-raised from ``flush()`` / ``close()`` and any
later ``submit()``.

The training pipeline does not run on it yet, and the reference's
``PipelineMetrics`` (the ``pipeline_*_seconds`` run metrics, the idle
fraction, the cost charges) and ``prefetch_to_device`` are not here:
ROADMAP Queue 1, P11.  ``tasks/common.Task`` parses the ``pipeline:``
block and logs it as having no effect.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
from typing import Any, Callable, Dict, Optional

import torch

logger = logging.getLogger(__name__)


def device_pull(done) -> None:
    """The sanctioned wait: block until the CUDA event ``done`` (recorded
    after a dispatch) has fired; None (a CPU dispatch, which has finished
    when it returns) waits for nothing."""
    if done is not None:
        done.synchronize()


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Conf-wired knobs for the pipelined training executor, built from the
    ``pipeline:`` conf block by the Task base."""

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

    ``stream``: a ``torch.cuda.Stream`` the dispatch stage runs on (the
    streaming refit passes its own, so a refit's kernels queue beside the
    serving predicts instead of behind them); None runs it on the caller's
    current stream."""

    def __init__(self, config: Optional[PipelineConfig] = None,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.config = config if config is not None else PipelineConfig()
        self.stream = stream
        self._async = bool(self.config.enabled and self.config.async_tracking)
        self._slots = threading.Semaphore(self.config.max_in_flight)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._closed = False
        self._first_error: Optional[BaseException] = None

    def _dispatch(self, dispatch, prepared):
        """Run the dispatch stage on the executor's stream; returns (state,
        the event recorded after it, or None)."""
        if self.stream is None:
            # on the caller's stream, which the writer thread shares: work
            # complete() queues there runs after the dispatch's
            return dispatch(prepared), None
        with torch.cuda.stream(self.stream):
            state = dispatch(prepared)
            done = torch.cuda.Event()
            done.record(self.stream)
        return state, done

    def submit(self, name: str,
               prep: Callable[[], Any],
               dispatch: Callable[[Any], Any],
               complete: Callable[[Any], Any]) -> ExperimentHandle:
        """Run one experiment through the pipeline; returns its handle.

        ``prep()`` -> prepared; ``dispatch(prepared)`` -> state;
        ``complete(state)`` -> result, called after :func:`device_pull` on
        the writer thread (inline when the pipeline is off).  Errors in
        prep / dispatch raise here; errors in complete surface through the
        handle, ``flush`` and ``close``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("TrainingExecutor is closed")
        self._raise_if_failed()
        handle = ExperimentHandle(name)
        if not self._async:
            return self._run_serial(handle, prep, dispatch, complete)
        self._ensure_worker()
        self._slots.acquire()
        try:
            state, done = self._dispatch(dispatch, prep())
        except BaseException:
            self._slots.release()
            raise
        self._queue.put((handle, state, done, complete))
        return handle

    def _run_serial(self, handle, prep, dispatch, complete):
        state, done = self._dispatch(dispatch, prep())
        try:
            device_pull(done)
            handle._finish(result=complete(state))
        except BaseException as exc:
            self._record_error(exc)
            handle._finish(error=exc)
            raise
        return handle

    def _record_error(self, exc: BaseException) -> None:
        with self._lock:
            if self._first_error is None:
                self._first_error = exc

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
            handle, state, done, complete = task
            try:
                device_pull(done)
                handle._finish(result=complete(state))
            except BaseException as exc:  # noqa: BLE001 — must not kill the writer
                logger.exception("pipeline stage C failed for %r", handle.name)
                self._record_error(exc)
                handle._finish(error=exc)
            finally:
                self._slots.release()
                self._queue.task_done()

    def _raise_if_failed(self) -> None:
        with self._lock:
            err = self._first_error
        if err is not None:
            raise err

    def flush(self) -> None:
        """Wait for every submitted experiment's stage C; re-raise errors."""
        self._queue.join()
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
        self._raise_if_failed()

    def __enter__(self) -> "TrainingExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            # the body is already unwinding: drain quietly, keep its error
            with contextlib.suppress(BaseException):
                self.close()
        else:
            self.close()


__all__ = ["ExperimentHandle", "PipelineConfig", "TrainingExecutor",
           "device_pull"]
