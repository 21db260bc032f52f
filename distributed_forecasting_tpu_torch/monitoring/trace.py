"""End-to-end tracing: correlated spans, a flight recorder and profiler
hooks (port of the reference's ``monitoring/trace.py``).

Aggregates (the Prometheus registries on ``GET /metrics``) cannot say where
the time of ONE slow experiment or request went.  This module is the
per-span decomposition layer:

* :class:`Tracer` — a thread-safe span API.  ``with tracer.span("name",
  k=v):`` opens a timed span nested under the thread's enclosing one (a
  per-thread context stack); ``tracer.context(ctx)`` adopts a
  :class:`TraceContext` on another thread (the training executor's writer
  thread), so one trace id follows an experiment across threads;
* :class:`FlightRecorder` — a bounded ring of the most recent completed
  spans, one short lock an append and no I/O, dumpable after the fact
  (:func:`dump_flight_recorder`);
* exporters — a streaming JSONL log (``jsonl_path``, off by default; one
  writer thread owns the file) and the Chrome trace / Perfetto rendering
  (:func:`to_chrome_trace`, one lane a thread);
* device correlation — :func:`device_annotation` is
  ``torch.profiler.record_function``: a host span's name marks the
  device timeline of a ``torch.profiler`` (Kineto) capture, and costs next
  to nothing when no capture runs.  :class:`ProfilerSession` runs one
  single-flight ``torch.profiler.profile`` capture (CPU and, on a card,
  CUDA activities) and exports its Chrome trace under ``profile_dir``.

Span timestamps read one monotonic clock (:data:`clock`), so spans of
different threads line up; wall-clock time appears only in dump file names
and metadata.  Span records, the JSONL lines and the Chrome trace are the
reference's byte for byte for the same spans.  The span kinds this package
opens are those of ``docs/observability.md``'s span catalog.

Conf (``serving.tracing``)::

    tracing:
      enabled: true            # span recording into the flight recorder
      ring_size: 4096          # flight-recorder capacity (completed spans)
      jsonl_path: null         # streaming JSONL export (off by default)
      dump_dir: null           # flight-recorder dumps
      debug_endpoints: false   # /debug/trace + /debug/profile
      profile_dir: null        # torch.profiler capture root
      max_profile_seconds: 60

The serve task configures the process-wide tracer from the block
(:func:`configure_tracing`); the training path and the scorer record into
it, and the scorer's ``/debug/trace`` and ``/debug/profile`` read it.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import json
import os
import queue
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: THE trace clock.  Everything that feeds span start/end times must read
#: this clock (the batcher's ``enqueued_at`` does), so explicitly-timed
#: spans (queue waits) line up with context-manager spans on one timeline.
clock = time.monotonic

_span_ids = itertools.count(1)
_dump_ids = itertools.count(1)


def new_trace_id() -> str:
    """Process-unique, collision-safe trace id (16 hex chars)."""
    return uuid.uuid4().hex[:16]


class TraceContext(Tuple):
    """Immutable (trace_id, span_id) pair — what crosses thread boundaries."""

    __slots__ = ()

    def __new__(cls, trace_id: str, span_id: Optional[str]):
        return super().__new__(cls, (trace_id, span_id))

    @property
    def trace_id(self) -> str:
        return self[0]

    @property
    def span_id(self) -> Optional[str]:
        return self[1]


@dataclasses.dataclass
class SpanRecord:
    """One completed span: the unit the recorder stores and exporters emit."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float            # trace-clock seconds (time.monotonic)
    end: float
    thread_id: int
    thread_name: str
    attrs: Dict[str, Any]
    status: str = "ok"

    @property
    def duration_s(self) -> float:
        return self.end - self.start

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_ms": round(1e3 * (self.end - self.start), 4),
            "thread_id": self.thread_id,
            "thread": self.thread_name,
            "status": self.status,
            "attrs": self.attrs,
        }


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """The ``serving.tracing`` conf block (tasks/serve.py)."""

    enabled: bool = True
    ring_size: int = 4096
    jsonl_path: Optional[str] = None
    dump_dir: Optional[str] = None
    debug_endpoints: bool = False
    profile_dir: Optional[str] = None
    max_profile_seconds: float = 60.0

    def __post_init__(self):
        if self.ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {self.ring_size}")
        if self.max_profile_seconds <= 0:
            raise ValueError(
                f"max_profile_seconds must be > 0, got "
                f"{self.max_profile_seconds}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "TraceConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like dumpdir must not silently disable auto-dumps
            raise ValueError(
                f"unknown tracing conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        return cls(
            enabled=bool(conf.get("enabled", True)),
            ring_size=int(conf.get("ring_size", 4096)),
            jsonl_path=conf.get("jsonl_path"),
            dump_dir=conf.get("dump_dir"),
            debug_endpoints=bool(conf.get("debug_endpoints", False)),
            profile_dir=conf.get("profile_dir"),
            max_profile_seconds=float(conf.get("max_profile_seconds", 60.0)),
        )


class FlightRecorder:
    """Bounded ring buffer of the most recent completed spans.

    Append is one short lock around a ``deque`` push — never I/O — so it is
    safe on every hot path.  ``snapshot()`` copies under the lock and all
    serialization happens on the copy, outside it.
    """

    def __init__(self, ring_size: int = 4096):
        self._ring: deque = deque(maxlen=int(ring_size))
        self._lock = threading.Lock()

    def record(self, span: SpanRecord) -> None:
        with self._lock:
            self._ring.append(span)

    def snapshot(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_JSONL_STOP = object()


class _JsonlWriter:
    """Streaming JSONL exporter: spans go through an unbounded queue to one
    daemon writer thread, which owns the file handle — producers never touch
    the filesystem (and never block: the queue is unbounded, so a slow disk
    backs up memory, not the serving path)."""

    def __init__(self, path: str):
        self.path = path
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="dftpu-trace-jsonl", daemon=True)
        self._thread.start()

    def submit(self, span: SpanRecord) -> None:
        self._q.put(span)

    def _run(self) -> None:
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        with open(self.path, "a") as f:
            while True:
                item = self._q.get()
                if item is _JSONL_STOP:
                    f.flush()
                    return
                f.write(json.dumps(item.to_json()) + "\n")

    def close(self, timeout: float = 5.0) -> None:
        self._q.put(_JSONL_STOP)
        self._thread.join(timeout)


class _NoopSpan:
    """Shared do-nothing span: the entire disabled-tracing fast path."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attribute(self, key: str, value: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class Span:
    """A live span: context manager that records itself when it closes."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "start", "status")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = f"{next(_span_ids):x}"
        self.parent_id = parent_id
        self.attrs = attrs
        self.start = 0.0
        self.status = "ok"

    def set_attribute(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.start = clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = clock()
        self._tracer._pop(self)
        if exc_type is not None:
            self.status = f"error:{exc_type.__name__}"
        t = threading.current_thread()
        self._tracer._finish(SpanRecord(
            name=self.name,
            trace_id=self.trace_id,
            span_id=self.span_id,
            parent_id=self.parent_id,
            start=self.start,
            end=end,
            thread_id=t.ident or 0,
            thread_name=t.name,
            attrs=self.attrs,
            status=self.status,
        ))
        return False


class _ContextFrame:
    """Adopting another thread's TraceContext: pushes a parent-only frame."""

    __slots__ = ("_tracer", "_ctx")

    def __init__(self, tracer: "Tracer", ctx: Optional[TraceContext]):
        self._tracer = tracer
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        if self._ctx is not None:
            self._tracer._push(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> bool:
        if self._ctx is not None:
            self._tracer._pop(self._ctx)
        return False


class Tracer:
    """Thread-safe span factory + flight recorder + optional JSONL export.

    All cross-thread state lives in the recorder and the exporter queue;
    span nesting is a per-thread stack (``threading.local``), so opening
    and closing spans takes no shared lock at all — only the recorder
    append at close does, and that lock never covers I/O.
    """

    def __init__(self, config: Optional[TraceConfig] = None):
        self.config = config if config is not None else TraceConfig()
        self.recorder = FlightRecorder(self.config.ring_size)
        self._local = threading.local()
        self._exporter = (
            _JsonlWriter(self.config.jsonl_path)
            if (self.config.enabled and self.config.jsonl_path) else None
        )
        self.profiler = ProfilerSession(
            self.config.profile_dir,
            max_seconds=self.config.max_profile_seconds,
        )

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    # -- per-thread context stack -----------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _push(self, frame) -> None:
        self._stack().append(frame)

    def _pop(self, frame) -> None:
        stack = self._stack()
        # tolerate exotic unwind orders (generators closing late): remove
        # the frame wherever it sits instead of corrupting the stack
        if stack and stack[-1] is frame:
            stack.pop()
        elif frame in stack:
            stack.remove(frame)

    def current(self) -> Optional[TraceContext]:
        """The calling thread's (trace_id, span_id) — what ``submit``-style
        handoffs capture and the receiving thread adopts via ``context``."""
        stack = self._stack()
        if not stack:
            return None
        top = stack[-1]
        if isinstance(top, TraceContext):
            return top
        return TraceContext(top.trace_id, top.span_id)

    def context(self, ctx: Optional[TraceContext]) -> _ContextFrame:
        """Adopt ``ctx`` as the calling thread's current trace context for
        the duration of the ``with`` block (no-op for ``ctx=None``)."""
        if not self.config.enabled:
            return _ContextFrame(self, None)
        return _ContextFrame(self, ctx)

    # -- spans --------------------------------------------------------------

    def span(self, name: str, ctx: Optional[TraceContext] = None, **attrs):
        """Open a span.  Parent/trace id come from ``ctx`` when given, else
        from the thread's current context; a fresh trace id is minted when
        neither exists (the span becomes a root)."""
        if not self.config.enabled:
            return _NOOP_SPAN
        parent = ctx if ctx is not None else self.current()
        if parent is not None:
            return Span(self, name, parent.trace_id, parent.span_id, attrs)
        return Span(self, name, new_trace_id(), None, attrs)

    def root_span(self, name: str, trace_id: Optional[str] = None, **attrs):
        """Open a root span with an explicit (e.g. header-supplied) trace
        id — the HTTP handler's entry point."""
        if not self.config.enabled:
            return _NOOP_SPAN
        return Span(self, name, trace_id or new_trace_id(), None, attrs)

    def record_span(self, name: str, start: float, end: float,
                    ctx: Optional[TraceContext] = None, **attrs) -> None:
        """Record an explicitly-timed span (both endpoints already read from
        :data:`clock`) — queue waits, post-hoc stage timings."""
        if not self.config.enabled:
            return
        parent = ctx if ctx is not None else self.current()
        t = threading.current_thread()
        self._finish(SpanRecord(
            name=name,
            trace_id=parent.trace_id if parent else new_trace_id(),
            span_id=f"{next(_span_ids):x}",
            parent_id=parent.span_id if parent else None,
            start=start,
            end=end,
            thread_id=t.ident or 0,
            thread_name=t.name,
            attrs=attrs,
        ))

    def _finish(self, record: SpanRecord) -> None:
        self.recorder.record(record)
        exporter = self._exporter
        if exporter is not None:
            exporter.submit(record)

    def close(self) -> None:
        """Flush and stop the JSONL writer (spans keep recording to the
        ring; close is about releasing the file)."""
        exporter = self._exporter
        if exporter is not None:
            exporter.close()


# -- Chrome-trace / Perfetto export ------------------------------------------

def to_chrome_trace(spans: Iterable[SpanRecord],
                    metadata: Optional[Dict[str, Any]] = None) -> Dict:
    """Render spans as a Chrome Trace Event Format object.

    Loadable by ``chrome://tracing`` and https://ui.perfetto.dev: complete
    ("X") events with microsecond timestamps relative to the earliest span,
    one lane per thread (thread-name metadata events included), span
    attributes + trace/span ids in ``args`` so Perfetto's flow/search finds
    every span of one request by its trace id.
    """
    spans = list(spans)
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    threads: Dict[int, str] = {}
    origin = min((s.start for s in spans), default=0.0)
    for s in spans:
        threads.setdefault(s.thread_id, s.thread_name)
        events.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "ts": round(1e6 * (s.start - origin), 3),
            "dur": round(1e6 * (s.end - s.start), 3),
            "pid": pid,
            "tid": s.thread_id,
            "args": {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "status": s.status,
                **s.attrs,
            },
        })
    meta_events = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": name}}
        for tid, name in sorted(threads.items())
    ]
    return {
        "traceEvents": meta_events + sorted(events, key=lambda e: e["ts"]),
        "displayTimeUnit": "ms",
        "otherData": metadata or {},
    }


def write_chrome_trace(path: str, spans: Iterable[SpanRecord],
                       metadata: Optional[Dict[str, Any]] = None) -> str:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, metadata), f)
    return path


def dump_flight_recorder(reason: str = "manual",
                         directory: Optional[str] = None,
                         tracer: Optional[Tracer] = None) -> Optional[str]:
    """Write the flight recorder's recent spans to a timestamped file.

    The file is itself a Perfetto-loadable Chrome trace (the dump reason and
    wall-clock time ride in ``otherData``).  Returns the path, or None when
    dumping is not configured (no ``dump_dir``) or the ring is empty.
    """
    tr = tracer if tracer is not None else get_tracer()
    directory = directory or tr.config.dump_dir
    if not directory:
        return None
    spans = tr.recorder.snapshot()
    if not spans:
        return None
    slug = "".join(ch if ch.isalnum() or ch in "._-" else "-"
                   for ch in reason)[:48]
    stamp = datetime.datetime.now().strftime("%Y%m%dT%H%M%S")
    path = os.path.join(
        directory, f"flight-{stamp}-{next(_dump_ids)}-{slug}.trace.json")
    write_chrome_trace(path, spans, metadata={
        "reason": reason,
        "dumped_at": datetime.datetime.now().isoformat(),
        "n_spans": len(spans),
    })
    return path


# -- device correlation (torch.profiler) -------------------------------------

def device_annotation(name: str):
    """``torch.profiler.record_function(name)``: during a ``torch.profiler``
    capture it stamps ``name`` onto the timeline, enclosing the device work
    launched inside it — how a host span (an executor's dispatch stage, a
    windowed fit) is matched to its kernels; without a capture it costs a
    few microseconds.  Works on the CPU as on the card."""
    from torch.profiler import record_function

    return record_function(name)


class ProfilerBusyError(RuntimeError):
    """A capture is already running (the endpoint maps this to HTTP 409)."""


class ProfilerSession:
    """Single-flight programmatic ``torch.profiler`` capture.

    One capture at a time per process (two profilers in one process
    corrupt each other); the busy flag flips under a short lock and the
    capture itself — start, sleep, stop, export, all slow — runs with no
    lock held.
    """

    def __init__(self, log_dir: Optional[str],
                 max_seconds: float = 60.0):
        self.log_dir = log_dir
        self.max_seconds = float(max_seconds)
        self._flag_lock = threading.Lock()
        self._active = False

    @property
    def available(self) -> bool:
        return self.log_dir is not None

    def capture(self, seconds: float) -> str:
        """Record ``seconds`` (clamped to ``max_seconds``) of this process
        with ``torch.profiler.profile`` — the host activity of every thread
        (``profile_all_threads``: the capturing thread only sleeps), and
        the CUDA activity where a card is visible — and export its Chrome
        trace as ``trace.json`` in the returned capture directory."""
        if self.log_dir is None:
            raise RuntimeError("profiler capture not configured "
                               "(tracing.profile_dir is unset)")
        seconds = max(0.1, min(float(seconds), self.max_seconds))
        with self._flag_lock:
            if self._active:
                raise ProfilerBusyError(
                    "a profiler capture is already in flight")
            self._active = True
        try:
            import torch
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            stamp = datetime.datetime.now().strftime("%Y%m%dT%H%M%S")
            out = os.path.join(self.log_dir,
                               f"capture-{stamp}-{next(_dump_ids)}")
            os.makedirs(out, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities,
                         experimental_config=_ExperimentalConfig(
                             profile_all_threads=True)) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
            return out
        finally:
            with self._flag_lock:
                self._active = False


# -- process-global tracer ---------------------------------------------------

_state_lock = threading.Lock()
_tracer: Optional[Tracer] = None


def configure_tracing(config: TraceConfig) -> Tracer:
    """Install a tracer built from ``config`` process-wide; the previous
    tracer's exporter is flushed and closed (outside the state lock — close
    joins a thread doing file I/O)."""
    global _tracer
    tracer = Tracer(config)
    with _state_lock:
        old, _tracer = _tracer, tracer
    if old is not None:
        old.close()
    return tracer


def get_tracer() -> Tracer:
    """The process-wide tracer (created on first use with defaults:
    recording on, exporters and debug endpoints off)."""
    global _tracer
    with _state_lock:
        if _tracer is None:
            _tracer = Tracer(TraceConfig())
        return _tracer


def enable_from_env() -> Optional[Tracer]:
    """Turn full tracing on from ``DFTPU_TRACE_DIR=<dir>``, the hook for
    runs with no conf (benchmark subprocesses, smoke runs): spans to
    ``<dir>/trace.jsonl``, flight-recorder dumps to ``<dir>``, profiler
    captures to ``<dir>/profile`` and the debug endpoints on.  Returns the
    installed tracer, or None (and changes nothing) when the variable is
    unset or empty."""
    directory = os.environ.get("DFTPU_TRACE_DIR")
    if not directory:
        return None
    return configure_tracing(TraceConfig(
        enabled=True,
        jsonl_path=os.path.join(directory, "trace.jsonl"),
        dump_dir=directory,
        profile_dir=os.path.join(directory, "profile"),
        debug_endpoints=True,
    ))


__all__ = [
    "FlightRecorder",
    "ProfilerBusyError",
    "ProfilerSession",
    "Span",
    "SpanRecord",
    "TraceConfig",
    "TraceContext",
    "Tracer",
    "clock",
    "configure_tracing",
    "device_annotation",
    "dump_flight_recorder",
    "enable_from_env",
    "get_tracer",
    "new_trace_id",
    "to_chrome_trace",
    "write_chrome_trace",
]
