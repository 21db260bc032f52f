"""dftsan runtime: an opt-in concurrency sanitizer for the serving stack
(port of the reference's ``monitoring/sanitizer.py``).

dflint's lock rules model the code: they build the acquired-while-holding
graph from the AST and flag cycles and blocking calls.  This module observes
the same locks at run time, the static+dynamic pairing ThreadSanitizer uses,
and writes what it sees as a report the reference's ``analysis/dftsan.py``
reads:

* **lock instrumentation**: :func:`attach` replaces the ``threading``
  primitives a class owns with wrappers that record acquisition order (the
  observed edge set, keyed by ``(relpath, class, attr)`` lock ids, the
  relpath taken in this package's tree), hold time and owner threads;
* **guarded attributes**: a declared ``{lock_attr: (attr, ...)}`` map turns
  those attrs into data descriptors that flag any read or write made without
  the owning lock held, with stack and thread provenance;
* **schedule perturbation**: every instrumented acquire and release runs the
  ``sanitizer.yield`` failpoint (``monitoring/failpoints.py``), so arming
  e.g. ``sanitizer.yield=sleep 1:0.05`` with a seed shakes interleavings
  reproducibly.

Disabled (the default, and the only state production runs in), the whole
module is one module-global boolean test: :func:`attach` returns before
touching the object, so instances keep their raw ``threading`` primitives
and their own class, and the hot paths are those of a build without the
sanitizer (the contract ``failpoints.py`` keeps too).

Enable BEFORE constructing the objects under test (instances built while
disabled stay uninstrumented)::

    DFTPU_TSAN=1                          # enable at import
    DFTPU_TSAN_REPORT_DIR=/tmp/dftsan     # atexit: one JSON per process
    DFTPU_FAILPOINTS="sanitizer.yield=sleep 1:0.05"   # optional shaking
    DFTPU_FAILPOINTS_SEED=42

or, from a test: ``sanitizer.configure()`` / ``sanitizer.deactivate()``.

Known approximations, by design:

* ``Condition.wait`` bookkeeping marks the condition released for the wait
  window and re-held on wakeup (``wait_for`` is re-implemented on top of
  ``wait`` so the predicate runs with the lock marked held);
* bare ``acquire()/release()`` call pairs are tracked, but a release on a
  thread that never acquired through the wrapper is ignored rather than
  guessed at.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Dict, Iterable, Mapping, Optional, Tuple

from distributed_forecasting_tpu_torch.monitoring.failpoints import failpoint

__all__ = [
    "attach",
    "configure",
    "configure_from_env",
    "deactivate",
    "is_enabled",
    "reset",
    "snapshot",
    "write_report",
]

#: same shape as the reference's analysis.rules_lockorder.LockId: the
#: join key between the observed and the static lock graphs
LockId = Tuple[str, Optional[str], str]

# ``_enabled`` is the ONLY thing a disabled call path reads: attach() and
# the guarded descriptors test it first, same fast-path contract as
# failpoints._enabled.  Everything below it is touched only while enabled.
_enabled = False

_lock = threading.Lock()          # recorder lock; deliberately raw
_tls = threading.local()
_report_path: Optional[str] = None

_MAX_EDGES = 512                  # distinct (src, dst) pairs kept
_MAX_VIOLATION_SITES = 256        # distinct (lock, attr, op, site) kept
_MAX_THREADS_PER_LOCK = 8

#: LockId -> {"kind", "acquires", "max_hold_ms", "total_hold_ms", threads}
_locks: Dict[LockId, dict] = {}
#: (src LockId, dst LockId) -> {"count", "path", "line", "thread"}
_edges: Dict[Tuple[LockId, LockId], dict] = {}
#: (LockId, attr, op, path, line) -> {"count", "thread", "stack"}
_violations: Dict[tuple, dict] = {}
_dropped = {"edges": 0, "violations": 0}

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
_SELF_FILE = os.path.abspath(__file__).rstrip("co")  # .pyc -> .py


def _relpath(path: str) -> str:
    ap = os.path.abspath(path)
    if ap.startswith(_REPO_ROOT + os.sep):
        return os.path.relpath(ap, _REPO_ROOT).replace(os.sep, "/")
    return path.replace(os.sep, "/")


def _call_site(depth_hint: int = 2) -> Tuple[str, int, str]:
    """(relpath, line, short stack) of the nearest caller frame outside
    this module — the provenance attached to edges and violations."""
    try:
        frame = sys._getframe(depth_hint)
    except ValueError:
        frame = sys._getframe(1)
    site: Optional[Tuple[str, int]] = None
    stack = []
    while frame is not None and len(stack) < 3:
        fname = frame.f_code.co_filename
        if os.path.abspath(fname).rstrip("co") != _SELF_FILE:
            rel = _relpath(fname)
            if site is None:
                site = (rel, frame.f_lineno)
            stack.append(f"{rel}:{frame.f_lineno} in "
                         f"{frame.f_code.co_name}")
        frame = frame.f_back
    if site is None:
        return "<unknown>", 0, ""
    return site[0], site[1], " <- ".join(stack)


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def _record_acquire(sync: "_InstrumentedSync") -> None:
    path, line, _ = _call_site(3)
    tname = threading.current_thread().name
    stack = _held_stack()
    with _lock:
        st = _locks.get(sync.lock_id)
        if st is None:
            st = _locks[sync.lock_id] = {
                "kind": sync.kind, "acquires": 0,
                "max_hold_ms": 0.0, "total_hold_ms": 0.0, "threads": set()}
        st["acquires"] += 1
        if len(st["threads"]) < _MAX_THREADS_PER_LOCK:
            st["threads"].add(tname)
        for held in stack:
            key = (held, sync.lock_id)
            edge = _edges.get(key)
            if edge is not None:
                edge["count"] += 1
            elif len(_edges) < _MAX_EDGES:
                _edges[key] = {"count": 1, "path": path, "line": line,
                               "thread": tname}
            else:
                _dropped["edges"] += 1
    stack.append(sync.lock_id)


def _record_release(sync: "_InstrumentedSync", held_s: float) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == sync.lock_id:
            del stack[i]
            break
    ms = held_s * 1000.0
    with _lock:
        st = _locks.get(sync.lock_id)
        if st is not None:
            st["total_hold_ms"] += ms
            if ms > st["max_hold_ms"]:
                st["max_hold_ms"] = ms


def _record_violation(lock_id: LockId, attr: str, op: str) -> None:
    path, line, stack = _call_site(3)
    key = (lock_id, attr, op, path, line)
    with _lock:
        hit = _violations.get(key)
        if hit is not None:
            hit["count"] += 1
        elif len(_violations) < _MAX_VIOLATION_SITES:
            _violations[key] = {
                "count": 1, "thread": threading.current_thread().name,
                "stack": stack}
        else:
            _dropped["violations"] += 1


# ---------------------------------------------------------------------------
# instrumented primitives
# ---------------------------------------------------------------------------

_LOCK_TYPE = type(threading.Lock())
_RLOCK_TYPE = type(threading.RLock())


def _kind_of(obj) -> Optional[str]:
    if isinstance(obj, threading.Condition):
        return "condition"
    if isinstance(obj, _RLOCK_TYPE):
        return "rlock"
    if isinstance(obj, _LOCK_TYPE):
        return "lock"
    return None


class _InstrumentedSync:
    """Wraps one Lock/RLock/Condition; records order/hold/owner and runs
    the ``sanitizer.yield`` perturbation point at both boundaries."""

    __slots__ = ("_inner", "lock_id", "kind", "_owner", "_depth", "_acq_t")

    def __init__(self, inner, lock_id: LockId, kind: str):
        self._inner = inner
        self.lock_id = lock_id
        self.kind = kind
        self._owner: Optional[int] = None
        self._depth = 0
        self._acq_t = 0.0

    # -- core protocol ------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        failpoint("sanitizer.yield")
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._note_released()
        self._inner.release()
        failpoint("sanitizer.yield")

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self) -> bool:
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else \
            self._owner is not None

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    # -- bookkeeping --------------------------------------------------------

    def _note_acquired(self) -> None:
        me = threading.get_ident()
        if self.kind == "rlock" and self._owner == me:
            self._depth += 1
            return
        self._owner = me
        self._depth = 1
        self._acq_t = time.monotonic()
        _record_acquire(self)

    def _note_released(self) -> None:
        if self._owner != threading.get_ident():
            return  # release by a non-owner: let the primitive raise
        if self.kind == "rlock" and self._depth > 1:
            self._depth -= 1
            return
        held = time.monotonic() - self._acq_t
        self._owner = None
        self._depth = 0
        _record_release(self, held)

    # -- condition surface --------------------------------------------------

    def wait(self, timeout: Optional[float] = None):
        # wait atomically releases the underlying lock: mirror that in the
        # bookkeeping so a concurrent holder is not a fabricated violation
        self._note_released()
        try:
            return self._inner.wait(timeout)
        finally:
            self._note_acquired()  # wait() reacquired before returning

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # reimplemented over self.wait() so the predicate runs with the
        # lock MARKED held (delegating would evaluate it "unlocked")
        endtime: Optional[float] = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                remaining = endtime - time.monotonic()
                if remaining <= 0:
                    break
                self.wait(remaining)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


# ---------------------------------------------------------------------------
# guarded attributes
# ---------------------------------------------------------------------------


class _GuardedAttr:
    """Data descriptor: the value stays in the instance ``__dict__`` under
    its own name; every attribute-protocol access is checked against the
    owning instrumented lock."""

    __slots__ = ("name", "lock_attr")

    def __init__(self, name: str, lock_attr: str):
        self.name = name
        self.lock_attr = lock_attr

    def _check(self, obj, op: str) -> None:
        if not _enabled:
            return
        sync = obj.__dict__.get(self.lock_attr)
        if isinstance(sync, _InstrumentedSync) and not sync.held_by_me():
            _record_violation(sync.lock_id, self.name, op)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            value = obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None
        self._check(obj, "read")
        return value

    def __set__(self, obj, value) -> None:
        self._check(obj, "write")
        obj.__dict__[self.name] = value

    def __delete__(self, obj) -> None:
        self._check(obj, "write")
        del obj.__dict__[self.name]


_sanitized_classes: Dict[tuple, type] = {}


def _sanitized_class(cls: type, guard_items: tuple) -> type:
    key = (cls, guard_items)
    sub = _sanitized_classes.get(key)
    if sub is None:
        ns = {"_dftsan_attached": True}
        for lock_attr, attrs in guard_items:
            for attr in attrs:
                ns[attr] = _GuardedAttr(attr, lock_attr)
        sub = type(cls.__name__, (cls,), ns)
        sub.__module__ = cls.__module__
        sub.__qualname__ = cls.__qualname__
        _sanitized_classes[key] = sub
    return sub


# ---------------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------------


def attach(obj, cls: Optional[type] = None,
           guards: Optional[Mapping[str, Iterable[str]]] = None,
           locks: Iterable[str] = ()):
    """Instrument ``obj`` in place; returns it.

    Disabled, this is one boolean test and the object is untouched —
    same class, same raw ``threading`` primitives.  Enabled:

    * every attr in ``locks`` and every ``guards`` key holding a
      Lock/RLock/Condition is wrapped in :class:`_InstrumentedSync`,
      identified as ``(relpath-of-cls-module, cls.__name__, attr)`` —
      pass ``cls`` explicitly from ``__init__`` so a subclass instance
      still records the ids the static analysis catalogued;
    * ``guards`` maps each lock attr to the attrs it protects; those
      become checked descriptors (the instance's class is swapped to a
      cached subclass — call attach LAST in ``__init__``).
    """
    if not _enabled:
        return obj
    owner = cls if cls is not None else type(obj)
    relpath = owner.__module__.replace(".", "/") + ".py"
    guard_map = {k: tuple(v) for k, v in (guards or {}).items()}
    for attr in sorted(set(locks) | set(guard_map)):
        inner = obj.__dict__.get(attr)
        if inner is None or isinstance(inner, _InstrumentedSync):
            continue
        kind = _kind_of(inner)
        if kind is None:
            continue
        obj.__dict__[attr] = _InstrumentedSync(
            inner, (relpath, owner.__name__, attr), kind)
    if guard_map and not getattr(type(obj), "_dftsan_attached", False):
        obj.__class__ = _sanitized_class(
            type(obj), tuple(sorted(guard_map.items())))
    return obj


def configure(report_path: Optional[str] = None) -> None:
    """Enable the sanitizer (and optionally set the atexit report target).
    Objects must be constructed AFTER this to be instrumented."""
    global _enabled, _report_path
    with _lock:
        if report_path is not None:
            _report_path = report_path
        _enabled = True


def deactivate() -> None:
    """Disable.  Already-instrumented objects keep their wrappers but the
    descriptors stop checking; new constructions are left raw."""
    global _enabled
    with _lock:
        _enabled = False


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop all recorded data (test isolation)."""
    with _lock:
        _locks.clear()
        _edges.clear()
        _violations.clear()
        _dropped["edges"] = 0
        _dropped["violations"] = 0
    _tls.stack = []


def snapshot() -> dict:
    """The event report ``analysis/dftsan.py`` consumes."""
    with _lock:
        return {
            "version": 1,
            "pid": os.getpid(),
            "locks": [
                {"id": list(lid), "kind": st["kind"],
                 "acquires": st["acquires"],
                 "max_hold_ms": round(st["max_hold_ms"], 3),
                 "total_hold_ms": round(st["total_hold_ms"], 3),
                 "threads": sorted(st["threads"])}
                for lid, st in sorted(_locks.items())],
            "edges": [
                {"src": list(src), "dst": list(dst), "count": e["count"],
                 "path": e["path"], "line": e["line"],
                 "thread": e["thread"]}
                for (src, dst), e in sorted(_edges.items())],
            "violations": [
                {"lock": list(lid), "attr": attr, "op": op, "path": path,
                 "line": line, "count": v["count"], "thread": v["thread"],
                 "stack": v["stack"]}
                for (lid, attr, op, path, line), v
                in sorted(_violations.items())],
            "dropped": dict(_dropped),
        }


def write_report(path: str) -> str:
    """Write the snapshot as JSON; creates parent dirs.  Returns the
    resolved file path (a directory target gets a pid-named file)."""
    if os.path.isdir(path) or path.endswith(os.sep):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"dftsan-{os.getpid()}.json")
    else:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _atexit_report() -> None:
    if _report_path and (_locks or _violations):
        try:
            write_report(_report_path)
        except OSError:
            pass  # a dying process must not fail in atexit


def configure_from_env() -> bool:
    """``DFTPU_TSAN=1`` enables at import; ``DFTPU_TSAN_REPORT`` (file)
    or ``DFTPU_TSAN_REPORT_DIR`` (directory, one pid-named file per
    process, what a fleet's replica subprocesses use) arms the
    atexit report dump."""
    if os.environ.get("DFTPU_TSAN", "").strip().lower() not in (
            "1", "true", "yes"):
        return False
    target = os.environ.get("DFTPU_TSAN_REPORT", "").strip()
    if not target:
        d = os.environ.get("DFTPU_TSAN_REPORT_DIR", "").strip()
        if d:
            target = os.path.join(d, f"dftsan-{os.getpid()}.json")
    configure(report_path=target or None)
    return True


atexit.register(_atexit_report)
configure_from_env()
