"""The compile cache: a persistent store of the port's kernel library, and
``aot_call`` at the reference's AOT entry points (port of the reference's
``engine/compile_cache.py``).

The reference caches compiled XLA programs in two layers: JAX's persistent
compilation cache, and an executable store keyed per (entry, config, shape).
What the port compiles is different, and so is what it caches:

1. **Layer 1, the persistent store** (:class:`AOTStore`), holds the port's
   **kernel library** — the shared library ``ops/_build.py`` builds with
   ``nvcc`` from every source in ``ops/_build.SOURCES``.  Its key
   (:func:`fingerprint`, entry ``kernel_library``) covers the sha256 of
   every source and of the flags, ``nvcc --version``, torch's version and
   its CUDA version, the card's name and compute capability
   (``ops/_build.library_backend``), and ``ops/precision.fingerprint_extra``
   where the precision policy is not the default.  A store entry is one
   file: a JSON header line (key, entry, sha256 and size of the payload,
   provenance) and the library's bytes; it is written to a private temp
   file, fsync'd and published by an atomic rename, so a reader sees no
   entry or a whole one.  A load checks size and sha256; a truncated or
   corrupt entry is discarded, counted as an error (outcome ``error``) and
   rebuilt.  ``max_size_mb`` caps the store and the LRU sweep drops the
   oldest-touched entries.  A fresh process with a warm store loads the
   library without invoking ``nvcc``.
2. **Layer 2, the per-(entry, shape) executable store**, has no
   counterpart: eager PyTorch compiles no program per shape, and the port
   runs its hand kernels and plain torch ops as they are.  It brings in
   neither ``torch.compile`` nor CUDA graphs (ROADMAP records the
   decision).  :func:`aot_call` keeps the reference's entry points and
   names: it runs ``fn(*args)`` under an ``aot.call`` span and charges the
   call's dispatch seconds to the cost registry (``monitoring/cost.py``);
   ``aot_store`` has no effect.

The library is process-wide (``ops/_build.library``): a store configured
after the library was loaded cannot serve this process.  The call says
so — it logs a warning, counts it (``cache_stats()["late"]``) and installs
nothing — and the store serves the next process.  With no store
configured, the library builds into ``build/torch_kernels/`` of a checkout
(or PyTorch's extensions directory).

The store's three failpoint sites (``monitoring/failpoints.py``) are the
reference's: ``aot.load`` and ``aot.store`` at the plain sites, and the
data site ``aot.load.payload``, where ``corrupt`` flips a byte of the
stored library (or ``corrupt truncate`` cuts it), which is then discarded,
labelled ``error`` and rebuilt.  ``DFTPU_COMPILE_CACHE=<dir>`` installs
the store without a conf block (:func:`enable_from_env`): the fleet task
hands it to every replica it spawns, so each replica and each restart
loads the library from the task's store.

Hit / miss / error / store counts and the load and build seconds are
``compile_cache_*`` metrics on the serving ``GET /metrics``.  Conf block
(``tasks/common.Task`` parses it for every task)::

    compile_cache:
      enabled: true
      directory: null          # default <env.root>/compile_cache
      max_size_mb: 1024        # size cap of the store
      eviction_policy: lru     # 'lru' | 'none'
      aot_store: true          # no effect in the port (no layer 2)
      min_compile_time_s: 0.0  # a build faster than this is not stored

"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional

from distributed_forecasting_tpu_torch.monitoring.failpoints import (
    failpoint,
    failpoint_data,
)
from distributed_forecasting_tpu_torch.monitoring.monitor import MetricsRegistry
from distributed_forecasting_tpu_torch.monitoring.trace import get_tracer
from distributed_forecasting_tpu_torch.utils import get_logger

_logger = get_logger("compile_cache")

_FORMAT_VERSION = 1
_STORE_SUFFIX = ".aot"

# a load is ~ms; an nvcc build is seconds
_LOAD_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5)
_COMPILE_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

_registry = MetricsRegistry()
_hits = _registry.counter(
    "compile_cache_hits_total",
    "AOT executables served from the on-disk store")
_misses = _registry.counter(
    "compile_cache_misses_total",
    "AOT lookups that fell through to a fresh lower+compile")
_errors = _registry.counter(
    "compile_cache_errors_total",
    "store I/O failures: corrupt/incompatible entries discarded on read, "
    "serialization failures on write (both fall through)")
_stores = _registry.counter(
    "compile_cache_stores_total",
    "executables serialized into the store")
_load_seconds = _registry.histogram(
    "compile_cache_load_seconds", _LOAD_BUCKETS,
    "deserialize-and-load time per store hit")
_compile_seconds = _registry.histogram(
    "compile_cache_compile_seconds", _COMPILE_BUCKETS,
    "lower+compile time per store miss")
_entry_requests = _registry.labeled_counter(
    "compile_cache_entry_requests_total", ("entry", "outcome"),
    "AOT store lookups per entry point, by outcome "
    "(memo | hit | miss | error)")
# configurations made after the kernel library loaded in this process
# (cache_stats()["late"]; not on /metrics, which carries the reference's
# families only)
_late = 0


def metrics_registry() -> MetricsRegistry:
    """The cache's telemetry registry — the scorer appends its render to
    ``GET /metrics`` (serving/batcher.ServingMetrics)."""
    return _registry


def cache_stats() -> Dict[str, float]:
    """Counter snapshot: hits / misses / errors / stores, and the
    configurations that came after the library had loaded (``late``)."""
    return {
        "hits": _hits.value,
        "misses": _misses.value,
        "errors": _errors.value,
        "stores": _stores.value,
        "late": float(_late),
    }


@dataclasses.dataclass(frozen=True)
class CompileCacheConfig:
    """The ``compile_cache`` conf block (parsed by tasks/common.Task)."""

    enabled: bool = False
    directory: Optional[str] = None   # None -> <default_root>/compile_cache
    max_size_mb: int = 1024           # cap for EACH layer's directory
    eviction_policy: str = "lru"      # 'lru' | 'none'
    aot_store: bool = True            # layer 2 (explicit executable store)
    min_compile_time_s: float = 0.0   # layer-1 persistent-cache threshold

    def __post_init__(self):
        if self.eviction_policy not in ("lru", "none"):
            raise ValueError(
                f"eviction_policy must be 'lru' or 'none', got "
                f"{self.eviction_policy!r}")
        if self.max_size_mb < 1:
            raise ValueError(
                f"max_size_mb must be >= 1, got {self.max_size_mb}")
        if self.min_compile_time_s < 0:
            raise ValueError(
                f"min_compile_time_s must be >= 0, got "
                f"{self.min_compile_time_s}")

    @classmethod
    def from_conf(cls, conf: Optional[dict],
                  default_root: str = ".") -> "CompileCacheConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like max_sizemb must not silently run uncapped
            raise ValueError(
                f"unknown compile_cache conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        directory = conf.get("directory") or os.path.join(
            default_root, "compile_cache")
        return cls(
            enabled=bool(conf.get("enabled", False)),
            directory=directory,
            max_size_mb=int(conf.get("max_size_mb", 1024)),
            eviction_policy=str(conf.get("eviction_policy", "lru")),
            aot_store=bool(conf.get("aot_store", True)),
            min_compile_time_s=float(conf.get("min_compile_time_s", 0.0)),
        )


# -- key fingerprinting ------------------------------------------------------

def _canon(x) -> Any:
    """Deterministic JSON-able canonicalization of static arguments (model
    configs are frozen dataclasses possibly holding mappings and tuples).
    Class identity is part of the encoding: two config classes with
    identical field values are different programs."""
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {
            "__dataclass__": f"{type(x).__module__}.{type(x).__qualname__}",
            **{f.name: _canon(getattr(x, f.name))
               for f in dataclasses.fields(x)},
        }
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in sorted(x.items())}
    try:  # Mapping (FrozenMap) without importing the class here
        items = x.items()
    except AttributeError:
        pass
    else:
        return {str(k): _canon(v) for k, v in sorted(items)}
    if isinstance(x, (tuple, list, frozenset, set)):
        seq = sorted(x) if isinstance(x, (frozenset, set)) else x
        return [_canon(v) for v in seq]
    return f"{type(x).__name__}:{x!r}"


def _flatten(tree, leaves: list) -> str:
    """Leaves of ``tree`` (tuples, lists, dicts by sorted key, None as an
    empty node) appended to ``leaves``; returns the structure written as
    JAX writes a ``PyTreeDef``'s body, so the signature of a tree of numpy
    arrays is the reference's."""
    if tree is None:
        return "None"
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v, leaves) for v in tree]
        if isinstance(tree, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    if isinstance(tree, dict):
        parts = [f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)]
        return "{" + ", ".join(parts) + "}"
    leaves.append(tree)
    return "*"


def _leaf_dtype(leaf) -> str:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return type(leaf).__name__
    return str(dtype).replace("torch.", "")


def _shape_signature(tree) -> Dict[str, Any]:
    """Shape part of a key: dtype+shape of every array leaf plus the tree
    structure (a None xreg and a present one are different programs even
    with identical array leaves).  A torch tensor's dtype is written as
    numpy's (``float32``)."""
    leaves: list = []
    body = _flatten(tree, leaves)
    return {
        "leaves": [
            f"{_leaf_dtype(leaf)}{list(getattr(leaf, 'shape', ()))}"
            for leaf in leaves
        ],
        "treedef": f"PyTreeDef({body})",
    }


def fingerprint(entry: str, statics: Optional[dict] = None, tree=None,
                backend: Optional[dict] = None,
                extra: Optional[dict] = None) -> str:
    """Store key = sha256 over (entry, canonical statics, shape signature,
    backend).  ``extra`` (process-global context, e.g. the precision
    policy) folds in only when set, so every other key is unchanged."""
    parts = {
        "format": _FORMAT_VERSION,
        "entry": entry,
        "statics": _canon(statics or {}),
        "shapes": _shape_signature(tree),
        "backend": backend or {},
    }
    if extra:
        parts["extra"] = _canon(extra)
    blob = json.dumps(parts, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def _load_library(payload: bytes) -> ctypes.CDLL:
    """Load a shared library from its bytes: written to a private temp
    file, opened with ``ctypes``, unlinked (the mapping outlives the
    name)."""
    fd, path = tempfile.mkstemp(prefix="dftt-lib-", suffix=".so")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        return ctypes.CDLL(path)
    finally:
        os.remove(path)


# -- the store ----------------------------------------------------------------

class AOTStore:
    """Keyed on-disk store of built shared libraries.

    One file per key: a JSON header line and the payload.  Loads that fail
    for ANY reason — a short or unreadable file, a checksum mismatch, a
    library that does not load — count an error, discard the entry, and
    return None so the caller rebuilds.  Loaded libraries are memoized
    in-process.
    """

    def __init__(self, directory: str, max_size_mb: int = 1024,
                 eviction_policy: str = "lru"):
        self.directory = directory
        self.max_size_bytes = int(max_size_mb) * 1024 * 1024
        self.eviction_policy = eviction_policy
        os.makedirs(directory, exist_ok=True)
        self._memo: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _path(self, key: str, entry: str = "") -> str:
        slug = "".join(
            ch if ch.isalnum() or ch in "._-" else "_" for ch in entry
        )[:48]
        name = f"{slug}-{key}{_STORE_SUFFIX}" if slug else key + _STORE_SUFFIX
        return os.path.join(self.directory, name)

    def _find(self, key: str) -> Optional[str]:
        # entry slug is a debugging nicety; the key suffix is authoritative
        tail = f"-{key}{_STORE_SUFFIX}"
        try:
            for name in os.listdir(self.directory):
                if name.endswith(tail) or name == key + _STORE_SUFFIX:
                    return os.path.join(self.directory, name)
        except OSError:
            return None
        return None

    def read(self, key: str) -> Optional[bytes]:
        """The checked payload of ``key``'s entry; None where there is none.
        Raises ValueError for a short or corrupt entry."""
        path = self._find(key)
        if path is None:
            return None
        with open(path, "rb") as f:
            blob = f.read()
        head, sep, payload = blob.partition(b"\n")
        if not sep:
            raise ValueError("no header")
        record = json.loads(head)
        if record.get("format") != _FORMAT_VERSION:
            raise ValueError(f"store format {record.get('format')!r}")
        # data site: "corrupt" / "corrupt truncate" mangle the payload
        # where bit rot would land, upstream of the size and sha checks
        payload = failpoint_data("aot.load.payload", payload)
        if len(payload) != record["size"]:
            raise ValueError(f"payload of {len(payload)} bytes, header says "
                             f"{record['size']}")
        if hashlib.sha256(payload).hexdigest() != record["sha256"]:
            raise ValueError("payload checksum mismatch")
        return payload

    def load(self, key: str):
        """The library stored under ``key``; None where there is none or on
        any mismatch (the entry is then discarded)."""
        path = self._find(key)
        if path is None:
            return None
        t0 = time.perf_counter()
        try:
            # inside the try, so an injected fault takes the path a real
            # corrupt entry takes: discard, count an error, rebuild
            failpoint("aot.load")
            payload = self.read(key)
            if payload is None:  # removed between the two lookups
                return None
            compiled = _load_library(payload)
        except Exception as e:  # corrupt/stale entry: discard, fall through
            _errors.inc()
            _logger.warning("discarding cache entry %s (%s: %s)",
                            os.path.basename(path), type(e).__name__, e)
            self.invalidate(key)
            return None
        _load_seconds.observe(time.perf_counter() - t0)
        # touch for the LRU sweep: eviction orders by mtime
        try:
            os.utime(path, None)
        except OSError:
            pass
        return compiled

    def store(self, key: str, payload: bytes, entry: str = "",
              meta: Optional[dict] = None) -> bool:
        """Write ``payload`` under ``key``: to a private temp file in the
        store directory, flushed and fsync'd, then published with the
        atomic ``os.replace`` — a concurrent reader sees either no entry or
        a whole one, and the last of two concurrent writers wins with an
        identical payload (N fleet replicas booting on a cold store each
        build and publish the same library)."""
        try:
            failpoint("aot.store")
            record = {
                "format": _FORMAT_VERSION,
                "key": key,
                "entry": entry,
                "sha256": hashlib.sha256(payload).hexdigest(),
                "size": len(payload),
                "meta": {
                    **(meta or {}),
                    # human-readable provenance only
                    "created": time.time(),  # dflint: disable=nondeterminism
                },
            }
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(json.dumps(record, sort_keys=True).encode())
                    f.write(b"\n")
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._path(key, entry))
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        # the store is an optimization, never a crash (an injected
        # failpoint error included)
        except Exception as e:  # noqa: BLE001
            _errors.inc()
            _logger.warning("failed to store %s: %s: %s", entry,
                            type(e).__name__, e)
            return False
        _stores.inc()
        self.evict()
        return True

    def invalidate(self, key: str) -> None:
        with self._lock:
            self._memo.pop(key, None)
        path = self._find(key)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass

    def evict(self) -> int:
        """LRU sweep: drop oldest-touched entries until under the cap."""
        if self.eviction_policy != "lru":
            return 0
        try:
            entries = [
                (os.path.getmtime(p), os.path.getsize(p), p)
                for p in (
                    os.path.join(self.directory, n)
                    for n in os.listdir(self.directory)
                    if n.endswith(_STORE_SUFFIX)
                )
            ]
        except OSError:
            return 0
        total = sum(sz for _, sz, _ in entries)
        removed = 0
        for _, sz, path in sorted(entries):
            if total <= self.max_size_bytes:
                break
            try:
                os.remove(path)
                total -= sz
                removed += 1
            except OSError:
                pass
        return removed

    def get_or_compile(self, key: str, entry: str,
                       compile_fn: Callable[[], str],
                       min_compile_time_s: float = 0.0,
                       meta: Optional[dict] = None):
        """Memo -> disk -> fresh build (stored for the next process).

        ``compile_fn()`` builds the library and returns the path of the
        built file, which is loaded in place and whose bytes are stored
        (unless the build took less than ``min_compile_time_s``)."""
        tracer = get_tracer()
        with tracer.span("aot.call", entry=entry) as span:
            with self._lock:
                compiled = self._memo.get(key)
            if compiled is not None:
                span.set_attribute("outcome", "memo")
                _entry_requests.inc(entry=entry, outcome="memo")
                return compiled
            # an entry that EXISTED but failed to load is an "error"
            # outcome, not a plain miss: the label shows bit rot in a store
            # that still ends up serving every call via a rebuild
            present = self._find(key) is not None
            with tracer.span("aot.load", entry=entry):
                compiled = self.load(key)
            if compiled is not None:
                _hits.inc()
                span.set_attribute("outcome", "hit")
                _entry_requests.inc(entry=entry, outcome="hit")
            else:
                _misses.inc()
                outcome = "error" if present else "miss"
                span.set_attribute("outcome", outcome)
                _entry_requests.inc(entry=entry, outcome=outcome)
                t0 = time.perf_counter()
                with tracer.span("aot.compile", entry=entry):
                    path = compile_fn()
                seconds = time.perf_counter() - t0
                _compile_seconds.observe(seconds)
                compiled = ctypes.CDLL(path)
                if seconds >= min_compile_time_s:
                    with open(path, "rb") as f:
                        payload = f.read()
                    self.store(key, payload, entry=entry,
                               meta={**(meta or {}),
                                     "build_seconds": seconds})
            with self._lock:
                self._memo[key] = compiled
            return compiled


# -- process-global configuration -------------------------------------------

_state_lock = threading.Lock()
_active_config: Optional[CompileCacheConfig] = None
_active_store: Optional[AOTStore] = None


def configure_compile_cache(
    config: CompileCacheConfig,
) -> Optional[AOTStore]:
    """Install the kernel-library store at ``<directory>/kernels``
    process-wide and return it; ``enabled=False`` tears it down.

    Where the kernel library is already loaded in this process, a store
    cannot take effect here: the call logs a warning, counts it
    (``cache_stats()["late"]``), installs nothing and returns None."""
    global _active_config, _active_store, _late
    if not config.enabled:
        with _state_lock:
            _active_config, _active_store = None, None
        return None
    from distributed_forecasting_tpu_torch.ops import _build

    if _build.loaded():
        with _state_lock:
            _late += 1
        _logger.warning(
            "compile_cache: the kernel library is already loaded in this "
            "process; the store at %s takes effect in the next process",
            config.directory)
        return None
    # filesystem work stays OUTSIDE _state_lock: a cold mkdir or the
    # eviction sweep can take seconds on a shared filesystem
    store = AOTStore(
        os.path.join(config.directory, "kernels"),
        max_size_mb=config.max_size_mb,
        eviction_policy=config.eviction_policy,
    )
    with _state_lock:
        _active_config = config
        _active_store = store
    store.evict()
    return store


def enable_from_env() -> Optional[AOTStore]:
    """Install the store from ``DFTPU_COMPILE_CACHE=<dir>`` — the
    conf-less hook of fleet replicas and scripts.  No-op when the variable
    is unset or a conf block already configured the cache."""
    directory = os.environ.get("DFTPU_COMPILE_CACHE")
    if not directory or _active_config is not None:
        return _active_store
    return configure_compile_cache(
        CompileCacheConfig(enabled=True, directory=directory))


def get_store() -> Optional[AOTStore]:
    return _active_store


def get_config() -> Optional[CompileCacheConfig]:
    return _active_config


def aot_call(entry: str, fn, args: tuple = (),
             static_kwargs: Optional[dict] = None,
             dynamic_kwargs: Optional[dict] = None,
             charge: bool = True):
    """``fn(*args, **dynamic_kwargs, **static_kwargs)`` at one of the
    reference's AOT entry points: under an ``aot.call`` span, its dispatch
    seconds (host clock, call to return: the device may still be running
    work the call queued) charged to the cost registry under ``entry`` and
    the family after its ``:``.  ``charge=False`` is for a caller that
    charges the entry itself over a longer interval (the serving predict
    meters dispatch through its host pulls): one call, one dispatch.
    Nothing is compiled or stored: eager PyTorch has no per-shape program
    (the module docstring)."""
    from distributed_forecasting_tpu_torch.monitoring.cost import cost_metrics

    with get_tracer().span("aot.call", entry=entry, outcome="eager"):
        t0 = time.perf_counter()
        out = fn(*args, **(dynamic_kwargs or {}), **(static_kwargs or {}))
        seconds = time.perf_counter() - t0
    if charge:
        # registry only: an enclosing meter (the sweep's attribution
        # scope) already times the evaluation this call is part of
        cost_metrics().record_dispatch(
            entry, entry.partition(":")[2] or entry, seconds,
            attribute=False)
    return out


__all__ = [
    "AOTStore",
    "CompileCacheConfig",
    "aot_call",
    "cache_stats",
    "configure_compile_cache",
    "enable_from_env",
    "fingerprint",
    "get_config",
    "get_store",
    "metrics_registry",
]
