"""Deterministic failpoint registry: injectable faults at named sites (port
of the reference's ``monitoring/failpoints.py``).

Every durability and dispatch boundary in the serving stack carries a
named ``failpoint("...")`` call — WAL append/roll/read, the kernel
library's store load/store (``engine/compile_cache``), state swap and
refit install, every front-door → replica forward leg.  When the registry
is inactive (the default, and the only state production ever runs in) a
site is a single module-global boolean test — no lock, no dict lookup,
no allocation — so the hot paths pay nothing for their testability.  When a spec is armed (env var, conf, or
:func:`configure` from a test/harness), the named sites fire reproducible
faults: the probabilistic modifier draws from a SEEDED PRNG, so a chaos
run that found a bug replays bit-for-bit from its seed.

Activation spec — ``;``/newline-separated terms::

    name=action[:prob][:count]

    wal.append.enospc=raise OSError            # every evaluation raises
    fleet.forward=raise:0.1                    # 10% of legs, seeded PRNG
    aot.load.payload=corrupt                   # flip a byte of the stored
                                               # kernel library
    aot.load.payload=corrupt truncate          # drop the tail instead
    state.swap=sleep 250:0.5:3                 # 250ms stall, p=0.5, 3 hits
    wal.append.enospc=kill9                    # SIGKILL self (no cleanup)

``prob`` is a float in (0, 1]; ``count`` caps total firings (``3`` or
``3x``) after which the site disarms itself.  Actions:

* ``raise [ExcName]`` — raise ``ExcName`` (a builtin exception name;
  default :class:`FailpointError`).
* ``sleep <ms>`` — block the calling thread; models brownouts and slow
  disks/replicas rather than hard failures.
* ``corrupt [flip|truncate]`` — only meaningful at data sites
  (:func:`failpoint_data`): deterministically flip one byte, or cut the
  payload short.  At a plain site it is ignored.
* ``kill9`` — ``SIGKILL`` the current process: the crash-consistency
  hammer (no atexit, no flush — exactly what the WAL must survive).

Environment activation (read once at import, the hook replica
subprocesses and CI use)::

    DFTPU_FAILPOINTS="wal.append.enospc=raise OSError:0.01"
    DFTPU_FAILPOINTS_SEED=42

The conf route is the strict ``serving.resilience.failpoints`` key
(``serving/resilience.py``); tests call :func:`configure` /
:func:`deactivate` directly.
"""

from __future__ import annotations

import builtins
import os
import random
import signal
import threading
import time
from typing import Dict, Optional

__all__ = [
    "FailpointError",
    "configure",
    "configure_from_env",
    "deactivate",
    "failpoint",
    "failpoint_data",
    "fired",
    "is_active",
    "snapshot",
]


class FailpointError(RuntimeError):
    """Default exception for ``raise`` actions with no exception name."""


class _Armed:
    """One armed site.  Mutable (count decrements under the module lock);
    deliberately not a dataclass — the hot path never touches it unless
    the registry is enabled."""

    __slots__ = ("action", "arg", "prob", "count")

    def __init__(self, action: str, arg: str = "",
                 prob: float = 1.0, count: int = -1):
        self.action = action
        self.arg = arg
        self.prob = prob
        self.count = count  # firings remaining; -1 = unlimited


_ACTIONS = ("raise", "sleep", "corrupt", "kill9")

# Registry state.  ``_enabled`` is the ONLY thing a disabled site reads:
# a module-global bool test, rebound under ``_lock`` by configure/
# deactivate.  Everything else is touched only while armed.
_lock = threading.Lock()
_enabled = False
_armed: Dict[str, _Armed] = {}
_fired: Dict[str, int] = {}
# re-seeded by every configure(): the seed is the reproducibility contract
# dflint: disable=nondeterminism — re-seeded by every configure()
_rng = random.Random(0)


def _resolve_exception(name: str):
    if not name:
        return FailpointError
    exc = getattr(builtins, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    raise ValueError(f"failpoint spec names unknown exception {name!r}")


def _parse_term(term: str) -> tuple:
    name, sep, rest = term.partition("=")
    name = name.strip()
    if not sep or not name or not rest.strip():
        raise ValueError(
            f"failpoint term {term!r} is not name=action[:prob][:count]")
    parts = [p.strip() for p in rest.split(":")]
    action_word, _, arg = parts[0].partition(" ")
    action_word = action_word.strip()
    arg = arg.strip()
    if action_word not in _ACTIONS:
        raise ValueError(
            f"failpoint {name!r}: unknown action {action_word!r} "
            f"(valid: {', '.join(_ACTIONS)})")
    if action_word == "raise":
        _resolve_exception(arg)  # fail at configure time, not at the site
    elif action_word == "sleep":
        if not arg:
            raise ValueError(f"failpoint {name!r}: sleep needs milliseconds")
        float(arg)
    elif action_word == "corrupt":
        if arg not in ("", "flip", "truncate"):
            raise ValueError(
                f"failpoint {name!r}: corrupt mode must be flip|truncate, "
                f"got {arg!r}")
    prob, count = 1.0, -1
    for mod in parts[1:]:
        if not mod:
            continue
        if mod.endswith("x"):
            count = int(mod[:-1])
        elif "." in mod:
            prob = float(mod)
        else:
            # a bare int is a count, a bare float a probability — ``1``
            # alone is read as a count (fire once); spell ``1.0`` for
            # "always"
            count = int(mod)
    if not 0.0 < prob <= 1.0:
        raise ValueError(f"failpoint {name!r}: prob {prob} outside (0, 1]")
    if count == 0 or count < -1:
        raise ValueError(f"failpoint {name!r}: count must be >= 1")
    return name, _Armed(action_word, arg, prob, count)


def configure(spec: Optional[str], seed: int = 0) -> int:
    """Arm the registry from an activation spec; returns the number of
    armed sites.  An empty/None spec deactivates (the conf-default path:
    ``failpoints: ""`` must leave production untouched)."""
    global _enabled
    terms = []
    for raw in (spec or "").replace("\n", ";").split(";"):
        raw = raw.strip()
        if raw:
            terms.append(_parse_term(raw))
    with _lock:
        _armed.clear()
        _fired.clear()
        _rng.seed(seed)
        for name, armed in terms:
            _armed[name] = armed
        _enabled = bool(_armed)
    return len(terms)


def configure_from_env() -> int:
    """Arm from ``DFTPU_FAILPOINTS`` / ``DFTPU_FAILPOINTS_SEED``; a
    missing/empty var leaves the current state alone (so an in-process
    ``configure`` is not clobbered by a late import)."""
    spec = os.environ.get("DFTPU_FAILPOINTS", "").strip()
    if not spec:
        return 0
    return configure(spec, seed=int(os.environ.get(
        "DFTPU_FAILPOINTS_SEED", "0") or 0))


def deactivate() -> None:
    """Disarm every site; every ``failpoint()`` is a no-op again."""
    configure(None)


def is_active(name: Optional[str] = None) -> bool:
    if not _enabled:
        return False
    with _lock:
        return name in _armed if name is not None else bool(_armed)


def fired(name: str) -> int:
    """How many times the named site has fired since configure()."""
    with _lock:
        return _fired.get(name, 0)


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_fired)


def _draw(name: str) -> Optional[tuple]:
    """Decide whether ``name`` fires this evaluation; returns the armed
    ``(action, arg)`` when it does.  All registry mutation happens here,
    under the lock; the action itself executes outside it."""
    with _lock:
        armed = _armed.get(name)
        if armed is None or armed.count == 0:
            return None
        if armed.prob < 1.0 and _rng.random() >= armed.prob:
            return None
        if armed.count > 0:
            armed.count -= 1
        _fired[name] = _fired.get(name, 0) + 1
        return armed.action, armed.arg


def failpoint(name: str) -> None:
    """A fault-injection site.  Disabled (the production state), this is
    one global-bool test; armed, it may raise, sleep, or kill the
    process according to the active spec."""
    if not _enabled:
        return
    hit = _draw(name)
    if hit is None:
        return
    action, arg = hit
    if action == "raise":
        raise _resolve_exception(arg)(f"failpoint {name}")
    if action == "sleep":
        time.sleep(float(arg) / 1000.0)
        return
    if action == "kill9":
        os.kill(os.getpid(), signal.SIGKILL)
    # "corrupt" at a plain site has nothing to corrupt: ignore, so one
    # spec can arm a data site without tripping same-named plain sites


def failpoint_data(name: str, data: bytes) -> bytes:
    """A data-mangling site: returns ``data`` possibly corrupted.

    ``corrupt`` (or ``corrupt flip``) flips one byte in the middle —
    the checksum-mismatch fault; ``corrupt truncate`` drops the second
    half — the torn/partial-write fault.  Non-corrupt actions behave as
    at a plain site (raise/sleep/kill9 still work here)."""
    if not _enabled:
        return data
    hit = _draw(name)
    if hit is None:
        return data
    action, arg = hit
    if action != "corrupt":
        if action == "raise":
            raise _resolve_exception(arg)(f"failpoint {name}")
        if action == "sleep":
            time.sleep(float(arg) / 1000.0)
            return data
        if action == "kill9":
            os.kill(os.getpid(), signal.SIGKILL)
        return data
    if not data:
        return data
    if arg == "truncate":
        return data[: max(len(data) // 2, 1) - 1]
    mid = len(data) // 2
    return data[:mid] + bytes([data[mid] ^ 0xFF]) + data[mid + 1:]


# Replica subprocesses (serving/replica.py children) inherit the fleet
# task's environment; arming at import means no per-module plumbing.
configure_from_env()
