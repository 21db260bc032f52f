"""Graceful degradation for the fleet: deadlines, breakers, hedging (port
of the reference's ``serving/resilience.py``; host code, no tensors).

The front door (serving/fleet.py) survives a DEAD replica — connection
failures retry on the next ready port.  This module covers a replica that
is merely *wrong-speed*:

* a hung socket would pin a front-door worker for the full
  ``proxy_timeout_s`` (2 minutes by default) per attempt;
* a consistently SLOW replica would stay in the rotation — every Nth
  request would eat its latency, because only connection failures flip
  ``ready``;
* a client with its own SLA needs a way to say "this answer is worthless
  after 800 ms", so exhausted requests do not burn device time.

Three mechanisms, all conf-gated under the strict ``serving.resilience``
block and all off by default:

* **Deadline budgets** — a request carries ``X-Deadline-Ms`` (or the
  conf's ``default_deadline_ms`` applies).  The front door converts it to
  a monotonic deadline once, derives every forwarded leg's socket timeout
  from the REMAINING budget, forwards the remainder downstream, and
  answers 503 the moment the budget is gone instead of queueing doomed
  work.  Replicas shed exhausted requests before dispatch the same way
  (serving/server.py).
* **Per-replica circuit breakers** — consecutive connection failures or
  slow calls open the breaker (``breaker_failures``); an open breaker
  ejects the replica from routing exactly like ``ready=False`` does, and
  after ``breaker_open_s`` a HALF_OPEN probe admits ONE request whose
  outcome closes or re-opens it.  State is exported per port as
  ``dftpu_fleet_breaker_state`` (0 closed / 1 open / 2 half-open).
* **Hedged scatter legs** — on multi-shard scatter, a leg that has not
  answered within the hedge delay (``hedge_delay_ms``, or the observed
  p95 of recent legs when 0) fires a duplicate to the next owner;
  first response wins, the loser is counted, never awaited.

The failpoint activation keys (``failpoints`` / ``failpoint_seed``) ride
in this block too, so one conf stanza describes a chaos run end to end
(``monitoring/failpoints.py`` holds the registry itself).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

# breaker states, also the dftpu_fleet_breaker_state gauge encoding
CLOSED = 0
OPEN = 1
HALF_OPEN = 2

_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """The ``serving.resilience`` conf block (conf/tasks/serve_config.yml).

    Every mechanism is opt-in: the all-defaults instance is behaviorally
    identical to the pre-resilience fleet (no deadlines, no breakers, no
    hedging, no failpoints) except for the per-leg forward timeout, which
    is always derived from ``request_timeout_s`` once the caller passes
    one.
    """

    failpoints: str = ""          # monitoring/failpoints activation spec
    failpoint_seed: int = 0
    default_deadline_ms: float = 0.0   # budget when no X-Deadline-Ms
    #                                    header arrives; 0 = unbounded
    min_leg_timeout_ms: float = 50.0   # floor under budget-derived leg
    #                                    timeouts (a 3ms socket timeout
    #                                    only manufactures failures)
    breaker_failures: int = 0     # consecutive failures/slow calls that
    #                               open a replica's breaker; 0 disables
    breaker_slow_s: float = 0.0   # a successful call slower than this
    #                               counts as a failure; 0 disables
    breaker_open_s: float = 5.0   # open -> half-open probe delay
    hedge_enabled: bool = False   # duplicate slow scatter legs
    hedge_delay_ms: float = 0.0   # fixed hedge delay; 0 = observed p95
    hedge_min_delay_ms: float = 10.0   # floor under the p95-derived delay

    def __post_init__(self):
        if self.default_deadline_ms < 0:
            raise ValueError("default_deadline_ms must be >= 0")
        if self.min_leg_timeout_ms <= 0:
            raise ValueError("min_leg_timeout_ms must be > 0")
        if self.breaker_failures < 0:
            raise ValueError("breaker_failures must be >= 0")
        if self.breaker_slow_s < 0:
            raise ValueError("breaker_slow_s must be >= 0")
        if self.breaker_open_s <= 0:
            raise ValueError("breaker_open_s must be > 0")
        if self.hedge_delay_ms < 0:
            raise ValueError("hedge_delay_ms must be >= 0")
        if self.hedge_min_delay_ms <= 0:
            raise ValueError("hedge_min_delay_ms must be > 0")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "ResilienceConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like breaker_failues must not silently disable the
            # breaker a chaos drill is about to depend on
            raise ValueError(
                f"unknown serving.resilience conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


def state_name(state: int) -> str:
    return _STATE_NAMES.get(int(state), "unknown")


class CircuitBreaker:
    """One replica's breaker: CLOSED -> OPEN -> HALF_OPEN -> CLOSED.

    ``allow()`` is the routing gate: True admits the call.  In OPEN it
    flips to HALF_OPEN once ``open_s`` has elapsed and admits exactly ONE
    probe (concurrent callers are refused until the probe reports).  The
    caller MUST report every admitted call via ``record_success`` /
    ``record_failure`` or a half-open breaker wedges refusing traffic.

    ``time_fn`` is injectable so the state machine unit-tests in
    simulated time instead of sleeping through ``open_s``.
    """

    def __init__(self, failures: int, open_s: float,
                 slow_s: float = 0.0,
                 time_fn: Callable[[], float] = time.monotonic):
        if failures < 1:
            raise ValueError("failures must be >= 1")
        self.failures = int(failures)
        self.open_s = float(open_s)
        self.slow_s = float(slow_s)
        self._time = time_fn
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._time() - self._opened_at < self.open_s:
                    return False
                self._state = HALF_OPEN
                self._probing = True
                return True
            # HALF_OPEN: one probe in flight at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self, elapsed_s: float = 0.0) -> None:
        if self.slow_s > 0 and elapsed_s >= self.slow_s:
            # answered, but too slowly to count as healthy: a brownout
            # replica must trip the breaker as surely as a dead one
            self.record_failure()
            return
        with self._lock:
            self._consecutive = 0
            self._probing = False
            self._state = CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                # failed probe: straight back to OPEN, timer restarted
                self._state = OPEN
                self._opened_at = self._time()
                return
            self._consecutive += 1
            if self._consecutive >= self.failures:
                self._state = OPEN
                self._opened_at = self._time()


class LatencyReservoir:
    """Last-N leg latencies -> the p95 the hedge delay derives from.

    A fixed ring, not a histogram: the hedge wants the RECENT p95 (the
    fleet's speed now), and 256 samples of float append are cheap enough
    to sit on the forward path.
    """

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._buf: List[float] = []
        self._cap = int(capacity)
        self._next = 0

    def observe(self, seconds: float) -> None:
        with self._lock:
            if len(self._buf) < self._cap:
                self._buf.append(float(seconds))
            else:
                self._buf[self._next] = float(seconds)
                self._next = (self._next + 1) % self._cap

    def p95(self) -> Optional[float]:
        with self._lock:
            if not self._buf:
                return None
            ordered = sorted(self._buf)
        return ordered[min(int(len(ordered) * 0.95), len(ordered) - 1)]


# -- deadline budgets ---------------------------------------------------------

def parse_deadline_header(raw: Optional[str]) -> Optional[float]:
    """``X-Deadline-Ms`` value -> remaining milliseconds, or None when the
    header is absent/garbage (garbage is treated as absent, not as an
    error: a hostile header must not 500 the front door)."""
    if raw is None:
        return None
    try:
        return float(raw.strip())
    except ValueError:
        return None


def deadline_from_headers(headers, default_ms: float = 0.0,
                          ) -> Optional[float]:
    """Monotonic deadline for a request, or None when unbounded.

    The header wins over the conf default — a client saying 500 ms means
    it.  A header that is already <= 0 yields a deadline in the past, so
    the shed check downstream fires without a special case.
    """
    budget_ms = parse_deadline_header(headers.get("X-Deadline-Ms"))
    if budget_ms is None:
        if default_ms <= 0:
            return None
        budget_ms = default_ms
    return time.monotonic() + budget_ms / 1000.0


def remaining_ms(deadline: Optional[float]) -> Optional[float]:
    if deadline is None:
        return None
    return (deadline - time.monotonic()) * 1000.0
