"""Background full refits for the streaming ingest path (port of the
reference's ``serving/refit.py``).

Incremental updates (engine/state_store) keep the filter STATE exact, but
the hyperparameters (the grid's winners, the seasonal profile, the sigma
regime) stay as the fit chose them.  :class:`RefitScheduler` watches three
signals and, when one fires, runs a full grid-search refit as a background
experiment through ``engine/executor.TrainingExecutor`` — prep and the fit's
dispatch on the scheduler's thread (on the card on the executor's own CUDA
stream), the replay and the swap on the executor's writer thread:

* **backlog** — points applied incrementally since the last refit
  (``max_applied_points``);
* **staleness** — wall seconds since the last refit (``max_staleness_s``);
* **drift** — the quality gauges: when the rolling interval coverage
  strays more than ``drift_coverage_tol`` from nominal.

Serving keeps answering from the last state throughout: the swap is the
only moment the applies and the refit contend.  For a Holt-Winters
artifact on the card a refit is one ``hw_score`` launch over the grid and
one ``hw_filter`` launch for the winners.  Not here yet: the
``refit.submit`` failpoint (ROADMAP Queue 1: P12).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional

import torch

from distributed_forecasting_tpu_torch.engine.executor import (
    PipelineConfig,
    TrainingExecutor,
)
from distributed_forecasting_tpu_torch.utils.logging import get_logger

# stop()'s drain patience before declaring the scheduler thread stuck
# (module-level so tests can shrink it without a 10s wall stall).
_JOIN_TIMEOUT_S = 10.0


@dataclasses.dataclass(frozen=True)
class RefitConfig:
    """The ``serving.ingest.refit`` conf block."""

    enabled: bool = False
    max_applied_points: int = 5000
    max_staleness_s: float = 3600.0
    check_interval_s: float = 5.0
    drift_coverage_tol: float = 0.15  # |coverage - nominal| trigger; <= 0
                                      # disables the drift signal

    def __post_init__(self):
        if self.max_applied_points < 1:
            raise ValueError("max_applied_points must be >= 1")
        if self.max_staleness_s <= 0:
            raise ValueError("max_staleness_s must be > 0")
        if self.check_interval_s <= 0:
            raise ValueError("check_interval_s must be > 0")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "RefitConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like max_stalenes_s must not silently drop a trigger
            raise ValueError(
                f"unknown serving.ingest.refit conf key(s) "
                f"{sorted(unknown)}; valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


class RefitScheduler:
    """Watches staleness/drift; schedules at most one refit in flight."""

    def __init__(self, store, config: RefitConfig, quality=None,
                 metrics=None):
        self.store = store
        self.config = config
        self.quality = quality
        self.metrics = metrics
        self.logger = get_logger("RefitScheduler")
        # own executor: refits must never queue behind (or hold slots
        # from) a training task's pipeline, and one in flight is plenty.
        # On the card the fit runs on a stream of its own, so its kernels
        # interleave with the predicts on the default stream
        stream = (torch.cuda.Stream(store.device)
                  if store.device.type == "cuda" else None)
        self._executor = TrainingExecutor(
            config=PipelineConfig(enabled=True, max_in_flight=1,
                                  prefetch_depth=0, async_tracking=False),
            stream=stream)
        # _lock guards _handle/_refits_done/_last_trigger: the scheduler
        # thread, forced maybe_refit() callers, and wait() all touch them
        self._lock = threading.Lock()
        self._handle = None
        self._submitting = False
        self._refits_done = 0
        self._last_trigger = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- trigger logic -------------------------------------------------------
    def due(self) -> str:
        """The name of the first firing trigger, or "" when fresh."""
        st = self.store.stats()
        if st["applied_since_refit"] >= self.config.max_applied_points:
            return "backlog"
        if st["seconds_since_refit"] >= self.config.max_staleness_s:
            return "staleness"
        if self.config.drift_coverage_tol > 0 and self.quality is not None:
            monitor = getattr(self.quality, "monitor", None)
            if monitor is not None:
                cov = monitor.coverage()
                if (not math.isnan(cov)
                        and abs(cov - monitor.nominal_coverage)
                        > self.config.drift_coverage_tol):
                    return "coverage_drift"
        return ""

    def _reap(self) -> Optional[Dict]:
        """Collect a finished refit handle exactly once.

        The ONLY place ``_handle`` is cleared and ``_refits_done``
        incremented — ``wait()`` and the scheduler loop both funnel
        through here, so a refit a caller waited on is never also counted
        by the loop.  Surfaces stage errors (the handle is cleared first,
        matching the loop's old drop-on-error behavior)."""
        with self._lock:
            handle = self._handle
            if handle is None or not handle.done():
                return None
            self._handle = None
        result = handle.result(timeout=0)
        with self._lock:
            self._refits_done += 1
        return result

    def maybe_refit(self, force: bool = False) -> Optional[str]:
        """Submit a refit if a trigger fired (or ``force``) and none is in
        flight; returns the trigger name when one was submitted."""
        self._reap()
        trigger = "forced" if force else self.due()
        if not trigger:
            return None
        # claim the submission slot under the lock, but run submit()
        # outside it — prep/dispatch execute inline in the caller (history
        # snapshot + the fit dispatch, possibly a compile), far too long
        # to hold _lock across
        with self._lock:
            if self._handle is not None or self._submitting:
                return None
            self._submitting = True
        try:
            prep, dispatch, complete = self.store.refit_stages()
            handle = self._executor.submit(
                f"refit:{trigger}", prep, dispatch, complete)
            with self._lock:
                self._last_trigger = trigger
                self._handle = handle
        finally:
            with self._lock:
                self._submitting = False
        self.logger.info("refit submitted (trigger=%s)", trigger)
        return trigger

    def wait(self, timeout: Optional[float] = None) -> Optional[Dict]:
        """Block until the in-flight refit (if any) has swapped in."""
        with self._lock:
            handle = self._handle
        if handle is None:
            return None
        result = handle.result(timeout=timeout)
        # _reap() counts it unless the scheduler loop got there first, in
        # which case the result is still the one we waited on
        reaped = self._reap()
        return result if reaped is None else reaped

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if not self.config.enabled or self._thread is not None:
            return
        self._stop.clear()  # dflint: disable=unlocked-shared-state — lifecycle field touched only by the owning thread
        self._thread = threading.Thread(  # dflint: disable=unlocked-shared-state — lifecycle field touched only by the owning thread
            target=self._run, name="refit-scheduler", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.config.check_interval_s):
            try:
                # maybe_refit reaps first, so stage-C errors surface here
                # instead of silently retrying (a failed handle is cleared
                # by _reap before its result re-raises)
                self.maybe_refit()
            except Exception:
                self.logger.exception("refit cycle failed")

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=_JOIN_TIMEOUT_S)
            if thread.is_alive():
                # a refit dispatch is wedged under _run: the daemon thread
                # leaks past this shutdown — surface it instead of
                # pretending the drain succeeded
                if self.metrics is not None:
                    self.metrics.refit_shutdown_stuck_total.inc()
                self.logger.error(
                    "refit scheduler thread still alive after %.0fs join; "
                    "leaking it (daemon) — shutdown is NOT clean",
                    _JOIN_TIMEOUT_S)
            else:
                self._thread = None  # dflint: disable=unlocked-shared-state — lifecycle field touched only by the owning thread
        self._executor.close()

    def snapshot(self) -> Dict:
        with self._lock:
            in_flight = bool(self._handle is not None
                             and not self._handle.done())
            refits_done = self._refits_done
            last_trigger = self._last_trigger
        return {
            "enabled": self.config.enabled,
            "in_flight": in_flight,
            "refits_done": refits_done,
            "last_trigger": last_trigger,
            "due": self.due(),
        }
