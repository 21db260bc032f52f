"""Per-series filter state behind the streaming ingest path (port of the
reference's ``engine/state_store.py``).

One :class:`SeriesStateStore` per served forecaster owns the live param
dataclass (level / trend / season for holt_winters, the SES level for
theta, the demand and interval carries for croston), the update carries
the fit does not keep (``init_update_aux``), a fitted-path buffer padded
to the time bucket, the host copies of the training history (for full
refits) and the pending buffer of points not yet applied.

Shapes:

- the SERIES axis is the forecaster's: every state tensor is (S,) or
  (S, ...), and requests gather rows from it;
- the NEW-DAY axis K is the apply's day count (the reference pads it to a
  power of two for XLA; ``ops/update.column_bucket`` keeps the ladder and
  the families skip the padding);
- the TIME axis of the fitted and history buffers grows in ``time_bucket``
  steps, and the forecaster's predict grid pads to the same bucket
  (``BatchForecaster.time_bucket``).

Concurrency: ``_lock`` guards the pending buffer, the installed-state
references, and the history buffers' late-point writes and grow-swap; it
is held for memory work only, never across a device call or file I/O.
``_apply_gate`` is a capacity-1 ``BoundedSemaphore`` serializing the state
WRITERS (``apply_pending``, the refit install) so their read-modify-write
of the params is atomic; writers hold it across the update.  Readers
(predict) take neither: they see state through ``BatchForecaster
.swap_state``'s snapshot.  No installed tensor is ever written in place:
an apply or a refit installs new tensors.

On the card the refit's fit runs on a stream of its own (the refit
scheduler's executor); its tensors are handed to the default stream, where
serving reads them, with ``record_stream`` before they are installed, so
the caching allocator does not reuse their memory for the next refit while
a predict still reads it.

The refit's install (the state swap) runs under a ``refit.swap`` span
(``model``, ``day_snap``, ``replayed_days``).

Not here yet: the reference's ``failpoint(...)`` sites and the dftsan
attach (ROADMAP Queue 1: P12).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_forecasting_tpu_torch.models.base import get_model
from distributed_forecasting_tpu_torch.monitoring.trace import get_tracer
from distributed_forecasting_tpu_torch.ops.update import apply_update
from distributed_forecasting_tpu_torch.utils.device import resolve_device
from distributed_forecasting_tpu_torch.utils.logging import get_logger


def time_cap(t: int, bucket: int) -> int:
    """Smallest multiple of ``bucket`` >= t (minimum one bucket)."""
    b = max(int(bucket), 1)
    return max((int(t) + b - 1) // b, 1) * b


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  To the card the copy goes through
    pinned memory without blocking, so an apply waits on nothing the card
    is still doing."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def store_device(forecaster, device) -> torch.device:
    """The device a store of ``forecaster`` lives on: ``device`` (the card
    unless the caller passes ``device="cpu"``), where the forecaster's
    parameters must already be."""
    dev, fdev = resolve_device(device), forecaster.device
    if fdev.type != dev.type or dev.index not in (None, fdev.index):
        raise ValueError(
            f"the forecaster's parameters are on {fdev}, the state "
            f"store on {dev}; load the artifact onto the store's device")
    return fdev


def _pad_time(fitted: torch.Tensor, cap: int) -> torch.Tensor:
    """A new (S, cap) tensor holding ``fitted`` and zeros after it."""
    S, t = fitted.shape
    out = fitted.new_zeros((S, cap))
    out[:, :t] = fitted
    return out


class SeriesStateStore:
    """Live filter state and pending points for one streamed forecaster.

    ``device``: where the state lives — the card unless the caller passes
    ``device="cpu"``; the forecaster's parameters must already be there."""

    def __init__(self, forecaster, time_bucket: int = 32,
                 history_y: Optional[np.ndarray] = None,
                 history_mask: Optional[np.ndarray] = None,
                 metrics=None, max_pending_days: int = 366, device=None):
        fns = get_model(forecaster.model)
        if fns.update_state is None or fns.init_update_aux is None:
            raise ValueError(
                f"model {forecaster.model!r} has no streaming update kernel; "
                f"ingest supports holt_winters, theta, and croston"
            )
        self.device = store_device(forecaster, device)
        self._fc = forecaster
        self._fns = fns
        self.model = forecaster.model
        self.config = forecaster.config
        self.day0 = int(forecaster.day0)
        self.time_bucket = max(int(time_bucket), 1)
        self.max_pending_days = max(int(max_pending_days), 1)
        self.metrics = metrics
        self.logger = get_logger("SeriesStateStore")

        self._lock = threading.Lock()        # pending + installed-state refs
        self._apply_gate = threading.BoundedSemaphore(1)  # state writers
        # one snapshot: attaching to a forecaster that is already serving
        # must not pair new params with an old day1
        params, day1 = forecaster._state_snapshot()
        self._day_cur = int(day1)
        self._pending: Dict[int, Dict[int, float]] = {}
        self._applied_since_refit = 0
        self._late_points = 0
        self._last_refit_monotonic = time.monotonic()
        S, T0 = params.fitted.shape
        self.n_series = S
        t_cap = time_cap(T0, self.time_bucket)
        self._params = dataclasses.replace(
            params, fitted=_pad_time(params.fitted, t_cap))
        # history buffers: needed by full refits (and to fold late points
        # in); optional for incremental serving alone
        if history_y is not None and history_mask is not None:
            self._y = np.zeros((S, t_cap), np.float32)
            self._mask = np.zeros((S, t_cap), np.float32)
            self._y[:, :T0] = np.asarray(history_y, np.float32)
            self._mask[:, :T0] = np.asarray(history_mask, np.float32)
            aux_args = {"y": to_device(self._y[:, :T0], self.device),
                        "mask": to_device(self._mask[:, :T0], self.device)}
        else:
            self._y = None
            self._mask = None
            aux_args = {}
        self._aux = fns.init_update_aux(self._params, **aux_args)
        # install: predicts now pad their grid to the same time bucket and
        # serve from the padded fitted buffer (its padding is never read:
        # history_splice gathers days <= t_fit_end only)
        forecaster.time_bucket = self.time_bucket
        forecaster.swap_state(params=self._params, day1=self._day_cur)

    # -- introspection -------------------------------------------------------
    @property
    def day_cur(self) -> int:
        with self._lock:
            return self._day_cur

    @property
    def can_refit(self) -> bool:
        """Full refits need the training history (a bare artifact has only
        params; incremental updates still work)."""
        return self._y is not None

    def stats(self) -> Dict:
        with self._lock:
            dirty = set()
            for points in self._pending.values():
                dirty.update(points)
            return {
                "day_cur": self._day_cur,
                "pending_days": len(self._pending),
                "dirty_series": len(dirty),
                "pending_points": sum(
                    len(p) for p in self._pending.values()),
                "applied_since_refit": self._applied_since_refit,
                "late_points": self._late_points,
                "seconds_since_refit":
                    time.monotonic() - self._last_refit_monotonic,
            }

    # -- ingest --------------------------------------------------------------
    def ingest(self, points: List[Tuple[int, int, float]]) -> Dict[str, int]:
        """Buffer ``(series_idx, day, y)`` observations.

        Days past the applied frontier go to the pending buffer (the last
        write wins per (series, day)); days inside the applied window fold
        into the history buffers only — they are late and reach the state
        at the next full refit; days before the training grid or beyond
        ``day_cur + max_pending_days`` are rejected (the apply densifies
        ``max_day - day_cur`` columns, so one far-future ordinal would size
        huge buffers).  In memory only: callers write the WAL first
        (serving/ingest), from which this buffer can be replayed."""
        accepted = late = rejected = 0
        with self._lock:
            day_cur = self._day_cur
            horizon = day_cur + self.max_pending_days
            for sidx, day, y in points:
                if day > horizon:
                    rejected += 1
                elif day > day_cur:
                    self._pending.setdefault(int(day), {})[int(sidx)] = \
                        float(y)
                    accepted += 1
                elif day >= self.day0:
                    if self._y is not None:
                        row = int(day) - self.day0
                        self._y[int(sidx), row] = float(y)
                        self._mask[int(sidx), row] = 1.0
                    late += 1
                    self._late_points += 1
                else:
                    rejected += 1
        return {"accepted": accepted, "late": late, "rejected": rejected}

    # -- the batched apply ---------------------------------------------------
    def apply_pending(self) -> Dict[str, int]:
        """Apply every pending point in one batched update.

        Builds dense (S, K) day-columns from the pending buffer on the host
        — every series, masked where no point arrived, covering every day up
        to the pending frontier (gap days are all-masked columns, the rows a
        refit's extended grid would hold) — copies them to the device once
        and runs the family's update over them (``ops/update
        .apply_update``).  The new state installs into the forecaster in
        one swap."""
        with self._apply_gate:
            with self._lock:
                if not self._pending:
                    return {"days": 0, "points": 0}
                day_cur = self._day_cur
                pending, self._pending = self._pending, {}
            t0 = time.monotonic()
            max_day = max(pending)
            horizon = day_cur + self.max_pending_days
            if max_day > horizon:
                # ingest() rejects such days already; this guards direct
                # callers and logs written before the horizon existed
                dropped = sum(len(p) for d, p in pending.items()
                              if d > horizon)
                self.logger.warning(
                    "dropping %d pending point(s) beyond the %d-day "
                    "horizon (max day %d, frontier %d)", dropped,
                    self.max_pending_days, max_day, day_cur)
                pending = {d: p for d, p in pending.items() if d <= horizon}
                if not pending:
                    return {"days": 0, "points": 0}
                max_day = max(pending)
            k = max_day - day_cur
            n_points = sum(len(p) for p in pending.values())
            cols = np.zeros((2, self.n_series, k), np.float32)  # y, mask
            for day, points in pending.items():
                col = day - day_cur - 1
                for sidx, y in points.items():
                    cols[0, sidx, col] = y
                    cols[1, sidx, col] = 1.0
            dev_cols = to_device(cols, self.device)
            params2, aux2, preds = apply_update(
                self.model, self.config, self._params, self._aux,
                dev_cols[0], dev_cols[1], np.ones(k, np.float32),
                np.arange(day_cur + 1, day_cur + 1 + k), day0=self.day0)
            t_len = day_cur - self.day0 + 1
            params2 = dataclasses.replace(params2, fitted=self._spliced(
                params2.fitted, preds, t_len, k))
            if self._y is not None:
                self._grow_history(t_len + k)
                self._y[:, t_len:t_len + k] = cols[0]
                self._mask[:, t_len:t_len + k] = cols[1]
            with self._lock:
                self._params = params2
                self._aux = aux2
                self._day_cur = max_day
                self._applied_since_refit += n_points
            self._fc.swap_state(params=params2, day1=max_day)
            if self.metrics is not None:
                self.metrics.update_seconds.observe(time.monotonic() - t0)
                self.metrics.applied_points_total.inc(n_points)
            return {"days": k, "points": n_points}

    def _spliced(self, fitted, preds, t_len: int, k: int):
        """A new fitted buffer: ``fitted`` (grown one bucket when the new
        columns pass its end) with ``preds[:, :k]`` at ``t_len``.  Never
        written in place: a predict may hold the installed buffer."""
        t_need = t_len + k
        cap = int(fitted.shape[1])
        out = (fitted.clone() if t_need <= cap
               else _pad_time(fitted, time_cap(t_need, self.time_bucket)))
        out[:, t_len:t_need] = preds[:, :k]
        return out

    def _grow_history(self, t_need: int) -> None:
        t_cap = self._y.shape[1]
        if t_need <= t_cap:
            return
        pad = time_cap(t_need, self.time_bucket) - t_cap
        # pad-and-swap under _lock: ingest() writes late points into _y
        # under the same lock, and a copy made outside it would lose a
        # write landing in the old buffer mid-copy (the next refit would
        # train without that point).  Memory-only work, within the contract.
        with self._lock:
            self._y = np.pad(self._y, ((0, 0), (0, pad)))
            self._mask = np.pad(self._mask, ((0, 0), (0, pad)))

    # -- background full refit ----------------------------------------------
    def refit_stages(self):
        """(prep, dispatch, complete) closures for ``TrainingExecutor
        .submit``: a full refit as a background experiment.

        prep snapshots the history under ``_lock``; dispatch runs the
        family's grid-search fit on the real (unpadded) extended grid — on
        the card on the executor's refit stream; complete, on the
        executor's writer thread once the fit's event has fired, replays
        the columns applied while the fit ran (through the same update, so
        the install continues the new fit exactly), rebuilds the fitted
        buffer and swaps the state in.  ``interval_scale`` stays as the
        fit calibrated it (recalibrating needs a CV pass)."""
        if not self.can_refit:
            raise ValueError(
                "refit needs the training history; this store was attached "
                "without (history_y, history_mask)")

        def prep():
            with self._lock:
                day_snap = self._day_cur
                t_len = day_snap - self.day0 + 1
                y = self._y[:, :t_len].copy()
                mask = self._mask[:, :t_len].copy()
            return {"day_snap": day_snap, "y": y, "mask": mask,
                    "t0": time.monotonic()}

        def dispatch(prepared):
            dev = self.device
            day = torch.arange(self.day0, prepared["day_snap"] + 1,
                               dtype=torch.int32, device=dev)
            params = self._fns.fit(
                torch.as_tensor(prepared["y"], device=dev),
                torch.as_tensor(prepared["mask"], device=dev), day,
                self.config)
            return {**prepared, "params": params}

        def complete(state):
            with self._apply_gate:
                self._install_refit(state)
            return {"day_snap": state["day_snap"]}

        return prep, dispatch, complete

    def _install_refit(self, state) -> None:
        """Replay and swap, under ``_apply_gate`` (the caller holds it)."""
        day_snap = int(state["day_snap"])
        params = state["params"]
        if self.device.type == "cuda":
            # the fit ran on the refit stream; from here the default
            # stream reads these tensors
            reader = torch.cuda.current_stream(self.device)
            for f in dataclasses.fields(params):
                getattr(params, f.name).record_stream(reader)
        t_snap = day_snap - self.day0 + 1
        aux = self._fns.init_update_aux(
            params, y=to_device(self._y[:, :t_snap], self.device),
            mask=to_device(self._mask[:, :t_snap], self.device))
        with self._lock:
            day_now = self._day_cur
        delta = day_now - day_snap
        fitted = _pad_time(params.fitted,
                           time_cap(day_now - self.day0 + 1, self.time_bucket))
        if delta > 0:
            # columns applied while the fit ran: replay them through the
            # same update, so the installed state continues the new fit
            # over everything seen so far
            cols = np.stack([self._y[:, t_snap:t_snap + delta],
                             self._mask[:, t_snap:t_snap + delta]])
            dev_cols = to_device(cols, self.device)
            params, aux, preds = apply_update(
                self.model, self.config, params, aux, dev_cols[0],
                dev_cols[1], np.ones(delta, np.float32),
                np.arange(day_snap + 1, day_snap + 1 + delta),
                day0=self.day0)
            fitted[:, t_snap:t_snap + delta] = preds
        params = dataclasses.replace(params, fitted=fitted)
        with get_tracer().span("refit.swap", model=self.model,
                               day_snap=day_snap, replayed_days=delta):
            with self._lock:
                self._params = params
                self._aux = aux
                self._applied_since_refit = 0
                self._late_points = 0
                self._last_refit_monotonic = time.monotonic()
            self._fc.swap_state(params=params, day1=day_now)
        if self.metrics is not None:
            self.metrics.refits_total.inc()
            self.metrics.refit_seconds.observe(
                time.monotonic() - state["t0"])
        self.logger.info(
            "refit installed through day %d (replayed %d day(s))",
            day_now, delta)


__all__ = ["SeriesStateStore", "time_cap", "to_device"]
