"""Run-level timing hooks (port of the reference's ``utils/profiling.py``).

  * :class:`PhaseTimer` — host wall-clock per named phase (read, tensorize,
    cross_validation, fit_forecast, ...), logged into a tracking run as
    ``phase_<name>_seconds`` metrics.  CUDA launches are asynchronous, so a
    phase around device work measures its host side (dispatch); the device
    time lands where the host first waits for a result.
  * :func:`device_trace` — ``torch.profiler`` over a block, exported as a
    Chrome trace into a directory when one is given; a no-op otherwise.  A
    profiler that fails to start or stop never fails the run.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


class PhaseTimer:
    def __init__(self) -> None:
        self._durations: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self._durations[name] = self._durations.get(name, 0.0) + time.time() - t0

    def metrics(self, prefix: str = "phase_") -> Dict[str, float]:
        return {f"{prefix}{k}_seconds": round(v, 4) for k, v in self._durations.items()}

    def total(self) -> float:
        return sum(self._durations.values())


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the block (CPU and, when a card is
    visible, CUDA activity), written to ``<log_dir>/trace.json``;
    ``log_dir=None`` disables it."""
    if not log_dir:
        yield
        return
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:  # pragma: no cover - profiler unavailable
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except Exception:  # pragma: no cover
                pass
