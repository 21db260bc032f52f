"""Config-gated mixed precision for the candidate-scoring passes (port of the
reference's ``ops/precision.py``).

The one place where the exactness contract tolerates a narrower type is
the Holt-Winters grid search's scoring: its only consumer is the argmin
over per-candidate MSEs, and the winner is always refit in float32
(``ops/fused_scan.hw_filter``), so the state, sigma and fitted path never
see a bf16 value.  A rank flip between two near-tied candidates changes
which near-optimal parameter vector wins, a question of model quality the
quality monitors watch, not of correctness.

Out of the gate's scope, float32 always: the parallel scans
(``ops/pscan``'s composition tree, ``ops/pkalman``), arima (its likelihood
feeds an optimizer), and the card's scoring kernel
(``ops/fused_scan.hw_score``, the route ``filter: auto`` takes on the card),
which ignores the gate as the reference's Pallas kernel does.

The gate is off by default and is switched by the strict ``precision:``
conf block (``tasks/common.Task``, before any fit) or by
:func:`configure_precision`:

    precision:
      bf16_scoring: true

:func:`fingerprint_extra` is the reference's key extra for its AOT store
(ROADMAP Queue 1: P11); nothing in the port calls it yet.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    # bf16 in the HW candidate-scoring filter (the fit's grid search only;
    # the winner's refit stays float32)
    bf16_scoring: bool = False

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "PrecisionConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like bf16_score must not silently run full precision
            raise ValueError(
                f"unknown precision conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


_lock = threading.Lock()
_config = PrecisionConfig()


def configure_precision(config: PrecisionConfig) -> None:
    """Install the process-wide precision policy (before the first fit)."""
    global _config
    with _lock:
        _config = config


def get_precision() -> PrecisionConfig:
    return _config


def scoring_dtype() -> Optional[torch.dtype]:
    """The candidate scoring's type: ``torch.bfloat16`` when the gate is
    on, else None (everything float32)."""
    return torch.bfloat16 if _config.bf16_scoring else None


def fingerprint_extra() -> Optional[dict]:
    """Non-default precision state as an extra for compiled-program cache
    keys: None at the defaults, else ``{"bf16_scoring": ...}``."""
    if _config == PrecisionConfig():
        return None
    return {"bf16_scoring": bool(_config.bf16_scoring)}
