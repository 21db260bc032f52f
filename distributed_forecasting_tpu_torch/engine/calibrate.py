"""Interval calibration (port of the reference's ``engine/calibrate.py``).

Only the serving half is ported so far: :func:`apply_interval_scale`, which
applies the per-series split-conformal scales an artifact may carry.
Computing those scales from CV residuals waits for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def apply_interval_scale(yhat, lo, hi, scale: Optional[torch.Tensor]):
    """Widen (or tighten) both half-bands around the point path:
    lo' = yhat - s (yhat - lo), hi' = yhat + s (hi - yhat).  ``None`` is the
    identity.  (The reference's ``floor`` clamp belongs to families with a
    band floor; no ported family has one.)"""
    if scale is None:
        return yhat, lo, hi
    s = scale[:, None]
    return yhat, yhat - s * (yhat - lo), yhat + s * (hi - yhat)
