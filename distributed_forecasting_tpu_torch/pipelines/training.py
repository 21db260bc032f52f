"""Training-pipeline helpers (port of the reference's
``pipelines/training.py``).  Only the conf resolution the curve model's
default configuration needs is ported so far: :func:`_resolve_holidays_conf`.
The pipeline itself waits for its slice (ROADMAP Queue 1, P6).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import pandas as pd

from distributed_forecasting_tpu_torch.data import holidays as H


def _resolve_holidays_conf(
    model_conf: Optional[Dict[str, Any]], batch, horizon: int
) -> Optional[Dict[str, Any]]:
    """Turn a NAMED holiday calendar in a model conf into the static
    epoch-day spec the curve model carries::

        holidays: US                 # or the expanded form:
        holidays:
          calendar: US
          lower_window: 1            # widen each occurrence like Prophet
          upper_window: 1
          custom:                    # extra events, Prophet-dict style
            promo: ["2017-11-24", "2017-12-26"]

    The calendar covers the batch's dates extended by ``horizon``, so the
    forecast window's occurrences get indicator columns too.  An explicit
    epoch-day spec (a sequence of (name, days) pairs) passes through.
    """
    if not model_conf or not isinstance(model_conf.get("holidays"), (str, dict)):
        return model_conf
    spec = model_conf["holidays"]
    if isinstance(spec, str):
        spec = {"calendar": spec}
    lower = int(spec.get("lower_window", 0))
    upper = int(spec.get("upper_window", 0))
    epoch = pd.Timestamp("1970-01-01")
    start = epoch + pd.Timedelta(days=int(batch.day[0]))
    end = epoch + pd.Timedelta(days=int(batch.day[-1]) + horizon)
    name = spec.get("calendar")
    custom = spec.get("custom") or {}
    if not name and not custom:
        raise ValueError(
            "holidays conf resolved to an empty calendar: give 'calendar: "
            "US', a 'custom' dates dict, or both"
        )
    out = dict(model_conf)
    out["holidays"] = H.holiday_spec_for_range(
        start, end, calendar=(name or "none"), custom=custom,
        lower_window=lower, upper_window=upper)
    return out
