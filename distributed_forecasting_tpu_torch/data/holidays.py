"""Holiday calendars for the curve model's holiday columns (own copy of the
reference's ``data/holidays.py``: pandas and numpy only).

The US federal calendar is computed by rule (fixed dates and n-th weekday
rules); custom calendars are plain ``{name: [dates]}`` dicts.
``holiday_spec`` turns a calendar into the static, hashable form the curve
model's config carries: ``((name, (epoch_day, ...)), ...)``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import pandas as pd


def _nth_weekday(year: int, month: int, weekday: int, n: int) -> pd.Timestamp:
    """n-th (1-based) given weekday of a month; n=-1 = last."""
    if n > 0:
        d = pd.Timestamp(year=year, month=month, day=1)
        offset = (weekday - d.dayofweek) % 7 + 7 * (n - 1)
        return d + pd.Timedelta(days=offset)
    d = pd.Timestamp(year=year, month=month, day=1) + pd.offsets.MonthEnd(0)
    offset = (d.dayofweek - weekday) % 7
    return d - pd.Timedelta(days=offset)


def us_federal_holidays(years: Iterable[int]) -> Dict[str, List[pd.Timestamp]]:
    """Major US federal holidays per year (fixed + floating rules)."""
    cal: Dict[str, List[pd.Timestamp]] = {}

    def add(name, ts):
        cal.setdefault(name, []).append(ts)

    for y in years:
        add("new_years_day", pd.Timestamp(y, 1, 1))
        add("mlk_day", _nth_weekday(y, 1, 0, 3))          # 3rd Mon Jan
        add("presidents_day", _nth_weekday(y, 2, 0, 3))   # 3rd Mon Feb
        add("memorial_day", _nth_weekday(y, 5, 0, -1))    # last Mon May
        add("independence_day", pd.Timestamp(y, 7, 4))
        add("labor_day", _nth_weekday(y, 9, 0, 1))        # 1st Mon Sep
        add("thanksgiving", _nth_weekday(y, 11, 3, 4))    # 4th Thu Nov
        add("christmas", pd.Timestamp(y, 12, 25))
    return cal


def holiday_spec(
    calendar: Dict[str, Iterable], lower_window: int = 0, upper_window: int = 0
) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """Calendar -> static config spec: ((name, (epoch_day, ...)), ...).

    ``lower/upper_window`` widen each occurrence like Prophet's holiday
    windows (e.g. upper_window=1 also marks the day after).
    """
    out = []
    for name in sorted(calendar):
        days = set()
        for ts in calendar[name]:
            base = (
                np.datetime64(pd.Timestamp(ts).date()) - np.datetime64("1970-01-01")
            ).astype(int)
            for off in range(-lower_window, upper_window + 1):
                days.add(int(base + off))
        out.append((name, tuple(sorted(days))))
    return tuple(out)


def us_holiday_spec_for_range(
    start, end, lower_window: int = 0, upper_window: int = 0
) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """Convenience: US federal calendar covering [start, end] dates."""
    y0, y1 = pd.Timestamp(start).year, pd.Timestamp(end).year
    return holiday_spec(
        us_federal_holidays(range(y0, y1 + 1)), lower_window, upper_window
    )


_NAMED_CALENDARS = ("US", "none")


def merge_calendars(
    base: Dict[str, Iterable], custom: Dict[str, Iterable]
) -> Dict[str, List[pd.Timestamp]]:
    """Base calendar + tenant-supplied custom events, with validation.

    ``custom`` is a plain ``{name: [dates]}`` spec dict (YAML-friendly:
    values may be date strings).  A custom name colliding with a base
    holiday is an ERROR, not a silent union — "christmas" meaning one
    tenant's promo window and the federal date at once would produce an
    indicator column nobody can interpret; rename the custom event.
    Unparseable dates fail loudly for the same reason a typo'd conf key
    does.
    """
    overlap = sorted(set(base) & set(custom))
    if overlap:
        raise ValueError(
            f"custom holiday name(s) {overlap} collide with the base "
            f"calendar; rename the custom event(s)")
    out: Dict[str, List[pd.Timestamp]] = {
        name: [pd.Timestamp(ts) for ts in days]
        for name, days in base.items()
    }
    for name, days in custom.items():
        if not str(name).strip():
            raise ValueError("custom holiday names must be non-empty")
        if isinstance(days, (str, bytes)) or not hasattr(days, "__iter__"):
            days = [days]
        try:
            parsed = [pd.Timestamp(ts) for ts in days]
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"custom holiday {name!r} has unparseable date(s): {e}"
            ) from e
        if not parsed:
            raise ValueError(f"custom holiday {name!r} has no dates")
        out[str(name)] = parsed
    return out


def holiday_spec_for_range(
    start,
    end,
    calendar: str = "US",
    custom: Optional[Dict[str, Iterable]] = None,
    lower_window: int = 0,
    upper_window: int = 0,
) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """Named calendar + optional custom events -> static spec over
    [start, end].

    ``calendar`` picks the algorithmic base ("US" federal, or "none" for
    custom-only tenants); ``custom`` merges tenant events through
    :func:`merge_calendars` (overlapping names raise).  This is the
    resolver both the training pipeline's ``holidays:`` conf and
    autoprep's ``engine.autoprep.holiday_*`` knobs go through.
    """
    name = str(calendar)
    if name.upper() == "US":
        y0, y1 = pd.Timestamp(start).year, pd.Timestamp(end).year
        base = us_federal_holidays(range(y0, y1 + 1))
    elif name.lower() == "none":
        base = {}
    else:
        raise ValueError(
            f"unknown holiday calendar {calendar!r}; "
            f"valid: {_NAMED_CALENDARS}")
    merged = merge_calendars(base, custom or {})
    return holiday_spec(merged, lower_window, upper_window)
