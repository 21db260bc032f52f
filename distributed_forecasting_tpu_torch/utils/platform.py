"""Platform override for the task and CLI entry points (port of the
reference's ``utils/platform.py``).

``DFTPU_PLATFORM=cpu`` is the reference's explicit switch to the CPU.  In
the port it names the device of every task and of the workflow runner
(``utils/device.platform_device``): ``cpu``, or ``cuda`` / ``gpu`` for the
card.  Library entry points take ``device`` alone.  Nothing falls back by
itself: without the switch (or ``device="cpu"``) the port runs on the card
and raises where there is none, and an unknown value raises.
"""

from __future__ import annotations

import os
from typing import Optional

from distributed_forecasting_tpu_torch.utils.device import platform_device


def apply_platform_override() -> Optional[str]:
    """``DFTPU_PLATFORM`` if set, checked: returns the platform, or None
    when unset; raises ValueError for a value that is not a platform of
    the port.  The Task base calls it first and logs the override; the
    device it names is what :func:`platform_device` hands the task."""
    plat = os.environ.get("DFTPU_PLATFORM")
    if not plat:
        return None
    platform_device()  # raises for an unknown platform
    return plat
