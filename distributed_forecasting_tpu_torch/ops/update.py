"""The streaming ingest path's state update (port of the reference's
``ops/update.py``).

Every dirty series' newly arrived day-columns go through the family's
``update_state`` (registered on ``models/base.ModelFns``) in one call per
apply: a loop over the new columns of the step function the family's fit
runs, each step a handful of elementwise launches over the (S,) lanes.
This module owns the call's discipline:

- **column bucketing** (:func:`column_bucket`): the reference pads the K
  axis (new days per apply) to a power of two with a ``valid`` flag per
  column, so XLA reuses a few compiled programs.  Eager PyTorch compiles
  nothing, so the families skip padding columns instead of gating them;
  the ladder is kept so callers and artifacts see the reference's shapes.
- **what XLA needed and eager mode does not**: the reference strips
  ``params.fitted`` from the dispatch (a pass-through leaf is a full
  argument copy inside a compiled program) and donates ``aux``.  Here the
  family never reads ``fitted`` (it rides through ``dataclasses.replace``
  as a reference, no copy) and the state store owns ``aux``, replacing it
  with the returned one; neither needs a placeholder tensor.

Not here yet: the AOT store's ``state_update:<model>`` entry and the
``state.update`` span (ROADMAP Queue 1: P11).
"""

from __future__ import annotations

from distributed_forecasting_tpu_torch.models.base import get_model


def column_bucket(k: int) -> int:
    """Smallest power of two >= k (minimum 1): the K-axis shape ladder."""
    if k < 1:
        raise ValueError(f"column_bucket needs k >= 1, got {k}")
    return 1 << (k - 1).bit_length()


def apply_update(model: str, config, params, aux, y_new, mask_new, valid,
                 day_new, day0=None):
    """One batched ``update_state`` call.

    ``y_new`` / ``mask_new``: (S, K) tensors on the params' device;
    ``valid`` / ``day_new``: (K,) host arrays (the state store builds them
    on the host, so nothing is read back from the card); ``day0``: the
    first training day as a host int, or None to read ``params.day0``.
    Returns the family's ``(params', aux', preds)``.  Raises KeyError for
    an unknown model and ValueError for a family without a streaming
    update (the curve model, arima, arnet: their state is not a filter
    carry)."""
    fns = get_model(model)
    if fns.update_state is None:
        raise ValueError(
            f"model {model!r} has no update_state kernel; streaming ingest "
            f"supports the state-space families (holt_winters, theta, "
            f"croston)"
        )
    return fns.update_state(params, aux, y_new, mask_new, valid, day_new,
                            config, day0=day0)
