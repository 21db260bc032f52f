"""Automatic ARIMA order selection, ``model_conf: {order: auto}`` (port of
the reference's ``engine/order.py``).

With the closed-form Hannan-Rissanen fit every candidate order is one
batched fit and CV pass over all series (on the card, one launch of each
ARIMA kernel), so a grid sweep needs no stepwise heuristics.  Selection is
by rolling-origin CV, which compares across ``d`` where in-sample
likelihoods cannot: the winner is the order with the smallest batch-mean
metric over the series with finite scores.  The decision table comes back
so the pipeline can log what lost and by how much.

(p, d, q) shape the model's state, so the choice is made once, on the host,
for the whole batch, and the config carries plain ints.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_forecasting_tpu_torch.engine.cv import CVConfig, cross_validate

# the default ladder: every (p, q) in a compact box at both d values,
# skipping the degenerate (0, d, 0) white-noise / drift orders
DEFAULT_ORDERS: Tuple[Tuple[int, int, int], ...] = tuple(
    (p, d, q)
    for d in (0, 1)
    for p in (0, 1, 2, 3)
    for q in (0, 1, 2)
    if (p, q) != (0, 0)
)


def select_arima_order(
    batch,
    orders: Sequence[Tuple[int, int, int]] = DEFAULT_ORDERS,
    base_conf: Optional[dict] = None,
    metric: str = "smape",
    cv: CVConfig = CVConfig(),
):
    """CV every candidate (p, d, q); return ``(best_order, table)``.

    ``base_conf``: the other ArimaConfig fields (seasonal terms, ...) every
    candidate shares.  ``table`` rows are ``((p, d, q), score, n_finite)``
    sorted best first, ``score`` the batch-mean metric over the series with
    a finite one.  The candidates' (S,) scores come to the host in one pull
    after the last CV pass.
    """
    from distributed_forecasting_tpu_torch.models.arima import ArimaConfig

    base = dict(base_conf or {})
    base.pop("order", None)
    orders = [tuple(int(x) for x in o) for o in orders]
    scores = [cross_validate(batch, model="arima",
                             config=ArimaConfig(p=p, d=d, q=q, **base),
                             cv=cv)[metric] for p, d, q in orders]
    rows = []
    table = torch.stack(scores).cpu().numpy().astype(np.float64)
    for order, vals in zip(orders, table):
        finite = np.isfinite(vals)
        score = float(np.mean(vals[finite])) if finite.any() else np.inf
        rows.append((order, score, int(finite.sum())))
    rows.sort(key=lambda r: r[1])
    best, best_score, _ = rows[0]
    if not np.isfinite(best_score):
        raise ValueError(
            "no candidate order produced a finite CV score — the batch may "
            "be too short for the CV config, or the series degenerate"
        )
    return best, rows


def resolve_order_conf(model_conf, batch, cv_conf=None) -> Optional[dict]:
    """Translate ``order: auto`` (or an explicit ``order: [p, d, q]``) in an
    arima ``model_conf`` into plain p/d/q fields.

    Sibling keys, popped here and never passed to ArimaConfig:
    ``order_candidates`` restricts the ladder; ``order_metric`` picks the
    selection metric (default smape).
    """
    if not model_conf:
        return model_conf
    if "order" not in model_conf:
        stray = [k for k in ("order_candidates", "order_metric")
                 if k in model_conf]
        if stray:
            # without "order" these would reach ArimaConfig as an opaque
            # unexpected-keyword TypeError
            raise ValueError(
                f"{' / '.join(stray)} only take effect alongside an "
                f"'order' key (e.g. order: auto) — add one or drop them"
            )
        return model_conf
    out = dict(model_conf)
    spec = out.pop("order")
    candidates = out.pop("order_candidates", None)
    metric = out.pop("order_metric", "smape")
    if isinstance(spec, str) and spec == "auto":
        base = {k: v for k, v in out.items() if k not in ("p", "d", "q")}
        orders = (tuple(tuple(int(x) for x in o) for o in candidates)
                  if candidates else DEFAULT_ORDERS)
        (p, d, q), _ = select_arima_order(
            batch, orders=orders, base_conf=base,
            cv=CVConfig(**(cv_conf or {})), metric=metric)
        out.update(p=p, d=d, q=q)
        return out
    if isinstance(spec, (list, tuple)) and len(spec) == 3:
        if candidates is not None or "order_metric" in model_conf:
            # a leftover pin beside an intended sweep: running only the
            # pinned order would let the user believe the grid was searched
            raise ValueError(
                f"order: {list(spec)} pins the order — order_candidates/"
                f"order_metric would be ignored; use order: auto to sweep "
                f"or drop them"
            )
        out.update(p=int(spec[0]), d=int(spec[1]), q=int(spec[2]))
        return out
    raise ValueError(
        f"arima order must be 'auto' or a [p, d, q] triple, got {spec!r}"
    )
