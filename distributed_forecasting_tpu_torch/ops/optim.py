"""First-order optimizer updates written out in plain torch (port of the
reference's ``ops/optim.py``).

The port trains with ``torch.optim`` (``engine/gradfit.make_optimizer``).
These transforms are the reference's own update math, the plain twins the
tests hold ``torch.optim`` against, step for step:

    tx = adam(5e-2)                # or sgd(...), momentum(...)
    state = tx.init(params)        # params: {name: tensor}
    updates, state = tx.update(grads, state)
    params = apply_updates(params, updates)

Adam here is the reference's (and optax's) ``lr·(m/bc1)/(sqrt(v/bc2)+eps)``;
``torch.optim.Adam`` computes the same update as
``m/(sqrt(v)/sqrt(bc2)+eps)·lr/bc1``, so the two differ in rounding only.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Transform(NamedTuple):
    """An (init, update) pair over dicts of tensors."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any], tuple]


def apply_updates(params: dict, updates: dict) -> dict:
    """``params + updates`` per entry, in the params' dtype."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def sgd(learning_rate: float) -> Transform:
    """Plain gradient descent: no state."""
    lr = learning_rate

    def init(params):
        return ()

    def update(grads, state):
        return {k: -lr * g for k, g in grads.items()}, state

    return Transform(init, update)


def momentum(learning_rate: float, decay: float = 0.9) -> Transform:
    """Heavy-ball momentum: ``v <- decay·v + g``, step ``-lr·v``."""
    lr, mu = learning_rate, decay

    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(grads, state):
        v = {k: mu * state[k] + g for k, g in grads.items()}
        return {k: -lr * vv for k, vv in v.items()}, v

    return Transform(init, update)


def bias_corrections(count: int, b1: float, b2: float) -> tuple:
    """Adam's bias corrections ``(1 - b1^count, 1 - b2^count)`` at step
    ``count``, computed in float32 as the reference does.  They are Python
    numbers (float32 values), so a step on the card copies nothing to it
    and never waits for it."""
    c = torch.tensor(float(count), dtype=torch.float32)
    return (float(1.0 - torch.tensor(b1, dtype=torch.float32) ** c),
            float(1.0 - torch.tensor(b2, dtype=torch.float32) ** c))


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax's defaults


def adam(learning_rate: float, b1: float = ADAM_B1, b2: float = ADAM_B2,
         eps: float = ADAM_EPS) -> Transform:
    """Adam with the standard bias correction (Kingma & Ba 2015)."""
    lr = learning_rate

    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state):
        count = state["count"] + 1
        mu = {k: b1 * state["mu"][k] + (1.0 - b1) * g
              for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1.0 - b2) * (g * g)
              for k, g in grads.items()}
        bc1, bc2 = bias_corrections(count, b1, b2)
        updates = {k: -lr * (mu[k] / bc1)
                   / (torch.sqrt(nu[k] / bc2) + eps)
                   for k in mu}
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)
