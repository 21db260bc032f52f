"""Random numbers in the port: one explicit ``torch.Generator`` per path.

The decision.  The JAX reference draws with threefry keys
(``jax.random.PRNGKey``, ``split``, ``fold_in``); the port does not port
threefry.  Every path that draws takes a ``torch.Generator`` and is held
against the reference by distribution, not bit for bit:

* ``jax.random.permutation`` is a sort-based shuffle over threefry bits,
  and its stream depends on JAX's ``jax_threefry_partitionable`` flag,
  whose default changed between versions;
* a CUDA and a CPU ``torch.Generator`` draw different Philox streams, so
  the card against the CPU could only be held by distribution anyway.

What keeps parity testable: each random path takes its draws as an input
(the arnet trainer its ``(steps, B)`` schedule, the curve model's
Monte-Carlo branch its ``(occur, laplace, noise)`` tensors, the tuned path
its trial scales).  These internal arguments default to the port's own
draws; the parity tests hand the reference's draws to the port and hold
every deterministic operation after them to the reference within a float32
tolerance, and separate tests hold the port's own draws by distribution.

A generator left as ``None`` is seeded where the reference seeds its key:
``config.seed`` for arnet, ``0`` where the reference takes
``PRNGKey(0)``, ``search.seed`` for the tuned path.  A path that draws
several times in a row draws from one generator in sequence where the
reference folds or splits its key.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def resolve_generator(generator: Optional[torch.Generator], device,
                      seed: int) -> torch.Generator:
    """``generator`` itself, or a new one on ``device`` seeded with ``seed``
    (the reference's seed for the path) when it is ``None``."""
    if generator is not None:
        return generator
    return make_generator(device, seed)
