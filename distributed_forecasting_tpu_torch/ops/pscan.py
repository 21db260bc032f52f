"""Parallel-prefix (associative scan) linear-recurrence solvers (port of the
reference's ``ops/pscan.py``: the on-device scans; the cross-device
``time_sharded_prefix`` and ``affine_scan_time_sharded`` are not ported,
ROADMAP Queue 1: P12).

Every filter used here (exponential smoothing, Holt-Winters, the Kalman mean
recursion) is an affine recurrence ``x_t = A_t x_{t-1} + c_t``, and the
composition of affine maps is associative::

    (A2, c2) o (A1, c1) = (A2 A1, A2 c1 + c2)

so all T states come out of an associative scan in O(log T) depth of batched
(d, d) products, for O(T d^3) operations where the sequential recursion
spends O(T d^2).  :func:`associative_scan` is the reference's
``jax.lax.associative_scan`` algorithm (the odd/even recursion), so both
compose the elements in the same order.

Batching: every function here takes the time axis first and any batch axes
after it, ``(T, *B, ...)``; a compose function broadcasts over them (the
reference batches the per-series functions with ``vmap``).

Used by ``models/holt_winters.parallel_filter`` (``filter='pscan'``, d =
season_length + 2), by ``ops/pkalman`` (the Kalman filtering elements) and
by ``models/arima``'s ``kalman='pscan'`` integration.
"""

from __future__ import annotations

import torch


def _compose(left, right):
    A1, c1 = left
    A2, c2 = right
    return A2 @ A1, (A2 @ c1[..., None])[..., 0] + c2


def _map(fn, *trees):
    """``fn`` over the leaves of tuples of tensors (the port's pytrees)."""
    return type(trees[0])(*map(fn, *trees)) if hasattr(
        trees[0], "_fields") else tuple(map(fn, *trees))


def associative_scan(compose, elems):
    """All inclusive prefixes ``e_1 (x) ... (x) e_t`` along the leading axis
    of ``elems`` (a tuple of tensors): ``jax.lax.associative_scan``'s
    odd/even recursion, the same pairs composed in the same order."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = compose(_map(lambda e: e[0:-1:2], elems),
                      _map(lambda e: e[1::2], elems))
    odd = associative_scan(compose, reduced)
    if n % 2 == 0:
        even = compose(_map(lambda e: e[:-1], odd),
                       _map(lambda e: e[2::2], elems))
    else:
        even = compose(odd, _map(lambda e: e[2::2], elems))
    even = _map(lambda e, r: torch.cat([e[0:1], r]), elems, even)

    def interleave(a, b):
        out = a.new_empty((a.shape[0] + b.shape[0], *a.shape[1:]))
        out[0::2] = a
        out[1::2] = b
        return out

    return _map(interleave, even, odd)


def _broadcast_like(carry, full):
    return _map(lambda c, p: c.expand(p.shape), carry, full)


def blocked_prefix(compose, elems, identity, block_size: int, project=None,
                   initial=None):
    """All prefix compositions ``e_1 (x) ... (x) e_t`` of an associative
    operator, blocked over the leading (time) axis.

    ``elems`` is a tuple of tensors with leading axis T; ``identity`` one of
    the same structure with leading axis 1 holding the operator's identity
    element (it pads T to a block multiple and seeds the cross-block carry).
    ``project`` (optional) maps the full prefix elements of one block to the
    per-step output wanted, so the stacked result holds only the projection
    while the carry stays a full element.  ``initial`` (one element, no
    leading axis) left-composes into every prefix.

    Blocking bounds the working set at O(block_size) elements per lane, at
    parallel depth log2(block_size) + T / block_size: the blocks run one
    after another, each left-composed with the carried prefix of the blocks
    before it.
    """
    if project is None:
        project = lambda full: full  # noqa: E731
    T = elems[0].shape[0]
    carry = _map(lambda i: i[0], identity) if initial is None else initial
    if T <= block_size:
        full = associative_scan(compose, elems)
        if initial is not None:
            full = compose(_broadcast_like(carry, full), full)
        return project(full)
    nb = -(-T // block_size)
    pad = nb * block_size - T
    if pad:
        # identity elements: padded steps compose to a no-op, and the padded
        # tail is sliced off below
        elems = _map(lambda e, i: torch.cat(
            [e, i.expand((pad, *e.shape[1:]))]), elems, identity)
    outs = []
    for k in range(nb):
        blk = _map(lambda e: e[k * block_size:(k + 1) * block_size], elems)
        pref = associative_scan(compose, blk)
        full = compose(_broadcast_like(carry, pref), pref)
        carry = _map(lambda f: f[-1], full)
        outs.append(project(full))
    return _map(lambda *o: torch.cat(o)[:T], *outs)


def blocked_total(compose, elems, identity):
    """TOTAL composition ``e_1 (x) ... (x) e_T``: a pairwise tree reduction,
    T - 1 compose operations at log2(T) depth.  ``identity`` (leading axis
    1) pads T to a power of two."""
    x = elems
    T = x[0].shape[0]
    n = 1 << max(0, T - 1).bit_length()  # next power of two >= T
    if n != T:
        x = _map(lambda e, i: torch.cat(
            [e, i.expand((n - T, *e.shape[1:]))]), x, identity)
    while n > 1:
        x = compose(_map(lambda e: e[0::2], x), _map(lambda e: e[1::2], x))
        n //= 2
    return _map(lambda e: e[0], x)


def affine_scan(A: torch.Tensor, c: torch.Tensor, x0: torch.Tensor,
                block_size: int = 1024) -> torch.Tensor:
    """All states of ``x_t = A_t x_{t-1} + c_t`` for t = 1..T.

    A: (T, *B, d, d); c: (T, *B, d); x0: (*B, d), the initial state.
    Returns (T, *B, d), the states AFTER each step.  Long T runs blocked
    (:func:`blocked_prefix`); each block projects its cumulative maps onto
    x0, so only states are stacked, never (T, d, d) cumulative maps.
    """
    d = c.shape[-1]
    lead = (1,) * (c.dim() - 1)
    identity = (torch.eye(d, dtype=A.dtype, device=A.device).view(*lead, d, d),
                c.new_zeros((*lead, d)))

    def to_states(full):
        A_cum, c_cum = full
        return (A_cum @ x0[None, ..., None])[..., 0] + c_cum

    return blocked_prefix(_compose, (A, c), identity, block_size,
                          project=lambda full: (to_states(full),))[0]


def affine_scan_batched(A, c, x0):
    """Batch axes leading: A (..., T, d, d), c (..., T, d), x0 (..., d) ->
    (..., T, d)."""
    states = affine_scan(A.movedim(-3, 0), c.movedim(-2, 0), x0)
    return states.movedim(0, -2)


# the reference's thresholds of its TPU-only rule (reference
# ops/pscan.py:197-206)
_PSCAN_MAX_LANES = 4096
_PSCAN_MIN_TIME = 20_000


def prefer_pscan(backend: str, n_series: int, n_time: int,
                 lanes: int = 1) -> bool:
    """The reference's rule for ``filter='auto'``: only a TPU picks the
    parallel prefix, and only for long series (T >= 20,000) over few batch
    lanes (S x lanes <= 4,096).  The port runs on ``cuda`` and ``cpu``, so
    it is always False here: ``ops/fused_scan.select_filter`` picks the hand
    kernel on the card and the scan on the CPU."""
    if backend != "tpu":
        return False
    return (n_time >= _PSCAN_MIN_TIME
            and n_series * max(lanes, 1) <= _PSCAN_MAX_LANES)
