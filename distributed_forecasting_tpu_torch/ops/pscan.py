"""Parallel-prefix (associative scan) linear-recurrence solvers (port of the
reference's ``ops/pscan.py``: the on-device scans, and the time-sharded
scans over the ranks of a series mesh, ``parallel/``).

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

:func:`time_sharded_prefix` runs any of these scans with the time axis
split over the ranks of a mesh (sequence parallelism for one very long
series): each rank passes its own ``T / D`` consecutive steps and gets back
its own steps' outputs.
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


# -- the time axis sharded over the ranks of a mesh ---------------------------

def _flat_gather(carry, group):
    """All ranks' ``carry`` elements (a tuple of tensors), stacked along a
    new leading rank axis, from one all-gather of their flattened leaves."""
    from distributed_forecasting_tpu_torch.parallel.mesh import (
        all_gather_rows,
    )

    flat = torch.cat([x.reshape(-1) for x in carry])
    rows = all_gather_rows(flat[None], group)                 # (D, n)
    out, at = [], 0
    for x in carry:
        out.append(rows[:, at:at + x.numel()].reshape((-1, *x.shape)))
        at += x.numel()
    return type(carry)(*out) if hasattr(carry, "_fields") else tuple(out)


def _time_sharded_prefix(compose, elems, identity, mesh, axis_name,
                         block_size, project, project_args,
                         carry_to_project):
    """:func:`time_sharded_prefix`'s outputs and the carried element, the
    composition of every step on the ranks before this one (the identity
    on the first rank)."""
    from distributed_forecasting_tpu_torch.parallel.mesh import (
        all_gather_rows,
        mesh_group,
        mesh_rank,
        mesh_size,
    )

    if project is None:
        project = lambda full: full  # noqa: E731
    group = mesh_group(mesh, axis_name)
    D, r = mesh_size(mesh, axis_name), mesh_rank(mesh, axis_name)
    T = elems[0].shape[0]
    steps = all_gather_rows(
        torch.tensor([T], dtype=torch.int64, device=elems[0].device), group)
    if bool((steps != T).any()):
        raise ValueError(
            f"the mesh's {D} devices must divide the time axis "
            f"T={int(steps.sum())} evenly (the ranks hold {steps.tolist()} "
            f"steps); pad with identity elements to a multiple")
    # 1. this rank's steps reduced to one element
    total = blocked_total(compose, elems, identity)
    # 2. one all-gather of the D totals; the exclusive prefix of the ranks
    # before this one
    pref = associative_scan(compose, _flat_gather(total, group))
    ident = _map(lambda i: i[0], identity)
    prev = ident if r == 0 else _map(lambda p: p[r - 1], pref)
    # 3. this rank's blocked prefix from the carried element
    if carry_to_project:
        out = blocked_prefix(
            compose, elems, identity, block_size,
            project=lambda full: project(full, prev, *project_args))
    else:
        out = blocked_prefix(
            compose, elems, identity, block_size,
            project=lambda full: project(full, *project_args), initial=prev)
    return out, prev


def time_sharded_prefix(compose, elems, identity, mesh,
                        axis_name: str = "series", block_size: int = 1024,
                        project=None, project_args=(),
                        carry_to_project: bool = False):
    """Two-phase prefix scan of any associative operator with the leading
    (time) axis sharded over the ranks of ``mesh``: cross-device sequence
    parallelism for whatever :func:`blocked_prefix` runs (affine maps,
    Kalman 5-tuples, ...).  Each rank passes its own ``T / D`` consecutive
    steps (rank order is time order) and gets back its own steps' outputs.

      1. each rank compose-reduces its steps to one total element
         (:func:`blocked_total`);
      2. the D totals ride one all-gather, and each rank takes the
         exclusive prefix of the ranks before it;
      3. each rank re-runs its blocked prefix with that carry as
         ``initial``, projecting per-step outputs as usual.

    ``project(full, *project_args)`` maps full prefix elements to per-step
    outputs.  With ``carry_to_project=True`` the carry is not composed into
    the per-step elements; the projection is called as ``project(full,
    carry, *project_args)`` instead (the affine scan folds it into x0
    once).  Ranks holding different step counts (a global T the mesh does
    not divide) raise ``ValueError`` on every rank; pad with identity
    elements upstream.
    """
    return _time_sharded_prefix(compose, elems, identity, mesh, axis_name,
                                block_size, project, project_args,
                                carry_to_project)[0]


def _affine_scan_time_sharded(A, c, x0, mesh, axis_name: str,
                              block_size: int):
    """:func:`affine_scan_time_sharded`'s states and this rank's effective
    initial state (the state before its first step)."""
    d = c.shape[-1]
    lead = (1,) * (c.dim() - 1)
    identity = (torch.eye(d, dtype=A.dtype, device=A.device).view(*lead, d, d),
                c.new_zeros((*lead, d)))

    def to_states(full, carry, x0_rep):
        # fold the carried prefix into x0 once, then project the local
        # cumulative maps: no per-step carry composition
        A_cum, c_cum = full
        return ((A_cum @ _fold(carry, x0_rep)[None, ..., None])[..., 0]
                + c_cum,)

    (states,), prev = _time_sharded_prefix(
        _compose, (A, c), identity, mesh, axis_name, block_size,
        project=to_states, project_args=(x0,), carry_to_project=True)
    return states, _fold(prev, x0)


def _fold(carry, x0):
    prevA, prevc = carry
    return (prevA @ x0[..., None])[..., 0] + prevc


def affine_scan_time_sharded(A: torch.Tensor, c: torch.Tensor,
                             x0: torch.Tensor, mesh,
                             axis_name: str = "series",
                             block_size: int = 1024) -> torch.Tensor:
    """:func:`affine_scan` with the time axis sharded over the ranks of
    ``mesh``: each rank passes its own ``T / D`` steps of A (T/D, *B, d, d)
    and c (T/D, *B, d), and x0 (*B, d) replicated (the state before the
    series' first step), and gets back its own steps' states (T/D, *B, d).

    Two passes over local data and one tiny collective (D elements of d^2 +
    d floats a lane): T can exceed one device's memory by the mesh factor.
    Each rank reduces its steps to one affine map, the D maps are
    all-gathered, and each rank folds the composition of the ranks before
    it into x0 once and projects its blocked prefix from there
    (:func:`time_sharded_prefix` with ``carry_to_project``).  Pad a T the
    mesh does not divide with identity maps (A = I, c = 0: padded states
    repeat the last real state).
    """
    return _affine_scan_time_sharded(A, c, x0, mesh, axis_name,
                                     block_size)[0]
