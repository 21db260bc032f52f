"""Port parity: ``ops/pscan`` (the associative scans) and Holt-Winters'
``filter='pscan'`` against the JAX reference and the port's own scan.

The port's :func:`associative_scan` is ``jax.lax.associative_scan``'s
odd/even recursion, so both compose the same pairs in the same order; they
differ only in how a (d, d) product rounds (XLA's dot contracts into FMAs,
torch's CPU matmul sums in its own order): states within 1e-5 of their
scale.  Holt-Winters' parallel filter against the sequential one carries the
prefix tree's re-association over T = 120-300 steps: within 1e-5 of the
data's scale (whole-number sales of magnitude ~100).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.ops import pscan as jps
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.ops import pscan as tps

torch.set_num_threads(1)

TOL = 1e-5

# the reference's functions compiled once per shape (eagerly, each jnp op of
# the prefix tree would dispatch on its own)
j_affine = jax.jit(jps.affine_scan, static_argnames=("block_size",))
j_affine_batched = jax.jit(jps.affine_scan_batched)


@functools.partial(jax.jit, static_argnames=("initial",))
def j_prefix(A, c, initial=False):
    eye = (jnp.eye(3, dtype=A.dtype)[None], jnp.zeros((1, 3), c.dtype))
    init = (A[0], c[0]) if initial else None
    return jps.blocked_prefix(jps._compose, (A, c), eye, 16, initial=init)


@jax.jit
def j_total(A, c):
    eye = (jnp.eye(3, dtype=A.dtype)[None], jnp.zeros((1, 3), c.dtype))
    return jps.blocked_total(jps._compose, (A, c), eye)


@jax.jit
def j_parallel_filter(y, mask, phi):
    return jax.vmap(lambda ys, ms: jhw.parallel_filter(
        ys, ms, 0.3, 0.1, 0.2, 7, phi))(y, mask)


def _affine(T, d, seed):
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(T, d, d)) * 0.35).astype(np.float32)
    c = rng.normal(size=(T, d)).astype(np.float32)
    x0 = rng.normal(size=d).astype(np.float32)
    return A, c, x0


def _close(got, want, scale=None):
    want = np.asarray(want)
    scale = scale or max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("T,block", [(1, 8), (37, 64), (300, 64), (257, 256)],
                         ids=["one", "flat", "blocked", "block_plus_one"])
def test_affine_scan_matches_reference(T, block):
    A, c, x0 = _affine(T, 4, seed=T)
    want = j_affine(jnp.asarray(A), jnp.asarray(c), jnp.asarray(x0),
                    block_size=block)
    got = tps.affine_scan(torch.from_numpy(A), torch.from_numpy(c),
                          torch.from_numpy(x0), block_size=block)
    assert tuple(got.shape) == (T, 4)
    _close(got.numpy(), want)


def test_affine_scan_equals_the_loop_and_batches():
    A, c, x0 = _affine(90, 3, seed=1)
    x = x0.astype(np.float64)
    loop = []
    for t in range(90):
        x = A[t].astype(np.float64) @ x + c[t]
        loop.append(x)
    got = tps.affine_scan(torch.from_numpy(A), torch.from_numpy(c),
                          torch.from_numpy(x0), block_size=16)
    _close(got.numpy(), np.stack(loop))
    # batch axes after time (the port's layout) and leading (``_batched``)
    Ab = np.stack([A, A[::-1].copy()])
    cb = np.stack([c, -c])
    xb = np.stack([x0, 2 * x0])
    lead = tps.affine_scan_batched(*(torch.from_numpy(a) for a in (Ab, cb, xb)))
    want = j_affine_batched(*(jnp.asarray(a) for a in (Ab, cb, xb)))
    assert tuple(lead.shape) == (2, 90, 3)
    _close(lead.numpy(), want)
    after = tps.affine_scan(torch.from_numpy(Ab).movedim(0, 1),
                            torch.from_numpy(cb).movedim(0, 1),
                            torch.from_numpy(xb))
    assert torch.equal(after.movedim(1, 0), lead)


@pytest.mark.parametrize("T", [1, 5, 64, 100])
def test_blocked_prefix_and_total_match_reference(T):
    A, c, _ = _affine(T, 3, seed=7 + T)
    eye = (np.eye(3, dtype=np.float32)[None], np.zeros((1, 3), np.float32))
    j = (jnp.asarray(A), jnp.asarray(c))
    t = (torch.from_numpy(A), torch.from_numpy(c))
    teye = tuple(torch.from_numpy(e) for e in eye)
    want = j_prefix(*j)
    got = tps.blocked_prefix(tps._compose, t, teye, 16)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    total = tps.blocked_total(tps._compose, t, teye)
    for g, w in zip(total, j_total(*j)):
        _close(g.numpy(), w)
    # the total is the last prefix; ``initial`` left-composes into each one
    for g, w in zip(total, got):
        _close(g.numpy(), w[-1].numpy())
    init = (torch.from_numpy(A[0]), torch.from_numpy(c[0]))
    pre = tps.blocked_prefix(tps._compose, t, teye, 16, initial=init)
    want_init = j_prefix(*j, initial=True)
    for g, w in zip(pre, want_init):
        _close(g.numpy(), w)


def test_prefer_pscan_keeps_the_reference_rule():
    for args in [("cpu", 8, 30_000), ("gpu", 8, 30_000), ("cuda", 8, 30_000),
                 ("tpu", 8, 30_000), ("tpu", 8, 2_000), ("tpu", 5_000, 30_000),
                 ("tpu", 100, 30_000, 96)]:
        assert tps.prefer_pscan(*args) == jps.prefer_pscan(*args), args
    assert not tps.prefer_pscan("cuda", 1, 10 ** 6)


def _workload(S, T, m=7, seed=0, missing=0.1):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    level = rng.uniform(40, 80, size=(S, 1)) + rng.uniform(-0.03, 0.03, (S, 1)) * t
    season = rng.uniform(2, 10, size=(S, 1)) * np.sin(2 * np.pi * t / m)[None]
    y = np.round(level + season + rng.normal(0, 2, size=(S, T))).astype(np.float32)
    mask = (rng.random((S, T)) >= missing).astype(np.float32)
    day = np.arange(16_000, 16_000 + T, dtype=np.int32)
    return y * mask, mask, day


@pytest.mark.parametrize("missing,phi", [(0.0, 1.0), (0.15, 0.9)],
                         ids=["dense", "gaps_damped"])
def test_parallel_filter_matches_reference_and_scan(missing, phi):
    y, mask, _ = _workload(3, 300, seed=3, missing=missing)
    scale = float(np.abs(y).max())
    ty, tm = torch.from_numpy(y), torch.from_numpy(mask)
    args = (0.3, 0.1, 0.2, 7)
    (l, b, s), mse, preds = thw.parallel_filter(ty, tm, *args, phi)
    (l2, b2, s2), mse2, preds2 = thw._filter(
        ty, tm, *(torch.full((3,), v) for v in args[:3]), 7, "additive",
        torch.full((3,), phi))
    for got, want in [(l, l2), (b, b2), (s, s2), (preds, preds2)]:
        _close(got.numpy(), want.numpy(), scale)
    _close(mse.numpy(), mse2.numpy())
    (jl, jb, js), jmse, jp = j_parallel_filter(jnp.asarray(y),
                                               jnp.asarray(mask), phi)
    for got, want in [(l, jl), (b, jb), (s, js), (preds, jp)]:
        _close(got.numpy(), want, scale)
    _close(mse.numpy(), jmse)


def test_hw_fit_pscan_matches_reference_and_scan():
    """``filter='pscan'`` scores every candidate with the parallel filter and
    refits the winner exactly, as every route of the port does: where the
    winners agree its fit is bitwise the scan's.  The reference's pscan fit
    returns the parallel filter's state: within 1e-5 of the data's scale."""
    y, mask, day = _workload(4, 160, seed=5)
    t = [torch.from_numpy(a) for a in (y, mask, day)]
    cfg = dict(damped=True, n_alpha=3, n_beta=2, n_gamma=2, n_phi=2)
    p_ps = thw.fit(*t, thw.HoltWintersConfig(filter="pscan", **cfg))
    p_sc = thw.fit(*t, thw.HoltWintersConfig(filter="scan", **cfg))
    msec_sc = thw._filter(t[0], t[1], *(x[None] for x in thw._candidate_grid(
        thw.HoltWintersConfig(**cfg))[:3]), 7, "additive",
        thw._candidate_grid(thw.HoltWintersConfig(**cfg))[3][None],
        keep_path=False)[1]
    best = torch.sort(msec_sc, dim=1).values
    apart = (best[:, 1] - best[:, 0]) > 1e-4 * best[:, 0]
    assert int(apart.sum()) >= 3
    same = apart & (p_ps.alpha == p_sc.alpha) & (p_ps.phi == p_sc.phi)
    assert bool((same == apart).all())
    for name in ("level", "trend", "season", "sigma", "fitted"):
        assert torch.equal(getattr(p_ps, name)[same], getattr(p_sc, name)[same])
    jp = jhw.fit(*(jnp.asarray(a) for a in (y, mask, day)),
                 jhw.HoltWintersConfig(filter="pscan", **cfg))
    scale = float(np.abs(y).max())
    rows = apart.numpy()
    np.testing.assert_allclose(p_ps.alpha.numpy()[rows],
                               np.asarray(jp.alpha)[rows], rtol=1.2e-7)
    for name in ("level", "trend", "season", "fitted"):
        _close(getattr(p_ps, name).numpy()[rows],
               np.asarray(getattr(jp, name))[rows], scale)


def test_pscan_multiplicative_raises_as_the_reference():
    y, mask, day = _workload(2, 40, seed=1)
    cfg = dict(filter="pscan", seasonality_mode="multiplicative")
    with pytest.raises(ValueError, match="additive seasonality only"):
        thw.fit(*(torch.from_numpy(a) for a in (y, mask, day)),
                thw.HoltWintersConfig(**cfg))
    with pytest.raises(ValueError, match="additive seasonality only"):
        jhw.fit(*(jnp.asarray(a) for a in (y, mask, day)),
                jhw.HoltWintersConfig(**cfg))
