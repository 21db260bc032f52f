"""Port parity: ``ops/pkalman.parallel_kalman_filter`` against the JAX
reference's and against the port's sequential filter (the twin of the
``arima_filter`` kernel), over missing and not-missing data and a few
(phi, theta), as the reference's ``tests/unit/test_pkalman.py:37-120`` holds
its own two filters.

Tolerances are the reference's own between its two filters (rtol 1e-3, atol
1e-3 on predictions and states, 1e-4 on variances): the prefix tree
re-associates T = 300 steps of 5-tuple compositions, each with two small
inverses.  The two packages' parallel filters compose the same pairs in the
same order and differ by the rounding of their (r, r) products: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.models import arima as ja
from distributed_forecasting_tpu.ops import pkalman as jpk
from distributed_forecasting_tpu_torch.models import arima as ta
from distributed_forecasting_tpu_torch.ops import pkalman as tpk

torch.set_num_threads(1)


def _simulate_arma(rng, T, phi, theta):
    p, q = len(phi), len(theta)
    eps = rng.normal(0, 1.0, T + 50)
    z = np.zeros(T + 50)
    for t in range(max(p, q + 1), T + 50):
        z[t] = sum(phi[i] * z[t - 1 - i] for i in range(p)) + eps[t]
        z[t] += sum(theta[j] * eps[t - 1 - j] for j in range(q))
    return z[50:]


def _inputs(phi, theta, missing, S=3, T=300, seed=7):
    rng = np.random.default_rng(seed)
    z = np.stack([_simulate_arma(rng, T, phi, theta) for _ in range(S)])
    mask = (rng.random((S, T)) >= missing).astype(np.float32)
    z = (z * mask).astype(np.float32)
    ph = np.tile(np.asarray(phi, np.float32), (S, 1)).reshape(S, len(phi))
    th = np.tile(np.asarray(theta, np.float32), (S, 1)).reshape(S, len(theta))
    return z, mask, ph, th, max(len(phi), len(theta) + 1, 1)


def _port_parallel(z, mask, ph, th, r, block_size=256):
    tph, tth = torch.from_numpy(ph), torch.from_numpy(th)
    T_mat, _ = ta._build_ssm(tph, tth, r)
    p_pad, _, RRt = ta._model(tph, tth, r)
    return tpk.parallel_kalman_filter(
        torch.from_numpy(z), torch.from_numpy(mask), T_mat, RRt,
        ta._init_cov(p_pad, RRt), block_size=block_size)


def _ref_parallel(z, mask, ph, th, r):
    def one(zs, ms, p, t):
        T_mat, Rv = ja._build_ssm(p, t, r)
        RRt = jnp.outer(Rv, Rv)
        return jpk.parallel_kalman_filter(zs, ms, T_mat, RRt,
                                          ja._init_cov(T_mat, RRt))
    return jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (z, mask, ph, th)))


NAMES = ("ssq", "ldet", "n", "preds", "Fs", "a_T", "P_T")
# (rtol, atol) per output between two filters, the reference's own
BETWEEN = {"ssq": (1e-3, 0), "ldet": (1e-3, 1e-3), "n": (0, 0),
           "preds": (1e-3, 1e-3), "Fs": (1e-3, 1e-4), "a_T": (1e-3, 1e-3),
           "P_T": (1e-3, 1e-4)}


CASES = pytest.mark.parametrize("phi,theta,missing", [
    ((0.6, -0.2), (0.3,), 0.0),
    ((0.6, -0.2), (0.3,), 0.2),
    ((0.9,), (), 0.0),
    ((), (0.5, 0.2), 0.15),
], ids=["arma_dense", "arma_gaps", "ar1", "ma2_gaps"])


@CASES
def test_parallel_kalman_matches_sequential(phi, theta, missing):
    z, mask, ph, th, r = _inputs(phi, theta, missing)
    got = _port_parallel(z, mask, ph, th, r)
    seq = ta._kalman_loglik_impl(torch.from_numpy(z), torch.from_numpy(mask),
                                 torch.from_numpy(ph), torch.from_numpy(th), r)
    for name, g, s in zip(NAMES, got, seq):
        assert tuple(g.shape) == tuple(s.shape), name
        rtol, atol = BETWEEN[name]
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("phi,theta,missing", [
    ((0.6, -0.2), (0.3,), 0.2),
    ((), (0.5, 0.2), 0.15),
], ids=["arma_gaps", "ma2_gaps"])
def test_parallel_kalman_matches_reference(phi, theta, missing):
    # T = 200 (one block): each reference case compiles its own program
    z, mask, ph, th, r = _inputs(phi, theta, missing, T=200)
    got = _port_parallel(z, mask, ph, th, r)
    want = _ref_parallel(z, mask, ph, th, r)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == np.asarray(w).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_parallel_kalman_blocked_matches_flat():
    """A blocked prefix (T > block, not a multiple of it) equals the flat
    one."""
    z, mask, ph, th, r = _inputs((0.7, -0.1), (0.4,), 0.1, S=2, T=205, seed=8)
    flat = _port_parallel(z, mask, ph, th, 3, block_size=205)
    blk = _port_parallel(z, mask, ph, th, 3, block_size=64)
    for a, b in zip(flat, blk):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_inv_small_inverts_i_plus_cj():
    rng = np.random.default_rng(3)
    B = rng.normal(size=(6, 4, 4)).astype(np.float32)
    C = B @ B.transpose(0, 2, 1)
    D = rng.normal(size=(6, 4, 4)).astype(np.float32)
    J = D @ D.transpose(0, 2, 1) * 0.1
    M = np.eye(4, dtype=np.float32) + C @ J
    got = tpk._inv_small(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpk._inv_small(jnp.asarray(M))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got @ M, np.broadcast_to(np.eye(4), M.shape),
                               atol=1e-4)
