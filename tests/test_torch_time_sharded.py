"""Port parity: the time-sharded scans over three real ranks —
``ops/pscan.affine_scan_time_sharded``, ``models/holt_winters.
parallel_filter_time_sharded`` and ``ops/pkalman.
parallel_kalman_filter_time_sharded`` — against the reference's on a
3-device mesh, and against the port's own unsharded scans.

A module fixture spawns one gloo group of three CPU ranks, each running this
file's ``__main__`` (no JAX there; the spawning is ``test_torch_parallel``'s
:class:`Ranks`).  Each rank passes its own 64 of T = 192 steps, as the
reference's ``tests/unit/multihost_worker.py`` passes its slice, and writes
its outputs to an ``.npz``; a global T the mesh does not divide (191, the
ranks holding 64, 64 and 63 steps) raises ``ValueError`` on every rank.

Tolerances: the two packages' scans compose the same pairs in the same
order (``ops/pscan.associative_scan`` is ``jax.lax.associative_scan``'s
recursion) and differ by how a small product rounds: the affine states and
the Holt-Winters filter within 1e-5 of the data's scale
(``test_torch_pscan.py``), the Kalman outputs rtol / atol 1e-4
(``test_torch_pkalman.py``).  Against the port's unsharded scan, which
associates the rank boundary differently, the same.  A replicated output
(the MSE, the final state, the likelihood pieces, the forecast seed) is the
same on every rank, bit for bit.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)

WORLD = 3
T = 192
BLOCK = 16     # each rank's 64 steps in 4 blocks
D_STATE = 3
HW = dict(alpha=0.3, beta=0.1, gamma=0.2, m=7)
PHI, THETA = (0.6, -0.2), (0.3,)
TOL = 1e-5
KALMAN_TOL = 1e-4
NAMES = ("ssq", "ldet", "n", "preds", "Fs", "a_T", "P_T")
# the outputs every rank holds whole
KALMAN_REPLICATED = ("ssq", "ldet", "n", "a_T", "P_T")


def _affine(T, d, seed=0, lanes=()):
    """The reference's well-conditioned affine problem (spectral radius
    below 1), time first."""
    rng = np.random.default_rng(seed)
    A = (0.9 * rng.uniform(-1, 1, size=(T, *lanes, d, d)) / d).astype(
        np.float32) + 0.5 * np.eye(d, dtype=np.float32)
    c = rng.normal(size=(T, *lanes, d)).astype(np.float32)
    x0 = rng.normal(size=(*lanes, d)).astype(np.float32)
    return A, c, x0


def _seasonal(S=2, seed=7):
    """(S, T) level + trend + weekly wave + noise, a 10-step gap each."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    y = (50 + 0.02 * t + 8 * np.sin(2 * np.pi * t / HW["m"])
         + rng.normal(0, 1.5, (S, T))).astype(np.float32)
    mask = np.ones((S, T), np.float32)
    mask[0, 100:110] = 0.0
    mask[1, 60:70] = 0.0   # across the first rank boundary
    return y * mask, mask


def _arma(S=2, seed=11):
    """(S, T) ARMA(2, 1) draws with a gap each."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(0, 1.0, (S, T + 50))
    z = np.zeros((S, T + 50))
    for t in range(2, T + 50):
        z[:, t] = PHI[0] * z[:, t - 1] + PHI[1] * z[:, t - 2] + eps[:, t]
        z[:, t] += THETA[0] * eps[:, t - 1]
    mask = np.ones((S, T), np.float32)
    mask[0, 120:135] = 0.0
    mask[1, 125:131] = 0.0  # across the second rank boundary
    return (z[:, 50:] * mask).astype(np.float32), mask


def _steps(rank: int, n: int = T):
    """This rank's slice of ``n`` steps (``np.array_split``'s)."""
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n),
                                                             WORLD)])
    return slice(int(bounds[rank]), int(bounds[rank + 1]))


def _port_kalman_system(S):
    from distributed_forecasting_tpu_torch.models import arima as ta

    ph = torch.tensor([PHI] * S, dtype=torch.float32)
    th = torch.tensor([THETA] * S, dtype=torch.float32)
    r = max(len(PHI), len(THETA) + 1)
    T_mat, _ = ta._build_ssm(ph, th, r)
    p_pad, _, RRt = ta._model(ph, th, r)
    return T_mat, RRt, ta._init_cov(p_pad, RRt)


# -- the ranks -------------------------------------------------------------------

def _rank_outputs(rank: int, world: int, port: int) -> dict:
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.models.holt_winters import (
        parallel_filter_time_sharded,
    )
    from distributed_forecasting_tpu_torch.ops.pkalman import (
        parallel_kalman_filter_time_sharded,
    )
    from distributed_forecasting_tpu_torch.ops.pscan import (
        affine_scan_time_sharded,
    )
    from distributed_forecasting_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = make_mesh(world)
    mine = _steps(rank)
    out = {}
    A, c, x0 = (torch.from_numpy(a) for a in _affine(T, D_STATE))
    out["affine"] = affine_scan_time_sharded(
        A[mine], c[mine], x0, mesh, block_size=BLOCK).numpy()
    A, c, x0 = (torch.from_numpy(a) for a in _affine(T, D_STATE, 1, (2,)))
    out["affine_lanes"] = affine_scan_time_sharded(
        A[mine], c[mine], x0, mesh, block_size=BLOCK).numpy()

    y, mask = (torch.from_numpy(a) for a in _seasonal())
    (l, b, s), mse, preds = parallel_filter_time_sharded(
        y[:, mine], mask[:, mine], HW["alpha"], HW["beta"], HW["gamma"],
        HW["m"], mesh)
    out.update(hw_l=l.numpy(), hw_b=b.numpy(), hw_s=s.numpy(),
               hw_mse=mse.numpy(), hw_preds=preds.numpy())

    z, zmask = (torch.from_numpy(a) for a in _arma())
    got = parallel_kalman_filter_time_sharded(
        z[:, mine], zmask[:, mine], *_port_kalman_system(2), mesh,
        block_size=BLOCK)
    for name, v in zip(NAMES, got):
        out[f"kalman_{name}"] = v.numpy()

    # 191 steps: the ranks hold 64, 64 and 63, and every rank refuses
    short = _steps(rank, T - 1)
    A, c, x0 = (torch.from_numpy(a) for a in _affine(T - 1, D_STATE))
    for name, call in (
            ("affine", lambda: affine_scan_time_sharded(
                A[short], c[short], x0, mesh)),
            ("kalman", lambda: parallel_kalman_filter_time_sharded(
                z[:, short], zmask[:, short], *_port_kalman_system(2),
                mesh))):
        try:
            call()
            out[f"indivisible_{name}"] = np.array("")
        except ValueError as e:
            out[f"indivisible_{name}"] = np.array(str(e))
    dist.destroy_process_group()
    return out


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of the parity group")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = _rank_outputs(args.rank, args.world, args.port)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    return 0


# -- the parent ------------------------------------------------------------------

@pytest.fixture(scope="module")
def outs():
    """The three ranks' outputs in rank order."""
    from test_torch_parallel import Ranks

    with tempfile.TemporaryDirectory(prefix="dftt-ranks-") as tmp:
        group = Ranks(os.path.abspath(__file__), WORLD, tmp)
        try:
            yield group.wait()
        finally:
            group.close()


@pytest.fixture(scope="module")
def mesh():
    from distributed_forecasting_tpu.parallel import make_mesh

    return make_mesh(WORLD)


def _cat(outs, key, axis=0):
    return np.concatenate([o[key] for o in outs], axis=axis)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _replicated(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key], err_msg=key)
    return outs[0][key]


def test_affine_scan_time_sharded_matches_reference(outs, mesh):
    import jax.numpy as jnp

    from distributed_forecasting_tpu.ops import pscan as jps

    A, c, x0 = (jnp.asarray(a) for a in _affine(T, D_STATE))
    want = jps.affine_scan_time_sharded(A, c, x0, mesh, block_size=BLOCK)
    assert [o["affine"].shape[0] for o in outs] == [64] * WORLD
    _close(_cat(outs, "affine"), want, what="states")


@pytest.mark.parametrize("key, lanes, seed", [
    ("affine", (), 0), ("affine_lanes", (2,), 1)], ids=["flat", "lanes"])
def test_affine_scan_time_sharded_matches_unsharded(outs, key, lanes, seed):
    """The port's batched contract (lanes after the time axis) included."""
    from distributed_forecasting_tpu_torch.ops.pscan import affine_scan

    A, c, x0 = (torch.from_numpy(a) for a in _affine(T, D_STATE, seed,
                                                     lanes))
    _close(_cat(outs, key), affine_scan(A, c, x0, block_size=BLOCK).numpy(),
           what=key)


def test_hw_time_sharded_matches_reference(outs, mesh):
    """Each row against the reference's time-sharded filter of that row:
    the per-step predictions concatenated by rank, the final state and the
    MSE replicated."""
    import jax.numpy as jnp

    from distributed_forecasting_tpu.models import holt_winters as jhw

    y, mask = _seasonal()
    for i in range(y.shape[0]):
        (l, b, s), mse, preds = jhw.parallel_filter_time_sharded(
            jnp.asarray(y[i]), jnp.asarray(mask[i]), HW["alpha"],
            HW["beta"], HW["gamma"], HW["m"], mesh)
        _close(_cat(outs, "hw_preds", axis=1)[i], preds, what="preds")
        _close(_replicated(outs, "hw_l")[i], l, what="l")
        _close(_replicated(outs, "hw_b")[i], b, what="b")
        _close(_replicated(outs, "hw_s")[i], s, what="s")
        _close(_replicated(outs, "hw_mse")[i], mse, what="mse")


def test_hw_time_sharded_matches_unsharded(outs):
    from distributed_forecasting_tpu_torch.models.holt_winters import (
        parallel_filter,
    )

    y, mask = (torch.from_numpy(a) for a in _seasonal())
    (l, b, s), mse, preds = parallel_filter(
        y, mask, HW["alpha"], HW["beta"], HW["gamma"], HW["m"])
    _close(_cat(outs, "hw_preds", axis=1), preds.numpy(), what="preds")
    for k, v in (("l", l), ("b", b), ("s", s), ("mse", mse)):
        _close(outs[0][f"hw_{k}"], v.numpy(), what=k)


def test_kalman_time_sharded_matches_reference(outs, mesh):
    """Each row against the reference's time-sharded filter of that row."""
    import jax.numpy as jnp

    from distributed_forecasting_tpu.models import arima as ja
    from distributed_forecasting_tpu.ops import pkalman as jpk

    z, mask = _arma()
    r = max(len(PHI), len(THETA) + 1)
    T_mat, Rv = ja._build_ssm(jnp.asarray(PHI, jnp.float32),
                              jnp.asarray(THETA, jnp.float32), r)
    RRt = jnp.outer(Rv, Rv)
    P0 = ja._init_cov(T_mat, RRt)
    for i in range(z.shape[0]):
        want = jpk.parallel_kalman_filter_time_sharded(
            jnp.asarray(z[i]), jnp.asarray(mask[i]), T_mat, RRt, P0, mesh,
            block_size=BLOCK)
        for name, w in zip(NAMES, want):
            got = (_replicated(outs, f"kalman_{name}")[i]
                   if name in KALMAN_REPLICATED
                   else _cat(outs, f"kalman_{name}", axis=1)[i])
            np.testing.assert_allclose(got, np.asarray(w), rtol=KALMAN_TOL,
                                       atol=KALMAN_TOL, err_msg=name)


def test_kalman_time_sharded_matches_unsharded(outs):
    from distributed_forecasting_tpu_torch.ops.pkalman import (
        parallel_kalman_filter,
    )

    z, mask = (torch.from_numpy(a) for a in _arma())
    want = parallel_kalman_filter(z, mask, *_port_kalman_system(2),
                                  block_size=BLOCK)
    for name, w in zip(NAMES, want):
        got = (outs[0][f"kalman_{name}"] if name in KALMAN_REPLICATED
               else _cat(outs, f"kalman_{name}", axis=1))
        np.testing.assert_allclose(got, w.numpy(), rtol=KALMAN_TOL,
                                   atol=KALMAN_TOL, err_msg=name)
    assert float(outs[0]["kalman_n"].sum()) == float(mask.sum())


@pytest.mark.parametrize("name", ["affine", "kalman"])
def test_indivisible_time_axis_raises_on_every_rank(outs, name):
    for o in outs:
        assert "must divide the time axis T=191" in str(
            o[f"indivisible_{name}"]), str(o[f"indivisible_{name}"])


def test_reference_refuses_the_same_time_axis(mesh):
    """The reference's own refusal, for the message the port keeps."""
    import jax.numpy as jnp

    from distributed_forecasting_tpu.ops import pscan as jps

    A, c, x0 = (jnp.asarray(a) for a in _affine(T - 1, D_STATE))
    with pytest.raises(ValueError, match="divide"):
        jps.affine_scan_time_sharded(A, c, x0, mesh)


if __name__ == "__main__":
    sys.exit(_rank_main())
