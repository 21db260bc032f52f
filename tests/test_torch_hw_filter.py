"""Port parity: the Holt-Winters winner refit (``hw_filter``) and the work
counts behind the scoring kernel's bound.

On CPU tensors ``hw_filter`` runs its plain twin ``_filter`` (the CUDA kernel
is held to the twin bit for bit on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  Here the twin is held against the reference's
``_filter`` (one ``lax.scan`` per row, vmapped over the rows).

Tolerance: rtol 1e-5, and an absolute 2e-5 of the data's scale on the path
and the final states, 1e-5 of its square on the MSE.  The two are not bitwise
equal because XLA contracts the step's multiply-adds into fused multiply-adds
on the CPU while the port rounds every product; over the 1,000+ steps of
these filters that difference carries into the state, and the level, trend
and season are differences of numbers of the data's size, so the bound is
absolute at the data's scale.  On these workloads the largest difference
used 7% of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.ops import fused_scan as tfs

torch.set_num_threads(1)

RTOL = 1e-5


def _workload(S, T, m, seed):
    """Seasonal level series with noise and ~10% missing cells, from numpy;
    whole numbers, as unit sales are (see test_torch_hw_score._workload)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    level = rng.uniform(20, 80, size=(S, 1)) + 0.02 * t[None, :]
    season = rng.uniform(2, 10, size=(S, 1)) * np.sin(2 * np.pi * t / m)[None]
    y = np.round(level + season + rng.normal(0, 2, size=(S, T))).astype(np.float32)
    mask = (rng.random((S, T)) > 0.1).astype(np.float32)
    return y * mask, mask


def _winners(S, damped, seed):
    """One grid candidate per row, as the grid search's argmin picks them."""
    grid = thw._candidate_grid(thw.HoltWintersConfig(damped=damped))
    best = np.random.default_rng(seed).integers(0, grid[0].numel(), S)
    return tuple(x.numpy()[best] for x in grid)


def _jax_filter(y, mask, params, m, mode):
    def one(ys, ms, a, b, g, p):
        return jhw._filter(ys, ms, a, b, g, m, mode, p)

    (l, b, s), mse, path = jax.vmap(one)(
        *(jnp.asarray(v) for v in (y, mask) + params))
    return tuple(np.asarray(v) for v in (l, b, s, mse, path))


def _port_filter(y, mask, params, m, mode):
    a, b, g, p = (torch.from_numpy(np.array(v)) for v in params)
    (l, tr, s), mse, path = tfs.hw_filter(torch.from_numpy(np.array(y)),
                                          torch.from_numpy(np.array(mask)),
                                          a, b, g, p, m, mode)
    return tuple(v.numpy() for v in (l, tr, s, mse, path))


def _assert_close(got, want, scale):
    names = ("level", "trend", "season", "mse", "fitted")
    for name, a, w in zip(names, got, want):
        assert a.shape == w.shape, name
        atol = 1e-5 * scale**2 if name == "mse" else 2e-5 * scale
        np.testing.assert_allclose(a, w, rtol=RTOL, atol=atol, err_msg=name)


def _cv_rows(S, T, seed):
    y, mask = _workload(S, T, 7, seed)
    day = np.arange(16_000, 16_000 + T, dtype=np.int32)
    conf = jcv.CVConfig(initial=120, period=60, horizon=30)
    cuts = jcv.cutoff_indices(T, conf)
    train = np.asarray(jcv.cv_windows(jnp.asarray(mask), jnp.asarray(day),
                                      cuts, conf.horizon)[0]).reshape(-1, T)
    return np.tile(y, (len(cuts), 1)), train


CASES = {
    # name: (m, mode, damped, S, T, seed)
    "additive_m7": (7, "additive", False, 6, 400, 3),
    "damped_m7": (7, "additive", True, 6, 400, 4),
    "multiplicative_m7": (7, "multiplicative", False, 6, 400, 5),
    "multiplicative_damped_m12": (12, "multiplicative", True, 5, 360, 6),
    "additive_m30": (30, "additive", False, 4, 300, 7),
    "damped_m30": (30, "additive", True, 4, 300, 8),
    "multiplicative_m30": (30, "multiplicative", False, 4, 300, 9),
    "additive_m365": (365, "additive", False, 2, 800, 10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_reference_filter(case):
    m, mode, damped, S, T, seed = CASES[case]
    y, mask = _workload(S, T, m, seed)
    params = _winners(S, damped, seed)
    got = _port_filter(y, mask, params, m, mode)
    _assert_close(got, _jax_filter(y, mask, params, m, mode), float(y.max()))


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_twin_matches_reference_filter_on_cv_train_masks(mode):
    # CV rows carry their predict-only tail into the path and final state
    y, train = _cv_rows(4, 300, seed=9)
    params = _winners(y.shape[0], True, seed=2)
    got = _port_filter(y, train, params, 7, mode)
    _assert_close(got, _jax_filter(y, train, params, 7, mode), float(y.max()))


def test_cpu_tensors_never_count_a_launch():
    y, mask = _workload(3, 60, 7, seed=1)
    before = tfs.hw_filter.launches
    _port_filter(y, mask, _winners(3, False, seed=1), 7, "additive")
    assert tfs.hw_filter.launches == before == 0


def test_fit_refits_the_winner_through_hw_filter(monkeypatch):
    y, mask = (torch.from_numpy(a) for a in _workload(3, 90, 7, seed=8))
    day = torch.arange(16_000, 16_090, dtype=torch.int32)
    calls = []

    def spy(*args):
        calls.append(args[6:])
        return tfs.hw_filter(*args)

    monkeypatch.setattr(thw, "hw_filter", spy)
    for mode in ("additive", "multiplicative"):
        thw.fit(y, mask, day, thw.HoltWintersConfig(seasonality_mode=mode))
    assert calls == [(7, "additive"), (7, "multiplicative")]


def test_row_cut_at_its_last_observed_step_scores_bitwise_the_same():
    # the scoring kernel stops each row there; the twin must not care
    y, mask = _workload(3, 200, 7, seed=11)
    mask[:, 150:] = 0.0
    mask[2, 120:] = 0.0
    y = y * mask
    grid = thw._candidate_grid(thw.HoltWintersConfig(damped=True))
    ends = tfs.row_ends(torch.from_numpy(mask)).tolist()
    full = tfs.hw_score_reference(torch.from_numpy(y), torch.from_numpy(mask),
                                  *grid, 7)
    for r, end in enumerate(ends):
        cut = tfs.hw_score_reference(torch.from_numpy(y[r:r + 1, :end].copy()),
                                     torch.from_numpy(mask[r:r + 1, :end].copy()),
                                     *grid, 7)
        assert torch.equal(cut[0], full[r])


def test_row_ends():
    mask = torch.tensor([[1, 0, 1, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 1.0]])
    assert tfs.row_ends(mask).tolist() == [3, 0, 5]
    assert tfs.row_ends(mask).dtype == torch.int32
    assert tfs.row_ends(torch.zeros(2, 0)).tolist() == [0, 0]


WORK_CASES = {
    # name: (mask, hand-counted operations per candidate and in all, for C)
    # row 0: observed 0, 1, 4 (a gap of 2 masked steps), a tail of 3 masked;
    # row 1: observed 0..7, no tail; row 2: nothing observed.  11 observed
    # steps of weight 1 x (18 per candidate + 1 for n), 2 masked steps before
    # a row's last observation x 2 per candidate; tails and row 2 cost 0
    "gap_and_tail": ([[1, 1, 0, 0, 1, 0, 0, 0],
                      [1, 1, 1, 1, 1, 1, 1, 1],
                      [0, 0, 0, 0, 0, 0, 0, 0]],
                     lambda C: 11 * (18 * C + 1) + 2 * 2 * C),
    # weights other than 1 cost one more (the error times the mask): one
    # unit step, two weighted ones, one masked step between them, a tail
    "weights": ([[0.5, 1, 0, 2, 0]],
                lambda C: 18 * C + 2 * 19 * C + 2 * C + 3),
    "nothing_observed": ([[0, 0, 0], [0, 0, 0]], lambda C: 0),
    "empty_history": (torch.zeros(2, 0), lambda C: 0),
}


@pytest.mark.parametrize("case", sorted(WORK_CASES))
def test_work_count_matches_a_hand_count(case):
    mask, want = WORK_CASES[case]
    mask = torch.as_tensor(mask, dtype=torch.float32)
    S, T = mask.shape
    C, m = 5, 7
    ops, nbytes = tfs.hw_score_work(mask, C, m)
    assert ops == want(C)
    assert nbytes == 4 * (2 * S * T + 4 * C + 2 * S + S * m + S * C)


def test_filter_work_count():
    ops, nbytes = tfs.hw_filter_work(500, 1826, 7)
    assert ops == 20 * 500 * 1826
    # y, mask read and the path written dominate: ~11 MB at the fit shape
    assert nbytes == 4 * (3 * 500 * 1826 + 9 * 500 + 2 * 500 * 7)


def test_wrapper_refuses_a_device_it_does_not_run_on():
    y, mask = (torch.from_numpy(a).to("meta") for a in _workload(2, 30, 7, seed=0))
    params = (torch.full((2,), 0.5, device="meta"),) * 4
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfs.hw_filter(y, mask, *params, 7, "additive")
