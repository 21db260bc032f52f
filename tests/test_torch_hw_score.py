"""Port parity: the Holt-Winters candidate-scoring function.

On CPU tensors the port's ``hw_score`` runs its plain twin (the CUDA kernel
is held against the twin on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  Here the twin is held against the reference's
Pallas kernel in interpret mode and against the reference's scan scores.

Tolerance: rtol 1e-5 / atol 1e-6, the reference's own bound between its
kernel and its scan (tests/unit/test_donation.py).  The scores are not
bitwise equal: XLA contracts the filter's multiply-adds into fused
multiply-adds on the CPU, while the port rounds every product, as its CUDA
kernel does.  Over these workloads the gap measured at most 6.1e-6 in
allclose's scale; the argmins must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.ops import fused_scan as jfs
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.ops import fused_scan as tfs

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _workload(S, T, m, seed):
    """Seasonal level series with noise and ~10% missing cells, from numpy.

    Values are whole numbers, as unit sales are: sums of whole numbers are
    exact in float32 in any order, so both frameworks start every filter
    from bitwise-equal initial states and the comparison sees only the
    per-step rounding.  (With fractional data a one-ulp difference in the
    initial level alone moves an MSE by ~1e-5 relative at alpha = 0.05.)"""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    level = rng.uniform(20, 80, size=(S, 1)) + 0.02 * t[None, :]
    season = rng.uniform(2, 10, size=(S, 1)) * np.sin(2 * np.pi * t / m)[None]
    y = np.round(level + season + rng.normal(0, 2, size=(S, T))).astype(np.float32)
    mask = (rng.random((S, T)) > 0.1).astype(np.float32)
    return y * mask, mask


def _grid(cfg):
    return tuple(np.asarray(v) for v in jhw._candidate_grid(cfg))


def _jax_scan_scores(y, mask, grid, m):
    A, B, G, P = (jnp.asarray(v) for v in grid)

    def per_series(ys, ms):
        def s(a, b, g, p):
            _, mse, _ = jhw._filter(ys, ms, a, b, g, m, "additive", p)
            return mse

        return jax.vmap(s)(A, B, G, P)

    return np.asarray(jax.vmap(per_series)(jnp.asarray(y), jnp.asarray(mask)))


def _port_scores(y, mask, grid, m):
    return tfs.hw_score(*(torch.from_numpy(np.array(v)) for v in (y, mask) + grid),
                        m).numpy()


CASES = {
    # name: (config, m, S, T, seed); T <= 120 where the Pallas interpreter runs
    "default_grid_m7": (jhw.HoltWintersConfig(), 7, 4, 84, 101),
    "damped_grid_m7": (jhw.HoltWintersConfig(damped=True), 7, 3, 70, 14),
    "small_grid_m12": (jhw.HoltWintersConfig(n_alpha=3, n_beta=2, n_gamma=2,
                                             season_length=12), 12, 5, 108, 14),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_reference_pallas_interpret_and_scan(case):
    cfg, m, S, T, seed = CASES[case]
    y, mask = _workload(S, T, m, seed)
    grid = _grid(cfg)
    got = _port_scores(y, mask, grid, m)
    want_kernel = np.asarray(jfs.hw_score(jnp.asarray(y), jnp.asarray(mask),
                                          *map(jnp.asarray, grid), m,
                                          interpret=True))
    want_scan = _jax_scan_scores(y, mask, grid, m)
    assert got.shape == want_kernel.shape == (S, grid[0].shape[0])
    np.testing.assert_allclose(got, want_kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_scan, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmin(1), want_kernel.argmin(1))
    np.testing.assert_array_equal(got.argmin(1), want_scan.argmin(1))


@pytest.mark.parametrize("m", [7, 12, 30])
def test_twin_matches_reference_scan_longer_history(m):
    # longer T than the interpreter allows: the reference's scan only
    y, mask = _workload(6, 400, m, seed=m)
    grid = _grid(jhw.HoltWintersConfig(season_length=m))
    got = _port_scores(y, mask, grid, m)
    want = _jax_scan_scores(y, mask, grid, m)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmin(1), want.argmin(1))


def test_twin_matches_reference_scan_on_cv_train_masks():
    # the CV pass scores rows whose history ends in a long masked run (each
    # cutoff's train mask), all cutoffs folded into one (C*S, T) batch
    from distributed_forecasting_tpu.engine import cv as jcv

    y, mask = _workload(4, 300, 7, seed=9)
    day = np.arange(16_000, 16_300, dtype=np.int32)
    conf = jcv.CVConfig(initial=120, period=60, horizon=30)
    cuts = jcv.cutoff_indices(300, conf)
    train = np.asarray(jcv.cv_windows(jnp.asarray(mask), jnp.asarray(day),
                                      cuts, conf.horizon)[0]).reshape(-1, 300)
    y_cv = np.tile(y, (len(cuts), 1))
    grid = _grid(jhw.HoltWintersConfig())
    got = _port_scores(y_cv, train, grid, 7)
    want = _jax_scan_scores(y_cv, train, grid, 7)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmin(1), want.argmin(1))


def test_multiplicative_raises_on_the_kernel_route():
    y, mask = (torch.from_numpy(a) for a in _workload(2, 30, 7, seed=0))
    day = torch.arange(16_000, 16_030, dtype=torch.int32)
    for filt in ("pallas", "auto"):
        cfg = thw.HoltWintersConfig(filter=filt,
                                    seasonality_mode="multiplicative")
        if filt == "pallas":
            with pytest.raises(ValueError, match="additive"):
                thw.fit(y, mask, day, cfg)
        else:  # 'auto' scans multiplicative seasonality, never the kernel
            assert thw.fit(y, mask, day, cfg).alpha.shape == (2,)


def test_cpu_tensors_never_count_a_launch():
    y, mask = _workload(3, 40, 7, seed=1)
    grid = _grid(jhw.HoltWintersConfig(n_alpha=2, n_beta=2, n_gamma=2))
    before = tfs.hw_score.launches
    _port_scores(y, mask, grid, 7)
    assert tfs.hw_score.launches == before == 0


def test_select_filter_routes_cuda_to_the_kernel():
    assert tfs.select_filter("cuda") == "pallas"
    assert tfs.select_filter("cpu") == "scan"


def test_wrapper_refuses_a_device_it_does_not_run_on():
    y, mask = (torch.from_numpy(a).to("meta") for a in _workload(2, 30, 7, seed=0))
    grid = [x.to("meta") for x in thw._candidate_grid(thw.HoltWintersConfig())]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfs.hw_score(y, mask, *grid, 7)
