"""Port parity: ``ops/metrics.wape``, ``rmsse`` and ``pinball`` against the
reference's, degenerate rows included.

The inputs come from numpy with a seed; the reference runs on the CPU.  The
rows hold a normal one, a partly masked one, an all-zero actuals row (wape
NaN), a constant training window (rmsse NaN: its naive scale is zero) and a
fully masked row.  Tolerance rtol 1e-6 / atol 1e-7: both sides reduce in
float32 in their own summation order (a few ulps apart at T 40).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.ops import metrics as jmetrics
from distributed_forecasting_tpu_torch.ops import metrics as tmetrics

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


def _rows(seed=0, T=40):
    rng = np.random.default_rng(seed)
    y = rng.gamma(2.0, 3.0, (5, T)).astype(np.float32)
    yhat = (y + rng.normal(0.0, 1.5, y.shape)).astype(np.float32)
    mask = np.ones_like(y)
    mask[1, ::3] = 0.0                      # partly masked
    y[2] = 0.0                              # all-zero actuals
    y[3, : T // 2] = 4.0                    # constant training window
    mask[4] = 0.0                           # fully masked
    train = np.zeros_like(y)
    train[:, : T // 2] = mask[:, : T // 2]
    evalm = np.zeros_like(y)
    evalm[:, T // 2:] = mask[:, T // 2:]
    return y, yhat, mask, train, evalm


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, equal_nan=True)


def test_wape_matches_the_reference():
    y, yhat, mask, _, _ = _rows()
    got = tmetrics.wape(*map(torch.from_numpy, (y, yhat, mask)))
    _close(got, jmetrics.wape(*map(jnp.asarray, (y, yhat, mask))))
    assert torch.isnan(got[2]) and torch.isnan(got[4])
    assert torch.isfinite(got[[0, 1, 3]]).all()


@pytest.mark.parametrize("m", [1, 7])
def test_rmsse_matches_the_reference(m):
    y, yhat, _, train, evalm = _rows(seed=1)
    got = tmetrics.rmsse(*map(torch.from_numpy, (y, yhat, evalm, train)),
                         m=m)
    _close(got, jmetrics.rmsse(*map(jnp.asarray, (y, yhat, evalm, train)),
                               m=m))
    # zero naive scale: the all-zero row, the constant window, no window
    assert torch.isnan(got[[2, 3, 4]]).all()


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9])
def test_pinball_matches_the_reference(q):
    y, yhat, mask, _, _ = _rows(seed=2)
    got = tmetrics.pinball(*map(torch.from_numpy, (y, yhat, mask)), q)
    _close(got, jmetrics.pinball(*map(jnp.asarray, (y, yhat, mask)), q))
    assert float(got[4]) == 0.0             # fully masked: 0, not NaN


def test_the_nan_metrics_stay_out_of_metric_fns():
    assert set(tmetrics.METRIC_FNS) == set(jmetrics.METRIC_FNS)
    assert not {"wape", "rmsse", "mase", "pinball"} & set(tmetrics.METRIC_FNS)
