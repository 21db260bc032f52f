"""The port's CUDA kernel on the card (skips where there is no CUDA device).

Run on a machine with an H100 (and nvcc) with
``python -m pytest tests/test_torch_cuda.py -m cuda``.  Imports only torch
and the port.

The kernel is built without multiply-add contraction and repeats its plain
twin's float32 operations in the same order, so the scores are held to the
twin bitwise; the fit the kernel scores is then bitwise the scan-scored fit.
"""

import dataclasses

import pytest
import torch

from distributed_forecasting_tpu_torch.models import holt_winters as hw
from distributed_forecasting_tpu_torch.ops import fused_scan as fs

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _workload(S, T, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.round(50 + 10 * torch.randn(S, T, generator=g))
    mask = (torch.rand(S, T, generator=g) > 0.1).float()
    return (y * mask).to(dev), mask.to(dev)


@pytest.mark.parametrize("cfg", [
    hw.HoltWintersConfig(),
    hw.HoltWintersConfig(damped=True),
    hw.HoltWintersConfig(season_length=30, n_alpha=3),
    hw.HoltWintersConfig(season_length=365),
], ids=["default", "damped", "m30", "m365"])
def test_kernel_equals_twin(dev, cfg):
    m = cfg.season_length
    y, mask = _workload(5, max(3 * m, 200), dev)
    grid = hw._candidate_grid(cfg, device=dev)
    before = fs.hw_score.launches
    got = fs.hw_score(y, mask, *grid, m)
    torch.cuda.synchronize()
    assert fs.hw_score.launches == before + 1
    want = fs.hw_score_reference(y, mask, *grid, m)
    assert torch.equal(got, want)


def test_kernel_equals_twin_on_cv_train_masks(dev):
    # the CV pass's rows: each cutoff's history ends in a long masked run of
    # predict-only steps
    from distributed_forecasting_tpu_torch.engine import cv

    y, mask = _workload(4, 300, dev, seed=5)
    day = torch.arange(16_000, 16_300, dtype=torch.int32, device=dev)
    conf = cv.CVConfig(initial=120, period=60, horizon=30)
    cuts = cv.cutoff_indices(300, conf)
    train = cv.cv_windows(mask, day, cuts, conf.horizon)[0].reshape(-1, 300)
    y_cv = y.repeat(len(cuts), 1)
    grid = hw._candidate_grid(hw.HoltWintersConfig(), device=dev)
    got = fs.hw_score(y_cv, train, *grid, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, fs.hw_score_reference(y_cv, train, *grid, 7))


def test_kernel_fit_equals_scan_fit(dev):
    y, mask = _workload(7, 150, dev, seed=3)
    day = torch.arange(16_000, 16_150, dtype=torch.int32, device=dev)
    for damped in (False, True):
        cfg = hw.HoltWintersConfig(filter="auto", damped=damped)
        p_k = hw.fit(y, mask, day, cfg)
        p_s = hw.fit(y, mask, day, dataclasses.replace(cfg, filter="scan"))
        for f in dataclasses.fields(p_k):
            assert torch.equal(getattr(p_k, f.name), getattr(p_s, f.name)), f.name


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    y, mask = _workload(3, 40, dev)
    grid = list(hw._candidate_grid(hw.HoltWintersConfig(), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fs.hw_score(y.t().contiguous().t(), mask, *grid, 7)
    grid[0] = grid[0].double()
    with pytest.raises(ValueError, match="float32"):
        fs.hw_score(y, mask, *grid, 7)
