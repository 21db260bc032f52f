"""The port's CUDA kernels on the card (skips where there is no CUDA device).

Run on a machine with an H100 (and nvcc) with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.  Imports
only torch and the port.

Scoring (``hw_score``) is tolerance-grade: the kernel contracts its
multiply-adds and stops each row after its last observed step, so its scores
are held to the plain twin within rtol 1e-5 / atol 1e-6 (the reference's own
kernel-vs-scan bound) and its argmins must equal the twin's or be near ties
within that tolerance; they are not bitwise equal.  The winner refit
(``hw_filter``) is built without contraction and repeats its twin's float32
operations in order, so it is held to ``_filter`` bit for bit; the fit the
kernel scores is then bitwise the scan-scored fit wherever the winners agree.

The curve model runs no hand kernel: its Gram is one cuBLAS GEMM and its
solve cuSOLVER's batched Cholesky with cuBLAS triangular solves.  Those are
held to the floored Cholesky twin (the CPU route) on the card at the main
path's shapes, within ``10 * cond(A) * 2^-24`` of each row's scale; an
indefinite system must come out NaN and be flagged by the fail-safe; the
Gram must build no (S, T, F) intermediate; the solve must not sync.

The arnet family's trainer (``engine/gradfit.py``) runs no hand kernel; its
invariants are held bit for bit on the card: the engine path equals the
family's trainer, bucket growth changes nothing, one seed gives one fit,
and a series trains alone as beside others.  On one injected schedule the
card's fit is the CPU's within float32 (summation order and Adam's fused
arithmetic differ).  The curve model's Monte-Carlo branch and the tuned
path run on the card at small shapes against the CPU on the same draws.

The MLE fit's kernels (``csrc/arima_mle.cu``) repeat their twins' float32
operations in order: the likelihood gradient is held to its twin bit for
bit, and its primal to ``arima_filter``'s; the whole fit (one launch) to
``mle_fit_reference`` bit for bit after 1, 30 and 200 steps.
"""

import dataclasses

import pytest
import torch

from distributed_forecasting_tpu_torch.models import holt_winters as hw
from distributed_forecasting_tpu_torch.ops import fused_scan as fs

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _workload(S, T, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.round(50 + 10 * torch.randn(S, T, generator=g))
    mask = (torch.rand(S, T, generator=g) > 0.1).float()
    return (y * mask).to(dev), mask.to(dev)


def _cv_rows(dev, S=4, T=300, seed=5):
    # the CV pass's rows: each cutoff's history ends in a long masked run of
    # predict-only steps
    from distributed_forecasting_tpu_torch.engine import cv

    y, mask = _workload(S, T, dev, seed=seed)
    day = torch.arange(16_000, 16_000 + T, dtype=torch.int32, device=dev)
    conf = cv.CVConfig(initial=120, period=60, horizon=30)
    cuts = cv.cutoff_indices(T, conf)
    train = cv.cv_windows(mask, day, cuts, conf.horizon)[0].reshape(-1, T)
    return y.repeat(len(cuts), 1), train


def _assert_scores_close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    a_got, a_want = got.argmin(1), want.argmin(1)
    rows = torch.nonzero(a_got != a_want).flatten()
    w_got, w_want = want[rows, a_got[rows]], want[rows, a_want[rows]]
    assert bool(((w_got - w_want).abs() <= ATOL + RTOL * w_want.abs()).all())


@pytest.mark.parametrize("cfg", [
    hw.HoltWintersConfig(),
    hw.HoltWintersConfig(damped=True),
    hw.HoltWintersConfig(season_length=30, n_alpha=3),
    hw.HoltWintersConfig(season_length=365),
], ids=["default", "damped", "m30", "m365"])
def test_kernel_equals_twin(dev, cfg):
    m = cfg.season_length
    y, mask = _workload(5, max(3 * m, 1200), dev)
    grid = hw._candidate_grid(cfg, device=dev)
    before = fs.hw_score.launches
    got = fs.hw_score(y, mask, *grid, m)
    torch.cuda.synchronize()
    assert fs.hw_score.launches == before + 1
    _assert_scores_close(got, fs.hw_score_reference(y, mask, *grid, m))


@pytest.mark.parametrize("n_cand,m", [
    (4, 7),      # a tiny grid still fills one warp
    (288, 30),   # three warps of a monthly season fit one block
    (288, 365),  # a year: one warp a block, three blocks a series
    (128, 500),  # the block cut to one warp, two blocks a series
])
def test_kernel_equals_twin_where_the_launcher_shapes_the_grid(dev, n_cand, m):
    # the launcher picks threads and blocks from (C, m); every shape it
    # picks must score every candidate
    y, mask = _workload(3, 2 * m + 50, dev, seed=n_cand)
    g = torch.Generator().manual_seed(m)
    grid = [(lo + (hi - lo) * torch.rand(n_cand, generator=g)).to(dev)
            for lo, hi in ((0.05, 0.95), (0.01, 0.4), (0.05, 0.6), (0.8, 1.0))]
    got = fs.hw_score(y, mask, *grid, m)
    torch.cuda.synchronize()
    _assert_scores_close(got, fs.hw_score_reference(y, mask, *grid, m))


def test_kernels_refuse_a_season_past_shared_memory(dev):
    y, mask = _workload(2, 4100, dev)
    grid = hw._candidate_grid(hw.HoltWintersConfig(), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        fs.hw_score(y, mask, *grid, 2000)
    with pytest.raises(ValueError, match="shared memory"):
        fs.hw_filter(y, mask, *_winners(2, dev), 2000, "additive")


def test_kernel_equals_twin_on_cv_train_masks(dev):
    y_cv, train = _cv_rows(dev)
    grid = hw._candidate_grid(hw.HoltWintersConfig(), device=dev)
    got = fs.hw_score(y_cv, train, *grid, 7)
    torch.cuda.synchronize()
    _assert_scores_close(got, fs.hw_score_reference(y_cv, train, *grid, 7))


def test_kernel_scores_a_row_view_off_the_16_byte_boundary(dev):
    # rows start anywhere: a view one row in starts 4 * T bytes on
    y, mask = _workload(6, 301, dev, seed=2)
    grid = hw._candidate_grid(hw.HoltWintersConfig(), device=dev)
    got = fs.hw_score(y[1:], mask[1:], *grid, 7)
    torch.cuda.synchronize()
    _assert_scores_close(got, fs.hw_score_reference(y[1:], mask[1:], *grid, 7))


def test_kernel_fit_equals_scan_fit(dev):
    y, mask = _workload(7, 150, dev, seed=3)
    day = torch.arange(16_000, 16_150, dtype=torch.int32, device=dev)
    for damped in (False, True):
        cfg = hw.HoltWintersConfig(filter="auto", damped=damped)
        p_k = hw.fit(y, mask, day, cfg)
        p_s = hw.fit(y, mask, day, dataclasses.replace(cfg, filter="scan"))
        same = torch.ones(7, dtype=torch.bool, device=dev)
        for f in ("alpha", "beta", "gamma", "phi"):
            same &= getattr(p_k, f) == getattr(p_s, f)
        assert bool(same.any())
        for f in dataclasses.fields(p_k):
            a, b = getattr(p_k, f.name), getattr(p_s, f.name)
            if a.dim() and a.shape[0] == 7:
                a, b = a[same], b[same]
            assert torch.equal(a, b), f.name


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    y, mask = _workload(3, 40, dev)
    grid = list(hw._candidate_grid(hw.HoltWintersConfig(), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fs.hw_score(y.t().contiguous().t(), mask, *grid, 7)
    grid[0] = grid[0].double()
    with pytest.raises(ValueError, match="float32"):
        fs.hw_score(y, mask, *grid, 7)


def _winners(S, dev, damped=False, seed=0):
    # one grid candidate per row, as fit's argmin picks them
    grid = hw._candidate_grid(hw.HoltWintersConfig(damped=damped), device=dev)
    g = torch.Generator().manual_seed(seed)
    best = torch.randint(0, grid[0].numel(), (S,), generator=g).to(dev)
    return tuple(x[best] for x in grid)


def _assert_filter_equals_twin(y, mask, params, m, mode):
    before = fs.hw_filter.launches
    (l, b, s), mse, path = fs.hw_filter(y, mask, *params, m, mode)
    torch.cuda.synchronize()
    assert fs.hw_filter.launches == before + 1
    a, be, g, p = params
    (l2, b2, s2), mse2, path2 = hw._filter(y, mask, a, be, g, m, mode, p)
    for got, want in ((l, l2), (b, b2), (s, s2), (mse, mse2), (path, path2)):
        assert got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,mode,damped", [
    (7, "additive", False),
    (7, "additive", True),
    (7, "multiplicative", False),
    (30, "additive", True),
    (30, "multiplicative", False),
    (365, "additive", False),
], ids=["m7", "m7_damped", "m7_mult", "m30_damped", "m30_mult", "m365"])
def test_filter_kernel_equals_twin_bitwise(dev, m, mode, damped):
    S = 70  # three blocks, the last one part-full
    y, mask = _workload(S, max(3 * m, 500), dev, seed=m)
    _assert_filter_equals_twin(y, mask, _winners(S, dev, damped), m, mode)


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_filter_kernel_equals_twin_on_cv_train_masks(dev, mode):
    y_cv, train = _cv_rows(dev)
    S = y_cv.shape[0]
    _assert_filter_equals_twin(y_cv, train, _winners(S, dev, seed=1), 7, mode)


def _same_bits_or_nan(got, want):
    """Equal element for element, NaN where the other has NaN."""
    return (got.shape == want.shape
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(torch.nan_to_num(got, nan=0.0, posinf=float("inf"),
                                             neginf=float("-inf")),
                            torch.nan_to_num(want, nan=0.0,
                                             posinf=float("inf"),
                                             neginf=float("-inf"))))


# what the chunk ring and the producers' copies can break: a history
# shorter than one chunk (63 steps at m 7, 64 otherwise),
# one season (T = m, None below: the shortest history the initial state
# takes; T = 1 is the season-of-one test's), a length that is a multiple of
# neither the chunk nor m, one row, a second block holding one row
FILTER_EDGES = {"T40": (70, 40), "Tm": (70, None), "T200": (70, 200),
                "S1": (1, 300), "S33": (33, 300)}
FILTER_INSTANCES = {"m7": (7, "additive"), "m7_mult": (7, "multiplicative"),
                    "m30": (30, "additive")}


@pytest.mark.parametrize("instance", list(FILTER_INSTANCES))
@pytest.mark.parametrize("edge", list(FILTER_EDGES))
def test_filter_kernel_equals_twin_at_the_ring_edges(dev, edge, instance):
    S, T = FILTER_EDGES[edge]
    m, mode = FILTER_INSTANCES[instance]
    T = T or m
    y, mask = _workload(S, T, dev, seed=T + S)
    _assert_filter_equals_twin(y, mask, _winners(S, dev, seed=S), m, mode)


@pytest.mark.parametrize("instance", list(FILTER_INSTANCES))
def test_filter_kernel_equals_twin_on_masked_rows_and_nan(dev, instance):
    """A row masked throughout, and NaN in y: on an observed step it runs
    through the row's state, on a masked step only into its MSE."""
    m, mode = FILTER_INSTANCES[instance]
    S, T = 40, 300
    y, mask = _workload(S, T, dev, seed=11)
    mask[3] = 0.0
    y[3] = 0.0
    y[5, 100], mask[5, 100] = float("nan"), 1.0
    y[6, 50], mask[6, 50] = float("nan"), 0.0
    y[33, 299], mask[33, 299] = float("nan"), 1.0
    params = _winners(S, dev, seed=2)
    (l, b, s), mse, path = fs.hw_filter(y, mask, *params, m, mode)
    a, be, g, p = params
    (l2, b2, s2), mse2, path2 = hw._filter(y, mask, a, be, g, m, mode, p)
    torch.cuda.synchronize()
    assert bool(mse.isnan()[5]) and bool(mse.isnan()[6])
    for got, want in ((l, l2), (b, b2), (s, s2), (mse, mse2), (path, path2)):
        assert _same_bits_or_nan(got, want)


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_filter_kernel_equals_twin_past_one_wave(dev, mode):
    """At m 7 a grid larger than one wave of fifteen-producer blocks (one
    an SM) runs seven producers a block: one row past one block an SM."""
    S = 32 * torch.cuda.get_device_properties(dev).multi_processor_count + 1
    y, mask = _workload(S, 200, dev, seed=5)
    _assert_filter_equals_twin(y, mask, _winners(S, dev, seed=5), 7, mode)


@pytest.mark.parametrize("T", [1, 200])
@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_filter_kernel_takes_a_season_of_one(dev, mode, T):
    """m = 1 runs on the shared-memory season, whose next slot is the
    current one."""
    y, mask = _workload(35, T, dev, seed=1)
    _assert_filter_equals_twin(y, mask, _winners(35, dev, seed=3), 1, mode)


def test_fit_refits_through_the_filter_kernel(dev):
    y, mask = _workload(5, 120, dev, seed=4)
    day = torch.arange(16_000, 16_120, dtype=torch.int32, device=dev)
    before = (fs.hw_score.launches, fs.hw_filter.launches)
    hw.fit(y, mask, day, hw.HoltWintersConfig(filter="auto"))
    assert (fs.hw_score.launches, fs.hw_filter.launches) == (
        before[0] + 1, before[1] + 1)


def test_filter_wrapper_refuses_what_the_kernel_does_not_take(dev):
    y, mask = _workload(3, 40, dev)
    params = list(_winners(3, dev))
    l0, b0, s0 = hw._init_state(y, mask, 7, "additive")
    with pytest.raises(ValueError, match="contiguous"):
        fs._hw_filter_cuda(y.t().contiguous().t(), mask, *params,
                           l0, b0, s0.contiguous(), "additive")
    params[1] = params[1].double()
    with pytest.raises(ValueError, match="float32"):
        fs.hw_filter(y, mask, *params, 7, "additive")


# -- the curve model's library route -----------------------------------------

def _curve_systems(dev, cv_rows=False):
    """The normal equations of the default configuration on the committed
    dataset: 500 series (or the CV pass's 1,500 rows) x 1,826 days."""
    import os

    from distributed_forecasting_tpu_torch import data
    from distributed_forecasting_tpu_torch.engine import cv
    from distributed_forecasting_tpu_torch.models import prophet_glm as pg
    from distributed_forecasting_tpu_torch.ops import solve
    from distributed_forecasting_tpu_torch.pipelines.training import (
        _resolve_holidays_conf,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csv = os.path.join(root, "datasets", "store_item_demand.csv.gz")
    b = data.tensorize(data.load_sales_csv(csv), device=dev)
    cfg = pg.CurveModelConfig(**_resolve_holidays_conf({"holidays": "US"}, b, 90))
    y, mask = b.y, b.mask
    if cv_rows:
        cuts = cv.cutoff_indices(b.n_time, cv.CVConfig())
        mask = cv.cv_windows(mask, b.day, cuts, 90)[0].reshape(-1, b.n_time)
        y = y.repeat(len(cuts), 1)
    zn, _, _ = pg._fit_target(y, mask, cfg)
    X, layout = pg._design(b.day, b.day[0].float(), b.day[-1].float(), cfg)
    lam = pg._prior_precision(layout, cfg, device=dev)
    A, rhs = solve.normal_equations(X, zn, mask, lam)
    return X, A, rhs


@pytest.mark.parametrize("cv_rows", [False, True], ids=["fit_500", "cv_1500"])
def test_cusolver_route_equals_floored_twin(dev, cv_rows):
    from distributed_forecasting_tpu_torch.ops import solve

    X, A, rhs = _curve_systems(dev, cv_rows)
    _, info = torch.linalg.cholesky_ex(A)
    assert int((info != 0).sum()) == 0
    got = solve.batched_cho_solve(A, rhs)
    want = solve._solve_cholesky_floored(A, rhs)
    tol = 10 * float(torch.linalg.cond(A.double()).max()) * 2.0**-24
    for g, w in ((got, want), (got @ X.T, want @ X.T)):
        scale = w.abs().amax(dim=1, keepdim=True)
        assert bool(((g - w).abs() <= tol * scale).all()), tol


def test_indefinite_system_is_nan_and_flagged(dev):
    from distributed_forecasting_tpu_torch.engine.fit import health_fallback
    from distributed_forecasting_tpu_torch.ops import solve

    g = torch.Generator().manual_seed(0)
    M = torch.randn(4, 6, 6, generator=g)
    A = (M @ M.mT + 6 * torch.eye(6)).to(dev)
    A[2] = -A[2]  # not definite: potrf stops at its first pivot
    x = solve.batched_cho_solve(A, torch.ones(4, 6, device=dev))
    assert bool(torch.isnan(x[2]).all())
    assert bool(torch.isfinite(x[[0, 1, 3]]).all())
    path = x @ torch.ones(6, 20, device=dev)
    y = torch.ones(4, 15, device=dev)
    _, _, _, ok = health_fallback(y, torch.ones_like(y), path, path, path, 5,
                                  min_points=10)
    assert ok.tolist() == [True, True, False, True]


def test_gram_builds_no_series_by_time_by_feature_tensor(dev):
    from distributed_forecasting_tpu_torch.ops import solve

    S, T, F = 500, 1826, 61
    X = torch.randn(T, F, device=dev)
    w = (torch.rand(S, T, device=dev) > 0.1).float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    G = solve.masked_gram(X, w)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < S * T * F * 4 / 4, peak  # a quarter of the (S, T, F) size
    want = torch.einsum("st,tf,tg->sfg", w.double(), X.double(), X.double())
    torch.testing.assert_close(G.double(), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_solve_makes_no_host_sync(dev):
    from distributed_forecasting_tpu_torch.ops import solve

    X, A, rhs = _curve_systems(dev)
    solve.batched_cho_solve(A, rhs)  # warm the libraries' handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solve.batched_cho_solve(A, rhs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# -- split-conformal calibration (engine/calibrate): torch.sort and gathers,
# no hand kernel.  The same float32 scores on both devices give the same
# ranks and, up to one rounding of the division, the same scales.

def _conformal_paths(dev, C=3, S=64, T=400, seed=9):
    g = torch.Generator().manual_seed(seed)
    y = torch.round(40 + 8 * torch.randn(S, T, generator=g))
    yhat = y[None] + 3 * torch.randn(C, S, T, generator=g)
    hi = yhat + (5 + torch.randn(C, S, T, generator=g)).abs()
    em = (torch.rand(C, S, T, generator=g) < 0.2).float()
    em[:, :4] = 0.0                      # empty: pooled
    em[:, 4:8] = em[:, 4:8] * (torch.rand(S, T, generator=g)[4:8] < 0.05)
    hi[:, 8] = yhat[:, 8]                # degenerate band
    return [x.to(dev) for x in (y, yhat, hi, em)]


def test_conformal_scale_on_the_card_equals_cpu(dev):
    from distributed_forecasting_tpu_torch.engine import calibrate as cal

    paths = _conformal_paths(dev)
    got = cal.conformal_scale_from_paths(*paths)
    want = cal.conformal_scale_from_paths(*(x.cpu() for x in paths))
    torch.testing.assert_close(got.cpu(), want, rtol=2.0 ** -23, atol=0)
    assert torch.isfinite(got).all() and (got > 0).all()


def test_conformal_scale_makes_no_host_sync(dev):
    from distributed_forecasting_tpu_torch.engine import calibrate as cal

    paths = _conformal_paths(dev)
    cal.conformal_scale_from_paths(*paths)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cal.conformal_scale_from_paths(*paths)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# -- the pooled families (model: blend | auto) --------------------------------

def _pool_batch(dev, S=24, T=400):
    from distributed_forecasting_tpu_torch import data

    df = data.synthetic_store_item_sales(n_stores=3, n_items=S // 3,
                                         n_days=T, seed=2)
    df["sales"] = df["sales"].round()
    df.loc[df["item"] == 1, "sales"] = 0.0  # one intermittent item a store
    df.loc[(df["item"] == 1) & (df.index % 9 == 0), "sales"] = 5.0
    return data.tensorize(df, device=dev)


def test_blend_on_the_card_launches_both_kernels_three_times(dev):
    """The holt_winters member scores and refits through the kernels in each
    of the blend's three passes (its CV for the weights, the pooled CV for
    the conformal scale, the full-history fit), at its default config."""
    from distributed_forecasting_tpu_torch.engine import blend, cv

    b = _pool_batch(dev)
    before = (fs.hw_score.launches, fs.hw_filter.launches)
    _, pool, res = blend.fit_forecast_blend(
        b, models=("holt_winters", "croston"), horizon=30, calibrate=True,
        cv=cv.CVConfig(initial=200, period=60, horizon=30))
    assert (fs.hw_score.launches - before[0],
            fs.hw_filter.launches - before[1]) == (3, 3)
    assert res.yhat.device.type == "cuda"
    assert pool.interval_scale.shape == (b.n_series,)


def test_croston_on_the_card_equals_the_cpu(dev):
    """The recurrence runs the same float32 operations on either device
    (the kernel on the card, its twin on the CPU): the fit, then the
    streaming update of its last 30 days from the fit of the rest, equal
    within rtol 1e-6 / atol 1e-6 of the data's scale (the initial means and
    the squared-error sum reduce in a different order).  The fit and the
    update launch the kernel once each; theta's fit and update likewise."""
    import numpy as np

    from distributed_forecasting_tpu_torch.models import croston as cr
    from distributed_forecasting_tpu_torch.models import theta as th
    from distributed_forecasting_tpu_torch.ops import ses

    b = _pool_batch(dev)
    T = b.y.shape[1] - 30
    scale = float(b.y.abs().max())
    days = b.day[T:].cpu().numpy()
    for mod, cfgs, kernel, fields in (
            (cr, [cr.CrostonConfig(variant=v) for v in ("croston", "sba",
                                                        "tsb")],
             ses.croston_filter, ("z_level", "p_level", "sigma", "fitted")),
            (th, [th.ThetaConfig()], ses.ses_filter,
             ("level", "alpha", "sigma", "fitted"))):
        for cfg in cfgs:
            out = {}
            for where in ("cuda", "cpu"):
                y, m, d = (x.to(where) for x in (b.y, b.mask, b.day))
                before = kernel.launches
                p = mod.fit(y[:, :T], m[:, :T], d[:T], cfg)
                aux = mod.init_update_aux(p, y[:, :T].cpu().numpy(),
                                          m[:, :T].cpu().numpy())
                p2, aux2, preds = mod.update_state(
                    p, aux, y[:, T:], m[:, T:], np.ones(30, np.float32),
                    days, cfg)
                assert kernel.launches - before == (2 if where == "cuda"
                                                    else 0)
                out[where] = (p, p2, preds, aux2)
            (p, p2, preds, aux2), (q, q2, qpreds, qaux2) = (out["cuda"],
                                                            out["cpu"])
            for f in fields:
                for got, want in ((p, q), (p2, q2)):
                    torch.testing.assert_close(
                        getattr(got, f).cpu(), getattr(want, f), rtol=1e-6,
                        atol=1e-6 * scale)
            torch.testing.assert_close(preds.cpu(), qpreds, rtol=1e-6,
                                       atol=1e-6 * scale)
            for k in aux2:
                torch.testing.assert_close(aux2[k].cpu(), qaux2[k],
                                           rtol=1e-6, atol=1e-6 * scale)


def test_season_detection_on_the_card_equals_the_cpu(dev):
    from distributed_forecasting_tpu_torch.engine import season

    b = _pool_batch(dev)
    got = season.acf_scores_impl(b.y, b.mask, 133)
    want = season.acf_scores_impl(b.y.cpu(), b.mask.cpu(), 133)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    assert season.detect_season_length(b) == 7


# -- the croston and theta recurrences (csrc/ses.cu) ---------------------------
#
# Both kernels repeat their twins' float32 operations in order (no
# contraction, IEEE division, the host's float32 constants): held to the
# twins (ops/ses.*_reference, run on the card) bit for bit.

def _intermittent(S, T, dev, seed=0, edges=True):
    """Intermittent demand (about half the days zero, ~10% masked) with,
    where the shape allows, an all-zero row, a fully masked row, NaN in y
    on an observed and on a masked day, and a non-binary mask."""
    g = torch.Generator().manual_seed(seed)
    y = torch.round(torch.rand(S, T, generator=g) * 20.0)
    y = torch.where(torch.rand(S, T, generator=g) < 0.5, 0.0, y)
    mask = (torch.rand(S, T, generator=g) > 0.1).float()
    if edges and S >= 8 and T >= 3:
        y[1] = 0.0
        mask[2] = 0.0
        y[3, T // 2], mask[3, T // 2] = float("nan"), 1.0
        y[4, 1], mask[4, 1] = float("nan"), 0.0
        mask[5, ::2] = 0.5
        mask[6] = 0.25
    return y.to(dev), mask.to(dev)


def _croston_carry(y, mask, variant):
    """The fit's initial carries for time-major y, mask."""
    from distributed_forecasting_tpu_torch.models.croston import initial_carry

    return tuple(c.contiguous() for c in initial_carry(y.t(), mask.t(),
                                                       variant))


def _assert_all_same_bits(got, want):
    for a, b in zip(got, want):
        assert _same_bits_or_nan(a, b)


def _croston_equals_twin(y_t, m_t, variant, sums=False, alpha=0.1, beta=0.1):
    from distributed_forecasting_tpu_torch.ops import ses

    carry = _croston_carry(y_t, m_t, variant)
    S = y_t.shape[1]
    s0 = ((torch.rand(S, device=y_t.device) * 10).contiguous(),
          torch.full((S,), 3.0, device=y_t.device)) if sums else None
    before = ses.croston_filter.launches
    path, c, sm = ses.croston_filter(y_t, m_t, carry, alpha, variant, beta,
                                     sums=s0)
    assert ses.croston_filter.launches == before + 1
    path2, c2, sm2 = ses.croston_filter_reference(y_t, m_t, carry, alpha,
                                                  variant, beta, sums=s0)
    torch.cuda.synchronize()
    _assert_all_same_bits((path, *c, *(sm or ())),
                          (path2, *c2, *(sm2 or ())))


CROSTON_SHAPES = {"fit": (500, 1826), "cv": (1500, 1706), "T1": (40, 1),
                  "T2": (40, 2), "wave": (132 * 32 * 32 + 1, 40)}


@pytest.mark.parametrize("shape", list(CROSTON_SHAPES))
@pytest.mark.parametrize("variant", ["croston", "sba", "tsb"])
def test_croston_filter_kernel_equals_twin_bitwise(dev, variant, shape):
    """The fit and CV shapes (the CV rows with their train masks: every
    cutoff's tail masked), T 1 and 2, and more rows than one wave of
    32-row blocks; the edge rows of :func:`_intermittent`."""
    S, T = CROSTON_SHAPES[shape]
    y, mask = _intermittent(S, T, dev, seed=S + T, edges=shape != "wave")
    if shape == "cv":
        cut = torch.tensor([1326, 1516, 1706], device=dev).repeat_interleave(
            S // 3)
        mask = mask * (torch.arange(T, device=dev)[None, :] < cut[:, None])
    _croston_equals_twin(y.t().contiguous(), mask.t().contiguous(), variant)


@pytest.mark.parametrize("variant", ["croston", "sba", "tsb"])
@pytest.mark.parametrize("T", [1, 2, 37])
def test_croston_filter_kernel_sums_equal_twin_bitwise(dev, variant, T):
    """The streaming update's form: the squared one-step error and the
    count summed on from given (sse, n_obs), a non-default alpha and beta."""
    y, mask = _intermittent(40, T, dev, seed=T)
    _croston_equals_twin(y.t().contiguous(), mask.t().contiguous(), variant,
                         sums=True, alpha=0.3, beta=0.2)


def _ses_inputs(S, T, dev, seed=0, edges=True):
    y, mask = _intermittent(S, T, dev, seed=seed, edges=edges)
    z = torch.where(torch.isnan(y), y, y * 1.7 - 3.0)       # a theta line
    l0 = (torch.rand(S, generator=torch.Generator().manual_seed(seed))
          * 10.0).to(dev)
    return z.t().contiguous(), mask.t().contiguous(), l0


SES_SHAPES = {"fit": (500, 1826), "cv": (1683, 1706), "T1": (40, 1),
              "T2": (40, 2), "wave": (20_000, 40)}


@pytest.mark.parametrize("shape", list(SES_SHAPES))
def test_ses_filter_kernel_equals_twin_bitwise(dev, shape):
    """Theta's seven alphas shared across rows (A 7; past one wave of
    32-lane blocks at 140,000 lanes), the fit and CV shapes, T 1 and 2."""
    from distributed_forecasting_tpu_torch.models.theta import ThetaConfig
    from distributed_forecasting_tpu_torch.ops import ses

    S, T = SES_SHAPES[shape]
    z, mask, l0 = _ses_inputs(S, T, dev, seed=S + T, edges=shape != "wave")
    alpha = torch.tensor(ThetaConfig().alphas, device=dev)[None].expand(
        S, 7).contiguous()
    before = ses.ses_filter.launches
    buf = ses.ses_filter(z, mask, l0, alpha)
    assert ses.ses_filter.launches == before + 1
    want = ses.ses_filter_reference(z, mask, l0, alpha)
    torch.cuda.synchronize()
    assert _same_bits_or_nan(buf, want)


@pytest.mark.parametrize("T", [1, 2, 37])
def test_ses_filter_kernel_scored_equals_twin_bitwise(dev, T):
    """One alpha a row (A 1), the streaming update's form: the levels, the
    fitted values and the error sums."""
    from distributed_forecasting_tpu_torch.ops import ses

    S = 40
    z, mask, l0 = _ses_inputs(S, T, dev, seed=T)
    g = torch.Generator().manual_seed(T)
    alpha = torch.tensor([0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.8])[
        torch.randint(0, 7, (S,), generator=g)][:, None].to(dev)
    y = (torch.rand(T, S, generator=g) * 30).to(dev)
    trend = (torch.rand(T, S, generator=g) * 5 + 10).to(dev)
    si = (torch.rand(T, S, generator=g) + 0.5).to(dev)
    scored = (y, trend, si, 2.0, torch.rand(S, generator=g).to(dev),
              torch.full((S,), 5.0, device=dev))
    got = ses.ses_filter(z, mask, l0, alpha, scored=scored)
    want = ses.ses_filter_reference(z, mask, l0, alpha, scored=scored)
    torch.cuda.synchronize()
    _assert_all_same_bits(got, want)


def test_ses_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from distributed_forecasting_tpu_torch.ops import ses

    z, mask, l0 = _ses_inputs(8, 20, dev)
    alpha = torch.full((8, 7), 0.1, device=dev)
    with pytest.raises(ValueError, match="float32"):
        ses.ses_filter(z.double(), mask, l0, alpha)
    with pytest.raises(ValueError, match="contiguous"):
        ses.ses_filter(z, mask, l0, alpha[:, ::2])
    with pytest.raises(ValueError, match="one alpha a row"):
        ses.ses_filter(z, mask, l0, alpha, scored=(z, z, z, 2.0, l0, l0))
    carry = _croston_carry(z, mask, "sba")
    with pytest.raises(ValueError, match="carry"):
        ses.croston_filter(z, mask, carry[:2], 0.1, "sba")
    with pytest.raises(ValueError, match="on cuda"):
        ses.croston_filter(z, mask, tuple(c.cpu() for c in carry), 0.1,
                           "sba")


# -- the arima family's kernels (csrc/arima_kalman.cu) ------------------------
#
# Both kernels repeat their twins' float32 operations in order, with no
# contraction (the structured products of models/arima, IEEE division, logf):
# held to the twins bit for bit.

def _arima_inputs(dev, cfg, S=6, T=300, seed=3, leading=25):
    from distributed_forecasting_tpu_torch.models import arima

    y, mask = _workload(S, T, dev, seed=seed)
    mask[0, :leading] = 0.0  # a leading masked stretch: y_first
    mask[1, -20:] = 0.0      # a trailing one: the level carried forward
    y = y * mask
    g = torch.Generator().manual_seed(seed)
    ar, ma, p, q = arima._lag_sets(cfg)
    phi = (0.8 * torch.rand(S, p, generator=g) - 0.4) / max(len(ar), 1)
    theta = (0.8 * torch.rand(S, q, generator=g) - 0.4) / max(len(ma), 1)
    zc, zmask, mean = arima._centered(y, mask, cfg.d)
    return (zc.contiguous(), zmask.contiguous(), y, mask, phi.to(dev),
            theta.to(dev), mean.contiguous(), arima._effective_r(cfg), cfg.d)


ARIMA_CASES = {
    "211": dict(p=2, d=1, q=1),
    "d0": dict(p=1, d=0, q=2),
    "seasonal_r8": dict(p=1, d=1, q=1, P=1, Q=1, m=7),
    "warp_r13": dict(p=1, d=1, q=1, P=1, m=13),
}


@pytest.mark.parametrize("case", list(ARIMA_CASES))
def test_arima_filter_kernel_equals_twin_bitwise(dev, case):
    from distributed_forecasting_tpu_torch.models import arima
    from distributed_forecasting_tpu_torch.ops import kalman

    args = _arima_inputs(dev, arima.ArimaConfig(**ARIMA_CASES[case]))
    before = kalman.arima_filter.launches
    got = kalman.arima_filter(*args)
    want = kalman.arima_filter_reference(*args)
    torch.cuda.synchronize()
    assert kalman.arima_filter.launches == before + 1
    for name, g, w in zip(kalman.FilterOutputs._fields, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and torch.equal(g, w), name


def test_arima_filter_kernel_equals_twin_on_cv_train_masks(dev):
    from distributed_forecasting_tpu_torch.models import arima
    from distributed_forecasting_tpu_torch.ops import kalman

    y, train = _cv_rows(dev)
    zc, zmask, mean = arima._centered(y, train, 1)
    S = y.shape[0]
    phi = torch.full((S, 2), 0.2, device=dev)
    theta = torch.full((S, 1), -0.3, device=dev)
    args = (zc.contiguous(), zmask.contiguous(), y, train, phi, theta,
            mean.contiguous(), 2, 1)
    for g, w in zip(kalman.arima_filter(*args),
                    kalman.arima_filter_reference(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["211", "seasonal_r8", "warp_r13"])
def test_arima_predict_kernel_equals_twin_bitwise(dev, case):
    from distributed_forecasting_tpu_torch.models import arima
    from distributed_forecasting_tpu_torch.ops import kalman

    cfg = arima.ArimaConfig(**ARIMA_CASES[case])
    args = _arima_inputs(dev, cfg)
    out = kalman.arima_filter_reference(*args)
    sigma2 = out.ssq / torch.clamp_min(out.n, 1.0)
    pargs = (args[4], args[5], out.a_T, out.P_T, sigma2, args[7])
    for H in (1, 91, 400):
        before = kalman.arima_predict.launches
        got = kalman.arima_predict(*pargs, H)
        want = kalman.arima_predict_reference(*pargs, H)
        torch.cuda.synchronize()
        assert kalman.arima_predict.launches == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("S", [2, 33, 70])
@pytest.mark.parametrize("case", ["211", "d0", "seasonal_r8"])
def test_arima_predict_kernel_equals_twin_at_chunk_edges(dev, case, S):
    """The two warps' hand-over of each 32-step vf tile: one chunk (H 1,
    31, 32), two (33, 64), three (65), many (2,001); a block of two rows,
    and a second block of one row."""
    from distributed_forecasting_tpu_torch.models import arima
    from distributed_forecasting_tpu_torch.ops import kalman

    cfg = arima.ArimaConfig(**ARIMA_CASES[case])
    args = _arima_inputs(dev, cfg, S=S, seed=S)
    out = kalman.arima_filter_reference(*args)
    sigma2 = out.ssq / torch.clamp_min(out.n, 1.0)
    pargs = (args[4], args[5], out.a_T, out.P_T, sigma2, args[7])
    for H in (1, 31, 32, 33, 64, 65, 2001):
        got = kalman.arima_predict(*pargs, H)
        want = kalman.arima_predict_reference(*pargs, H)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), H


def test_arima_kernels_refuse_an_r_past_their_limit(dev):
    from distributed_forecasting_tpu_torch.models import arima
    from distributed_forecasting_tpu_torch.ops import kalman

    cfg = arima.ArimaConfig(p=1, d=1, q=1, P=1, m=70)
    args = _arima_inputs(dev, cfg, S=2, T=200)
    assert args[7] == 70
    with pytest.raises(ValueError, match="limit of 64"):
        kalman.arima_filter(*args)
    with pytest.raises(ValueError, match="limit of 64"):
        kalman.arima_predict(args[4], args[5],
                             torch.zeros(2, 70, device=dev),
                             torch.zeros(2, 70, 70, device=dev),
                             torch.ones(2, device=dev), 70, 10)


def test_arima_fit_on_the_card_equals_the_cpu(dev):
    """fit_forecast launches both kernels once; the HR estimate's solves
    (cuSOLVER on the card, the pivoted LU twin on the CPU) move the
    coefficients by float32 rounding: within 1e-4 of each output's scale."""
    from distributed_forecasting_tpu_torch.engine import fit
    from distributed_forecasting_tpu_torch.ops import kalman

    b = _pool_batch(dev)
    before = (kalman.arima_filter.launches, kalman.arima_predict.launches)
    params, res = fit.fit_forecast(b, "arima", horizon=30)
    assert (kalman.arima_filter.launches - before[0],
            kalman.arima_predict.launches - before[1]) == (1, 1)
    cpu = dataclasses.replace(b, y=b.y.cpu(), mask=b.mask.cpu(),
                              day=b.day.cpu())
    _, want = fit.fit_forecast(cpu, "arima", horizon=30)
    for name in ("yhat", "lo", "hi"):
        w = getattr(want, name)
        torch.testing.assert_close(getattr(res, name).cpu(), w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


# -- span buckets, the chunked fit and the native data plane ------------------

def _ragged_batch(dev, n_items=12, T=400):
    """3 stores x 12 items: items 1-4 from day 0, 5-8 from day 150, 9-12 from
    day 300 (new items), tensorized on the card."""
    from distributed_forecasting_tpu_torch import data

    df = data.synthetic_store_item_sales(n_stores=3, n_items=n_items,
                                         n_days=T, seed=13)
    df["sales"] = df["sales"].round()
    day = (df["date"] - df["date"].min()).dt.days
    start = (df["item"] - 1) // 4 * 150
    return data.tensorize(df[day >= start], device=dev)


def test_bucketed_holt_winters_launches_the_kernels_on_every_bucket(
        dev, monkeypatch):
    """fit_forecast_bucketed scores and refits each bucket on its trimmed
    grid through the kernels, one launch of each a bucket; each call is
    held to its twin as the unbucketed calls are (scores within the
    tolerance with near-tie argmins, the refit bitwise)."""
    from distributed_forecasting_tpu_torch.engine import fit

    b = _ragged_batch(dev)
    calls = {"hw_score": [], "hw_filter": []}
    for name in calls:
        orig = getattr(hw, name)

        def record(*args, _orig=orig, _name=name):
            out = _orig(*args)
            calls[_name].append((args, out))
            return out

        monkeypatch.setattr(hw, name, record)
    before = (fs.hw_score.launches, fs.hw_filter.launches)
    buckets, res = fit.fit_forecast_bucketed(
        b, "holt_winters", config=hw.HoltWintersConfig(filter="auto"),
        horizon=30)
    assert [sub.n_time for _, sub, _ in buckets] == [128, 256, 400]
    assert (fs.hw_score.launches - before[0],
            fs.hw_filter.launches - before[1]) == (3, 3)
    assert res.yhat.device.type == "cuda" and bool(res.ok.all())
    for (args, got), (_, sub, _) in zip(calls["hw_score"], buckets):
        assert args[0].shape == (sub.n_series, sub.n_time)
        torch.cuda.synchronize()
        _assert_scores_close(got, fs.hw_score_reference(*args))
    for args, got in calls["hw_filter"]:
        y, mask, a, be, g, p, m, mode = args
        want = hw._filter(y, mask, a, be, g, m, mode, p)
        for x, w in zip((*got[0], got[1], got[2]), (*want[0], want[1],
                                                     want[2])):
            assert torch.equal(x, w)


def _cond_tol(b, cfg):
    """10 * cond(A) * 2^-24: the relative error a backward-stable float32
    solve of the batch's curve systems may show, with room for 10 ulp."""
    from distributed_forecasting_tpu_torch.models import prophet_glm as pg
    from distributed_forecasting_tpu_torch.ops import solve

    zn, _, _ = pg._fit_target(b.y, b.mask, cfg)
    X, layout = pg._design(b.day, b.day[0].float(), b.day[-1].float(), cfg)
    lam = pg._prior_precision(layout, cfg, device=b.y.device)
    A, _ = solve.normal_equations(X, zn, b.mask, lam)
    return 10 * float(torch.linalg.cond(A.double()).max()) * 2.0**-24


def test_bucketed_curve_model_on_the_card_equals_the_cpu(dev):
    """Each bucket's curve fit on the card against the same fit on the CPU
    (the card's library solve against the floored Cholesky twin): within
    10 * cond(A) * 2^-24 of each row's scale, cond over the buckets."""
    from distributed_forecasting_tpu_torch.engine import fit
    from distributed_forecasting_tpu_torch.models import prophet_glm as pg

    b = _ragged_batch(dev)
    cfg = pg.CurveModelConfig(yearly_order=0)
    buckets, got = fit.fit_forecast_bucketed(b, config=cfg, horizon=30)
    tol = max(_cond_tol(sub, cfg) for _, sub, _ in buckets)
    cpu = dataclasses.replace(b, y=b.y.cpu(), mask=b.mask.cpu(),
                              day=b.day.cpu())
    _, want = fit.fit_forecast_bucketed(cpu, config=cfg, horizon=30)
    assert torch.equal(got.ok.cpu(), want.ok)
    for k in ("yhat", "lo", "hi"):
        w = getattr(want, k)
        scale = w.abs().amax(dim=1, keepdim=True)
        assert bool(((getattr(got, k).cpu() - w).abs() <= tol * scale).all())


def test_chunked_fit_on_the_card_equals_the_unchunked_fit(dev):
    """The chunks run at one shape; cuBLAS may pick another GEMM for a
    chunk than for the whole batch, so the curve model is held within
    10 * cond(A) * 2^-24 of each row's scale (on an H100 80GB HBM3 at
    700 W: up to 2.3e-4 of a row's scale on this ragged batch);
    Holt-Winters, whose kernels compute each row on its own, bitwise."""
    from distributed_forecasting_tpu_torch.engine import fit
    from distributed_forecasting_tpu_torch.models import prophet_glm as pg

    b = _ragged_batch(dev, n_items=20)  # 60 series
    curve = pg.CurveModelConfig(yearly_order=0)
    tol = _cond_tol(b, curve)
    for model, cfg in (("prophet", curve),
                       ("holt_winters", hw.HoltWintersConfig())):
        _, whole = fit.fit_forecast(b, model, config=cfg, horizon=30)
        for dispatch in ("scan", "loop"):
            _, got = fit.fit_forecast_chunked(b, model, config=cfg,
                                              horizon=30, chunk_size=16,
                                              dispatch=dispatch)
            assert torch.equal(got.ok, whole.ok)
            for k in ("yhat", "lo", "hi"):
                a, w = getattr(got, k), getattr(whole, k)
                if model == "holt_winters":
                    assert torch.equal(a, w), k
                else:
                    scale = w.abs().amax(dim=1, keepdim=True)
                    assert bool(((a - w).abs() <= tol * scale).all()), k


def test_native_tensorize_on_the_card_is_the_pandas_one(dev):
    from distributed_forecasting_tpu_torch import data

    df = data.synthetic_store_item_sales(n_stores=3, n_items=5, n_days=300,
                                         seed=3, missing_rate=0.1)
    assert data.resolved_backend() == "native"
    nat = data.tensorize(df, backend="native", device=dev)
    ref = data.tensorize(df, backend="pandas", device=dev)
    for k in ("y", "mask", "day"):
        assert getattr(nat, k).device.type == "cuda"
        assert torch.equal(getattr(nat, k), getattr(ref, k)), k
    assert (nat.keys == ref.keys).all() and nat.start_date == ref.start_date


# -- the scorer (serving/server.py, batcher.py): a series' rows must be
# bit-identical whatever the request's size bucket, or the coalescer's
# merged responses would differ from solo ones.  On the card that needs the
# curve model's design product and the cumulative sums to work row by row
# (models/base.design_product, models/base.cumsum_rows): one GEMM
# and torch.cumsum pick their algorithm by the row count.


def test_cumsum_rows_adds_each_row_in_order(dev):
    from distributed_forecasting_tpu_torch.models.base import cumsum_rows

    x = torch.rand(70, 300, device=dev)
    seq = [x[:, 0]]
    for j in range(1, x.shape[1]):
        seq.append(seq[-1] + x[:, j])
    seq = torch.stack(seq, dim=1)
    for rows in (1, 2, 8, 70):
        assert torch.equal(cumsum_rows(x[:rows]), seq[:rows]), rows


def _served(dev, model, S=96, T=420):
    from distributed_forecasting_tpu_torch import data, engine
    from distributed_forecasting_tpu_torch.models import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    df = data.synthetic_store_item_sales(n_stores=4, n_items=S // 4,
                                         n_days=T, seed=17, missing_rate=0.03)
    batch = data.tensorize(df, device=dev)
    params, _ = engine.fit_forecast(batch, model, horizon=30)
    scale = torch.linspace(0.8, 1.3, batch.n_series).numpy()
    return BatchForecaster.from_fit(batch, params, model,
                                    get_model(model).config_cls(),
                                    interval_scale=scale)


@pytest.mark.parametrize("model", ["prophet", "holt_winters", "arima",
                                   "arnet"])
def test_coalesced_blocks_equal_solo_blocks(dev, model):
    """Each of 8 probed series: its block from a 1-series, an 8-series and a
    64-series request (buckets 1, 8, 64), byte-equal through the server's
    encoder, for predict with and without history and for quantiles."""
    import pandas as pd

    from distributed_forecasting_tpu_torch.serving.server import (
        _encode_predictions,
    )

    fc = _served(dev, model)
    assert fc.coalesce_safe
    keys = [tuple(map(int, k)) for k in fc.keys]
    probe = keys[5:13]
    calls = (
        lambda r: fc.predict(r, horizon=30),
        lambda r: fc.predict(r, horizon=30, include_history=True),
        lambda r: fc.predict_quantiles(r, quantiles=(0.1, 0.5, 0.9),
                                       horizon=30),
    )
    for call in calls:
        solo = {k: _encode_predictions(call(pd.DataFrame([k], columns=list(
            fc.key_names))), fc.key_names) for k in probe}
        for size in (8, 64):
            req = keys[:size] if size == 64 else probe
            assert fc._bucket(len(req)) == size
            out = call(pd.DataFrame(req, columns=list(fc.key_names)))
            T = len(out) // len(req)
            for j, k in enumerate(req):
                if k in solo:
                    block = out.iloc[j * T:(j + 1) * T].reset_index(drop=True)
                    assert _encode_predictions(block, fc.key_names) == solo[k]


def test_served_bodies_equal_the_in_process_predict(dev):
    import json
    import urllib.request

    import pandas as pd

    from distributed_forecasting_tpu_torch.serving import server

    fc = _served(dev, "holt_winters")
    srv = server.start_server(fc)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/invocations"
        keys = [dict(zip(fc.key_names, map(int, k))) for k in fc.keys[:17]]
        for inputs, extra in ((keys[:1], {}), (keys, {}),
                              (keys, {"quantiles": [0.1, 0.9]})):
            req = urllib.request.Request(url, data=json.dumps(
                {"inputs": inputs, "horizon": 30, **extra}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                body = r.read()
            frame = pd.DataFrame(inputs)
            want = (fc.predict_quantiles(frame, quantiles=(0.1, 0.9),
                                         horizon=30) if extra
                    else fc.predict(frame, horizon=30))
            assert body == server._encode_predictions(want, fc.key_names)
    finally:
        srv.shutdown()


@pytest.mark.parametrize("model", ["holt_winters", "arima"])
def test_a_card_resident_subset_predicts_bitwise_the_full_forecast(dev,
                                                                  model):
    """``subset_for_shards`` of a forecaster on the card to a proper subset
    of its shards (3 of 8): the gathered parameters stay on the card, and
    for every owned key predict (with and without history) and
    predict_quantiles are bitwise the full forecaster's; the subset's arima
    forecast runs the ``arima_predict`` kernel."""
    import numpy as np
    import pandas as pd

    from distributed_forecasting_tpu_torch.ops import kalman
    from distributed_forecasting_tpu_torch.serving.sharding import (
        shard_of_key,
        subset_for_shards,
    )

    fc = _served(dev, model)
    owned = [1, 4, 6]
    sub, idx = subset_for_shards(fc, owned, 8)
    assert 0 < len(idx) < fc.n_series
    assert sub.n_series == len(idx)
    assert all(shard_of_key(k, 8) in owned for k in sub.keys.tolist())
    for f in dataclasses.fields(sub.params):
        v = getattr(sub.params, f.name)
        if isinstance(v, torch.Tensor):
            assert v.device.type == dev.type, f.name
    req = pd.DataFrame(np.asarray(fc.keys)[idx][::-1],
                       columns=list(fc.key_names))
    for kw in ({"horizon": 30}, {"horizon": 7, "include_history": True}):
        launches = kalman.arima_predict.launches
        got = sub.predict(req, **kw)
        if model == "arima" and "include_history" not in kw \
                and dev.type == "cuda":
            assert kalman.arima_predict.launches > launches
        want = fc.predict(req, **kw)
        assert got.columns.tolist() == want.columns.tolist()
        for col in got.columns:
            assert np.array_equal(got[col].to_numpy(), want[col].to_numpy())
    q = sub.predict_quantiles(req, quantiles=(0.1, 0.5, 0.9), horizon=30)
    assert q.equals(fc.predict_quantiles(req, quantiles=(0.1, 0.5, 0.9),
                                         horizon=30))


def _detect_points(fc, n_series=8, days=30, seed=4):
    """The last ``days`` days of the fit and ``days`` past it for
    ``n_series`` series, actuals drawn around the served band with a spike
    of 40 band-widths on every seventh point."""
    import numpy as np
    import pandas as pd

    keys = [tuple(map(int, k)) for k in fc.keys[:n_series]]
    frame = pd.DataFrame(keys, columns=list(fc.key_names))
    pred = fc.predict(frame, horizon=days, include_history=True)
    pred = pred[pred["ds"] > pred["ds"].max() - pd.Timedelta(days=2 * days)]
    rng = np.random.default_rng(seed)
    half = (pred["yhat_upper"] - pred["yhat"]).to_numpy()
    y = pred["yhat"].to_numpy() + rng.normal(0, 0.5, len(pred)) * half
    spike = np.arange(len(pred)) % 7 == 3
    y[spike] += 40 * half[spike]
    pts = pred[list(fc.key_names) + ["ds"]].assign(
        ds=pred["ds"].dt.strftime("%Y-%m-%d"), y=y)
    return pts.reset_index(drop=True), spike


@pytest.mark.parametrize("model", ["prophet", "holt_winters", "arima"])
def test_anomaly_scores_on_the_card_equal_the_cpu(dev, model, tmp_path):
    """The same artifact on the card and on the CPU scores the same points:
    keys, dates, actuals and counts equal, bands within the scorer's
    card-vs-CPU predict tolerance (1e-5 of each series' scale for the curve
    model and Holt-Winters, 1e-4 for arima's Kalman predict), scores within
    that error's propagation, every spike flagged on both."""
    import numpy as np

    from distributed_forecasting_tpu_torch.serving import BatchForecaster
    from distributed_forecasting_tpu_torch.serving.anomaly import (
        AnomalyScorer,
    )

    fc = _served(dev, model)
    fc.save(str(tmp_path))
    cpu = BatchForecaster.load(str(tmp_path), device="cpu")
    pts, spike = _detect_points(fc)
    got = AnomalyScorer(fc).score(pts)
    want = AnomalyScorer(cpu).score(pts)
    rel = 1e-4 if model == "arima" else 1e-5
    for k in ("n_scored", "n_skipped", "threshold"):
        assert got[k] == want[k], k
    assert got["n_scored"] == len(pts)
    scale = max(abs(r["yhat_upper"]) for r in want["results"])
    for g, w in zip(got["results"], want["results"]):
        for k in ("store", "item", "ds", "y"):
            assert g[k] == w[k]
        for k in ("yhat", "yhat_lower", "yhat_upper"):
            assert abs(g[k] - w[k]) <= rel * scale, (k, g, w)
        band = w["yhat_upper"] - w["yhat"]
        tol = 2 * rel * scale * (2.6 + 2 * w["anomaly_score"]) / band + 1e-6
        assert abs(g["anomaly_score"] - w["anomaly_score"]) <= tol
    for out in (got, want):
        flags = np.array([r["is_anomaly"] for r in out["results"]])
        assert flags[spike].all()


@pytest.mark.parametrize("model", ["prophet", "holt_winters", "arima"])
def test_coalesced_detection_equals_solo_detection(dev, model):
    """Eight concurrent 1-series /detect_anomalies requests at a coalescing
    server answer byte for byte what the unbound scorer answers for each
    alone, in fewer dispatches than requests."""
    import json
    import threading
    import urllib.request

    from distributed_forecasting_tpu_torch.serving import server
    from distributed_forecasting_tpu_torch.serving.anomaly import (
        AnomalyScorer,
    )
    from distributed_forecasting_tpu_torch.serving.batcher import (
        BatchingConfig,
    )

    fc = _served(dev, model)
    pts, _ = _detect_points(fc)
    per = [g for _, g in pts.groupby(list(fc.key_names), sort=False)]
    solo = [json.dumps(AnomalyScorer(fc).score(g)).encode() for g in per]
    srv = server.start_server(
        fc, anomaly=AnomalyScorer(fc),
        batching=BatchingConfig(enabled=True, max_batch_size=64,
                                max_wait_ms=200.0, max_queue_depth=64,
                                request_timeout_s=120.0))
    url = f"http://127.0.0.1:{srv.server_address[1]}/detect_anomalies"
    got = [None] * len(per)
    barrier = threading.Barrier(len(per))

    def client(i):
        barrier.wait()
        req = urllib.request.Request(url, data=json.dumps(
            {"points": per[i].to_dict("records")}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got[i] = r.read()

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(per))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        dispatches = srv.metrics.dispatches.value
    finally:
        srv.shutdown()
    assert got == solo
    assert dispatches < len(per)


def test_detection_launches_arima_predict_once_a_request(dev):
    """On a composite whose arima member owns every other series, each
    scored request holding an arima series launches ``arima_predict`` once;
    a request of Holt-Winters series alone launches it not at all."""
    import numpy as np

    from distributed_forecasting_tpu_torch.ops import kalman
    from distributed_forecasting_tpu_torch.serving import MultiModelForecaster
    from distributed_forecasting_tpu_torch.serving.anomaly import (
        AnomalyScorer,
    )

    members = {m: _served(dev, m) for m in ("arima", "holt_winters")}
    S = members["arima"].n_series
    auto = MultiModelForecaster(members, np.arange(S) % 2)
    pts, spike = _detect_points(members["arima"], n_series=6)
    scorer = AnomalyScorer(auto)
    kalman.arima_predict.launches = 0
    for _ in range(3):
        out = scorer.score(pts)
    assert kalman.arima_predict.launches == 3
    assert all(r["is_anomaly"] for r, s in zip(out["results"], spike) if s)
    hw_keys = {tuple(map(int, k)) for k in auto.keys[1::2]}
    hw_only = pts[[tuple(k) in hw_keys for k in pts[list(
        auto.key_names)].itertuples(index=False, name=None)]]
    kalman.arima_predict.launches = 0
    assert scorer.score(hw_only)["n_scored"] == len(hw_only) > 0
    assert kalman.arima_predict.launches == 0


def test_kernel_library_builds_once_from_concurrent_threads(dev, monkeypatch):
    import threading

    from distributed_forecasting_tpu_torch.ops import _build

    builds = []
    real_build = _build.build

    def counted(*args, **kwargs):
        builds.append(args)
        return real_build(*args, **kwargs)

    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "build", counted)
    barrier = threading.Barrier(8)
    got = [None] * 8

    def first_use(i):
        barrier.wait()
        got[i] = _build.library()

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert len(builds) == 1
    assert got[0] is not None and all(g is got[0] for g in got)


# -- automatic data prep (engine/autoprep.py, ops/clean.py) -------------------
#
# Plain torch on the card (cuFFT for the ACF).  On whole-number sales the
# outlier stage is exact on both devices, so masks, scores and repairs are
# bitwise the CPU's; the CUSUM runs on the repaired tensor, where a
# cp_index may differ only at a tie of its statistic (the top two valid
# |dev| within 1e-6 * sum|y m|), and its shift and score within T * 2**-24.

def test_autoprep_on_the_card_equals_the_cpu(dev):
    import numpy as np

    from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
    from distributed_forecasting_tpu_torch.engine import autoprep as ap

    S, T = 64, 400
    g = torch.Generator().manual_seed(13)
    t = torch.arange(T)
    y = torch.round(torch.clamp(
        30 + 8 * torch.sin(2 * torch.pi * t / 7)[None, :]
        + 3 * torch.randn(S, T, generator=g), min=0))
    y[torch.arange(S), torch.randint(10, T - 10, (S,), generator=g)] *= 8
    y[:8, 100:130] = 0.0                       # dead feeds
    y[8:16, 250:] += 20.0                      # level shifts
    mask = (torch.rand(S, T, generator=g) > 0.05).float()
    mask[:8, 100:130] = 1.0
    keys = np.stack([np.ones(S, np.int64), np.arange(1, S + 1)], axis=1)
    cpu = SeriesBatch(y=y * mask, mask=mask,
                      day=torch.arange(17000, 17000 + T, dtype=torch.int32),
                      keys=keys, key_names=("store", "item"),
                      start_date="2016-07-17")
    card = dataclasses.replace(cpu, y=cpu.y.to(dev), mask=cpu.mask.to(dev),
                               day=cpu.day.to(dev))
    cfg = ap.AutoprepConfig(enabled=True, season_detect=True,
                            holiday_regressors=True)
    got = ap.autoprep_batch(card, cfg, horizon=30)
    want = ap.autoprep_batch(cpu, cfg, horizon=30)
    gr, wr = got.report, want.report
    assert got.batch.y.device.type == "cuda" == got.xreg.device.type
    for f in ("masked_zero_cells", "outlier_score", "outlier_scale",
              "repaired", "repair_value"):
        assert np.array_equal(getattr(gr, f), getattr(wr, f)), f
    assert torch.equal(got.batch.mask.cpu(), want.batch.mask)
    assert torch.equal(got.xreg.cpu(), want.xreg)
    assert gr.season_length == wr.season_length == 7
    assert (gr.masked_zero_cells[:8] == 30).all() and gr.repaired.sum() >= S // 2
    # the CUSUM's tie rule, on the repaired tensor
    yc = np.where(wr.repaired, wr.repair_value, cpu.y.numpy()).astype(
        np.float64) * want.batch.mask.numpy()
    m = want.batch.mask.numpy().astype(np.float64)
    n = m.sum(1, keepdims=True)
    dev_ = np.abs(np.cumsum((yc - yc.sum(1, keepdims=True) / n) * m, 1))
    left = np.cumsum(m, 1)
    stat = np.sort(np.where((left >= 2) & (n - left >= 2), dev_, -np.inf), 1)
    tie = stat[:, -1] - stat[:, -2] <= 1e-6 * np.abs(yc).sum(1)
    same = gr.cp_index == wr.cp_index
    assert (same | tie).all()
    tol = T * 2.0 ** -24
    scale = np.abs(yc).max(1)
    assert (np.abs(gr.cp_shift - wr.cp_shift)[same]
            <= tol * (np.abs(wr.cp_shift) + scale)[same]).all()
    assert (np.abs(gr.cp_score - wr.cp_score)[same]
            <= tol * np.abs(wr.cp_score)[same] + 1e-6).all()
    assert (gr.cp_index[8:16] >= 0).all()


# -- slice 13: arnet's trainer, the Monte-Carlo branch, the tuned path --------

def _arnet_batch(dev, S=5, T=400, seed=4, R=0, per_series=False):
    import numpy as np

    from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch

    rng = np.random.default_rng(seed)
    y = np.zeros((S, T))
    for t in range(2, T):
        y[:, t] = 0.5 * y[:, t - 1] - 0.2 * y[:, t - 2] + 0.3 * rng.normal(
            size=S)
    y += 20.0 * (1 + np.arange(S))[:, None]
    mask = (rng.random((S, T)) > 0.05).astype(np.float32)
    batch = SeriesBatch(
        y=torch.tensor(y * mask, dtype=torch.float32, device=dev),
        mask=torch.tensor(mask, device=dev),
        day=torch.arange(T, dtype=torch.int32, device=dev) + 18000,
        keys=np.arange(S)[:, None], key_names=("id",),
        start_date="2019-04-14", freq="D")
    xreg = None
    if R:
        shape = (S, T + 30, R) if per_series else (T + 30, R)
        xreg = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev)
    return batch, xreg


ARNET_CASES = {"plain": {}, "shared_xreg": dict(R=2),
               "per_series_xreg": dict(R=2, per_series=True)}


@pytest.mark.parametrize("case", list(ARNET_CASES))
def test_arnet_eager_path_equals_family_trainer_on_the_card(dev, case):
    from distributed_forecasting_tpu_torch.engine import fit, gradfit
    from distributed_forecasting_tpu_torch.models import arnet

    for S in (3, 37):
        batch, xreg = _arnet_batch(dev, S=S, **ARNET_CASES[case])
        cfg = arnet.ArnetConfig(lags=7, epochs=5,
                                n_regressors=0 if xreg is None else 2)
        p_in, r_in = fit.fit_forecast(batch, "arnet", cfg, horizon=30,
                                      xreg=xreg)
        p_eg, r_eg = gradfit.gradfit_fit_forecast(
            batch, config=cfg, horizon=30, xreg=xreg,
            gcfg=gradfit.GradFitConfig(enabled=True, series_bucket=4))
        assert p_in.w.device.type == dev.type
        for name in ("yhat", "lo", "hi"):
            assert torch.equal(getattr(r_eg, name), getattr(r_in, name))
        assert torch.equal(p_eg.w, p_in.w) and torch.equal(p_eg.beta,
                                                           p_in.beta)


@pytest.mark.parametrize("case", list(ARNET_CASES))
def test_arnet_bucket_growth_changes_nothing_on_the_card(dev, case):
    from distributed_forecasting_tpu_torch.engine import gradfit
    from distributed_forecasting_tpu_torch.models import arnet

    batch, xreg = _arnet_batch(dev, S=5, **ARNET_CASES[case])
    cfg = arnet.ArnetConfig(lags=7, epochs=5,
                            n_regressors=0 if xreg is None else 2)
    outs = [gradfit.gradfit_fit_forecast(
        batch, config=cfg, horizon=30, xreg=xreg,
        gcfg=gradfit.GradFitConfig(enabled=True, series_bucket=base))
        for base in (8, 16, 64, 512)]
    for params, res in outs[1:]:
        assert torch.equal(params.w, outs[0][0].w)
        assert torch.equal(res.yhat, outs[0][1].yhat)


def test_arnet_one_seed_one_fit_and_rows_alone_on_the_card(dev):
    import dataclasses as dc

    from distributed_forecasting_tpu_torch.engine import fit
    from distributed_forecasting_tpu_torch.models import arnet

    batch, _ = _arnet_batch(dev, S=40, seed=5)
    cfg = arnet.ArnetConfig(lags=7, epochs=4, seed=1)
    full, rf = fit.fit_forecast(batch, "arnet", cfg, horizon=30)
    again, ra = fit.fit_forecast(batch, "arnet", cfg, horizon=30)
    assert torch.equal(full.w, again.w) and torch.equal(rf.hi, ra.hi)
    for n in (1, 2, 17):
        sub = dc.replace(batch, y=batch.y[:n], mask=batch.mask[:n],
                         keys=batch.keys[:n])
        p, r = fit.fit_forecast(sub, "arnet", cfg, horizon=30)
        assert torch.equal(p.w, full.w[:n])
        assert torch.equal(r.hi, rf.hi[:n])


def test_arnet_card_equals_cpu_on_one_schedule(dev):
    """The same injected schedule trains both: within float32 of each
    other (the CPU-vs-reference tolerances of test_torch_arnet.py)."""
    import numpy as np

    from distributed_forecasting_tpu_torch.engine import gradfit
    from distributed_forecasting_tpu_torch.models import arnet

    batch, xreg = _arnet_batch(dev, S=8, R=2, per_series=True)
    cfg = arnet.ArnetConfig(lags=7, epochs=8, n_regressors=2)
    sched = gradfit.minibatch_schedule(
        torch.Generator().manual_seed(0), 400, 64, 8)
    xh = xreg[:, :400]
    card = arnet.fit(batch.y, batch.mask, batch.day, cfg, xreg=xh,
                     schedule=sched.to(dev))
    cpu = arnet.fit(batch.y.cpu(), batch.mask.cpu(), batch.day.cpu(), cfg,
                    xreg=xh.cpu(), schedule=sched)
    np.testing.assert_allclose(card.w.cpu().numpy(), cpu.w.numpy(), atol=2e-5)
    scale = cpu.fitted.abs().amax(1, keepdim=True)
    assert bool(((card.fitted.cpu() - cpu.fitted).abs()
                 <= 2e-5 * scale + 1e-7).all())


def test_monte_carlo_on_the_card_equals_cpu_on_the_same_draws(dev):
    """Draws made once on the CPU, handed to both: paths' bands and
    quantiles within 1e-5 of each row's scale (the analytic path's card
    tolerance), the quantiles taken along the sample axis on the card."""
    from distributed_forecasting_tpu_torch import data, engine
    from distributed_forecasting_tpu_torch.models import prophet_glm as pg

    df = data.synthetic_store_item_sales(n_stores=2, n_items=8, n_days=400,
                                         seed=3)
    card = data.tensorize(df, device=dev)
    cpu = data.tensorize(df, device="cpu")
    cfg = pg.CurveModelConfig(uncertainty_samples=300, yearly_order=0)
    params_c, _ = engine.fit_forecast(cpu, "prophet", cfg, horizon=30)
    params_g = type(params_c)(**{f.name: getattr(params_c, f.name).to(dev)
                                 for f in dataclasses.fields(params_c)})
    day_all = torch.arange(int(cpu.day[0]), int(cpu.day[-1]) + 31,
                           dtype=torch.int32)
    te = float(cpu.day[-1])
    S = cpu.n_series
    t_all = pg.scaled_time(day_all, params_c.t0, params_c.t1)
    tes = (torch.tensor([[te]]) - params_c.t0) / (params_c.t1 - params_c.t0)
    draws = pg.draw_standard((S, 300, 25), (S, 300, day_all.shape[0]),
                             pg._cp_process(params_c, t_all, tes, cfg)[1],
                             torch.Generator().manual_seed(2))
    got = pg.forecast(params_g, day_all.to(dev), te, cfg,
                      draws=tuple(d.to(dev) for d in draws))
    want = pg.forecast(params_c, day_all, te, cfg, draws=draws)
    for g, w in zip(got, want):
        scale = w.abs().amax(1, keepdim=True)
        assert bool(((g.cpu() - w).abs() <= 1e-5 * scale + 1e-6).all())
    q = pg.forecast_quantiles(params_g, day_all.to(dev), te, cfg,
                              (0.1, 0.5, 0.9),
                              generator=torch.Generator(dev).manual_seed(0))
    assert q.device.type == dev.type and bool(torch.isfinite(q).all())
    assert bool((q[:, 0] <= q[:, 1]).all() and (q[:, 1] <= q[:, 2]).all())


def test_tuned_cv_scores_on_the_card_equal_cpu(dev):
    import numpy as np

    from distributed_forecasting_tpu_torch import data
    from distributed_forecasting_tpu_torch.engine import cv, hyper
    from distributed_forecasting_tpu_torch.models import prophet_glm as pg

    df = data.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=400,
                                         seed=5)
    conf = cv.CVConfig(initial=250, period=60, horizon=30)
    cfg = pg.CurveModelConfig(yearly_order=0)
    scales = [torch.tensor(v) for v in ((0.01, 0.1, 0.4), (0.1, 1.0, 9.0),
                                        (0.5, 2.0, 5.0))]
    got = hyper._cv_scores(data.tensorize(df, device=dev), cfg, conf,
                           *scales, "smape")
    want = hyper._cv_scores(data.tensorize(df, device="cpu"), cfg, conf,
                            *scales, "smape")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3)


# -- the MLE likelihood gradient (csrc/arima_mle.cu) ---------------------------
#
# The kernel repeats its twin's float32 operations in order (primal and
# forward-mode tangents), with no contraction: held to the twin bit for bit,
# and its primal to arima_filter's.

def _mle_inputs(dev, S, p, q, T=300, seed=4):
    from distributed_forecasting_tpu_torch.models import arima

    y, mask = _workload(S, T, dev, seed=seed)
    mask[0, :40] = 0.0
    mask[1] = 0.0              # an all-masked row
    mask[2] = 0.0
    mask[2, T // 2] = 1.0      # one observation
    zc, zmask, _ = arima._centered(y * mask, mask, 1)
    g = torch.Generator().manual_seed(seed)
    u = 0.5 * torch.randn(S, p + q, generator=g)
    u[3, :1] = 2.0             # |PACF| 0.96: near the stationarity boundary
    phi = arima._pacf_to_coef(u[:, :p]).to(dev)
    theta = arima._pacf_to_coef(u[:, p:]).to(dev)
    return zc.contiguous(), zmask.contiguous(), phi, theta


@pytest.mark.parametrize("p, q", [(2, 1), (4, 0), (0, 3), (7, 6), (8, 0),
                                  (9, 0)],
                         ids=["r2", "r4", "r4_theta", "r7_shared_dP",
                              "r8_shared_P", "warp_r9"])
def test_loglik_grad_kernel_equals_twin_bitwise(dev, p, q):
    from distributed_forecasting_tpu_torch.ops import kalman

    r = max(p, q + 1, 1)
    zc, zmask, phi, theta = _mle_inputs(dev, 64, p, q)
    before = kalman.arima_loglik_grad.launches
    got = kalman.arima_loglik_grad(zc, zmask, phi, theta, r)
    want = kalman.arima_loglik_grad_reference(zc, zmask, phi, theta, r)
    torch.cuda.synchronize()
    assert kalman.arima_loglik_grad.launches == before + 1
    for name, g, w in zip(kalman.LoglikGrad._fields, got, want):
        assert g.shape == w.shape and torch.equal(g, w), name
    filt = kalman.arima_filter(zc, zmask, None, None, phi, theta,
                               torch.zeros(64, device=dev), r, 0)
    for name in ("ssq", "ldet", "n"):
        assert torch.equal(getattr(got, name), getattr(filt, name)), name
    assert not got.dssq[1].any() and torch.isfinite(got.dssq).all()


def test_loglik_grad_kernel_refuses_an_r_past_its_limit(dev):
    from distributed_forecasting_tpu_torch.ops import kalman

    zc, zmask, phi, theta = _mle_inputs(dev, 4, 70, 0, T=50)
    with pytest.raises(ValueError, match="limit of 64"):
        kalman.arima_loglik_grad(zc, zmask, phi, theta, 70)


def test_mle_fit_on_the_card_launches_the_kernel_each_step(dev):
    """fit_forecast with method='mle' runs its whole fit in one launch of
    ``arima_mle_fit`` (none of ``arima_loglik_grad``) and each arima kernel
    once, and so does its CV pass; the card's fit is the CPU's within
    float32 (the Adam scalars divide by reciprocal on the card)."""
    from distributed_forecasting_tpu_torch.engine import cv, fit
    from distributed_forecasting_tpu_torch.models.arima import ArimaConfig
    from distributed_forecasting_tpu_torch.ops import kalman

    b = _pool_batch(dev)
    cfg = ArimaConfig(method="mle", fit_steps=40)
    kalman.arima_mle_fit.launches = kalman.arima_loglik_grad.launches = 0
    params, res = fit.fit_forecast(b, "arima", config=cfg, horizon=30)
    torch.cuda.synchronize()
    assert kalman.arima_mle_fit.launches == 1
    assert kalman.arima_loglik_grad.launches == 0
    cv.cross_validate(b, "arima", config=cfg, cv=cv.CVConfig(
        initial=200, period=100, horizon=30))
    torch.cuda.synchronize()
    assert kalman.arima_mle_fit.launches == 2
    assert kalman.arima_loglik_grad.launches == 0
    cpu = dataclasses.replace(b, y=b.y.cpu(), mask=b.mask.cpu(),
                              day=b.day.cpu())
    want_params, want = fit.fit_forecast(cpu, "arima", config=cfg, horizon=30)
    torch.testing.assert_close(params.phi.cpu(), want_params.phi, rtol=0,
                               atol=1e-4)
    for name in ("yhat", "lo", "hi"):
        w = getattr(want, name)
        torch.testing.assert_close(getattr(res, name).cpu(), w, rtol=0,
                                   atol=1e-3 * float(w.abs().max()))


# The fit kernel against its twin on the card: the same operations in the
# same order (the map, the filter and its tangents, the gradient, Adam with
# the card's reciprocal-of-scalar divisions), so u, and the coefficients
# torch maps it to, are bit for bit the twin's after every step.  The twin
# runs ~75 launches a time step, so these cases keep T at 150.
_FIT_STEPS = (1, 30, 200)
_TWIN_PATHS = {}


@pytest.mark.parametrize("p, q", [(2, 1), (4, 0), (0, 3), (8, 0), (9, 0)],
                         ids=["r2", "r4", "r4_theta", "r8_shared_P",
                              "warp_r9"])
def test_mle_fit_kernel_equals_twin_bitwise(dev, p, q):
    from distributed_forecasting_tpu_torch.models import arima
    from distributed_forecasting_tpu_torch.ops import kalman

    r = max(p, q + 1, 1)
    zc, zmask, _, _ = _mle_inputs(dev, 40, p, q, T=150)
    cfg = arima.ArimaConfig()
    if (p, q) not in _TWIN_PATHS:  # the twin's path, once per order
        _TWIN_PATHS[p, q] = arima.mle_fit_reference(
            zc, zmask, p, q, r, max(_FIT_STEPS), cfg.learning_rate,
            cfg.prior_scale, path=True)
    want = _TWIN_PATHS[p, q]
    for steps in _FIT_STEPS:
        before = kalman.arima_mle_fit.launches
        launch, got = kalman._mle_fit_launcher(
            zc, zmask, p, q, r, steps, cfg.learning_rate, cfg.prior_scale)
        launch()
        torch.cuda.synchronize()
        assert kalman.arima_mle_fit.launches == before + 1
        w = want[steps - 1]
        differ = (got != w).any(dim=1)
        assert not differ.any(), (steps, int(differ.sum()),
                                  float((got - w).abs().max()))
        for fn, sl in ((arima._pacf_to_coef, slice(0, p)),
                       (arima._pacf_to_coef, slice(p, p + q))):
            assert torch.equal(fn(got[:, sl]), fn(w[:, sl])), steps
    assert torch.isfinite(got).all()
    assert float(got.abs().max()) > 1e-2  # the fit moved off u = 0


def test_mle_fit_kernel_refuses_what_it_has_no_instance_for(dev):
    from distributed_forecasting_tpu_torch.ops import kalman

    zc, zmask, _, _ = _mle_inputs(dev, 4, 70, 0, T=50)
    with pytest.raises(ValueError, match="limit of 64"):
        kalman.arima_mle_fit(zc, zmask, 70, 0, 70, 2, 0.05, 1.0)
    # nothing to fit: no launch, u = 0
    before = kalman.arima_mle_fit.launches
    assert not kalman.arima_mle_fit(zc, zmask, 2, 1, 2, 0, 0.05, 1.0).any()
    assert kalman.arima_mle_fit(zc, zmask, 0, 0, 1, 5, 0.05, 1.0).shape == (
        4, 0)
    assert kalman.arima_mle_fit.launches == before


def test_bf16_gate_leaves_the_kernel_route_unchanged(dev):
    """On the card ``filter: auto`` scores with hw_score, which ignores the
    precision gate: the gated fit equals the ungated one bitwise."""
    from distributed_forecasting_tpu_torch.ops import precision

    y, mask = _workload(16, 200, dev)
    day = torch.arange(16_000, 16_200, dtype=torch.int32, device=dev)
    fits = {}
    try:
        for on in (False, True):
            precision.configure_precision(
                precision.PrecisionConfig(bf16_scoring=on))
            fits[on] = hw.fit(y, mask, day, hw.HoltWintersConfig())
    finally:
        precision.configure_precision(precision.PrecisionConfig())
    for f in ("alpha", "beta", "gamma", "level", "fitted"):
        assert torch.equal(getattr(fits[False], f), getattr(fits[True], f)), f


# -- streaming ingest: the update continues the card's fit ------------------

_PINNED = dict(n_alpha=1, n_beta=1, n_gamma=1, damped=False)


@pytest.mark.parametrize("k", [1, 7, 40])
def test_hw_stream_equals_the_hw_filter_fit_on_the_card(dev, k):
    """A pinned 1-candidate grid (``filter: auto``: hw_score, then the
    hw_filter kernel): k streamed columns through ``update_state`` (the
    port's ``_hw_step`` loop, PyTorch's elementwise kernels) equal the
    kernel's fit of the extended series bit for bit."""
    from distributed_forecasting_tpu_torch.ops.update import apply_update

    T = 300
    y, mask = _workload(8, T + k, dev, seed=k)
    day = torch.arange(16_000, 16_000 + T + k, dtype=torch.int32, device=dev)
    cfg = hw.HoltWintersConfig(**_PINNED)
    before = fs.hw_filter.launches
    params = hw.fit(y[:, :T], mask[:, :T], day[:T], cfg)
    assert fs.hw_filter.launches == before + 1
    aux = hw.init_update_aux(params, mask=mask[:, :T])
    got, _, preds = apply_update(
        "holt_winters", cfg, params, aux, y[:, T:], mask[:, T:],
        [1.0] * k, day[T:].cpu().numpy(), day0=16_000)
    ref = hw.fit(y, mask, day, cfg)
    for name in ("level", "trend", "season"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.equal(preds, ref.fitted[:, T:])


def _streamed_store(dev, model, S=16, T=200, bucket=32, seed=3):
    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
        tensorize,
    )
    from distributed_forecasting_tpu_torch.engine.state_store import (
        SeriesStateStore,
    )
    from distributed_forecasting_tpu_torch.models.base import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    batch = tensorize(synthetic_store_item_sales(
        n_stores=2, n_items=S // 2, n_days=T, seed=seed), device=dev)
    fns = get_model(model)
    cfg = fns.config_cls(**(_PINNED if model == "holt_winters" else {}))
    params = fns.fit(batch.y, batch.mask, batch.day, cfg)
    fc = BatchForecaster.from_fit(batch, params, model, cfg)
    store = SeriesStateStore(fc, time_bucket=bucket,
                             history_y=batch.y.cpu().numpy(),
                             history_mask=batch.mask.cpu().numpy(),
                             device=dev)
    return batch, fc, store


@pytest.mark.parametrize("model", ["holt_winters", "theta", "croston"])
def test_stream_chained_and_across_a_bucket_on_the_card(dev, model):
    """One day at a time across a time-bucket boundary equals the same days
    in one apply, bit for bit, for each family; the padded fitted buffer
    grows one bucket and its padding stays 0."""
    import numpy as np

    stores = [_streamed_store(dev, model) for _ in range(2)]
    rng = np.random.default_rng(9)
    k = 40  # 200 days + 40 crosses the 224 cap
    S = stores[0][2].n_series
    vals = rng.gamma(4.0, 10.0, (S, k))
    day1 = stores[0][2].day_cur
    for j in range(k):
        stores[0][2].ingest([(s, day1 + 1 + j, float(vals[s, j]))
                             for s in range(S) if (s + j) % 5])
        stores[0][2].apply_pending()
    stores[1][2].ingest([(s, day1 + 1 + j, float(vals[s, j]))
                         for j in range(k) for s in range(S) if (s + j) % 5])
    assert stores[1][2].apply_pending()["days"] == k
    a, b = stores[0][2]._params, stores[1][2]._params
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert a.fitted.shape[1] == 256
    assert not torch.any(a.fitted[:, 240:])


def test_stream_during_refit_on_the_card(dev):
    """A forced refit on the scheduler's stream while days apply on the
    default stream: one hw_score and one hw_filter launch, the install
    replays the days applied meanwhile and equals fit-then-update bitwise,
    and predicts during the refit see whole states."""
    import threading

    import numpy as np
    import pandas as pd

    from distributed_forecasting_tpu_torch.engine.executor import device_pull
    from distributed_forecasting_tpu_torch.serving.refit import (
        RefitConfig,
        RefitScheduler,
    )

    batch, fc, store = _streamed_store(dev, "holt_winters", S=64, T=400)
    sched = RefitScheduler(store, RefitConfig(
        enabled=True, max_applied_points=10**9, max_staleness_s=1e9,
        check_interval_s=60))
    S = store.n_series
    rng = np.random.default_rng(2)
    prep, dispatch, complete = store.refit_stages()
    counts = (fs.hw_score.launches, fs.hw_filter.launches)
    prepared = prep()
    day_snap = prepared["day_snap"]
    for _ in range(5):  # applied between the snapshot and the install
        d = store.day_cur + 1
        store.ingest([(s, d, float(rng.gamma(4.0, 10.0))) for s in range(S)])
        store.apply_pending()
    req = pd.DataFrame(fc.keys[:3], columns=list(fc.key_names))
    answers = []
    reader = threading.Thread(target=lambda: answers.extend(
        fc.predict(req, horizon=7) for _ in range(20)))
    reader.start()
    state, done = sched._executor._dispatch(dispatch, prepared)
    device_pull(done)  # the event recorded on the refit stream
    complete(state)
    reader.join()
    sched.stop()
    assert (fs.hw_score.launches - counts[0],
            fs.hw_filter.launches - counts[1]) == (1, 1)
    assert all(np.isfinite(a.yhat).all() for a in answers)
    t_snap = day_snap - store.day0 + 1
    y = torch.as_tensor(store._y[:, :t_snap], device=dev)
    m = torch.as_tensor(store._mask[:, :t_snap], device=dev)
    p0 = hw.fit(y, m, torch.arange(store.day0, day_snap + 1,
                                   dtype=torch.int32, device=dev),
                store.config)
    p1, _, _ = hw.update_state(
        p0, hw.init_update_aux(p0, mask=m),
        torch.as_tensor(store._y[:, t_snap:t_snap + 5], device=dev),
        torch.as_tensor(store._mask[:, t_snap:t_snap + 5], device=dev),
        [1.0] * 5, list(range(day_snap + 1, day_snap + 6)), store.config)
    for name in ("level", "trend", "season", "alpha"):
        assert torch.equal(getattr(store._params, name),
                           getattr(p1, name)), name


@pytest.mark.parametrize("model", ["holt_winters", "theta", "croston"])
def test_time_bucket_predict_byte_equal_on_the_card(dev, model):
    """A padded predict grid (``time_bucket`` 32) trims to the exact grid's
    bytes on the card: every family's forecast works row by row in time."""
    import pandas as pd

    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    batch, fc, _ = _streamed_store(dev, model, T=210)
    exact = BatchForecaster.from_fit(batch, fc.params, model, fc.config)
    req = pd.DataFrame(batch.keys[:5], columns=list(batch.key_names))
    for hist in (False, True):
        a = exact.predict(req, horizon=30, include_history=hist)
        b = fc.predict(req, horizon=30, include_history=hist)
        assert fc.time_bucket == 32
        pd.testing.assert_frame_equal(a, b, check_exact=True)


# -- the scorer's runtime on the card (monitoring/trace.py, cost.py) ----------

def test_predict_device_seconds_match_cuda_events(dev, monkeypatch):
    """The seconds a predict charges to ``serving_predict:<model>`` are the
    host interval from dispatch through the pulls: CUDA events recorded at
    the same two instants agree within 0.8-1.2x (no device work the predict
    queued outlives the charge), and the span carries the same number."""
    import pandas as pd

    from distributed_forecasting_tpu_torch.monitoring import cost, trace
    from distributed_forecasting_tpu_torch.serving import predictor

    fc = _served(dev, "arima")
    req = pd.DataFrame(fc.keys[:40], columns=list(fc.key_names))
    fc.predict(req, horizon=28)
    torch.cuda.synchronize()
    marks, clock = [], predictor.trace_clock

    def evented():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return clock()

    monkeypatch.setattr(predictor, "trace_clock", evented)
    cm = cost.cost_metrics()
    label = "entry=serving_predict:arima,family=arima"
    s0 = cm.device_seconds_total.snapshot().get(label, 0.0)
    tracer = trace.configure_tracing(trace.TraceConfig(enabled=True))
    try:
        for _ in range(10):
            fc.predict(req, horizon=28)
    finally:
        trace.configure_tracing(trace.TraceConfig())
    torch.cuda.synchronize()
    charged = cm.device_seconds_total.snapshot()[label] - s0
    events = sum(marks[2 * i].elapsed_time(marks[2 * i + 1])
                 for i in range(10)) / 1e3
    assert len(marks) == 20
    assert 0.8 <= charged / events <= 1.2, (charged, events)
    spans = [s for s in tracer.recorder.snapshot()
             if s.name == "serving.predict"]
    assert len(spans) == 10
    assert sum(s.attrs["device_seconds"] for s in spans) == pytest.approx(
        charged)


def test_sample_watermarks_read_cuda_memory_stats(dev):
    """The device watermarks are the caching allocator's counts of the card
    in use: ``torch.cuda.memory_stats()``'s allocated bytes, current and
    peak."""
    from distributed_forecasting_tpu_torch.monitoring.cost import CostMetrics

    held = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cm = CostMetrics()
    cm.sample_watermarks()
    stats = torch.cuda.memory_stats()
    assert cm.device_bytes.value == stats["allocated_bytes.all.current"]
    assert cm.device_peak_bytes.value == stats["allocated_bytes.all.peak"]
    assert cm.device_bytes.value >= held.numel()
    assert cm.host_rss_bytes.value > 0


def test_profiler_capture_holds_arima_predict_in_its_annotation(dev,
                                                                 tmp_path):
    """A ``ProfilerSession`` capture while another thread predicts on an
    arima artifact: an ``arima_predict`` kernel lies inside the
    ``serving_predict:arima`` annotation (on the device's timeline or,
    through its launch's correlation id, the host's).  Kineto may drop a
    window's records in a long process, so the capture is taken up to
    three times."""
    import json
    import os
    import threading
    import time

    import pandas as pd

    from distributed_forecasting_tpu_torch.monitoring.trace import (
        ProfilerSession,
    )

    fc = _served(dev, "arima")
    req = pd.DataFrame(fc.keys[:8], columns=list(fc.key_names))
    fc.predict(req, horizon=28)
    sess = ProfilerSession(str(tmp_path), max_seconds=10.0)

    def predicts():
        time.sleep(0.5)
        t_end = time.perf_counter() + 0.5
        while time.perf_counter() < t_end:
            fc.predict(req, horizon=28)
        torch.cuda.synchronize()

    for _ in range(3):
        th = threading.Thread(target=predicts)
        th.start()
        out = sess.capture(1.5)
        th.join(60)
        with open(os.path.join(out, "trace.json")) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and "arima_predict_kernel" in e.get("name", "")]
        marks = [e for e in events if e.get("name") == "serving_predict:arima"]
        corr = {k.get("args", {}).get("correlation") for k in kernels}
        launches = [e for e in events if e.get("cat") == "cuda_runtime"
                    and e.get("args", {}).get("correlation") in corr]

        def inside(a, b):
            return a["ts"] <= b["ts"] and (b["ts"] + b.get("dur", 0)
                                           <= a["ts"] + a.get("dur", 0))

        found = any(inside(a, b) for a in marks for b in kernels + launches)
        if found:
            break
    assert found, (len(kernels), len(marks))


def test_corrupt_stored_library_is_rebuilt_on_a_warm_boot(dev, tmp_path):
    """The chaos case ``aot_corrupt_warm_boot`` on the real kernel library
    (``tests/test_torch_chaos.py`` runs it on a stub): a cold store builds
    the library with nvcc, a warm one loads it without building, one
    flipped byte (``aot.load.payload=corrupt``) is discarded, counted as an
    error, labelled ``error`` and rebuilt with every launcher, and the next
    clean boot loads the rebuilt entry without building."""
    from distributed_forecasting_tpu_torch.engine import compile_cache as cc
    from distributed_forecasting_tpu_torch.monitoring import failpoints as fp
    from distributed_forecasting_tpu_torch.ops import _build

    key = cc.fingerprint("kernel_library", backend=_build.library_backend())
    builds = []

    def build():
        builds.append(1)
        return _build.build(f"dftt_chaos_{len(builds)}", _build.SOURCES,
                            str(tmp_path / f"build-{len(builds)}"))

    def boot():
        return cc.AOTStore(str(tmp_path / "kernels")).get_or_compile(
            key, "kernel_library", build)

    launchers = [f"{k}_launch" for k in (
        "hw_score", "hw_filter", "arima_filter", "arima_predict",
        "arima_loglik_grad", "arima_mle_fit")]
    boot()
    assert len(builds) == 1
    boot()
    assert len(builds) == 1  # warm: loaded, not built
    errors = cc.cache_stats()["errors"]
    labelled = cc._entry_requests.snapshot().get(
        "entry=kernel_library,outcome=error", 0)
    fp.configure("aot.load.payload=corrupt:1")
    try:
        rebuilt = boot()
        assert fp.fired("aot.load.payload") == 1
    finally:
        fp.deactivate()
    assert len(builds) == 2
    assert cc.cache_stats()["errors"] == errors + 1
    assert cc._entry_requests.snapshot()[
        "entry=kernel_library,outcome=error"] == labelled + 1
    assert all(hasattr(rebuilt, name) for name in launchers)
    hits = cc.cache_stats()["hits"]
    again = boot()
    assert all(hasattr(again, name) for name in launchers)
    assert len(builds) == 2 and cc.cache_stats()["hits"] == hits + 1


def test_one_rank_nccl_sharded_fit_is_the_unsharded_fit(dev):
    """``parallel/``: a one-rank NCCL mesh on the card
    (``make_mesh()``), the Holt-Winters ``sharded_fit_forecast`` of the
    committed dataset (500 x 1,826) bit for bit the unsharded fit, and the
    kernels' launch counters moved by the sharded fit."""
    import os

    import torch.distributed as dist

    from distributed_forecasting_tpu_torch import data, engine, parallel
    from distributed_forecasting_tpu_torch.parallel import mesh as pmesh

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csv = os.path.join(root, "datasets", "store_item_demand.csv.gz")
    b = data.tensorize(data.load_sales_csv(csv), device=dev)
    assert (b.n_series, b.n_time) == (500, 1826)
    assert not dist.is_initialized()
    try:
        mesh = parallel.make_mesh()
        assert dist.get_backend() == "nccl"
        fs.hw_score.launches = fs.hw_filter.launches = 0
        _, got = parallel.sharded_fit_forecast(b, "holt_winters", mesh=mesh)
        torch.cuda.synchronize()
        assert fs.hw_score.launches == 1 and fs.hw_filter.launches == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        pmesh._RANK_DEVICE = None
    _, want = engine.fit_forecast(b, "holt_winters")
    for k in ("yhat", "lo", "hi", "ok"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def _mesh_serving_rank(out) -> None:
    """The serving rank of a two-rank mesh, in a fresh process (its
    follower forks before CUDA starts here): fits, predicts on one device
    and over the mesh, and puts ``(mismatches, follower report)`` or the
    error on ``out``."""
    import logging
    import os
    import traceback

    try:
        import numpy as np
        import pandas as pd
        import torch.distributed as dist

        from distributed_forecasting_tpu_torch import data, engine
        from distributed_forecasting_tpu_torch.models import get_model
        from distributed_forecasting_tpu_torch.ops import _build
        from distributed_forecasting_tpu_torch.serving import BatchForecaster
        from distributed_forecasting_tpu_torch.serving.replica import (
            MeshRanks,
        )

        ranks = MeshRanks(2, 0, logging.getLogger("mesh-test"))
        dev = torch.device("cuda")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        csv = os.path.join(root, "datasets", "store_item_demand.csv.gz")
        b = data.tensorize(data.load_sales_csv(csv), device=dev)
        _build.library()
        fcs = {}
        for model in ("arima", "holt_winters"):
            params, _ = engine.fit_forecast(b, model, horizon=28)
            fcs[model] = BatchForecaster.from_fit(
                b, params, model, get_model(model).config_cls())
        calls = {f"{k}": (lambda fc, r: fc.predict(r, horizon=28))
                 for k in (1, 17, 500)}
        calls["500q"] = lambda fc, r: fc.predict_quantiles(
            r, quantiles=(0.1, 0.5, 0.9), horizon=28)
        keys = np.asarray(b.keys)[::-1]

        def run(fc):
            return {name: call(fc, pd.DataFrame(
                keys[:int(name.rstrip("q"))], columns=list(b.key_names)))
                for name, call in calls.items()}

        want = {model: run(fc) for model, fc in fcs.items()}
        mesh = ranks.join(dev)
        assert dist.get_backend() == "gloo"
        got = {}
        for model, fc in fcs.items():
            fc.enable_mesh(mesh)
            got[model] = run(fc)
            fc.disable_mesh()
        fcs["arima"].enable_mesh(mesh)
        (report,) = ranks.drain(fcs["arima"])
        bad = [(model, name, col) for model in fcs for name in calls
               for col in want[model][name].columns
               if got[model][name].columns.tolist()
               != want[model][name].columns.tolist()
               or got[model][name][col].to_numpy().tobytes()
               != want[model][name][col].to_numpy().tobytes()]
        out.put((bad, report, len(calls)))
    except BaseException:  # noqa: BLE001 — the parent fails with it
        out.put(traceback.format_exc())


def test_a_two_rank_mesh_predict_on_one_card_is_byte_equal(dev):
    """A replica's mesh on the card: a fresh process is the serving rank
    and ``serving/replica.MeshRanks`` forks one follower, both on cuda:0
    over gloo (one card).  Arima and Holt-Winters artifacts of the
    committed dataset: predict at 1, 17 and 500 series and
    predict_quantiles at 500, byte-equal to the single-device predict;
    the follower launched ``arima_predict`` for its blocks (its drain
    report)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_mesh_serving_rank, args=(out,))
    proc.start()
    result = out.get(timeout=600)
    proc.join(60)
    assert not isinstance(result, str), result
    bad, report, n_calls = result
    assert bad == [], bad
    assert report["arima_predict"] >= n_calls, report
    assert proc.exitcode == 0
