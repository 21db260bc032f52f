"""Port parity: the data-cleaning operations of ``ops/clean.py`` against the
JAX reference, on the same arrays.

The inputs are whole numbers, as the committed dataset's sales are, with
planted spikes, zero runs, level shifts and masked days.  On such rows
every running sum stays below 2**24, so the box-window sums are exact in
float32 whatever order the terms are added in: the zero-run lengths, the
box sums, the outlier scores and scales, and the repairs are held bitwise.

After repair the values are fractional, and the two packages' running
sums round differently (the port adds each row in order,
``models/base.cumsum_rows``; XLA's CPU scan does not).  There:

* float outputs that come from sums of up to T terms are held within
  ``T * 2**-24`` of their magnitude (plus that of the row's scale), the
  float32 bound of a sum of T terms;
* a CUSUM ``cp_index`` may differ only where the row's two largest valid
  ``|dev|`` are within ``1e-6 * sum|y * m|`` of each other (a tie within
  the rounding of the cumulative sum); ``found`` may differ only where the
  score is within that tolerance of the threshold.  Shift and score are
  then held at the reference's index.

The interpolation ``v_prev * (1 - w) + v_next * w`` may be contracted into
an FMA by XLA; repaired values are held within 2 ulps, not bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.ops import clean as jclean
from distributed_forecasting_tpu_torch.ops import clean as tclean

torch.set_num_threads(1)

S, T = 16, 400
EPS32 = 2.0 ** -24
CP_TIE = 1e-6


def _data(seed: int = 0, fractional: bool = False):
    """(S, T) daily demand: level + weekly cycle + noise, a +25 shift from
    day 250 in the even rows, three x8 spikes a row, an observed 30-day
    zero run in row 1 and a 4-day one in row 2, row 3 unobserved for its
    first 60 days and 5% of the other days masked."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    y = (rng.uniform(20, 60, (S, 1)) + 8 * np.sin(2 * np.pi * t / 7)
         + rng.normal(0, 3, (S, T)))
    y[:, 250:] += np.where(np.arange(S)[:, None] % 2 == 0, 25.0, 0.0)
    for s in range(S):
        y[s, rng.choice(np.arange(10, T - 10), 3, replace=False)] *= 8
    y[1, 50:80] = 0.0
    y[2, 100:104] = 0.0
    mask = (rng.random((S, T)) > 0.05).astype(np.float32)
    mask[1, 50:80] = mask[2, 100:104] = 1.0  # the zero runs are observed
    mask[3, :60] = 0.0
    y = np.maximum(y, 0.0)
    if not fractional:
        y = np.round(y)
    return (y * mask).astype(np.float32), mask


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize("min_run", [3, 14])
def test_zero_runs_match_reference(min_run):
    y, mask = _data()
    (jy, jm), (ty, tm) = _both(y, mask)
    np.testing.assert_array_equal(
        tclean.zero_run_lengths(ty, tm).numpy(),
        np.asarray(jclean.zero_run_lengths(jy, jm)))
    jmask, jdrop = jclean.mask_zero_runs(jy, jm, min_run)
    tmask, tdrop = tclean.mask_zero_runs(ty, tm, min_run)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    # the 30-day run is dropped at either length, the 4-day one only at 3
    assert tdrop[1, 50:80].all() and tdrop[2, 100:104].all() == (min_run <= 4)


@pytest.mark.parametrize("fractional", [False, True],
                         ids=["whole", "fractional"])
@pytest.mark.parametrize("window", [1, 7])
def test_box_window_sums_match_reference(fractional, window):
    y, mask = _data(seed=1, fractional=fractional)
    (jv,), (tv,) = _both(y * mask)
    got = tclean._box_window_sums(tv, window).numpy()
    want = np.asarray(jclean._box_window_sums(jv, window))
    if fractional:
        # two float32 running sums of up to T terms: each within
        # T * eps * sum|v| of the exact sum
        tol = 2 * T * EPS32 * np.abs(y * mask).sum(axis=1, keepdims=True)
        assert (np.abs(got - want) <= tol).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [1, 7])
def test_outlier_scores_and_repair_match_reference(window):
    y, mask = _data(seed=2)
    (jy, jm), (ty, tm) = _both(y, mask)
    jscore, jscale = jclean.mad_outlier_scores(jy, jm, window)
    tscore, tscale = tclean.mad_outlier_scores(ty, tm, window)
    # whole numbers: the box sums are exact, the rest is the same IEEE
    # arithmetic in the same order
    np.testing.assert_array_equal(tscore.numpy(), np.asarray(jscore))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    flag = np.asarray(jscore) > 6.0
    assert flag.sum() >= S  # the planted spikes
    (jf,), (tf,) = _both(flag)
    jy2, jrep = jclean.interpolate_repair(jy, jm, jf)
    ty2, trep = tclean.interpolate_repair(ty, tm, tf)
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    want = np.asarray(jy2)
    # XLA may contract the interpolation into an FMA: 2 ulps
    assert (np.abs(ty2.numpy() - want)
            <= 2 * np.spacing(np.abs(want))).all()
    # cells not repaired are the input, bit for bit
    keep = ~trep.numpy()
    np.testing.assert_array_equal(ty2.numpy()[keep], y[keep])


def test_repair_edges_and_anchorless_rows():
    """A flagged first and last cell take their one-sided neighbor; a row
    whose every observed cell is flagged keeps its values."""
    y, mask = _data(seed=3)
    flag = np.zeros((S, T), bool)
    flag[0, 0] = flag[0, T - 1] = True
    flag[5, :] = True
    (jy, jm, jf), (ty, tm, tf) = _both(y, mask, flag)
    jy2, jrep = jclean.interpolate_repair(jy, jm, jf)
    ty2, trep = tclean.interpolate_repair(ty, tm, tf)
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    np.testing.assert_array_equal(ty2.numpy(), np.asarray(jy2))
    assert not trep[5].any() and torch.equal(ty2[5], ty[5])


def _top_two_gap(y, mask):
    """Per row: the gap between the two largest valid |dev| of the CUSUM
    statistic (float64), and the row's sum |y * m|."""
    m = mask.astype(np.float64)
    v = y.astype(np.float64) * m
    n_tot = m.sum(1, keepdims=True)
    mu = v.sum(1, keepdims=True) / np.maximum(n_tot, 1)
    dev = np.abs(np.cumsum((y - mu) * m, axis=1))
    n_left = np.cumsum(m, axis=1)
    valid = (n_left >= 2) & (n_tot - n_left >= 2)
    stat = np.sort(np.where(valid, dev, -np.inf), axis=1)
    return stat[:, -1] - stat[:, -2], np.abs(v).sum(1)


def _shift64(y, mask, s, cp):
    """Float64 mean(after) - mean(before) of row ``s`` split after ``cp``."""
    m = mask[s].astype(bool)
    v = y[s].astype(np.float64)
    before, after = v[: cp + 1][m[: cp + 1]], v[cp + 1:][m[cp + 1:]]
    return after.mean() - before.mean()


def assert_cusum_close(got, want, y, mask, threshold):
    """The tie rule of the module docstring, row by row."""
    g_cp, g_shift, g_score = (x.numpy() for x in got)
    w_cp, w_shift, w_score = (np.asarray(x) for x in want)
    gap, mass = _top_two_gap(y, mask)
    tol = y.shape[1] * EPS32
    scale = np.abs(y * mask).max(axis=1)
    for s in range(y.shape[0]):
        if g_cp[s] == w_cp[s]:
            assert abs(g_shift[s] - w_shift[s]) <= tol * (
                abs(w_shift[s]) + scale[s]), s
            assert abs(g_score[s] - w_score[s]) <= tol * abs(w_score[s]) + 1e-6
            continue
        if (g_cp[s] < 0) != (w_cp[s] < 0):
            # found flipped: only at the threshold
            assert abs(max(g_score[s], w_score[s]) - threshold) \
                <= tol * threshold, s
            continue
        # a tie of the statistic: each package's shift is right at its own
        # index (the reference's held at the reference's)
        assert gap[s] <= CP_TIE * mass[s], s
        for cp, shift in ((g_cp[s], g_shift[s]), (w_cp[s], w_shift[s])):
            assert abs(shift - _shift64(y, mask, s, cp)) <= tol * (
                abs(shift) + scale[s]), s


@pytest.mark.parametrize("fractional", [False, True],
                         ids=["whole", "fractional"])
@pytest.mark.parametrize("threshold", [4.0, 8.0])
def test_cusum_level_shift_matches_reference(fractional, threshold):
    y, mask = _data(seed=4, fractional=fractional)
    (jy, jm), (ty, tm) = _both(y, mask)
    got = tclean.cusum_level_shift(ty, tm, threshold)
    want = jclean.cusum_level_shift(jy, jm, threshold)
    assert got[0].dtype == torch.int32
    assert_cusum_close(got, want, y, mask, threshold)
    # the planted +25 shifts are found in the even rows, near day 250
    # (the unrepaired x8 spikes move the split by up to a few weeks)
    cp = got[0].numpy()
    assert (np.abs(cp[::2] - 249) <= 30).all()
    assert (got[1].numpy()[::2] > 0).all()


def test_align_level_shift_matches_reference():
    y, mask = _data(seed=5)
    (jy, jm), (ty, tm) = _both(y, mask)
    jcp, jshift, _ = jclean.cusum_level_shift(jy, jm, 8.0)
    cp, shift = np.asarray(jcp), np.asarray(jshift)
    got = tclean.align_level_shift(ty, tm, torch.from_numpy(cp),
                                   torch.from_numpy(shift))
    want = jclean.align_level_shift(jy, jm, jcp, jshift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[cp < 0], y[cp < 0])


@pytest.mark.parametrize("n_holidays", [0, 3])
def test_holiday_indicators_match_reference(n_holidays):
    day = np.arange(19000, 19000 + 120, dtype=np.int32)
    if n_holidays:
        days = np.full((n_holidays, 4), -1, np.int32)
        days[0, :2] = [19003, 19100]
        days[1, :4] = [19010, 19011, 19012, 18000]
        days[2, :1] = [19119]
    else:
        days = np.zeros((0, 1), np.int32)
    got = tclean.holiday_indicators(torch.from_numpy(day),
                                    torch.from_numpy(days))
    want = np.asarray(jclean.holiday_indicators(jnp.asarray(day),
                                                jnp.asarray(days)))
    assert got.shape == (120, n_holidays) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
