"""Port parity: hierarchical reconciliation against the JAX reference — the
store x item ``Hierarchy``, bottom-up aggregation, top-down allocation, MinT
with structural and CV weights, ``coherency_error``,
``reconciliation_report``, the MinT node batch and the ``reconcile`` task
for each method.

Inputs: random base forecasts over a 3-store x 5-item hierarchy (24
nodes) made with numpy from a seed, and, for the task, 2 stores x 4 items
of synthetic sales (15 nodes) x 400 days with CV 200/60/30.

Tolerances:
  * the summing matrix, node labels, keys, node batch masks and
    aggregated integer sales are equal;
  * bottom-up and top-down sums within rtol 1e-6 (float32 sums of a few
    terms, in another order);
  * MinT within ``10 cond(G) 2^-24`` of the forecasts' scale, both against
    the reference (each a float32 Cholesky of the same G) and against a
    float64 numpy solve of the same system; coherency within 1e-6 of the
    forecasts' scale;
  * the MinT task's table within 1e-4 of each node's scale: its theta node
    fits agree within 1e-5 (test_torch_theta.py) where the alpha winners
    are apart, which the test checks for every node and cutoff, and the
    CV weights then move the solve by their own relative change.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu.reconcile import hierarchy as jh
from distributed_forecasting_tpu.tasks import reconcile as jrec
import distributed_forecasting_tpu.data as jdata
from distributed_forecasting_tpu_torch import tasks as ttasks
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu_torch.reconcile import hierarchy as th
from distributed_forecasting_tpu_torch.tasks import reconcile as trec

torch.set_num_threads(1)

F32_EPS = 2.0 ** -24


def _keys(n_stores=3, n_items=5, drop=(4,)):
    keys = np.array([(s, i) for s in range(1, n_stores + 1)
                     for i in range(1, n_items + 1)], dtype=np.int64)
    return np.delete(keys, list(drop), axis=0)  # one store lacks an item


def _base(h, H=12, seed=0):
    """Incoherent base forecasts at every level: bottoms plus noise summed
    up, each level perturbed."""
    rng = np.random.default_rng(seed)
    bottom = rng.uniform(2, 20, size=(h.n_bottom, H))
    coherent = h.S_mat.astype(np.float64) @ bottom
    noise = rng.normal(0, 0.05, size=coherent.shape) * coherent
    return (coherent + noise).astype(np.float32)


def test_hierarchy_matches_reference():
    keys = _keys()
    jh_, th_ = jh.Hierarchy.from_keys(keys), th.Hierarchy.from_keys(keys)
    for f in ("keys", "stores", "items", "S_mat"):
        np.testing.assert_array_equal(getattr(th_, f), getattr(jh_, f))
    assert th_.S_mat.dtype == np.float32
    assert (th_.n_bottom, th_.n_nodes) == (jh_.n_bottom, jh_.n_nodes) == (
        14, 1 + 3 + 5 + 14)
    assert th_.node_labels() == jh_.node_labels()


def test_bottom_up_and_top_down_match_reference():
    keys = _keys()
    jh_, th_ = jh.Hierarchy.from_keys(keys), th.Hierarchy.from_keys(keys)
    rng = np.random.default_rng(1)
    bottom = rng.uniform(0, 30, size=(th_.n_bottom, 10)).astype(np.float32)
    got = th.aggregate_bottom_up(th_, torch.from_numpy(bottom)).numpy()
    want = np.asarray(jh.aggregate_bottom_up(jh_, bottom))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(th.coherency_error(th_, torch.from_numpy(got))) <= (
        1e-6 * np.abs(got).max())
    total = bottom.sum(0)
    props = rng.uniform(0, 5, size=th_.n_bottom).astype(np.float32)
    got = th.top_down_allocate(th_, torch.from_numpy(total),
                               torch.from_numpy(props)).numpy()
    want = np.asarray(jh.top_down_allocate(jh_, total, props))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[0], total, rtol=1e-6)


def _mint64(S_mat, base, var):
    """The same MinT system solved in float64 with numpy: (x, cond(G))."""
    S = S_mat.astype(np.float64)
    w_inv = 1.0 / np.maximum(var.astype(np.float64), 1e-12)
    SW = S * w_inv[:, None]
    G = S.T @ SW + 1e-8 * np.eye(S.shape[1])
    x = np.linalg.solve(G, SW.T @ base.astype(np.float64))
    return S @ x, float(np.linalg.cond(G))


@pytest.mark.parametrize("weights", ["struct", "cv"])
def test_mint_matches_reference_and_float64(weights):
    keys = _keys()
    jh_, th_ = jh.Hierarchy.from_keys(keys), th.Hierarchy.from_keys(keys)
    base = _base(th_)
    if weights == "cv":
        # CV-like variances spanning three decades across the nodes
        rng = np.random.default_rng(2)
        var = (10.0 ** rng.uniform(-1, 2, size=th_.n_nodes)).astype(
            np.float32)
        tv, jv = torch.from_numpy(var), var
    else:
        var = th_.S_mat.sum(1)
        tv = jv = None
    got = th.reconcile_forecasts(th_, torch.from_numpy(base), tv).numpy()
    want = np.asarray(jh.reconcile_forecasts(jh_, base, jv))
    exact, cond = _mint64(th_.S_mat, base, var)
    scale = np.abs(exact).max()
    tol = 10 * cond * F32_EPS * scale
    np.testing.assert_array_less(np.abs(got - want), tol)
    np.testing.assert_array_less(np.abs(got - exact), tol)
    assert float(th.coherency_error(th_, torch.from_numpy(got))) <= (
        1e-6 * scale)
    # the revision moves the incoherent base onto the coherent subspace
    assert float(th.coherency_error(th_, torch.from_numpy(base))) > 1e-2


def test_failed_cholesky_raises():
    h = th.Hierarchy.from_keys(_keys())
    var = torch.full((h.n_nodes,), float("nan"))
    with pytest.raises(torch.linalg.LinAlgError):
        th.reconcile_forecasts(h, torch.from_numpy(_base(h)), var)


def test_reconciliation_report_matches_reference():
    keys = _keys()
    jh_, th_ = jh.Hierarchy.from_keys(keys), th.Hierarchy.from_keys(keys)
    rng = np.random.default_rng(3)
    actual = np.round(rng.uniform(0, 20, size=(th_.n_bottom, 30))).astype(
        np.float32)
    actual[2, :5] = 0.0
    fc = (actual + rng.normal(0, 2, size=actual.shape)).astype(np.float32)
    mask = (rng.random(actual.shape) > 0.1).astype(np.float32)
    mask[5] = 0.0
    got = th.reconciliation_report(th_, *(torch.from_numpy(a)
                                          for a in (fc, actual, mask)))
    want = jh.reconciliation_report(jh_, fc, actual, mask)
    assert set(got) == set(want) == {"total_mape", "store_mape", "item_mape"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def history():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=4, n_days=400,
                                          seed=9, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    # a late-launching item: its bottom row must keep its own mask
    late = (df["store"] == 1) & (df["item"] == 2)
    return df[~late | (df["date"] >= df["date"].min()
                        + pd.Timedelta(days=120))].reset_index(drop=True)


def test_mint_node_batch_matches_reference(history):
    jb, tb = jdata.tensorize(history), tdata.tensorize(history, device="cpu")
    h = th.Hierarchy.from_keys(tb.keys)
    got = trec.mint_node_batch(tb, h)
    want = jrec.mint_node_batch(jb, jh.Hierarchy.from_keys(np.asarray(
        jb.keys)))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.keys, want.keys)
    n_agg = h.n_nodes - h.n_bottom
    assert (got.mask[:n_agg] == 1).all()
    # bottoms keep their own masks: the late item's first 120 days are out
    late = int(np.flatnonzero((tb.keys == (1, 2)).all(1))[0])
    assert (got.mask[n_agg + late, :120] == 0).all()
    torch.testing.assert_close(got.mask[n_agg:], tb.mask, rtol=0, atol=0)


@pytest.mark.parametrize("mse, want", [
    (np.array([4.0, 0.0, np.nan, 1.0, 2.0], np.float32), [4, 2, 2, 1, 2]),
    (np.array([0.0, np.inf], np.float32), [1.0, 1.0]),
], ids=["median_of_positive", "none_positive"])
def test_mint_error_var_fallback(mse, want):
    np.testing.assert_array_equal(trec.mint_error_var(mse), want)


HORIZON = 28
CV = {"initial": 200, "period": 60, "horizon": 30}


@pytest.fixture(scope="module")
def store(history, tmp_path_factory):
    """One store both packages read: the history table and a forecast
    table from the port's theta train task."""
    root = str(tmp_path_factory.mktemp("reconcile"))
    env = {"env": {"root": root}}
    catalog = tdata.DatasetCatalog(f"{root}/warehouse")
    catalog.save_table("hackathon.sales.raw", history)
    ttasks.TrainTask(init_conf={
        **env, "input": {"table": "hackathon.sales.raw"},
        "output": {"table": "hackathon.sales.finegrain_forecasts"},
        "training": {"model": "theta", "run_cross_validation": False,
                     "horizon": HORIZON}}, device="cpu").launch()
    return env


def _reconcile(env, package, method, **rc):
    conf = {**env,
            "input": {"table": "hackathon.sales.finegrain_forecasts",
                      "history_table": "hackathon.sales.raw"},
            "output": {"table": f"hackathon.sales.rec_{package}_{method}"},
            "reconcile": {"method": method, "horizon": HORIZON, **rc}}
    if package == "ref":
        task = jrec.ReconcileTask(init_conf=conf)
    else:
        task = trec.ReconcileTask(init_conf=conf, device="cpu")
    summary = task.launch()
    return summary, task.catalog.read_table(conf["output"]["table"])


def _winners_apart(history):
    """Every node's alpha winner, in the fit and in each CV cutoff, is apart
    from the runner-up by more than test_torch_theta's TIE_RTOL."""
    from test_torch_theta import _apart, _candidate_sses

    from distributed_forecasting_tpu_torch.engine import cv as tcv
    from distributed_forecasting_tpu_torch.models.theta import ThetaConfig

    tb = tdata.tensorize(history, device="cpu")
    nodes = trec.mint_node_batch(tb, th.Hierarchy.from_keys(tb.keys))
    cuts = tcv.cutoff_indices(tb.n_time, tcv.CVConfig(**CV))
    train = tcv.cv_windows(nodes.mask, nodes.day, cuts, CV["horizon"])[0]
    return all(_apart(_candidate_sses(nodes.y.numpy(), mask.numpy(),
                                      nodes.day.numpy(), ThetaConfig())).all()
               for mask in (nodes.mask, *train))


@pytest.mark.parametrize("method, rc", [
    ("bottom_up", {}), ("top_down", {}),
    ("mint", {"weights": "struct"}), ("mint", {"weights": "cv", "cv": CV}),
], ids=["bottom_up", "top_down", "mint_struct", "mint_cv"])
def test_reconcile_task_matches_reference(store, history, method, rc):
    got_sum, got = _reconcile(store, "port", method, **rc)
    want_sum, want = _reconcile(store, "ref", method, **rc)
    assert set(got_sum) == set(want_sum)
    for k in got_sum:
        if k != "table_version":
            assert got_sum[k] == want_sum[k], k
    assert got_sum["n_nodes"] == 15
    # mint forecasts the horizon; bottom_up and top_down take the forecast
    # table's rows without actuals, which are the horizon and, as in the
    # reference, every history day some series has masked
    days = got_sum["n_days"]
    assert days == HORIZON if method == "mint" else days > HORIZON
    assert list(got.columns) == list(want.columns) == [
        "ds", "node", "yhat", "method"]
    pd.testing.assert_frame_equal(got[["ds", "node", "method"]],
                                  want[["ds", "node", "method"]])
    g = got["yhat"].to_numpy().reshape(15, days)
    w = want["yhat"].to_numpy().reshape(15, days)
    # a day whose pivot misses a series is NaN in both (the reference's own
    # output for a masked history day)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    if method == "mint":
        assert np.isfinite(g).all()
        assert _winners_apart(history)
    else:
        assert np.isfinite(g[:, -HORIZON:]).all()
    scale = np.nanmax(np.abs(w), axis=1, keepdims=True)
    rtol = 1e-4 if method == "mint" else 1e-6
    np.testing.assert_array_less(np.nan_to_num(np.abs(g - w)),
                                 np.broadcast_to(rtol * scale + 1e-6, g.shape))
    g = g[:, -HORIZON:]
    coherent = th.Hierarchy.from_keys(
        tdata.tensorize(history, device="cpu").keys)
    err = float(th.coherency_error(coherent,
                                   torch.tensor(g, dtype=torch.float32)))
    assert err <= 1e-5 * np.abs(g).max(), err


def test_unknown_method_and_weights_raise(store):
    with pytest.raises(ValueError, match="unknown reconcile method"):
        _reconcile(store, "port", "middle_out")
    with pytest.raises(ValueError, match="cv\\|struct"):
        _reconcile(store, "port", "mint", weights="ols")
