"""Port parity: ARIMA ``order: auto`` (``engine/order``) against the JAX
reference.

``resolve_order_conf``'s translations and refusals are host logic: equal
outputs and equal error messages.  The sweep runs a CV pass per candidate
(each reference candidate compiles its own program, so these tests sweep
three or four orders, not the 22 of the default ladder): the same winner
where the best two scores are apart by more than 1e-3 relative, and every
row's score within 1e-3 relative (the CV metrics' own tolerance in
``test_torch_arima.py``: the HR fit's float32 solves).
"""

import numpy as np
import pytest

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.engine import order as jorder
from distributed_forecasting_tpu.pipelines import training as jtraining
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.engine import order as torder
from distributed_forecasting_tpu_torch.pipelines import training as ttraining

REL = 1e-3
CV = dict(initial=200, period=60, horizon=30)


@pytest.fixture(scope="module")
def batches():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=360,
                                          seed=4, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    return jdata.tensorize(df), tdata.tensorize(df, device="cpu")


def test_default_ladder_is_the_reference_one():
    assert torder.DEFAULT_ORDERS == jorder.DEFAULT_ORDERS
    assert len(torder.DEFAULT_ORDERS) == 22


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("conf", [
    None,
    {},
    {"p": 1, "d": 0, "q": 1},
    {"order": [3, 1, 2], "m": 7},
    {"order": (1, 0, 0)},
    {"order_candidates": [[1, 1, 1]]},
    {"order_metric": "mase", "p": 1},
    {"order": [1, 1, 1], "order_candidates": [[1, 1, 1]]},
    {"order": [1, 1, 1], "order_metric": "rmse"},
    {"order": "bogus"},
    {"order": [1, 2]},
], ids=["none", "empty", "plain", "pinned", "pinned_tuple", "stray_candidates",
        "stray_metric", "pin_and_candidates", "pin_and_metric", "bad_spec",
        "short_triple"])
def test_resolve_order_conf_is_host_exact(conf, batches):
    jb, tb = batches
    got = _outcome(torder.resolve_order_conf, conf, tb)
    want = _outcome(jorder.resolve_order_conf, conf, jb)
    assert got == want


def _table(rows):
    return {order: (score, n) for order, score, n in rows}


def test_order_auto_sweep_matches_reference(batches):
    jb, tb = batches
    orders = ((1, 1, 1), (2, 1, 1), (0, 1, 1), (1, 0, 1))
    got, got_rows = torder.select_arima_order(tb, orders=orders,
                                              cv=tcv.CVConfig(**CV))
    want, want_rows = jorder.select_arima_order(jb, orders=orders,
                                                cv=jcv.CVConfig(**CV))
    g, w = _table(got_rows), _table(want_rows)
    assert set(g) == set(w) == set(orders)
    for order in orders:
        assert g[order][1] == w[order][1] == tb.n_series
        np.testing.assert_allclose(g[order][0], w[order][0], rtol=REL,
                                   err_msg=str(order))
    scores = sorted(s for s, _ in w.values())
    if scores[1] - scores[0] > REL * scores[0]:
        assert got == want
    # rows come back best first
    assert [r[1] for r in got_rows] == sorted(r[1] for r in got_rows)


def test_pipeline_resolves_order_auto_as_the_reference(batches):
    """``_resolve_model_conf`` runs the sweep for arima only, under the
    task's CV conf, and leaves the other keys as they were."""
    jb, tb = batches
    # candidates of the sweep above: their programs are compiled already
    conf = {"order": "auto", "order_candidates": [[1, 1, 1], [2, 1, 1],
                                                  [1, 0, 1]],
            "order_metric": "mae", "m": 7}
    got = ttraining._resolve_model_conf("arima", conf, tb, 30, CV)
    want = jtraining._resolve_model_conf("arima", conf, jb, 30, CV)
    assert set(got) == set(want) == {"p", "d", "q", "m"}
    assert got["m"] == 7
    rows = jorder.select_arima_order(
        jb, orders=[(1, 1, 1), (2, 1, 1), (1, 0, 1)], metric="mae",
        cv=jcv.CVConfig(**CV))[1]
    scores = sorted(r[1] for r in rows)
    if scores[1] - scores[0] > REL * scores[0]:
        assert got == want
    # another family's conf is not read for an order
    assert ttraining._resolve_model_conf(
        "holt_winters", {"order": "auto"}, tb, 30, CV) == {"order": "auto"}
