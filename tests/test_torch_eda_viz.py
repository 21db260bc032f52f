"""Port parity: the exploratory aggregations (``data/eda.py``) equal the
reference's frames and dicts on the same sales table, and the plots
(``visualization.py``) render on matplotlib's Agg backend from a port fit
on the CPU, as the reference's ``tests/unit/test_eda_viz.py`` checks."""

import numpy as np
import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu.data import eda as jeda
from distributed_forecasting_tpu_torch import data as tdata
from distributed_forecasting_tpu_torch.data import eda as teda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sales():
    return tdata.synthetic_store_item_sales(n_stores=2, n_items=5,
                                            n_days=1096, seed=7)


def test_dataset_stats(sales):
    s = teda.dataset_stats(sales)
    assert s == jeda.dataset_stats(sales)
    assert (s["n_stores"], s["n_items"], s["n_series"],
            s["expected_models"]) == (2, 5, 10, 10)
    assert s["days"] == 1096 and s["rows"] == len(sales)


@pytest.mark.parametrize("name", ["yearly_trend", "monthly_trend",
                                  "weekday_trend"])
def test_trends_match_reference(sales, name):
    got = getattr(teda, name)(sales)
    pd.testing.assert_frame_equal(got, getattr(jeda, name)(sales))
    if name == "yearly_trend":
        assert set(got.columns) == {"year", "sales"}
        assert len(got) == 4  # 2013..2016 (3 years + 1 day)
        np.testing.assert_allclose(got.sales.sum(), sales.sales.sum(),
                                   rtol=1e-9)
    elif name == "monthly_trend":
        assert len(got) == 37
    else:
        assert set(got.weekday.unique()) == set(range(7))
        assert "mean_daily_sales" in got.columns


def test_plots_render(sales):
    import matplotlib

    matplotlib.use("Agg")
    from distributed_forecasting_tpu_torch import visualization as viz
    from distributed_forecasting_tpu_torch.engine import fit_forecast
    from distributed_forecasting_tpu_torch.models.prophet_glm import (
        CurveModelConfig,
    )

    batch = tdata.tensorize(sales, device="cpu")
    cfg = CurveModelConfig()
    params, res = fit_forecast(batch, model="prophet", config=cfg,
                               horizon=30)
    ax = viz.plot_forecast(batch, res, series_index=1)
    assert ax.get_title()
    assert len(ax.lines) == 3  # observed, yhat, the cutoff line
    ax2 = viz.plot_changepoints(params, cfg)
    assert len(ax2.patches) == cfg.n_changepoints  # one bar a changepoint
    fig = viz.plot_components(params, cfg, res.day_all)
    assert len(fig.axes) >= 3  # trend + weekly + yearly
    fig2 = viz.plot_components(params, cfg, res.day_all.numpy(),
                               t_end=int(batch.day[-1]))
    assert [a.get_ylabel() for a in fig2.axes] == [
        a.get_ylabel() for a in fig.axes]
    matplotlib.pyplot.close("all")
