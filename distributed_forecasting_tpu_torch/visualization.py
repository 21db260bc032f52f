"""Forecast plots (port of the reference's ``visualization.py``).

From this framework's artifacts: history + forecast with the interval band,
the learned changepoint magnitudes, and the decomposed components (trend /
weekly / yearly) recovered from the curve model's linear basis.  Tensors
are moved to the host before plotting.

matplotlib is imported lazily (headless 'Agg' backend), so the library
never requires a display and the dependency stays optional: no module on
the fit, training or serving path imports this one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_forecast(
    batch,
    result,
    series_index: int = 0,
    ax=None,
    title: Optional[str] = None,
):
    """History points + forecast line with the interval band (one series)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    import pandas as pd

    dates = pd.to_datetime(_host(result.day_all).astype("int64"), unit="D")
    T_hist = batch.n_time
    y = _host(batch.y[series_index])
    m = _host(batch.mask[series_index]) > 0
    ax.plot(batch.dates()[m], y[m], "k.", ms=2, label="observed")
    ax.plot(dates, _host(result.yhat[series_index]), lw=1.2, label="yhat")
    ax.fill_between(
        dates,
        _host(result.lo[series_index]),
        _host(result.hi[series_index]),
        alpha=0.25, linewidth=0, label="interval",
    )
    ax.axvline(batch.dates()[T_hist - 1], ls="--", lw=0.8, color="grey")
    keys = dict(zip(batch.key_names, batch.keys[series_index]))
    ax.set_title(title or f"forecast {keys}")
    ax.legend(loc="best", fontsize=8)
    return ax


def plot_changepoints(params, config, series_index: int = 0, ax=None):
    """Learned changepoint slope deltas over the changepoint grid, as the
    model stores them."""
    from distributed_forecasting_tpu_torch.models.prophet_glm import _n_cp

    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 3))
    k = _n_cp(config)
    deltas = _host(params.beta[series_index, 2: 2 + k])
    if config.changepoint_days:
        # explicit sites: scaled by the training span the params carry
        t0, t1 = float(params.t0), float(params.t1)
        grid = (
            np.asarray(sorted(config.changepoint_days), float) - t0
        ) / max(t1 - t0, 1.0)
    else:
        grid = np.arange(1, k + 1) / (k + 1) * config.changepoint_range
    ax.bar(grid, deltas, width=0.8 / (k + 1))
    ax.set_xlabel("scaled time of changepoint")
    ax.set_ylabel("slope delta")
    ax.set_title("changepoint magnitudes")
    return ax


def plot_components(params, config, day_all, series_index: int = 0,
                    xreg=None, t_end=None):
    """Trend / weekly / yearly decomposition from the linear basis (the
    Prophet components plot).  Returns the figure."""
    from distributed_forecasting_tpu_torch.models.prophet_glm import decompose

    plt = _plt()
    import pandas as pd

    days = _host(day_all).astype("int64")
    dates = pd.to_datetime(days, unit="D")
    device = params.beta.device
    comps = {
        name: _host(vals[series_index])
        for name, vals in decompose(
            params, torch.as_tensor(days, dtype=torch.int32, device=device),
            config, xreg=xreg,
            t_end=None if t_end is None else torch.tensor(
                float(t_end), dtype=torch.float32, device=device),
        ).items()
    }

    fig, axes = plt.subplots(len(comps), 1, figsize=(9, 2.2 * len(comps)),
                             sharex=True)
    if len(comps) == 1:
        axes = [axes]
    for ax, (name, vals) in zip(axes, comps.items()):
        if name == "weekly":
            ax.plot(dates[:15], vals[:15])  # two weeks is enough to read
        else:
            ax.plot(dates, vals)
        ax.set_ylabel(name)
    fig.tight_layout()
    return fig
