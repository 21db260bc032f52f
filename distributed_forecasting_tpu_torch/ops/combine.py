"""WLS combine for window-parallel (DARIMA) fitting (port of the
reference's ``ops/combine.py``).

*Distributed ARIMA Models for Ultra-long Time Series* (arXiv 2007.09577)
estimates one global model from K independent sub-series fits by weighted
least squares with inverse-covariance weights: each window k contributes
its coefficient estimate beta_k and the precision Sigma_k^{-1} of that
estimate, and the combined estimator is the closed form

    beta = (sum_k Sigma_k^{-1})^{-1} sum_k Sigma_k^{-1} beta_k.

For the Hannan-Rissanen regression the precision is available for free:
Sigma_k^{-1} = X_k'X_k / sigma2_k, the ridged normal matrix and residual
variance that ``models/arima._hr_regression`` already computes.  So the
combine is one (S, F, F) batched solve over statistics that are O(F^2)
per window; the (S*K, W) window data never reaches it.  All of it is
library calls (reductions and ``ops/solve.solve_dense``); the reference has
no Pallas kernel here, so the port has no hand kernel either.
"""

from __future__ import annotations

import torch

from distributed_forecasting_tpu_torch.ops.solve import solve_dense

_EPS = 1e-6


def wls_combine(stats: dict, n_windows: int) -> dict:
    """Combine per-window HR sufficient statistics into one estimate per
    series.

    ``stats`` is the dict returned by ``models/arima.window_stats`` with
    every leaf flat over the series x windows axis: coef (S*K, F), gram
    (S*K, F, F), n_valid/sigma2/mean/n_obs (S*K,).  Windows of one series
    are CONTIGUOUS (series-major), matching ``engine/windowed``'s gather.

    Returns per-series ``{"coef": (S, F), "mean": (S,), "sigma2": (S,)}``:
    the WLS-combined regression coefficients, the precision-weighted global
    mean of the differenced series, and the observation-pooled residual
    variance (diagnostic: the tail finalize recomputes sigma2 from its own
    Kalman pass).
    """
    coef = stats["coef"]
    B, F = coef.shape
    if B % n_windows:
        raise ValueError(
            f"flat window axis {B} is not a multiple of n_windows={n_windows}"
        )
    S = B // n_windows

    def grp(x):
        return x.reshape((S, n_windows) + tuple(x.shape[1:]))

    sigma2 = torch.clamp_min(grp(stats["sigma2"]), _EPS)   # (S, K)
    n_obs = grp(stats["n_obs"])                            # (S, K)
    n_valid = grp(stats["n_valid"])                        # (S, K)
    mean_k = grp(stats["mean"])                            # (S, K)

    # precision-weighted global mean (scalar WLS over the window means)
    w_mean = n_obs / sigma2
    mean = torch.sum(w_mean * mean_k, dim=1) / torch.clamp_min(
        torch.sum(w_mean, dim=1), _EPS)
    # observation-pooled residual variance
    pooled = torch.sum(n_valid * sigma2, dim=1) / torch.clamp_min(
        torch.sum(n_valid, dim=1), 1.0)

    if F == 0:
        return {"coef": coef.new_zeros((S, 0)), "mean": mean,
                "sigma2": pooled}

    gram = grp(stats["gram"])                              # (S, K, F, F)
    coef_k = grp(coef)                                     # (S, K, F)
    prec = gram / sigma2[..., None, None]                  # Sigma_k^{-1}
    A = torch.sum(prec, dim=1)                             # (S, F, F)
    b = torch.einsum("skfg,skg->sf", prec, coef_k)
    # each gram already carries the HR ridge, so A is a sum of SPD terms
    return {"coef": solve_dense(A, b), "mean": mean, "sigma2": pooled}


def combine_estimates(model: str, stats: dict, n_windows: int) -> dict:
    """One batched WLS combine at the reference's AOT entry
    ``windowed_combine:<model>`` (``engine/compile_cache.aot_call``), under
    the ``windowed.combine`` span."""
    from distributed_forecasting_tpu_torch.engine.compile_cache import (
        aot_call,
    )
    from distributed_forecasting_tpu_torch.monitoring.trace import (
        device_annotation,
        get_tracer,
    )

    entry = f"windowed_combine:{model}"
    with get_tracer().span("windowed.combine", model=model,
                           rows=int(stats["coef"].shape[0]),
                           n_windows=int(n_windows)):
        with device_annotation(entry):
            return aot_call(entry, wls_combine, args=(stats,),
                            static_kwargs={"n_windows": int(n_windows)})
