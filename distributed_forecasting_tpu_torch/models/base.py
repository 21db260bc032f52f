"""Model protocol + registry (port of the reference's ``models/base.py``).

Every model family exposes the same two functions over a *batch* of series:

    fit(y, mask, day, config)               -> params (frozen dataclass of
                                               tensors; leaves lead with the
                                               series axis S)
    forecast(params, day_all, t_end, config) -> (yhat, lo, hi), each
                                               (S, len(day_all))

``day_all`` covers history + horizon; ``t_end`` is the last *training* day
(a scalar, or one per series), where forecast uncertainty starts.  No family
ported so far draws random numbers, so the contract carries no generator.
Families registered with ``supports_xreg`` (the curve model) also take
``xreg=`` exogenous regressor values in ``fit`` and ``forecast``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

MODEL_REGISTRY: dict = {}


def _ndtri(p, device) -> torch.Tensor:
    """Standard-normal quantile of ``p`` (float or sequence) in float32."""
    return torch.special.ndtri(torch.as_tensor(p, dtype=torch.float32,
                                               device=device))


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, dim=-1)`` in which every row adds its terms in
    order, whatever the number of rows beside it, so a series' forecast does
    not depend on the series computed with it (the serving coalescer's
    contract, ``BatchForecaster.coalesce_safe``).

    On the card PyTorch scans the last axis with a parallel scheme per row,
    and a tensor with one row through CUB's device-wide scan, so a row's
    rounding changes with the row count.  Scanned along the leading axis of
    the transpose, each row gets one thread that adds in sequence; a lone
    row is scanned beside a copy of itself, which keeps it off CUB.  On the
    CPU every row is already summed in order."""
    if x.device.type != "cuda":
        return torch.cumsum(x, dim=-1)
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    cols = rows.t() if n > 1 else rows.t().expand(-1, 2)
    out = torch.cumsum(cols.contiguous(), dim=0)[:, :n]
    return out.t().reshape(x.shape)


def gaussian_quantiles(forecast_fn: Callable, floor=None) -> Callable:
    """Exact quantile forecaster for families whose predictive is Gaussian in
    data space (``hi = yhat + z·sd``); the per-step sd is recovered from the
    upper bound, which no family clamps, and ``floor`` (croston's
    non-negative demand) then clamps every priced level.  Returns
    (S, Q, T_all)."""

    def forecast_quantiles(params, day_all, t_end, config,
                           quantiles=(0.1, 0.5, 0.9)):
        if not quantiles or not all(0.0 < q < 1.0 for q in quantiles):
            raise ValueError(
                f"quantiles must lie in (0, 1), got {quantiles!r}"
            )
        yhat, lo, hi = forecast_fn(params, day_all, t_end, config)
        z_w = _ndtri(0.5 + config.interval_width / 2.0, yhat.device)
        sd = (hi - yhat) / z_w
        zq = _ndtri(tuple(quantiles), yhat.device)
        yq = yhat[:, None, :] + zq[None, :, None] * sd[:, None, :]
        return yq if floor is None else torch.clamp_min(yq, floor)

    return forecast_quantiles


def history_splice(fitted, future, day_all, day0, h):
    """The (S, T_all) forecast path over history + future days: in-sample
    days (``h <= 0``) gather the one-step fitted path by day offset from
    ``day0``; future days take ``future``."""
    S, T_fit = fitted.shape
    hist_idx = torch.clamp(
        (day_all.to(torch.float32) - day0).to(torch.int64), 0, T_fit - 1
    )
    hist = torch.gather(fitted, 1, hist_idx.expand(S, -1))
    return torch.where(h > 0.0, future, hist)


class ModelFns(NamedTuple):
    fit: Callable
    forecast: Callable
    config_cls: type
    # (params, day_all, t_end, config, quantiles) -> (S, Q, T_all)
    forecast_quantiles: Callable = None
    supports_xreg: bool = False
    # hard floor the family enforces on its lower band (croston clamps
    # demand at 0); band post-processing (conformal scaling,
    # engine/calibrate, the blend's pooled band) re-applies it after
    # widening
    band_floor: Optional[float] = None


def register_model(name: str, fit: Callable, forecast: Callable,
                   config_cls: type, forecast_quantiles: Callable = None,
                   supports_xreg: bool = False,
                   band_floor: Optional[float] = None):
    MODEL_REGISTRY[name] = ModelFns(fit=fit, forecast=forecast,
                                    config_cls=config_cls,
                                    forecast_quantiles=forecast_quantiles,
                                    supports_xreg=supports_xreg,
                                    band_floor=band_floor)


# families of the reference the port has not ported yet
UNPORTED_FAMILIES = frozenset({"arnet"})


def get_model(name: str) -> ModelFns:
    if name in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {name!r} is not ported yet (ROADMAP Queue 1: P8)")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def require_models(names) -> None:
    """Check every family of a pool before any work starts: an unported one
    raises ``NotImplementedError``, an unknown one ``KeyError``."""
    for name in names:
        get_model(name)
