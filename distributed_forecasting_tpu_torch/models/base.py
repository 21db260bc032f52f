"""Model protocol + registry (port of the reference's ``models/base.py``).

Every model family exposes the same two functions over a *batch* of series:

    fit(y, mask, day, config)               -> params (frozen dataclass of
                                               tensors; leaves lead with the
                                               series axis S)
    forecast(params, day_all, t_end, config) -> (yhat, lo, hi), each
                                               (S, len(day_all))

``day_all`` covers history + horizon; ``t_end`` is the last *training* day
(a scalar, or one per series), where forecast uncertainty starts.  Families
registered with ``supports_xreg`` (the curve model, arnet) also take
``xreg=`` exogenous regressor values in ``fit`` and ``forecast``.  A family
registered with ``draws`` (the curve model, whose Monte-Carlo intervals
sample paths) takes ``generator=`` (a ``torch.Generator``) in ``forecast``
and ``forecast_quantiles``, where the reference's take a key; arnet's fit
draws its minibatch schedule from ``config.seed`` (``utils/rng.py``).  The
state-space families (holt_winters, theta, croston) register the streaming
``update_state`` / ``init_update_aux`` pair (see :class:`ModelFns`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
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


# a sum of fewer terms than this over a non-innermost axis runs in order,
# one thread an output, whatever PyTorch's CUDA reduction picks for its
# block shape; from this length on it may split the terms across warps
_SERIAL_TERMS = 64


def sum_leading(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(0)`` for a tensor laid out with the series axis LAST, with
    each output's terms added in an order that does not depend on the
    number of series.

    On the card PyTorch's reduction over a leading axis adds each output's
    terms in order in one thread while there are fewer than 64 of them;
    from 64 on it may split them across warps, by a block shape it picks
    from the number of outputs.  So a longer axis is summed in blocks of 32
    (each in order), then the block sums.  The CPU's vectorized reduction
    over a leading axis changes its blocking with the size of the trailing
    axes, so there the series axis goes first and each series' block is
    summed alike.  A lone series is summed beside a copy of itself (a
    size-1 axis would be squeezed away, turning the sum into another
    kind)."""
    if x.shape[-1] == 1:
        return sum_leading(x.expand(*x.shape[:-1], 2))[..., :1]
    if x.device.type != "cuda":
        return x.movedim(-1, 0).contiguous().sum(1).movedim(0, -1)
    x = x.contiguous()
    n = x.shape[0]
    if n < _SERIAL_TERMS:
        return x.sum(0)
    k = n // 32
    out = sum_leading(x[:k * 32].reshape(k, 32, *x.shape[1:]).sum(1))
    return out if n % 32 == 0 else out + x[k * 32:].sum(0)


# elements of the (rows, F, T) product one chunk of design_product holds
_PRODUCT_CHUNK = 1 << 24


def design_product(beta, X):
    """``beta @ X.T``, (S, F) x (T, F) -> (S, T), with every entry a sum of
    its F products in the same order whatever S.  One GEMM lets the library
    pick its algorithm by S, so a series' path would change with the rows
    computed beside it (the serving coalescer needs it not to,
    ``BatchForecaster.coalesce_safe``); an elementwise product reduced over
    its feature axis sums each entry alike.  The product is laid out
    (rows, F, T), so the reduction reads along T, and rows go in chunks
    that keep it under ``_PRODUCT_CHUNK`` elements."""
    XT = X.t().contiguous()
    step = max(1, _PRODUCT_CHUNK // max(XT.numel(), 1))
    parts = [(beta[i:i + step, :, None] * XT[None]).sum(1)
             for i in range(0, beta.shape[0], step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def t_end_rows(t_end, device) -> torch.Tensor:
    """A scalar or per-row forecast start as a (1, 1) or (S, 1) column."""
    return torch.as_tensor(t_end, dtype=torch.float32, device=device).reshape(-1, 1)


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
    # the forecast draws random numbers and takes ``generator=``
    draws: bool = False
    # the fit takes statistics over all rows of a call (arnet standardizes
    # per-series regressors so) and takes ``groups=``, the number of equal
    # blocks of rows that must each keep their own: the CV's stacked
    # cutoffs pass one block a cutoff
    per_block_stats: bool = False
    # the streaming update (serving/ingest):
    #   update_state(params, aux, y_new, mask_new, valid, day_new, config,
    #                day0=None) -> (params', aux', preds)
    # continues the family's filter over K appended day-columns with the
    # step function its fit runs, so a streamed state is the fit's bit for
    # bit.  y_new / mask_new: (S, K) on the params' device; valid / day_new:
    # (K,) on the host (1 for a real appended day, 0 for padding, which is
    # skipped; absolute day ordinals); day0: the first training day as a
    # host int (None reads params.day0).  preds: (S, K) one-step-ahead
    # fitted values of the new columns (0 in padding columns).
    # ``params'.fitted`` is the caller's: the state store splices preds in.
    update_state: Callable = None
    # init_update_aux(params, y=None, mask=None) -> dict of the carries the
    # fit does not keep in params (sse / n_obs for sigma, croston's q, TSB's
    # b); exact with the training (y, mask), approximate without
    init_update_aux: Callable = None


def streamed_columns(valid, day_new) -> tuple:
    """``(columns, days)`` of an update's real appended columns, in order:
    the indices where the host array ``valid`` is positive and their day
    ordinals from ``day_new``, as Python ints.  Padding columns (valid 0)
    are left out: a family's update skips them, which leaves its carry
    unchanged, as the reference's gating does."""
    valid = np.asarray(valid)
    cols = np.flatnonzero(valid > 0)
    days = np.asarray(day_new).astype(np.int64)[cols]
    return cols.tolist(), days.tolist()


def first_day(params, day0=None) -> int:
    """The first training day as a host int: ``day0`` when the caller has
    it (the state store does, so an apply reads nothing back from the
    card), else ``params.day0``."""
    return int(day0) if day0 is not None else int(float(params.day0))


def advance_t_fit_end(t_fit_end, days):
    """``max(t_fit_end, days)`` as the new 0-d ``t_fit_end`` tensor; the
    days are host ints, so no value is read back from the card."""
    return t_fit_end.clamp_min(float(max(days))) if days else t_fit_end


def register_model(name: str, fit: Callable, forecast: Callable,
                   config_cls: type, forecast_quantiles: Callable = None,
                   supports_xreg: bool = False,
                   band_floor: Optional[float] = None, draws: bool = False,
                   per_block_stats: bool = False,
                   update_state: Callable = None,
                   init_update_aux: Callable = None):
    MODEL_REGISTRY[name] = ModelFns(fit=fit, forecast=forecast,
                                    config_cls=config_cls,
                                    forecast_quantiles=forecast_quantiles,
                                    supports_xreg=supports_xreg,
                                    band_floor=band_floor, draws=draws,
                                    per_block_stats=per_block_stats,
                                    update_state=update_state,
                                    init_update_aux=init_update_aux)


def generator_kwargs(fns: ModelFns, generator) -> dict:
    """``{"generator": generator}`` for a family whose forecast draws, when
    a generator is given; else nothing (the family seeds its own)."""
    return {"generator": generator} if fns.draws and generator is not None \
        else {}


def get_model(name: str) -> ModelFns:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def require_models(names) -> None:
    """Check every family of a pool before any work starts: an unknown one
    raises ``KeyError``."""
    for name in names:
        get_model(name)
