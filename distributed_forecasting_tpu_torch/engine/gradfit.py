"""Batched gradient training: one optimizer step for ALL series (port of
the reference's ``engine/gradfit.py``).

The AR-Net family (``models/arnet.py``) has no closed form: it is fit by
minibatch gradient descent, and the batch-shaped way to do that is one
optimizer step advancing all S series at once over one minibatch:

* the forward model is ``z_t ~ w·[z_{t-1} .. z_{t-L}] + beta·x_t + b``
  with per-series weights ``w``, ``beta``, ``b``;
* the loss is a SUM over series of each series' masked minibatch mean, so
  series never couple through the loss and a padded bucket row (mask all
  zero) sheds exactly zero gradient;
* the optimizer is ``torch.optim`` (adam / sgd / momentum 0.9,
  :func:`make_optimizer`), updating the weights in place; the gradient is
  autograd's over the plain forward function.

The trainer keeps the series axis LAST: weights ``w`` (L, S), ``beta``
(R, S), ``b`` (S,), minibatches ``(L, B, S)``.  Every sum of the step,
forward and backward, is ``models/base.sum_leading`` over a leading axis
(:class:`_LeadingContraction` gives the contractions and the bias a
backward that is too), which adds each series' terms in one order whatever
S is — where a GEMM, or autograd's own reductions, pick their order by the
row count.  So a series trains to the same bits alone, beside others, or
inside a padded bucket.  Callers see the reference's (S, L) layout.

Two training paths share every numeric ingredient (the schedule, the
gather, the step):

* :func:`train_scan` — a loop over the schedule on tensors already on the
  device, used by ``models/arnet.fit`` so the family runs unchanged under
  ``fit_forecast``, the CV's stacked cutoffs, the pools and the pipeline;
* :func:`gradfit_fit_forecast` — the engine path ``fit_forecast`` routes
  to when the ``engine.gradfit`` conf block is armed: the series axis
  padded to the ``series_bucket`` ladder, minibatches assembled on the
  host and copied ``prefetch_depth`` steps ahead from pinned memory
  (``engine/executor.prefetch_to_device``), each step through
  ``engine/compile_cache.aot_call`` (entry ``gradfit_step:arnet``), the
  loop's interval charged to the cost registry after the sanctioned
  pull, then the same finalize and forecast as the family
  (``gradfit_finalize:arnet``).

The schedule comes from a ``torch.Generator`` seeded with
``config.seed`` (``utils/rng.py``: the random-number decision), and every
trainer takes it as an argument too, which is how the tests hand the
reference's schedule to the port.  ``donate`` has no effect: torch's
optimizer updates the weights in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from distributed_forecasting_tpu_torch.models.base import sum_leading
from distributed_forecasting_tpu_torch.utils.rng import make_generator


# -- conf block --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradFitConfig:
    """The strict ``engine.gradfit`` conf block (tasks/common.py).

    ``enabled`` arms the engine path in ``engine.fit_forecast``: an arnet
    fit routes through :func:`gradfit_fit_forecast` instead of the family's
    own :func:`train_scan`.  CV keeps the family's trainer regardless.
    """

    enabled: bool = False
    #: series rows are padded up to ``series_bucket * 2^k``
    series_bucket: int = 64
    #: minibatches copied to the device this many steps ahead (0 = none)
    prefetch_depth: int = 2
    #: the reference donates the weights and optimizer state into each
    #: step; ``torch.optim`` updates them in place either way
    donate: bool = True

    def __post_init__(self):
        if self.series_bucket < 1:
            raise ValueError(
                f"series_bucket must be >= 1, got {self.series_bucket}")
        if self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0, got {self.prefetch_depth}")

    @classmethod
    def from_conf(cls, conf: Optional[dict]) -> "GradFitConfig":
        conf = conf or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(conf) - known
        if unknown:
            # a typo like series_bucet must not silently fall back
            raise ValueError(
                f"unknown engine.gradfit conf key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        kwargs = {
            f.name: type(f.default)(conf[f.name])
            for f in dataclasses.fields(cls)
            if f.name in conf and conf[f.name] is not None
        }
        return cls(**kwargs)


_active_config = GradFitConfig()


def configure_gradfit(conf) -> GradFitConfig:
    """Install the process-wide gradfit config (tasks/common parses the
    ``engine.gradfit`` conf block into this)."""
    global _active_config
    cfg = conf if isinstance(conf, GradFitConfig) \
        else GradFitConfig.from_conf(conf)
    _active_config = cfg
    return cfg


def gradfit_config() -> GradFitConfig:
    return _active_config


def series_bucket(n_series: int, base: int) -> int:
    """The smallest ``base * 2^k >= n_series``."""
    b = max(int(base), 1)
    while b < int(n_series):
        b *= 2
    return b


# -- optimizer ---------------------------------------------------------------

def make_optimizer(config, params) -> torch.optim.Optimizer:
    """``torch.optim`` optimizer for ``config.optimizer`` over ``params``:
    ``adam`` (betas 0.9 / 0.999, eps 1e-8, as optax's), ``sgd``, or
    ``momentum`` (SGD with momentum 0.9, optax's ``trace``)."""
    name = config.optimizer
    lr = config.learning_rate
    if name == "adam":
        return torch.optim.Adam(params, lr=lr)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if name == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    raise ValueError(
        f"unknown ArnetConfig.optimizer {name!r}; "
        f"'adam' | 'sgd' | 'momentum'")


# -- shared numeric core -----------------------------------------------------

def init_weights(n_series: int, lags: int, n_reg: int,
                 device=None) -> dict:
    """Zero weights in the trainer's layout, ``w`` (L, S), ``beta`` (R, S),
    ``b`` (S,): the model starts at 'predict the (standardized) mean',
    which is also what a fully masked padding row trains to."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device,
                           requires_grad=True)

    return {"w": zeros(lags, n_series), "beta": zeros(n_reg, n_series),
            "b": zeros(n_series)}


class _LeadingContraction(torch.autograd.Function):
    """``sum_k coef[k, s] x[k, b, s]`` -> (B, S), with the gradient of
    ``coef`` summed over b as the leading axis of ``x_t`` (x laid out
    (B, K, S)): both passes sum with ``sum_leading``."""

    @staticmethod
    def forward(ctx, coef, x, x_t):
        ctx.save_for_backward(x_t)
        return sum_leading(coef[:, None, :] * x)

    @staticmethod
    def backward(ctx, g):
        (x_t,) = ctx.saved_tensors
        return sum_leading(g[:, None, :] * x_t), None, None


def predict_minibatch(wp: dict, lagb, xb):
    """Forward AR + regressor head over one minibatch, in the trainer's
    layout: ``lagb`` the pair ((L, B, S), (B, L, S)) of lagged standardized
    targets (lag 1 first), ``xb`` the pair ((R, B, 1), (B, R, 1)) of shared
    or ((R, B, S), (B, R, S)) of per-series standardized regressors.
    Returns (B, S) predictions in standardized space."""
    # the bias as a contraction over a one-term axis that already has the
    # minibatch's shape: broadcast into (B, S), autograd would sum its
    # gradient over B its own way
    B = lagb[0].shape[1]
    pred = (_LeadingContraction.apply(wp["w"], *lagb)
            + _LeadingContraction.apply(wp["b"][None, :],
                                        lagb[0].new_ones((1, B, 1)),
                                        lagb[0].new_ones((B, 1, 1))))
    if xb[0].shape[0]:
        pred = pred + _LeadingContraction.apply(wp["beta"], *xb)
    return pred


def loss_fn(wp: dict, zb, lagb, xb, vb, config):
    """SUM over series of each series' masked minibatch mean loss (huber or
    mse); ``zb``, ``vb``: (B, S).  Summing over series keeps each series'
    gradient independent of the rows beside it."""
    err = predict_minibatch(wp, lagb, xb) - zb
    if config.loss == "huber":
        d = config.huber_delta
        ae = torch.abs(err)
        per = torch.where(ae <= d, 0.5 * err * err, d * (ae - 0.5 * d))
    elif config.loss == "mse":
        per = 0.5 * err * err
    else:
        raise ValueError(
            f"unknown ArnetConfig.loss {config.loss!r}; 'huber' | 'mse'")
    per_series = sum_leading(per * vb) / torch.clamp_min(sum_leading(vb), 1.0)
    return per_series.sum()


def train_step(wp: dict, opt: torch.optim.Optimizer, zb, lagb, xb, vb,
               config):
    """One optimizer step, the body both training paths run; updates
    ``wp`` in place and returns the loss (a 0-d tensor, no host sync)."""
    opt.zero_grad()
    loss = loss_fn(wp, zb, lagb, xb, vb, config)
    loss.backward()
    opt.step()
    return loss.detach()


def minibatch_schedule(generator: torch.Generator, n_time: int,
                       batch_size: int, epochs: int) -> torch.Tensor:
    """The epoch schedule, (steps, B) int64 time positions on the
    generator's device: each epoch an independent permutation of the grid
    (one ``torch.randperm`` from ``generator``), cut into ``floor(T/B)``
    full batches; a remainder under B is dropped, so every step has one
    shape.  Both training paths take their schedule from here."""
    B = min(batch_size, n_time)
    nb = max(n_time // B, 1)
    perms = [torch.randperm(n_time, generator=generator,
                            device=generator.device)[: nb * B]
             for _ in range(max(epochs, 1))]
    return torch.stack(perms).reshape(-1, B)


def default_schedule(config, n_time: int, device) -> torch.Tensor:
    """The schedule of a fit with no schedule given: a generator on
    ``device`` seeded with ``config.seed`` (the reference's
    ``PRNGKey(config.seed)``)."""
    return minibatch_schedule(make_generator(device, config.seed), n_time,
                              config.batch_size, config.epochs)


def trainer_layout(z, xz, valid, lags: int) -> tuple:
    """The standardized tensors in the trainer's layout, time leading and
    series last: ``(zp, zt, vt, xt)`` with ``zp`` (L + T, S) the targets
    front-padded with L zeros, ``zt`` / ``vt`` (T, S), ``xt`` (T, R, 1)
    shared or (T, R, S) per-series regressors."""
    zt = z.t().contiguous()
    zp = torch.cat([zt.new_zeros((lags, zt.shape[1])), zt])
    vt = valid.t().contiguous()
    xt = (xz[:, :, None] if xz.dim() == 2 else xz.permute(1, 2, 0))
    return zp, zt, vt, xt.contiguous()


def gather_minibatch(zp, zt, vt, xt, idx, lags: int) -> tuple:
    """One minibatch ``(zb, lagb, xb, vb)`` out of the trainer-layout
    tensors (:func:`trainer_layout`); ``idx``: (B,) time positions;
    ``lagb`` and ``xb`` are the pairs :func:`predict_minibatch` takes.
    Lag features read the front-padded copy, so positions with
    ``t < lags`` read zeros (their ``valid`` weight is 0 anyway)."""
    offs = lags - 1 - torch.arange(lags, device=idx.device)
    lagb = (zp[idx[None, :] + offs[:, None]],                    # (L, B, S)
            zp[idx[:, None] + offs[None, :]])                    # (B, L, S)
    xb_t = xt[idx]                                               # (B, R, .)
    return zt[idx], lagb, (xb_t.transpose(0, 1).contiguous(), xb_t), vt[idx]


def _reference_layout(wp: dict) -> dict:
    """Trainer weights -> the reference's (S, L) / (S, R) / (S,) layout."""
    return {"w": wp["w"].detach().t().contiguous(),
            "beta": wp["beta"].detach().t().contiguous(),
            "b": wp["b"].detach().clone()}


def train_scan(z, xz, valid, config, schedule=None) -> Tuple[dict, torch.Tensor]:
    """The family's trainer: a loop of :func:`train_step` over the schedule
    on tensors already on the device.  ``z``, ``valid``: (S, T); ``xz``:
    (T, R) or (S, T, R).  ``schedule``: (steps, B) time positions, by
    default :func:`default_schedule`.  Returns the weights in the
    reference's layout and the per-step losses."""
    S, T = z.shape
    if schedule is None:
        schedule = default_schedule(config, T, z.device)
    schedule = torch.as_tensor(schedule, dtype=torch.int64, device=z.device)
    zp, zt, vt, xt = trainer_layout(z, xz, valid, config.lags)
    wp = init_weights(S, config.lags, xz.shape[-1], z.device)
    opt = make_optimizer(config, list(wp.values()))
    losses = []
    for idx in schedule:
        zb, lagb, xb, vb = gather_minibatch(zp, zt, vt, xt, idx, config.lags)
        losses.append(train_step(wp, opt, zb, lagb, xb, vb, config))
    return _reference_layout(wp), torch.stack(losses)


# -- the engine path ----------------------------------------------------------

def _host_batches(zp, zt, vt, xt, schedule: np.ndarray, lags: int
                  ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Minibatches assembled on the host (numpy gathers of the
    trainer-layout arrays), the same values as :func:`gather_minibatch`."""
    offs = lags - 1 - np.arange(lags)
    for idx in schedule:
        xb_t = xt[idx]
        yield (zt[idx], zp[idx[None, :] + offs[:, None]],
               zp[idx[:, None] + offs[None, :]], xb_t.transpose(1, 0, 2),
               xb_t, vt[idx])


def host_train(y, mask, day, config, xreg_hist=None,
               gcfg: Optional[GradFitConfig] = None, schedule=None) -> dict:
    """The engine path's epoch loop.  Pads the series axis to the
    ``series_bucket`` ladder (padded rows train to zero and are sliced
    off), assembles the minibatches on the host from the schedule (by
    default :func:`default_schedule` on the batch's device, brought to the
    host once), copies them ahead (``engine/executor.prefetch_to_device``)
    and advances all series with one :func:`train_step` each (the
    ``gradfit_step:arnet`` entry); the loop's interval, through the
    sanctioned pull, is charged to the cost registry.  Returns the
    (S,)-row weights in the reference's layout."""
    from distributed_forecasting_tpu_torch.engine.compile_cache import (
        aot_call,
    )
    from distributed_forecasting_tpu_torch.engine.executor import (
        device_pull,
        prefetch_to_device,
    )
    from distributed_forecasting_tpu_torch.models import arnet
    from distributed_forecasting_tpu_torch.monitoring.cost import (
        cost_metrics,
    )

    gcfg = gcfg if gcfg is not None else _active_config
    dev = y.device
    S, T = int(y.shape[0]), int(y.shape[1])
    pad = series_bucket(S, gcfg.series_bucket) - S
    y_b = torch.cat([y.to(torch.float32), y.new_zeros((pad, T))])
    m_b = torch.cat([mask.to(torch.float32), mask.new_zeros((pad, T))])
    xreg_b = xreg_hist
    if xreg_hist is not None and xreg_hist.dim() == 3:
        xreg_b = torch.cat([xreg_hist, xreg_hist.new_zeros(
            (pad,) + tuple(xreg_hist.shape[1:]))])
    z, _mu, _sd, xz, valid, _xmu, _xsd = arnet.prep_training(
        y_b, m_b, config, xreg=xreg_b)
    if schedule is None:
        schedule = default_schedule(config, T, dev)
    schedule = torch.as_tensor(schedule).cpu().numpy().astype(np.int64)
    host = [a.cpu().numpy() for a in trainer_layout(z, xz, valid, config.lags)]

    wp = init_weights(S + pad, config.lags, xz.shape[-1], dev)
    opt = make_optimizer(config, list(wp.values()))
    t0 = time.perf_counter()
    batches = _host_batches(*host, schedule, config.lags)
    for zb, lag, lag_t, xb, xb_t, vb in prefetch_to_device(
            batches, depth=gcfg.prefetch_depth, device=dev):
        aot_call("gradfit_step:arnet", train_step,
                 args=(wp, opt, zb, (lag, lag_t), (xb, xb_t), vb),
                 static_kwargs=dict(config=config))
    done = None
    if dev.type == "cuda":
        done = torch.cuda.Event()
        done.record()
    device_pull(done)
    cost_metrics().record_dispatch("gradfit_step:arnet", "arnet",
                                   time.perf_counter() - t0)
    out = _reference_layout(wp)
    return {k: v[:S] for k, v in out.items()}


def gradfit_fit_forecast(batch, config=None, horizon: int = 90,
                         min_points: int = 14, xreg=None,
                         gcfg: Optional[GradFitConfig] = None,
                         schedule=None):
    """The path ``fit_forecast`` routes arnet fits through when the
    ``engine.gradfit`` block is armed: :func:`host_train`, then the
    family's own finalize (``arnet.params_from_weights``), forecast and the
    fail-safe.  ``xreg`` covers history + horizon, as for
    ``fit_forecast``.  Returns ``(params, ForecastResult)``."""
    from distributed_forecasting_tpu_torch.engine.compile_cache import (
        aot_call,
    )
    from distributed_forecasting_tpu_torch.engine.fit import ForecastResult
    from distributed_forecasting_tpu_torch.models import arnet

    config = config if config is not None else arnet.ArnetConfig()
    y, mask, day = batch.y, batch.mask, batch.day
    T = batch.n_time
    xreg_hist = None
    if xreg is not None:
        xreg = xreg.to(y.device)
        xreg_hist = xreg[:T] if xreg.dim() == 2 else xreg[:, :T]
    wp = host_train(y, mask, day, config, xreg_hist=xreg_hist, gcfg=gcfg,
                    schedule=schedule)
    params, yhat, lo, hi, ok, day_all = aot_call(
        "gradfit_finalize:arnet", _finalize_impl,
        args=(y, mask, day, wp["w"], wp["beta"], wp["b"]),
        static_kwargs=dict(config=config, horizon=horizon,
                           min_points=min_points),
        dynamic_kwargs=dict(xreg=xreg))
    return params, ForecastResult(yhat=yhat, lo=lo, hi=hi, ok=ok,
                                  day_all=day_all)


def _finalize_impl(y, mask, day, w, beta, b, config, horizon, min_points,
                   xreg=None):
    """The post-training tail: the family's finalize
    (``arnet.params_from_weights``), its forecast and the fail-safe —
    ``(params, yhat, lo, hi, ok, day_all)``."""
    from distributed_forecasting_tpu_torch.engine.fit import (
        day_grid,
        health_fallback,
    )
    from distributed_forecasting_tpu_torch.models import arnet

    T = y.shape[1]
    xreg_hist = None
    if xreg is not None:
        xreg_hist = xreg[:T] if xreg.dim() == 2 else xreg[:, :T]
    params = arnet.params_from_weights(y, mask, day, config, w, beta, b,
                                       xreg=xreg_hist)
    day_all = day_grid(day, horizon)
    yhat, lo, hi = arnet.forecast(params, day_all, day[-1].to(torch.float32),
                                  config, xreg=xreg)
    yhat, lo, hi, ok = health_fallback(y, mask, yhat, lo, hi, horizon,
                                       min_points)
    return params, yhat, lo, hi, ok, day_all
