"""The ARIMA family's hand-written CUDA kernels and their plain twins.

:func:`arima_filter` is the Kalman filter of every differenced, centered
series (and, for d = 1, the integration of its one-step predictions back to
the original scale); :func:`arima_predict` the predict-only recursion of the
forecast.  Both replace ``lax.scan`` loops of the reference's
``models/arima.py`` (no Pallas origin): in eager PyTorch a scan is a Python
loop of some twenty launches a step, so the kernels (``csrc/arima_kalman.cu``,
one thread a series; the note at its top gives the design and the bound)
take their place on the card.  :func:`arima_loglik_grad` is the MLE fit's
likelihood and its Jacobian with respect to the coefficients, in forward
mode, where the reference differentiates its scan in reverse;
:func:`arima_mle_fit` the whole MLE fit, every Adam step of it in one
launch (both ``csrc/arima_mle.cu``).

On a CUDA tensor each wrapper launches its kernel or raises (an r beyond the
kernels' limit raises ``ValueError``); on a CPU tensor it runs its plain twin
from ``models/arima`` (``_kalman_loglik_impl`` and ``_integrate``,
``_predict_path``, ``arima_loglik_grad_reference``,
``mle_fit_reference``).  The kernels are
bitwise equal to the twins on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from distributed_forecasting_tpu_torch.ops.fused_scan import (
    _check,
    _ptr,
    _raise_on,
    _record_work,
    _stream,
)
from distributed_forecasting_tpu_torch.ops.optim import (
    ADAM_B1,
    ADAM_B2,
    ADAM_EPS,
    bias_corrections,
)


class FilterOutputs(NamedTuple):
    """What :func:`arima_filter` returns; the last four only for d = 1."""

    ssq: torch.Tensor       # (S,) sum of squared standardized innovations
    ldet: torch.Tensor      # (S,) sum of log innovation variances
    n: torch.Tensor         # (S,) observed steps
    preds: torch.Tensor     # (S, T) one-step predictions of zc
    Fs: torch.Tensor        # (S, T) their variances (unit innovation scale)
    a_T: torch.Tensor       # (S, r) predictive state after the grid
    P_T: torch.Tensor       # (S, r, r) its covariance
    fitted: Optional[torch.Tensor] = None      # (S, T) original scale
    fitted_var: Optional[torch.Tensor] = None  # (S, T)
    level_end: Optional[torch.Tensor] = None   # (S,)
    var_end: Optional[torch.Tensor] = None     # (S,)


def arima_filter_work(S: int, T: int, r: int, d: int) -> tuple:
    """(float32 operations, bytes) of one :func:`arima_filter` launch: every
    step of every row — T P and T P T' 4 r^2, + R R' r^2, the gain r, T a
    2 r, the update 2 r + 3 r^2, the prediction, floor and innovation 2, the
    likelihood pieces 5 and the count 1 (selects not counted) — P0's 30
    Lyapunov iterations (5 r^2 each) and, for d = 1, the integration's 4 a
    step; bytes, each input read once (zc, zmask; y, mask for d = 1; the
    per-row coefficients and mean) and each output written once."""
    ops = S * (T * (8 * r * r + 5 * r + 8) + 30 * 5 * r * r)
    arrays_in, arrays_out = 2, 2
    if d == 1:
        ops += 4 * S * T
        arrays_in, arrays_out = 4, 4
    nbytes = 4 * (S * T * (arrays_in + arrays_out)
                  + S * (2 * r + 1) + S * (r + r * r + 3)
                  + (4 * S if d == 1 else 0))
    return ops, nbytes


def arima_predict_work(S: int, H: int, r: int) -> tuple:
    """(float32 operations, bytes) of one :func:`arima_predict` launch: T a
    2 r, T P T' + R R' 5 r^2 and the variance's scale 1 a step; the
    coefficients and the state read once, zf and vf written once."""
    return (S * H * (5 * r * r + 2 * r + 1),
            4 * (S * (2 * r + r * r + 1) + 2 * S * H))


def _check_order(p: int, q: int, r: int) -> None:
    if min(p, q) < 0 or r < max(p, q + 1, 1):
        raise ValueError(f"r={r} is below max(p={p}, q={q} + 1)")


def _coefficients(phi, theta, r: int):
    p, q = phi.shape[1], theta.shape[1]
    _check_order(p, q, r)
    return p, q


def first_observed(y, mask):
    """(S,) each row's first observed value (y at the first maximum of its
    mask, the reference's ``ys[argmax(ms)]``): the d = 1 integration's
    starting level."""
    return torch.gather(y, 1, torch.argmax(mask, dim=1, keepdim=True))[:, 0]


def arima_filter_reference(zc, zmask, y, mask, phi, theta, mean, r: int,
                           d: int) -> FilterOutputs:
    """The plain twin of :func:`arima_filter`: the sequential Kalman filter
    (``models/arima._kalman_loglik_impl``) and, for d = 1, the integration
    loop (``models/arima._integrate``)."""
    from distributed_forecasting_tpu_torch.models import arima

    out = FilterOutputs(*arima._kalman_loglik_impl(zc, zmask, phi, theta, r))
    if d != 1:
        return out
    sigma2 = out.ssq / torch.clamp_min(out.n, 1.0)
    return out._replace(**dict(zip(
        ("fitted", "fitted_var", "level_end", "var_end"),
        arima._integrate(y, mask, out.preds + mean[:, None], out.Fs, sigma2,
                         first_observed(y, mask)))))


def _arima_filter_launcher(zc, zmask, y, mask, phi, theta, mean, r: int,
                           d: int):
    """Check what the filter kernel assumes, allocate its outputs and bind
    its arguments: returns ``(launch, out)``, where ``launch()`` launches it
    on the stream that was PyTorch's current one when it was bound, raises
    on a refused launch and counts the launch on
    ``arima_filter.launches``."""
    from distributed_forecasting_tpu_torch.ops._build import library

    S, T = zc.shape
    p, q = _coefficients(phi, theta, r)
    dev = zc.device
    expected = {"zc": (zc, (S, T)), "zmask": (zmask, (S, T)),
                "phi": (phi, (S, p)), "theta": (theta, (S, q)),
                "mean": (mean, (S,))}
    if d == 1:
        expected.update(y=(y, (S, T)), mask=(mask, (S, T)))
    _check("arima_filter", dev, expected)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    out = FilterOutputs(new(S), new(S), new(S), new(S, T), new(S, T),
                        new(S, r), new(S, r, r))
    y_first = None
    if d == 1:
        out = out._replace(fitted=new(S, T), fitted_var=new(S, T),
                           level_end=new(S), var_end=new(S))
        y_first = first_observed(y, mask).contiguous()
    if S == 0:
        return (lambda: None), out
    lib = library()
    tensors = (zc, zmask, y if d == 1 else None, mask if d == 1 else None,
               phi, theta, mean, y_first, out.preds, out.Fs, out.a_T, out.P_T,
               out.ssq, out.ldet, out.n, out.fitted, out.fitted_var,
               out.level_end, out.var_end)
    args = [_ptr(x) if x is not None else None for x in tensors]
    args += [S, T, p, q, r, int(d), _stream(dev)]

    def launch():
        with torch.cuda.device(dev):
            err = lib.arima_filter_launch(*args)
        _raise_on("arima_filter", lib, err,
                  f"S={S}, T={T}, p={p}, q={q}, r={r}")
        arima_filter.launches += 1

    launch.tensors = tensors  # the bound pointers stay valid while launch lives
    return launch, out


def arima_filter(zc, zmask, y, mask, phi, theta, mean, r: int,
                 d: int) -> FilterOutputs:
    """Kalman-filter every row of the centered differenced series ``zc``
    (mask ``zmask``) under its ARMA coefficients; for d = 1 integrate the
    one-step predictions back onto ``y`` (mask ``mask``).

    zc, zmask, y, mask: (S, T); phi (S, p), theta (S, q); mean (S,); r the
    state dimension (>= max(p, q + 1)); d 0 or 1.  Returns
    :class:`FilterOutputs`.  CUDA tensors launch the kernel
    (``csrc/arima_kalman.cu``, bitwise equal to the twin) or raise; CPU
    tensors run the twin :func:`arima_filter_reference`.
    """
    if zc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"arima_filter runs on cuda or cpu, got {zc.device}")
    S, T = zc.shape
    _record_work("arima_filter", f"{S}x{T}:r{r}:d{d}",
                 lambda: arima_filter_work(S, T, r, d))
    if zc.device.type == "cpu":
        return arima_filter_reference(zc, zmask, y, mask, phi, theta, mean,
                                      r, d)
    launch, out = _arima_filter_launcher(zc, zmask, y, mask, phi, theta,
                                         mean, r, d)
    launch()
    return out


def arima_predict_reference(phi, theta, a0, P0, sigma2, r: int, H: int):
    """The plain twin of :func:`arima_predict`
    (``models/arima._predict_path``)."""
    from distributed_forecasting_tpu_torch.models import arima

    return arima._predict_path(phi, theta, a0, P0, sigma2, r, H)


def _arima_predict_launcher(phi, theta, a0, P0, sigma2, r: int, H: int):
    """Check, allocate and bind the forecast kernel: returns ``(launch, (zf,
    vf))`` as :func:`_arima_filter_launcher` does."""
    from distributed_forecasting_tpu_torch.ops._build import library

    S = a0.shape[0]
    p, q = _coefficients(phi, theta, r)
    dev = a0.device
    _check("arima_predict", dev, {
        "phi": (phi, (S, p)), "theta": (theta, (S, q)), "a0": (a0, (S, r)),
        "P0": (P0, (S, r, r)), "sigma2": (sigma2, (S,))})
    zf = torch.empty((S, H), dtype=torch.float32, device=dev)
    vf = torch.empty((S, H), dtype=torch.float32, device=dev)
    if S == 0 or H == 0:
        return (lambda: None), (zf, vf)
    lib = library()
    tensors = (phi, theta, a0, P0, sigma2, zf, vf)
    args = [*map(_ptr, tensors), S, H, p, q, r, _stream(dev)]

    def launch():
        with torch.cuda.device(dev):
            err = lib.arima_predict_launch(*args)
        _raise_on("arima_predict", lib, err,
                  f"S={S}, H={H}, p={p}, q={q}, r={r}")
        arima_predict.launches += 1

    launch.tensors = tensors
    return launch, (zf, vf)


def arima_predict(phi, theta, a0, P0, sigma2, r: int, H: int):
    """The predict-only recursion ``a <- T a``, ``P <- T P T' + R R'`` over
    H steps from the state (a0 (S, r), P0 (S, r, r)) after the fit grid.
    Returns ``(zf, vf)``, (S, H) each: the predicted first state component
    and its variance times sigma2 (S,).  CUDA tensors launch the kernel or
    raise; CPU tensors run the twin :func:`arima_predict_reference`."""
    if a0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"arima_predict runs on cuda or cpu, got {a0.device}")
    S = a0.shape[0]
    _record_work("arima_predict", f"{S}x{H}:r{r}",
                 lambda: arima_predict_work(S, H, r))
    if a0.device.type == "cpu":
        return arima_predict_reference(phi, theta, a0, P0, sigma2, r, H)
    launch, out = _arima_predict_launcher(phi, theta, a0, P0, sigma2, r, H)
    launch()
    return out


class LoglikGrad(NamedTuple):
    """What :func:`arima_loglik_grad` returns."""

    ssq: torch.Tensor    # (S,) sum of squared standardized innovations
    ldet: torch.Tensor   # (S,) sum of log innovation variances
    n: torch.Tensor      # (S,) observed steps
    dssq: torch.Tensor   # (S, p + q) d ssq / d (phi, theta)
    dldet: torch.Tensor  # (S, p + q) d ldet / d (phi, theta)


def arima_loglik_grad_work(S: int, T: int, r: int, k: int) -> tuple:
    """(float32 operations, bytes) of the least work of one
    :func:`arima_loglik_grad` call: the primal filter once a row (as
    :func:`arima_filter_work` counts it without the outputs: 8 r^2 + 5 r + 8
    a step, 5 r^2 an iteration of P0) and each of the k tangents (T dP, dT P
    and their sums 4 r^2, the same for d(T P T') 4 r^2, dRR' 3 r^2, the gain
    terms 8 r^2; dK 3 r, dT a + T da 4 r, the update 4 r; dF, dv and the two
    sums 12 a step; 11 r^2 an iteration of P0); zc and zmask read once, the
    coefficients read once, the three (S,) and two (S, k) outputs written
    once."""
    primal = S * (T * (8 * r * r + 5 * r + 8) + 30 * 5 * r * r)
    tangent = S * k * (T * (19 * r * r + 11 * r + 12) + 30 * 11 * r * r)
    return primal + tangent, 4 * (2 * S * T + S * k + 3 * S + 2 * S * k)


def arima_loglik_grad_reference(zc, zmask, phi, theta, r: int) -> LoglikGrad:
    """The plain twin of :func:`arima_loglik_grad`
    (``models/arima.arima_loglik_grad_reference``)."""
    from distributed_forecasting_tpu_torch.models import arima

    return LoglikGrad(*arima.arima_loglik_grad_reference(zc, zmask, phi,
                                                         theta, r))


def _arima_loglik_grad_launcher(zc, zmask, phi, theta, r: int):
    """Check, allocate and bind the likelihood-gradient kernel: returns
    ``(launch, out)`` as :func:`_arima_filter_launcher` does; ``launch()``
    counts on ``arima_loglik_grad.launches``."""
    from distributed_forecasting_tpu_torch.ops._build import library

    S, T = zc.shape
    p, q = _coefficients(phi, theta, r)
    dev = zc.device
    _check("arima_loglik_grad", dev, {
        "zc": (zc, (S, T)), "zmask": (zmask, (S, T)), "phi": (phi, (S, p)),
        "theta": (theta, (S, q))})
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    out = LoglikGrad(new(S), new(S), new(S), new(S, p + q), new(S, p + q))
    if S == 0:
        return (lambda: None), out
    lib = library()
    tensors = (zc, zmask, phi, theta, *out)
    args = [*map(_ptr, tensors), S, T, p, q, r, _stream(dev)]

    def launch():
        with torch.cuda.device(dev):
            err = lib.arima_loglik_grad_launch(*args)
        _raise_on("arima_loglik_grad", lib, err,
                  f"S={S}, T={T}, p={p}, q={q}, r={r}")
        arima_loglik_grad.launches += 1

    launch.tensors = tensors
    return launch, out


def arima_loglik_grad(zc, zmask, phi, theta, r: int) -> LoglikGrad:
    """The concentrated likelihood's pieces of every row of the centered
    differenced series ``zc`` (mask ``zmask``) under its ARMA coefficients,
    and their Jacobians with respect to the coefficients.

    zc, zmask: (S, T); phi (S, p), theta (S, q); r the state dimension
    (>= max(p, q + 1)).  Returns :class:`LoglikGrad`; its ssq, ldet and n
    are :func:`arima_filter`'s.  CUDA tensors launch the kernel
    (``csrc/arima_mle.cu``, bitwise equal to the twin) or raise; CPU tensors
    run the twin :func:`arima_loglik_grad_reference`.
    """
    p, q = _coefficients(phi, theta, r)
    if zc.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"arima_loglik_grad runs on cuda or cpu, got {zc.device}")
    S, T = zc.shape
    _record_work("arima_loglik_grad", f"{S}x{T}:r{r}:k{p + q}",
                 lambda: arima_loglik_grad_work(S, T, r, p + q))
    if zc.device.type == "cpu":
        return arima_loglik_grad_reference(zc, zmask, phi, theta, r)
    launch, out = _arima_loglik_grad_launcher(zc, zmask, phi, theta, r)
    launch()
    return out


def mle_fit_work(S: int, T: int, r: int, p: int, q: int,
                 steps: int) -> tuple:
    """(float32 operations, bytes) of the least work of one
    :func:`arima_mle_fit` call: ``steps`` evaluations as
    :func:`arima_loglik_grad_work` counts one, and each step's map and
    update a row — tanh and its derivative 4 k, the Durbin-Levinson
    recursion 2 m (m - 1) for m = p, q and its tangents 4 m (m - 1) a
    direction along that polynomial, the gradient 8 k and Adam 11 k; zc and
    zmask read once, the bias corrections read once, u written once."""
    k = p + q
    ops, _ = arima_loglik_grad_work(S, T, r, k)
    dl = sum(2 * m * (m - 1) + 4 * m * m * (m - 1) for m in (p, q))
    ops = steps * (ops + S * (4 * k + dl + 19 * k))
    return ops, 4 * (2 * S * T + 2 * steps + S * k)


def adam_bias_table(steps: int) -> torch.Tensor:
    """(steps, 2) float32: the bias corrections of Adam's steps 1..steps,
    each computed as ``ops/optim.adam`` computes it."""
    return torch.tensor([bias_corrections(c, ADAM_B1, ADAM_B2)
                         for c in range(1, steps + 1)],
                        dtype=torch.float32).reshape(steps, 2)


def _check_fit(p: int, q: int, r: int, steps: int) -> None:
    _check_order(p, q, r)
    if steps < 0:
        raise ValueError(f"arima_mle_fit: steps must be >= 0, got {steps}")


def mle_fit_reference(zc, zmask, p: int, q: int, r: int, steps: int,
                      learning_rate: float, prior_scale: float):
    """The plain twin of :func:`arima_mle_fit`
    (``models/arima.mle_fit_reference``)."""
    from distributed_forecasting_tpu_torch.models import arima

    return arima.mle_fit_reference(zc, zmask, p, q, r, steps, learning_rate,
                                   prior_scale)


def _mle_fit_launcher(zc, zmask, p: int, q: int, r: int, steps: int,
                      learning_rate: float, prior_scale: float):
    """Check, allocate and bind the fit kernel: returns ``(launch, u)`` as
    :func:`_arima_filter_launcher` does; ``launch()`` counts on
    ``arima_mle_fit.launches``.  With no coordinate or no step there is
    nothing to launch: u stays 0."""
    from distributed_forecasting_tpu_torch.ops._build import library

    S, T = zc.shape
    k = p + q
    _check_fit(p, q, r, steps)
    dev = zc.device
    _check("arima_mle_fit", dev, {"zc": (zc, (S, T)),
                                  "zmask": (zmask, (S, T))})
    u = torch.zeros((S, k), dtype=torch.float32, device=dev)
    if S == 0 or k == 0 or steps == 0:
        return (lambda: None), u
    lib = library()
    # pinned, so the copy to the card does not wait for the host
    bc = adam_bias_table(steps).pin_memory().to(dev, non_blocking=True)
    tensors = (zc, zmask, bc, u)
    scalars = [ADAM_B1, 1.0 - ADAM_B1, ADAM_B2, 1.0 - ADAM_B2,
               -learning_rate, ADAM_EPS, 1.0 / (prior_scale * prior_scale)]
    args = [*map(_ptr, tensors), S, T, p, q, r, steps, *scalars,
            _stream(dev)]

    def launch():
        with torch.cuda.device(dev):
            err = lib.arima_mle_fit_launch(*args)
        _raise_on("arima_mle_fit", lib, err,
                  f"S={S}, T={T}, p={p}, q={q}, r={r}, steps={steps}")
        arima_mle_fit.launches += 1

    launch.tensors = tensors
    return launch, u


def arima_mle_fit(zc, zmask, p: int, q: int, r: int, steps: int,
                  learning_rate: float, prior_scale: float) -> torch.Tensor:
    """The MLE fit of every row of the centered differenced series ``zc``
    (mask ``zmask``, (S, T)): ``steps`` steps of Adam (``ops/optim.adam``
    at ``learning_rate``) from u = 0 on the unconstrained PACF parameters u
    (S, p + q) of the ARMA(p, q) coefficients, minimizing the concentrated
    Gaussian NLL plus a Gaussian prior of scale ``prior_scale`` on u; r the
    state dimension (>= max(p, q + 1)).  Returns u after the last step.

    CUDA tensors run the whole fit in one launch of the kernel
    (``csrc/arima_mle.cu``, bitwise equal to the twin on the card) or
    raise; CPU tensors run the twin :func:`mle_fit_reference`.
    """
    _check_fit(p, q, r, steps)
    if zc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"arima_mle_fit runs on cuda or cpu, got {zc.device}")
    S, T = zc.shape
    _record_work("arima_mle_fit", f"{S}x{T}:r{r}:p{p}:q{q}:steps{steps}",
                 lambda: mle_fit_work(S, T, r, p, q, steps))
    if zc.device.type == "cpu":
        return mle_fit_reference(zc, zmask, p, q, r, steps, learning_rate,
                                 prior_scale)
    launch, u = _mle_fit_launcher(zc, zmask, p, q, r, steps, learning_rate,
                                  prior_scale)
    launch()
    return u


# launches of each CUDA kernel in this process (the CPU twins never count)
arima_filter.launches = 0
arima_predict.launches = 0
arima_loglik_grad.launches = 0
arima_mle_fit.launches = 0
