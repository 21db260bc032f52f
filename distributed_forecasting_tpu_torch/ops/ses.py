"""The croston and theta recurrences' hand-written CUDA kernels, their plain
twins and their work counts.

:func:`croston_filter` runs Croston's, SBA's or TSB's recursion over a
time-major (T, S) grid from given carries: the fit and every CV pass of
``models/croston.fit`` and the streaming ``update_state``.  It replaces the
reference's ``lax.scan`` of ``models/croston.py`` (no Pallas origin).
:func:`ses_filter` runs the masked SES of every (row, alpha) lane: theta's
fit (``models/theta.ses_paths``, the whole alpha grid in one launch) and its
streaming update (one alpha a row, with the fitted values and the running
squared error).  It replaces the reference's ``_ses_path`` scan and the
update's.

Both kernels (``csrc/ses.cu``) are bitwise equal to their twins,
:func:`croston_filter_reference` and :func:`ses_filter_reference`: the
Python loops of :func:`_croston_step`, :func:`_tsb_step` and
:func:`_ses_step`, one step a handful of elementwise launches.  A streamed
state continues the fit's bit for bit because both run the same step.

On a CUDA tensor each wrapper launches its kernel or raises (a refused
launch raises through :func:`ops.fused_scan._raise_on`); on a CPU tensor it
runs the twin.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from distributed_forecasting_tpu_torch.ops.fused_scan import (
    _check,
    _ptr,
    _raise_on,
    _record_work,
    _stream,
)

_EPS = 1e-6
VARIANTS = ("croston", "sba", "tsb")

# float32 operations of one step (selects and compares not counted, as for
# hw_filter): croston's rate (a division), the interval count, the two
# smoothing updates (alpha * y, (1 - alpha) * z, their sum; alpha * q,
# (1 - alpha) * p, their sum) and the restart q * keep; SBA's bias factor
# one more; TSB's rate z * b, the probability update (beta term, (1 -
# beta) * b, their sum) and the size update
CROSTON_OPS_STEP = {"croston": 9, "sba": 10, "tsb": 6}
# the squared-error sums of the streaming update: y - rate, times the mask,
# squared, added, and the count
SUMS_OPS_STEP = 5
# theta's SES step: alpha * z, (1 - alpha) * level and the add
SES_OPS_STEP = 3
# the scored form's step: the fitted value (two products, a sum, times the
# seasonal index) and the error sums as above
SCORED_OPS_STEP = 4 + SUMS_OPS_STEP


def _croston_step(z, p, q, ay, mt, demand, keep, alpha: float,
                  variant: str, out):
    """One Croston / SBA step on (S,) lanes: writes the one-step rate into
    ``out`` and returns ``(z', p', q')``.  ``ay`` is ``alpha * y``,
    ``demand`` the step's demand flag, ``keep`` 0 at a demand and 1 else
    (``q * keep`` restarts the interval count as ``where(demand, 0, q)``
    does, exactly: q is a finite count)."""
    if variant == "sba":
        rate = z / torch.clamp_min(p, 1.0)
        torch.mul(rate, 1.0 - alpha / 2.0, out=out)
    else:
        torch.div(z, torch.clamp_min(p, 1.0), out=out)
    q_new = q + mt  # observed periods since the last demand
    z = torch.where(demand, ay + (1 - alpha) * z, z)
    p = torch.where(demand, alpha * q_new + (1 - alpha) * p, p)
    return z, p, q_new * keep


def _tsb_step(z, b, ay, b_in, observed, demand, alpha: float, beta: float,
              out):
    """One TSB step on (S,) lanes: writes the one-step rate ``z * b`` into
    ``out`` and returns ``(z', b')``.  The probability moves every observed
    period (``b_in`` is ``beta * 1[demand]``), the size only at demands."""
    torch.mul(z, b, out=out)
    b = torch.where(observed, b_in + (1 - beta) * b, b)
    z = torch.where(demand, ay + (1 - alpha) * z, z)
    return z, b


def _ses_step(level, az, observed, one_minus, out=None, carry=None):
    """One masked SES step on any lane shape: ``(1 - alpha) * level +
    alpha * z`` where observed, else ``level`` (whose value is the step's
    one-step prediction).  ``az`` is ``alpha * z`` and ``one_minus`` is
    ``1 - alpha``, formed by the caller.  ``out`` / ``carry`` are optional
    buffers for the result and the unmasked update."""
    carry = torch.mul(one_minus, level, out=carry)
    carry.add_(az)
    return torch.where(observed, carry, level, out=out)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(
            f"unknown CrostonConfig.variant {variant!r}; "
            f"'croston', 'sba', or 'tsb'"
        )


def croston_filter_reference(y, mask, carry, alpha: float, variant: str,
                             beta: float = 0.1, sums=None):
    """Plain-PyTorch twin of :func:`croston_filter`: one Python loop over T
    of :func:`_croston_step` or :func:`_tsb_step`, then, with ``sums``, one
    of the squared-error accumulation."""
    T, S = y.shape
    demand = (y > _EPS) & (mask > 0)
    ay = alpha * y
    path = y.new_empty(T, S)
    if variant == "tsb":
        z, b = carry
        # the probability's update term beta * 1[demand], for every step
        b_in = torch.where(demand, beta * 1.0, 0.0)
        observed = mask > 0
        for t in range(T):
            z, b = _tsb_step(z, b, ay[t], b_in[t], observed[t], demand[t],
                             alpha, beta, out=path[t])
        carry = (z, b)
    else:
        z, p, q = carry
        # 0 at a demand, else 1
        keep = (~demand).to(y.dtype)
        for t in range(T):
            z, p, q = _croston_step(z, p, q, ay[t], mask[t], demand[t],
                                    keep[t], alpha, variant, out=path[t])
        carry = (z, p, q)
    if sums is not None:
        sse, n = sums
        for t in range(T):
            err = (y[t] - path[t]) * mask[t]
            sse = sse + err * err
            n = n + mask[t]
        sums = (sse, n)
    return path, carry, sums


def croston_filter_work(S: int, T: int, variant: str,
                        sums: bool = False) -> tuple:
    """(float32 operations, bytes) of one :func:`croston_filter` call: every
    step runs; y and mask read, the path written, the carries (three, two
    for TSB; the two sums where asked) read and written once."""
    carries = (2 if variant == "tsb" else 3) + (2 if sums else 0)
    ops = (CROSTON_OPS_STEP[variant] + (SUMS_OPS_STEP if sums else 0)) * S * T
    return ops, 4 * (3 * S * T + 2 * carries * S)


def _f32(x: float) -> ctypes.c_float:
    """A Python float rounded to float32, as torch rounds a Python scalar
    before it multiplies a float32 tensor."""
    return ctypes.c_float(float(np.float32(x)))


def _croston_filter_launcher(y, mask, carry, alpha: float, variant: str,
                             beta: float, sums):
    """Check what the kernel assumes, allocate its outputs and bind its
    arguments: returns ``(launch, (path, carry', sums'))``, where
    ``launch()`` launches it on the stream that was PyTorch's current one
    when it was bound, raises on a refused launch and counts the launch on
    ``croston_filter.launches``."""
    from distributed_forecasting_tpu_torch.ops._build import library

    T, S = y.shape
    dev = y.device
    names = ("z", "b") if variant == "tsb" else ("z", "p", "q")
    if len(carry) != len(names):
        raise ValueError(f"croston_filter: the {variant} carry is "
                         f"{names}, got {len(carry)} tensors")
    expected = {"y": (y, (T, S)), "mask": (mask, (T, S)),
                **{k: (x, (S,)) for k, x in zip(names, carry)}}
    if sums is not None:
        expected.update(sse=(sums[0], (S,)), n=(sums[1], (S,)))
    _check("croston_filter", dev, expected)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    path = new(T, S)
    out = tuple(new(S) for _ in names)
    sums_out = None if sums is None else (new(S), new(S))
    result = (path, out, sums_out)
    if S == 0:
        return (lambda: None), result
    lib = library()
    null = ctypes.c_void_p(None)
    ptr = lambda x: null if x is None else _ptr(x)  # noqa: E731
    q0, q = (None, None) if variant == "tsb" else (carry[2], out[2])
    sse0, n0 = sums if sums is not None else (None, None)
    sse, n = sums_out if sums_out is not None else (None, None)
    tensors = tuple(x for x in (y, mask, *carry, *(sums or ()), path, *out,
                                *(sums_out or ())))
    args = [_ptr(y), _ptr(mask), _ptr(carry[0]), _ptr(carry[1]), ptr(q0),
            ptr(sse0), ptr(n0), _ptr(path), _ptr(out[0]), _ptr(out[1]),
            ptr(q), ptr(sse), ptr(n), S, T, VARIANTS.index(variant),
            _f32(alpha), _f32(1 - alpha), _f32(1.0 - alpha / 2.0),
            _f32(beta * 1.0), _f32(1 - beta), _stream(dev)]

    def launch():
        with torch.cuda.device(dev):
            err = lib.croston_filter_launch(*args)
        _raise_on("croston_filter", lib, err,
                  f"S={S}, T={T}, variant={variant}")
        croston_filter.launches += 1

    launch.tensors = tensors  # the bound pointers stay valid while launch lives
    return launch, result


def croston_filter(y, mask, carry, alpha: float, variant: str,
                   beta: float = 0.1, sums=None):
    """Croston / SBA / TSB over a time-major grid from given carries.

    ``y, mask``: (T, S) float32; ``carry``: ``(z, p, q)`` for croston and
    SBA (size, interval, periods since the last demand), ``(z, b)`` for TSB
    (size, demand probability), each (S,); ``sums``: None, or the streaming
    update's running ``(sse, n_obs)``, (S,) each.  Returns ``(path, carry',
    sums')``: the (T, S) one-step rates, the carries after the last step,
    and the sums continued over the grid (None without ``sums``).  The step
    forms ``alpha * y``, the demand flag ``(y > 1e-6) & (mask > 0)``, and
    croston's ``keep`` / TSB's ``beta * 1[demand]`` itself.

    CUDA tensors launch the kernel (``csrc/ses.cu``, bitwise equal to the
    twin) or raise; CPU tensors run :func:`croston_filter_reference`.
    """
    _check_variant(variant)
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"croston_filter runs on cuda or cpu, got {y.device}")
    T, S = y.shape
    _record_work("croston_filter",
                 f"{S}x{T}:{variant}{':sums' if sums is not None else ''}",
                 lambda: croston_filter_work(S, T, variant, sums is not None))
    if y.device.type == "cpu":
        return croston_filter_reference(y, mask, carry, alpha, variant, beta,
                                        sums)
    launch, result = _croston_filter_launcher(y, mask, carry, alpha, variant,
                                              beta, sums)
    launch()
    return result


def ses_filter_reference(z, mask, l0, alpha, scored=None):
    """Plain-PyTorch twin of :func:`ses_filter`: one Python loop over T of
    :func:`_ses_step` on the (S, A) lanes (with ``scored``, each step's
    fitted value and error sums beside it)."""
    T, S = z.shape
    A = alpha.shape[1]
    one_minus = 1.0 - alpha
    # time-major: each step reads and writes contiguous (S, A) slices
    az = alpha[None] * z[:, :, None]                        # (T, S, A)
    observed = (mask > 0)[:, :, None]                       # (T, S, 1)
    buf = z.new_empty(T + 1, S, A)
    buf[0] = l0[:, None]
    carry = z.new_empty(S, A)
    if scored is None:
        for t in range(T):
            _ses_step(buf[t], az[t], observed[t], one_minus, out=buf[t + 1],
                      carry=carry)
        return buf
    y, trend, si, theta, sse, n = scored
    w_ses = 1.0 / theta
    fitted = z.new_empty(T, S)
    for t in range(T):
        pred = buf[t, :, 0]
        _ses_step(buf[t], az[t], observed[t], one_minus, out=buf[t + 1],
                  carry=carry)
        torch.mul(w_ses * pred + (1.0 - w_ses) * trend[t], si[t],
                  out=fitted[t])
        err = (y[t] - fitted[t]) * mask[t]
        sse = sse + err * err
        n = n + mask[t]
    return buf, fitted, sse, n


def ses_filter_work(S: int, T: int, A: int, scored: bool = False) -> tuple:
    """(float32 operations, bytes) of one :func:`ses_filter` call: every
    (lane, step) runs, plus ``1 - alpha`` once a lane; z, mask, the (S, A)
    alphas and the (S,) initial levels read once, the (T + 1, S, A) buffer
    written once; the scored form adds y, trend and si read, the (T, S)
    fitted values written and the two sums read and written."""
    ops = (SES_OPS_STEP * A + (SCORED_OPS_STEP if scored else 0)) * S * T \
        + S * A
    nbytes = 4 * (2 * S * T + S * A + S + (T + 1) * S * A)
    if scored:
        nbytes += 4 * (4 * S * T + 4 * S)
    return ops, nbytes


def _ses_filter_launcher(z, mask, l0, alpha, scored):
    """Check what the kernel assumes, allocate its outputs and bind its
    arguments: returns ``(launch, result)`` as :func:`ses_filter` returns
    it; ``launch()`` launches on the stream that was PyTorch's current one
    when it was bound, raises on a refused launch and counts the launch on
    ``ses_filter.launches``."""
    from distributed_forecasting_tpu_torch.ops._build import library

    T, S = z.shape
    A = alpha.shape[1] if alpha.dim() == 2 else -1
    dev = z.device
    expected = {"z": (z, (T, S)), "mask": (mask, (T, S)), "l0": (l0, (S,)),
                "alpha": (alpha, (S, A))}
    if scored is not None:
        if A != 1:
            raise ValueError(f"ses_filter: the scored form takes one alpha a "
                             f"row, got {A}")
        y, trend, si, theta, sse0, n0 = scored
        expected.update(y=(y, (T, S)), trend=(trend, (T, S)),
                        si=(si, (T, S)), sse=(sse0, (S,)), n=(n0, (S,)))
    _check("ses_filter", dev, expected)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    buf = new(T + 1, S, A)
    if scored is None:
        result, extra_in, extra_out, w = buf, (), (), (0.0, 0.0)
    else:
        fitted, sse, n = new(T, S), new(S), new(S)
        result = (buf, fitted, sse, n)
        extra_in, extra_out = (y, trend, si, sse0, n0), (fitted, sse, n)
        w_ses = 1.0 / theta
        w = (w_ses, 1.0 - w_ses)
    if S == 0:
        return (lambda: None), result
    lib = library()
    null = ctypes.c_void_p(None)
    ins = [_ptr(x) for x in extra_in] or [null] * 5
    outs = [_ptr(x) for x in extra_out] or [null] * 3
    tensors = (z, mask, l0, alpha, *extra_in, buf, *extra_out)
    args = [_ptr(z), _ptr(mask), _ptr(l0), _ptr(alpha), *ins, _ptr(buf),
            *outs, S, T, A, _f32(w[0]), _f32(w[1]), _stream(dev)]

    def launch():
        with torch.cuda.device(dev):
            err = lib.ses_filter_launch(*args)
        _raise_on("ses_filter", lib, err, f"S={S}, T={T}, A={A}")
        ses_filter.launches += 1

    launch.tensors = tensors  # the bound pointers stay valid while launch lives
    return launch, result


def ses_filter(z, mask, l0, alpha, scored=None):
    """Masked SES of every (row, alpha) lane over a time-major grid.

    ``z, mask``: (T, S) float32; ``l0``: (S,) initial levels; ``alpha``:
    (S, A) float32, the candidates shared across rows (expanded) or one per
    row (A 1).  Returns the (T + 1, S, A) buffer whose row t is the level
    before step t (its one-step prediction) and whose last row is the final
    level; the level moves only where ``mask > 0``.  ``scored``: None, or the
    streaming update's ``(y, trend, si, theta, sse, n_obs)`` (three (T, S)
    grids, theta's float, two (S,) sums; A must be 1): then returns
    ``(buf, fitted, sse', n_obs')``, with each step's fitted value
    ``(level / theta + (1 - 1 / theta) * trend) * si`` (T, S) and the
    masked squared one-step error summed on.

    CUDA tensors launch the kernel (``csrc/ses.cu``, bitwise equal to the
    twin) or raise; CPU tensors run :func:`ses_filter_reference`.
    """
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ses_filter runs on cuda or cpu, got {z.device}")
    T, S = z.shape
    A = alpha.shape[-1]
    _record_work("ses_filter",
                 f"{S}x{T}:A{A}{':scored' if scored is not None else ''}",
                 lambda: ses_filter_work(S, T, A, scored is not None))
    if z.device.type == "cpu":
        return ses_filter_reference(z, mask, l0, alpha, scored)
    launch, result = _ses_filter_launcher(z, mask, l0, alpha, scored)
    launch()
    return result


# launches of each CUDA kernel in this process (the CPU twins never count)
croston_filter.launches = 0
ses_filter.launches = 0
