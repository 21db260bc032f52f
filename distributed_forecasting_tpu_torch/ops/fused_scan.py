"""The Holt-Winters filter's hand-written CUDA kernels, their plain twins, and
the ``filter='auto'`` heuristic.

:func:`hw_score` replaces the reference's Pallas TPU kernel
(``distributed_forecasting_tpu/ops/fused_scan.py::hw_score``).  For every
(series, candidate) pair it computes the masked one-step-ahead MSE of the
additive Holt-Winters filter with trend damping.  Only the argmin over
candidates consumes it, and the winner is refit exactly, so scoring is
tolerance-grade: the kernel (``csrc/hw_score.cu``) contracts its error sum
into fused multiply-adds and stops each row after its last observed step, and
agrees with its twin :func:`hw_score_reference` within rtol 1e-5 / atol 1e-6,
not bit for bit.

:func:`hw_filter` is the winner refit: one candidate per row, the final
state, the MSE and the fitted path.  It replaces the reference's ``lax.scan``
filter (no Pallas origin).  Its kernel (``csrc/hw_filter.cu``) is bitwise
equal to its twin ``models/holt_winters._filter``: the refit's state is what
forecasting and serving read.

On a CUDA tensor each wrapper launches its kernel (see the note at the top of
each source for its design and bound) or raises; on a CPU tensor it runs the
plain twin.
"""

from __future__ import annotations

import torch

# float32 operations (an FMA counts two) of one hw_score step per candidate
# (the note in csrc/hw_score.cu): observed with a mask of exactly 1, observed
# with any other weight (one more: the error times the mask), and masked
# (phi * b, l + phi * b); plus one per observed row step for the count n
HW_SCORE_OPS_UNIT = 18
HW_SCORE_OPS_WEIGHTED = 19
HW_SCORE_OPS_MASKED = 2
# float32 operations of one hw_filter step (the twin's, both branches and the
# error terms; selects not counted)
HW_FILTER_OPS_STEP = 20


def select_filter(device_type: str) -> str:
    """Pick the candidate-scoring solver for a device type.

    Returns ``'pallas'`` — the reference's name for the scoring kernel,
    which on the card is the hand-written CUDA kernel — for ``cuda``, and
    ``'scan'`` otherwise (off the card the kernel's plain twin is exactly
    the scan's arithmetic, so scanning is the honest choice).  ``'pscan'``
    is never chosen: that solver is not ported.  Unlike the reference's
    heuristic this one reads no shape: no choice here depends on one.
    """
    return "pallas" if device_type == "cuda" else "scan"


def hw_score_reference(y, mask, alpha, beta, gamma, phi, m: int):
    """Plain-PyTorch twin of :func:`hw_score`: the sequential filter over the
    (S, C) lanes (one Python loop over T), returning the (S, C) masked MSE."""
    from distributed_forecasting_tpu_torch.models.holt_winters import _filter

    _, mse, _ = _filter(y, mask, alpha[None], beta[None], gamma[None], m,
                        "additive", phi[None], keep_path=False)
    return mse


def row_ends(mask):
    """(S,) int32: one past each row's last observed step (0 for a row with
    none).  The scoring kernel stops there: trailing masked steps change
    neither a score's error sum nor its observed count."""
    S, T = mask.shape
    if T == 0:
        return torch.zeros(S, dtype=torch.int32, device=mask.device)
    steps = torch.arange(1, T + 1, dtype=torch.int32, device=mask.device)
    return torch.where(mask > 0, steps, 0).amax(1).to(torch.int32)


def hw_score_work(mask, n_cand: int, m: int) -> tuple:
    """(float32 operations, bytes) that scoring ``n_cand`` candidates needs on
    this ``mask``: per candidate, 18 operations an observed step with a mask
    of exactly 1, 19 one with any other weight, and 2 a masked step before
    the row's last observed step (0 after it), plus one per observed row
    step for the count; bytes, each input read once and the (S, C) scores
    written once."""
    S, T = mask.shape
    n_obs = int((mask > 0).sum())
    n_unit = int((mask == 1).sum())
    n_masked = int(row_ends(mask).sum()) - n_obs
    ops = (n_cand * (HW_SCORE_OPS_UNIT * n_unit
                     + HW_SCORE_OPS_WEIGHTED * (n_obs - n_unit)
                     + HW_SCORE_OPS_MASKED * n_masked) + n_obs)
    nbytes = 4 * (2 * S * T + 4 * n_cand + 2 * S + S * m + S * n_cand)
    return ops, nbytes


def hw_filter_work(S: int, T: int, m: int) -> tuple:
    """(float32 operations, bytes) of the winner refit of S rows: every step
    runs (trailing masked steps too); y and mask read, the path written, the
    per-row parameters and states read and written once."""
    ops = HW_FILTER_OPS_STEP * S * T
    nbytes = 4 * (3 * S * T + 8 * S + 2 * S * m + S)
    return ops, nbytes


def _record_work(entry: str, key: str, work) -> None:
    """Publish ``work()`` — a kernel's (operations, bytes) count — as the
    cost registry's program costs of (``entry``, shape ``key``), once per
    key (``monitoring/cost.CostMetrics.record_work``)."""
    from distributed_forecasting_tpu_torch.monitoring.cost import cost_metrics

    cost_metrics().record_work(entry, key, work)


def _check(kernel: str, dev, expected: dict) -> None:
    """Raise unless every tensor is float32 on ``dev``, contiguous, of its
    shape."""
    for name, (x, shape) in expected.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(
                f"{kernel}: {name} must be float32 on {dev}, got "
                f"{x.dtype} on {x.device}"
            )
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {shape} tensor, got "
                f"{tuple(x.shape)} (contiguous={x.is_contiguous()})"
            )


def _ptr(x):
    import ctypes

    return ctypes.c_void_p(x.data_ptr())


def _stream(dev):
    import ctypes

    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(kernel: str, lib, err: int, detail: str) -> None:
    """Raise for a launcher's non-zero status: ValueError where the launcher
    refused the arguments (a negative status: a season too long for shared
    memory), RuntimeError for a CUDA error."""
    if err == 0:
        return
    msg = getattr(lib, f"{kernel}_error_string")(err).decode()
    if err < 0:
        raise ValueError(f"{kernel}: {msg} ({detail})")
    raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({detail})")


def _hw_score_launcher(y, mask, alpha, beta, gamma, phi, l0, b0, s0):
    """Check what the scoring kernel assumes (y and mask 16-byte aligned, as
    its staging copies read them), allocate its output and bind its
    arguments: returns ``(launch, out)``, where ``launch()`` launches it on
    the stream that was PyTorch's current one when it was bound, raises on a
    refused launch and counts the launch on ``hw_score.launches``."""
    from distributed_forecasting_tpu_torch.ops._build import library

    S, T = y.shape
    C = alpha.shape[0]
    m = s0.shape[1]
    dev = y.device
    _check("hw_score", dev, {
        "y": (y, (S, T)), "mask": (mask, (S, T)), "alpha": (alpha, (C,)),
        "beta": (beta, (C,)), "gamma": (gamma, (C,)), "phi": (phi, (C,)),
        "l0": (l0, (S,)), "b0": (b0, (S,)), "s0": (s0, (S, m))})
    if y.data_ptr() % 16 or mask.data_ptr() % 16:
        raise ValueError("hw_score: y and mask must start on a 16-byte boundary")
    out = torch.empty((S, C), dtype=torch.float32, device=dev)
    if S == 0 or C == 0:
        return (lambda: None), out
    t_end = row_ends(mask)
    lib = library()
    tensors = (y, mask, alpha, beta, gamma, phi, l0, b0, s0, t_end, out)
    args = [*map(_ptr, tensors), S, T, C, m, _stream(dev)]

    def launch():
        with torch.cuda.device(dev):
            err = lib.hw_score_launch(*args)
        _raise_on("hw_score", lib, err,
                  f"S={S}, T={T}, C={C}, season_length={m}")
        hw_score.launches += 1

    launch.tensors = tensors  # the bound pointers stay valid while launch lives
    return launch, out


def _hw_score_cuda(y, mask, alpha, beta, gamma, phi, l0, b0, s0):
    """Launch the scoring kernel: (S, C) float32 scores from the series (y,
    mask), the candidates (alpha..phi) and the initial states (l0, b0,
    s0)."""
    launch, out = _hw_score_launcher(y, mask, alpha, beta, gamma, phi, l0, b0, s0)
    launch()
    return out


def hw_score(y, mask, alpha, beta, gamma, phi, m: int):
    """Score every (series, candidate) pair's additive-HW filter MSE.

    y, mask: (S, T); alpha/beta/gamma/phi: (C,) candidate grid.  Returns
    (S, C) masked one-step-ahead MSE, the ranking input of the grid search's
    argmin.  Additive seasonality only (the multiplicative update divides
    by the state; ``fit`` refuses ``filter='pallas'`` for it).  Initial
    states come from the same ``_init_state`` the sequential filter uses,
    computed once per series before the launch.

    CUDA tensors launch the kernel (``csrc/hw_score.cu``) or raise; CPU
    tensors run the plain twin :func:`hw_score_reference`.  The kernel's
    scores agree with the twin's within rtol 1e-5 / atol 1e-6.
    """
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hw_score runs on cuda or cpu, got {y.device}")
    S, T = y.shape
    C = alpha.shape[0]
    _record_work("hw_score", f"{S}x{T}:C{C}:m{m}",
                 lambda: hw_score_work(mask, C, m))
    if y.device.type == "cpu":
        return hw_score_reference(y, mask, alpha, beta, gamma, phi, m)
    from distributed_forecasting_tpu_torch.models.holt_winters import _init_state

    # the staging copies read whole aligned 16-byte segments
    y, mask = (x.clone() if x.data_ptr() % 16 else x for x in (y, mask))
    l0, b0, s0 = _init_state(y, mask, m, "additive")
    return _hw_score_cuda(y, mask, alpha, beta, gamma, phi,
                          l0.contiguous(), b0.contiguous(), s0.contiguous())


def _hw_filter_launcher(y, mask, alpha, beta, gamma, phi, l0, b0, s0, mode):
    """Check what the refit kernel assumes, allocate its outputs and bind its
    arguments: returns ``(launch, ((level, trend, season), mse, fitted))``,
    where ``launch()`` launches it on the stream that was PyTorch's current
    one when it was bound, raises on a refused launch and counts the launch
    on ``hw_filter.launches``."""
    from distributed_forecasting_tpu_torch.ops._build import library

    S, T = y.shape
    m = s0.shape[1]
    dev = y.device
    _check("hw_filter", dev, {
        "y": (y, (S, T)), "mask": (mask, (S, T)), "alpha": (alpha, (S,)),
        "beta": (beta, (S,)), "gamma": (gamma, (S,)), "phi": (phi, (S,)),
        "l0": (l0, (S,)), "b0": (b0, (S,)), "s0": (s0, (S, m))})
    if mode not in ("additive", "multiplicative"):
        raise ValueError(f"hw_filter: unknown seasonality mode {mode!r}")
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    level, trend, mse, season, fitted = new(S), new(S), new(S), new(S, m), new(S, T)
    result = ((level, trend, season), mse, fitted)
    if S == 0:
        return (lambda: None), result
    lib = library()
    tensors = (y, mask, alpha, beta, gamma, phi, l0, b0, s0, level, trend,
               season, mse, fitted)
    args = [*map(_ptr, tensors), S, T, m, int(mode == "multiplicative"),
            _stream(dev)]

    def launch():
        with torch.cuda.device(dev):
            err = lib.hw_filter_launch(*args)
        _raise_on("hw_filter", lib, err,
                  f"S={S}, T={T}, season_length={m}, mode={mode}")
        hw_filter.launches += 1

    launch.tensors = tensors  # the bound pointers stay valid while launch lives
    return launch, result


def _hw_filter_cuda(y, mask, alpha, beta, gamma, phi, l0, b0, s0, mode):
    """Launch the refit kernel: ``((level, trend, season), mse, fitted)``."""
    launch, result = _hw_filter_launcher(y, mask, alpha, beta, gamma, phi,
                                         l0, b0, s0, mode)
    launch()
    return result


def hw_filter(y, mask, alpha, beta, gamma, phi, m: int, mode: str):
    """Refit one candidate per row: the Holt-Winters filter over the whole
    history with the fitted path.

    y, mask: (S, T); alpha/beta/gamma/phi: (S,), the row's own parameters.
    Returns ``((level, trend, season (S, m)), mse (S,), fitted (S, T))``, what
    ``models/holt_winters._filter(..., keep_path=True)`` returns for (S,)
    lanes.  CUDA tensors launch the kernel (``csrc/hw_filter.cu``, bitwise
    equal to the twin) or raise; CPU tensors run the twin ``_filter``.
    """
    from distributed_forecasting_tpu_torch.models.holt_winters import (
        _filter,
        _init_state,
    )

    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hw_filter runs on cuda or cpu, got {y.device}")
    S, T = y.shape
    _record_work("hw_filter", f"{S}x{T}:m{m}:{mode}",
                 lambda: hw_filter_work(S, T, m))
    if y.device.type == "cpu":
        return _filter(y, mask, alpha, beta, gamma, m, mode, phi)
    l0, b0, s0 = _init_state(y, mask, m, mode)
    return _hw_filter_cuda(y, mask, alpha, beta, gamma, phi, l0.contiguous(),
                           b0.contiguous(), s0.contiguous(), mode)


# launches of each CUDA kernel in this process (the CPU twins never count)
hw_score.launches = 0
hw_filter.launches = 0
