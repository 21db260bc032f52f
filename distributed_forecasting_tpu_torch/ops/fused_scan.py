"""Candidate scoring for the Holt-Winters grid search: the hand-written CUDA
kernel, its plain twin, and the ``filter='auto'`` heuristic.

:func:`hw_score` replaces the reference's Pallas TPU kernel
(``distributed_forecasting_tpu/ops/fused_scan.py::hw_score``).  For every
(series, candidate) pair it computes the masked one-step-ahead MSE of the
additive Holt-Winters filter with trend damping.  Only the argmin over
candidates consumes it; the winner is refit with the sequential filter
(``models/holt_winters._filter``), so scoring only has to agree with the
filter to float32 tolerance.  On a CUDA tensor :func:`hw_score` launches the
kernel in ``csrc/hw_score.cu`` (see the note there for its design and
bound) or raises; on a CPU tensor it runs :func:`hw_score_reference`, the
same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import torch

# candidates per thread block at most: four warps.  The kernel keeps the
# seasonal state of every thread in shared memory, m * threads * 4 bytes.
_MAX_BLOCK = 128
_WARP = 32
# dynamic shared memory one block may use on Hopper (227 KB)
_SMEM_LIMIT = 232_448


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
    (S, C) lanes (one Python loop over T), returning the (S, C) masked MSE.
    Same inputs, same arithmetic, step for step, as the CUDA kernel."""
    from distributed_forecasting_tpu_torch.models.holt_winters import _filter

    _, mse, _ = _filter(y, mask, alpha[None], beta[None], gamma[None], m,
                        "additive", phi[None], keep_path=False)
    return mse


def _block_threads(n_cand: int, m: int) -> tuple:
    """(threads per block, candidate blocks per series) for C candidates and
    season length m: the fewest blocks of at most 128 threads, split evenly
    and rounded up to whole warps (96 -> one block of 96; 288 -> three of
    96), then cut to what fits the seasonal state in shared memory."""
    n_blk = -(-n_cand // _MAX_BLOCK)
    per_block = -(-n_cand // n_blk)
    bc = -(-per_block // _WARP) * _WARP
    fit = (_SMEM_LIMIT // (4 * m)) // _WARP * _WARP
    if fit < _WARP:
        raise ValueError(
            f"season_length={m} needs {4 * m * _WARP} bytes of shared memory "
            f"for one warp of candidates; the card allows {_SMEM_LIMIT} per "
            f"block (m <= {_SMEM_LIMIT // (4 * _WARP)})"
        )
    bc = min(bc, fit)
    return bc, -(-n_cand // bc)


def _hw_score_cuda(y, mask, alpha, beta, gamma, phi, l0, b0, s0):
    """Launch the CUDA kernel on PyTorch's current stream: (S, C) float32
    scores from the series (y, mask), the candidates (alpha..phi) and the
    initial states (l0, b0, s0).  Checks what the kernel assumes, raises on
    a refused launch, counts the launch on ``hw_score.launches``."""
    import ctypes

    from distributed_forecasting_tpu_torch.ops._build import hw_score_library

    S, T = y.shape
    C = alpha.shape[0]
    m = s0.shape[1]
    dev = y.device
    expected = {"y": (y, (S, T)), "mask": (mask, (S, T)),
                "alpha": (alpha, (C,)), "beta": (beta, (C,)),
                "gamma": (gamma, (C,)), "phi": (phi, (C,)),
                "l0": (l0, (S,)), "b0": (b0, (S,)), "s0": (s0, (S, m))}
    for name, (x, shape) in expected.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(
                f"hw_score: {name} must be float32 on {dev}, got "
                f"{x.dtype} on {x.device}"
            )
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"hw_score: {name} must be a contiguous {shape} tensor, got "
                f"{tuple(x.shape)} (contiguous={x.is_contiguous()})"
            )
    if S == 0 or C == 0:
        return y.new_empty((S, C))
    bc, n_blk = _block_threads(C, m)
    out = torch.empty((S, C), dtype=torch.float32, device=dev)
    lib = hw_score_library()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hw_score_launch(
            ptr(y), ptr(mask), ptr(alpha), ptr(beta), ptr(gamma), ptr(phi),
            ptr(l0), ptr(b0), ptr(s0), ptr(out),
            S, T, C, m, bc, n_blk, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"hw_score kernel launch failed: {lib.hw_score_error_string(err).decode()}"
            f" (S={S}, T={T}, C={C}, m={m}, threads={bc}, blocks={n_blk})"
        )
    hw_score.launches += 1
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
    tensors run the plain twin :func:`hw_score_reference`.
    """
    if y.device.type == "cpu":
        return hw_score_reference(y, mask, alpha, beta, gamma, phi, m)
    if y.device.type != "cuda":
        raise ValueError(f"hw_score runs on cuda or cpu, got {y.device}")
    from distributed_forecasting_tpu_torch.models.holt_winters import _init_state

    l0, b0, s0 = _init_state(y, mask, m, "additive")
    return _hw_score_cuda(y, mask, alpha, beta, gamma, phi,
                          l0.contiguous(), b0.contiguous(), s0.contiguous())


# launches of the CUDA kernel in this process (the CPU twin never counts)
hw_score.launches = 0
