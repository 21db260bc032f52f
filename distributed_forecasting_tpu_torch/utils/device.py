"""Device choice for every entry point of the port.

The port runs on the card.  ``resolve_device(None)`` is ``cuda`` and raises
when no CUDA device is visible — there is no quiet fall-back to the CPU,
because a CPU run measures PyTorch's CPU kernels, not the port.  The CPU is
used only when a caller asks for it (``device="cpu"``), as the tests do.

Float32 matrix products and convolutions are pinned to full float32 here
(TF32 off for both cuBLAS and cuDNN): the JAX reference computes in float32,
and TF32 keeps only about three decimal digits.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else the named device,
    which must exist."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the port runs on the card — pass "
            "device='cpu' to run on the CPU explicitly"
        )
    return dev


# DFTPU_PLATFORM values the port honours (the reference's CPU switch)
_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def platform_device(device=None):
    """The device a task or workflow asked for: ``device`` when given, else
    the ``DFTPU_PLATFORM`` environment variable (``cpu``, or ``cuda`` /
    ``gpu``), else None (the card).  Only the task layer reads the
    variable; library entry points take ``device`` alone."""
    if device is not None:
        return device
    plat = os.environ.get("DFTPU_PLATFORM")
    if not plat:
        return None
    if plat not in _PLATFORMS:
        raise ValueError(
            f"DFTPU_PLATFORM={plat!r} is not a platform of the port; "
            f"valid: {sorted(_PLATFORMS)}"
        )
    return _PLATFORMS[plat]
