"""Build and load the port's CUDA kernels at first use.

Each kernel source under ``csrc/`` exposes a plain C launcher, so it needs
none of PyTorch's headers and ``nvcc`` compiles it in seconds.  The library
is built with ``torch.utils.cpp_extension.load`` (ninja, content-cached)
and read with ``ctypes``; tensors pass as ``data_ptr()`` integers and the
stream as PyTorch's current CUDA stream.  In a checkout of the repo the
library goes to ``build/torch_kernels/`` at the checkout's root; an
installed copy of the package builds into PyTorch's own extensions
directory (``TORCH_EXTENSIONS_DIR``, or its default under the user's
cache).  Nothing here runs at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import os

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
_ROOT = os.path.dirname(_PKG)
# a checkout holds setup.py beside the package; site-packages does not
BUILD_DIR = (os.path.join(_ROOT, "build", "torch_kernels")
             if os.path.isfile(os.path.join(_ROOT, "setup.py")) else None)

# sm_90a: Hopper with its architecture-specific instructions.  No fast
# math, and no fused multiply-add contraction (--fmad=false): every float
# operation rounds on its own, exactly as the plain PyTorch twin's
# elementwise ops do, so the kernel reproduces the twin's scores.
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
              "-std=c++17"]


def build(name: str, sources) -> str:
    """Compile ``sources`` (file names under ``csrc/``) into the shared
    library ``name`` and return its path."""
    from torch.utils.cpp_extension import load

    if BUILD_DIR is not None:
        os.makedirs(BUILD_DIR, exist_ok=True)
    return load(
        name=name,
        sources=[os.path.join(CSRC, s) for s in sources],
        extra_cuda_cflags=CUDA_FLAGS,
        build_directory=BUILD_DIR,
        is_python_module=False,
    )


@functools.lru_cache(maxsize=None)
def hw_score_library() -> ctypes.CDLL:
    """The Holt-Winters scoring kernel's library, built on first call."""
    lib = ctypes.CDLL(build("dftt_hw_score", ["hw_score.cu"]))
    lib.hw_score_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.hw_score_launch.restype = ctypes.c_int
    lib.hw_score_error_string.argtypes = [ctypes.c_int]
    lib.hw_score_error_string.restype = ctypes.c_char_p
    return lib
