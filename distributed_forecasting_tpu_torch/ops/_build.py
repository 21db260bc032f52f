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
import os
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
_ROOT = os.path.dirname(_PKG)
# a checkout holds setup.py beside the package; site-packages does not
BUILD_DIR = (os.path.join(_ROOT, "build", "torch_kernels")
             if os.path.isfile(os.path.join(_ROOT, "setup.py")) else None)

# sm_90a: Hopper with its architecture-specific instructions.  No fast
# math, and no fused multiply-add contraction (--fmad=false): every float
# operation rounds on its own, exactly as the plain PyTorch twin's
# elementwise ops do, so the refit kernel (csrc/hw_filter.cu) and the ARIMA
# kernels (csrc/arima_kalman.cu, csrc/arima_mle.cu) reproduce their twins
# bit for bit.  The
# scoring kernel writes its multiply-adds out as
# __fmaf_rn where it wants them.
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


# every kernel source, built into one library by one build call (ninja runs
# one nvcc per source, in parallel)
SOURCES = ["hw_score.cu", "hw_filter.cu", "arima_kalman.cu",
           "arima_mle.cu"]


_LIBRARY = None
# serializes the first build: concurrent first launches (the scorer's
# handler threads) build and load the library once
_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The port's kernel library (every source in ``SOURCES``), built on
    first call; thread-safe."""
    global _LIBRARY
    if _LIBRARY is None:
        with _LIBRARY_LOCK:
            if _LIBRARY is None:
                _LIBRARY = _load()
    return _LIBRARY


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build("dftt_kernels", SOURCES))
    lib.hw_score_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.hw_filter_launch.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.arima_filter_launch.argtypes = (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.arima_predict_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.arima_loglik_grad_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.arima_mle_fit_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] * 7
        + [ctypes.c_void_p]
    )
    for name in ("hw_score", "hw_filter", "arima_filter", "arima_predict",
                 "arima_loglik_grad", "arima_mle_fit"):
        getattr(lib, f"{name}_launch").restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib
