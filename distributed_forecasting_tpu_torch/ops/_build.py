"""Build and load the port's CUDA kernels at first use.

Each kernel source under ``csrc/`` exposes a plain C launcher, so it needs
none of PyTorch's headers and ``nvcc`` compiles it in seconds.  The library
is built with ``torch.utils.cpp_extension.load`` (ninja, content-cached)
and read with ``ctypes``; tensors pass as ``data_ptr()`` integers and the
stream as PyTorch's current CUDA stream.  In a checkout of the repo the
library goes to ``build/torch_kernels/`` at the checkout's root; an
installed copy of the package builds into PyTorch's own extensions
directory (``TORCH_EXTENSIONS_DIR``, or its default under the user's
cache).  Where a ``compile_cache`` store is configured
(``engine/compile_cache.configure_compile_cache``) the library loads
through it instead: a warm store loads the stored library without
``nvcc``; a cold one builds into a private temporary directory and stores
the result under a key that covers every source, the flags, the toolchain
and the card (:func:`library_backend`).  Nothing here runs at import: the
first launch builds or loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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
# elementwise ops do, so the refit kernel (csrc/hw_filter.cu), the ARIMA
# kernels (csrc/arima_kalman.cu, csrc/arima_mle.cu) and the croston and
# theta recurrences (csrc/ses.cu) reproduce their twins bit for bit.  The
# scoring kernel writes its multiply-adds out as
# __fmaf_rn where it wants them.
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
              "-std=c++17"]


def build(name: str, sources, build_directory=None) -> str:
    """Compile ``sources`` (file names under ``csrc/``) into the shared
    library ``name`` in ``build_directory`` (default :data:`BUILD_DIR`) and
    return its path."""
    from torch.utils.cpp_extension import load

    build_directory = build_directory or BUILD_DIR
    if build_directory is not None:
        os.makedirs(build_directory, exist_ok=True)
    global builds
    builds += 1
    return load(
        name=name,
        sources=[os.path.join(CSRC, s) for s in sources],
        extra_cuda_cflags=CUDA_FLAGS,
        build_directory=build_directory,
        is_python_module=False,
    )


# build() calls in this process (a warm store makes none)
builds = 0


# every kernel source, built into one library by one build call (ninja runs
# one nvcc per source, in parallel)
SOURCES = ["hw_score.cu", "hw_filter.cu", "arima_kalman.cu",
           "arima_mle.cu", "ses.cu"]


_LIBRARY = None
# serializes the first build: concurrent first launches (the scorer's
# handler threads) build and load the library once
_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The port's kernel library (every source in ``SOURCES``), built or
    loaded from the configured store on first call; thread-safe."""
    global _LIBRARY
    if _LIBRARY is None:
        with _LIBRARY_LOCK:
            if _LIBRARY is None:
                # the one build (or store load) is the critical section:
                # every concurrent first launch waits for the single nvcc
                # run instead of racing it; later calls skip the lock
                # dflint: disable=blocking-under-lock (intentional build barrier)
                _LIBRARY = _load()
    return _LIBRARY


def loaded() -> bool:
    """Whether this process has loaded the kernel library (it is
    process-wide: a store configured later cannot serve this process)."""
    return _LIBRARY is not None


def source_digests() -> dict:
    """sha256 of every source in :data:`SOURCES`, by file name."""
    out = {}
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def nvcc_version() -> str:
    """``nvcc --version`` of the toolkit ``torch.utils.cpp_extension``
    builds with; "none" where it finds none."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        return "none"
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def device_identity() -> dict:
    """The card the library is built for: its name and compute
    capability."""
    import torch

    return {"device": torch.cuda.get_device_name(0),
            "capability": list(torch.cuda.get_device_capability(0))}


def library_backend() -> dict:
    """Everything the built library depends on: the sources' digests, the
    flags, ``nvcc --version``, torch's version and its CUDA version, and
    the card (the store key's backend part)."""
    import torch

    return {"sources": source_digests(), "flags": list(CUDA_FLAGS),
            "nvcc": nvcc_version(), "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, **device_identity()}


def _open() -> ctypes.CDLL:
    """The library: through the configured store (memo, disk, or a build
    that is then stored), else built into :data:`BUILD_DIR`."""
    from distributed_forecasting_tpu_torch.engine.compile_cache import (
        fingerprint,
        get_config,
        get_store,
    )
    from distributed_forecasting_tpu_torch.ops.precision import (
        fingerprint_extra,
    )

    store = get_store()
    if store is None:
        return ctypes.CDLL(build("dftt_kernels", SOURCES))
    backend = library_backend()
    key = fingerprint("kernel_library", backend=backend,
                      extra=fingerprint_extra())
    tmp = tempfile.mkdtemp(prefix="dftt-build-")
    try:
        return store.get_or_compile(
            key, "kernel_library",
            lambda: build(f"dftt_kernels_{key[:16]}", SOURCES, tmp),
            min_compile_time_s=get_config().min_compile_time_s,
            meta={"sources": backend["sources"]})
    finally:
        # a loaded library outlives its file
        shutil.rmtree(tmp, ignore_errors=True)


def _load() -> ctypes.CDLL:
    """The library with every launcher's argument and result types
    declared."""
    lib = _open()
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
    lib.croston_filter_launch.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
        + [ctypes.c_void_p]
    )
    lib.ses_filter_launch.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
        + [ctypes.c_void_p]
    )
    for name in ("hw_score", "hw_filter", "arima_filter", "arima_predict",
                 "arima_loglik_grad", "arima_mle_fit", "croston_filter",
                 "ses_filter"):
        getattr(lib, f"{name}_launch").restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib
