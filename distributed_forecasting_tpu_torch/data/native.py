"""ctypes bindings for the host C++ data plane (``native/dftpu_native.cpp``).

The library parses the ``(date, store, item, sales)`` CSV with native date
conversion, interns the (store, item) keys and scatters the rows into the
dense (S, T) value and mask planes that ``tensorize`` hands to the card.  It
is host code: nothing here touches a device.

Loading never writes into ``native/``.  The committed ``libdftpu_native.so``
loads when the sha256 in its sidecar equals that of the source; a stale or
missing binary, or one that does not load on this machine, is never used:
the source is compiled with ``g++`` into the port's build directory
(``build/torch_kernels/`` in a checkout), under a file name that carries the
source's digest, so a built binary cannot go stale.  Without a compiler the
native path is unavailable and ``is_available()`` says so.  Nothing runs at
import: the first call loads or builds, once per process, under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from distributed_forecasting_tpu_torch.ops._build import BUILD_DIR

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_SRC_NAME = "dftpu_native.cpp"
_SO_NAME = "libdftpu_native.so"
_CXX = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C ABI of the current source (the reference's signatures)."""
    i64 = ctypes.c_int64

    def arr(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

    lib.dftpu_csv_count.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64)]
    lib.dftpu_csv_count.restype = ctypes.c_int
    lib.dftpu_csv_parse.argtypes = [
        ctypes.c_char_p, i64, arr(np.int32), arr(np.int64), arr(np.int64),
        arr(np.float64),
    ]
    lib.dftpu_csv_parse.restype = ctypes.c_int
    lib.dftpu_group_keys.argtypes = [
        arr(np.int64), arr(np.int64), i64, arr(np.int64), arr(np.int64),
        ctypes.POINTER(i64),
    ]
    lib.dftpu_group_keys.restype = ctypes.c_int
    lib.dftpu_scatter.argtypes = [
        arr(np.int64), arr(np.int32), arr(np.float64), i64, ctypes.c_int32,
        i64, i64, arr(np.float64), arr(np.float32),
    ]
    lib.dftpu_scatter.restype = ctypes.c_int
    return lib


def _build_and_load(native_dir: str = NATIVE_DIR,
                    build_dir: Optional[str] = BUILD_DIR
                    ) -> Optional[ctypes.CDLL]:
    """Load the committed binary in ``native_dir`` when its sidecar records
    the source's digest; else compile the source into ``build_dir``.
    Returns None when neither gives a library.  Writes nothing into
    ``native_dir``."""
    src = os.path.join(native_dir, _SRC_NAME)
    if not os.path.isfile(src):
        return None
    digest = _digest(src)
    committed = os.path.join(native_dir, _SO_NAME)
    try:
        with open(committed + ".src.sha256") as f:
            fresh = f.read().strip() == digest
    except OSError:
        fresh = False
    if fresh and os.path.isfile(committed):
        try:
            return _declare(ctypes.CDLL(committed))
        except OSError:
            pass  # built for another machine: compile the source here
    if build_dir is None:
        return None
    out = os.path.join(build_dir, f"libdftpu_native_{digest[:16]}.so")
    if not os.path.isfile(out):
        try:
            os.makedirs(build_dir, exist_ok=True)
            # compile beside the target, then rename: a concurrent process
            # never loads a half-written file
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            try:
                subprocess.run([*_CXX, "-o", tmp, src], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        except (subprocess.SubprocessError, OSError):
            return None
    try:
        return _declare(ctypes.CDLL(out))
    except OSError:
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        # the one build is the critical section: concurrent first callers
        # wait for it instead of racing the compiler
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
        return _LIB


def is_available() -> bool:
    return _lib() is not None


def _require() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def parse_sales_csv(path: str
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Native CSV parse -> (day int32 epoch days, store int64, item int64,
    sales float64).  The parser is positional: date, store, item, sales."""
    lib = _require()
    n = ctypes.c_int64(0)
    if lib.dftpu_csv_count(path.encode(), ctypes.byref(n)) != 0:
        raise IOError(f"cannot read {path}")
    n = n.value
    day = np.empty(n, np.int32)
    store = np.empty(n, np.int64)
    item = np.empty(n, np.int64)
    sales = np.empty(n, np.float64)
    rc = lib.dftpu_csv_parse(path.encode(), n, day, store, item, sales)
    if rc != 0:
        raise ValueError(f"malformed CSV {path} (rc={rc})")
    return day, store, item, sales


def tensorize_arrays(day: np.ndarray, store: np.ndarray, item: np.ndarray,
                     sales: np.ndarray):
    """Native group and scatter -> numpy ``(y float32, mask float32,
    day_grid int32, keys int64 (S, 2))``, keys in lexicographic order.
    Duplicate rows sum in float64 in row order, as ``np.add.at`` does, and
    the plane is rounded to float32 once."""
    lib = _require()
    n = len(day)
    series_idx = np.empty(n, np.int64)
    keys_buf = np.empty(2 * n, np.int64)
    S = ctypes.c_int64(0)
    rc = lib.dftpu_group_keys(
        np.ascontiguousarray(store, np.int64),
        np.ascontiguousarray(item, np.int64),
        n, series_idx, keys_buf, ctypes.byref(S),
    )
    if rc != 0:
        raise RuntimeError(f"group_keys failed (rc={rc})")
    S = S.value
    keys = keys_buf[: 2 * S].reshape(S, 2).copy()
    d0, d1 = int(day.min()), int(day.max())
    T = d1 - d0 + 1
    y64 = np.zeros((S, T), np.float64)
    mask = np.zeros((S, T), np.float32)
    rc = lib.dftpu_scatter(
        series_idx, np.ascontiguousarray(day, np.int32),
        np.ascontiguousarray(sales, np.float64), n, d0, S, T, y64, mask,
    )
    if rc != 0:
        raise RuntimeError(f"scatter failed (rc={rc})")
    day_grid = np.arange(d0, d1 + 1, dtype=np.int32)
    return y64.astype(np.float32), mask, day_grid, keys


def load_and_tensorize_csv(path: str, device=None):
    """CSV file -> :class:`SeriesBatch` on ``device`` (``cuda`` unless the
    caller asks for the CPU), keys (store, item), all on the native path."""
    import torch

    from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
    from distributed_forecasting_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    y, mask, day_grid, keys = tensorize_arrays(*parse_sales_csv(path))
    return SeriesBatch(
        y=torch.from_numpy(y).to(dev),
        mask=torch.from_numpy(mask).to(dev),
        day=torch.from_numpy(day_grid).to(dev),
        keys=keys,
        key_names=("store", "item"),
        start_date=str(np.datetime64(int(day_grid[0]), "D")),
    )
