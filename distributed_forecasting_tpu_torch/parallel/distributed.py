"""Multi-host input sharding (port of the reference's
``parallel/distributed.py``: the 50k-series regime its docstrings call
BASELINE #4).

At scale every rank feeds only its own shard of the series axis: the
assignment of series to ranks is deterministic and coordination-free, so
each rank can tensorize its local shard without ever materializing the
global batch.  The hash is the reference's, bit for bit: the same key pair
lands on the same rank in both packages.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import pandas as pd


def series_owner(keys: np.ndarray, num_hosts: int) -> np.ndarray:
    """Owner rank of each (store, item) series: a stable hash, no
    coordination.

    A Fibonacci-style multiplicative hash of the key pair, so the
    assignment is uniform whatever the id ranges.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    h = keys[:, 0] * np.uint64(0x9E3779B97F4A7C15)
    for j in range(1, keys.shape[1]):
        h ^= keys[:, j] * np.uint64(0xC2B2AE3D27D4EB4F)
        h = (h << np.uint64(31)) | (h >> np.uint64(33))
    return (h % np.uint64(num_hosts)).astype(np.int64)


def host_local_frame(
    df: pd.DataFrame,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    key_cols: Sequence[str] = ("store", "item"),
) -> pd.DataFrame:
    """Rows of the long table whose series belong to this rank.

    Defaults to the rank and world size of the initialized
    ``torch.distributed`` group (the reference reads
    ``jax.process_index()`` / ``process_count()``); without one, the
    identity.  So the same code runs single-process (every row) and
    multi-process (1/N of the series).
    """
    if process_index is None or process_count is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            process_index = dist.get_rank()
            process_count = dist.get_world_size()
        else:
            process_index, process_count = 0, 1
    if process_count <= 1:
        return df
    keys = df[list(key_cols)].to_numpy()
    owner = series_owner(keys, process_count)
    return df[owner == process_index].reset_index(drop=True)


def host_shard_summary(
    df: pd.DataFrame, process_count: int,
    key_cols: Sequence[str] = ("store", "item"),
) -> Tuple[np.ndarray, float]:
    """(series per rank, imbalance ratio max / mean), for capacity checks."""
    uniq = df[list(key_cols)].drop_duplicates().to_numpy()
    owner = series_owner(uniq, process_count)
    counts = np.bincount(owner, minlength=process_count)
    return counts, float(counts.max() / max(counts.mean(), 1e-9))
