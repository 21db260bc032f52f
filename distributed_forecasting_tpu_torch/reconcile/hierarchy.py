"""Hierarchical forecast reconciliation (port of the reference's
``reconcile/hierarchy.py``).

  * :class:`Hierarchy` — the store x item two-level hierarchy as a static
    summing matrix ``S_mat`` (rows: total, per-store, per-item, bottom),
    host numpy as in the reference;
  * bottom-up aggregation (one matmul with the summing matrix);
  * top-down allocation by historical proportions (the reference workload's
    allocation method generalized to the full hierarchy);
  * MinT-diagonal (WLS) reconciliation: given base forecasts at every level,
    the trace-minimizing coherent revision
    ``y~ = S (S' W^-1 S)^-1 S' W^-1 y^`` with diagonal W from base-forecast
    error variances — one Cholesky factorization and solve
    (``torch.linalg.cholesky`` / ``cholesky_solve``), which raises when the
    system is not positive definite.

Everything runs on the device of the forecasts it is given.
:func:`gather_bottom_sharded` all-gathers series-sharded bottom forecasts
over the series mesh (``parallel/``), so every rank can aggregate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from distributed_forecasting_tpu_torch.ops import metrics as M


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Two-level (store, item) hierarchy over S bottom series.

    Node order: [total, stores..., items..., bottom...].
    """

    keys: np.ndarray          # (S, 2) int64 (store, item) per bottom series
    stores: np.ndarray        # unique store ids (sorted)
    items: np.ndarray         # unique item ids (sorted)
    S_mat: np.ndarray         # (n_nodes, S) float32 summing matrix

    @classmethod
    def from_keys(cls, keys: np.ndarray) -> "Hierarchy":
        keys = np.asarray(keys)
        S = keys.shape[0]
        stores = np.unique(keys[:, 0])
        items = np.unique(keys[:, 1])
        rows = [np.ones((1, S), np.float32)]
        rows.append((keys[None, :, 0] == stores[:, None]).astype(np.float32))
        rows.append((keys[None, :, 1] == items[:, None]).astype(np.float32))
        rows.append(np.eye(S, dtype=np.float32))
        return cls(keys=keys, stores=stores, items=items,
                   S_mat=np.concatenate(rows, axis=0))

    @property
    def n_bottom(self) -> int:
        return self.keys.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.S_mat.shape[0]

    def node_labels(self) -> list:
        labels = ["total"]
        labels += [f"store_{s}" for s in self.stores]
        labels += [f"item_{i}" for i in self.items]
        labels += [f"store_{s}_item_{i}" for s, i in self.keys.tolist()]
        return labels

    def summing_matrix(self, device) -> torch.Tensor:
        """``S_mat`` as a float32 tensor on ``device``."""
        return torch.as_tensor(self.S_mat, device=device)


def aggregate_bottom_up(h: Hierarchy, bottom: torch.Tensor) -> torch.Tensor:
    """(S, H) bottom forecasts -> (n_nodes, H) coherent forecasts by summing:
    one matmul with the summing matrix."""
    return h.summing_matrix(bottom.device) @ bottom


def top_down_allocate(h: Hierarchy, total: torch.Tensor,
                      proportions: torch.Tensor) -> torch.Tensor:
    """(H,) total forecast + (S,) historical proportions -> coherent
    (n_nodes, H)."""
    p = proportions / torch.clamp_min(proportions.sum(), 1e-12)
    return aggregate_bottom_up(h, p[:, None] * total[None, :])


def reconcile_forecasts(
    h: Hierarchy,
    base_all_levels: torch.Tensor,
    error_var: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MinT-diagonal (WLS) reconciliation.

    base_all_levels: (n_nodes, H) independent base forecasts at every level
    (incoherent in general); error_var: (n_nodes,) base-error variances
    (default: structural variances, the row sums of ``S_mat``, i.e.
    WLS-struct).  Returns coherent (n_nodes, H) revised forecasts.  Raises
    ``torch.linalg.LinAlgError`` when ``S' W^-1 S + 1e-8 I`` is not positive
    definite."""
    S_mat = h.summing_matrix(base_all_levels.device)        # (m, n)
    if error_var is None:
        error_var = S_mat.sum(1)                            # WLS-struct
    w_inv = 1.0 / torch.clamp_min(error_var, 1e-12)         # (m,)
    SW = S_mat * w_inv[:, None]                             # W^-1 S (m, n)
    G = S_mat.T @ SW                                        # (n, n)
    rhs = SW.T @ base_all_levels                            # (n, H)
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    chol = torch.linalg.cholesky(G + 1e-8 * eye)
    return S_mat @ torch.cholesky_solve(rhs, chol)


def mint_work(n_nodes: int, n_bottom: int, H: int) -> tuple:
    """(float32 operations, bytes) of :func:`reconcile_forecasts`' least
    work: the Gram ``S' W^-1 S`` (2 m n^2), its right-hand side (2 m n H),
    the Cholesky (n^3 / 3), two triangular solves (2 n^2 H) and the final
    product (2 m n H); the summing matrix, the variances and the base
    forecasts read once, the revised forecasts written once."""
    m, n = n_nodes, n_bottom
    ops = 2 * m * n * n + 4 * m * n * H + n ** 3 // 3 + 2 * n * n * H
    return ops, 4 * (m * n + m + 2 * m * H)


def coherency_error(h: Hierarchy, all_levels: torch.Tensor) -> torch.Tensor:
    """Max absolute violation of the aggregation constraints (0 = coherent)."""
    bottom = all_levels[-h.n_bottom:]
    return torch.max(torch.abs(all_levels - aggregate_bottom_up(h, bottom)))


def gather_bottom_sharded(bottom_local: torch.Tensor, mesh,
                          axis_name: str = "series") -> torch.Tensor:
    """All-gather the series-sharded bottom forecasts: each rank passes its
    block of rows (``parallel.shard_batch``'s layout) and every rank gets
    the whole bottom level, in rank order, for aggregation — the one
    collective of this module."""
    from distributed_forecasting_tpu_torch.parallel.mesh import (
        all_gather_rows,
        mesh_group,
    )

    return all_gather_rows(bottom_local, mesh_group(mesh, axis_name))


def reconciliation_report(
    h: Hierarchy, bottom_forecast: torch.Tensor, bottom_actual: torch.Tensor,
    mask: torch.Tensor,
) -> Dict[str, float]:
    """Accuracy of coherent aggregates vs aggregated actuals: mape of the
    total, and the mean mape over stores and over items."""
    agg_f = aggregate_bottom_up(h, bottom_forecast)
    agg_a = aggregate_bottom_up(h, bottom_actual)
    agg_m = (aggregate_bottom_up(h, mask) > 0).to(torch.float32)
    n_s, n_i = len(h.stores), len(h.items)
    stores = slice(1, 1 + n_s)
    items = slice(1 + n_s, 1 + n_s + n_i)
    return {
        "total_mape": float(M.mape(agg_a[:1], agg_f[:1], agg_m[:1])[0]),
        "store_mape": float(torch.mean(M.mape(agg_a[stores], agg_f[stores],
                                              agg_m[stores]))),
        "item_mape": float(torch.mean(M.mape(agg_a[items], agg_f[items],
                                             agg_m[items]))),
    }
