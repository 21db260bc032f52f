"""The series mesh over ``torch.distributed`` (port of the reference's
``parallel`` package: the 50k-series, multi-host regime its docstrings call
BASELINE #4).

The reference is single-controller: one process lays a ``Mesh`` of D
devices out, and ``NamedSharding(P("series", None))`` gives device ``r``
the rows ``[r * S_pad / D, (r + 1) * S_pad / D)`` of the series axis
padded to a multiple of D.  The port runs the same layout SPMD, one process
(rank) per device: each of the D ranks of a process group calls the same
function and holds exactly the rows the reference places on device ``r``.
The rule every sharded function follows:

    On rank ``r`` a sharded function returns exactly the rows of the
    reference's global result that the reference's mesh places on device
    ``r``; where the reference trims to the unsharded series count, the
    port trims those rows the same way.  Concatenated in rank order, the
    ranks' outputs are the reference's global array.  Where the reference
    returns a replicated value (``global_metric_means``,
    ``reconcile.hierarchy.gather_bottom_sharded``, the windowed fit's
    trimmed result), every rank returns the whole of it.

The time-sharded scans (``ops/pscan.affine_scan_time_sharded``,
``ops/pkalman.parallel_kalman_filter_time_sharded``,
``models/holt_winters.parallel_filter_time_sharded``) apply the same rule
to the time axis: each rank passes its own ``T / D`` steps and gets back
its own steps' outputs.

``shard_forecast_inputs`` follows it for a predict's inputs: the serving
rank of a replica's mesh holds them and every rank gets its block
(``serving/predictor.py``, ``serving/replica.py``).
"""

from distributed_forecasting_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
)
from distributed_forecasting_tpu_torch.parallel.sharded import (
    global_metric_means,
    shard_batch,
    shard_forecast_inputs,
    sharded_cv_metrics,
    sharded_fit_forecast,
)

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "shard_batch",
    "sharded_fit_forecast",
    "sharded_cv_metrics",
    "global_metric_means",
    "shard_forecast_inputs",
]
