"""Sharded fit, forecast and CV over the series mesh (port of the
reference's ``parallel/sharded.py``).

The reference places the padded series batch with ``NamedSharding(P(
"series", None))`` and lets XLA's partitioner run the single-chip program
on every device's rows.  The port runs the same layout SPMD: every rank of
the mesh calls the same function on the whole (host) batch and keeps the
rows the reference would place on its device, ``[r * S_pad / D, (r + 1) *
S_pad / D)`` of the series axis padded to a multiple of the mesh size D
(mask-zero rows).  Fits are independent, so the fit and the CV pass run the
port's own single-device code on the local block with no cross-rank
traffic; the shared day grid and shared regressors are replicated.

The one collective is :func:`global_metric_means`: a single all-reduce of
the stacked (sum, count) over healthy rows, in place of the reference's
``psum`` (which replaced the original system's mean of per-group metric
frames).

:func:`shard_forecast_inputs` is the serving analogue of
:func:`shard_batch`: the serving rank of a replica's mesh sends every rank
its block of a predict's gathered inputs (``serving/predictor.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine.fit import (
    DEFAULT_MIN_POINTS,
    ForecastResult,
    fit_forecast,
    validate_xreg,
)
from distributed_forecasting_tpu_torch.models import get_model
from distributed_forecasting_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    mesh_device,
    mesh_group,
    mesh_rank,
    mesh_size,
)


def _block(n_rows: int, mesh) -> Tuple[int, int]:
    """``(first row, rows)`` of this rank's block of an ``n_rows`` axis
    padded to a mesh multiple."""
    n = mesh_size(mesh)
    rows = -(-n_rows // n)
    return mesh_rank(mesh) * rows, rows


def shard_batch(batch: SeriesBatch, mesh) -> SeriesBatch:
    """Pad the series axis to a mesh multiple and keep this rank's block on
    its device; ``day`` is replicated.  Padding rows carry mask 0 and keys
    -1 (``SeriesBatch.pad_series_to``)."""
    first, rows = _block(batch.n_series, mesh)
    padded = batch.pad_series_to(rows * mesh_size(mesh))
    dev = mesh_device(mesh)
    sl = slice(first, first + rows)
    return dataclasses.replace(
        padded, y=padded.y[sl].to(dev), mask=padded.mask[sl].to(dev),
        day=padded.day.to(dev), keys=padded.keys[sl])


def _shard_xreg(xreg: torch.Tensor, orig_S: int, mesh) -> torch.Tensor:
    """This rank's regressors in :func:`shard_batch`'s layout: per-series
    (S, T, R) zero-padded to the padded batch and cut to the rank's block,
    shared (T, R) replicated."""
    dev = mesh_device(mesh)
    if xreg.dim() != 3:
        return xreg.to(dev)
    if xreg.shape[0] != orig_S:
        raise ValueError(
            f"per-series xreg leads with {xreg.shape[0]} rows, expected "
            f"{orig_S} (the unsharded batch's series count)")
    first, rows = _block(orig_S, mesh)
    pad = rows * mesh_size(mesh) - orig_S
    if pad:
        xreg = torch.cat([xreg, xreg.new_zeros((pad,) + xreg.shape[1:])])
    return xreg[first:first + rows].to(dev)


def _leaf_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes, flat, from a dense copy (a leaf may be a broadcast
    view)."""
    return x.detach().clone(memory_format=torch.contiguous_format) \
        .reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, shape, dtype: str) -> torch.Tensor:
    """The tensor whose bytes :func:`_leaf_bytes` gave (copied, so its
    storage starts aligned for ``dtype``)."""
    return buf.clone().view(getattr(torch, dtype)).reshape(shape)


def shard_forecast_inputs(params, day_all, scale, fc_kwargs, mesh,
                          bucket):
    """Send every rank of ``mesh`` its block of a bucket-ladder predict's
    gathered inputs; returns this rank's ``(params, day_all, scale,
    fc_kwargs)``.

    The reference places the same inputs with ``NamedSharding``: every
    leaf whose leading axis is the request ``bucket`` (already padded to a
    mesh multiple by ``BatchForecaster._bucket``) shards on the series axis,
    and the day grid, shared covariates and scalar or global leaves
    replicate.  Here the serving rank (rank 0 of the mesh) holds them and
    every rank calls this function (SPMD, ``parallel/__init__``): rank ``r`` gets rows
    ``[r * bucket / D, (r + 1) * bucket / D)`` of the params' row leaves,
    ``scale`` and a per-series (bucket, T_all, R) ``xreg``, and the rest
    whole, even a shared (T_all, R) calendar whose ``T_all`` equals the
    bucket (the reference's explicit ``xreg`` rule).  Forecasts are
    per-series independent, so the family's single-device forecast on each
    block gives the rows the single-device predict gives.

    On the other ranks pass ``None`` for the four inputs and the bucket:
    the shapes and dtypes come from rank 0 in one small header
    (``broadcast_object_list``), then one ``scatter`` carries the row
    blocks and one ``broadcast`` the replicated leaves, each as one byte
    buffer on the rank's device.
    """
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.convert import (
        params_class,
        params_type_name,
    )

    group = mesh_group(mesh)
    n, rank = mesh_size(mesh), mesh_rank(mesh)
    dev = mesh_device(mesh)
    root = dist.get_global_rank(group, 0)
    if rank == 0:
        if bucket % n:
            raise ValueError(
                f"request bucket {bucket} is not a multiple of the mesh size "
                f"{n}; buckets must be padded to mesh multiples before "
                f"sharding")
        leaves = [("params", f.name, getattr(params, f.name))
                  for f in dataclasses.fields(params)]
        leaves.append(("day_all", "", day_all))
        if scale is not None:
            leaves.append(("scale", "", torch.as_tensor(scale)))
        leaves += [("kw", k, torch.as_tensor(v))
                   for k, v in (fc_kwargs or {}).items()]

        def is_row(slot, name, x):
            if slot == "scale":
                return True
            if slot == "day_all":
                return False
            if slot == "kw" and name == "xreg":
                # explicit, not by shape: a shared (T_all, R) calendar
                # with T_all == bucket still replicates
                return x.dim() == 3
            return x.dim() >= 1 and x.shape[0] == bucket

        header = {"params_type": params_type_name(params), "bucket": bucket,
                  "leaves": [(slot, name, tuple(x.shape),
                              str(x.dtype).rpartition(".")[2],
                              is_row(slot, name, x))
                             for slot, name, x in leaves]}
    else:
        header = None
    box = [header]
    dist.broadcast_object_list(box, src=root, group=group)
    header = box[0]
    rows = header["bucket"] // n
    specs = header["leaves"]
    row_bytes = [int(torch.Size((rows,) + tuple(shape[1:])).numel())
                 * getattr(torch, dtype).itemsize if row else 0
                 for _, _, shape, dtype, row in specs]
    rep_bytes = [int(torch.Size(shape).numel()) * getattr(torch, dtype).itemsize
                 if not row else 0 for _, _, shape, dtype, row in specs]
    row_buf = torch.empty(sum(row_bytes), dtype=torch.uint8, device=dev)
    rep_buf = torch.empty(sum(rep_bytes), dtype=torch.uint8, device=dev)
    if rank == 0:
        blocks = [torch.cat([_leaf_bytes(x[r * rows:(r + 1) * rows])
                             for (_, _, x), (*_, row) in zip(leaves, specs)
                             if row] or [row_buf[:0]]).to(dev)
                  for r in range(n)]
        rep_buf = torch.cat([_leaf_bytes(x)
                             for (_, _, x), (*_, row) in zip(leaves, specs)
                             if not row] or [rep_buf]).to(dev)
    if row_buf.numel():
        dist.scatter(row_buf, blocks if rank == 0 else None, src=root,
                     group=group)
    if rep_buf.numel():
        dist.broadcast(rep_buf, src=root, group=group)
    out = {"params": {}, "kw": {}}
    row_at = rep_at = 0
    for (slot, name, shape, dtype, row), nr, nb in zip(specs, row_bytes,
                                                        rep_bytes):
        if row:
            x = _from_bytes(row_buf[row_at:row_at + nr],
                            (rows,) + tuple(shape[1:]), dtype)
            row_at += nr
        else:
            x = _from_bytes(rep_buf[rep_at:rep_at + nb], shape, dtype)
            rep_at += nb
        if slot in out:
            out[slot][name] = x
        else:
            out[slot] = x
    params = params_class(header["params_type"])(**out["params"])
    return params, out["day_all"], out.get("scale"), out["kw"]


def sharded_fit_forecast(
    batch: SeriesBatch,
    model: str = "prophet",
    config=None,
    horizon: int = 90,
    mesh=None,
    generator: Optional[torch.Generator] = None,
    min_points: int = DEFAULT_MIN_POINTS,
    xreg=None,
) -> Tuple[object, ForecastResult]:
    """Mesh-sharded ``engine.fit_forecast``: this rank fits and forecasts
    its block of the padded batch with the port's single-device
    ``fit_forecast``.  Returns the block's params and
    :class:`ForecastResult` (padding rows have ``ok=False``); the ranks'
    results concatenated in rank order are the reference's global result.

    ``xreg`` follows the batch: per-series tensors take the rank's block,
    shared calendars are replicated.  ``generator``: this rank's draws,
    where the family draws (the reference folds one key over the global
    rows; the port's draws are held by distribution, ``utils/rng.py``).
    """
    if mesh is None:
        raise ValueError("pass a mesh (parallel.make_mesh())")
    fns = get_model(model)
    cfg = config if config is not None else fns.config_cls()
    xreg = validate_xreg(fns, model, cfg, xreg, batch.n_time + horizon,
                         "sharded_fit_forecast")
    local = shard_batch(batch, mesh)
    if xreg is not None:
        xreg = _shard_xreg(xreg, batch.n_series, mesh)
    return fit_forecast(local, model=model, config=cfg, horizon=horizon,
                        min_points=min_points, xreg=xreg,
                        generator=generator)


def global_metric_means(per_series: Dict[str, torch.Tensor], ok: torch.Tensor,
                        mesh) -> Dict[str, torch.Tensor]:
    """Mesh-wide means of per-series metrics over healthy series only.

    Each rank passes its own rows (``per_series`` values and ``ok`` of one
    length; padding rows carry ``ok=False`` and are left out).  One
    all-reduce of the stacked (sums, count) replaces the reference's
    ``psum``; every rank returns the same means.
    """
    names = sorted(k for k in per_series if not k.startswith("_"))
    vals = torch.stack([torch.as_tensor(per_series[k]) for k in names])
    w = ok.to(device=vals.device, dtype=vals.dtype)[None, :]
    local = torch.cat([torch.sum(vals * w, dim=1), torch.sum(w, dim=1)])
    total = all_reduce_sum(local, mesh_group(mesh))
    means = total[:-1] / torch.clamp_min(total[-1], 1.0)
    return {k: means[i] for i, k in enumerate(names)}


def sharded_cv_metrics(
    batch: SeriesBatch,
    model: str = "prophet",
    config=None,
    cv=None,
    mesh=None,
    generator: Optional[torch.Generator] = None,
    xreg=None,
) -> Dict[str, torch.Tensor]:
    """Rolling-origin CV with the series axis sharded: this rank fits and
    scores its block for every cutoff with the port's CV pass
    (``engine/cv``: the cutoffs folded into one fit), and returns its rows
    of the reference's per-series means — the metric set of
    ``cross_validate`` (mse, rmse, mae, mape, smape, mdape, coverage and
    MASE at the cadence's naive lag) — trimmed as the reference trims to
    the unsharded series count (a rank holding only padding returns empty
    rows), plus ``"_n_cutoffs"``.  Ready for :func:`global_metric_means`.

    ``generator``: this rank's draws, explicit, where the reference folds
    its key with the device's index on the mesh axis; ``None`` seeds one
    with this rank's index (``0`` on a one-rank mesh, as ``cross_validate``
    seeds).  The families that run on the card draw nothing in the CV
    pass, so this changes no number there.

    ``xreg`` (history-grid regressor values, a longer tensor trimmed)
    shards like the batch: per-series by block, shared replicated.
    """
    from distributed_forecasting_tpu_torch.engine.cv import (
        CVConfig,
        _cv_entry,
        _cv_impl,
        cutoff_indices,
    )
    from distributed_forecasting_tpu_torch.ops.metrics import (
        seasonal_naive_lag,
    )
    from distributed_forecasting_tpu_torch.utils.rng import resolve_generator

    if mesh is None:
        raise ValueError("pass a mesh (parallel.make_mesh())")
    cv = cv or CVConfig()
    config, xreg = _cv_entry(batch, model, config, xreg,
                             "sharded_cv_metrics")
    orig_n = batch.n_series
    local = shard_batch(batch, mesh)
    if xreg is not None:
        xreg = _shard_xreg(xreg, orig_n, mesh)
    cuts = cutoff_indices(local.n_time, cv)
    if get_model(model).draws:
        generator = resolve_generator(generator, local.y.device,
                                      mesh_rank(mesh))
    out, _ = _cv_impl(local, model, config, cuts, cv.horizon, False,
                      seasonal_naive_lag(local.freq), xreg=xreg,
                      generator=generator)
    first, rows = _block(orig_n, mesh)
    keep = max(0, min(rows, orig_n - first))
    result = {k: v[:keep] for k, v in out.items() if not k.startswith("_")}
    result["_n_cutoffs"] = len(cuts)
    return result
