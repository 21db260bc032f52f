"""Batched inference model: one artifact for all series, one forecast per
request (port of the reference's ``serving/predictor.py`` core).

:class:`BatchForecaster` holds the fitted parameters of every series plus the
key table; ``predict`` selects the requested series by key, gathers their
parameter rows and runs one batched forecast on the parameters' device.
Unknown keys raise (or are skipped).  The artifact directory has the
reference's layout — ``params.npz``, ``forecaster.json`` and an optional
``interval_scale.npy`` — so artifacts load in either package.

Streaming ingest (``serving/ingest.py``) installs new filter state through
:meth:`BatchForecaster.swap_state`: ``(params, day1)`` change together under
one lock, and every predict reads them through one snapshot, so a request
sees the whole old state or the whole new one.

Each predict is a ``serving.predict`` / ``serving.predict_quantiles`` span
(``monitoring/trace.py``) around a dispatch annotated with its entry name
(``serving_predict:<model>``, the profiler's marker) and run through
``engine/compile_cache.aot_call``; the host interval from dispatch through
the ``.cpu()`` pulls is its ``device_seconds``, charged with the bucket's
padding rows to the cost registry (``monitoring/cost.py``).  Nothing
synchronizes the device: the pulls wait on this stream's work only.

**Mesh predict** (:meth:`BatchForecaster.enable_mesh`).  The reference's
predict spans a mesh from one controller; here the serving rank (rank 0 of
a replica's own ``torch.distributed`` group, ``serving/replica.py``) holds
the forecaster and the other ranks run :func:`serve_mesh_followers`, holding
no forecast state.  A dispatch takes one state snapshot, pads the request
to a bucket that is a multiple of the mesh size, sends a small header
(model, config, grid, trims), sends each rank its block of the gathered
rows (``parallel.shard_forecast_inputs``), and every rank runs the family's
single-device forecast on its block and applies the per-row time trims and
interval scale (:func:`_block_outputs`, the single-device path's own);
the serving rank all-gathers the kept rows and encodes them exactly as a
single-device predict does, so the bodies are byte-equal.  Every
dispatch's collectives run under ``_mesh_lock``: warmup, the coalescer, the
forecast cache's writer thread and a refit's republish all predict, and
the ranks must see one dispatch's messages at a time.  A block that raises
(a malformed request raises on every rank) still takes part in the gather,
flagged, so the ranks stay in step: the serving rank raises the error to
the caller and the followers log it and serve on.  Only row-independent
forecasters have a mesh predict: not one with Monte-Carlo intervals
(``coalesce_safe`` False) and not the composites.

The thread sanitizer (``monitoring/sanitizer.py``, a no-op unless armed)
guards ``(params, day1)``, the state generation and the listener table with
``_state_lock``, and records ``_mesh_lock``'s order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.convert import (
    params_class,
    params_from_numpy,
    params_to_numpy,
    params_type_name,
)
from distributed_forecasting_tpu_torch.data.tensorize import ordinals_to_dates
from distributed_forecasting_tpu_torch.engine.calibrate import apply_interval_scale
from distributed_forecasting_tpu_torch.engine.compile_cache import aot_call
from distributed_forecasting_tpu_torch.models import get_model
from distributed_forecasting_tpu_torch.models.base import generator_kwargs
from distributed_forecasting_tpu_torch.monitoring import sanitizer
from distributed_forecasting_tpu_torch.monitoring.cost import cost_metrics
from distributed_forecasting_tpu_torch.monitoring.trace import clock as trace_clock
from distributed_forecasting_tpu_torch.monitoring.trace import (
    device_annotation,
    get_tracer,
)
from distributed_forecasting_tpu_torch.utils.config import freeze, to_jsonable
from distributed_forecasting_tpu_torch.utils.device import resolve_device
from distributed_forecasting_tpu_torch.utils.logging import get_logger

_PARAMS_FILE = "params.npz"
_META_FILE = "forecaster.json"
_SCALE_FILE = "interval_scale.npy"


def save_params_npz(path: str, params) -> str:
    """Write a param dataclass as one ``.npz`` of its fields; returns the
    ``params_type`` string to record beside it."""
    np.savez(path, **params_to_numpy(params))
    return params_type_name(params)


def load_params_npz(path: str, params_type: str, device=None):
    """Rebuild a param dataclass from its ``.npz`` on ``device``; the
    recorded ``params_type`` is looked up in ``convert.PARAMS_TYPES``."""
    cls = params_class(params_type)
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    return params_from_numpy(cls, fields, device)


def _device_of(params) -> torch.device:
    """The device a param dataclass lives on (its first field's)."""
    return getattr(params, dataclasses.fields(params)[0].name).device


class UnknownSeriesError(KeyError):
    pass


def quantile_columns(quantiles) -> list:
    """Column names for quantile result frames (``q0.1``, ``q0.5``, ...)."""
    return [f"q{float(q):g}" for q in quantiles]


def _ladder_value(k: int) -> int:
    """Smallest pow2x3 ladder value >= k: 1, 2, 3, 4, 6, 8, 12, 16, 24, ...
    (request sizes round up to these, so a server sees O(log S) shapes)."""
    if k <= 1:
        return 1
    p = 1 << (k - 1).bit_length()
    three_quarters = 3 * (p >> 2)
    return three_quarters if three_quarters >= k else p


def _bucket_ladder(sizes) -> tuple:
    """Every pow2x3 request bucket up to the largest requested size:
    (1, 2, 3, 4, 6, ..., bucket(max(sizes))).  A composite forecaster
    splits a request across its members by series, so a listed size can
    reach a member as any smaller sub-request."""
    top_bucket = _ladder_value(max(max(int(k), 1) for k in sizes))
    ladder, b = [], 1
    while b <= top_bucket:
        ladder.append(b)
        if 3 * (b >> 1) > b:  # the 3 * 2^(i-1) rung between b and 2b
            ladder.append(3 * (b >> 1))
        b <<= 1
    return tuple(v for v in ladder if v <= top_bucket)


def _mesh_size(mesh) -> int:
    """Ranks along the mesh's series axis."""
    from distributed_forecasting_tpu_torch.parallel.mesh import mesh_size

    return int(mesh_size(mesh))


def _kept_steps(header: dict) -> int:
    """Time steps a dispatch's response keeps (after the grid's padding
    rows and, without ``include_history``, the history are trimmed)."""
    kept = min(header["n_real"], header["t_grid"])
    return kept if header["include_history"] else header["horizon"]


def _block_outputs(fns, header: dict, params, day_all, scale, fc_kwargs,
                   gen_kwargs: dict) -> torch.Tensor:
    """One dispatch's forecast of ``params``' rows with the per-row
    finishing a response needs: the time-bucket padding trimmed, the
    interval scale applied, the history trimmed.  Returns (rows, 3, T_keep)
    (``yhat``, ``yhat_upper``, ``yhat_lower``) for a point predict, (rows,
    Q, T_keep) for quantiles.  Every operation works row by row, so a block
    of a bucket gives the bucket's rows bit for bit: the single-device
    predict runs it on the whole bucket, each rank of a mesh on its block."""
    n_real, t_end, config = header["n_real"], header["t_end"], header["config"]
    horizon = header["horizon"]
    if header["op"] == "predict":
        yhat, lo, hi = aot_call(
            header["entry"], fns.forecast, args=(params, day_all, t_end),
            static_kwargs={"config": config},
            dynamic_kwargs={**fc_kwargs, **gen_kwargs}, charge=False)
        if n_real < int(day_all.shape[0]):
            # the time-bucket padding rows go BEFORE the history trim, so
            # [-horizon:] ends on the real last day
            yhat, lo, hi = (yhat[:, :n_real], lo[:, :n_real],
                            hi[:, :n_real])
        yhat, lo, hi = apply_interval_scale(yhat, lo, hi, scale,
                                            floor=fns.band_floor)
        out = torch.stack([yhat, hi, lo], dim=1)
    else:
        priced, quantiles = header["priced"], header["quantiles"]
        out = fns.forecast_quantiles(params, day_all, t_end, config, priced,
                                     **fc_kwargs, **gen_kwargs)
        # (rows, Q, T_all)
        if n_real < int(day_all.shape[0]):
            out = out[:, :, :n_real]
        if scale is not None:
            med = out[:, priced.index(0.5), :][:, None, :]
            out = med + scale[:, None, None] * (out - med)
            if fns.band_floor is not None:
                # widening must not undo the family's clamp of the levels
                out = torch.clamp_min(out, fns.band_floor)
        if priced != quantiles:
            out = out[:, [priced.index(q) for q in quantiles], :]
    if not header["include_history"]:
        out = out[:, :, -horizon:]
    return out


def _send_header(mesh, header: dict) -> dict:
    """The serving rank's dispatch header to every rank of ``mesh`` (pass
    ``None`` on the others); returns it on every rank."""
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.parallel.mesh import mesh_group

    group = mesh_group(mesh)
    box = [header]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def _gather_blocks(mesh, fns, header: dict, params, day_all, scale,
                   fc_kwargs, gen_kwargs: dict) -> tuple:
    """One dispatch over ``mesh`` after its header (:func:`_send_header`),
    run on every rank in the same order: the rank's block of the inputs,
    the block's outputs, and one all-gather of every rank's kept rows in
    rank order, each rank's rows followed by a flag that says whether its
    forecast raised.  A rank whose forecast raises still takes part in the
    gather (zeros of the agreed shape), so the ranks stay in step.

    Returns ``(rows, fault, failed)``: the bucket's kept rows, this rank's
    exception or None, and the ranks whose forecast raised.  An error of a
    collective itself propagates: the ranks are then out of step."""
    from distributed_forecasting_tpu_torch.parallel.mesh import (
        all_gather_rows,
        mesh_device,
        mesh_group,
    )
    from distributed_forecasting_tpu_torch.parallel.sharded import (
        shard_forecast_inputs,
    )

    params, day_all, scale, fc_kwargs = shard_forecast_inputs(
        params, day_all, scale, fc_kwargs, mesh, header["bucket"])
    fault = None
    try:
        block = _block_outputs(fns, header, params, day_all, scale,
                               fc_kwargs, gen_kwargs)
    except Exception as e:  # noqa: BLE001 — reported after the gather
        fault = e
        width = 3 if header["op"] == "predict" else len(header["quantiles"])
        block = torch.zeros(
            (header["bucket"] // _mesh_size(mesh), width,
             _kept_steps(header)), dtype=torch.float32,
            device=mesh_device(mesh))
    flag = block.new_full((1,), float(fault is not None))
    out = all_gather_rows(torch.cat([block.reshape(-1), flag]),
                          mesh_group(mesh)).view(_mesh_size(mesh), -1)
    failed = torch.nonzero(out[:, -1]).flatten().tolist()
    rows = out[:, :-1].reshape((-1,) + tuple(block.shape[1:]))
    return rows, fault, failed


def _mesh_dispatch(mesh, fns, header: dict, params, day_all, scale,
                   fc_kwargs, gen_kwargs: dict) -> torch.Tensor:
    """The serving rank's side of :func:`_gather_blocks`: the bucket's kept
    rows, or the error of its own block (the request's, as on one device),
    or an error naming the follower ranks whose block raised."""
    rows, fault, failed = _gather_blocks(mesh, fns, header, params, day_all,
                                         scale, fc_kwargs, gen_kwargs)
    if fault is not None:
        raise fault
    if failed:
        raise RuntimeError(
            f"mesh rank(s) {failed} raised on their block of this dispatch "
            f"(see their log); the ranks stay in step")
    return rows


def serve_mesh_followers(mesh, report=None) -> int:
    """A follower rank's loop (ranks 1 .. D - 1 of a replica's mesh): block
    on the serving rank's next header, run the same family forecast on this
    rank's block of the inputs, send the kept rows, and repeat until the
    stop message (:meth:`BatchForecaster.stop_mesh`).  The rank holds no
    forecast state: every dispatch's parameter rows come from the serving
    rank's one snapshot.  A block that raises (a malformed request raises
    on every rank) is logged and the loop goes on: the gather kept the
    ranks in step, and the serving rank answers the request with the
    error.  On the stop message every rank sends ``report()`` (this rank's
    hand-kernel launch counts, for the replica's drain line) to every
    other.  Returns the dispatches served, failed ones included."""
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.parallel.mesh import (
        mesh_group,
        mesh_rank,
    )

    served = 0
    while True:
        header = _send_header(mesh, None)
        if header["op"] == "stop":
            reports = [None] * dist.get_world_size(mesh_group(mesh))
            dist.all_gather_object(reports, report() if report else {},
                                   group=mesh_group(mesh))
            return served
        _, fault, _ = _gather_blocks(mesh, get_model(header["model"]),
                                     header, None, None, None, None, {})
        if fault is not None:
            get_logger("BatchForecaster").error(
                "mesh rank %d: its block of a %s dispatch (%s) raised %r; "
                "serving on", mesh_rank(mesh), header["op"], header["entry"],
                fault)
        served += 1


def mesh_refusal(forecaster) -> Optional[str]:
    """Why ``forecaster`` has no mesh predict, or None when it has one: a
    composite (ensemble, bucketed) reorders rows by member, and a forecaster
    with Monte-Carlo intervals draws each series' paths beside the others'
    (``coalesce_safe``)."""
    if not isinstance(forecaster, BatchForecaster):
        return "a composite: its members reorder the rows"
    if not forecaster.coalesce_safe:
        return ("Monte-Carlo intervals: a series' draws depend on the rows "
                "beside it")
    return None


def result_block_index(out: pd.DataFrame, key_names) -> tuple:
    """``(T, {key tuple: block index})`` for a long predict result frame.

    Every serving predict returns one contiguous ``T``-row block per series
    (``_frame_skeleton`` tiles the dates per series); the micro-batching
    coalescer (``serving/batcher.py``) scatters a merged result back with
    this map: request ``r``'s rows are its keys' blocks concatenated in
    ``r``'s own first-occurrence order, which is what a solo ``predict(r)``
    returns.
    """
    uniq = out[list(key_names)].drop_duplicates()
    n = len(uniq)
    if n == 0:
        return 0, {}
    T = len(out) // n
    return T, {tuple(row): i for i, row in enumerate(uniq.itertuples(index=False))}


class BatchForecaster:
    """Loads once, predicts every requested series in one batched call."""

    # predict / predict_quantiles return request-order T-row blocks per
    # series that are BIT-IDENTICAL whatever the request's size bucket: every
    # family's forecast works row by row, with no sum across series and no
    # library call whose algorithm depends on the row count (the curve
    # model's design product, models/base.design_product; the
    # cumulative sums, models/base.cumsum_rows; arnet's contractions over a
    # leading axis).  The serving coalescer merges concurrent requests only
    # for forecasters that declare it; composites (ensemble, bucketed)
    # reorder rows by member and do not.  An instance with Monte-Carlo
    # intervals does not either (``__init__``): a series' draws depend on
    # the rows drawn beside it.
    coalesce_safe = True

    def __init__(
        self,
        model: str,
        config,
        params,
        keys: np.ndarray,
        key_names: tuple,
        day0: int,
        day1: int,
        interval_scale: Optional[np.ndarray] = None,
        freq: str = "D",
    ):
        self.model = model
        self.config = config
        self.params = params
        self.keys = np.asarray(keys)
        self.key_names = tuple(key_names)
        self.day0 = int(day0)  # first training period ordinal
        self.day1 = int(day1)  # last training period ordinal
        self.freq = str(freq)
        if getattr(config, "uncertainty_samples", 0) > 0:
            self.coalesce_safe = False
        # (S,) per-series conformal band scale, applied to both half-bands
        self.interval_scale = (
            None if interval_scale is None
            else np.asarray(interval_scale, dtype=np.float32)
        )
        if self.interval_scale is not None and (
            self.interval_scale.shape != (self.keys.shape[0],)
        ):
            raise ValueError(
                f"interval_scale must be ({self.keys.shape[0]},) — one scale "
                f"per trained series — got {self.interval_scale.shape}"
            )
        self._index = {tuple(k): i for i, k in enumerate(self.keys.tolist())}
        # streaming state swap (serving/ingest): _state_lock makes (params,
        # day1) one unit; held only for the swap and the snapshot, never
        # across device work or I/O
        self._state_lock = threading.Lock()
        # install counter: every swap_state bumps it, so derived data can
        # tell the state it was computed from apart from a newer one;
        # listeners run after the swap, outside the lock
        self._state_gen = 0
        self._state_listeners: list = []
        # time-grid bucket (engine/state_store sets it when streaming is
        # attached): the predict grid's history end pads up to a multiple
        # of this many days and the padded rows are trimmed before they
        # are served; 1 is the exact grid
        self.time_bucket = 1
        # the mesh every predict shards its series axis over (enable_mesh),
        # or None; _mesh_lock holds one dispatch's collectives together
        self._mesh = None
        self._mesh_lock = threading.Lock()
        # dftsan (no-op unless DFTPU_TSAN armed): the atomic state unit plus
        # the generation counter and listener table swap_state mutates;
        # the mesh lock's order is recorded
        sanitizer.attach(self, cls=BatchForecaster, guards={
            "_state_lock": ("params", "day1", "_state_gen",
                            "_state_listeners")}, locks=("_mesh_lock",))

    @property
    def device(self) -> torch.device:
        return _device_of(self._state_snapshot()[0])

    @property
    def n_series(self) -> int:
        return int(self.keys.shape[0])

    @property
    def family(self) -> str:
        """The registry's ``model_family`` tag (the deploy task sets it)."""
        return self.model

    @property
    def serving_schema(self) -> str:
        return (
            "ds date, "
            + ", ".join(f"{k} int" for k in self.key_names)
            + ", yhat double, yhat_upper double, yhat_lower double"
        )

    # -- construction / persistence ------------------------------------------
    @classmethod
    def from_fit(cls, batch, params, model: str, config,
                 interval_scale=None) -> "BatchForecaster":
        day0, day1 = batch.day[[0, -1]].tolist()
        return cls(model=model, config=config, params=params, keys=batch.keys,
                   key_names=batch.key_names, day0=day0, day1=day1,
                   interval_scale=interval_scale, freq=batch.freq)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        # one (params, day1) unit: a save racing a streaming apply must not
        # write new params beside an old day1
        params, day1 = self._state_snapshot()
        params_type = save_params_npz(os.path.join(directory, _PARAMS_FILE),
                                      params)
        scale_path = os.path.join(directory, _SCALE_FILE)
        if self.interval_scale is not None:
            np.save(scale_path, self.interval_scale)
        elif os.path.exists(scale_path):
            # a reused directory must not keep a previous run's scales
            os.remove(scale_path)
        meta = {
            "params_type": params_type,
            "model": self.model,
            "config": dataclasses.asdict(self.config),
            "key_names": list(self.key_names),
            "keys": self.keys.tolist(),
            "day0": self.day0,
            "day1": day1,
            "freq": self.freq,
            "serving_schema": self.serving_schema,
        }
        with open(os.path.join(directory, _META_FILE), "w") as f:
            json.dump(meta, f, indent=2,
                      default=lambda x: to_jsonable(x, strict=True))

    @classmethod
    def load(cls, directory: str, device=None) -> "BatchForecaster":
        """Load an artifact directory (written by this package or by the
        reference) onto ``device`` (``cuda`` unless the caller asks for
        the CPU)."""
        dev = resolve_device(device)
        with open(os.path.join(directory, _META_FILE)) as f:
            meta = json.load(f)
        params = load_params_npz(os.path.join(directory, _PARAMS_FILE),
                                 meta["params_type"], dev)
        fns = get_model(meta["model"])
        config = fns.config_cls(
            **{k: freeze(v) for k, v in meta["config"].items()}
        )
        scale_path = os.path.join(directory, _SCALE_FILE)
        interval_scale = np.load(scale_path) if os.path.exists(scale_path) else None
        return cls(
            model=meta["model"], config=config, params=params,
            keys=np.asarray(meta["keys"], dtype=np.int64),
            key_names=tuple(meta["key_names"]), day0=meta["day0"],
            day1=meta["day1"], interval_scale=interval_scale,
            freq=meta.get("freq", "D"),
        )

    # -- inference -------------------------------------------------------------
    def series_indices(self, request: pd.DataFrame,
                       on_missing: str = "raise") -> np.ndarray:
        """Row of every requested series, in first-occurrence order."""
        if on_missing not in ("raise", "skip"):
            raise ValueError(
                f"on_missing must be 'raise' or 'skip', got {on_missing!r}"
            )
        cols = [np.asarray(request[name].to_numpy()) for name in self.key_names]
        idx, seen = [], set()
        for i in range(len(request)):
            key = tuple(int(c[i]) for c in cols)
            if key in seen:
                continue
            seen.add(key)
            if key in self._index:
                idx.append(self._index[key])
            elif on_missing == "raise":
                raise UnknownSeriesError(
                    f"series {dict(zip(self.key_names, key))} was not in the "
                    f"training set ({len(self._index)} known series)"
                )
        return np.asarray(idx, dtype=np.int64)

    # -- streaming state ------------------------------------------------------
    def swap_state(self, params=None, day1: Optional[int] = None) -> None:
        """Install new filter state: the streaming apply's and the refit's
        commit point.  ``params`` (when given) is a param dataclass of the
        same type; ``day1`` moves the last observed day the forecast grid
        ends at.  A concurrent predict sees the whole old state or the whole
        new one (:meth:`_state_snapshot`).  Every install bumps the state
        generation, then calls the registered listeners outside the lock."""
        with self._state_lock:
            if params is not None:
                self.params = params
            if day1 is not None:
                self.day1 = int(day1)
            self._state_gen += 1
            listeners = tuple(self._state_listeners)
        for fn in listeners:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a listener must not fail the write
                get_logger("BatchForecaster").exception(
                    "state listener failed (state swap itself committed)")

    def register_state_listener(self, fn) -> None:
        """Call ``fn()`` after every committed :meth:`swap_state`, on the
        writer's thread, outside the state lock."""
        with self._state_lock:
            self._state_listeners.append(fn)

    def state_generation(self) -> int:
        """The install counter (0 until the first :meth:`swap_state`)."""
        with self._state_lock:
            return self._state_gen

    def _state_snapshot(self):
        """``(params, day1)`` as one consistent unit; see
        :meth:`swap_state`."""
        with self._state_lock:
            return self.params, self.day1

    def _state_snapshot_versioned(self):
        """``(params, day1, generation)`` as one consistent unit: the
        forecast cache's read form (``serving/forecast_cache.py``), so a
        derived frame is tagged with exactly the generation its state
        belongs to."""
        with self._state_lock:
            return self.params, self.day1, self._state_gen

    def gather_params(self, sidx: np.ndarray, params=None):
        """Row-gather the requested series out of the parameters: fields
        whose leading axis is the series axis are indexed, others (0-d
        fields such as the curve model's ``t0``/``t1``, its empty (0, 0)
        regressor and AR fields) pass.  ``params`` overrides the installed
        state (a request passes its own snapshot)."""
        S = self.n_series
        if params is None:
            params, _ = self._state_snapshot()
        take = torch.as_tensor(sidx, dtype=torch.long,
                               device=_device_of(params))
        return type(params)(**{
            f.name: (v[take] if v.dim() >= 1 and v.shape[0] == S else v)
            for f in dataclasses.fields(params)
            for v in (getattr(params, f.name),)
        })

    # -- mesh-parallel predict ------------------------------------------------
    @property
    def mesh(self):
        """The mesh predict shards over, or None (single-device)."""
        # dflint: disable=unlocked-shared-state — one reference read
        return self._mesh

    def enable_mesh(self, mesh) -> None:
        """Shard every predict's series axis over ``mesh``, from its rank 0
        (the serving rank; ranks 1 .. D - 1 run :func:`serve_mesh_followers`).

        Request buckets round up to mesh multiples (:meth:`_bucket`), and
        each dispatch runs over the mesh (the module docstring).  The output
        is byte-identical to the single-device predict: forecasts are
        per-series independent, so the blocks change placement, not math.
        Warmup goes through the same bucketing and the same dispatch.  A
        forecaster with Monte-Carlo intervals is refused: its draws depend
        on the rows drawn beside it (``coalesce_safe``)."""
        from distributed_forecasting_tpu_torch.parallel.mesh import mesh_rank

        refusal = mesh_refusal(self)
        if refusal is not None:
            raise ValueError(f"{self.model!r} has no mesh predict "
                             f"({refusal}); serve it on one device")
        if _mesh_size(mesh) < 1:
            raise ValueError("mesh has no devices")
        if mesh_rank(mesh) != 0:
            raise ValueError(
                "the serving rank is rank 0 of the mesh; the other ranks "
                "run serve_mesh_followers")
        # under _mesh_lock like stop_mesh's flip: a dispatch in flight
        # finishes on the mesh it started on
        with self._mesh_lock:
            self._mesh = mesh

    def disable_mesh(self) -> None:
        """Back to single-device predict (mesh-size-1 buckets).  The
        followers keep waiting for the next header: end them with
        :meth:`stop_mesh`.  Waits for a dispatch in flight to finish."""
        with self._mesh_lock:
            self._mesh = None

    def stop_mesh(self) -> list:
        """Send the followers the stop message (they return from
        :func:`serve_mesh_followers`) and go back to single-device predict;
        returns each follower rank's report, in rank order.  Waits for a
        dispatch in flight to finish."""
        import torch.distributed as dist

        from distributed_forecasting_tpu_torch.parallel.mesh import mesh_group

        with self._mesh_lock:
            mesh, self._mesh = self._mesh, None
            if mesh is None:
                return []
            _send_header(mesh, {"op": "stop"})
            reports = [None] * dist.get_world_size(mesh_group(mesh))
            dist.all_gather_object(reports, {}, group=mesh_group(mesh))
        return reports[1:]

    def _bucket(self, k: int) -> int:
        """Request-size bucket: next pow2x3 ladder value, capped at S, then
        (with a mesh) rounded up to a mesh multiple so every rank gets a
        block of one size (the padding rows repeat the first series like
        any other bucket padding)."""
        bucket = max(min(_ladder_value(k), self.n_series), k)
        # one reference read: a bucket rounded for a mesh stays valid on one
        # device, and enable_mesh runs before traffic
        # dflint: disable=unlocked-shared-state — snapshot, see above
        mesh = self._mesh
        if mesh is not None:
            n = _mesh_size(mesh)
            bucket = ((bucket + n - 1) // n) * n
        return bucket

    def _aot_entry(self, kind: str) -> str:
        """The entry name of this forecaster's predict programs
        (``<kind>:<model>``, ``@mesh<n>`` appended over a mesh): the cost
        registry's row and the profiler annotation."""
        entry = f"{kind}:{self.model}"
        # dflint: disable=unlocked-shared-state — one reference read (a label)
        mesh = self._mesh
        if mesh is not None:
            entry += f"@mesh{_mesh_size(mesh)}"
        return entry

    def _dispatch(self, fns, header: dict, params, day_all, scale,
                  fc_kwargs, gen_kwargs: dict) -> torch.Tensor:
        """The bucket's kept outputs (:func:`_block_outputs`): on this
        device, or over the mesh under ``_mesh_lock``."""
        # dflint: disable=unlocked-shared-state — fast path; re-read under the lock
        if self._mesh is None:
            return _block_outputs(fns, header, params, day_all, scale,
                                  fc_kwargs, gen_kwargs)
        with self._mesh_lock:
            mesh = self._mesh
            if mesh is None:  # stopped meanwhile (the replica's drain)
                return _block_outputs(fns, header, params, day_all, scale,
                                      fc_kwargs, gen_kwargs)
            return _mesh_dispatch(mesh, fns, _send_header(mesh, header),
                                  params, day_all, scale, fc_kwargs,
                                  gen_kwargs)

    def _header(self, op: str, entry: str, bucket: int, day_all, t_end,
                n_real: int, horizon: int, include_history: bool,
                priced=None, quantiles=None) -> dict:
        """What every rank needs to run its block of one dispatch."""
        return {"op": op, "entry": entry, "model": self.model,
                "config": self.config, "t_end": float(t_end),
                "bucket": int(bucket), "n_real": int(n_real),
                "t_grid": int(day_all.shape[0]), "horizon": int(horizon),
                "include_history": bool(include_history),
                "priced": priced, "quantiles": quantiles}

    def _charge(self, entry: str, span, t_disp: float, k: int) -> None:
        """Charge one dispatch: the host interval since ``t_disp`` as its
        device seconds (on the span and in the cost registry) and the
        bucket's pad rows."""
        dev = trace_clock() - t_disp
        span.set_attribute("device_seconds", dev)
        cm = cost_metrics()
        cm.record_dispatch(entry, self.model, dev)
        bucket = self._bucket(k)
        cm.record_padding(entry, bucket, bucket - k)

    def _prepare_request(self, request, horizon, on_missing, xreg):
        """Resolve series, pad the request to its bucket (pad rows repeat
        the first series and are dropped by the caller), gather parameters,
        scales and regressor rows, and build the history + horizon day grid.
        Returns ``(sidx, params, day_all, fc_kwargs, scale, t_end,
        n_real)``: ``(params, t_end)`` come from one state snapshot, and
        ``n_real`` is the count of grid rows the caller keeps — with
        ``time_bucket > 1`` the history end pads up to a bucket multiple
        and the trailing rows are trimmed before any ``include_history``
        logic.

        ``xreg``: (T_all, R) shared or (S_trained, T_all, R) per series over
        the ``day0 .. day1 + horizon`` grid (or over the padded grid);
        per-series rows are gathered with the request's padded indices."""
        sidx = self.series_indices(request, on_missing=on_missing)
        if sidx.size == 0:
            return sidx, None, None, None, None, None, 0
        params_snap, day1_snap = self._state_snapshot()
        dev = _device_of(params_snap)
        span = day1_snap - self.day0 + 1
        if self.time_bucket > 1:
            b = int(self.time_bucket)
            span = ((span + b - 1) // b) * b
        n_real = day1_snap - self.day0 + horizon + 1
        bucket = self._bucket(int(sidx.size))
        padded = np.concatenate(
            [sidx, np.full(bucket - sidx.size, sidx[0], sidx.dtype)]
        )
        day_all = torch.arange(self.day0, self.day0 + span + horizon,
                               dtype=torch.int32, device=dev)
        scale = (None if self.interval_scale is None else torch.as_tensor(
            self.interval_scale[padded], device=dev))
        fc_kwargs = {}
        if xreg is not None:
            if not get_model(self.model).supports_xreg:
                raise ValueError(
                    f"model {self.model!r} does not accept exogenous "
                    f"regressors"
                )
            xreg = torch.as_tensor(xreg, dtype=torch.float32, device=dev)
            if xreg.dim() not in (2, 3):
                raise ValueError(
                    f"xreg must be (T_all, R) or (S_trained, T_all, R), got "
                    f"{xreg.dim()}-D"
                )
            T_grid = int(day_all.shape[0])
            if xreg.shape[-2] == n_real and n_real != T_grid:
                # time-bucketed grid: regressors cover the real rows; the
                # padded rows are trimmed from the output, never served
                xreg = torch.nn.functional.pad(
                    xreg, (0, 0, 0, T_grid - n_real))
            elif xreg.shape[-2] != T_grid:
                raise ValueError(
                    f"xreg time axis is {xreg.shape[-2]}, expected the full "
                    f"history+horizon grid {n_real}"
                )
            if xreg.dim() == 3:
                # a wrong leading dim would serve another series' covariates
                if xreg.shape[0] != self.n_series:
                    raise ValueError(
                        f"per-series xreg leads with {xreg.shape[0]} rows, "
                        f"expected all {self.n_series} trained series (rows "
                        f"are gathered down to the request internally)"
                    )
                xreg = xreg[torch.as_tensor(padded, dtype=torch.long,
                                            device=dev)]
            fc_kwargs["xreg"] = xreg
        return (sidx, self.gather_params(padded, params=params_snap),
                day_all, fc_kwargs, scale, day1_snap, n_real)

    @staticmethod
    def _kept_days(day_all, header: dict):
        """The day grid a dispatch's response keeps (:func:`_kept_steps`)."""
        day_all = day_all[:header["n_real"]]
        return day_all if header["include_history"] else \
            day_all[-header["horizon"]:]

    def _frame_skeleton(self, sidx, day_all):
        """ds + key columns for a long result frame over ``day_all``."""
        T = day_all.shape[0]
        dates = ordinals_to_dates(day_all.cpu().numpy().astype("int64"),
                                  self.freq)
        frame = {"ds": np.tile(dates.values, len(sidx))}
        for j, name in enumerate(self.key_names):
            frame[name] = np.repeat(self.keys[sidx, j], T)
        return frame

    def warmup(self, horizon: int = 90, sizes=(1,)) -> int:
        """Run one throwaway predict per distinct request bucket of
        ``sizes`` (clamped to the trained-series count) at this horizon, so
        first requests find the kernels built and the allocator warm.  A
        regressor model is warmed with a zero (T_all, R) calendar.  Returns
        the number of buckets run."""
        S = self.n_series
        buckets = sorted({self._bucket(min(max(int(k), 1), S)) for k in sizes})
        xreg = None
        R = getattr(self.config, "n_regressors", 0)
        if R:
            _, day1 = self._state_snapshot()
            T_all = day1 - self.day0 + horizon + 1
            xreg = torch.zeros((T_all, R), dtype=torch.float32,
                               device=self.device)
        for b in buckets:
            req = pd.DataFrame(self.keys[:b], columns=self.key_names)
            self.predict(req, horizon=horizon, xreg=xreg)
        return len(buckets)

    def predict(self, request: pd.DataFrame, horizon: int = 90,
                include_history: bool = False,
                on_missing: str = "raise", xreg=None,
                generator=None) -> pd.DataFrame:
        """Forecast every requested series ``horizon`` steps past the end of
        training.  ``request`` needs the key columns only.  ``xreg``: a
        regressor model's values over the full ``day0 .. day1 + horizon``
        grid, (T_all, R) shared or (S_trained, T_all, R) per series.
        ``generator``: the draws of Monte-Carlo intervals (``None`` seeds
        one with 0, the reference's default key)."""
        (sidx, params, day_all, fc_kwargs, scale, t_end,
         n_real) = self._prepare_request(request, horizon, on_missing, xreg)
        if sidx.size == 0:
            return pd.DataFrame(
                columns=["ds", *self.key_names, "yhat", "yhat_upper", "yhat_lower"]
            )
        fns = get_model(self.model)
        k = int(sidx.size)
        bucket = self._bucket(k)
        entry = self._aot_entry("serving_predict")
        header = self._header("predict", entry, bucket, day_all, t_end,
                              n_real, horizon, include_history)
        with get_tracer().span(
            "serving.predict", model=self.model, k=k,
            bucket=bucket, horizon=int(horizon),
        ) as span:
            # device-time attribution: the interval from dispatch through
            # the .cpu() pull below, on the span clock
            t_disp = trace_clock()
            # the annotation marks this dispatch on a profiler capture's
            # timeline, named like the entry
            with device_annotation(entry):
                out = self._dispatch(fns, header, params, day_all, scale,
                                     fc_kwargs,
                                     generator_kwargs(fns, generator))
            frame = self._frame_skeleton(sidx, self._kept_days(
                day_all, header))
            # the pull is the host's wait: inside the span, so device time
            # shows as serving.predict time
            out = out[:k].cpu().numpy()
            frame["yhat"] = out[:, 0].reshape(-1)
            frame["yhat_upper"] = out[:, 1].reshape(-1)
            frame["yhat_lower"] = out[:, 2].reshape(-1)
            self._charge(entry, span, t_disp, k)
            return pd.DataFrame(frame)

    def predict_quantiles(self, request: pd.DataFrame,
                          quantiles=(0.1, 0.5, 0.9), horizon: int = 90,
                          include_history: bool = False,
                          on_missing: str = "raise",
                          xreg=None, generator=None) -> pd.DataFrame:
        """Probabilistic forecast: one column per quantile level (``q0.1``,
        ``q0.5``, ...), priced from the predictive distribution the central
        interval uses.  ``xreg`` and ``generator`` as for :meth:`predict`."""
        fns = get_model(self.model)
        if fns.forecast_quantiles is None:
            raise ValueError(
                f"model {self.model!r} registered no quantile forecast "
                f"implementation"
            )
        quantiles = tuple(float(q) for q in quantiles)
        (sidx, params, day_all, fc_kwargs, scale, t_end,
         n_real) = self._prepare_request(request, horizon, on_missing, xreg)
        qcols = quantile_columns(quantiles)
        if sidx.size == 0:
            return pd.DataFrame(columns=["ds", *self.key_names, *qcols])
        k = int(sidx.size)
        bucket = self._bucket(k)
        entry = self._aot_entry("serving_predict_quantiles")
        # conformal scaling spreads every level around the median, so the
        # median is priced alongside when calibration is on
        priced = quantiles
        if scale is not None and 0.5 not in priced:
            priced = tuple(sorted((*priced, 0.5)))
        header = self._header("quantiles", entry, bucket, day_all, t_end,
                              n_real, horizon, include_history,
                              priced=priced, quantiles=quantiles)
        with get_tracer().span(
            "serving.predict_quantiles", model=self.model, k=k,
            bucket=bucket, horizon=int(horizon),
            n_quantiles=len(quantiles),
        ) as span:
            t_disp = trace_clock()
            with device_annotation(entry):
                yq = self._dispatch(fns, header, params, day_all, scale,
                                    fc_kwargs,
                                    generator_kwargs(fns, generator))
            yq = yq[:k].cpu().numpy()
            self._charge(entry, span, t_disp, k)
            frame = self._frame_skeleton(sidx, self._kept_days(
                day_all, header))
            for qi, col in enumerate(qcols):
                frame[col] = yq[:, qi, :].reshape(-1)
            return pd.DataFrame(frame)
