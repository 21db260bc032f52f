"""Fleet replica entrypoint: one serving process under the supervisor (port
of the reference's ``serving/replica.py``).

Launched by ``serving/fleet.py``'s default spawner as

    python -m distributed_forecasting_tpu_torch.serving.replica --conf '<json>'

The conf object carries: ``artifact_dir`` (the saved forecaster to load),
``host``/``port`` (the supervisor-assigned, restart-stable address),
``warmup_sizes``/``warmup_horizon``, optional ``batching``/``tracing``/
``http`` blocks (same shapes as the ``serving:`` conf), ``model_version``,
``mesh_devices``, an optional ``monitoring`` block (quality/store/SLO —
``monitoring/quality.py``; the replica suffixes the store directory with
its port so replicas never share an append cursor), an optional
``anomaly`` block (its stream directory suffixed the same way), an
optional ``cache`` block (the forecast cache, persisting by default under
``<artifact_dir>/forecast_cache/replica-<port>``), and an optional
``ingest`` block
(``serving/ingest.py``).  Unlike the quality store, the ingest WAL
directory is SHARED across the fleet: each replica appends ``O_APPEND``
whole lines and follows the log with its own cursor in ``interval`` apply
mode (the default in a fleet), so a point posted through any replica
converges into every owner's model state.

The replica runs on the card.  ``DFTPU_PLATFORM=cpu`` in its environment
(the fleet task sets it only when it was asked for the CPU) puts it on the
CPU; without it a replica that finds no card raises, and the supervisor's
restart backoff shows it — it never carries on on the CPU.  On the card
the kernel library is loaded at boot, before ``/readyz`` flips, through
the store ``DFTPU_COMPILE_CACHE`` names (the fleet's shared store: the
first boot builds with ``nvcc`` and stores, every later boot and restart
loads): a replica that cannot build or load it fails loudly.

With a ``sharding`` block plus a ``shards`` assignment list (sharded
fleets — ``serving/sharding.py``), the replica subsets its forecaster (a
row gather of its tensors on the card), history sidecar, and WAL
follow-set to the owned shards before warmup: resident series drop to
~S*owned/num_shards, only the owned ``wal_dir/shard-<k>/`` namespaces are
replayed, and the backlog replay happens BEFORE ``/readyz`` flips (the
supervisor's hand-off gate).

Boot order is the contract the supervisor routes on: load and subset to
the owned shards, build the forecast cache (it adopts its persisted
frames, then subscribes to state installs), bind the port with
``/readyz`` at 503, warm the bucket ladder, replay the owned WAL backlog
(an apply invalidates adopted frames), then flip ready — a replica never
receives traffic before it is warm and current.  The ready line logs the
boot's seconds by stage.  SIGTERM drains gracefully: /readyz flips to
503, queued requests finish, then the socket closes, and the drain line
logs the launch count of every hand kernel in the process.

Not here: ``mesh_devices > 1`` (a predict sharded over a device mesh
needs follower ranks that receive every request from the serving rank,
ROADMAP Queue 1: P12's second half, item 1.6) raises
``NotImplementedError``.  The thread sanitizer's ``attach`` is P13.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import time

_PENDING = "ROADMAP Queue 1: P12, second half"


def _history(artifact_dir: str):
    """The training-history sidecar (``history.npz``, arrays ``y`` /
    ``mask``) beside the artifact: in its directory, its ``forecaster/``
    subdirectory, or — for the ``forecaster/`` subdirectory of a
    registered version, which the fleet task passes — the version's own
    directory, where the serve task looks first.  ``(None, None)`` when
    there is none."""
    import numpy as np

    candidates = [os.path.join(artifact_dir, "history.npz"),
                  os.path.join(artifact_dir, "forecaster", "history.npz")]
    if os.path.basename(os.path.normpath(artifact_dir)) == "forecaster":
        candidates.append(os.path.join(
            os.path.dirname(os.path.normpath(artifact_dir)), "history.npz"))
    for cand in candidates:
        if os.path.exists(cand):
            with np.load(cand) as blob:
                return blob["y"], blob["mask"]
    return None, None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--conf", required=True,
                    help="JSON replica config (see module docstring)")
    args = ap.parse_args(argv)
    conf = json.loads(args.conf)
    t_boot = time.perf_counter()

    if int(conf.get("mesh_devices") or 0) > 1:
        raise NotImplementedError(
            f"mesh_devices={conf['mesh_devices']}: a replica's predict "
            f"sharded over a device mesh needs follower ranks fed by the "
            f"serving rank ({_PENDING}, item 1.6)")

    from distributed_forecasting_tpu_torch.engine.compile_cache import (
        cache_stats,
        enable_from_env,
    )
    from distributed_forecasting_tpu_torch.monitoring.quality import (
        build_quality_runtime,
    )
    from distributed_forecasting_tpu_torch.monitoring.trace import (
        TraceConfig,
        configure_tracing,
    )
    from distributed_forecasting_tpu_torch.serving.batcher import (
        BatchingConfig,
    )
    from distributed_forecasting_tpu_torch.serving.dataplane import HttpConfig
    from distributed_forecasting_tpu_torch.serving.forecast_cache import (
        CacheConfig,
        build_forecast_cache,
    )
    from distributed_forecasting_tpu_torch.serving.loader import (
        load_forecaster,
    )
    from distributed_forecasting_tpu_torch.serving.server import start_server
    from distributed_forecasting_tpu_torch.utils.device import (
        platform_device,
        resolve_device,
    )
    from distributed_forecasting_tpu_torch.utils.logging import get_logger

    logger = get_logger("fleet-replica")
    port = int(conf["port"])
    # every block is parsed before any tensor loads: a typo'd key kills
    # the replica at boot instead of silently serving defaults
    batching = BatchingConfig.from_conf(conf.get("batching"))
    http = HttpConfig.from_conf(conf.get("http"))
    CacheConfig.from_conf(conf.get("cache"))

    device = resolve_device(platform_device())  # the card unless asked
    stages = {}
    enable_from_env()  # DFTPU_COMPILE_CACHE: the store all replicas share
    if device.type == "cuda":
        from distributed_forecasting_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.library()
        stages["library"] = time.perf_counter() - t0

    tracing_conf = conf.get("tracing")
    trace_dir = os.environ.get("DFTPU_TRACE_DIR")
    if tracing_conf is None and trace_dir:
        # conf-less trace activation: per-replica JSONL streams and
        # flight-recorder dumps land in one directory
        tracing_conf = {
            "enabled": True,
            "jsonl_path": os.path.join(
                trace_dir, f"replica-{port}.trace.jsonl"),
            "dump_dir": trace_dir,
        }
    configure_tracing(TraceConfig.from_conf(tracing_conf))

    t0 = time.perf_counter()
    forecaster = load_forecaster(conf["artifact_dir"], device=device)
    stages["load"] = time.perf_counter() - t0

    # -- series partition (serving/sharding.py) -----------------------------
    # The supervisor hands each replica its shard assignment at spawn; the
    # replica subsets params/keys/scales to those shards BEFORE warmup, so
    # resident memory and every forecast/update is ~S*owned/num_shards.
    shards = conf.get("shards")
    sharding_cfg = None
    shard_metrics = None
    owned_idx = None
    if conf.get("sharding") and shards is not None:
        from distributed_forecasting_tpu_torch.serving.predictor import (
            BatchForecaster,
        )
        from distributed_forecasting_tpu_torch.serving.sharding import (
            ShardingConfig,
            ShardMetrics,
            subset_for_shards,
        )

        cfg = ShardingConfig.from_conf(conf["sharding"])
        if isinstance(forecaster, BatchForecaster):
            forecaster, owned_idx = subset_for_shards(
                forecaster, shards, cfg.num_shards)
            sharding_cfg = cfg
            shard_metrics = ShardMetrics()
            shard_metrics.observe_assignment(
                forecaster.keys, shards, cfg.num_shards)
            logger.info(
                "serving shards %s of %d: %d resident series",
                sorted(int(s) for s in shards), cfg.num_shards,
                int(forecaster.keys.shape[0]))
        else:
            # composite artifacts (ensemble/bucketed) don't subset yet;
            # serve the full set — the front door's routing is still
            # correct, just not memory-partitioned
            logger.warning(
                "%s cannot subset to a shard assignment; serving the "
                "full series set", type(forecaster).__name__)

    mon_conf = conf.get("monitoring")
    quality = None
    if mon_conf:
        # every replica gets its OWN store subdirectory (segment cursors
        # are per-process state; two appenders in one directory would race
        # on rotation)
        mon_conf = dict(mon_conf)
        qs = dict(mon_conf.get("quality_store") or {})
        if qs.get("directory"):
            qs["directory"] = os.path.join(qs["directory"],
                                           f"replica-{port}")
            mon_conf["quality_store"] = qs
        quality = build_quality_runtime(
            mon_conf,
            forecaster,
            default_store_dir=os.path.join(
                conf["artifact_dir"], "quality_store", f"replica-{port}"),
        )
    ingest = None
    ingest_conf = conf.get("ingest")
    if ingest_conf:
        from distributed_forecasting_tpu_torch.serving.ingest import (
            build_ingest_runtime,
        )

        ingest_conf = dict(ingest_conf)
        if ingest_conf.get("apply_mode") is None:
            # fleet default: every replica FOLLOWS the shared WAL on an
            # interval — sync mode would only freshen the replica that
            # happened to receive the POST
            ingest_conf["apply_mode"] = "interval"
        # the training-history sidecar enables full refits; a sharded
        # replica keeps only its shards' rows
        history_y, history_mask = _history(conf["artifact_dir"])
        if history_y is not None and owned_idx is not None:
            history_y = history_y[owned_idx]
            history_mask = history_mask[owned_idx]
        wal_factory = None
        if sharding_cfg is not None:
            from distributed_forecasting_tpu_torch.serving.sharding import (
                ShardedWAL,
            )

            def wal_factory(wal_dir, max_segment_bytes):
                # per-shard namespaces under the SHARED wal_dir: this
                # replica appends anywhere (durability) but follows — and
                # therefore applies — only its owned shards
                return ShardedWAL(
                    wal_dir, shards, sharding_cfg.num_shards,
                    max_segment_bytes=max_segment_bytes,
                    on_read=shard_metrics.note_wal_read)

        ingest = build_ingest_runtime(
            ingest_conf,
            forecaster,
            history_y=history_y,
            history_mask=history_mask,
            quality=quality,
            default_wal_dir=os.path.join(conf["artifact_dir"], "ingest_wal"),
            device=device,
            wal_factory=wal_factory,
        )
        if ingest is not None:
            logger.info("streaming ingest: shared WAL at %s (%s mode)",
                        ingest.wal.directory, ingest.config.apply_mode)
    anomaly = None
    if conf.get("anomaly"):
        from distributed_forecasting_tpu_torch.serving.anomaly import (
            build_anomaly_runtime,
        )

        # per-replica stream directory for the same reason as the quality
        # store: segment cursors are per-process state
        anomaly = build_anomaly_runtime(
            conf["anomaly"],
            forecaster,
            default_store_dir=os.path.join(
                conf["artifact_dir"], "anomaly_stream", f"replica-{port}"),
        )
        if anomaly is not None:
            logger.info("anomaly scoring on: threshold=%.3f",
                        anomaly.threshold)
    cache = None
    if conf.get("cache"):
        # per-replica persistence directory: a sharded replica's frames
        # cover only its owned series, and two replicas must never adopt
        # each other's payloads
        cache = build_forecast_cache(
            conf["cache"],
            forecaster,
            default_mmap_dir=os.path.join(
                conf["artifact_dir"], "forecast_cache", f"replica-{port}"),
        )
        if cache is not None:
            logger.info("forecast cache on: %d persisted frame(s) adopted",
                        int(cache.metrics.loads.value))
    srv = start_server(
        forecaster,
        host=conf.get("host", "127.0.0.1"),
        port=port,
        model_version=conf.get("model_version"),
        batching=batching,
        ready=False,  # warm first; the supervisor routes on /readyz
        quality=quality,
        ingest=ingest,
        anomaly=anomaly,
        extra_metrics=shard_metrics,
        cache=cache,
        http=http,
    )
    sizes = conf.get("warmup_sizes")
    if sizes:
        t0 = time.perf_counter()
        n = forecaster.warmup(
            horizon=int(conf.get("warmup_horizon", 90)),
            sizes=[int(s) for s in sizes],
        )
        stages["warmup"] = time.perf_counter() - t0
        logger.info("warmed %d bucket(s)", n)
    if ingest is not None:
        # hand-off gate: replay the WAL backlog (a sharded replica: its
        # shards' logs) BEFORE /readyz flips, so a restarted owner never
        # serves forecasts that predate writes the fleet already accepted
        t0 = time.perf_counter()
        replay = ingest.poll_apply()
        stages["replay"] = time.perf_counter() - t0
        if replay.get("accepted"):
            logger.info("replayed WAL backlog before ready: %s", replay)
    srv.mark_ready()
    stats = cache_stats()
    logger.info(
        "replica ready on %s:%d on %s in %.3fs (%s; compile cache %d "
        "hit(s), %d miss(es))", conf.get("host", "127.0.0.1"),
        port, device, time.perf_counter() - t_boot,
        ", ".join(f"{k} {v:.3f}s" for k, v in stages.items()),
        stats["hits"], stats["misses"])

    stop = threading.Event()

    def _drain(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    stop.wait()
    logger.info("draining replica on port %d", port)
    srv.shutdown()  # /readyz -> 503, batcher drains, accept loop stops
    srv.server_close()
    logger.info("replica on port %d drained; hand-kernel launches in this "
                "process: %s", port, json.dumps(_launches()))


def _launches() -> dict:
    """The launch counter of every hand kernel's wrapper in this process
    (each counts where it launches its kernel on the card)."""
    from distributed_forecasting_tpu_torch.ops import fused_scan, kalman

    return {name: getattr(mod, name).launches for mod, names in (
        (fused_scan, ("hw_score", "hw_filter")),
        (kalman, ("arima_filter", "arima_predict", "arima_loglik_grad",
                  "arima_mle_fit"))) for name in names}


if __name__ == "__main__":
    main()
