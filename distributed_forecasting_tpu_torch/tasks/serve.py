"""Serve task: registered model -> HTTP scoring endpoint (port of the
reference's ``tasks/serve.py``).

Resolves the latest (optionally stage-filtered) version from the registry,
loads its artifact once onto the task's device (``cuda`` unless
``DFTPU_PLATFORM=cpu``), warms the request-size buckets and serves
``/invocations`` (``serving/server.py``)::

    python -m distributed_forecasting_tpu_torch.tasks.serve \\
        --conf-file conf/tasks/serve_config.yml

Conf::

    serving:
      model_name: ForecastingBatchModel
      stage: Staging          # optional latest-version filter
      host: 0.0.0.0
      port: 8080
      warmup_sizes: [1, 8]    # run these request buckets before serving
      warmup_horizon: 90
      batching: {...}         # the micro-batching coalescer (strict)
      http: {...}             # the data plane (strict)
      tracing: {...}          # spans, flight recorder, /debug/*
                              # (monitoring/trace.py)
      anomaly: {...}          # POST /detect_anomalies (serving/anomaly.py)
      cache: {...}            # the forecast cache (serving/forecast_cache.py)
      ingest: {...}           # POST /ingest (serving/ingest.py): the WAL,
                              # default <env.root>/ingest_wal; refits need
                              # a history.npz sidecar beside the artifact
    monitoring:
      quality: {...}          # POST /observe (monitoring/quality.py)
      quality_store: {...}    # metric history (monitoring/store.py),
                              # default <env.root>/quality_store
      slo: {...}              # burn-rate SLOs (monitoring/slo.py) over the
                              # store, staleness from the env's tracking root
      cost: {...}             # dftpu_cost_* charges, /debug/cost and the
                              # store's cost rows (monitoring/cost.py)

``conf/tasks/serve_config.yml`` runs as shipped, and with
``serving.ingest.enabled: true``.  Every block is parsed strictly, as the
reference parses it, before any artifact loads; the tracer is then
configured from ``serving.tracing`` and the cost layer from
``monitoring.cost``, as the reference's task does.  ``serving.cache``
builds the materialized forecast cache (``serving/forecast_cache.py``;
in memory unless ``mmap_dir`` is set) after the warmup, as the reference
does; a forecaster that is not coalesce-safe (an ensemble, a bucketed
artifact, Monte-Carlo intervals) serves uncached.  ``compile_cache:`` is
armed by the Task base: the first kernel launch loads the kernel library
through its store, and the store's counts are logged after the warmup.
The ``fleet:``, ``sharding:`` and ``resilience:`` blocks belong to the
fleet task (``tasks/fleet.py``: N replica processes of this scorer behind
one front door), as in the reference, whose serve task does not read
them.
"""

from __future__ import annotations

import os
import time

import numpy as np

from distributed_forecasting_tpu_torch.engine.compile_cache import cache_stats
from distributed_forecasting_tpu_torch.monitoring.cost import CostConfig
from distributed_forecasting_tpu_torch.monitoring.quality import (
    build_quality_runtime,
)
from distributed_forecasting_tpu_torch.monitoring.trace import (
    TraceConfig,
    configure_tracing,
)
from distributed_forecasting_tpu_torch.serving.anomaly import (
    AnomalyConfig,
    build_anomaly_runtime,
)
from distributed_forecasting_tpu_torch.serving.batcher import BatchingConfig
from distributed_forecasting_tpu_torch.serving.dataplane import HttpConfig
from distributed_forecasting_tpu_torch.serving.forecast_cache import (
    CacheConfig,
    build_forecast_cache,
)
from distributed_forecasting_tpu_torch.serving.ingest import (
    IngestConfig,
    build_ingest_runtime,
)
from distributed_forecasting_tpu_torch.serving.loader import resolve_from_registry
from distributed_forecasting_tpu_torch.serving.server import serve
from distributed_forecasting_tpu_torch.tasks.common import Task


class ServeTask(Task):
    def launch(self) -> None:
        serve(**self.server_args())

    def server_args(self) -> dict:
        """Parse every block, load the registered artifact onto the task's
        device, build the runtimes and warm the request buckets: the keyword
        arguments of ``serving.server.serve`` (or ``start_server``, which
        takes the same ones and runs the scorer in this process)."""
        conf = self.conf.get("serving", {})
        name = conf.get("model_name", "ForecastingBatchModel")
        stage = conf.get("stage")
        # every block is checked before the registry load, so a conf typo
        # or an unported block fails in milliseconds
        batching = BatchingConfig.from_conf(conf.get("batching"))
        tracing = TraceConfig.from_conf(conf.get("tracing"))
        http = HttpConfig.from_conf(conf.get("http"))
        AnomalyConfig.from_conf(conf.get("anomaly"))  # fail fast on typos
        IngestConfig.from_conf(conf.get("ingest"))
        monitoring = self.conf.get("monitoring")
        CostConfig.from_conf((monitoring or {}).get("cost"))
        CacheConfig.from_conf(conf.get("cache"))
        configure_tracing(tracing)

        forecaster, version = resolve_from_registry(
            self.registry, name, stage=stage, device=self.device)
        env = self.conf.get("env", {})
        quality = build_quality_runtime(
            monitoring,
            forecaster,
            tracking_root=self._paths["tracking"],
            default_store_dir=os.path.join(
                env.get("root", "./dftpu_store"), "quality_store"),
        )
        if quality is not None:
            self.logger.info(
                "quality observability on (monitor=%s store=%s slo=%s)",
                quality.monitor is not None, quality.store is not None,
                quality.slo is not None)
        ingest = self._build_ingest(conf.get("ingest"), forecaster,
                                    version, quality, env)
        anomaly = build_anomaly_runtime(
            conf.get("anomaly"),
            forecaster,
            default_store_dir=os.path.join(
                env.get("root", "./dftpu_store"), "anomaly_stream"),
        )
        if anomaly is not None:
            self.logger.info(
                "anomaly detection on: threshold=%.3f stream=%s",
                anomaly.threshold,
                anomaly.config.stream_scoring and ingest is not None)
        sizes = conf.get("warmup_sizes")
        if sizes:
            t0 = time.perf_counter()
            n = forecaster.warmup(
                horizon=int(conf.get("warmup_horizon", 90)),
                sizes=[int(s) for s in sizes],
            )
            self.logger.info("warmed %d request-size bucket(s) in %.1fs", n,
                             time.perf_counter() - t0)
            stats = cache_stats()
            self.logger.info(
                "compile cache after warmup: %d hit(s), %d miss(es)",
                stats["hits"], stats["misses"])
        self.logger.info(
            "serving %s v%s (%d series) on %s, %s:%s (micro-batching %s)",
            name, version.version, forecaster.n_series, self.device,
            conf.get("host", "0.0.0.0"), conf.get("port", 8080),
            "on" if batching.enabled else "off",
        )
        cache = build_forecast_cache(conf.get("cache"), forecaster)
        if cache is not None:
            self.logger.info(
                "forecast cache on: max_horizons=%d quantile_sets=%d",
                cache.config.max_horizons, len(cache.config.quantile_sets))
        return dict(
            forecaster=forecaster,
            host=conf.get("host", "0.0.0.0"),
            port=int(conf.get("port", 8080)),
            model_version=str(version.version),
            batching=batching,
            quality=quality,
            ingest=ingest,
            anomaly=anomaly,
            cache=cache,
            http=http,
        )

    def _build_ingest(self, ingest_conf, forecaster, version, quality, env):
        """``serving.ingest`` conf -> runtime (or None when absent or off).

        Full refits need the training series, which the registered
        artifact does not carry: a ``history.npz`` sidecar (arrays ``y`` /
        ``mask``, written by whoever registered the model) beside the
        artifact enables them; without it the refit block is dropped with
        a warning and the incremental path serves alone."""
        if not ingest_conf:
            return None
        history_y = history_mask = None
        for candidate in (
            os.path.join(version.artifact_dir, "history.npz"),
            os.path.join(version.artifact_dir, "forecaster", "history.npz"),
        ):
            if os.path.exists(candidate):
                with np.load(candidate) as hist:
                    history_y = hist["y"]
                    history_mask = hist["mask"]
                self.logger.info("training history sidecar: %s", candidate)
                break
        ingest_conf = dict(ingest_conf)
        if history_y is None and (ingest_conf.get("refit") or {}).get(
                "enabled"):
            self.logger.warning(
                "serving.ingest.refit is enabled but the artifact has no "
                "history.npz sidecar; serving incremental-only")
            ingest_conf.pop("refit")
        ingest = build_ingest_runtime(
            ingest_conf,
            forecaster,
            history_y=history_y,
            history_mask=history_mask,
            quality=quality,
            default_wal_dir=os.path.join(
                env.get("root", "./dftpu_store"), "ingest_wal"),
            device=self.device,
        )
        if ingest is not None:
            self.logger.info(
                "streaming ingest on: wal_dir=%s apply_mode=%s refit=%s",
                ingest.wal.directory, ingest.config.apply_mode,
                "on" if ingest.refit is not None else "off")
        return ingest


def entrypoint():
    ServeTask().launch()


if __name__ == "__main__":
    entrypoint()
