"""Fleet task: registered model -> N serving replicas behind one front door
(port of the reference's ``tasks/fleet.py``).

The horizontal-scale counterpart of ``tasks/serve.py``: this task resolves
the registered version ONCE (``registry.latest_version``: the front door
loads no tensors and never touches the card, so it holds no CUDA
context), then supervises N replica processes
(``python -m distributed_forecasting_tpu_torch.serving.replica``) that
each load the artifact onto the card, and runs the front door::

    python -m distributed_forecasting_tpu_torch.tasks.fleet \\
        --conf-file conf/tasks/serve_config.yml

On one H100 the N replicas share the card; the fleet scales out across
processes, not chips.  Conf: the same ``serving:`` block ``tasks.serve``
reads, plus::

    serving:
      fleet:
        enabled: true
        replicas: 2              # server processes behind the front door
        replica_host: 127.0.0.1  # replicas are local children
        base_port: 0             # 0: free ports; else base_port + i
        health_poll_interval_s: 0.5
        probe_timeout_s: 2
        ready_timeout_s: 300     # a cold replica builds the kernel library
        restart_backoff_s: 0.5   # capped exponential crash-restart backoff
        restart_backoff_max_s: 30
        drain_timeout_s: 10      # SIGTERM -> SIGKILL grace on drain
        proxy_timeout_s: 120     # per-attempt forward timeout
        retry_window_s: 10       # front-door budget to find a ready replica
        mesh_devices: 0          # >1: each replica is rank 0 of a mesh
                                 # of this many ranks (follower processes
                                 # it spawns, serving/replica.py)
      sharding:                  # series partition (serving/sharding.py)
        enabled: false
        num_shards: 8            # fixed key->shard partition count
        replication: 2           # owners per shard on the consistent ring
        vnodes: 64               # virtual ring points per replica
        quota_rps: 0             # per-tenant admitted rows/s (0 = off)
        quota_burst: 0           # token-bucket size (0 = 2 * quota_rps)
      resilience: {...}          # deadlines, breakers, hedging, failpoints
                                 # (serving/resilience.py)
      http: {...}                # the data plane of front door and replicas

Every block is parsed strictly before the registry is read.  The
environment each replica is spawned with carries:

* ``DFTPU_COMPILE_CACHE`` — the kernel library's store of this task's
  ``compile_cache:`` block (``engine/compile_cache``): the first replica
  boot builds the library and stores it, every other replica and every
  restart loads it with no ``nvcc``;
* ``DFTPU_FAILPOINTS`` / ``DFTPU_FAILPOINTS_SEED`` — from
  ``serving.resilience.failpoints`` / ``failpoint_seed``, so one conf
  stanza arms the whole tree (``monitoring/failpoints.py``);
* ``DFTPU_PLATFORM`` — the task's device: ``cpu`` when the task was asked
  for the CPU (``device="cpu"`` or ``DFTPU_PLATFORM=cpu``), else ``cuda``;
  a replica that finds no card raises and the supervisor's backoff shows
  it.

A top-level ``monitoring:`` block flows through to every replica with its
defaults (the env's tracking root, a store directory under ``env.root``):
each builds its own quality monitor, port-suffixed store and SLO
evaluator, and the fleet ``/metrics`` max-merges ``dftpu_slo_*``.

``serving.host``/``serving.port`` bind the FRONT DOOR (the one address
clients see); replicas bind supervisor-assigned ports on ``replica_host``.
SIGTERM drains the whole fleet gracefully: front door stops accepting,
every replica flips /readyz to 503 and finishes its queued requests.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading

from distributed_forecasting_tpu_torch.engine.compile_cache import get_config
from distributed_forecasting_tpu_torch.serving.batcher import BatchingConfig
from distributed_forecasting_tpu_torch.serving.dataplane import HttpConfig
from distributed_forecasting_tpu_torch.serving.fleet import (
    FleetConfig,
    start_fleet,
)
from distributed_forecasting_tpu_torch.serving.resilience import (
    ResilienceConfig,
)
from distributed_forecasting_tpu_torch.serving.sharding import ShardingConfig
from distributed_forecasting_tpu_torch.tasks.common import Task


class FleetTask(Task):
    def launch(self) -> None:
        supervisor, front = self.start()
        stop = threading.Event()

        def _drain(signum, frame):
            stop.set()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
        stop.wait()
        self.logger.info("draining fleet")
        front.shutdown()
        supervisor.stop()
        self.logger.info("front door drained; %s", self.cuda_note())

    @staticmethod
    def cuda_note() -> str:
        """Whether this process (the front door) holds a CUDA context."""
        import torch

        return ("CUDA initialized in this process: "
                f"{torch.cuda.is_initialized()}")

    def spawn_env(self, resilience: ResilienceConfig) -> dict:
        """The environment added to every replica's: the shared kernel
        store, the failpoint spec and the device switch."""
        env_extra = {
            "DFTPU_PLATFORM": "cpu" if self.device.type == "cpu" else "cuda",
        }
        cc = get_config()
        if cc is not None and cc.enabled:
            # every replica shares the task's store: the first boot builds
            # the kernel library, the others (and every restart) load it
            env_extra["DFTPU_COMPILE_CACHE"] = cc.directory
        if resilience.failpoints:
            # replica children arm their registries at import from the
            # environment: one conf stanza drives the whole tree
            env_extra["DFTPU_FAILPOINTS"] = resilience.failpoints
            env_extra["DFTPU_FAILPOINTS_SEED"] = str(
                resilience.failpoint_seed)
        return env_extra

    def start(self, spawn_fn=None):
        """Parse the blocks, resolve the version and start the fleet;
        returns ``(supervisor, front_door)`` (``launch`` then blocks until
        SIGTERM).  ``spawn_fn`` replaces the subprocess spawner (tests)."""
        conf = self.conf.get("serving", {})
        fleet = FleetConfig.from_conf(conf.get("fleet"))
        if not fleet.enabled:
            # running the fleet task IS the opt-in; honor the block's
            # sizing but don't require a redundant enabled: true
            fleet = dataclasses.replace(fleet, enabled=True)
        # strict parses before the registry read: a typo fails in
        # milliseconds, not as a fleet that silently serves defaults
        BatchingConfig.from_conf(conf.get("batching"))
        HttpConfig.from_conf(conf.get("http"))
        sharding = ShardingConfig.from_conf(conf.get("sharding"))
        resilience = ResilienceConfig.from_conf(conf.get("resilience"))
        name = conf.get("model_name", "ForecastingBatchModel")
        stage = conf.get("stage")
        version = self.registry.latest_version(name, stage=stage)
        sub = os.path.join(version.artifact_dir, "forecaster")
        artifact_dir = sub if os.path.isdir(sub) else version.artifact_dir
        serving_conf = {**conf, "model_version": str(version.version)}
        mon_conf = self.conf.get("monitoring")
        if mon_conf:
            # replicas build their own quality runtime from this block
            # (default_spawn_fn passes it through); the env's tracking root
            # and a store default make the staleness SLO and the store work
            # without per-replica conf
            env = self.conf.get("env", {})
            mon_conf = dict(mon_conf)
            mon_conf.setdefault("tracking_root", self._paths["tracking"])
            qs = dict(mon_conf.get("quality_store") or {})
            if qs.get("enabled") and not qs.get("directory"):
                qs["directory"] = os.path.join(
                    env.get("root", "./dftpu_store"), "quality_store")
                mon_conf["quality_store"] = qs
            serving_conf["monitoring"] = mon_conf

        supervisor, front = start_fleet(
            fleet,
            artifact_dir=artifact_dir,
            serving_conf=serving_conf,
            front_host=conf.get("host", "0.0.0.0"),
            front_port=int(conf.get("port", 8080)),
            env_extra=self.spawn_env(resilience),
            spawn_fn=spawn_fn,
            sharding=sharding if sharding.enabled else None,
            resilience=resilience,
        )
        self.logger.info(
            "fleet of %d replica(s) serving %s v%s behind %s:%d (%s)",
            supervisor.size, name, version.version,
            conf.get("host", "0.0.0.0"), front.server_address[1],
            self.cuda_note())
        return supervisor, front


def entrypoint():
    FleetTask().launch()


if __name__ == "__main__":
    entrypoint()
