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

**A mesh of ranks** (``mesh_devices`` D > 1). The replica is rank 0, the
serving rank, of a ``torch.distributed`` group of its own: it starts a
``TCPStore`` on a free port (so two replicas of one fleet never meet in one
group) and forks D - 1 follower processes before it touches CUDA
(:class:`MeshRanks`), which bring up the card and the kernel library, join
the group and run ``serving/predictor.serve_mesh_followers``: they hold no
forecast state, and every predict's rows come from the serving rank's one
snapshot (``BatchForecaster.enable_mesh``), so ingest, the WAL and refits
stay on the serving rank. Rank ``r`` runs on ``cuda:r`` over NCCL where the
host has a card for each rank, else over gloo on ``cuda:<r % cards>``
(every rank on ``cuda:0`` with one card); on the CPU under
``DFTPU_PLATFORM=cpu``
(``parallel/mesh.initialize_distributed``). ``/readyz`` flips after the
group is up and the warmup ladder has run through it. A follower that
cannot load the library, cannot join, or dies takes the replica down with a
nonzero exit (out of ``/readyz``; the supervisor's restart brings it back),
and a follower dies with its replica (a parent-death signal, and its
sockets into the group close). SIGTERM drains the queue first, then sends
the followers the stop message and joins them; the drain line also carries
each follower's hand-kernel launches. A composite artifact or a forecaster
with Monte-Carlo intervals has no mesh predict (its rows are not
independent): the replica serves it on one device with the reference's
warning, and ends its followers before they join.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import time

# a follower's group timeout: it waits for the next request between
# dispatches, so an idle replica must not time it out
MESH_GROUP_TIMEOUT_S = 30 * 24 * 3600.0
# the followers' boot (CUDA, the library, the rendezvous) before the
# replica gives up on its group
MESH_BOOT_TIMEOUT_S = 300.0
# a drain's wait for the followers to leave after the stop message
MESH_DRAIN_TIMEOUT_S = 10.0
# the replica's exit code when a follower rank dies
MESH_FOLLOWER_DIED = 75


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


class _Follower:
    """A forked follower process: what the replica uses of ``Popen``."""

    def __init__(self, pid: int):
        self.pid, self.returncode = pid, None
        self._lock = threading.Lock()

    def poll(self):
        with self._lock:
            if self.returncode is None:
                pid, status = os.waitpid(self.pid, os.WNOHANG)
                if pid:
                    self.returncode = os.waitstatus_to_exitcode(status)
            return self.returncode

    def wait(self, timeout: float) -> int:
        deadline = time.monotonic() + timeout
        while True:
            # poll's value, read under the lock: returncode is not re-read
            rc = self.poll()
            if rc is not None:
                return rc
            if time.monotonic() > deadline:
                raise TimeoutError(f"follower pid {self.pid} still runs")
            time.sleep(0.02)

    def kill(self) -> None:
        if self.poll() is None:
            try:
                os.kill(self.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


class MeshRanks:
    """The serving rank's side of a replica's mesh: the follower processes,
    their rendezvous store and a watcher thread.

    The followers are forked before this process touches CUDA or starts a
    thread (call it first; both are checked), so each starts with the
    interpreter and the imports already loaded and brings up CUDA, the
    library and its rank on its own while this rank loads the artifact.
    Python's fork warning still shows: the imports' idle native pools
    (numpy's BLAS threads) count as threads, and reset in the child through
    their own at-fork handlers.  Each learns the port of the ``TCPStore``
    this rank then starts on a free port through a pipe.  A follower that
    exits before :meth:`drain` (a failed boot or a death) ends the replica
    with :data:`MESH_FOLLOWER_DIED`, after its ``/readyz`` flips to 503
    (the server, once :meth:`serving` names it)."""

    def __init__(self, world: int, port: int, logger):
        import datetime
        import sys

        import torch
        import torch.distributed as dist

        if torch.cuda.is_initialized():
            raise RuntimeError(
                "the mesh's followers fork before this process uses CUDA; "
                "start MeshRanks first")
        if threading.active_count() != 1:
            # a fork copies only this thread: a lock another thread holds
            # (a logging handler's, a tracer exporter's) stays held in the
            # follower, which can then hang in its boot
            raise RuntimeError(
                f"the mesh's followers fork from a process with one Python "
                f"thread; {threading.active_count()} are running "
                f"({[t.name for t in threading.enumerate()]}): start "
                f"MeshRanks before any thread")
        self.world, self.logger = int(world), logger
        self._server = None
        self._up = threading.Event()
        self._stop = threading.Event()
        self.procs, pipes = [], []
        sys.stdout.flush()
        sys.stderr.flush()
        parent = os.getpid()
        for rank in range(1, self.world):
            read, write = os.pipe()
            pid = os.fork()
            if pid == 0:  # the follower: never returns into the replica
                code = 1
                try:
                    os.close(write)
                    for fd in pipes:
                        os.close(fd)
                    code = follower_main({
                        "world": self.world, "rank": rank, "parent": parent,
                        "replica_port": int(port), "store_fd": read})
                except BaseException:  # noqa: BLE001 — logged, exits nonzero
                    logger.exception("follower rank %d failed", rank)
                finally:
                    os._exit(code)
            os.close(read)
            pipes.append(write)
            self.procs.append(_Follower(pid))
        self.store = dist.TCPStore(
            "127.0.0.1", 0, world_size=self.world, is_master=True,
            timeout=datetime.timedelta(seconds=MESH_BOOT_TIMEOUT_S),
            wait_for_workers=False)
        for fd in pipes:
            os.write(fd, str(int(self.store.port)).encode())
            os.close(fd)
        self._t0 = time.monotonic()
        self._watcher = threading.Thread(target=self._watch,
                                         name="mesh-followers", daemon=True)
        self._watcher.start()

    @property
    def pids(self) -> list:
        return [p.pid for p in self.procs]

    def join(self, device):
        """Bring rank 0 into the group on ``device`` (blocks until every
        follower has joined) and return the mesh."""
        import datetime

        from distributed_forecasting_tpu_torch.parallel.mesh import (
            initialize_distributed,
            make_mesh,
        )

        initialize_distributed(
            num_processes=self.world, process_id=0, device=device,
            store=self.store,
            timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
        mesh = make_mesh(self.world)
        self._up.set()
        return mesh

    def serving(self, server) -> None:
        """The server whose ``/readyz`` a follower's death flips first."""
        self._server = server

    def _watch(self) -> None:
        while not self._stop.wait(0.2):
            for rank, proc in enumerate(self.procs, start=1):
                rc = proc.poll()
                if rc is not None:
                    self._fail(f"follower rank {rank} (pid {proc.pid}) "
                               f"exited with {rc}")
            if not self._up.is_set() and \
                    time.monotonic() - self._t0 > MESH_BOOT_TIMEOUT_S:
                self._fail(f"the mesh of {self.world} ranks was not up in "
                           f"{MESH_BOOT_TIMEOUT_S:.0f} s")

    def _fail(self, why: str) -> None:
        """Leave /readyz, end the other followers and exit nonzero: the
        ranks can no longer dispatch in step (the main thread may be
        blocked inside a collective, so this exits from here)."""
        import logging

        if self._server is not None:
            self._server.mark_unready()
        self.logger.error("%s; the replica leaves /readyz and exits %d",
                          why, MESH_FOLLOWER_DIED)
        for proc in self.procs:
            proc.kill()
        logging.shutdown()
        os._exit(MESH_FOLLOWER_DIED)

    def drain_unjoined(self) -> None:
        """End followers that will not be needed (a forecaster with no mesh
        predict): they hold nothing, so they are killed before they join."""
        self._stop.set()
        self._watcher.join()
        for proc in self.procs:
            proc.kill()
            proc.wait(MESH_DRAIN_TIMEOUT_S)

    def drain(self, forecaster) -> list:
        """After the server's drain: stop the watcher, send the followers
        the stop message, join them within :data:`MESH_DRAIN_TIMEOUT_S`
        (killing any left) and leave the group.  Returns each follower's
        hand-kernel launch counts, in rank order."""
        import torch.distributed as dist

        self._stop.set()
        self._watcher.join()
        reports = forecaster.stop_mesh()
        deadline = time.monotonic() + MESH_DRAIN_TIMEOUT_S
        for proc in self.procs:
            try:
                proc.wait(max(deadline - time.monotonic(), 0.1))
            except TimeoutError:
                self.logger.error("follower pid %d outlived the drain; "
                                  "killed", proc.pid)
                proc.kill()
                proc.wait(MESH_DRAIN_TIMEOUT_S)
        dist.destroy_process_group()
        return reports


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent (the replica) dies: Linux's
    parent-death signal, set before anything else, then a check that the
    parent did not die first."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, int(signal.SIGKILL)) != 0:  # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != parent:
        os._exit(MESH_FOLLOWER_DIED)


def follower_main(plan: dict) -> int:
    """A follower rank of a replica's mesh, forked by :class:`MeshRanks`:
    bring up CUDA and the kernel library on the card, read the store's port
    from the replica, join its group, serve dispatches until the stop
    message, then log the drain line with this process's hand-kernel
    launches.  It ignores SIGINT and SIGTERM: its lifetime is its
    replica's (the stop message, or the parent-death signal)."""
    import datetime

    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.engine.compile_cache import (
        enable_from_env,
    )
    from distributed_forecasting_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
    )
    from distributed_forecasting_tpu_torch.serving.predictor import (
        serve_mesh_followers,
    )
    from distributed_forecasting_tpu_torch.utils.device import (
        platform_device,
        resolve_device,
    )
    from distributed_forecasting_tpu_torch.utils.logging import get_logger

    _die_with_parent(int(plan["parent"]))
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    rank, world = int(plan["rank"]), int(plan["world"])
    logger = get_logger("fleet-replica-follower")
    t0 = time.perf_counter()
    device = resolve_device(platform_device())
    enable_from_env()
    if device.type == "cuda":
        from distributed_forecasting_tpu_torch.ops import _build

        _build.library()
    got = os.read(int(plan["store_fd"]), 32)
    os.close(int(plan["store_fd"]))
    if not got:  # the replica failed before it started the store
        return MESH_FOLLOWER_DIED
    store = dist.TCPStore(
        "127.0.0.1", int(got), world_size=world, is_master=False,
        timeout=datetime.timedelta(seconds=MESH_BOOT_TIMEOUT_S))
    dev = initialize_distributed(
        num_processes=world, process_id=rank, device=device, store=store,
        timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
    mesh = make_mesh(world)
    logger.info("follower rank %d of %d of the replica on port %d ready on "
                "%s in %.3fs", rank, world, int(plan["replica_port"]), dev,
                time.perf_counter() - t0)
    served = serve_mesh_followers(mesh, report=_launches)
    dist.destroy_process_group()
    logger.info("follower rank %d of the replica on port %d drained after "
                "%d dispatch(es); hand-kernel launches in this process: %s",
                rank, int(plan["replica_port"]), served,
                json.dumps(_launches()))
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--conf", required=True,
                    help="JSON replica config (see module docstring)")
    args = ap.parse_args(argv)
    conf = json.loads(args.conf)
    t_boot = time.perf_counter()

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
    from distributed_forecasting_tpu_torch.serving.predictor import (
        mesh_refusal,
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

    mesh_devices = int(conf.get("mesh_devices") or 0)
    # the followers fork before this process touches CUDA and bring up
    # their card and library while this rank loads
    ranks = (MeshRanks(mesh_devices, port, logger)
             if mesh_devices > 1 else None)
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

    if ranks is not None:
        refusal = mesh_refusal(forecaster)
        if refusal is not None:
            # the reference's behaviour for composites, and the port's for
            # Monte-Carlo intervals too: rows that are not independent
            logger.warning("%s has no mesh-parallel predict (%s); serving "
                           "single-device", type(forecaster).__name__,
                           refusal)
            ranks.drain_unjoined()
            ranks = None
        else:
            t0 = time.perf_counter()
            forecaster.enable_mesh(ranks.join(device))
            stages["mesh"] = time.perf_counter() - t0
            logger.info("mesh-parallel predict over %d rank(s): follower "
                        "pid(s) %s", mesh_devices, ranks.pids)

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
    if ranks is not None:
        ranks.serving(srv)
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
    followers = [] if ranks is None else ranks.drain(forecaster)
    logger.info("replica on port %d drained; hand-kernel launches in this "
                "process: %s; in its follower ranks: %s", port,
                json.dumps(_launches()), json.dumps(followers))


def _launches() -> dict:
    """The launch counter of every hand kernel's wrapper in this process
    (each counts where it launches its kernel on the card)."""
    from distributed_forecasting_tpu_torch.ops import fused_scan, kalman, ses

    return {name: getattr(mod, name).launches for mod, names in (
        (fused_scan, ("hw_score", "hw_filter")),
        (kalman, ("arima_filter", "arima_predict", "arima_loglik_grad",
                  "arima_mle_fit")),
        (ses, ("croston_filter", "ses_filter"))) for name in names}


if __name__ == "__main__":
    main()
