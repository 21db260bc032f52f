"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once, on the card, at the reference
workload's full size — the committed ``datasets/store_item_demand.csv.gz``
(500 store x item series, 1,826 days) — and the system's own workflow at
its own size:

  * Holt-Winters: load -> tensorize -> fit + forecast (candidates scored by
    the ``hw_score`` CUDA kernel, the winner refit by the ``hw_filter`` CUDA
    kernel) -> fail-safe -> forecast frame -> rolling-origin CV (730/360/90)
    -> artifact save/load -> batched predict;
  * the curve model (``model: prophet``, the default configuration:
    multiplicative seasonality, US holidays, F = 61 features): the same
    path, its Gram one cuBLAS GEMM and its solve cuSOLVER's batched
    Cholesky with cuBLAS triangular solves (no hand kernel);
  * ``conf/workflows.yml``'s ``forecasting-e2e`` through the port's workflow
    runner: catalog -> ingest (10 stores x 50 items x 1,826 synthetic days)
    -> train (the curve model, CV 730/360/90, split-conformal bands) ->
    deploy -> inference -> monitor (profile, anomalies, drift from the
    table's second version on, degradation);
  * its ``real-data-e2e`` (the committed dataset through the CSV ingest)
    and ``forecasting-blend`` (4 x 25 x 1,096 synthetic days, Holt-Winters
    at ``season_length: auto``, then promote): train with ``model: blend``
    over prophet, holt_winters and croston — each family's CV pass for the
    weights, the pooled CV pass for the conformal scale, one full-history
    fit each; the Holt-Winters member on both hand kernels — deploy,
    inference, then monitor or promote;
  * its ``allocated-baseline`` (the 500 synthetic series summed to 50
    items, one curve-model fit per item, store shares applied on the host)
    and ``hierarchical-m5`` (the committed dataset: theta at every one of
    the 500 bottoms, then the reconcile task's theta fit and CV of all 561
    hierarchy nodes and the MinT solve with CV weights, horizon 28);
  * the arima family on the committed dataset: fit_forecast(model="arima")
    at its default (2, 1, 1) — the Hannan-Rissanen estimate, the Kalman
    pass on the ``arima_filter`` CUDA kernel, the forecast on the
    ``arima_predict`` kernel — CV, artifact and predict; ``order: auto``
    over the 22 orders of its ladder; and ``model: auto`` with no
    ``families`` key (prophet, holt_winters, theta, croston, arima) through
    the runner: real-data-e2e's etl, then train, deploy and inference;
  * the curve model's remaining entry points and the native data plane:
    the CSV parse and tensorize on the C++ library (``native/``, loaded or
    built into ``build/torch_kernels/``), span buckets on examples/06's
    ragged catalog (``fit_forecast_bucketed``, ``training.bucketed``,
    ``BucketedForecaster``), regressors (``training.regressors``,
    ``inference.regressors``), the CV artifact (``training.cv_artifact``)
    and the chunked fit of 20,480 series;
  * the online scorer: ``python -m
    distributed_forecasting_tpu_torch.tasks.serve`` on the shipped serve
    conf, answering /invocations, /observe and /metrics over HTTP with the
    micro-batching coalescer off and on;
  * automatic data prep (``engine/autoprep.py``, ``ops/clean.py``) on the
    committed dataset with spikes, zero runs and level shifts planted from
    a seed: the prep program on the card against a CPU copy, and the train
    task from the shipped train_config.yml with ``engine.autoprep`` armed
    (Holt-Winters at ``season_length: auto``, then the curve model with
    holiday regressors);
  * streaming ingest: the serve task with ``serving.ingest`` on over
    Holt-Winters, theta and croston artifacts of the committed dataset —
    ``POST /ingest`` into the write-ahead log, the batched state update,
    a forced background refit (for Holt-Winters ``hw_score`` over its
    96-candidate grid, then ``hw_filter``) with its replay;
  * windowed (DARIMA) arima fitting of ultra-long series (500 x 100,000
    and 1 x 1,000,000 periods from a seed): the window statistics, the WLS
    combine, the tail window's ``arima_filter`` pass and the
    ``arima_predict`` forecast, the tail-window streaming refit, and the
    train task with ``engine.windowed`` armed;
  * the training runtime: the shipped train conf through the pipelined
    executor, ``run_many`` of four families, the kernel library's
    ``compile_cache`` store in fresh processes, the cost registry and the
    tracer;
  * the scorer's runtime: the serve task with ``tracing.debug_endpoints``
    over Holt-Winters (streaming ingest on) and arima artifacts — span
    trees from ``http.request`` to ``aot.call``, ``/debug/trace``,
    ``/debug/profile`` during a refit (``hw_score``, ``hw_filter``) and
    arima traffic (``arima_predict``), the flight-recorder dump of a 503,
    ``/debug/cost`` and the ``dftpu_cost_*`` store rows;
  * the serving fleet: the fleet task (front door, supervisor, 2 replica
    processes on the card, series sharding with per-shard WALs) on a
    Holt-Winters artifact — scatter-gather bodies byte-equal to one
    scorer's, an ingest and the refit it forces inside a replica
    (``hw_score``, ``hw_filter``), replicas killed mid-stream and their
    warm boots from the shared kernel store;
  * the materialized forecast cache: the serve task with ``serving.cache``
    on over arima, Holt-Winters (streaming ingest on), theta and curve-model
    artifacts beside the same scorers with it off — full-S rebuilds
    (arima's launches ``arima_predict``), hit against dispatch, the
    rebuilds an ``/ingest`` apply and a forced refit pay, persistence and
    adoption at a restart, and two fleets of 2 replicas, cache on and off;
  * the series mesh (``parallel/*`` over ``torch.distributed``): one NCCL
    rank on the card through ``make_mesh()``, and two processes sharing the
    card over gloo, each brought up by ``initialize_distributed`` — the
    reference's multi-host scenario (hash-owned shards, a global metric
    mean by all-reduce), sharded fits and CV, the bottom-level gather, the
    time-sharded scans over one series of 2^20 steps and the windowed arima
    fit of 500 x 100,000 over the mesh;
  * a replica's predict over a mesh of ranks: the fleet task with one
    replica at ``mesh_devices: 2`` (a serving rank and a forked follower
    sharing the card over gloo) beside the same fleet at 0, bodies
    byte-equal at 1, 17 and 500 series, an apply and a forced refit on the
    serving rank of a Holt-Winters replica, a follower's death and its
    replica's restart.

Phases, each printing one JSON line; any failure raises, so the exit code
is not 0:

  1. device   the card's name, and its name and power limit from nvidia-smi
  2. build    every kernel built from csrc/ in one build call (seconds),
              phase 18 (c)'s cold library-store child building beside it
  3. kernels  each kernel against its plain twin on the card at the main
              path's shapes (each twin run once for the cases that share
              its shapes: the twins work row by row, ``stacked_twins``).  hw_score (default grid, damped grid, 10% more
              cells masked, a 30-day season, and the CV pass's 1,500 rows
              with the three cutoffs' train masks): rtol 1e-5 / atol 1e-6,
              argmins equal or near ties within that tolerance.  hw_filter
              (the winners of the default and the damped grid, the
              multiplicative mode, a 30-day season, the CV pass's 1,500
              rows): bitwise equal to _filter in path, states and MSE.
              Phase 8 adds the same two checks on every call the pooled
              train tasks make (see ``pooled_kernel_cases``).
              The curve model's library solve against the floored Cholesky
              twin (the CPU route, run here on the card) on the fit's 500
              and the CV pass's 1,500 systems: beta and the fitted path
              within 10 * cond(A) * 2^-24 of each row's scale, no failed
              factorization, and no host sync in the solve
  4. main     each main path with the launch counters set to 0 just before
              it and read just after: every kernel must have launched on
              the Holt-Winters path (the curve path launches none of them)
  5. checks   what came out is right: finite, the expected shapes and key
              order, bands ordered, 3 CV cutoffs with finite means; the
              kernel-scored HW fit bitwise the scan-scored fit where the
              argmins agree; a 20-series run of each path equal to the same
              run on the CPU (HW within float32 tolerance, the curve model
              within 10 * cond(A) * 2^-24), ok flags equal
  6. times    CUDA-event medians of 5 runs after a warm-up.  Holt-Winters:
              both kernels at the fit, CV and damped shapes beside their
              bounds, each timed host-paced (``ms``: 20 launches of the
              bound launcher between two events) and on the device
              (``device_ms``: the same with a sleep kernel queued first, so
              that the host has enqueued them all before the first runs;
              None where it had not);
              hw_filter's cycles a step by the slope of its device time over
              T = 1,826 / 3,652 / 7,304 (additive and multiplicative m 7,
              additive m 30) and its chain (``HW_CHAIN_CYCLES``, read from
              its SASS); both twins, fit_forecast broken down into scoring,
              refit, forecast and fail-safe (a staged copy of it whose
              outputs must equal fit_forecast's), the CV pass, one
              500-series predict, and the device's idle share over one
              fit_forecast (torch.profiler).  The curve model: fit_forecast
              and its stages (design, Gram, solve, residual scale,
              forecast, fail-safe; a staged copy held bitwise to it), the
              CV pass, one 500-series predict, the Gram and the solve alone
              at the fit and CV shapes beside their bounds (and the
              ``einsum`` Gram), and the device's idle share and library
              launches over one fit_forecast and one CV pass
  7. workflow forecasting-e2e, twice in a temporary env.root, with
              the launch counters set to 0 before each run (its curve model
              launches no hand kernel).  Checks: every task OK; the train
              run's batch, forecast and conformal scales on the card; the
              forecast and inference tables' keys, dates and rows, finite,
              lo <= yhat <= hi; 500 finite positive scales;
              val_coverage_calibrated logged beside val_coverage; the run's
              version registered, tagged model_family prophet, in Staging;
              the registered artifact predicting the train run's artifact's
              frame, the inference table, and the train run's forecast
              within 1e-5; the monitor's summary and its tables (the drift
              report on the second run only).  Times: per task, the train
              run's phase_* and fit_seconds, the device's idle share over
              the train task's dispatch stage, and the conformal scale alone
              at the CV shape beside its bound (its sorts counted, no host
              sync).  A
              20-series cross_validate(calibrate=True) on the card equals
              the CPU's: ranks equal, scales within their scores' change
  8. blend    real-data-e2e WORKFLOW_RUNS (2) times in one env.root (the
              monitor scans drift from the second run on; then the monitor
              task rerun on the CPU over the same stored table must write
              equal tables, and its four scans are timed), then
              forecasting-blend twice in one env.root (the second promote
              decides by its rule against the first run's champion), each
              workflow WORKFLOW_RUNS times in all for the per-task medians,
              with the launch counters set to 0 as each train task starts: both kernels must launch in every
              one (3 each).  The first train task of each workflow records
              its hw_score and hw_filter calls (forecasting-blend's at
              100 x 1,096 and the CV pass's 200 rows, the detected m = 7),
              and each output the path got is held against its twin on the
              same inputs, as phase 3 holds it.  Checks: every task OK on
              the card; the weights finite and each series' summing to 1;
              the tables' keys, dates, finite values, lo <= yhat <= hi (the
              pooled band's floor, when its members declare one); the conformal
              scales finite and positive; the registered version's family
              tag and stage; the registered artifact predicting the
              inference table and the train run's forecast within 1e-5;
              the season detected on the committed dataset (and by
              forecasting-blend's ``season_length: auto``) is 7; a
              20-series ``fit_forecast_blend(calibrate=True)`` on the card
              agrees with the CPU (see ``pool_vs_cpu``).  Times: per task
              and ``fit_seconds`` (medians of WORKFLOW_RUNS runs), the
              train task's
              dispatch stage (CUDA events, one sample; idle share; the
              host syncs PyTorch reports), the croston recurrence at the
              fit and CV shapes beside its bounds, and season detection
  9. complete allocated-baseline and hierarchical-m5, each WORKFLOW_RUNS
              times in one env.root, the launch counters set to 0 before each run
              (neither launches a hand kernel).  Checks: every task OK on the
              card; the allocated table's columns and rows are the
              reference's, each item's store shares sum to 1 and each
              store's future rows are the item artifact's forecast times its
              share; the reconciled table has 561 nodes x 28 days in the
              reference's node order, coherent within the float32 summation
              bound, and the MinT solve agrees with a float64 numpy solve
              within 10 cond(G) 2^-24; a 20-node theta fit and forecast on
              the card agrees with the CPU (winners equal where the SSEs are
              apart); a 20-series blend over [holt_winters, theta, croston]
              agrees with the CPU (see ``pool_check``) and launches both
              kernels.  Times: per task (medians of WORKFLOW_RUNS), the SES
              loop and the
              theta fit at the fit and CV shapes (launches, idle share, host
              syncs, bounds), and the MinT solve at n = 500

 10. arima    arima_filter against its twin, bit for bit, at the fit shape
              (2, 1, 1), the CV pass's 1,500 rows, d = 0, 10% more cells
              masked, weekly seasonal P = Q = 1 (r = 8) and m = 52 with
              P = 1 (r = 52, the shared-memory path); arima_predict at
              H = 91 and at a serving grid longer than the fit grid (2,001);
              both refuse r = 70 with ValueError.  The arima main path with
              every counter set to 0 just before it and read just after
              (both arima kernels must launch); checks as phase 5's and a
              20-series card-vs-CPU run within 1e-3 of each output's scale;
              times: both kernels beside their bounds and their twins
              (once), host-paced and on the device; arima_predict also
              beside an empty kernel launched the same way (the launch
              floor), its chain (``ARIMA_PREDICT_CHAIN_CYCLES``) and the
              host's part of a call,
              fit_forecast and the CV pass (idle share, host syncs), one HW
              ``filter='pscan'`` and one ``kalman='pscan'`` fit with their
              peak memory.  ``order: auto`` on the committed dataset (all 22
              orders; wall time; on 20 series the card and the CPU pick the
              same order where the best two are apart by 1e-3).  Then
              ``model: auto`` with the default families three times in one
              env.root: every task OK, hw_score, hw_filter and arima_filter
              launched in every train task, all five families scored per
              series, the registered artifact predicting the inference table
              and the train run's forecast; per-task medians
 11. slice 9  the native data plane on the committed dataset: the CSV
              parse native and pandas (equal frames) and tensorize on both
              planes (bitwise equal on the card), each timed, the resolved
              backend native.  Span buckets on examples/06's catalog (10 x
              50 x 1,826 days, items >= 10 from day 1,570): the bucketed
              Holt-Winters fit with the counters set to 0 around it (one
              launch of each kernel a bucket), every hw_score / hw_filter
              call held to its twin as phase 3 holds them, the curve
              model's bucketed fit, 20 series of both buckets against the
              CPU, the train task with ``training.bucketed`` through deploy
              and inference (the registered artifact is buckets.json and
              reproduces the inference table), per-bucket fit times and
              predict latency at 1 / 17 / 500 series.  Regressors on the
              committed dataset (examples/07's promo calendar, shared, and a
              seeded per-series price): fit_forecast and a CV pass with
              xreg, 20 series against the CPU within their conditioning
              bound, the train task with ``training.regressors`` (a catalog
              table), inference with ``inference.regressors`` and
              ``inference.quantiles`` reproduced from the registry, predict
              latency.  The CV artifact: cv_forecasts.parquet's rows equal
              the eval masks' sum, its 20-series rows the CPU's frame.  The
              chunked fit: 20,480 x 1,826 in chunks of 4,096 under both
              dispatches against the unchunked fit on 8,192 series (2e-4 of
              each row's scale), wall time and peak memory of each.  Files
              under ``native/`` are unchanged at the end
 12. scorer   the online scorer.  Two artifacts registered in one store:
              forecasting-e2e's train (the curve model, calibrated) on the
              committed dataset, and ``model: auto`` with the default
              families.  conf/tasks/serve_config.yml as shipped (quality
              store and SLO evaluator on), each child with its own store
              directory, started twice as ``python -m
              distributed_forecasting_tpu_torch.tasks.serve`` (batching off,
              and on with 64 / 5 ms); the batching-off child also runs
              ``serving.anomaly`` and ticks its scrape loop and SLO
              evaluator every second; /readyz polled until 200.  Checks:
              /health's 500 series; bodies for 1, 17 and 500 series (and
              quantiles) byte-equal to ``_encode_predictions`` of the
              in-process predict on the card, and within 1e-5 of each row's
              scale of a CPU copy of the artifact; every response of 32
              coalescing clients byte-equal to the same request served
              alone; 429 with Retry-After: 1 under a burst at
              max_queue_depth 2, 503 for X-Deadline-Ms: 0; /observe's summary
              and an in-process QualityMonitor's snapshot equal a float64
              numpy computation over 28 days of 17 series' actuals and the
              served bands; the latency SLI within one histogram bucket of
              the client's p95, every rule's SLI on /metrics, no evaluation
              error, and each burn rate equal to a recomputation from the
              store's rows; /detect_anomalies (17 series x 28 days, spikes
              planted) byte-equal to the in-process scorer, within the CPU
              tests' tolerance of a CPU copy, every spike flagged; both
              children exit on SIGTERM and the store is read back.  The auto
              artifact behind a scorer in this process, the counters set to
              0 just before its HTTP requests and read after: arima_predict
              launches, the served rows byte-equal to the in-process
              predict; /detect_anomalies at in-process servers on both
              artifacts (one arima_predict launch a request on the auto
              one), and concurrent detection and forecast requests sharing
              dispatches.  Times: p50 / p95 / p99 of 20 sequential requests
              at 1, 17 and 500 series, the device's idle share over the
              500-series request, requests/s, latency, dispatches per
              request and the mean coalesced batch under 32 clients with
              batching off and on; /detect_anomalies at 17 x 28 and 500 x 20
              points (sequential) and its predict / host split; one
              ``scrape_once`` and one ``evaluate_once``; 1-series latency
              with the store and SLO on against off
 13. autoprep the committed dataset with, from a seed, one x8 spike in every
              series, a 30-day zero run in 50 series and a +20 level shift
              over the last 826 days in 50 others.  (a) The prep program,
              every stage on with season and holiday detection, horizon 90,
              on the card and on a CPU copy: the report's counts, the
              largest difference of each float output, and the differing
              discrete outputs, each inside the tie rules (a flag may flip
              only where its score is within 1e-5 of the threshold, a
              cp_index only where the top two valid |dev| are within 1e-6 x
              sum|y m|); repairs and the fit tensor bitwise elsewhere.  (b)
              The train task from conf/tasks/train_config.yml with the prep
              armed, season detection, ``model: holt_winters`` and
              ``season_length: auto``, the counters set to 0 just before it
              and read after (hw_score and hw_filter must launch); its
              prep_report (500 rows) and prep_repairs (one row a repaired
              point) tables and prep_* metrics, the detected 7; run twice,
              alternating with the prep off.  (c) The curve model (the
              shipped model conf) with every stage on (holiday regressors,
              season detection and re-leveling too): n_regressors is the
              holiday count, its prep tables are logged, the artifact loads
              and predicts the train table.  (d) Holt-Winters fit on the first
              1,736 days with and without the cleaning stages: the repaired
              fit's MAE over the last 90 days of the truth is lower.  (e)
              The prep program's CUDA-event median of 5 beside its byte
              bound, its device events and the card's idle share;
              ``autoprep_batch`` on the host clock; the train task's wall
              time with the prep on and off
 14. draws    the paths that draw random numbers (``slice13_phase``):
              arnet on both trainers, its CV pass and train task, a pool
              with arnet, the Monte-Carlo curve model, the tuned path
 15. P8's end (``slice14_phase``) on the committed dataset.  (a) The
              likelihood-gradient kernel (``arima_loglik_grad``,
              csrc/arima_mle.cu) against its twin bit for bit, and its ssq,
              ldet and n against arima_filter's bit for bit, at the fit
              shape (2, 1, 1), the CV pass's 1,500 rows, d = 0, 10% more
              cells masked, r = 4, 8 and 9 (the shared-memory path); its
              Jacobian against float64 autograd through the plain filter
              (fit shape, r = 9) within 1e-3 of each row's scale or twice
              float32 autograd's distance from it; ValueError at r = 70.
              The fit kernel (``arima_mle_fit``) against its twin bit for
              bit (u, phi, theta) after 2 Adam steps at the fit shape and
              the CV pass's rows, and at r = 8 and 9 (1 step); ValueError
              at r = 70.  (b) fit_forecast and the CV pass with
              ``method: mle`` with the counters set to 0 around them: one
              arima_mle_fit launch a fit (all 200 Adam steps), no
              arima_loglik_grad launch, arima_filter and arima_predict
              launched; outputs finite; 20 series on their last 365 days
              against the CPU within 1e-4 of scale; the HR and MLE one-step
              in-sample MSE of every series side by side; the train task
              with ``model_conf: {method: mle}`` through deploy and
              inference (2 fit launches: CV and fit); ``model: auto`` with
              an MLE arima.  (c) The
              bf16 gate: the scan route's bf16 winners differ from float32
              only inside the bf16 error measured on the two candidates;
              HW train tasks gated and not under ``filter: scan`` and
              ``auto`` (byte-equal: the kernel ignores the gate).  (d)
              ``successive_halving_select`` at ``AutoMLConfig()``'s defaults
              (hw_score launches in it), a 1e-3 s budget tripping the gate,
              and the train task with ``engine.automl.enabled`` byte-equal
              to the task without it.  (e) Both kernels' CUDA-event medians
              beside their bounds, serial chains and cycles a time step
              (the fit kernel as the main path launches it: 200 steps),
              the fit's per-step time over its first and last 20 steps,
              the twins once; the MLE fit's wall time, device events, idle
              share and host syncs
 16. stream   streaming ingest (``slice15_phase``) on the committed
              dataset.  (a) Holt-Winters (96 candidates), theta and croston
              fit on the card with the counters set to 0 just before, each
              registered with its history.npz sidecar; per family the
              serve task (``ServeTask.server_args``, the shipped conf with
              ``serving.ingest`` on, sync apply, refit on but only forced)
              in this process: 60 days posted one a request (500 points),
              a 30-day burst (15,000 points), then 10 days with a forced
              refit whose snapshot is taken after the 5th, so the install
              replays 5; after every POST /invocations (17 series) is
              byte-equal to a mirror store fed the same points; the refit
              launches hw_score and hw_filter once each (Holt-Winters) and
              its install equals fit-then-update bit for bit; /metrics
              counts what was posted.  (b) Bitwise on the card: k = 1, 7,
              40 streamed days (40 through the store, across a time-bucket
              boundary) equal the hw_filter fit of the extended series
              (one pinned candidate); 30 days in one apply equal 30
              applies of one day, and padding columns leave the carry, for
              each family; two interval-mode followers of one WAL converge.
              (c) 20 series streamed on the card and on the CPU from the
              card's fit: states within 1e-5 of each row's scale, routing
              counts equal.  (d) POST /ingest p50 / p95, apply_pending at
              K 1 and at the burst (host wall, CUDA events, idle share), the
              refit's wall time and both kernels at its shape,
              /invocations for 500 series idle and during refits, and the
              apply at 20,480 series at K 1 and at a bucket crossing with
              peak device memory
 17. windowed windowed (DARIMA) arima fitting (``slice17_phase``) at the
              shipped ``engine.windowed`` block (W 8,192, overlap 256,
              min_windows 4) on AR(2) + level series from a seed.  (a)
              fit_forecast(model="arima") at 500 x 100,000 with the block
              armed (13 windows; the tail-window grid checked, ok all
              true), then the sequential whole-series fit with it disarmed,
              the counters set to 0 around the first call of each (one
              launch of each arima kernel); both walls (CUDA events,
              median of 5), idle shares, peak memory, the windowed stages
              (gather, window statistics, combine, finalize) beside their
              bounds, and the reference's horizon parity (10%).  (b)
              arima_filter on the finalize's inputs (500, 8,192, r 2, d 1)
              and arima_predict at the windowed forecast's length (H 29)
              against their twins bit for bit, then timed.  (c) 20 x
              40,000 windowed on the card and on the CPU within ARIMA_REL.
              (d) 1 x 1,000,000 (126 windows): ok, finite, the int32 grid
              exact, wall time.  (e) WindowedSeriesStateStore at 500 x
              100,000 driven by RefitScheduler: a cold refit (13 windows'
              statistics), 3 days x 500 points ingested, a warm refit (one
              window's statistics, two tail-window refits on /metrics), a
              fresh store's cold refit bitwise equal to the warm one, a
              late point recomputing all 13; the refits' walls.  (f)
              catalog -> ingest (20 series x 40,000 days) -> train with
              conf/tasks/train_config.yml, ``model: arima``, CV off and the
              block armed: the frame over tail window + horizon, the
              artifact anchored at the history's first day (as the
              reference anchors it) predicting the frame's future rows
 18. runtime  the training runtime (``slice19_phase``) on the committed
              dataset.  (a) conf/tasks/train_config.yml as shipped (the
              curve model) and with ``model: holt_winters``, each pipelined
              and with ``async_tracking: false``, twice each in turns, the
              counters set to 0 around each task: the forecast table, the
              tracked params, tags, series table and non-timing metrics
              and the artifact byte-identical; the ``pipeline_*`` run
              metrics logged; hw_score and hw_filter launched through the
              executor.  (b) ``run_many`` of Holt-Winters, arima, theta and
              the curve model (CV 730/360/90, horizon 90) pipelined and
              serial in turns: walls, ``stage_metrics``, each experiment
              byte-identical between the modes, and one pipelined run
              traced for the card's idle share beside the executor's
              ``pipeline_device_idle_fraction``.  (c) The kernel library's
              ``compile_cache`` store in fresh processes: cold (nvcc),
              then at once warm (nvcc refused), a truncated entry (in a
              copy of the store) and a changed source (each rebuilt), each
              child holding hw_score against its twin.
              (d) A fresh cost registry: every kernel row's FLOPs and bytes
              equal its ``*_work`` count; the HW fit's charged seconds
              beside CUDA events.  (e) Tracing: a flight-recorder dump with
              the ``pipeline.*``, ``aot.call`` and ``windowed.*`` kinds, a
              ``ProfilerSession`` capture where a ``device_annotation``
              encloses an hw_score launch, the train task's wall with the
              tracer on and off
 19. scorer runtime (``slice20_phase``) on the committed dataset:
              Holt-Winters (its history sidecar, ``serving.ingest`` on) and
              arima fit on the card, the launch counters set to 0 just
              before the fits and read after (e), each served in this
              process from conf/tasks/serve_config.yml with batching, the
              anomaly scorer and ``serving.tracing`` (debug endpoints,
              profile, dump and JSONL directories) on.  (a) /invocations,
              /observe, /detect_anomalies and /ingest on the Holt-Winters
              scorer and /invocations on the arima one, each with a client
              X-Trace-Id: ``/debug/trace`` holds its tree under that id
              (``http.request`` root with status 200, ``batcher.*``,
              ``serving.predict``, ``aot.call``, ``quality.observe``,
              ``anomaly.score``, ``ingest.append``, ``state.update``), on two
              threads or more where the coalescer runs, the dispatch a child
              of the root.  (b) In a fresh child process serving both
              artifacts again, ``/debug/profile?seconds=2`` while a forced
              refit and arima traffic run (a second capture answers 409):
              hw_score and hw_filter inside the refit's
              ``pipeline_dispatch:refit:forced`` annotation, arima_predict
              inside ``serving_predict:arima``; ``refit.swap`` in the ring.
              (c) A request held past ``request_timeout_s`` answers 503
              and leaves a ``flight-*-http-503.trace.json`` dump.  (d) The
              seconds charged to ``serving_predict:arima`` over 10 predicts
              at 1, 5, 100 and 500 series against CUDA events at the same
              instants (0.8-1.2x) and around the whole call, the pad rows
              charged equal to the sum of (bucket - k), ``/debug/cost``'s
              ``serving_predict*`` rows, the ``dftpu_cost_*`` store rows
              after one scrape.  (e) /invocations p50 / p95 at 1 and 500
              series (horizon 7) with tracing on and off, 60 each, in
              turns of 10;
              one ``device_annotation`` and one span timed alone
 20. fleet    the serving fleet (``slice21_phase``) on the committed
              dataset: a Holt-Winters artifact with its history sidecar,
              served by ``python -m
              distributed_forecasting_tpu_torch.tasks.fleet`` on the
              shipped serve conf with 2 replicas, sharding (8 shards,
              replication 2), ingest with refits, breakers after 3
              failures and the kernel store phase 18 filled
              (``FLEET_CONF``; the cold build is measured there), beside a
              single ``tasks.serve`` scorer in this process on the same
              conf.  (a) /invocations of 1, 17 and 500 series through the
              front door byte-equal to the single scorer's (the 1-series
              request routed to one shard, the others scattered), and
              p50 / p95 through the front door and straight to a replica.
              (b) One /ingest of 500 points for one shard's series: every
              owner applies it (``dftpu_shard_ingest_points_total``,
              ``dftpu_ingest_applied_points_total``).  (c) Its backlog
              forces a refit in each replica: replica 0's
              ``/debug/profile`` capture holds hw_score and hw_filter
              inside ``pipeline_dispatch:refit:backlog``; the forecasts
              after it are byte-equal to the single scorer's, which
              applied the same points and refit.  (d) SIGKILL to replica 1
              while one keep-alive client streams: every request answers
              200 on the same connection; then replica 0 too.  (e) Each
              replica's first and restarted boot and their stages (its
              ready lines), restart-to-ready, the restarted library a
              store hit with no miss (no ``nvcc``).  (f) The fleet /metrics is
              ``aggregate_prometheus`` of the replicas' scrapes, and the
              front-door process holds no CUDA context.  After the
              restarts (each replica replays the shard WAL and refits on
              its backlog) the forecasts are byte-equal again; a SIGTERM
              drains the fleet and each replica's drain line gives its
              launches
 21. cache    the materialized forecast cache (``slice22_phase``) on the
              committed dataset: arima, Holt-Winters (history sidecar,
              ``serving.ingest`` on as phase 16 serves it), theta and the
              curve model fit and served by ``tasks.serve`` from the
              shipped conf twice, ``serving.cache`` on (quantile set 0.1,
              0.5, 0.9) and off, horizon 90.  (b) Every family's bodies at
              1, 17 and 500 series, point and quantiles, byte-equal on and
              off, each read twice on (the gather, then the encoded-body
              memo, which launches no kernel).  (f) Meanwhile two fleets
              of the theta artifact (2 replicas each, cache on and off)
              boot: front-door bodies byte-equal, each on-replica's frames
              under its own ``replica-<port>`` directory, the front door's
              ``dftpu_cache_entry_age_seconds`` the max of the replicas'.
              (a) Full-S rebuild wall and CUDA-event ms per family and
              signature (an arima rebuild launches arima_predict once).
              (c) arima /invocations p50 / p95 at 1, 17 and 500 series,
              hit against dispatch, and 32 clients for 2 s on and off.
              (d) Six one-day /ingest applies to the Holt-Winters scorers
              on and off (p50 / p95; ``swap_state`` to the republished
              frames), then a forced refit: after each write the first
              reads equal a fresh dispatch on the new state, the rebuilds
              ran on the writer's thread and on the default stream.  (e)
              Persist ms and bytes per 500-series entry, adoption at a
              restart of the task (no rebuild, byte-equal), and a copied
              frame discarded under state one streamed day moved
 22. parallel ``parallel/*`` over ``torch.distributed``
              (``slice23_phase``; its first line says which part measures
              what).  (a) One rank over NCCL on cuda:0 (``make_mesh()``):
              ``sharded_fit_forecast`` of Holt-Winters, arima and the curve
              model and ``sharded_cv_metrics`` of Holt-Winters with
              ``global_metric_means`` on the committed dataset, the launch
              counters set to 0 before and read after; each against the
              unsharded fit / CV pass on the card (bitwise for
              Holt-Winters, arima and the CV means, the curve model within
              ``CURVE_RTOL``), the means against a float64 host mean;
              sharded and unsharded walls in turns and the sharded fit's
              idle share.  (b) ``PAR_WORLD`` (2) processes of ``python3
              chip_smoke.py --parallel-rank PLAN`` on the one card over
              gloo, each through ``initialize_distributed`` and loading the
              library this run built (no ``nvcc``): ``host_local_frame`` of
              the CSV, its shard's fit and the global mean MAPE by one
              all-reduce (equal on both, within 1e-4 of one process's);
              ``sharded_fit_forecast``, ``sharded_cv_metrics`` and the
              means over the 2-rank mesh (within 1e-5 of (a)'s);
              ``gather_bottom_sharded`` of the forecasts (bitwise (a)'s);
              ``affine_scan_time_sharded``, ``parallel_filter_time_sharded``
              (m 7) and ``parallel_kalman_filter_time_sharded`` on one
              series of 2^20 steps, half a rank, against ``affine_scan``
              and the ``hw_filter`` / ``arima_filter`` kernels over the
              whole series (``PAR_*_TOL``); ``windowed_fit_forecast`` of
              500 x 100,000 over the mesh, equal on both ranks and within
              2e-4 of the unsharded fit.  Each rank's wall a step and the
              collectives' share of it.  A rank that exits nonzero or
              disagrees fails the phase
 23. mesh     a replica's predict over a mesh of ranks (``slice24_phase``;
              its first line says what it measures: two ranks sharing the
              card over gloo, the protocol's cost, not a speedup).  Arima
              and Holt-Winters artifacts of the committed dataset; three
              fleets boot at once, beside phase 21's (``main`` starts them
              before phase 21, which waits for them before its timed
              parts), on the shipped serve conf with one
              replica each (``mesh_fleet_conf``): arima at ``mesh_devices``
              2 and at 0, and Holt-Winters at 2 with ``serving.ingest`` on
              and a refit forced by a backlog of 500 points, beside a
              single Holt-Winters scorer in this process applying in the
              POST.  (a) /invocations at 1, 17 and 500 series (horizon 28),
              point and quantiles 0.1 / 0.5 / 0.9, byte-equal between the
              two arima fleets, and p50 / p95 of each at each size (20
              requests a size and fleet, in turns).  (c)
              SIGKILL to the mesh replica's follower: the replica leaves
              /readyz and exits 75, and while the supervisor restarts it
              (b) runs: one /ingest of 500 points to the Holt-Winters
              fleet and the single scorer, applied on the serving rank
              with a refit there (hw_score, hw_filter), bodies byte-equal
              to the single scorer's before and after; the other two
              fleets drain.  The restarted replica answers the same bytes;
              a SIGTERM drains it, and no pid of any replica or follower
              of the phase is left.  Both ranks' launches come from the
              drain lines (arima_predict on each rank of the arima mesh)
 24. tsan     the thread sanitizer armed on the card, and the Prophet MAP
              oracle (``slice25_phase``).  (a) Two processes armed as the
              reference's ``make tsan`` arms its tests (``TSAN_ENV``:
              ``DFTPU_TSAN=1``, a report directory, the ``sanitizer.yield``
              failpoint at 5% with seed 42), booted beside phase 21's
              fleets (``main`` starts them with ``start_tsan``) on phase
              23's artifacts and the shipped serve conf: a fleet of two
              replicas (8 shards x replication 2) serving the Holt-Winters
              artifact with ingest, a backlog refit, the coalescer and the
              cache on, and a single scorer (``TSAN_SCORER_CHILD``) of the
              arima artifact with the coalescer and the cache on.  Their
              bodies at 1, 17 and 500 series are byte-equal to disarmed
              scorers' in this process on the same artifacts, before and
              after the drive: ``TSAN_CLIENTS`` threads for
              ``TSAN_DRIVE_S`` seconds of /invocations at 1, 17 and 500
              series and /metrics scrapes, one /ingest of 500 points
              (to the disarmed Holt-Winters scorer too) whose backlog forces
              a refit in both replicas (hw_score, hw_filter); the scorer
              launches arima_predict.  SIGTERM ends every armed process,
              each writing its report at exit; the port's dftsan CLI in a
              child joins them with the static lock model and must exit 0
              with no unsuppressed error, and every one of the seven
              ``sanitizer.attach`` classes must appear in the reports.
              (b) ``models/prophet_map.cv_mape`` (float64 numpy / scipy)
              over the first 50 series in a child started with (a)'s
              processes, against the curve model's CV on the card over
              the same series: ``scripts/prophet_parity.compare``'s summary
              keys (``oracle_mape``, never ``prophet_mape``); a non-finite
              oracle result fails the phase
  phase 25    the croston and theta recurrences on their hand kernels
              (``csrc/ses.cu``, ``slice26_phase``): (a) croston_filter
              (every variant) and ses_filter (the seven alphas) against
              their twins on the card, bit for bit, at the fit shape
              (500 x 1,826), the CV pass's (1,500 rows with their train
              masks) and in the streaming update's forms (the error sums;
              theta's scored form, one alpha a row), each twin run once,
              each kernel's time beside its bound and the twin's; each
              kernel's slope over T (cycles a step) at the fit shape
              tiled 1, 2 and 4 times; (b) the main path through the entry
              points with both counters set to 0 just before it and read
              after: ``engine.fit_forecast`` of croston under each variant
              and of theta, ``cross_validate`` of each, one streaming
              ``apply_update`` of each, exactly one launch a fit, a CV pass
              and an update; finite outputs, 20 series card vs CPU; (c) the
              earlier phases' numbers now on the kernels: phase 8's blend
              dispatch (time, idle share, device events), phase 9's theta
              fit, phase 16's /ingest p99 per family, and each phase's
              launches of the two kernels (phases 8, 9, 10 and 16 fit
              croston or theta and must have launched them)

``python3 chip_smoke.py --kernel-times [--package-root DIR]`` builds the
kernels and runs only ``kernel_times``: hw_filter's slope, its probe
(this checkout only) and its times at 500 rows, one wave plus one row and
20,480 rows, arima_predict against its launch floor, hw_score's two
times and croston_filter's and ses_filter's slopes over T, on the port
found in DIR (a checkout of another commit) or in this
one, so that two commits compare in one call on one card.

The line before the last lists the kernels (launches, error, times,
``covered``, bound; only numbers this run measured or computed;
launches and error include phase 11's bucketed calls, phase 12's
arima_predict launches through HTTP, /invocations and /detect_anomalies,
phase 13's train task, phases 14-15's main paths and tasks, phase 16's
fit and forced refit, phase 17's fits, tail refits, train task and
artifact predict, phase 18's train tasks and ``run_many``, and phase
19's fits, forced refit and predicts, the launches phase 20's
replicas logged at their drain, and phase 21's fits, dispatches,
rebuilds and forced refit, phase 22's sharded path and its two
ranks' launches, and phase 23's fits, single scorer and every rank's
drained launches, and phase 24's disarmed scorers and armed processes'
launches; the arima rows add phase 17's kernel times at the
window's shapes; croston_filter's and ses_filter's launches are phase
25's main path, with every phase's launches of them beside);
the last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA device;
without one it exits 1 and prints no result.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pandas as pd
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "datasets", "store_item_demand.csv.gz")
RTOL, ATOL = 1e-5, 1e-6
# H100 SXM published peaks: HBM bytes/s, float32 (non-tensor-core) FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
REPS = 5
TWIN_REPS = 2  # samples of a launch-bound plain twin's ~0.6 s call
# runs of each workflow of phases 8-9 for the per-task medians, and samples
# of each monitor scan (host work: each run costs seconds); 2 keeps the
# drift scan (it runs from a store's second run on)
WORKFLOW_RUNS = 2
# the committed dataset: 500 (store, item) series x 1,826 days
SHAPE = (500, 1826)
# rolling-origin CV: 3 cutoffs at T = 1,826 (engine.CVConfig's fields)
CV = dict(initial=730, period=360, horizon=90)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS, inner: int = 1) -> float:
    """Median device time of one ``fn()``: ``reps`` samples after a warm-up,
    each ``inner`` back-to-back calls between two CUDA events on the current
    stream, divided by ``inner``."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


# the device-paced timing's lead: torch.cuda._sleep cycles queued before the
# start event, ~10 ms at the boost clock, longer than the host takes to
# enqueue the timed launches (device_ms checks that it was, and tries once
# more with a lead 8 times as long where it was not)
DEVICE_SLEEP_CYCLES = 20_000_000


def device_ms(fn, reps: int = REPS, inner: int = 20) -> dict:
    """Median device time of one ``fn()`` with the host out of the way: a
    sleep kernel queued first holds the stream while the host enqueues the
    start event, ``inner`` launches and the stop event, so the launches run
    back to back on the device.  ``covered``: in every sample the host had
    enqueued them all before the sleep ended (the sleep's own events say
    how long it ran); where it had not, the times are the host's pace and
    ``device_ms`` is None."""
    fn()
    torch.cuda.synchronize()
    for lead in (DEVICE_SLEEP_CYCLES, 8 * DEVICE_SLEEP_CYCLES):
        times, covered = [], True
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            torch.cuda._sleep(lead)
            t0 = time.perf_counter()
            ev[1].record()
            for _ in range(inner):
                fn()
            ev[2].record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            covered &= enqueue_ms < ev[0].elapsed_time(ev[1])
            times.append(ev[1].elapsed_time(ev[2]) / inner)
        if covered:
            return {"device_ms": statistics.median(times), "covered": True}
    return {"device_ms": None, "covered": False}


def bound_ms(work: tuple) -> tuple:
    """Least time for ``(operations, bytes)`` of work: the bytes at HBM rate
    or the float32 operations at the float32 peak, whichever is larger (the
    counts come from ops/fused_scan.hw_score_work / hw_filter_work)."""
    ops, nbytes = work
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_scores(got, want) -> dict:
    """Kernel vs twin scores: errors, tolerance, argmins (a differing argmin
    passes only as a near tie: the two candidates' twin scores within the
    tolerance of each other)."""
    diff = (got - want).abs()
    close = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    a_got, a_want = got.argmin(1), want.argmin(1)
    rows = torch.nonzero(a_got != a_want).flatten()
    w_got = want[rows, a_got[rows]]
    w_want = want[rows, a_want[rows]]
    near = bool(((w_got - w_want).abs() <= ATOL + RTOL * w_want.abs()).all())
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / want.abs().clamp_min(1e-30)).max()),
            "bitwise": bool(torch.equal(got, want)), "within_tol": close,
            "argmin_differs": int(rows.numel()), "near_ties_ok": near,
            "pass": close and near}


def cv_inputs(batch, cv, cv_conf=CV):
    """The CV pass's kernel inputs: the series repeated once per cutoff and
    each cutoff's train mask, ``(C*S, T)`` rows, as ``cross_validate`` gives
    them to the kernel (each row ends in a masked run of predict-only steps)."""
    T = batch.n_time
    cuts = cv.cutoff_indices(T, cv.CVConfig(**cv_conf))
    train_masks = cv.cv_windows(batch.mask, batch.day, cuts,
                                cv_conf["horizon"])[0]
    return batch.y.repeat(len(cuts), 1), train_masks.reshape(-1, T)


def compare_filter(got, want) -> dict:
    """hw_filter vs _filter: bitwise in every output (path, final states,
    MSE), with the largest difference for the record."""
    (l, b, s), mse, path = got
    (l2, b2, s2), mse2, path2 = want
    pairs = {"level": (l, l2), "trend": (b, b2), "season": (s, s2),
             "mse": (mse, mse2), "fitted": (path, path2)}
    equal = {k: bool(a.shape == w.shape and torch.equal(a, w))
             for k, (a, w) in pairs.items()}
    err = max(float((a - w).abs().nan_to_num(float("inf")).max())
              if a.numel() else 0.0 for a, w in pairs.values())
    return {"max_abs_err": err, "bitwise": all(equal.values()), **equal,
            "pass": all(equal.values())}


def _take_rows(out, at: int, n: int):
    """Rows ``[at, at + n)`` of every tensor in a twin's output (a tensor,
    or a tuple or named tuple of them, nested, with ``None`` kept)."""
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return out[at:at + n]
    parts = [_take_rows(x, at, n) for x in out]
    return type(out)(*parts) if hasattr(out, "_fields") else type(out)(parts)


def stacked_twins(twin, calls: dict, rows: int, key) -> dict:
    """``twin``'s output for each of ``calls`` (name -> args whose first
    ``rows`` entries lead with the series axis), from one twin call for
    each group of calls that ``key(args)`` puts together, their rows
    stacked.  Each twin works row by row, so a call's rows of the stacked
    call are what a call of its own gives; the comparisons that read them
    are bitwise or tolerance-grade as before, so a twin that did not would
    fail them.  One stacked call costs what one call costs: the twins are
    bound by their launches, not by their rows."""
    groups = {}
    for name, args in calls.items():
        groups.setdefault(key(args), []).append(name)
    out = {}
    for names in groups.values():
        first = calls[names[0]]
        want = twin(*(torch.cat([calls[n][i] for n in names])
                      for i in range(rows)), *first[rows:])
        at = 0
        for n in names:
            k = int(calls[n][0].shape[0])
            out[n] = _take_rows(want, at, k)
            at += k
    return out


def _grid_key(args) -> tuple:
    """hw_score's calls that one twin call covers: one T, season and grid."""
    return (int(args[0].shape[1]), args[6],
            tuple(x.cpu().numpy().tobytes() for x in args[2:6]))


def score_twins(port, calls: dict) -> dict:
    """hw_score_reference's scores for each of ``calls`` (args y, mask,
    alpha, beta, gamma, phi, m), stacked where they share a T, season and
    grid (:func:`stacked_twins`)."""
    return stacked_twins(port["fs"].hw_score_reference, calls, 2, _grid_key)


def filter_twins(port, calls: dict) -> dict:
    """``_filter``'s outputs for each of ``calls`` (args y, mask, alpha,
    beta, gamma, phi, m, mode; one parameter set a row), stacked where they
    share a T, season and mode (:func:`stacked_twins`)."""
    hw = port["hw"]
    return stacked_twins(
        lambda y, mask, a, b, g, p, m, mode: hw._filter(y, mask, a, b, g, m,
                                                        mode, p),
        calls, 6, lambda args: (int(args[0].shape[1]), args[6], args[7]))


def score_case(port, case: str, args, got, want=None) -> dict:
    """hw_score's output ``got`` on ``args`` (y, mask, alpha, beta, gamma,
    phi, m) against hw_score_reference on the same inputs (``want``, where
    the caller ran it); raises on a disagreement."""
    y, mask, a, b, g, p, m = args
    if want is None:
        want = port["fs"].hw_score_reference(y, mask, a, b, g, p, m)
    res = compare_scores(got, want)
    res.update(S=int(y.shape[0]), T=int(y.shape[1]), C=int(a.numel()), m=m)
    emit("kernel_vs_twin", kernel="hw_score", case=case, **res)
    if not res["pass"]:
        raise AssertionError(f"hw_score disagrees with its twin: {case}")
    return res


def filter_case(port, case: str, args, got, want=None) -> dict:
    """hw_filter's output ``got`` on ``args`` (y, mask, alpha, beta, gamma,
    phi, m, mode) against _filter on the same inputs (``want``, where the
    caller ran it); raises on a disagreement."""
    y, mask, a, b, g, p, m, mode = args
    if want is None:
        want = port["hw"]._filter(y, mask, a, b, g, m, mode, p)
    res = compare_filter(got, want)
    res.update(S=int(y.shape[0]), T=int(y.shape[1]), m=m, mode=mode)
    emit("kernel_vs_twin", kernel="hw_filter", case=case, **res)
    if not res["pass"]:
        raise AssertionError(f"hw_filter disagrees with its twin: {case}")
    return res


def kernel_cases(batch, port) -> dict:
    """Phase 3: each kernel against its twin on the card.  hw_filter refits
    the winners of the kernel's own scores, as ``fit`` does.  The twins run
    stacked where cases share their shapes (:func:`stacked_twins`)."""
    hw, fs = port["hw"], port["fs"]
    rng = np.random.default_rng(0)
    drop = torch.from_numpy((rng.random(tuple(batch.y.shape)) >= 0.1)
                            .astype(np.float32)).to(batch.y.device)
    full = batch.y * batch.mask
    cases = {
        "default_C96": (hw.HoltWintersConfig(), full, batch.mask),
        "damped_C288": (hw.HoltWintersConfig(damped=True), full, batch.mask),
        "masked_10pct": (hw.HoltWintersConfig(), full * drop,
                         batch.mask * drop),
        "season_m30": (hw.HoltWintersConfig(season_length=30), full,
                       batch.mask),
        "cv_1500": (hw.HoltWintersConfig(), *cv_inputs(batch, port["cv"])),
    }
    out, winners = {"hw_score": {}, "hw_filter": {}}, {}
    args = {name: (y, mask, *hw._candidate_grid(cfg, device=y.device),
                   cfg.season_length)
            for name, (cfg, y, mask) in cases.items()}
    wants = score_twins(port, args)
    for name, (cfg, y, mask) in cases.items():
        got = fs.hw_score(*args[name])
        torch.cuda.synchronize()
        out["hw_score"][name] = score_case(port, name, args[name], got,
                                           wants[name])
        best = got.argmin(1)
        winners[name] = (y, mask, *(x[best] for x in args[name][2:6]),
                         cfg.season_length)

    refits = {
        "fit_default_winners": (*winners["default_C96"], "additive"),
        "fit_damped_winners": (*winners["damped_C288"], "additive"),
        "fit_multiplicative": (*winners["default_C96"], "multiplicative"),
        "season_m30": (*winners["season_m30"], "additive"),
        "cv_1500": (*winners["cv_1500"], "additive"),
    }
    wants = filter_twins(port, refits)
    for name, args in refits.items():
        got = fs.hw_filter(*args)
        torch.cuda.synchronize()
        out["hw_filter"][name] = filter_case(port, name, args, got,
                                             wants[name])
    return out


def main_path(port, tmp: str) -> dict:
    """Phase 4: the user's main path, start to end."""
    data, engine, hw, serving = (port["data"], port["engine"], port["hw"],
                                 port["serving"])
    t0 = time.perf_counter()
    df = data.load_sales_csv(DATA)
    batch = data.tensorize(df)
    cfg = hw.HoltWintersConfig(filter="auto")
    params, result = engine.fit_forecast(batch, "holt_winters", config=cfg,
                                         horizon=90)
    frame = engine.forecast_frame(batch, result)
    metrics = engine.cross_validate(batch, "holt_winters", config=cfg,
                                    cv=engine.CVConfig(**CV))
    fc = serving.BatchForecaster.from_fit(batch, params, "holt_winters", cfg)
    fc.save(tmp)
    loaded = serving.BatchForecaster.load(tmp)
    rng = np.random.default_rng(1)
    requests = {k: batch.keys[rng.permutation(batch.n_series)[:k]]
                for k in (1, 17, 500)}
    answers = {k: loaded.predict(_request(keys)) for k, keys in requests.items()}
    quantiles = loaded.predict_quantiles(_request(requests[17]))
    torch.cuda.synchronize()
    return dict(batch=batch, params=params, result=result, frame=frame,
                metrics=metrics, requests=requests, answers=answers,
                quantiles=quantiles, seconds=time.perf_counter() - t0)


def _request(keys):
    return pd.DataFrame(np.asarray(keys), columns=["store", "item"])


def check_outputs(run, port) -> None:
    """Phase 5: what came out of the Holt-Winters main path is right."""
    engine, hw = port["engine"], port["hw"]
    batch = run["batch"]
    S = batch.n_series
    check_frames(run, "main_path")

    # the kernel-scored fit is bitwise the scan-scored fit where the winning
    # candidates agree (both refit the winner exactly, through hw_filter)
    p_k = run["params"]
    p_s = hw.fit(batch.y, batch.mask, batch.day,
                 hw.HoltWintersConfig(filter="scan"))
    same = torch.ones(S, dtype=torch.bool, device=batch.y.device)
    for f in ("alpha", "beta", "gamma", "phi"):
        same &= getattr(p_k, f) == getattr(p_s, f)
    for f in dataclasses.fields(p_k):
        a, b = getattr(p_k, f.name), getattr(p_s, f.name)
        if a.dim() and a.shape[0] == S:
            a, b = a[same], b[same]
        assert torch.equal(a, b), f"kernel fit != scan fit in {f.name}"
    emit("kernel_fit_vs_scan_fit", argmins_agree=int(same.sum()), of=S,
         bitwise_where_agree=True)

    # a small input against the same port on the CPU
    sub = batch.take_series(range(20))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    cfg = hw.HoltWintersConfig(filter="auto")
    _, r_gpu = engine.fit_forecast(sub, "holt_winters", config=cfg, horizon=90)
    _, r_cpu = engine.fit_forecast(cpu, "holt_winters", config=cfg, horizon=90)
    assert torch.equal(r_gpu.ok.cpu(), r_cpu.ok)
    scale = float(sub.y.abs().max())
    worst = 0.0
    for k in ("yhat", "lo", "hi"):
        a, b = getattr(r_gpu, k).cpu(), getattr(r_cpu, k)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)
        worst = max(worst, float((a - b).abs().max()))
    emit("gpu_vs_cpu_20_series", max_abs_diff=worst, tol=f"1e-5 + 1e-5*{scale}")


def fit_forecast_stages(batch, port, cfg, horizon: int = 90) -> tuple:
    """``engine.fit_forecast`` for the Holt-Winters model, step for step as
    ``fit`` and ``fit_forecast`` run it, with a CUDA event between the
    stages: scoring (initial states, row ends, hw_score), refit (argmin,
    winners, hw_filter), forecast, fail-safe.  Returns (milliseconds per
    stage, (params, result)); ``check_stages`` holds the outputs to
    ``fit_forecast``'s, so that this copy cannot drift from it."""
    hw, fs = port["hw"], port["fs"]
    from distributed_forecasting_tpu_torch.engine import fit as fit_mod

    y, mask, day = batch.y, batch.mask, batch.day
    m = cfg.season_length
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    grid = hw._candidate_grid(cfg, device=y.device)
    msec = fs.hw_score(y, mask, *grid, m)
    ev[1].record()
    best = torch.argmin(msec, dim=1)
    a, b, g, p = (x[best] for x in grid)
    (l, t, s), mse, fitted = fs.hw_filter(y, mask, a, b, g, p, m,
                                          cfg.seasonality_mode)
    params = hw.HWParams(alpha=a, beta=b, gamma=g, phi=p, level=l, trend=t,
                         season=s, sigma=torch.sqrt(mse), fitted=fitted,
                         day0=day[0].to(torch.float32),
                         t_fit_end=day[-1].to(torch.float32))
    ev[2].record()
    day_all = fit_mod.day_grid(day, horizon)
    yhat, lo, hi = hw.forecast(params, day_all, day[-1].to(torch.float32), cfg)
    ev[3].record()
    result = fit_mod.health_fallback(y, mask, yhat, lo, hi, horizon,
                                     fit_mod.DEFAULT_MIN_POINTS)
    ev[4].record()
    torch.cuda.synchronize()
    names = ("scoring", "refit", "forecast", "fail_safe")
    ms = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(names)}
    return ms, (params, result)


def check_stages(staged, params, result) -> None:
    """The staged copy's outputs equal ``fit_forecast``'s bit for bit (NaN
    where it has NaN): every fitted parameter, and yhat, lo, hi, ok."""
    p_s, r_s = staged
    pairs = [(getattr(p_s, f.name), getattr(params, f.name))
             for f in dataclasses.fields(params)]
    pairs += list(zip(r_s, (result.yhat, result.lo, result.hi, result.ok)))
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


# The trace's margins and attempts.  Once a process has made many
# launches, Kineto drops device events of a trace as "Out-of-range" of its
# window (its log's count; it also warns of kernels stamped before their
# own launch calls), erratically: a probe's kernels were lost in some
# traces and not in the next (PERF.md section 7), and late in the smoke
# the MLE fit's trace lost its hand kernels.
# So the trace opens TRACE_HEAD_S before the measured call and closes
# TRACE_TAIL_S after a marker kernel (aten's spin_kernel, under a host
# annotation) that ends it, and a trace that misses the marker or a hand
# kernel the call launched is taken again, up to TRACE_ATTEMPTS times,
# then reported "not measured".
TRACE_HEAD_S = 1.0
TRACE_TAIL_S = 0.5
TRACE_ATTEMPTS = 3
TAIL_MARK = "chip_smoke.trace_tail"


def wrapper(k: str):
    """The wrapper of hand kernel ``k`` (:data:`KERNELS`), which carries its
    launch counter."""
    from distributed_forecasting_tpu_torch.ops import fused_scan, kalman, ses

    return getattr(fused_scan if k.startswith("hw_") else
                   ses if k in SES_KERNELS else kalman, k)


def hand_launches() -> dict:
    """The launch counter of every hand kernel (:data:`KERNELS`)."""
    return {k: wrapper(k).launches for k in KERNELS}


def idle_share(fn, top_n: int = 0,
               margins: tuple = (TRACE_HEAD_S, TRACE_TAIL_S),
               attempts: int = TRACE_ATTEMPTS) -> dict:
    """The device's busy time (union of kernel intervals in a torch.profiler
    trace) over the host wall time of one ``fn()`` ending in a synchronize,
    the traced durations of the port's own kernels in it, the device events
    counted and timed by kind (:data:`EVENT_KINDS`), and the ``top_n``
    device event names by time with their counts; ``tail_lag_ms``, the
    marker kernel's start on the device's clock less its annotation's start
    on the host's; ``margins`` the seconds the trace stays open before
    the call and after the marker.  A trace that misses the marker or a
    hand kernel ``fn()`` launched (the counters say how many) is taken
    again with another call, ``attempts`` in all (1 where ``fn`` changes
    state); ``attempt`` says which one is reported.  Reports ``not
    measured`` if none is whole, or if the trace holds no device time (the
    profiler is optional on the card's machine; the rest of the run does
    not rest on it)."""
    for attempt in range(1, attempts + 1):
        res = _trace(fn, top_n, margins)
        res["attempt"] = attempt
        if res.get("reason") != "the trace dropped events":
            break
    return res


def _trace(fn, top_n: int, margins: tuple) -> dict:
    """One trace of ``fn()`` for :func:`idle_share`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    try:
        torch.cuda.synchronize()
        before = hand_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(margins[0])
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            with record_function(TAIL_MARK):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(margins[1])
        launched = {k: n - before[k] for k, n in hand_launches().items()}
        # the profiler's raw records, (name, device, start us, end us, user
        # annotation): building its FunctionEvent list instead costs ~70 us
        # an event in Python (tens of seconds for an arnet fit's trace)
        events = [(e.name(), e.device_type(), e.start_ns() / 1e3,
                   e.end_ns() / 1e3, e.is_user_annotation())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() not in ("[memory]", "[OutOfMemory]")
                  and not getattr(e, "is_hidden_event", lambda: False)()]
        # kernels and copies only: user annotations on the card's timeline
        # (torch.optim's "Optimizer.step#Adam.step") are not device work
        device = [e for e in events if e[1] == DeviceType.CUDA and not e[4]]
        tail = [e for e in device if "spin_kernel" in e[0]]
        device = [e for e in device if "spin_kernel" not in e[0]]
        mark = [e for e in events if e[0] == TAIL_MARK
                and e[1] == DeviceType.CPU]
        spans = sorted((e[2], e[3]) for e in device)
        own = {k: [(e[3] - e[2]) / 1e3 for e in device
                   if f"{k}_kernel" in e[0]]
               for k in KERNELS}
        names = {}
        for e in device:
            n, ms = names.get(e[0], (0, 0.0))
            names[e[0]] = (n + 1, ms + (e[3] - e[2]) / 1e3)
    except Exception as exc:  # noqa: BLE001 — reported, not hidden
        return {"idle_share": "not measured", "reason": repr(exc)}
    missing = {k: n - len(own[k]) for k, n in launched.items()
               if len(own[k]) < n}
    lag_ms = ((tail[0][2] - mark[0][2]) / 1e3
              if tail and mark else "not measured")
    if not tail or missing:
        return {"idle_share": "not measured",
                "reason": "the trace dropped events",
                "tail_marker_traced": bool(tail),
                "hand_kernels_missing": missing,
                "device_events_traced": len(spans), "tail_lag_ms": lag_ms}
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans or busy <= 0:
        return {"idle_share": "not measured", "reason": "no device time"}
    busy_ms = busy / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:top_n]
    by_kind = {}
    for name, (n, ms) in names.items():
        kind = next((k for k, keys in EVENT_KINDS.items()
                     if any(key in name for key in keys)), "other")
        c, t = by_kind.get(kind, (0, 0.0))
        by_kind[kind] = (c + n, t + ms)
    return {"idle_share": 1.0 - busy_ms / wall, "device_busy_ms": busy_ms,
            "wall_ms_profiled": wall, "device_events": len(spans),
            "kernel_ms": own, "hand_launches": launched,
            "tail_lag_ms": lag_ms,
            "events_by_kind": {k: {"count": n, "ms": ms}
                               for k, (n, ms) in sorted(by_kind.items())},
            "top_device_events": [{"name": k[:120], "count": n, "ms": ms}
                                  for k, (n, ms) in top]}


# device events by library or kind, matched on the kernel's name in order
EVENT_KINDS = {
    "gemm (cuBLAS)": ("gemm", "gemv"),
    "potrf (cuSOLVER)": ("potrf",),
    "trsm (cuBLAS)": ("trsm",),
    "sort": ("Sort", "sort"),
    "memcpy/memset": ("Memcpy", "Memset"),
    "hand kernels": ("hw_score_kernel", "hw_filter_kernel",
                     "arima_filter_kernel", "arima_predict_kernel",
                     "arima_loglik_grad_kernel", "arima_mle_fit_kernel",
                     "croston_filter_kernel", "ses_filter_kernel"),
}


def timings(run, port, card_line: str) -> dict:
    """Phase 6: device times at the main path's shapes.  Each kernel alone
    is timed over 20 back-to-back launches per sample, its arguments checked
    and bound beforehand (``_hw_*_launcher``) so that the host only launches
    and the device's queue stays ahead of it, with y and mask warm in the
    50 MB L2 as they are after ``_init_state`` reads them on the main
    path."""
    engine, hw, fs = port["engine"], port["hw"], port["fs"]
    batch = run["batch"]
    y, mask, p = batch.y, batch.mask, run["params"]
    cfg = hw.HoltWintersConfig(filter="auto")
    cv_y, cv_mask = cv_inputs(batch, port["cv"])

    def inputs(y, mask, cfg):
        grid = hw._candidate_grid(cfg, device=y.device)
        m = cfg.season_length
        init = [x.contiguous() for x in hw._init_state(y, mask, m, "additive")]
        best = fs.hw_score(y, mask, *grid, m).argmin(1)
        return grid, init, tuple(x[best] for x in grid), m

    def score(y, mask, cfg):
        grid, init, _, m = inputs(y, mask, cfg)
        launch, _ = fs._hw_score_launcher(y, mask, *grid, *init)
        ms = cuda_ms(launch, inner=20)
        C = int(grid[0].numel())
        bound, by = bound_ms(fs.hw_score_work(mask, C, m))
        return {"ms": ms, **device_ms(launch), "bound_ms": bound,
                "bound_by": by,
                "shape": [int(y.shape[0]), int(y.shape[1]), C, m]}

    def refit(y, mask, cfg):
        _, init, won, m = inputs(y, mask, cfg)
        launch, _ = fs._hw_filter_launcher(y, mask, *won, *init, "additive")
        ms = cuda_ms(launch, inner=20)
        S, T = (int(d) for d in y.shape)
        bound, by = bound_ms(fs.hw_filter_work(S, T, m))
        return {"ms": ms, **device_ms(launch), "bound_ms": bound,
                "bound_by": by, "shape": [S, T, m],
                "sass_chain_ms": T * HW_CHAIN_CYCLES / CLOCK_HZ * 1e3}

    shapes = {"fit": (y, mask, cfg), "cv": (cv_y, cv_mask, cfg),
              "damped": (y, mask, hw.HoltWintersConfig(damped=True))}
    k_score = {k: score(*v) for k, v in shapes.items()}
    k_filter = {k: refit(*v) for k, v in shapes.items()}
    grid = hw._candidate_grid(cfg, device=y.device)
    cv = engine.CVConfig(**CV)
    fc = port["serving"].BatchForecaster.from_fit(batch, p, "holt_winters", cfg)
    req = _request(batch.keys)
    fit_forecast = lambda: engine.fit_forecast(  # noqa: E731
        batch, "holt_winters", config=cfg, horizon=90)
    runs = [fit_forecast_stages(batch, port, cfg) for _ in range(REPS + 1)]
    check_stages(runs[0][1], *fit_forecast())
    stages = [ms for ms, _ in runs[1:]]
    t = {
        "hw_score_twin_ms": cuda_ms(lambda: fs.hw_score_reference(
            y, mask, *grid, 7), reps=TWIN_REPS),
        "hw_filter_twin_ms": cuda_ms(lambda: hw._filter(
            y, mask, p.alpha, p.beta, p.gamma, 7, "additive", p.phi),
            reps=TWIN_REPS),
        "fit_forecast_ms": cuda_ms(fit_forecast),
        "fit_forecast_stages_ms": {k: statistics.median(s[k] for s in stages)
                                   for k in stages[0]},
        "cv_pass_ms": cuda_ms(lambda: engine.cross_validate(
            batch, "holt_winters", config=cfg, cv=cv)),
        "predict_500_ms": cuda_ms(lambda: fc.predict(req)),
    }
    fit_forecast()
    t["fit_forecast_profile"] = idle_share(fit_forecast)
    t["hw_filter_slope"] = hw_filter_slope(port, batch)
    emit("times", card=card_line, reps=REPS, statistic="median",
         hw_score=k_score, hw_filter=k_filter,
         hw_chain_cycles_read_from_sass=HW_CHAIN_CYCLES, **t)
    return dict(t, hw_score=k_score["fit"], hw_filter=k_filter["fit"])


# -- the curve model (model: prophet, the default configuration) -------------

F32_EPS = 2.0 ** -24  # float32 unit roundoff
DEFERRED = []  # failures that let the measurements run first


def curve_config(batch, port):
    """The default configuration as the training task builds it: the task
    conf's ``holidays: US`` resolved over the batch's dates + the horizon."""
    conf = port["training"]._resolve_holidays_conf(
        {"seasonality_mode": "multiplicative", "holidays": "US"}, batch, 90)
    return port["pg"].CurveModelConfig(**conf)


def curve_systems(y, mask, day, cfg, port, xreg=None):
    """The penalized normal equations ``fit`` solves for these rows, built
    by the same functions: (X, A, b); with ``xreg``, its standardized
    columns join the design as they do in ``fit``."""
    pg, solve = port["pg"], port["solve"]
    zn, _, _ = pg._fit_target(y, mask, cfg)
    X, layout = pg._design(day, day[0].to(torch.float32),
                           day[-1].to(torch.float32), cfg)
    if xreg is not None:
        X, layout = pg.with_regressors(
            X, layout, pg._standardize_xreg(xreg, mask, cfg)[0])
    lam = pg._prior_precision(layout, cfg, device=y.device)
    A, b = solve.normal_equations(X, zn, mask, lam)
    return X, A, b


def cond_tolerance(A) -> tuple:
    """(10 * max cond(A) * 2^-24, max cond): the relative error a backward
    stable float32 solve of these systems may show, with room for 10 ulp."""
    kappa = float(torch.linalg.cond(A.double()).max())
    return 10.0 * kappa * F32_EPS, kappa


def curve_solve_cases(batch, port) -> dict:
    """Phase 3 for the curve model: the library solve (cuSOLVER potrf +
    cuBLAS trsm) against the floored Cholesky twin, on the card, at the
    fit's 500 and the CV pass's 1,500 systems; failed factorizations
    counted; the solve run under CUDA's sync check."""
    solve = port["solve"]
    cfg = curve_config(batch, port)
    out = {}
    for name, (y, mask) in {"fit_500": (batch.y, batch.mask),
                            "cv_1500": cv_inputs(batch, port["cv"])}.items():
        X, A, b = curve_systems(y, mask, batch.day, cfg, port)
        _, info = torch.linalg.cholesky_ex(A)
        failed = int((info != 0).sum())
        got = solve.batched_cho_solve(A, b)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            solve.batched_cho_solve(A, b)
            synced = False
        except RuntimeError:
            synced = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = solve._solve_cholesky_floored(A, b)
        tol, kappa = cond_tolerance(A)
        res = {"S": int(A.shape[0]), "F": int(A.shape[1]), "cond_max": kappa,
               "tol_rel": tol, "failed_factorizations": failed,
               "host_sync_in_solve": synced}
        ok = failed == 0
        for what, g, w in (("beta", got, want), ("path", got @ X.T, want @ X.T)):
            rel = float(((g - w).abs().amax(1) / w.abs().amax(1)).max())
            res[f"{what}_max_rel_err"] = rel
            ok = ok and rel <= tol
        res["max_abs_err"] = float((got - want).abs().max())
        res["pass"] = ok
        emit("curve_solve_vs_twin", case=name, **res)
        if synced:  # the measurements still run; main() fails at the end
            DEFERRED.append(f"the library solve synced with the host: {name}")
        if not ok:
            raise AssertionError(f"curve solve disagrees with its twin: {name}")
        out[name] = res
    return out


def curve_main_path(port, tmp: str) -> dict:
    """Phase 4 for the curve model: its main path, start to end."""
    data, engine, serving = port["data"], port["engine"], port["serving"]
    t0 = time.perf_counter()
    batch = data.tensorize(data.load_sales_csv(DATA))
    cfg = curve_config(batch, port)
    params, result = engine.fit_forecast(batch, "prophet", config=cfg,
                                         horizon=90)
    frame = engine.forecast_frame(batch, result)
    metrics = engine.cross_validate(batch, "prophet", config=cfg,
                                    cv=engine.CVConfig(**CV))
    fc = serving.BatchForecaster.from_fit(batch, params, "prophet", cfg)
    fc.save(tmp)
    loaded = serving.BatchForecaster.load(tmp)
    assert loaded.config == cfg
    rng = np.random.default_rng(2)
    requests = {k: batch.keys[rng.permutation(batch.n_series)[:k]]
                for k in (1, 17, 500)}
    answers = {k: loaded.predict(_request(keys)) for k, keys in requests.items()}
    quantiles = loaded.predict_quantiles(_request(requests[17]))
    torch.cuda.synchronize()
    return dict(batch=batch, cfg=cfg, params=params, result=result,
                frame=frame, metrics=metrics, requests=requests,
                answers=answers, quantiles=quantiles,
                seconds=time.perf_counter() - t0)


def check_frames(run, phase: str) -> dict:
    """The checks both main paths share: frame size and finiteness, ordered
    bands, 3 CV cutoffs with finite means, predict's rows and key order,
    quantiles finite and ordered.  Emits and returns the summary."""
    batch, frame, res = run["batch"], run["frame"], run["result"]
    S, T = batch.n_series, batch.n_time
    assert (S, T) == SHAPE, (S, T)
    assert len(frame) == S * (T + 90), len(frame)
    vals = frame[["yhat", "yhat_upper", "yhat_lower"]].to_numpy()
    assert np.isfinite(vals).all()
    assert (frame["yhat_lower"] <= frame["yhat_upper"]).all()
    means = {k: float(torch.nanmean(v)) for k, v in run["metrics"].items()
             if not k.startswith("_")}
    assert all(np.isfinite(v) for v in means.values()), means
    assert run["metrics"]["_n_cutoffs"] == 3
    for k, keys in run["requests"].items():
        out = run["answers"][k]
        assert len(out) == 90 * len(keys)
        assert np.isfinite(out[["yhat", "yhat_upper", "yhat_lower"]]
                           .to_numpy()).all()
        assert (out["yhat_lower"] <= out["yhat_upper"]).all()
        got = out[["store", "item"]].to_numpy()[::90]
        np.testing.assert_array_equal(got, keys)
    q = run["quantiles"]
    assert len(q) == 90 * len(run["requests"][17])
    assert np.isfinite(q[["q0.1", "q0.5", "q0.9"]].to_numpy()).all()
    assert ((q["q0.1"] <= q["q0.5"]) & (q["q0.5"] <= q["q0.9"])).all()
    summary = dict(series=S, days=T, frame_rows=len(frame),
                   ok=int(res.ok.sum()), cv_cutoffs=3, cv_means=means,
                   seconds=run["seconds"])
    emit(phase, **summary)
    return summary


def check_curve_outputs(run, port) -> None:
    """Phase 5 for the curve model."""
    engine = port["engine"]
    check_frames(run, "curve_main_path")
    sub = run["batch"].take_series(range(20))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    cfg = run["cfg"]
    _, r_gpu = engine.fit_forecast(sub, "prophet", config=cfg, horizon=90)
    _, r_cpu = engine.fit_forecast(cpu, "prophet", config=cfg, horizon=90)
    assert torch.equal(r_gpu.ok.cpu(), r_cpu.ok)
    tol, kappa = cond_tolerance(curve_systems(sub.y, sub.mask, sub.day, cfg,
                                              port)[1])
    worst = 0.0
    for k in ("yhat", "lo", "hi"):
        a, b = getattr(r_gpu, k).cpu(), getattr(r_cpu, k)
        rel = float(((a - b).abs().amax(1) / b.abs().amax(1)).max())
        assert rel <= tol, (k, rel, tol)
        worst = max(worst, rel)
    emit("curve_gpu_vs_cpu_20_series", max_rel_diff=worst, tol_rel=tol,
         cond_max=kappa)


def curve_stages(batch, port, cfg, horizon: int = 90) -> tuple:
    """``engine.fit_forecast`` for the curve model (l2, no regressors, no
    AR: the default configuration), step for step as ``fit`` and
    ``fit_forecast`` run it, with a CUDA event between the stages: design
    (fit-space target, design matrix, prior precision), Gram (normal
    equations), solve, residual scale, forecast, fail-safe.  Returns
    (milliseconds per stage, (params, result)); ``check_curve_stages`` holds
    the outputs bitwise to ``fit_forecast``'s."""
    pg, solve = port["pg"], port["solve"]
    from distributed_forecasting_tpu_torch.engine import fit as fit_mod

    y, mask, day = batch.y, batch.mask, batch.day
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    ev[0].record()
    t0, t1 = day[0].to(torch.float32), day[-1].to(torch.float32)
    zn, y_scale, cap = pg._fit_target(y, mask, cfg)
    X, layout = pg._design(day, t0, t1, cfg)
    lam = pg._prior_precision(layout, cfg, device=y.device)
    ev[1].record()
    A, b = solve.normal_equations(X, zn, mask, lam)
    ev[2].record()
    beta = solve.batched_cho_solve(A, b)
    ev[3].record()
    sigma = solve.weighted_residual_scale(X, zn, mask, beta)
    params = pg.CurveParams(
        beta=beta, sigma=sigma, y_scale=y_scale, cap=cap, t0=t0, t1=t1,
        **pg._no_regressors(y.device), **pg._no_ar(y.device))
    ev[4].record()
    day_all = fit_mod.day_grid(day, horizon)
    yhat, lo, hi = pg.forecast(params, day_all, day[-1].to(torch.float32), cfg)
    ev[5].record()
    result = fit_mod.health_fallback(y, mask, yhat, lo, hi, horizon,
                                     fit_mod.DEFAULT_MIN_POINTS)
    ev[6].record()
    torch.cuda.synchronize()
    names = ("design", "gram", "solve", "residual_scale", "forecast",
             "fail_safe")
    ms = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(names)}
    return ms, (params, result)


def curve_timings(run, port, card_line: str) -> dict:
    """Phase 6 for the curve model."""
    engine, solve, pg = port["engine"], port["solve"], port["pg"]
    batch, cfg = run["batch"], run["cfg"]
    cv = engine.CVConfig(**CV)
    fit_forecast = lambda: engine.fit_forecast(  # noqa: E731
        batch, "prophet", config=cfg, horizon=90)
    cv_pass = lambda: engine.cross_validate(  # noqa: E731
        batch, "prophet", config=cfg, cv=cv)
    runs = [curve_stages(batch, port, cfg) for _ in range(REPS + 1)]
    check_stages(runs[0][1], *fit_forecast())
    stages = [ms for ms, _ in runs[1:]]

    def lib(y, mask):
        """The Gram and the solve alone at these rows, beside their bounds,
        and the einsum Gram (one PyTorch call: the library yardstick)."""
        X, A, b = curve_systems(y, mask, batch.day, cfg, port)
        S, F = int(A.shape[0]), int(A.shape[1])
        T = int(X.shape[0])
        g_bound, g_by = bound_ms(solve.gram_work(S, T, F))
        s_bound, s_by = bound_ms(solve.cho_solve_work(S, F))
        g_ms = cuda_ms(lambda: solve.masked_gram(X, mask), inner=20)
        return {
            "shape": [S, T, F],
            "gram_ms": g_ms, "gram_bound_ms": g_bound, "gram_bound_by": g_by,
            "gram_share_of_bound": g_bound / g_ms,
            "gram_einsum_ms": cuda_ms(lambda: torch.einsum(
                "st,tf,tg->sfg", mask, X, X), inner=5),
            "solve_ms": cuda_ms(lambda: solve.batched_cho_solve(A, b),
                                inner=20),
            "potrf_ms": cuda_ms(lambda: torch.linalg.cholesky_ex(A), inner=20),
            "solve_bound_ms": s_bound, "solve_bound_by": s_by,
            "solve_twin_ms": cuda_ms(
                lambda: solve._solve_cholesky_floored(A, b)),
        }

    shapes = {"fit": (batch.y, batch.mask), "cv": cv_inputs(batch, port["cv"])}
    library = {k: lib(*v) for k, v in shapes.items()}
    for v in library.values():
        v["solve_share_of_bound"] = v["solve_bound_ms"] / v["solve_ms"]
    X = pg._design(batch.day, batch.day[0].float(), batch.day[-1].float(),
                   cfg)[0]
    fc = port["serving"].BatchForecaster.from_fit(batch, run["params"],
                                                  "prophet", cfg)
    req = _request(batch.keys)
    t = {
        "fit_forecast_ms": cuda_ms(fit_forecast),
        "fit_forecast_stages_ms": {k: statistics.median(s[k] for s in stages)
                                   for k in stages[0]},
        "cv_pass_ms": cuda_ms(cv_pass),
        "predict_500_ms": cuda_ms(lambda: fc.predict(req)),
        "design_ms": cuda_ms(lambda: pg._design(
            batch.day, batch.day[0].float(), batch.day[-1].float(), cfg)),
        "F": int(X.shape[1]),
        "library": library,
    }
    fit_forecast()
    t["fit_forecast_profile"] = idle_share(fit_forecast, top_n=12)
    cv_pass()
    t["cv_pass_profile"] = idle_share(cv_pass, top_n=12)
    emit("curve_times", card=card_line, reps=REPS, statistic="median", **t)
    return t


# -- the forecasting-e2e workflow: catalog -> ingest -> train with conformal
# bands -> deploy -> inference, through the port's workflow runner -----------

WORKFLOWS = os.path.join(ROOT, "conf", "workflows.yml")
E2E = "forecasting-e2e"
TASKS = ["catalog", "etl", "train", "deploy", "inference"]
E2E_TASKS = TASKS + ["monitor"]


def e2e_spec(port, name: str = E2E) -> dict:
    """``conf/workflows.yml``'s workflow ``name`` as the runner reads it,
    every node of it, with its conf_file and input paths made absolute."""
    spec = port["config"].load_conf(WORKFLOWS)
    spec["workflows"] = [w for w in spec["workflows"] if w["name"] == name]
    wf = spec["workflows"][0]
    for t in wf["tasks"]:
        if t.get("conf_file"):
            t["conf_file"] = os.path.join(ROOT, t["conf_file"])
        inp = t.get("conf", {}).get("input", {})
        if inp.get("path"):
            inp["path"] = os.path.join(ROOT, inp["path"])
    return spec


def task_conf(spec, task: str) -> dict:
    return next(t["conf"] for t in spec["workflows"][0]["tasks"]
                if t["task"] == task)


class DeviceSpy:
    """Records the device of the batch, the forecast and the conformal
    scales that the training pipeline's ``fit_forecast`` and
    ``cross_validate`` see and return, without waiting for the device."""

    def __init__(self, training):
        self.training, self.devices = training, {}

    def __enter__(self):
        tr, seen = self.training, self.devices
        self._orig = fit_forecast, cross_validate = (tr.fit_forecast,
                                                     tr.cross_validate)

        def fit_spy(batch, **kw):
            params, result = fit_forecast(batch, **kw)
            seen.update(batch=batch.y.device.type,
                        forecast=result.yhat.device.type)
            return params, result

        def cv_spy(batch, **kw):
            out = cross_validate(batch, **kw)
            seen["interval_scale"] = out["_interval_scale"].device.type
            return out

        tr.fit_forecast, tr.cross_validate = fit_spy, cv_spy
        return self

    def __exit__(self, *exc):
        self.training.fit_forecast, self.training.cross_validate = self._orig


def workflow_main_path(port, root: str, spec: dict, device="cuda") -> dict:
    """A workflow of ``spec``, start to end, on ``device``, with the devices
    the training pipeline's fit and CV saw."""
    t0 = time.perf_counter()
    with DeviceSpy(port["training"]) as spy:
        results = port["runner"].WorkflowRunner(
            spec, env={"root": root}, device=device).run(
                spec["workflows"][0]["name"])
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(results=results, devices=spy.devices,
                seconds=time.perf_counter() - t0)


def _store(port, root):
    """The workflow's catalog, tracker and registry under ``root``."""
    t = port["tracking"]
    return (port["data"].DatasetCatalog(os.path.join(root, "warehouse")),
            t.FileTracker(os.path.join(root, "mlruns")),
            t.ModelRegistry(os.path.join(root, "registry")))


def _check_table(df, keys, dates, what: str) -> None:
    """Rows are every key over ``dates``, in key-major order; the values
    finite and ordered lo <= yhat <= hi."""
    S, D = len(keys), len(dates)
    assert len(df) == S * D, (what, len(df), S * D)
    np.testing.assert_array_equal(df[["store", "item"]].to_numpy()[::D], keys)
    np.testing.assert_array_equal(
        df["ds"].to_numpy().reshape(S, D),
        np.broadcast_to(dates.values, (S, D)))
    vals = df[["yhat", "yhat_upper", "yhat_lower"]].to_numpy()
    assert np.isfinite(vals).all(), what
    assert (df["yhat_lower"] <= df["yhat"]).all(), what
    assert (df["yhat"] <= df["yhat_upper"]).all(), what


def check_monitor(results, port, root: str, spec: dict, version: int) -> dict:
    """The monitor node's checks: its summary, and the tables it wrote over
    the monitored table's current version — the profile, the flagged rows,
    the degradation report, and from the table's second version on the
    drift report (on the first the task skips the scan)."""
    mc = task_conf(spec, "monitor")["monitor"]
    out = results["monitor"]["result"]
    catalog = _store(port, root)[0]
    table = mc["table"]
    assert len(catalog.table_versions(table)) == version
    assert out["monitor"] == mc["name"] and out["rows"] > 0, out
    assert np.isfinite(out["daily_mape_mean"]), out
    assert ("n_drifted" in out) == (version >= 2), (version, out)
    profile = catalog.read_table(f"{table}_profile_metrics")
    assert len(profile) == out["rows"]
    flagged = catalog.read_table(f"{table}_anomalies")
    assert len(flagged) == out["n_anomalies"] and flagged["is_anomaly"].all()
    report = catalog.read_table(f"{table}_degradation")
    assert int(report["degraded"].sum()) == out["n_degraded"]
    if version >= 2:
        drift = catalog.read_table(f"{table}_drift")
        assert int(drift["drifted"].sum()) == out["n_drifted"]
    return out


def check_workflow(run, port, root: str, spec: dict, device="cuda",
                   version: int = 1) -> dict:
    """Phase 7's checks: every task OK, the train run on the card, both
    tables' keys, dates, rows and values, the 500 conformal scales, the
    calibrated coverage logged beside the raw, the registered version and
    its tags and stage, the registered artifact predicting what the train
    run's artifact predicts, and the monitor's summary and tables."""
    results = run["results"]
    assert list(results) == E2E_TASKS, list(results)
    assert all(r["status"] == "OK" for r in results.values()), results
    assert run["devices"] == {"batch": device, "forecast": device,
                              "interval_scale": device}, run["devices"]
    synth = task_conf(spec, "ingest")["input"]["synthetic"]
    tr = task_conf(spec, "train")
    horizon = int(tr["training"]["horizon"])
    h_inf = int(task_conf(spec, "inference")["inference"]["horizon"])
    S = int(synth["n_stores"]) * int(synth["n_items"])
    T = int(synth["n_days"])
    catalog, tracker, registry = _store(port, root)
    keys = np.array([(s, i) for s in range(1, synth["n_stores"] + 1)
                     for i in range(1, synth["n_items"] + 1)])
    dates = pd.date_range("2013-01-01", periods=T + horizon)
    forecasts = catalog.read_table(tr["output"]["table"])
    _check_table(forecasts, keys, dates, "forecast table")
    inf_conf = task_conf(spec, "inference")
    served = catalog.read_table(inf_conf["output"]["table"])
    _check_table(served, keys, dates[T:T + h_inf], "inference table")

    summary = results["train"]["result"]
    assert summary["n_series"] == S and summary["n_failed"] == 0, summary
    train_run = tracker.get_run(summary["experiment_id"], summary["run_id"])
    metrics = train_run.metrics()
    assert {"val_coverage", "val_coverage_calibrated"} <= set(metrics)
    backend = train_run.params()["tensorize_backend"]
    assert backend == "native", backend
    table = pd.read_parquet(train_run.artifact_path("series_metrics.parquet"))
    scales = table["interval_scale"].to_numpy()
    assert scales.shape == (S,) and np.isfinite(scales).all()
    assert (scales > 0).all()

    model_name = inf_conf["inference"]["model_name"]
    registered_version = version
    version = registry.latest_version(model_name)
    assert (version.version, version.stage) == (registered_version,
                                                "Staging"), version
    assert version.tags["model_family"] == "prophet", version.tags
    registered, _ = port["serving"].resolve_from_registry(
        registry, model_name, device=device)
    trained = port["serving"].load_forecaster(
        train_run.artifact_path("forecaster"), device=device)
    request = pd.DataFrame(keys, columns=["store", "item"])
    got = registered.predict(request, horizon=h_inf)
    pd.testing.assert_frame_equal(got, trained.predict(request, horizon=h_inf))
    # (the table's parquet round trip changes the ds unit, not the dates)
    pd.testing.assert_frame_equal(got, served[got.columns], check_dtype=False)
    # the train run's own forecast over the same days, within float32
    future = forecasts.groupby(["store", "item"], sort=False).nth(
        list(range(T, T + h_inf)))
    for col in ("yhat", "yhat_upper", "yhat_lower"):
        a = got[col].to_numpy().reshape(S, -1)
        b = future[col].to_numpy().reshape(S, -1)
        scale = np.abs(b).max(axis=1, keepdims=True)
        assert (np.abs(a - b) <= 1e-5 * scale).all(), col
    out = dict(
        tasks_seconds={k: r["seconds"] for k, r in results.items()},
        seconds=run["seconds"], series=S, days=T,
        forecast_rows=len(forecasts), inference_rows=len(served),
        fit_seconds=metrics["fit_seconds"],
        phases={k: v for k, v in metrics.items() if k.startswith("phase_")},
        tensorize_backend=backend,
        val_coverage=metrics["val_coverage"],
        val_coverage_calibrated=metrics["val_coverage_calibrated"],
        interval_scale_mean=metrics["interval_scale_mean"],
        interval_scale_range=[float(scales.min()), float(scales.max())],
        registry={"version": version.version, "stage": version.stage,
                  "model_family": version.tags["model_family"]},
        devices=run["devices"],
        monitor=check_monitor(results, port, root, spec, registered_version))
    emit("workflow", **out)
    return out


def train_stages(port, root: str, spec: dict, device="cuda"):
    """The workflow's train task as its pipeline runs it, stage by stage,
    with the arguments the train task passes."""
    from distributed_forecasting_tpu_torch.tasks.train import (
        fine_grained_options,
    )

    catalog, tracker, _ = _store(port, root)
    pipe = port["training"].TrainingPipeline(catalog, tracker, device=device)
    return pipe.fine_grained_stages(
        **fine_grained_options(task_conf(spec, "train")))


def cv_paths(port, batch, config, cv_conf):
    cv = port["cv"]
    cuts = cv.cutoff_indices(batch.n_time, cv.CVConfig(**cv_conf))
    return cv._cv_paths(batch, "prophet", config, cuts, cv_conf["horizon"])


def conformal_vs_cpu(port, batch, config, cv_conf, n: int = 20) -> dict:
    """A 20-series ``cross_validate(calibrate=True)`` on the card and on
    the CPU: the CV paths within the tolerance their conditioning gives
    (10 * cond(A) * 2^-24 of each row's scale), the conformal ranks equal,
    and each scale within the largest change of the scores it is an order
    statistic of (of every series' scores where the pooled one stands in)."""
    cal, cv = port["cal"], port["cv"]
    sub = batch.take_series(range(n))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    cvc = cv.CVConfig(**cv_conf)
    out_gpu = cv.cross_validate(sub, "prophet", config=config, cv=cvc,
                                calibrate=True)
    out_cpu = cv.cross_validate(cpu, "prophet", config=config, cv=cvc,
                                calibrate=True)
    paths = {}
    for name, b in (("gpu", sub), ("cpu", cpu)):
        yhat, _, hi, em, _ = cv_paths(port, b, config, cv_conf)
        half = hi - yhat
        obs = (em > 0) & (half > 1e-6 * (yhat.abs() + 1e-9))
        r = torch.where(obs, (b.y[None] - yhat).abs() / half.clamp_min(1e-9),
                        0.0)
        n_obs = obs.sum((0, 2)).float()
        width = torch.full((), cal.config_interval_width(config),
                           dtype=torch.float32, device=n_obs.device)
        paths[name] = dict(yhat=yhat.cpu(), hi=hi.cpu(), obs=obs.cpu(),
                           r=r.cpu(), n=n_obs.cpu(),
                           k=cal._conformal_rank(n_obs, width).cpu())
    g, c = paths["gpu"], paths["cpu"]
    assert torch.equal(g["obs"], c["obs"]) and torch.equal(g["k"], c["k"])
    assert cv_conf == CV, cv_conf  # cv_inputs builds CV's windows
    _, A, _ = curve_systems(*cv_inputs(sub, port["cv"]), sub.day, config, port)
    tol, kappa = cond_tolerance(A)
    worst_path = 0.0
    for k in ("yhat", "hi"):
        a, b = g[k].reshape(-1, g[k].shape[-1]), c[k].reshape(-1, c[k].shape[-1])
        rel = float(((a - b).abs().amax(1) / b.abs().amax(1)).max())
        assert rel <= tol, (k, rel, tol)
        worst_path = max(worst_path, rel)
    diff = (g["r"] - c["r"]).abs()
    per_series = diff.amax((0, 2))
    bound = torch.where(c["n"] >= 30, per_series, diff.max())
    s_gpu, s_cpu = out_gpu["_interval_scale"].cpu(), out_cpu["_interval_scale"]
    err = (s_gpu - s_cpu).abs()
    assert bool((err <= bound + F32_EPS * 2 * s_cpu.abs()).all()), (err, bound)
    res = dict(series=n, ranks_equal=True, path_max_rel_diff=worst_path,
               path_tol_rel=tol, cond_max=kappa,
               scale_max_abs_diff=float(err.max()),
               scale_bound_max=float(bound.max()))
    emit("workflow_gpu_vs_cpu_20_series", **res)
    return res


def workflow_timings(port, root: str, spec: dict, card_line: str) -> dict:
    """Phase 7's times: the device's idle share over the train task's
    dispatch stage (the CV pass with its conformal scales, the fit, the
    calibrated bands), and the conformal scale alone at the CV shape beside
    its bound, with its sort launches, and run under CUDA's sync check."""
    cal = port["cal"]
    prep, dispatch, _ = train_stages(port, root, spec)
    state = prep()
    dispatch(dict(state))  # warm-up
    torch.cuda.synchronize()
    profile = idle_share(lambda: dispatch(dict(state)), top_n=12)
    batch, config = state["batch"], state["config"]
    cv_conf = task_conf(spec, "train")["training"]["cv"]
    yhat, _, hi, em, _ = cv_paths(port, batch, config, cv_conf)
    width = cal.config_interval_width(config)
    scale = lambda: cal.conformal_scale_from_paths(  # noqa: E731
        batch.y, yhat, hi, em, interval_width=width)
    C, S, T = (int(d) for d in yhat.shape)
    bound, by = bound_ms(cal.conformal_scale_work(C, S, T))
    ms = cuda_ms(scale, inner=20)
    scale_profile = idle_share(scale, top_n=6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scale()
        synced = False
    except RuntimeError:
        synced = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if synced:  # the measurements still run; main() fails at the end
        DEFERRED.append("the conformal scale synced with the host")
    t = dict(dispatch_profile=profile,
             conformal={"shape": [C, S, T], "ms": ms, "bound_ms": bound,
                        "bound_by": by, "share_of_bound": bound / ms,
                        "host_sync": synced,
                        "events_by_kind": scale_profile.get("events_by_kind"),
                        "top_device_events": scale_profile.get(
                            "top_device_events")})
    emit("workflow_times", card=card_line, reps=REPS, statistic="median", **t)
    return dict(t, state=state, cv_conf=cv_conf)


# -- phase 8: the pooled workflows, real-data-e2e and forecasting-blend ------

REAL = "real-data-e2e"
BLEND = "forecasting-blend"
POOLED_TASKS = {REAL: E2E_TASKS, BLEND: TASKS + ["promote"]}
# the croston recurrence's dependent chain per step (csrc/ses.cu): the size
# and interval updates, each a multiply, an add and a select (the SASS of
# croston_filter_kernel, scripts/cuda_kernel_report.py --chain, carries
# them as FMUL, FADD and a predicated select), ~16 cycles; T such steps at
# the card's 1.98 GHz boost clock, whatever the width (as HW_CHAIN_CYCLES
# counts hw_filter's)
CROSTON_CHAIN_CYCLES = 16
CLOCK_HZ = 1.98e9


class KernelRecorder:
    """Records every hw_score and hw_filter call that the Holt-Winters
    module ``hw`` makes, inputs and output: ``calls[kernel]`` is a list of
    ``(args, out)``."""

    def __init__(self, hw):
        self.hw = hw
        self.calls = {"hw_score": [], "hw_filter": []}

    def __enter__(self):
        self._orig = {k: getattr(self.hw, k) for k in self.calls}
        for name, fn in self._orig.items():
            def call(*args, _fn=fn, _name=name):
                out = _fn(*args)
                self.calls[_name].append((args, out))
                return out
            setattr(self.hw, name, call)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.hw, name, fn)


class PoolSpy:
    """For each train task of a pooled workflow: sets the launch counters
    to 0 as the training pipeline starts and reads them as it returns, and
    records the devices of the batch and the blended forecast, and the
    member configs the blend was given.  With ``hw`` (the
    Holt-Winters module) it also records every hw_score and hw_filter call
    that module makes, inputs and output, for :func:`pooled_kernel_cases`."""

    def __init__(self, training, counters, hw=None):
        self.training, self.counters = training, counters
        self.launches, self.devices, self.configs = [], {}, {}
        self.recorder = None if hw is None else KernelRecorder(hw)
        self.calls = {} if hw is None else self.recorder.calls

    def __enter__(self):
        tr, spy = self.training, self
        self._orig = fine, blend = (tr.TrainingPipeline.fine_grained,
                                    tr.fit_forecast_blend)

        def fine_spy(pipe, *a, **kw):
            for fn in spy.counters.values():
                fn.launches = 0
            out = fine(pipe, *a, **kw)
            spy.launches.append({k: fn.launches
                                 for k, fn in spy.counters.items()})
            return out

        def blend_spy(batch, **kw):
            params, pool, result = blend(batch, **kw)
            spy.devices.update(batch=batch.y.device.type,
                               forecast=result.yhat.device.type)
            spy.configs = kw.get("configs") or {}
            return params, pool, result

        tr.TrainingPipeline.fine_grained = fine_spy
        tr.fit_forecast_blend = blend_spy
        if self.recorder is not None:
            self.recorder.__enter__()
        return self

    def __exit__(self, *exc):
        tr = self.training
        tr.TrainingPipeline.fine_grained, tr.fit_forecast_blend = self._orig
        if self.recorder is not None:
            self.recorder.__exit__(*exc)


def pooled_run(port, root: str, spec: dict, counters,
               record: bool = False) -> dict:
    """One run of a pooled workflow in ``root``, on the card; with
    ``record``, the train task's kernel calls and member configs too."""
    name = spec["workflows"][0]["name"]
    t0 = time.perf_counter()
    with PoolSpy(port["training"], counters,
                 port["hw"] if record else None) as spy:
        results = port["runner"].WorkflowRunner(
            spec, env={"root": root}, device="cuda").run(name)
    torch.cuda.synchronize()
    assert len(spy.launches) == 1, spy.launches
    out = dict(results=results, devices=spy.devices,
               launches=spy.launches[0], seconds=time.perf_counter() - t0)
    if record:
        out.update(calls=spy.calls, configs=spy.configs)
    return out


def pooled_kernel_cases(port, run, path: str) -> dict:
    """Phase 8's kernel cases: every hw_score and hw_filter call the train
    task of ``path`` made (its CV rows and its full history, at the season
    it detected or was given and the default grid), the output the path
    got held against the twin on the same inputs, as phase 3 holds it."""
    out = {"hw_score": {}, "hw_filter": {}}
    for kernel, case, twins in (("hw_score", score_case, score_twins),
                                ("hw_filter", filter_case, filter_twins)):
        calls = run["calls"][kernel]
        assert len(calls) == run["launches"][kernel], (kernel, len(calls))
        named = {f"{path}_call{i}_{args[0].shape[0]}x{args[0].shape[1]}":
                 (args, got) for i, (args, got) in enumerate(calls)}
        wants = twins(port, {n: a for n, (a, _) in named.items()})
        for name, (args, got) in named.items():
            out[kernel][name] = case(port, name, args, got, wants[name])
    return out


def check_pooled(run, port, root: str, spec: dict, version: int) -> dict:
    """Phase 8's checks of one pooled run: every task OK on the card, both
    hand kernels launched by the train task, the forecast and inference
    tables (keys, dates, finite, lo <= yhat <= hi), the weights (finite,
    each series' summing to 1), the pooled band's floor, the conformal
    scales, the registered version, its family tag and stage, and the
    registered artifact reproducing the train run's forecast within
    1e-5."""
    name = spec["workflows"][0]["name"]
    results = run["results"]
    assert list(results) == POOLED_TASKS[name], list(results)
    assert all(r["status"] == "OK" for r in results.values()), results
    assert run["devices"] == {"batch": "cuda", "forecast": "cuda"}, run
    for k, n in run["launches"].items():
        assert n >= 1, f"the {name} train task never launched {k}"
    catalog, tracker, registry = _store(port, root)
    tr = task_conf(spec, "train")
    horizon = int(tr["training"]["horizon"])
    summary = results["train"]["result"]
    train_run = tracker.get_run(summary["experiment_id"], summary["run_id"])
    table = pd.read_parquet(train_run.artifact_path("series_metrics.parquet"))
    keys = table[["store", "item"]].to_numpy()
    S = len(keys)
    assert summary["n_series"] == S, summary
    families = tr["training"]["model_conf"]["families"]
    weights = table[[f"weight_{f}" for f in families]].to_numpy()
    assert np.isfinite(weights).all() and (weights >= 0).all()
    assert np.abs(weights.sum(axis=1) - 1.0).max() <= 1e-9
    scales = table["interval_scale"].to_numpy()
    assert np.isfinite(scales).all() and (scales > 0).all()
    forecasts = catalog.read_table(tr["output"]["table"])
    T = len(forecasts) // S - horizon
    dates = pd.DatetimeIndex(forecasts["ds"].iloc[:T + horizon])
    _check_table(forecasts, keys, dates, f"{name} forecast table")
    inf_conf = task_conf(spec, "inference")
    h_inf = int(inf_conf["inference"]["horizon"])
    served = catalog.read_table(inf_conf["output"]["table"])
    # the inference task keeps its input's first-occurrence key order
    served_keys = served[["store", "item"]].drop_duplicates().to_numpy()
    _check_table(served, served_keys, dates[T:T + h_inf],
                 f"{name} inference table")
    row = {tuple(k): i for i, k in enumerate(keys.tolist())}
    order = np.asarray([row[tuple(k)] for k in served_keys.tolist()])
    assert sorted(order.tolist()) == list(range(S))
    floor = port["blend"].blend_band_floor(families)
    if floor is not None:
        assert (forecasts["yhat_lower"] >= floor).all()

    model_name = inf_conf["inference"]["model_name"]
    v = registry.get_version(model_name, version)
    family = "blend:" + ",".join(families)
    assert v.tags["model_family"] == family, v.tags
    registered, latest = port["serving"].resolve_from_registry(
        registry, model_name, device="cuda")
    assert latest.version == version, latest
    assert type(registered).__name__ == "BlendedForecaster"
    hw_member = registered.forecasters["holt_winters"]
    request = pd.DataFrame(served_keys, columns=["store", "item"])
    got = registered.predict(request, horizon=h_inf)
    pd.testing.assert_frame_equal(got, served[got.columns], check_dtype=False)
    future = forecasts.groupby(["store", "item"], sort=False).nth(
        list(range(T, T + h_inf)))
    for col in ("yhat", "yhat_upper", "yhat_lower"):
        a = got[col].to_numpy().reshape(S, -1)
        b = future[col].to_numpy().reshape(S, -1)[order]
        scale = np.abs(b).max(axis=1, keepdims=True)
        assert (np.abs(a - b) <= 1e-5 * scale).all(), col
    metrics = train_run.metrics()
    out = dict(
        workflow=name, tasks_seconds={k: r["seconds"]
                                      for k, r in results.items()},
        seconds=run["seconds"], series=S, days=T, launches=run["launches"],
        fit_seconds=metrics["fit_seconds"],
        val_smape=metrics["val_smape"],
        mean_weights={f: metrics[f"mean_weight_{f}"] for f in families},
        interval_scale_range=[float(scales.min()), float(scales.max())],
        pooled_band_floor=floor, season_length=hw_member.config.season_length,
        registry={"version": v.version, "stage": latest.stage,
                  "model_family": family})
    if "promote" in results:
        out["promote"] = results["promote"]["result"]
    if "monitor" in results:
        out["monitor"] = check_monitor(results, port, root, spec, version)
    return out


def check_promote(first: dict, second: dict, spec: dict) -> dict:
    """The second forecasting-blend run's promote decides by its rule
    against the first run's champion."""
    pr = task_conf(spec, "promote")["promote"]
    p1, p2 = first["promote"], second["promote"]
    assert p1["promoted"] and p1["baseline_value"] is None, p1
    assert p2["candidate_version"] == 2 and p2["baseline_value"] is not None
    assert p2["baseline_value"] == first["val_smape"], (p2, first)
    assert pr["rule"] == "not_worse", pr
    b, c = p2["baseline_value"], p2["candidate_value"]
    assert p2["promoted"] == (c <= b + float(pr["tolerance"]) * abs(b)), p2
    assert second["registry"]["stage"] == (
        "Production" if p2["promoted"] else "Staging"), second
    return {"first": p1, "second": p2}


# each recurrence family's limit on the relative card-vs-CPU change of its
# CV score: float32 elementwise recurrences (Holt-Winters: the kernel is
# bitwise its twin, so the devices differ only in how the twin's arithmetic
# rounds; croston and theta's SES: the same selects and FMAs; theta's slot
# sums and trend moments reduce in another order) drift apart by a few ulp
# a step; 1e-5 is ~80 ulp.  The curve member's comes from its conditioning.
POOL_RTOL = {"holt_winters": 1e-5, "croston": 1e-5, "theta": 1e-5}
# theta's alpha winner is held equal where a row's best two SSEs differ by
# more than this (ten times the score limit), as tests/test_torch_theta.py
THETA_TIE_RTOL = 1e-4


def pooled_ratios(port, batch, pool, configs, cv_conf) -> dict:
    """The pooled band's conformal scores on ``batch``'s device, rebuilt
    from each member's CV paths with ``pool``'s weights as
    ``engine/blend._blend_conformal_scale`` builds them; the scale
    recomputed from them must equal ``pool.interval_scale`` bit for bit, so
    that this copy cannot drift from it."""
    cvm, cal = port["cv"], port["cal"]
    cuts = cvm.cutoff_indices(batch.n_time, cvm.CVConfig(**cv_conf))
    w = torch.as_tensor(pool.weights, dtype=torch.float32,
                        device=batch.y.device)
    yhat_b = up_b = em = None
    for i, f in enumerate(pool.models):
        config, _ = cvm._cv_entry(batch, f, configs.get(f), None, "pool")
        yhat, _, hi, e, _ = cvm._cv_paths(batch, f, config, cuts,
                                          cv_conf["horizon"])
        wf = w[:, i][None, :, None]
        if yhat_b is None:
            yhat_b, up_b, em = wf * yhat, wf * (hi - yhat), e
        else:
            yhat_b, up_b = yhat_b + wf * yhat, up_b + wf * (hi - yhat)
    width = cal.config_interval_width(config)
    hi_b = yhat_b + up_b
    scale = cal.conformal_scale_from_paths(batch.y, yhat_b, hi_b, em,
                                           interval_width=width)
    assert np.array_equal(scale.cpu().numpy(), pool.interval_scale)
    half = hi_b - yhat_b
    obs = (em > 0) & (half > 1e-6 * (yhat_b.abs() + 1e-9))
    r = torch.where(obs, (batch.y[None] - yhat_b).abs()
                    / half.clamp_min(1e-9), 0.0)
    n_obs = obs.sum((0, 2)).float()
    k = cal._conformal_rank(n_obs, torch.full(
        (), width, dtype=torch.float32, device=n_obs.device))
    return dict(obs=obs.cpu(), r=r.cpu(), n=n_obs.cpu(), k=k.cpu())


def pool_vs_cpu(port, batch, spec: dict, configs: dict, n: int = 20) -> dict:
    """Phase 8's 20-series card-vs-CPU blend, with the train task's pool,
    member configs, CV and horizon (:func:`pool_check`)."""
    tr = task_conf(spec, "train")["training"]
    return pool_check(port, batch, tuple(tr["model_conf"]["families"]),
                      configs, tr["cv"], int(tr["horizon"]), n,
                      "blend_gpu_vs_cpu_20_series")


def theta_apart(port, y, mask, day, config) -> np.ndarray:
    """(S,) True where a row's best two theta alpha SSEs (computed on
    ``y``'s device) differ by more than ``THETA_TIE_RTOL`` relative:
    there the winner is held equal across devices; below it either is
    accepted, and the row's theta paths are not compared."""
    sse = port["theta"].candidate_sses(y, mask, day, config)
    s = np.sort(sse.double().cpu().numpy(), axis=1)
    return (s[:, 1] - s[:, 0]) > THETA_TIE_RTOL * np.maximum(s[:, 0], 1e-30)


def pool_check(port, batch, families, configs: dict, cv_conf: dict,
               horizon: int, n: int, line: str, counters=None) -> dict:
    """A 20-series ``fit_forecast_blend(calibrate=True)`` on the card and on
    the CPU.  Each family's scores within its own limit: :data:`POOL_RTOL`
    for the recurrences, and for the curve member 10 cond(A) 2^-24 of its
    CV systems (phase 3's bound on its paths).  With theta in the pool the
    comparison covers the rows whose theta alpha winners are apart in the
    fit and in every CV cutoff (:func:`theta_apart`).  The argmax-weight
    family equal wherever a series' best and second-best scores are more
    than twice the largest limit apart; weights within 2 d w + 1e-7 of each
    other, d the row's own largest relative score change (weights move by
    at most 2 d for a relative change d of the scores); the pooled
    conformal ranks equal and each scale within the largest change of the
    pooled scores it is an order statistic of (of every series' scores
    where the pooled one stands in), as phase 7 holds the curve model's;
    ok flags equal.  With ``counters``, they are set to 0 just before the
    card's blend and read just after it (the checks' own recomputation of
    the CV paths is not counted)."""
    blend, cvm = port["blend"], port["cv"]
    sub = batch.take_series(range(n))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    kw = dict(models=families, configs=configs, cv=cvm.CVConfig(**cv_conf),
              horizon=horizon, calibrate=True)
    for fn in (counters or {}).values():
        fn.launches = 0
    _, b_gpu, r_gpu = blend.fit_forecast_blend(sub, **kw)
    launches = {k: fn.launches for k, fn in (counters or {}).items()}
    _, b_cpu, r_cpu = blend.fit_forecast_blend(cpu, **kw)

    limits = {f: POOL_RTOL[f] for f in families if f in POOL_RTOL}
    kappa = None
    if "prophet" in families:
        curve, _ = cvm._cv_entry(sub, "prophet", configs.get("prophet"),
                                 None, "pool")
        _, A, _ = curve_systems(*cv_inputs(sub, cvm, cv_conf), sub.day,
                                curve, port)
        limits["prophet"], kappa = cond_tolerance(A)
    rows = np.ones(n, bool)
    if "theta" in families:
        config = configs.get("theta") or port["theta"].ThetaConfig()
        y_cv, m_cv = cv_inputs(cpu, cvm, cv_conf)
        C = y_cv.shape[0] // n
        rows = theta_apart(port, cpu.y, cpu.mask, cpu.day, config)
        rows &= theta_apart(port, y_cv, m_cv, cpu.day, config).reshape(
            C, n).all(0)
        assert rows.sum() >= n // 2, rows
    g = b_gpu.scores[list(families)].to_numpy()[rows]
    c = b_cpu.scores[list(families)].to_numpy()[rows]
    assert np.isfinite(g).all() and np.isfinite(c).all()
    rel = np.abs(g - c) / np.abs(c)
    for i, f in enumerate(families):
        assert rel[:, i].max() <= limits[f], (f, rel[:, i].max(), limits[f])
    srt = np.sort(c, axis=1)
    apart = (srt[:, 1] - srt[:, 0]) > 2 * max(limits.values()) * srt[:, 0]
    a_gpu = b_gpu.weights.argmax(axis=1)
    a_cpu = b_cpu.weights.argmax(axis=1)
    assert (a_gpu[rows][apart] == a_cpu[rows][apart]).all()
    d = rel.max(axis=1, keepdims=True)
    wdiff = np.abs(b_gpu.weights - b_cpu.weights)[rows]
    assert (wdiff <= 2 * d * b_cpu.weights[rows] + 1e-7).all(), wdiff.max()

    pg = pooled_ratios(port, sub, b_gpu, configs, cv_conf)
    pc = pooled_ratios(port, cpu, b_cpu, configs, cv_conf)
    assert torch.equal(pg["obs"][:, rows], pc["obs"][:, rows])
    assert torch.equal(pg["k"][rows], pc["k"][rows])
    diff = (pg["r"] - pc["r"]).abs()
    bound = torch.where(pc["n"][rows] >= 30, diff[:, rows].amax((0, 2)),
                        diff.max()).numpy()
    s_gpu, s_cpu = b_gpu.interval_scale[rows], b_cpu.interval_scale[rows]
    err = np.abs(s_gpu - s_cpu)
    assert (err <= bound + F32_EPS * 2 * np.abs(s_cpu)).all(), (err, bound)
    assert torch.equal(r_gpu.ok.cpu(), r_cpu.ok)
    res = dict(series=n, families=list(families), launches=launches,
               rows_compared=int(rows.sum()),
               score_max_rel_diff={f: float(rel[:, i].max())
                                   for i, f in enumerate(families)},
               score_limit_rel=limits, curve_cond_max=kappa,
               argmax_equal_where_apart=int(apart.sum()),
               weight_max_abs_diff=float(wdiff.max()),
               scale_max_abs_diff=float(err.max()),
               scale_bound_max=float(bound.max()),
               scale_max_rel_diff=float((err / s_cpu).max()),
               argmax_counts={f: int((a_gpu == i).sum())
                              for i, f in enumerate(families)})
    emit(line, **res)
    return res


def count_syncs(fn) -> list:
    """Every host sync PyTorch reports while ``fn()`` runs
    (``set_sync_debug_mode("warn")``), as the calling file:line."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message)]


# samples of the pooled train task's dispatch (each ~8 s on the card)
POOLED_DISPATCH_REPS = 1


def pooled_timings(port, root: str, spec: dict, card_line: str) -> dict:
    """Phase 8's device times on the real dataset: the train task's dispatch
    stage (CUDA events, median of POOLED_DISPATCH_REPS; the device's idle
    share; its host
    syncs), the croston recurrence at the fit and CV shapes beside its
    bounds, and season detection (the ACF alone on the card, and the whole
    detection with its host pull)."""
    cr, season, cvm = port["croston"], port["season"], port["cv"]
    prep, dispatch, _ = train_stages(port, root, spec)
    state = prep()
    batch = state["batch"]
    dispatch(dict(state))  # warm-up
    t = {"dispatch_ms": cuda_ms(lambda: dispatch(dict(state)),
                                reps=POOLED_DISPATCH_REPS),
         "dispatch_profile": idle_share(lambda: dispatch(dict(state)),
                                        top_n=12),
         "dispatch_host_syncs": count_syncs(lambda: dispatch(dict(state)))}
    cv_conf = task_conf(spec, "train")["training"]["cv"]
    cuts = cvm.cutoff_indices(batch.n_time, cvm.CVConfig(**cv_conf))
    train_masks = cvm.cv_windows(batch.mask, batch.day, cuts,
                                 cv_conf["horizon"])[0]
    shapes = {"fit": (batch.y, batch.mask),
              "cv": (batch.y.repeat(len(cuts), 1),
                     train_masks.reshape(-1, batch.n_time))}
    cfg = cr.CrostonConfig()
    t["croston"] = {}
    for k, (y, mask) in shapes.items():
        S, T = (int(d) for d in y.shape)
        fit = lambda: cr.fit(y, mask, batch.day, cfg)  # noqa: E731
        bound, by = bound_ms(port["ses"].croston_filter_work(
            S, T, cfg.variant))
        prof = idle_share(fit)
        t["croston"][k] = {
            "shape": [S, T], "ms": cuda_ms(fit), "bound_ms": bound,
            "bound_by": by,
            "serial_chain_ms": T * CROSTON_CHAIN_CYCLES / CLOCK_HZ * 1e3,
            "device_events": prof.get("device_events"),
            "idle_share": prof["idle_share"]}
    max_lag = season.clamp_max_lag(400, batch.n_time)
    acf = lambda: season.acf_scores_impl(batch.y, batch.mask, max_lag)  # noqa: E731
    bound, by = bound_ms(season.acf_work(batch.n_series, batch.n_time,
                                         max_lag))
    detect = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        period = season.detect_season_length(batch)
        detect.append((time.perf_counter() - t0) * 1e3)
    assert period == 7, period
    t["season"] = {"shape": [batch.n_series, batch.n_time, max_lag],
                   "acf_ms": cuda_ms(acf), "bound_ms": bound, "bound_by": by,
                   "acf_device_events": idle_share(acf).get("device_events"),
                   "detect_ms_host": statistics.median(detect),
                   "detected": period}
    emit("blend_times", card=card_line, reps=REPS, statistic="median", **t)
    return dict(t, batch=batch)


def monitor_rerun(port, root: str, spec: dict, card_line: str) -> dict:
    """The monitor node of the workflow run last in ``root``, run again as
    a task on the CPU over the same stored forecast table: its summary and
    its four output tables (profile, flagged rows, drift, degradation)
    must equal the card run's.  Then each of the four scans timed as the
    task calls it (host clock, median of 3: pandas and numpy on the host,
    its table write included)."""
    mon = port["monitoring"]
    node = next(t for t in spec["workflows"][0]["tasks"]
                if t["task"] == "monitor")
    conf = {**node["conf"], "env": {"root": root}}
    mc = conf["monitor"]
    table = mc["table"]
    catalog = _store(port, root)[0]
    outputs = [f"{table}_{k}" for k in ("profile_metrics", "anomalies",
                                        "drift", "degradation")]
    card = {t: catalog.read_table(t) for t in outputs}
    summary = port["tasks"].MonitorTask(init_conf=conf, device="cpu").launch()
    for t in outputs:
        assert len(catalog.table_versions(t)) >= 2, t
        pd.testing.assert_frame_equal(catalog.read_table(t), card[t])
    cfg = mon.MonitorConfig(name=mc["name"], table=table)
    df = catalog.read_table(table)
    profile = mon.run_monitor(catalog, cfg, df=df)
    scans = {
        "profile": lambda: mon.run_monitor(catalog, cfg, df=df),
        "anomalies": lambda: mon.detect_anomalies(catalog, table, df=df),
        "drift": lambda: mon.drift_report(
            catalog, table, slicing_cols=cfg.slicing_cols, df=df),
        "degradation": lambda: mon.degradation_report(catalog, cfg,
                                                      profile=profile),
    }
    times = {}
    for k, fn in scans.items():
        samples = []
        for _ in range(WORKFLOW_RUNS):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
        times[k] = statistics.median(samples)
    out = {"workflow": spec["workflows"][0]["name"], "table": table,
           "rows": len(df), "versions": len(catalog.table_versions(table)),
           "cpu_rerun_equal": True, "summary": summary,
           "scan_ms_host": times}
    emit("monitor", card=card_line, reps=WORKFLOW_RUNS, statistic="median",
         **out)
    return out


def pooled_phase(port, counters, card_line: str) -> dict:
    """Phase 8: real-data-e2e (WORKFLOW_RUNS runs in one env root, the
    monitor's drift scan from the second on, then its monitor rerun on the
    CPU), then forecasting-blend twice in one env root (the second promote
    against the first's champion) and up to WORKFLOW_RUNS runs, for the
    per-task medians; the first train task of each workflow's kernel calls against
    their twins; checks, times, and the 20-series card-vs-CPU blend."""
    out = {"launches": {k: 0 for k in counters},
           "cases": {k: {} for k in counters}}
    runs = {}
    for name in (REAL, BLEND):
        spec = e2e_spec(port, name)
        with tempfile.TemporaryDirectory() as root:
            first = pooled_run(port, root, spec, counters, record=True)
            for k, res in pooled_kernel_cases(port, first, name).items():
                out["cases"][k].update(res)
            checked = [check_pooled(first, port, root, spec, 1)]
            if name == BLEND:
                checked.append(check_pooled(
                    pooled_run(port, root, spec, counters), port, root, spec,
                    2))
                out["promote"] = check_promote(*checked, spec)
                emit("blend_promote", **out["promote"])
            if name == REAL:
                timed = pooled_timings(port, root, spec, card_line)
                out["gpu_vs_cpu"] = pool_vs_cpu(port, timed.pop("batch"),
                                                spec, first["configs"])
                out["times"] = timed
                # the repeats share the root: from the second run on the
                # monitored table has a baseline and the drift scan runs
                while len(checked) < WORKFLOW_RUNS:
                    checked.append(check_pooled(
                        pooled_run(port, root, spec, counters), port, root,
                        spec, len(checked) + 1))
                out["monitor"] = monitor_rerun(port, root, spec, card_line)
            del first
        while len(checked) < WORKFLOW_RUNS:
            with tempfile.TemporaryDirectory() as root:
                checked.append(check_pooled(
                    pooled_run(port, root, spec, counters), port, root, spec,
                    1))
        runs[name] = checked
        for c in checked:
            for k, n in c["launches"].items():
                out["launches"][k] += n
        emit("launches", path=name, per_train_task=[c["launches"]
                                                   for c in checked],
             expected="each kernel >= 1 a train task: 3 each (the CV pass "
                      "for the weights, the pooled CV pass, the fit)")
        med = lambda key: statistics.median(c[key] for c in checked)  # noqa: E731
        emit("blend_workflow", **checked[0], runs=len(checked),
             median_seconds=med("seconds"), median_fit_seconds=med(
                 "fit_seconds"),
             median_tasks_seconds={k: statistics.median(
                 c["tasks_seconds"][k] for c in checked)
                 for k in checked[0]["tasks_seconds"]})
    assert runs[BLEND][0]["season_length"] == 7, runs[BLEND][0]
    out["runs"] = runs
    return out


# -- phase 9: allocated-baseline and hierarchical-m5, at their own sizes -----

ALLOC = "allocated-baseline"
HIER = "hierarchical-m5"
# the reference's allocated table (pipelines/training.py allocated)
ALLOC_COLUMNS = ["ds", "store", "item", "y", "yhat", "yhat_upper",
                 "yhat_lower", "training_date"]
# the SES step's dependent chain (ses_filter_kernel): (1 - alpha) * level,
# the add and the select, ~12 cycles; T such steps at the boost clock,
# whatever the width (as hw_filter.cu:37-43 reckons its own chain)
SES_CHAIN_CYCLES = 12


class MintSpy:
    """Records every MinT solve the reconcile task makes: the hierarchy,
    the base forecasts, the error variances and the revision."""

    def __init__(self, rec):
        self.rec, self.calls = rec, []

    def __enter__(self):
        orig = self._orig = self.rec.reconcile_forecasts

        def spy(h, base, error_var=None):
            out = orig(h, base, error_var=error_var)
            self.calls.append((h, base, error_var, out))
            return out

        self.rec.reconcile_forecasts = spy
        return self

    def __exit__(self, *exc):
        self.rec.reconcile_forecasts = self._orig


def complete_run(port, root: str, spec: dict, counters) -> dict:
    """One run of a phase 9 workflow in ``root`` on the card, the launch
    counters set to 0 just before it and read just after, with the devices
    the training pipeline saw and the MinT solves it made."""
    for fn in counters.values():
        fn.launches = 0
    with MintSpy(port["reconcile_task"]) as mint:
        run = workflow_main_path(port, root, spec)
    run["launches"] = {k: fn.launches for k, fn in counters.items()}
    run["mint"] = mint.calls
    return run


def _nodes(spec) -> list:
    return [t["name"] for t in spec["workflows"][0]["tasks"]]


def check_allocated(run, port, root: str, spec: dict) -> dict:
    """allocated-baseline: every task OK; the item-level fit on the card; the
    table with the reference's columns and a row per (store, item) and day
    of history + horizon, finite and ordered; each item's store shares
    summing to 1; and each store's future rows the item artifact's
    forecast times its share (within 1e-5 of the row's scale)."""
    results = run["results"]
    assert list(results) == _nodes(spec), list(results)
    assert all(r["status"] == "OK" for r in results.values()), results
    assert run["devices"] == {"batch": "cuda", "forecast": "cuda"}, run
    catalog, tracker, _ = _store(port, root)
    raw = catalog.read_table(task_conf(spec, "ingest")["output"]["table"])
    tr = task_conf(spec, "train")
    horizon = int(tr["training"]["horizon"])
    table = catalog.read_table(tr["output"]["table"])
    assert list(table.columns) == ALLOC_COLUMNS, list(table.columns)
    pairs = raw[["store", "item"]].drop_duplicates()
    T = raw["date"].nunique()
    assert len(table) == len(pairs) * (T + horizon), len(table)
    vals = table[["yhat", "yhat_upper", "yhat_lower"]].to_numpy()
    assert np.isfinite(vals).all()
    assert (table["yhat_lower"] <= table["yhat"]).all()
    assert (table["yhat"] <= table["yhat_upper"]).all()
    totals = raw.groupby(["store", "item"])["sales"].sum()
    share = totals / totals.groupby(level="item").transform("sum")
    share_sums = share.groupby(level="item").sum().to_numpy()
    assert np.abs(share_sums - 1.0).max() <= 1e-12
    summary = results[_nodes(spec)[-1]]["result"]
    items = np.sort(raw["item"].unique())
    assert summary["n_items"] == len(items), summary
    train_run = tracker.get_run(summary["experiment_id"], summary["run_id"])
    fc = port["serving"].load_forecaster(
        train_run.artifact_path("forecaster"), device="cuda")
    assert fc.key_names == ("item",), fc.key_names
    item_fc = fc.predict(pd.DataFrame({"item": items}), horizon=horizon)
    future = table[table["ds"] > raw["date"].max()]
    merged = future.merge(item_fc, on=["ds", "item"], suffixes=("", "_item"))
    assert len(merged) == len(pairs) * horizon, len(merged)
    ratio = share.loc[list(zip(merged["store"], merged["item"]))].to_numpy()
    worst = 0.0
    for col in ("yhat", "yhat_upper", "yhat_lower"):
        want = merged[f"{col}_item"].to_numpy() * ratio
        scale = pd.Series(np.abs(want)).groupby(
            [merged["store"], merged["item"]]).transform("max").to_numpy()
        err = np.abs(merged[col].to_numpy() - want)
        assert (err <= 1e-5 * scale).all(), col
        worst = max(worst, float((err / np.maximum(scale, 1e-30)).max()))
    return dict(workflow=ALLOC, seconds=run["seconds"],
                tasks_seconds={k: r["seconds"] for k, r in results.items()},
                n_items=len(items), rows=len(table), launches=run["launches"],
                share_sum_max_err=float(np.abs(share_sums - 1.0).max()),
                artifact_vs_table_max_rel=worst)


def mint64(S_mat, base, var) -> tuple:
    """The MinT system solved in float64 with numpy: (revision, cond(G))."""
    S = S_mat.astype(np.float64)
    w_inv = 1.0 / np.maximum(var.astype(np.float64), 1e-12)
    SW = S * w_inv[:, None]
    G = S.T @ SW + 1e-8 * np.eye(S.shape[1])
    x = np.linalg.solve(G, SW.T @ base.astype(np.float64))
    return S @ x, float(np.linalg.cond(G))


def check_hierarchical(run, port, root: str, spec: dict) -> dict:
    """hierarchical-m5: every task OK; the theta fit on the card (500
    series, finite ordered bands over history + 28 days); the reconciled
    table of 561 nodes x 28 days in the reference's node order, finite and
    coherent — its aggregates within the float32 summation bound
    ``n_bottom 2^-24 max|y|`` of the sums of its bottoms; and the one MinT
    solve, run on the card, within ``10 cond(G) 2^-24`` of the forecasts'
    scale of a float64 numpy solve of the same system."""
    results = run["results"]
    assert list(results) == _nodes(spec), list(results)
    assert all(r["status"] == "OK" for r in results.values()), results
    assert run["devices"] == {"batch": "cuda", "forecast": "cuda"}, run
    catalog = _store(port, root)[0]
    tr = task_conf(spec, "train")
    horizon = int(tr["training"]["horizon"])
    train = results["train"]["result"]
    forecasts = catalog.read_table(tr["output"]["table"])
    S = train["n_series"]
    T = len(forecasts) // S - horizon
    assert len(forecasts) == S * (T + horizon)
    vals = forecasts[["yhat", "yhat_upper", "yhat_lower"]].to_numpy()
    assert np.isfinite(vals).all()
    assert (forecasts["yhat_lower"] <= forecasts["yhat"]).all()
    assert (forecasts["yhat"] <= forecasts["yhat_upper"]).all()

    rc = task_conf(spec, "reconcile")
    rec = results["reconcile"]["result"]
    assert len(run["mint"]) == 1, len(run["mint"])
    h, base, var, revised = run["mint"][0]
    n_nodes, H = h.n_nodes, int(rc["reconcile"]["horizon"])
    assert rec["n_nodes"] == n_nodes == 1 + len(h.stores) + len(h.items) + S
    assert (rec["method"], rec["weights"], rec["model"], rec["n_days"]) == (
        "mint", "cv", "theta", H), rec
    assert base.device.type == var.device.type == revised.device.type == (
        "cuda")
    table = catalog.read_table(rc["output"]["table"])
    assert list(table.columns) == ["ds", "node", "yhat", "method"]
    assert len(table) == n_nodes * H and (table["method"] == "mint_cv").all()
    assert table["node"].to_numpy()[::H].tolist() == h.node_labels()
    last = pd.Timestamp(forecasts["ds"].iloc[T - 1])
    np.testing.assert_array_equal(
        table["ds"].to_numpy()[:H],
        pd.date_range(last + pd.Timedelta(days=1), periods=H).values)
    y = table["yhat"].to_numpy(np.float64).reshape(n_nodes, H)
    assert np.isfinite(y).all()
    coh = float(np.abs(h.S_mat.astype(np.float64) @ y[-S:] - y).max())
    coh_bound = S * F32_EPS * float(np.abs(y).max())
    assert coh <= coh_bound, (coh, coh_bound)
    exact, cond = mint64(h.S_mat, base.cpu().numpy(), var.cpu().numpy())
    scale = float(np.abs(exact).max())
    mint_err = float(np.abs(revised.cpu().numpy() - exact).max())
    mint_tol = 10 * cond * F32_EPS * scale
    assert mint_err <= mint_tol, (mint_err, mint_tol)
    np.testing.assert_array_equal(revised.cpu().numpy().reshape(-1),
                                  table["yhat"].to_numpy(np.float32))
    return dict(workflow=HIER, seconds=run["seconds"],
                tasks_seconds={k: r["seconds"] for k, r in results.items()},
                series=S, days=T, nodes=n_nodes, horizon=H,
                launches=run["launches"], n_failed=train["n_failed"],
                coherency_error=coh, coherency_bound=coh_bound,
                coherency_rel=coh / float(np.abs(y).max()),
                coherency_error_card=float(port["reconcile"].coherency_error(
                    h, revised)),
                mint_vs_float64_max_abs=mint_err, mint_tol=mint_tol,
                mint_cond=cond,
                error_var_range=[float(var.min()), float(var.max())])


def theta_vs_cpu(port, nodes, n: int = 20) -> dict:
    """A 20-node theta ``fit_forecast`` on the card and on the CPU (the
    total, the stores and the first items of the hierarchy): alpha winners
    equal where a node's best two SSEs are apart (:func:`theta_apart`),
    and there every fitted parameter, the path and the band within rtol
    1e-5 / atol 1e-5 of the node's scale (the SES steps are the same
    float32 operations on both; the slot sums and the trend's moments
    reduce in another order); ok flags equal."""
    th = port["theta"]
    sub = nodes.take_series(range(n))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    cfg = th.ThetaConfig()
    out = {}
    for name, b in (("gpu", sub), ("cpu", cpu)):
        params, res = port["engine"].fit_forecast(b, "theta", config=cfg,
                                                  horizon=28)
        out[name] = (params, res)
    apart = theta_apart(port, cpu.y, cpu.mask, cpu.day, cfg)
    assert apart.sum() >= n // 2, apart
    (pg, rg), (pc, rc) = out["gpu"], out["cpu"]
    np.testing.assert_array_equal(pg.alpha.cpu().numpy()[apart],
                                  pc.alpha.numpy()[apart])
    scale = cpu.y.abs().amax(1).numpy()[apart][:, None]
    worst = 0.0
    pairs = [(getattr(pg, f).cpu(), getattr(pc, f))
             for f in ("level", "sigma", "intercept", "slope", "fitted")]
    pairs += [(getattr(rg, k).cpu(), getattr(rc, k))
              for k in ("yhat", "lo", "hi")]
    for a, b in pairs:
        a = a.numpy()[apart].reshape(int(apart.sum()), -1)
        b = b.numpy()[apart].reshape(int(apart.sum()), -1)
        err = np.abs(a - b)
        assert (err <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), err.max()
        worst = max(worst, float((err / scale).max()))
    assert torch.equal(rg.ok.cpu(), rc.ok)
    res = dict(nodes=n, winners_apart=int(apart.sum()),
               alpha_equal_where_apart=True, max_rel_diff=worst)
    emit("theta_gpu_vs_cpu_20_nodes", **res)
    return res


def complete_timings(port, batch, nodes, mint_call, card_line: str) -> dict:
    """Phase 9's device times (CUDA events, median of 5): the SES loop
    alone (``models/theta.ses_paths``, 7 alphas) and the whole theta fit at
    the train task's shape (500 x 1,826) and at the reconcile task's CV
    shape (561 nodes x 3 cutoffs = 1,683 rows), each with its launches and
    the device's idle share (torch.profiler), its host syncs, and its
    bounds (bytes, and the serial chain); the MinT solve at n = 500 with
    its bound."""
    th, cvm = port["theta"], port["cv"]
    cfg = th.ThetaConfig()
    cuts = cvm.cutoff_indices(nodes.n_time, cvm.CVConfig())
    train = cvm.cv_windows(nodes.mask, nodes.day, cuts,
                           cvm.CVConfig().horizon)[0]
    shapes = {"fit": (batch.y, batch.mask),
              "cv": (nodes.y.repeat(len(cuts), 1),
                     train.reshape(-1, nodes.n_time))}
    alphas = torch.tensor(cfg.alphas, device=batch.y.device)
    A = len(cfg.alphas)
    t = {"ses": {}, "theta_fit": {}}
    for k, (y, mask) in shapes.items():
        S, T = (int(d) for d in y.shape)
        z = th._lines(y, mask, batch.day, cfg)[5]
        ses = lambda: th.ses_paths(z, mask, alphas)  # noqa: E731
        fit = lambda: th.fit(y, mask, batch.day, cfg)  # noqa: E731
        bound, by = bound_ms(port["ses"].ses_filter_work(S, T, A))
        prof = idle_share(ses)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fit()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        t["ses"][k] = {
            "shape": [S, T, A], "ms": cuda_ms(ses), "bound_ms": bound,
            "bound_by": by,
            "serial_chain_ms": T * SES_CHAIN_CYCLES / CLOCK_HZ * 1e3,
            "device_events": prof.get("device_events"),
            "launches_per_step": (prof["device_events"] / T
                                  if isinstance(prof.get("device_events"), int)
                                  else "not measured"),
            "idle_share": prof["idle_share"],
            "host_syncs": count_syncs(ses),
            "buffer_bytes": 4 * (T + 1) * S * A}
        fprof = idle_share(fit)
        t["theta_fit"][k] = {
            "shape": [S, T], "ms": cuda_ms(fit),
            "device_events": fprof.get("device_events"),
            "idle_share": fprof["idle_share"],
            "host_syncs": count_syncs(fit),
            "peak_bytes": int(peak)}
    h, base_fc, var, _ = mint_call
    mint = lambda: port["reconcile"].reconcile_forecasts(  # noqa: E731
        h, base_fc, var)
    bound, by = bound_ms(port["reconcile"].mint_work(
        h.n_nodes, h.n_bottom, int(base_fc.shape[1])))
    mprof = idle_share(mint)
    t["mint"] = {"shape": [h.n_nodes, h.n_bottom, int(base_fc.shape[1])],
                 "ms": cuda_ms(mint), "bound_ms": bound, "bound_by": by,
                 "device_events": mprof.get("device_events"),
                 "idle_share": mprof["idle_share"],
                 "host_syncs": count_syncs(mint)}
    emit("complete_times", card=card_line, reps=REPS, statistic="median", **t)
    return t


def complete_phase(port, counters, card_line: str) -> dict:
    """Phase 9: allocated-baseline and hierarchical-m5 at their own sizes,
    each WORKFLOW_RUNS times in one env root, the Holt-Winters launch
    counters set to 0 before each run (neither launches a Holt-Winters
    kernel: the curve model and theta, whose SES is ses_filter's);
    checks, per-task medians, the SES loop's and the MinT solve's times, a
    20-node theta card-vs-CPU run, and a 20-series blend over
    [holt_winters, theta, croston] on the card against the CPU, which
    launches both hand kernels."""
    out = {"launches": {k: 0 for k in counters}}
    for name, check in ((ALLOC, check_allocated),
                        (HIER, check_hierarchical)):
        spec = e2e_spec(port, name)
        with tempfile.TemporaryDirectory() as root:
            checked = []
            for _ in range(WORKFLOW_RUNS):
                run = complete_run(port, root, spec, counters)
                checked.append(check(run, port, root, spec))
            if name == HIER:
                catalog = _store(port, root)[0]
                hist = catalog.read_table(
                    task_conf(spec, "ingest")["output"]["table"])
                batch = port["data"].tensorize(hist)
                h = port["reconcile"].Hierarchy.from_keys(batch.keys)
                nodes = port["reconcile_task"].mint_node_batch(batch, h)
                out["theta_vs_cpu"] = theta_vs_cpu(port, nodes)
                out["times"] = complete_timings(port, batch, nodes,
                                                run["mint"][0], card_line)
                del run
        for c in checked:
            assert all(n == 0 for n in c["launches"].values()), c["launches"]
        emit("launches", path=name, per_run=[c["launches"] for c in checked],
             expected="0: the curve model and theta launch neither "
                      "Holt-Winters kernel (theta launches ses_filter)")
        med = lambda key: statistics.median(c[key] for c in checked)  # noqa: E731
        emit("complete_workflow", **checked[0], runs=len(checked),
             median_seconds=med("seconds"),
             median_tasks_seconds={k: statistics.median(
                 c["tasks_seconds"][k] for c in checked)
                 for k in checked[0]["tasks_seconds"]})
        out[name] = checked

    # theta beside holt_winters and croston in a pool: both kernels launch
    pool = ("holt_winters", "theta", "croston")
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA))
    out["theta_pool"] = pool_check(port, batch, pool, {}, CV, 90, 20,
                                   "theta_pool_gpu_vs_cpu_20_series",
                                   counters=counters)
    launched = out["theta_pool"]["launches"]
    emit("launches", path="theta_pool", **launched,
         expected="3 each: the CV pass for the weights, the pooled CV pass, "
                  "the fit")
    for k, n in launched.items():
        if n < 1:
            raise AssertionError(f"the theta pool never launched {k}")
        out["launches"][k] += n
    return out


# -- phase 10: the arima family, order: auto, and model: auto's default pool -

ARIMA_KERNELS = ("arima_filter", "arima_predict")
# the Kalman step's dependent chain at r = 2: the floor of P_00, one IEEE
# division (the gain), the rank-one update and the next P_00, ~50 cycles;
# T such steps at the boost clock, whatever the width (csrc/arima_kalman.cu)
ARIMA_CHAIN_CYCLES = 50
# card against CPU, the whole arima path: the HR estimate's solves
# (cuSOLVER's LU on the card, the pivoted LU twin on the CPU) and its Gram
# reductions round differently, and the Kalman pass carries the change
# through T steps; held per row at the limit tests/test_torch_cuda.py holds
# the same comparison to (1e-4; measured on the H100 up to 3.3e-5 a row)
ARIMA_REL = 1e-4
# order: auto's winner is held equal across devices where its best two
# batch-mean scores differ by more than this, relative
ORDER_TIE_RTOL = 1e-3
AUTO = "model-auto-default-families"
AUTO_TASKS = ["catalog", "etl", "train", "deploy", "inference"]
DEFAULT_POOL = ("prophet", "holt_winters", "theta", "croston", "arima")


def arima_args(port, y, mask, cfg) -> tuple:
    """The arguments ``fit`` gives ``arima_filter`` for ``cfg`` on (y,
    mask): the centered differenced series, its HR coefficients, the mean,
    r and d."""
    ar = port["arima"]
    lags = ar._lag_sets(cfg)
    zc, zmask, mean = ar._centered(y, mask, cfg.d)
    K = max(cfg.hr_ar_order, lags[2] + lags[3] + cfg.m)
    phi, theta = ar._hannan_rissanen(zc, zmask, *lags, K)
    return (zc.contiguous(), zmask.contiguous(), y.contiguous(),
            mask.contiguous(), phi.contiguous(), theta.contiguous(),
            mean.contiguous(), ar._effective_r(cfg), cfg.d)


def compare_bitwise(pairs: dict) -> dict:
    """Kernel vs twin outputs, bit for bit (NaN where the twin has NaN),
    with the largest difference for the record."""
    equal = {k: bool(a.shape == w.shape and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(w, nan=0.0))
        and torch.equal(a.isnan(), w.isnan())) for k, (a, w) in pairs.items()}
    err = max(float((a - w).abs().nan_to_num(0.0).max()) if a.numel() else 0.0
              for a, w in pairs.values())
    return {"max_abs_err": err, "bitwise": all(equal.values()),
            "unequal": [k for k, v in equal.items() if not v],
            "pass": all(equal.values())}


def arima_filter_case(port, case: str, args, want=None) -> dict:
    """arima_filter on ``args`` against its twin on the same inputs
    (``want``, where the caller ran it), bit for bit (the kernel repeats the
    twin's float32 operations in order, built without contraction); raises
    on a disagreement."""
    kal = port["kalman"]
    got = kal.arima_filter(*args)
    if want is None:
        want = kal.arima_filter_reference(*args)
    torch.cuda.synchronize()
    res = compare_bitwise({k: (g, w) for k, g, w in zip(
        kal.FilterOutputs._fields, got, want) if w is not None})
    res.update(S=int(args[0].shape[0]), T=int(args[0].shape[1]), r=args[7],
               d=args[8], p=int(args[4].shape[1]), q=int(args[5].shape[1]))
    emit("kernel_vs_twin", kernel="arima_filter", case=case, **res)
    if not res["pass"]:
        raise AssertionError(f"arima_filter disagrees with its twin: {case}")
    return res


def arima_predict_case(port, case: str, args, H: int) -> dict:
    """arima_predict from the filter's final state against its twin, bit for
    bit; raises on a disagreement."""
    kal = port["kalman"]
    out = kal.arima_filter(*args)
    sigma2 = out.ssq / torch.clamp_min(out.n, 1.0)
    pargs = (args[4], args[5], out.a_T, out.P_T, sigma2, args[7], H)
    got = kal.arima_predict(*pargs)
    want = kal.arima_predict_reference(*pargs)
    torch.cuda.synchronize()
    res = compare_bitwise({"zf": (got[0], want[0]), "vf": (got[1], want[1])})
    res.update(S=int(args[0].shape[0]), H=H, r=args[7])
    emit("kernel_vs_twin", kernel="arima_predict", case=case, **res)
    if not res["pass"]:
        raise AssertionError(f"arima_predict disagrees with its twin: {case}")
    return res


def arima_kernel_cases(batch, port) -> dict:
    """Phase 10's kernel cases at the main path's shapes: the fit (2, 1, 1),
    the CV pass's 1,500 rows with the cutoffs' train masks, d = 0, 10% more
    cells masked, weekly seasonal P = Q = 1 (r = 8), m = 52 with P = 1
    (r = 52, the shared-memory path); the forecast recursion at H = 91 and
    at a serving grid longer than the fit grid (H = 2,001); and the
    ValueError for an r past the kernels' limit.  The filter's twin runs
    stacked where cases share their order and shapes (:func:`stacked_twins`).
    """
    ar = port["arima"]
    rng = np.random.default_rng(0)
    drop = torch.from_numpy((rng.random(tuple(batch.y.shape)) >= 0.1)
                            .astype(np.float32)).to(batch.y.device)
    full = batch.y * batch.mask
    cv_y, cv_mask = cv_inputs(batch, port["cv"])
    cases = {
        "fit_211": (ar.ArimaConfig(), full, batch.mask),
        "cv_1500": (ar.ArimaConfig(), cv_y, cv_mask),
        "d0_201": (ar.ArimaConfig(p=2, d=0, q=1), full, batch.mask),
        "masked_10pct": (ar.ArimaConfig(), full * drop, batch.mask * drop),
        "seasonal_r8": (ar.ArimaConfig(p=1, q=1, P=1, Q=1, m=7), full,
                        batch.mask),
        "warp_r52": (ar.ArimaConfig(p=1, q=1, P=1, m=52), full, batch.mask),
    }
    out = {"arima_filter": {}, "arima_predict": {}}
    args = {name: arima_args(port, y, mask, cfg)
            for name, (cfg, y, mask) in cases.items()}
    # one twin call for the cases of one order, d and T (stacked_twins)
    wants = stacked_twins(
        port["kalman"].arima_filter_reference, args, 7,
        lambda a: (int(a[0].shape[1]), int(a[4].shape[1]),
                   int(a[5].shape[1]), a[7], a[8]))
    for name in cases:
        out["arima_filter"][name] = arima_filter_case(port, name, args[name],
                                                      wants[name])
    for name, key, H in (("fit_H91", "fit_211", 91),
                         ("serving_H2001", "fit_211", 2001),
                         ("seasonal_r8_H91", "seasonal_r8", 91),
                         ("warp_r52_H91", "warp_r52", 91)):
        out["arima_predict"][name] = arima_predict_case(port, name, args[key],
                                                        H)
    big = arima_args(port, full[:4], batch.mask[:4],
                     ar.ArimaConfig(p=1, q=1, P=1, m=70))
    for kernel, call in (
            ("arima_filter", lambda: port["kalman"].arima_filter(*big)),
            ("arima_predict", lambda: port["kalman"].arima_predict(
                big[4], big[5], torch.zeros(4, 70, device=full.device),
                torch.zeros(4, 70, 70, device=full.device),
                torch.ones(4, device=full.device), 70, 10))):
        try:
            call()
        except ValueError as exc:
            assert "limit of 64" in str(exc), exc
            emit("kernel_refuses", kernel=kernel, r=70, error=str(exc))
        else:
            raise AssertionError(f"{kernel} took r = 70")
    return out


def arima_main_path(port, tmp: str) -> dict:
    """Phase 10's main path: load -> tensorize -> fit_forecast(model=
    "arima") -> fail-safe -> forecast frame -> CV -> artifact save/load ->
    a 500-series predict."""
    data, engine, ar, serving = (port["data"], port["engine"], port["arima"],
                                 port["serving"])
    t0 = time.perf_counter()
    batch = data.tensorize(data.load_sales_csv(DATA))
    cfg = ar.ArimaConfig()
    params, result = engine.fit_forecast(batch, "arima", config=cfg,
                                         horizon=90)
    frame = engine.forecast_frame(batch, result)
    metrics = engine.cross_validate(batch, "arima", config=cfg,
                                    cv=engine.CVConfig(**CV))
    fc = serving.BatchForecaster.from_fit(batch, params, "arima", cfg)
    fc.save(tmp)
    loaded = serving.BatchForecaster.load(tmp)
    rng = np.random.default_rng(1)
    requests = {k: batch.keys[rng.permutation(batch.n_series)[:k]]
                for k in (1, 17, 500)}
    answers = {k: loaded.predict(_request(keys)) for k, keys in requests.items()}
    quantiles = loaded.predict_quantiles(_request(requests[17]))
    torch.cuda.synchronize()
    return dict(batch=batch, params=params, result=result, frame=frame,
                metrics=metrics, requests=requests, answers=answers,
                quantiles=quantiles, seconds=time.perf_counter() - t0)


def arima_vs_cpu(port, batch, n: int = 20, horizon: int = 90,
                 phase: str = "arima_gpu_vs_cpu_20_series") -> dict:
    """A 20-series arima fit_forecast on the card and on the CPU: every row
    of every output within ARIMA_REL of that row's own scale (its largest
    magnitude, at least 1: the unit of the dimensionless coefficients, where
    a phi near 0 carries the solves' absolute rounding), ok flags and day
    grids equal."""
    engine = port["engine"]
    sub = batch.take_series(range(n))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    p_gpu, r_gpu = engine.fit_forecast(sub, "arima", horizon=horizon)
    p_cpu, r_cpu = engine.fit_forecast(cpu, "arima", horizon=horizon)
    assert torch.equal(r_gpu.ok.cpu(), r_cpu.ok)
    assert torch.equal(r_gpu.day_all.cpu(), r_cpu.day_all)
    worst = {}
    pairs = [(k, getattr(r_gpu, k), getattr(r_cpu, k))
             for k in ("yhat", "lo", "hi")]
    pairs += [(f.name, getattr(p_gpu, f.name), getattr(p_cpu, f.name))
              for f in dataclasses.fields(p_cpu)]
    for k, a, b in pairs:
        if not b.numel():
            continue
        rows = b.shape[0] if b.dim() and b.shape[0] == n else 1
        a, b = a.cpu().reshape(rows, -1), b.reshape(rows, -1)
        err = (a - b).abs().amax(dim=1)
        scale = b.abs().amax(dim=1).clamp_min(1.0)
        bad = err > ARIMA_REL * scale
        assert not bad.any(), (k, err[bad].tolist(), scale[bad].tolist())
        worst[k] = float((err / scale).max())
    res = dict(series=n, T_all=int(r_cpu.day_all.shape[0]),
               max_rel_to_scale=worst, limit=ARIMA_REL)
    emit(phase, **res)
    return res


def check_arima_outputs(run, port) -> dict:
    """Phase 10's output checks: the frames, shapes and bands (as phase 5's),
    every parameter finite, the CV means finite, the 20-series card-vs-CPU
    run."""
    check_frames(run, "arima_main_path")
    p = run["params"]
    for f in dataclasses.fields(p):
        assert torch.isfinite(getattr(p, f.name)).all(), f.name
    S, T = run["batch"].y.shape
    assert tuple(p.fitted.shape) == (S, T) and tuple(p.P_last.shape) == (
        S, 2, 2)
    return arima_vs_cpu(port, run["batch"])


def order_auto(port, batch, counters) -> dict:
    """``order: auto`` on the committed dataset, all 22 orders of the
    default ladder, on the card (wall time, one pull of the table at its
    end), with every launch counter set to 0 just before it and read just
    after; then on 20 series, card and CPU: the same order where their best
    two scores differ by more than ORDER_TIE_RTOL relative."""
    order, cvm = port["order"], port["cv"]
    cv = cvm.CVConfig(**CV)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    best, rows = order.select_arima_order(batch, cv=cv)
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items()}
    assert len(rows) == 22 and all(np.isfinite(r[1]) for r in rows), rows
    sub = batch.take_series(range(20))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    b_gpu, r_gpu = order.select_arima_order(sub, cv=cv)
    b_cpu, r_cpu = order.select_arima_order(cpu, cv=cv)
    scores = sorted(r[1] for r in r_cpu)
    apart = scores[1] - scores[0] > ORDER_TIE_RTOL * scores[0]
    if apart:
        assert b_gpu == b_cpu, (b_gpu, b_cpu)
    g, c = ({o: s for o, s, _ in r} for r in (r_gpu, r_cpu))
    rel = max(abs(g[o] - c[o]) / abs(c[o]) for o in c)
    res = dict(selected=list(best), seconds=wall, orders=len(rows),
               launches=launched, table=[[list(o), s, n] for o, s, n in rows[:5]],
               worst=[list(rows[-1][0]), rows[-1][1]],
               cpu_vs_gpu_20={"gpu": list(b_gpu), "cpu": list(b_cpu),
                              "best_two_apart": bool(apart),
                              "score_max_rel_diff": rel})
    emit("order_auto", **res)
    return res


def auto_spec(port) -> dict:
    """``model: auto`` with no ``families`` key on the committed dataset:
    real-data-e2e's catalog and etl (the CSV ingest), then train, deploy and
    inference, built in code (conf/workflows.yml is read, not edited)."""
    spec = e2e_spec(port, REAL)
    wf = spec["workflows"][0]
    wf["name"] = AUTO
    wf["tasks"] = [t for t in wf["tasks"] if t["task"] != "monitor"]
    tr = task_conf(spec, "train")["training"]
    tr["model"] = "auto"
    tr.pop("model_conf", None)
    tr.pop("calibrate_intervals", None)  # auto refuses calibration
    tr["experiment"] = "auto_forecasting"
    task_conf(spec, "deploy")["deploy"].update(
        experiment="auto_forecasting", model_name="ForecastingAutoModel")
    task_conf(spec, "inference")["inference"]["model_name"] = (
        "ForecastingAutoModel")
    return spec


def auto_run(port, root: str, spec: dict, counters) -> dict:
    """One run of the auto workflow in ``root`` on the card, every launch
    counter set to 0 as the train task starts and read as it returns."""
    t0 = time.perf_counter()
    with PoolSpy(port["training"], counters) as spy:
        results = port["runner"].WorkflowRunner(
            spec, env={"root": root}, device="cuda").run(AUTO)
    torch.cuda.synchronize()
    assert len(spy.launches) == 1, spy.launches
    return dict(results=results, launches=spy.launches[0],
                seconds=time.perf_counter() - t0)


def check_auto(run, port, root: str, spec: dict, version: int) -> dict:
    """Every task OK; hw_score, hw_filter and arima_filter launched by the
    train task; the per-series table scores all five default families and
    names each series' winner among them; the registered artifact (a
    mixed-family forecaster) predicts the inference table within 1e-5 (the
    parquet round trip) and the train run's forecast within 1e-5 of each
    row's scale."""
    results = run["results"]
    assert list(results) == AUTO_TASKS, list(results)
    assert all(r["status"] == "OK" for r in results.values()), results
    for k in ("hw_score", "hw_filter", "arima_filter"):
        assert run["launches"][k] >= 1, (k, run["launches"])
    catalog, tracker, registry = _store(port, root)
    tr = task_conf(spec, "train")
    horizon = int(tr["training"]["horizon"])
    summary = results["train"]["result"]
    train_run = tracker.get_run(summary["experiment_id"], summary["run_id"])
    assert train_run.params()["families"] == list(DEFAULT_POOL)
    table = pd.read_parquet(train_run.artifact_path("series_metrics.parquet"))
    for f in DEFAULT_POOL:
        assert np.isfinite(table[f"smape_{f}"]).all(), f
    assert set(table["chosen_model"]) <= set(DEFAULT_POOL)
    keys = table[["store", "item"]].to_numpy()
    S = len(keys)
    forecasts = catalog.read_table(tr["output"]["table"])
    T = len(forecasts) // S - horizon
    dates = pd.DatetimeIndex(forecasts["ds"].iloc[:T + horizon])
    _check_table(forecasts, keys, dates, "auto forecast table")
    inf_conf = task_conf(spec, "inference")
    h_inf = int(inf_conf["inference"]["horizon"])
    served = catalog.read_table(inf_conf["output"]["table"])
    served_keys = served[["store", "item"]].drop_duplicates().to_numpy()
    _check_table(served, served_keys, dates[T:T + h_inf],
                 "auto inference table")
    row = {tuple(k): i for i, k in enumerate(keys.tolist())}
    order = np.asarray([row[tuple(k)] for k in served_keys.tolist()])
    model_name = inf_conf["inference"]["model_name"]
    registered, latest = port["serving"].resolve_from_registry(
        registry, model_name, device="cuda")
    assert latest.version == version, latest
    assert type(registered).__name__ == "MultiModelForecaster"
    request = pd.DataFrame(served_keys, columns=["store", "item"])
    got = registered.predict(request, horizon=h_inf)
    cols = ["ds", "store", "item", "yhat", "yhat_upper", "yhat_lower"]
    pd.testing.assert_frame_equal(got[cols], served[cols], check_dtype=False)
    future = forecasts.groupby(["store", "item"], sort=False).nth(
        list(range(T, T + h_inf)))
    for col in ("yhat", "yhat_upper", "yhat_lower"):
        a = got[col].to_numpy().reshape(S, -1)
        b = future[col].to_numpy().reshape(S, -1)[order]
        scale = np.abs(b).max(axis=1, keepdims=True)
        assert (np.abs(a - b) <= 1e-5 * scale).all(), col
    metrics = train_run.metrics()
    out = dict(workflow=AUTO, seconds=run["seconds"],
               tasks_seconds={k: r["seconds"] for k, r in results.items()},
               launches=run["launches"], fit_seconds=metrics["fit_seconds"],
               val_smape=metrics["val_smape"],
               chosen={f: int(metrics[f"n_chosen_{f}"]) for f in DEFAULT_POOL},
               registry={"version": latest.version, "stage": latest.stage,
                         "model_family": latest.tags.get("model_family")})
    emit("auto_workflow", **out)
    return out


def once_ms(fn) -> float:
    """Device time of one ``fn()`` between two CUDA events (a plain twin's
    Python loop: too slow to repeat)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def peak_mib(fn) -> tuple:
    """(host wall ms, peak device memory MiB) of one ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return wall, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def arima_timings(run, port, card_line: str) -> dict:
    """Phase 10's device times: both kernels at the fit shape (and
    arima_filter at the CV shape) beside their bounds and their twins' time
    (once) — each kernel alone over 20 back-to-back launches a sample, its
    arguments checked and bound beforehand (``_arima_*_launcher``) so that
    the host only launches — the Hannan-Rissanen estimate alone at both
    shapes (launches, idle share, host syncs, bound), the arima fit_forecast and CV pass (idle share, host syncs),
    and one HW ``filter='pscan'`` fit and one ``kalman='pscan'`` arima fit
    at (500, 1,826) with their peak memory."""
    engine, ar, hw, kal = (port["engine"], port["arima"], port["hw"],
                           port["kalman"])
    batch = run["batch"]
    y, mask = batch.y * batch.mask, batch.mask
    cfg = ar.ArimaConfig()
    cv = engine.CVConfig(**CV)
    k = {}
    for name, (yy, mm) in (("fit", (y, mask)),
                           ("cv", cv_inputs(batch, port["cv"]))):
        args = arima_args(port, yy, mm, cfg)
        S, T = (int(d) for d in yy.shape)
        bound, by = bound_ms(kal.arima_filter_work(S, T, args[7], args[8]))
        launch, _ = kal._arima_filter_launcher(*args)
        k[name] = {"shape": [S, T, args[7], args[8]],
                   "ms": cuda_ms(launch, inner=20), **device_ms(launch),
                   "bound_ms": bound, "bound_by": by,
                   "serial_chain_ms": T * ARIMA_CHAIN_CYCLES / CLOCK_HZ * 1e3}
        if name == "fit":
            fit_args = args
    # the kernel at other orders, on the fit shape: d = 0, r = 1 and 3, the
    # weekly seasonal r = 8 and the shared-memory path's r = 52
    for name, order in (("d0_201", dict(p=2, d=0, q=1)),
                        ("r1_110", dict(p=1, q=0)), ("r3_312", dict(p=3, q=2)),
                        ("seasonal_r8", dict(p=1, q=1, P=1, Q=1, m=7)),
                        ("warp_r52", dict(p=1, q=1, P=1, m=52))):
        args = arima_args(port, y, mask, ar.ArimaConfig(**order))
        launch, _ = kal._arima_filter_launcher(*args)
        k[name] = {"shape": [batch.n_series, batch.n_time, args[7], args[8]],
                   "ms": cuda_ms(launch, inner=5)}
    twin_filter = once_ms(lambda: kal.arima_filter_reference(*fit_args))
    out = kal.arima_filter(*fit_args)
    sigma2 = out.ssq / torch.clamp_min(out.n, 1.0)
    pargs = (fit_args[4], fit_args[5], out.a_T, out.P_T, sigma2, 2, 91)
    bound, by = bound_ms(kal.arima_predict_work(batch.n_series, 91, 2))
    from distributed_forecasting_tpu_torch.ops import _build
    predict = {**arima_predict_floor(port, pargs,
                                     measurement_entries(_build.library())),
               "bound_ms": bound, "bound_by": by}
    twin_predict = once_ms(lambda: kal.arima_predict_reference(*pargs))
    # the Hannan-Rissanen estimate alone, at the fit and CV shapes
    hr = {}
    for name, (yy, mm) in (("fit", (y, mask)),
                           ("cv", cv_inputs(batch, port["cv"]))):
        ar_lags, ma_lags, p_eff, q_eff = ar._lag_sets(cfg)
        zc, zmask, _ = ar._centered(yy, mm, cfg.d)
        K = max(cfg.hr_ar_order, p_eff + q_eff + cfg.m)
        est = lambda: ar._hannan_rissanen(  # noqa: E731
            zc, zmask, ar_lags, ma_lags, p_eff, q_eff, K)
        S, T = (int(d) for d in yy.shape)
        bound, by = bound_ms(ar.hr_work(S, T, K, len(ar_lags) + len(ma_lags)))
        prof = idle_share(est)
        hr[name] = {"shape": [S, T, K], "ms": cuda_ms(est), "bound_ms": bound,
                    "bound_by": by, "device_events": prof.get("device_events"),
                    "idle_share": prof["idle_share"],
                    "host_syncs": count_syncs(est)}
    fit_forecast = lambda: engine.fit_forecast(  # noqa: E731
        batch, "arima", config=cfg, horizon=90)
    cv_pass = lambda: engine.cross_validate(  # noqa: E731
        batch, "arima", config=cfg, cv=cv)
    t = {"arima_filter": k, "arima_predict": predict, "hannan_rissanen": hr,
         "arima_filter_twin_ms": twin_filter,
         "arima_predict_twin_ms": twin_predict,
         "fit_forecast_ms": cuda_ms(fit_forecast),
         "fit_forecast_profile": idle_share(fit_forecast, top_n=8),
         "fit_forecast_host_syncs": count_syncs(fit_forecast),
         "cv_pass_ms": cuda_ms(cv_pass),
         "cv_pass_profile": idle_share(cv_pass),
         "cv_pass_host_syncs": count_syncs(cv_pass)}
    hw_ms, hw_mib = peak_mib(lambda: hw.fit(
        batch.y, batch.mask, batch.day, hw.HoltWintersConfig(filter="pscan")))
    ar_ms, ar_mib = peak_mib(lambda: ar.fit(
        batch.y, batch.mask, batch.day, ar.ArimaConfig(kalman="pscan")))
    t["pscan"] = {"hw_filter_pscan_fit": {"ms_host": hw_ms,
                                          "peak_mib": hw_mib},
                  "arima_kalman_pscan_fit": {"ms_host": ar_ms,
                                             "peak_mib": ar_mib}}
    emit("arima_times", card=card_line, reps=REPS, statistic="median", **t)
    return t


def arima_phase(port, card_line: str) -> dict:
    """Phase 10: the arima kernels against their twins, the arima main path
    with every launch counter set to 0 just before it and read just after
    (both arima kernels must launch), its checks and times, ``order: auto``
    on the committed dataset, and ``model: auto`` with the default families
    through the runner three times in one env root (hw_score, hw_filter and
    arima_filter must launch in every train task)."""
    fs, kal = port["fs"], port["kalman"]
    counters = {"hw_score": fs.hw_score, "hw_filter": fs.hw_filter,
                "arima_filter": kal.arima_filter,
                "arima_predict": kal.arima_predict}
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA))
    cases = arima_kernel_cases(batch, port)

    out = {"cases": cases, "launches": {k: 0 for k in ARIMA_KERNELS}}
    for fn in counters.values():  # counters to 0 just before the main path
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        run = arima_main_path(port, tmp)
    launched = {k: fn.launches for k, fn in counters.items()}  # ... and after
    emit("launches", path="arima", **launched,
         expected="arima_filter and arima_predict: 1 per fit_forecast + 1 "
                  "per CV pass, arima_predict 1 per predict")
    for k in ARIMA_KERNELS:
        if launched[k] < 1:
            raise AssertionError(f"the arima main path never launched {k}")
        out["launches"][k] += launched[k]
    out["gpu_vs_cpu"] = check_arima_outputs(run, port)
    out["times"] = arima_timings(run, port, card_line)

    out["order"] = order_auto(port, batch, counters)
    launched = out["order"]["launches"]
    emit("launches", path="order_auto", **launched,
         expected="arima_filter and arima_predict: 1 per CV pass, one pass "
                  "for each of the 22 orders on 500 series")
    for k in ARIMA_KERNELS:
        assert launched[k] == 22, (k, launched)
        out["launches"][k] += launched[k]

    spec = auto_spec(port)
    checked = []
    with tempfile.TemporaryDirectory() as root:
        for version in (1, 2, 3):
            checked.append(check_auto(auto_run(port, root, spec, counters),
                                      port, root, spec, version))
    for c in checked:
        for k in ARIMA_KERNELS:
            out["launches"][k] += c["launches"][k]
    med = lambda key: statistics.median(c[key] for c in checked)  # noqa: E731
    emit("auto_times", card=card_line, runs=len(checked),
         median_seconds=med("seconds"), median_fit_seconds=med("fit_seconds"),
         median_tasks_seconds={k: statistics.median(
             c["tasks_seconds"][k] for c in checked)
             for k in checked[0]["tasks_seconds"]},
         launches_per_train_task=[c["launches"] for c in checked])
    out["auto"] = checked
    return out


# -- phase 11: span buckets, regressors, the chunked fit, the native plane ---

# examples/06's ragged catalog: 10 stores x 50 items, items >= 10 exist
# from this day on
RAGGED = (10, 50)
RAGGED_LAUNCH = 1570
# the 50k-series regime cut to 20,480 series (40 stores x 512 items) in
# chunks of 4,096, compared with the unchunked fit on 8,192 of them
CHUNKED = (40, 512)
CHUNK = 4096
CHUNK_COMPARED = 8192
# the curve tolerance of the parity tests (tests/test_torch_engine.py):
# 2e-4 of each row's scale
CURVE_RTOL = 2e-4
FORECASTS = "hackathon.sales.finegrain_forecasts"
SERVED = "hackathon.sales.test_finegrain_forecasts"
COVARIATES = "hackathon.sales.covariates"
MODEL = "ForecastingBatchModel"
DEVICE = "cuda"  # where phase 11 runs and what its checks expect


def native_snapshot() -> dict:
    """sha256 of every file under native/: the port never writes there."""
    d = os.path.join(ROOT, "native")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def host_ms(fn, reps: int = 3) -> tuple:
    """(median host wall ms of ``reps`` calls of ``fn``, the last result);
    ``fn`` ends in a host pull or synchronizes itself."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def native_plane(port) -> dict:
    """The committed dataset's CSV through the native parser and through
    pandas (equal frames; the date column's unit is each parser's own), and
    tensorize on the native and the pandas planes (bitwise equal on the
    card), each timed."""
    data, dataset, native = port["data"], port["dataset"], port["native"]
    assert data.resolved_backend() == "native", "the native library is off"
    csv_native_ms, df = host_ms(lambda: data.load_sales_csv(DATA))
    csv_pandas_ms, df_pd = host_ms(
        lambda: dataset._coerce_sales_frame(pd.read_csv(DATA)))
    pd.testing.assert_frame_equal(df, df_pd, check_dtype=False)
    tz_native_ms, nat = host_ms(lambda: data.tensorize(df, backend="native"))
    tz_pandas_ms, ref = host_ms(lambda: data.tensorize(df, backend="pandas"))
    for k in ("y", "mask", "day"):
        assert getattr(nat, k).device.type == DEVICE, k
        assert torch.equal(getattr(nat, k), getattr(ref, k)), k
    assert np.array_equal(nat.keys, ref.keys) and nat.keys.dtype == ref.keys.dtype
    assert (nat.start_date, nat.freq) == (ref.start_date, ref.freq)
    out = dict(rows=len(df), shape=[nat.n_series, nat.n_time],
               library=native._lib()._name, frames_equal=True,
               tensorize_bitwise=True, reps=3, statistic="median",
               csv_ms={"native": csv_native_ms, "pandas": csv_pandas_ms},
               tensorize_ms={"native": tz_native_ms, "pandas": tz_pandas_ms})
    emit("native_plane", **out)
    return out


def slice_tasks(port, root: str, training: dict, inference: dict) -> dict:
    """train -> deploy -> inference of the port's task layer on the card in
    ``root`` (its catalog already holds the input tables), each timed."""
    types = port["tasks"].TASK_TYPES
    env = {"env": {"root": root}}
    confs = {
        "train": {"input": {"table": "hackathon.sales.raw"},
                  "output": {"table": FORECASTS},
                  "training": {"model": "prophet", "horizon": 90, "cv": CV,
                               "model_conf": {"seasonality_mode":
                                              "multiplicative",
                                              "holidays": "US"},
                               **training}},
        "deploy": {"deploy": {"experiment": "finegrain_forecasting",
                              "model_name": MODEL}},
        "inference": {"input": {"table": "hackathon.sales.raw"},
                      "output": {"table": SERVED},
                      "inference": {"model_name": MODEL, "horizon": 90,
                                    "promote_to": "Staging", **inference}},
    }
    out, seconds = {}, {}
    for name, conf in confs.items():
        t0 = time.perf_counter()
        out[name] = types[name](init_conf={**env, **conf},
                                device=DEVICE).launch()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    catalog, tracker, registry = _store(port, root)
    run = tracker.get_run(out["train"]["experiment_id"], out["train"]["run_id"])
    assert out["train"]["n_failed"] == 0, out["train"]
    params = run.params()
    assert params["tensorize_backend"] == "native", params
    registered, version = port["serving"].resolve_from_registry(
        registry, MODEL, device=DEVICE)
    assert version.stage == "Staging", version
    served = catalog.read_table(SERVED)
    return dict(results=out, seconds=seconds, run=run, params=params,
                registered=registered, version=version, served=served)


def _rel_rows(a, b) -> float:
    """Largest |a - b| over each row's scale (the max |b| of the row)."""
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def bucketed_phase(port, counters, card_line: str) -> dict:
    """examples/06's ragged catalog at full width: fit_forecast_bucketed for
    Holt-Winters (every hw_score / hw_filter call held to its twin, one
    launch of each a bucket) and the curve model; 20 series of both
    buckets on the card against the CPU; the train task with
    ``training.bucketed`` through deploy and inference; per-bucket fit
    times and BucketedForecaster predict latency."""
    data, engine, hw = port["data"], port["engine"], port["hw"]
    df = data.synthetic_store_item_sales(n_stores=RAGGED[0],
                                         n_items=RAGGED[1], n_days=1826,
                                         seed=12)
    dates = pd.to_datetime(df["date"])
    df = df[(df["item"] < 10) | (dates >= dates.min() + pd.Timedelta(
        days=RAGGED_LAUNCH))].reset_index(drop=True)
    batch = data.tensorize(df)
    cfgs = {"holt_winters": hw.HoltWintersConfig(filter="auto"),
            "prophet": curve_config(batch, port)}
    for fn in counters.values():  # counters to 0 just before the HW fit
        fn.launches = 0
    with KernelRecorder(hw) as rec:
        buckets, res_hw = engine.fit_forecast_bucketed(
            batch, "holt_winters", config=cfgs["holt_winters"], horizon=90)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}  # ... and after
    shapes = [[sub.n_series, sub.n_time] for _, sub, _ in buckets]
    emit("launches", path="bucketed_holt_winters", **launches,
         expected=f"1 of each per bucket: {shapes}")
    assert launches == {"hw_score": len(buckets), "hw_filter": len(buckets)}
    assert len(buckets) == 2, shapes
    cases = {"hw_score": {}, "hw_filter": {}}
    for kernel, case in (("hw_score", score_case), ("hw_filter", filter_case)):
        for i, (args, got) in enumerate(rec.calls[kernel]):
            name = f"bucket{i}_{args[0].shape[0]}x{args[0].shape[1]}"
            cases[kernel][name] = case(port, name, args, got)
    _, res_pg = engine.fit_forecast_bucketed(batch, "prophet",
                                             config=cfgs["prophet"],
                                             horizon=90)
    S, T_all = batch.n_series, batch.n_time + 90
    for name, res in (("holt_winters", res_hw), ("prophet", res_pg)):
        assert res.yhat.shape == (S, T_all) and res.yhat.device.type == DEVICE
        assert bool(res.ok.all()), name
        for k in ("yhat", "lo", "hi"):
            assert bool(torch.isfinite(getattr(res, k)).all()), (name, k)
        assert bool((res.lo <= res.yhat).all() & (res.yhat <= res.hi).all())
        for idx, sub, _ in buckets:  # the rows before a bucket's window
            lead = batch.n_time - sub.n_time
            rows = torch.as_tensor(idx, device=res.yhat.device)
            M = res.yhat[rows]
            assert torch.equal(M[:, :lead], M[:, lead:lead + 1].expand(
                -1, lead)), name

    # 20 series, 10 of each bucket, on the card and on the CPU
    pick = np.concatenate([idx[:10] for idx, _, _ in buckets])
    sub = batch.take_series(pick)
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    vs_cpu = {}
    for model, cfg in cfgs.items():
        bk_gpu, r_gpu = engine.fit_forecast_bucketed(sub, model, config=cfg,
                                                     horizon=90)
        bk_cpu, r_cpu = engine.fit_forecast_bucketed(cpu, model, config=cfg,
                                                     horizon=90)
        assert torch.equal(r_gpu.ok.cpu(), r_cpu.ok)
        agree = torch.ones(len(pick), dtype=torch.bool)
        if model == "prophet":
            tol, kappa = max(cond_tolerance(curve_systems(
                b.y, b.mask, b.day, cfg, port)[1]) for _, b, _ in bk_gpu)
        else:
            # the kernel scores within rtol 1e-5 of the twin (phase 3): a
            # near tie may pick another winner, so the rows are held where
            # both devices picked the same one
            tol, kappa = 1e-5, None
            for (idx, _, p_g), (_, _, p_c) in zip(bk_gpu, bk_cpu):
                same = torch.ones(len(idx), dtype=torch.bool)
                for f in ("alpha", "beta", "gamma", "phi"):
                    same &= getattr(p_g, f).cpu() == getattr(p_c, f)
                agree[torch.as_tensor(idx)] = same
        worst = max(_rel_rows(getattr(r_gpu, k).cpu()[agree],
                              getattr(r_cpu, k)[agree])
                    for k in ("yhat", "lo", "hi"))
        assert worst <= tol, (model, worst, tol)
        vs_cpu[model] = {"max_rel_diff": worst, "tol_rel": tol,
                         "cond_max": kappa, "rows_held": int(agree.sum())}
    emit("bucketed_gpu_vs_cpu_20_series", **vs_cpu)

    # the train task with training.bucketed, then deploy and inference
    with tempfile.TemporaryDirectory() as root:
        port["data"].DatasetCatalog(os.path.join(root, "warehouse")).save_table(
            "hackathon.sales.raw", df)
        t = slice_tasks(port, root, {"bucketed": True}, {})
        assert int(t["params"]["n_buckets"]) == len(buckets), t["params"]
        art = t["version"].artifact_dir
        art = (os.path.join(art, "forecaster")
               if os.path.isdir(os.path.join(art, "forecaster")) else art)
        assert os.path.exists(os.path.join(art, "buckets.json")), art
        fc = t["registered"]
        assert type(fc).__name__ == "BucketedForecaster"
        served = t["served"]
        keys = served[["store", "item"]].drop_duplicates().reset_index(
            drop=True)
        got = fc.predict(keys, horizon=90)
        pd.testing.assert_frame_equal(got, served[got.columns],
                                      check_dtype=False)
        rng = np.random.default_rng(3)
        latency = {}
        for k in (1, 17, 500):
            req = _request(batch.keys[rng.permutation(S)[:k]])
            latency[k], _ = host_ms(lambda: fc.predict(req, horizon=90),
                                    reps=REPS)
        workflow = dict(tasks_seconds=t["seconds"],
                        n_buckets=int(t["params"]["n_buckets"]),
                        fit_seconds=t["run"].metrics()["fit_seconds"],
                        tensorize_backend=t["params"]["tensorize_backend"],
                        inference_rows=len(served), artifact="buckets.json")
    fit_ms = {model: {f"{sub.n_series}x{sub.n_time}": cuda_ms(
        lambda sub=sub, model=model, cfg=cfg: engine.fit_forecast(
            sub, model, config=cfg, horizon=90))
        for _, sub, _ in buckets} for model, cfg in cfgs.items()}
    whole_ms = {model: {
        "bucketed": cuda_ms(lambda model=model, cfg=cfg:
                            engine.fit_forecast_bucketed(
                                batch, model, config=cfg, horizon=90)),
        "full_grid": cuda_ms(lambda model=model, cfg=cfg:
                             engine.fit_forecast(batch, model, config=cfg,
                                                 horizon=90))}
        for model, cfg in cfgs.items()}
    out = dict(shape=[S, batch.n_time], buckets=shapes, launches=launches,
               cases=cases, gpu_vs_cpu=vs_cpu, workflow=workflow,
               fit_ms_per_bucket=fit_ms, fit_ms=whole_ms,
               predict_ms=latency)
    emit("bucketed", card=card_line, reps=REPS, statistic="median",
         **{k: v for k, v in out.items() if k != "cases"})
    return out


def regressor_inputs(batch, horizon: int = 90, seed: int = 7):
    """examples/07's promo calendar (a 2-day event every 13 days, known
    into the future), shared, and a per-series price (a step path from a
    seeded base), as one long table over history + horizon."""
    rng = np.random.default_rng(seed)
    S, T_all = batch.n_series, batch.n_time + horizon
    dates = pd.date_range(batch.start_date, periods=T_all)
    promo = (np.arange(T_all) % 13 < 2).astype(np.float64)
    # a discount of 0-15% that steps on about 1% of the days
    steps = np.cumsum(rng.random((S, T_all)) < 0.01, axis=1) % 4
    price = np.round(rng.uniform(2.0, 8.0, (S, 1)) * (1.0 - 0.05 * steps), 2)
    table = pd.DataFrame({
        "date": np.tile(dates.values, S),
        "store": np.repeat(batch.keys[:, 0], T_all),
        "item": np.repeat(batch.keys[:, 1], T_all),
        "promo": np.tile(promo, S),
        "price": price.reshape(-1)})
    return table, pd.DataFrame({"date": dates, "promo": promo})


def regressor_phase(port, card_line: str) -> dict:
    """The committed dataset with examples/07's promo calendar (shared) and
    a per-series price: fit_forecast and a CV pass with xreg on the card,
    20 series against the CPU, the train task with ``training.regressors``
    (the covariates a catalog table), deploy, inference with
    ``inference.regressors`` and ``inference.quantiles``, and predict
    latency with per-series xreg."""
    data, engine, pg = port["data"], port["engine"], port["pg"]
    df = data.load_sales_csv(DATA)
    batch = data.tensorize(df)
    table, calendar = regressor_inputs(batch)
    cols = ["promo", "price"]
    xreg = data.tensorize_regressors(table, batch, cols, horizon=90,
                                     per_series=True)
    shared = data.tensorize_regressors(calendar, batch, ["promo"], horizon=90)
    assert xreg.shape == (batch.n_series, batch.n_time + 90, 2)
    assert shared.shape == (batch.n_time + 90, 1)
    assert xreg.device.type == DEVICE
    base = curve_config(batch, port)
    cfg = dataclasses.replace(base, n_regressors=2, regressor_names=tuple(cols))
    cfg1 = dataclasses.replace(base, n_regressors=1, regressor_names=("promo",))
    params, res = engine.fit_forecast(batch, "prophet", config=cfg,
                                      horizon=90, xreg=xreg)
    _, res1 = engine.fit_forecast(batch, "prophet", config=cfg1, horizon=90,
                                  xreg=shared)
    metrics = engine.cross_validate(batch, "prophet", config=cfg,
                                    cv=engine.CVConfig(**CV), xreg=xreg)
    for r in (res, res1):
        assert bool(r.ok.all()) and bool(torch.isfinite(r.yhat).all())
    assert metrics["_n_cutoffs"] == 3
    assert bool(torch.isfinite(metrics["mae"]).all())
    assert params.reg_mu.shape == (batch.n_series, 2)
    # the promo column is 0/1: the fit leaves it unstandardized
    assert bool((params.reg_mu[:, 0] == 0).all())

    sub = batch.take_series(range(20))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    x20 = xreg[:20]
    _, r_gpu = engine.fit_forecast(sub, "prophet", config=cfg, horizon=90,
                                   xreg=x20)
    _, r_cpu = engine.fit_forecast(cpu, "prophet", config=cfg, horizon=90,
                                   xreg=x20.cpu())
    assert torch.equal(r_gpu.ok.cpu(), r_cpu.ok)
    tol, kappa = cond_tolerance(curve_systems(
        sub.y, sub.mask, sub.day, cfg, port, xreg=x20[:, :sub.n_time])[1])
    worst = max(_rel_rows(getattr(r_gpu, k).cpu(), getattr(r_cpu, k))
                for k in ("yhat", "lo", "hi"))
    assert worst <= tol, (worst, tol)
    vs_cpu = {"max_rel_diff": worst, "tol_rel": tol, "cond_max": kappa}
    emit("regressors_gpu_vs_cpu_20_series", **vs_cpu)

    reg = {"table": COVARIATES, "columns": cols, "per_series": True}
    quantiles = [0.1, 0.5, 0.9]
    with tempfile.TemporaryDirectory() as root:
        catalog = data.DatasetCatalog(os.path.join(root, "warehouse"))
        catalog.save_table("hackathon.sales.raw", df)
        catalog.save_table(COVARIATES, table)
        t = slice_tasks(port, root, {"regressors": reg},
                        {"regressors": reg, "quantiles": quantiles})
        assert int(t["params"]["n_regressors"]) == 2, t["params"]
        served, fc = t["served"], t["registered"]
        qcols = [f"q{q:g}" for q in quantiles]
        assert list(served.columns) == ["ds", "store", "item", *qcols]
        assert np.isfinite(served[qcols].to_numpy()).all()
        assert (served["q0.1"] <= served["q0.5"]).all()
        assert (served["q0.5"] <= served["q0.9"]).all()
        keys = served[["store", "item"]].drop_duplicates().reset_index(
            drop=True)
        x_all = data.regressors_for_grid(
            catalog.read_table(COVARIATES), day0=fc.day0,
            n_days=fc.day1 + 90 - fc.day0 + 1, regressor_cols=cols,
            per_series=True, keys=fc.keys, key_names=fc.key_names)
        assert torch.equal(x_all, xreg)
        got = fc.predict_quantiles(keys, quantiles=quantiles, horizon=90,
                                   xreg=x_all)
        pd.testing.assert_frame_equal(got, served, check_dtype=False)
        rng = np.random.default_rng(4)
        latency = {}
        for k in (1, 17, 500):
            req = _request(batch.keys[rng.permutation(batch.n_series)[:k]])
            latency[k], _ = host_ms(
                lambda: fc.predict(req, horizon=90, xreg=x_all), reps=REPS)
        workflow = dict(tasks_seconds=t["seconds"],
                        fit_seconds=t["run"].metrics()["fit_seconds"],
                        phases={k: v for k, v in t["run"].metrics().items()
                                if k.startswith("phase_")},
                        tensorize_backend=t["params"]["tensorize_backend"],
                        inference_rows=len(served))
    out = dict(shape=[batch.n_series, batch.n_time], xreg=list(xreg.shape),
               val_mae=float(metrics["mae"].mean()), gpu_vs_cpu=vs_cpu,
               workflow=workflow, predict_ms=latency)
    emit("regressors", card=card_line, reps=REPS, statistic="median", **out)
    return out


def cv_artifact_phase(port) -> dict:
    """The train task with ``training.cv_artifact`` on the committed
    dataset: cv_forecasts.parquet holds one row per series, cutoff and
    observed scored day (the eval masks' sum), and its rows of 20 series
    equal cv_forecast_frame on the CPU (keys, dates, cutoffs and y exactly,
    forecasts within the CV systems' conditioning bound)."""
    data, cv = port["data"], port["cv"]
    df = data.load_sales_csv(DATA)
    batch = data.tensorize(df)
    cfg = curve_config(batch, port)
    with tempfile.TemporaryDirectory() as root:
        data.DatasetCatalog(os.path.join(root, "warehouse")).save_table(
            "hackathon.sales.raw", df)
        t = slice_tasks(port, root, {"cv_artifact": True}, {})
        frame = pd.read_parquet(t["run"].artifact_path("cv_forecasts.parquet"))
        seconds = t["seconds"]
    cvc = cv.CVConfig(**CV)
    cuts = cv.cutoff_indices(batch.n_time, cvc)
    eval_sum = int(cv.cv_windows(batch.mask, batch.day, cuts,
                                 CV["horizon"])[1].sum())
    assert len(frame) == eval_sum, (len(frame), eval_sum)
    sub = batch.take_series(range(20))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    want = cv.cv_forecast_frame(cpu, config=cfg, cv=cvc)
    keys = set(map(tuple, sub.keys.tolist()))
    got = frame[[k in keys for k in zip(frame["store"], frame["item"])]]
    got = got.reset_index(drop=True)
    exact = ["ds", "store", "item", "cutoff", "y"]
    pd.testing.assert_frame_equal(got[exact], want[exact], check_dtype=False)
    _, A, _ = curve_systems(*cv_inputs(sub, cv), sub.day, cfg, port)
    tol, kappa = cond_tolerance(A)
    worst = 0.0
    for col in ("yhat", "yhat_lower", "yhat_upper"):
        scale = want.groupby(["store", "item", "cutoff"])[col].transform(
            lambda v: np.abs(v).max()).to_numpy()
        rel = float((np.abs(got[col].to_numpy() - want[col].to_numpy())
                     / scale).max())
        assert rel <= tol, (col, rel, tol)
        worst = max(worst, rel)
    out = dict(rows=len(frame), eval_mask_sum=eval_sum,
               cutoffs=len(cuts), tasks_seconds=seconds,
               gpu_vs_cpu_20_series={"rows": len(got), "max_rel_diff": worst,
                                     "tol_rel": tol, "cond_max": kappa})
    emit("cv_artifact", **out)
    return out


def chunked_phase(port, card_line: str) -> dict:
    """20,480 series x 1,826 days built as arrays from a seed; the curve
    model's default configuration chunked by 4,096 (5 chunks) under both
    dispatches, against the unchunked fit on 8,192 of the series (the
    curve tolerance); wall time and peak device memory of each."""
    data, engine = port["data"], port["engine"]
    t0 = time.perf_counter()
    batch = data.synthetic_series_batch(n_stores=CHUNKED[0],
                                        n_items=CHUNKED[1], seed=3)
    build_s = time.perf_counter() - t0
    cfg = curve_config(batch, port)
    runs, got = {}, {}
    for dispatch in ("scan", "loop"):
        out = []
        ms, mib = peak_mib(lambda: out.append(engine.fit_forecast_chunked(
            batch, "prophet", config=cfg, horizon=90, chunk_size=CHUNK,
            dispatch=dispatch)))
        got[dispatch] = out[0][1]
        runs[dispatch] = {"ms_host": ms, "peak_mib": mib}
    for k in ("yhat", "lo", "hi", "ok"):  # one host loop either way
        assert torch.equal(getattr(got["scan"], k), getattr(got["loop"], k))
    res = got["scan"]
    assert res.yhat.shape == (batch.n_series, batch.n_time + 90)
    assert bool(res.ok.all()) and bool(torch.isfinite(res.yhat).all())
    del got
    sub = batch.take_series(range(CHUNK_COMPARED))
    out = []
    ms, mib = peak_mib(lambda: out.append(engine.fit_forecast(
        sub, "prophet", config=cfg, horizon=90)))
    runs[f"unchunked_{CHUNK_COMPARED}"] = {"ms_host": ms, "peak_mib": mib}
    whole = out[0][1]
    assert torch.equal(res.ok[:CHUNK_COMPARED], whole.ok)
    worst = max(_rel_rows(getattr(res, k)[:CHUNK_COMPARED],
                          getattr(whole, k)) for k in ("yhat", "lo", "hi"))
    assert worst <= CURVE_RTOL, worst
    del out, whole
    ms, mib = peak_mib(lambda: engine.fit_forecast(batch, "prophet",
                                                   config=cfg, horizon=90))
    runs[f"unchunked_{batch.n_series}"] = {"ms_host": ms, "peak_mib": mib}
    out = dict(shape=[batch.n_series, batch.n_time], chunk_size=CHUNK,
               chunks=-(-batch.n_series // CHUNK), build_seconds=build_s,
               runs=runs, compared_series=CHUNK_COMPARED,
               max_rel_diff_vs_unchunked=worst, tol_rel=CURVE_RTOL)
    emit("chunked", card=card_line, **out)
    return out


def slice9_phase(port, counters, card_line: str) -> dict:
    """Phase 11: the native data plane, span buckets, regressors, the
    chunked fit and the CV artifact."""
    t0 = time.perf_counter()
    out = {"native": native_plane(port),
           "bucketed": bucketed_phase(port, counters, card_line),
           "regressors": regressor_phase(port, card_line),
           "cv_artifact": cv_artifact_phase(port),
           "chunked": chunked_phase(port, card_line)}
    out["seconds"] = time.perf_counter() - t0
    emit("phase11", seconds=out["seconds"])
    return out


# -- phase 12: the online scorer (serving/server.py, batcher.py, tasks/serve.py)

SERVE_CONF = os.path.join(ROOT, "conf", "tasks", "serve_config.yml")
SCORER = "scorer-curve"
SCORER_MODEL = "ForecastingBatchModel"
AUTO_MODEL = "ForecastingAutoModel"
SCORER_HORIZON = 90
LATENCY_REQUESTS = 20  # sequential requests per request size
LOAD_CLIENTS = 32  # concurrent 1-series clients
LOAD_SECONDS = 3.0
OBSERVE_DAYS, OBSERVE_SERIES = 28, 17
# card vs CPU on the same stored parameters: only the forecast arithmetic
# rounds differently (tests/test_torch_predictor.py's rtol and atol)
SCORER_RTOL = 1e-5


def scorer_spec(port) -> dict:
    """real-data-e2e's catalog and etl (the committed dataset), then
    forecasting-e2e's train (the curve model, CV 730/360/90, calibrated
    bands), deploy and inference (which moves the version to Staging),
    built in memory."""
    spec = e2e_spec(port, REAL)
    wf = spec["workflows"][0]
    wf["name"] = SCORER
    wf["tasks"] = [t for t in wf["tasks"] if t["task"] != "monitor"]
    tr = task_conf(spec, "train")
    tr["training"] = dict(task_conf(e2e_spec(port, E2E), "train")["training"],
                          experiment="scorer_forecasting")
    task_conf(spec, "deploy")["deploy"].update(
        experiment="scorer_forecasting", model_name=SCORER_MODEL)
    task_conf(spec, "inference")["inference"]["model_name"] = SCORER_MODEL
    return spec


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scorer_conf(port, root: str, model_name: str, batching: dict,
                extra: dict) -> tuple:
    """conf/tasks/serve_config.yml with ``env.root``, the model, localhost
    and a free port, the batching block's fields in ``batching``, and the
    dotted keys of ``extra`` (the quality store's own directory: two
    processes must never share an append cursor).  Written beside the store;
    returns (path, port, what changed)."""
    conf = port["config"].load_conf(SERVE_CONF)
    number = free_port()
    conf["env"] = {"root": root}
    conf["serving"].update(model_name=model_name, host="127.0.0.1",
                           port=number)
    conf["serving"]["batching"].update(batching)
    for key, value in extra.items():
        *path, last = key.split(".")
        node = conf
        for k in path:
            node = node[k]
        assert last in node, key  # only keys the shipped conf has
        node[last] = value
    path = os.path.join(root, f"serve_{number}.yml")
    with open(path, "w") as f:
        json.dump(conf, f)  # JSON is YAML
    changed = {"env.root": root, "serving.model_name": model_name,
               "serving.host": "127.0.0.1", "serving.port": number,
               **{f"serving.batching.{k}": v for k, v in batching.items()},
               **extra}
    return path, number, changed


class Scorer:
    """``python -m distributed_forecasting_tpu_torch.tasks.serve`` as a
    child process: started, polled on /readyz, and stopped with SIGTERM
    whatever happens in between."""

    def __init__(self, conf_path: str, number: int, log_path: str):
        self.conf_path, self.port, self.log_path = conf_path, number, log_path

    def __enter__(self):
        env = dict(os.environ)
        if DEVICE == "cpu":  # a rehearsal on the CPU
            env["DFTPU_PLATFORM"] = "cpu"
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_forecasting_tpu_torch.tasks.serve",
             "--conf-file", self.conf_path],
            cwd=ROOT, env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self.t0 = time.perf_counter()
        return self

    def wait_ready(self, timeout: float = 600.0) -> dict:
        """Poll /readyz until it answers 200: connection refusals (warmup
        runs before the socket binds, as in the reference) and 503s count
        as not ready.  Fails if the process exits or never gets ready."""
        seen = {}
        while time.perf_counter() - self.t0 < timeout:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"the scorer exited with {self.proc.returncode}: "
                    f"{self.log_tail()}")
            try:
                status = http_call(self.port, "GET", "/readyz")[0]
            except OSError:
                status = "refused"
            seen[str(status)] = seen.get(str(status), 0) + 1
            if status == 200:
                return {"seconds_to_ready": time.perf_counter() - self.t0,
                        "readyz_polls": seen}
            time.sleep(0.1)
        raise AssertionError(f"the scorer was not ready in {timeout} s: "
                             f"{self.log_tail()}")

    def log_tail(self, n: int = 3000) -> str:
        self.log.flush()
        with open(self.log_path) as f:
            return f.read()[-n:]

    def __exit__(self, *exc):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
                self.log.close()
                raise AssertionError("the scorer did not exit on SIGTERM")
        self.log.close()
        self.returncode = self.proc.returncode


def http_call(number: int, method: str, path: str, payload=None,
              headers=None, conn=None):
    """One request -> (status, body bytes, headers); over ``conn`` (a
    keep-alive ``http.client.HTTPConnection``) when given."""
    import http.client

    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", number, timeout=300)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        conn.request(method, path, body=body, headers=dict(headers or {}))
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        if own:
            conn.close()


def _inputs(keys, key_names) -> list:
    return [dict(zip(key_names, map(int, k))) for k in keys]


def _counter(text: str, name: str) -> float:
    import re

    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def scorer_metrics(number: int) -> dict:
    text = http_call(number, "GET", "/metrics")[1].decode()
    return {k: _counter(text, k) for k in (
        "serving_requests_total", "serving_dispatches_total",
        "serving_batch_size_sum", "serving_batch_size_count",
        "serving_rejections_total", "serving_deadline_shed_total")}


def _pcts(ms: list) -> dict:
    a = np.asarray(ms)
    return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99))}


def scorer_requests(fc) -> dict:
    """The request sets: 1, 17 (spread over the catalog) and every series."""
    S = fc.n_series
    rows = {1: [0], 17: np.linspace(0, S - 1, 17).astype(int).tolist(),
            S: list(range(S))}
    return {n: _inputs(fc.keys[r], fc.key_names) for n, r in rows.items()}


def scorer_correctness(port, number: int, fc, fc_cpu, requests) -> dict:
    """Bodies for 1, 17 and all series (and quantiles for 1 and 17) are
    byte-equal to ``_encode_predictions`` of the in-process predict on the
    card; the CPU copy of the artifact agrees within SCORER_RTOL of each
    row's scale."""
    encode = port["server"]._encode_predictions
    out, max_abs, max_rel = {}, 0.0, 0.0
    for n, inputs in requests.items():
        for quantiles in (None, [0.1, 0.5, 0.9]):
            if quantiles and n > 17:
                continue
            payload = {"inputs": inputs, "horizon": SCORER_HORIZON}
            frame = pd.DataFrame(inputs)
            if quantiles:
                payload["quantiles"] = quantiles
                call = lambda f: f.predict_quantiles(  # noqa: E731
                    frame, quantiles=tuple(quantiles), horizon=SCORER_HORIZON)
            else:
                call = lambda f: f.predict(frame, horizon=SCORER_HORIZON)  # noqa: E731
            status, body, _ = http_call(number, "POST", "/invocations", payload)
            assert status == 200, (status, body[:300])
            assert body == encode(call(fc), fc.key_names), (n, quantiles)
            got = pd.DataFrame(json.loads(body)["predictions"])
            cpu = call(fc_cpu)
            cols = [c for c in cpu.columns if c not in ("ds", *fc.key_names)]
            assert list(got.columns) == list(cpu.columns)
            a = got[cols].to_numpy(np.float64).reshape(n, SCORER_HORIZON, -1)
            b = cpu[cols].to_numpy(np.float64).reshape(n, SCORER_HORIZON, -1)
            scale = np.abs(b).max(axis=(1, 2), keepdims=True)
            err = np.abs(a - b)
            assert np.isfinite(a).all() and (err <= SCORER_RTOL * (
                np.abs(b) + scale)).all(), (n, quantiles, float(err.max()))
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / np.maximum(scale, 1e-30)).max()))
            out[f"{n}{'_quantiles' if quantiles else ''}"] = {
                "rows": len(got), "bytes": len(body), "byte_equal": True}
    return {"requests": out, "max_abs_err_vs_cpu": max_abs,
            "max_err_vs_cpu_of_row_scale": max_rel, "rtol": SCORER_RTOL}


def scorer_latency(number: int, requests) -> tuple:
    """LATENCY_REQUESTS sequential requests at each size over one
    keep-alive connection: host wall ms from send to the last body byte.
    Returns the percentiles by size and every request's ms."""
    import http.client

    out, every = {}, []
    for n, inputs in requests.items():
        conn = http.client.HTTPConnection("127.0.0.1", number, timeout=300)
        payload = {"inputs": inputs, "horizon": SCORER_HORIZON}
        ms = []
        try:
            http_call(number, "POST", "/invocations", payload, conn=conn)
            for _ in range(LATENCY_REQUESTS):
                t0 = time.perf_counter()
                status = http_call(number, "POST", "/invocations", payload,
                                   conn=conn)[0]
                ms.append((time.perf_counter() - t0) * 1e3)
                assert status == 200, status
        finally:
            conn.close()
        out[str(n)] = _pcts(ms)
        every += ms
    return out, every


def scorer_breakdown(port, fc, requests) -> dict:
    """Where a request's time goes, in this process: host wall ms of the
    predict (it ends in host pulls) and of encoding its body, medians of 20
    calls (5 for every series) after one warm-up."""
    encode = port["server"]._encode_predictions
    out = {}
    for n, inputs in requests.items():
        frame = pd.DataFrame(inputs)
        p_ms, e_ms = [], []
        for _ in range(1 + (5 if n > 17 else 20)):
            t0 = time.perf_counter()
            pred = fc.predict(frame, horizon=SCORER_HORIZON)
            t1 = time.perf_counter()
            encode(pred, fc.key_names)
            p_ms.append((t1 - t0) * 1e3)
            e_ms.append((time.perf_counter() - t1) * 1e3)
        out[str(n)] = {"predict_ms": statistics.median(p_ms[1:]),
                       "encode_ms": statistics.median(e_ms[1:])}
    return out


def scorer_load(number: int, keys, key_names, keep_bodies: bool,
                seconds: float = LOAD_SECONDS) -> dict:
    """LOAD_CLIENTS threads of 1-series requests for ``seconds``, each with
    its own seeded key sequence and a new connection a request (with more
    clients than the scorer's http.workers, keep-alive clients would hold
    every worker and the rest would wait out the window); the scorer's
    /metrics read before and after."""
    import threading

    before = scorer_metrics(number)
    lat, bodies, bad = [], {}, []
    lock = threading.Lock()
    barrier = threading.Barrier(LOAD_CLIENTS)

    def client(i):
        rng = np.random.default_rng(1000 + i)
        mine = []
        try:
            barrier.wait()
            stop = time.perf_counter() + seconds
            while time.perf_counter() < stop:
                k = int(rng.integers(len(keys)))
                payload = {"inputs": _inputs(keys[[k]], key_names),
                           "horizon": SCORER_HORIZON}
                t0 = time.perf_counter()
                status, body, _ = http_call(number, "POST", "/invocations",
                                            payload)
                mine.append((time.perf_counter() - t0) * 1e3)
                with lock:
                    if status != 200:
                        bad.append(status)
                    elif keep_bodies:
                        bodies.setdefault(k, set()).add(body)
        finally:
            with lock:
                lat.extend(mine)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(LOAD_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 300)
    wall = time.perf_counter() - t0
    after = scorer_metrics(number)
    d = {k: after[k] - before[k] for k in after}
    assert not bad, f"non-200 answers under load: {sorted(set(bad))}"
    out = {"clients": LOAD_CLIENTS, "seconds": wall,
           "requests": len(lat), "requests_per_s": len(lat) / wall,
           **_pcts(lat),
           "serving_requests_total": d["serving_requests_total"],
           "serving_dispatches_total": d["serving_dispatches_total"],
           "dispatches_per_request": (d["serving_dispatches_total"]
                                      / max(d["serving_requests_total"], 1)),
           "mean_batch_size": (d["serving_batch_size_sum"]
                               / max(d["serving_batch_size_count"], 1))}
    return out, bodies


def scorer_admission(port, fc, number: int) -> dict:
    """A burst of 64 concurrent all-series requests at a coalescing server
    (in this process) with max_queue_depth 2: 429s with Retry-After: 1 and
    200s only; then X-Deadline-Ms: 0 at the child scorer: 503, Retry-After:
    1, before any dispatch."""
    import threading

    srv = port["server"].start_server(fc, batching=port["batcher"].BatchingConfig(
        enabled=True, max_batch_size=64, max_wait_ms=5.0, max_queue_depth=2,
        request_timeout_s=60.0))
    answers = []
    lock = threading.Lock()
    barrier = threading.Barrier(64)
    payload = {"inputs": scorer_requests(fc)[fc.n_series],
               "horizon": SCORER_HORIZON}

    def fire():
        barrier.wait()
        status, _, headers = http_call(srv.server_address[1], "POST",
                                       "/invocations", payload)
        with lock:
            answers.append((status, headers.get("Retry-After")))

    try:
        threads = [threading.Thread(target=fire) for _ in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        rejected = srv.metrics.rejections.value
    finally:
        srv.shutdown()
    statuses = sorted({s for s, _ in answers})
    assert len(answers) == 64 and set(statuses) <= {200, 429}, statuses
    n429 = sum(s == 429 for s, _ in answers)
    assert n429 >= 1 and n429 == rejected, (n429, rejected)
    assert all(r == "1" for s, r in answers if s == 429)
    before = scorer_metrics(number)["serving_deadline_shed_total"]
    status, body, headers = http_call(
        number, "POST", "/invocations",
        {"inputs": scorer_requests(fc)[1], "horizon": SCORER_HORIZON},
        headers={"X-Deadline-Ms": "0"})
    assert status == 503 and headers.get("Retry-After") == "1", status
    assert b"deadline budget exhausted" in body
    assert scorer_metrics(number)["serving_deadline_shed_total"] == before + 1
    return {"burst": 64, "answered_200": 64 - n429, "answered_429": n429,
            "retry_after": "1", "deadline_0": status}


def quality64(merged: pd.DataFrame) -> dict:
    """WAPE, RMSSE and coverage of actuals against served bands: each term
    in float32 as the monitor forms it, summed per series and then over the
    series in float64."""
    acc = dict.fromkeys(("abs_err", "abs_y", "sq_err", "inside", "n",
                         "naive_sq", "naive_n"), 0.0)
    for _, g in merged.sort_values(["store", "item", "ds"]).groupby(
            ["store", "item"], sort=False):
        y, yhat = g["y"].to_numpy(np.float32), g["yhat"].to_numpy(np.float32)
        lo = g["yhat_lower"].to_numpy(np.float32)
        hi = g["yhat_upper"].to_numpy(np.float32)
        ok = np.isfinite(y) & np.isfinite(yhat)
        y0 = np.where(ok, y, np.float32(0))
        err = np.where(ok, y - yhat, np.float32(0))
        step = (pd.to_datetime(g["ds"]) - pd.Timestamp("1970-01-01")).dt.days
        adj = ok[1:] & ok[:-1] & (np.diff(step.to_numpy()) == 1)
        d = np.where(adj, y0[1:] - y0[:-1], np.float32(0))
        terms = {"abs_err": np.abs(err), "abs_y": np.abs(y0),
                 "sq_err": err * err,
                 "inside": (ok & (y0 >= lo) & (y0 <= hi)).astype(np.float32),
                 "n": ok.astype(np.float32), "naive_sq": d * d,
                 "naive_n": adj.astype(np.float32)}
        for k, v in terms.items():
            acc[k] += float(np.sum(v.astype(np.float64)))
    return {"wape": acc["abs_err"] / acc["abs_y"],
            "rmsse": float(np.sqrt((acc["sq_err"] / acc["n"])
                                   / (acc["naive_sq"] / acc["naive_n"]))),
            "coverage": acc["inside"] / acc["n"], "observations": acc["n"]}


def scorer_observe(port, number: int, fc, actuals: pd.DataFrame) -> dict:
    """The last OBSERVE_DAYS days of actuals of the 17-series set through
    POST /observe, and through an in-process QualityMonitor on the card:
    both summaries equal a float64 numpy computation over the same actuals
    and the bands the scorer serves for those days (within 1e-12: the
    float64 sums' order)."""
    keys = pd.DataFrame(scorer_requests(fc)[17])
    last = actuals["date"].max()
    obs = actuals[actuals["date"] > last - pd.Timedelta(days=OBSERVE_DAYS)]
    obs = obs.merge(keys).rename(columns={"date": "ds", "sales": "y"})
    obs = obs[["store", "item", "ds", "y"]].assign(
        ds=lambda d: d["ds"].dt.strftime("%Y-%m-%d"))
    status, body, _ = http_call(number, "POST", "/observe",
                                {"observations": obs.to_dict("records")})
    assert status == 200, (status, body[:300])
    summary = json.loads(body)
    horizon = max(1, int((pd.Timestamp(obs["ds"].max())
                          - pd.Timestamp("1970-01-01")).days) - fc.day1)
    status, body, _ = http_call(number, "POST", "/invocations", {
        "inputs": keys.to_dict("records"), "horizon": horizon,
        "include_history": True})
    served = pd.DataFrame(json.loads(body)["predictions"])
    want = quality64(obs.merge(served, on=["store", "item", "ds"]))
    mon = port["quality"].QualityMonitor(
        fc, port["quality"].QualityConfig(enabled=True))
    mon.observe(obs)
    snap = mon.snapshot()
    for got in (summary, snap):
        assert got["observations"] == int(want["observations"]) == len(obs)
        assert got["series_observed"] == OBSERVE_SERIES
        for m in ("wape", "rmsse", "coverage"):
            assert abs(got["metrics"][m] - want[m]) <= 1e-12 * abs(want[m]), (
                m, got["metrics"][m], want[m])
    return {"observations": summary["observations"],
            "series_observed": summary["series_observed"],
            "served": summary["metrics"], "monitor_snapshot": snap["metrics"],
            "numpy_float64": {m: want[m] for m in ("wape", "rmsse",
                                                   "coverage")},
            "nominal_coverage": summary["nominal_coverage"]}


def scorer_auto(port, fc_auto) -> dict:
    """The ``model: auto`` artifact behind a scorer in this process: every
    launch counter set to 0 just before the HTTP requests (1 series arima
    won, 17 with arima's among them, every series) and read just after;
    arima_predict must have launched, and each body equals the in-process
    predict's byte for byte."""
    encode = port["server"]._encode_predictions
    arima = fc_auto.models.index("arima")
    won = np.flatnonzero(fc_auto.assignment == arima)
    assert won.size, "arima won no series: the artifact serves no arima rows"
    S = fc_auto.n_series
    rows = {"1_arima": won[:1].tolist(),
            "17": sorted(set(np.linspace(0, S - 1, 16).astype(int).tolist())
                         | {int(won[0])}),
            str(S): list(range(S))}
    fs, kal = port["fs"], port["kalman"]
    counters = {"hw_score": fs.hw_score, "hw_filter": fs.hw_filter,
                "arima_filter": kal.arima_filter,
                "arima_predict": kal.arima_predict}
    srv = port["server"].start_server(fc_auto)
    try:
        for fn in counters.values():  # counters to 0 just before the path
            fn.launches = 0
        bodies = {}
        for name, r in rows.items():
            inputs = _inputs(fc_auto.keys[r], fc_auto.key_names)
            status, body, _ = http_call(
                srv.server_address[1], "POST", "/invocations",
                {"inputs": inputs, "horizon": SCORER_HORIZON})
            assert status == 200, (name, status, body[:300])
            bodies[name] = (inputs, body)
        launched = {k: fn.launches for k, fn in counters.items()}  # ... after
    finally:
        srv.shutdown()
    emit("launches", path="scorer", **launched,
         expected="arima_predict: 1 per request holding a series arima won")
    # (a rehearsal on the CPU runs the twins, which count nothing)
    assert launched["arima_predict"] >= 1 or DEVICE == "cpu", launched
    for name, (inputs, body) in bodies.items():
        want = encode(fc_auto.predict(pd.DataFrame(inputs),
                                      horizon=SCORER_HORIZON),
                      fc_auto.key_names)
        assert body == want, name
    served = pd.DataFrame(json.loads(bodies["1_arima"][1])["predictions"])
    assert set(served["model"]) == {"arima"}
    return {"family": fc_auto.family, "series_arima_won": int(won.size),
            "launches": launched, "byte_equal": sorted(bodies)}


ROWWISE_REPS = 3  # samples of each rowwise_cost timing


def rowwise_cost(port, fc) -> dict:
    """What bit-identical blocks across request buckets cost on the card:
    the curve model's row-wise design product against the one GEMM it
    replaces, and the in-order row scan against ``torch.cumsum``, at the
    serving and training row counts (CUDA events, median of ROWWISE_REPS
    samples of 20 back-to-back calls)."""
    pg = port["pg"]
    from distributed_forecasting_tpu_torch.models.base import (
        cumsum_rows,
        design_product,
    )

    day_all = torch.arange(fc.day0, fc.day1 + SCORER_HORIZON + 1,
                           dtype=torch.int32, device="cuda")
    X, layout = pg._design(day_all, fc.params.t0, fc.params.t1, fc.config)
    F = layout["n_features"]
    g = torch.Generator(device="cuda").manual_seed(12)
    out = {"T_all": int(X.shape[0]), "F": F}
    # the library calls' rows depend on the row count: the first row of
    # each against the same row computed alone
    beta = fc.params.beta[:, :F].contiguous()
    v = torch.rand(500, X.shape[0], device="cuda", generator=g)
    alone = {"gemm": beta[:1] @ X.T, "cumsum": torch.cumsum(v[:1], 1),
             "design_product": design_product(beta[:1], X),
             "cumsum_rows": cumsum_rows(v[:1])}
    out["row0_max_abs_diff_vs_alone"] = {
        str(M): {"gemm": float(((beta[:M] @ X.T)[:1] - alone["gemm"])
                               .abs().max()),
                 "cumsum": float((torch.cumsum(v[:M], 1)[:1]
                                  - alone["cumsum"]).abs().max()),
                 "design_product": float((design_product(beta[:M], X)[:1]
                                          - alone["design_product"])
                                         .abs().max()),
                 "cumsum_rows": float((cumsum_rows(v[:M])[:1]
                                       - alone["cumsum_rows"]).abs().max())}
        for M in (2, 8, 24, 64, 500)}
    for S in (1, 64, 500, 4096):
        beta = torch.randn(S, F, device="cuda", generator=g)
        v = torch.rand(S, X.shape[0], device="cuda", generator=g)
        out[str(S)] = {
            "design_product_ms": cuda_ms(lambda: design_product(beta, X),
                                         reps=ROWWISE_REPS, inner=20),
            "gemm_ms": cuda_ms(lambda: beta @ X.T, reps=ROWWISE_REPS,
                               inner=20),
            "cumsum_rows_ms": cuda_ms(lambda: cumsum_rows(v),
                                      reps=ROWWISE_REPS, inner=20),
            "torch_cumsum_ms": cuda_ms(lambda: torch.cumsum(v, 1),
                                       reps=ROWWISE_REPS, inner=20)}
    return out


# -- phase 12, slice 11: the store, the SLO evaluator, /detect_anomalies ----

DETECT_DAYS, DETECT_SERIES = 28, 17
DETECT_FULL_DAYS = 20  # x 500 series: 10,000 points, the shipped maximum
DETECT_REQUESTS = {17: 25, 500: 5}  # sequential requests per size
SPIKE_SD = 50.0  # planted spikes, in standard deviations of their series
SPIKES = 12
# card vs CPU on one stored artifact: the CPU tests' tolerances of a served
# predict (tests/test_torch_anomaly.py), as fractions of the data's scale
DETECT_TOL = {"arima": 1e-3}
DETECT_TOL_DEFAULT = 1e-5
SLO_TICK_S = 1.0  # the anomaly child's scrape and evaluation interval


def anomaly_conf(port) -> dict:
    """The shipped ``serving.anomaly`` block, enabled."""
    block = port["config"].load_conf(SERVE_CONF)["serving"]["anomaly"]
    return dict(block, enabled=True)


def detect_points(actuals: pd.DataFrame, fc, n_series: int, days: int,
                  seed: int = 12) -> tuple:
    """The last ``days`` days of actuals of ``n_series`` series spread over
    the catalog, with SPIKES points moved by SPIKE_SD standard deviations of
    their series: (points frame, planted mask)."""
    S = fc.n_series
    rows = np.linspace(0, S - 1, n_series).astype(int)
    keys = pd.DataFrame(fc.keys[rows], columns=list(fc.key_names))
    last = actuals["date"].max()
    pts = actuals[actuals["date"] > last - pd.Timedelta(days=days)]
    pts = pts.merge(keys).rename(columns={"date": "ds", "sales": "y"})
    pts = pts[["store", "item", "ds", "y"]].reset_index(drop=True)
    sd = actuals.merge(keys).groupby(["store", "item"])["sales"].std()
    rng = np.random.default_rng(seed)
    planted = np.zeros(len(pts), dtype=bool)
    planted[rng.choice(len(pts), SPIKES, replace=False)] = True
    sign = np.where(np.arange(len(pts)) % 2 == 0, 1.0, -1.0)
    spread = sd.loc[list(zip(pts["store"], pts["item"]))].to_numpy()
    pts.loc[planted, "y"] = (pts["y"].to_numpy(np.float64)
                             + SPIKE_SD * spread * sign)[planted]
    pts["ds"] = pts["ds"].dt.strftime("%Y-%m-%d")
    return pts, planted


def _family_rows(fc, results) -> list:
    """Each result's serving family (a composite's winner)."""
    if not hasattr(fc, "assignment"):
        return [fc.family] * len(results)
    index = {tuple(map(int, k)): i for i, k in enumerate(fc.keys)}
    return [fc.models[fc.assignment[index[(r["store"], r["item"])]]]
            for r in results]


def detect_vs(got: dict, want: dict, fc, scale: float) -> dict:
    """One detection answer against another on the same points: keys, dates,
    actuals and counts equal; bands within DETECT_TOL of the data's scale
    per family; scores within that error's first-order propagation."""
    for k in ("n_scored", "n_skipped", "threshold"):
        assert got[k] == want[k], (k, got[k], want[k])
    worst = {"band": 0.0, "score": 0.0}
    z = want["threshold"]
    for fam, g, w in zip(_family_rows(fc, want["results"]), got["results"],
                         want["results"]):
        for k in ("store", "item", "ds", "y"):
            assert g[k] == w[k], (k, g, w)
        e = DETECT_TOL.get(fam, DETECT_TOL_DEFAULT) * scale
        for k in ("yhat", "yhat_lower", "yhat_upper"):
            err = abs(g[k] - w[k])
            assert err <= e, (fam, k, g, w)
            worst["band"] = max(worst["band"], err / scale)
        band = w["yhat_upper"] - w["yhat"]
        tol = 2 * e * (z + 2 * w["anomaly_score"]) / band + 1e-6
        err = abs(g["anomaly_score"] - w["anomaly_score"])
        assert err <= tol, (fam, g, w)
        worst["score"] = max(worst["score"], err)
    return {"max_band_err_of_scale": worst["band"],
            "max_score_abs_err": worst["score"]}


def detect_served(port, number: int, fc, fc_cpu, pts, planted,
                  counters=None) -> dict:
    """POST /detect_anomalies at ``number``: the body is the in-process
    scorer's on the card byte for byte, the CPU copy's within detect_vs,
    and every planted point is flagged.  With ``counters``, each launch
    counter is set to 0 just before the request and read just after."""
    anomaly = port["anomaly"]
    config = anomaly.AnomalyConfig.from_conf(anomaly_conf(port))
    for fn in (counters or {}).values():
        fn.launches = 0
    status, body, _ = http_call(number, "POST", "/detect_anomalies",
                                {"points": pts.to_dict("records")})
    launched = {k: fn.launches for k, fn in (counters or {}).items()}
    assert status == 200, (status, body[:300])
    mine = anomaly.AnomalyScorer(fc, config).score(pts)
    assert body == json.dumps(mine).encode(), "served != in-process"
    out = json.loads(body)
    cpu = anomaly.AnomalyScorer(fc_cpu, config).score(pts)
    scale = float(np.abs(pts["y"].to_numpy(np.float64)).max())
    versus = detect_vs(out, cpu, fc, scale)
    flags = np.array([r["is_anomaly"] for r in out["results"]])
    assert out["n_scored"] == len(pts) and flags[planted].all(), (
        out["n_scored"], int(flags[planted].sum()))
    return {"points": len(pts), "n_flagged": out["n_flagged"],
            "planted_flagged": int(flags[planted].sum()),
            "threshold": out["threshold"], "byte_equal_in_process": True,
            "cpu": versus, "launches": launched}


def scorer_detect(port, fc, fc_cpu, fc_auto, fc_auto_cpu, actuals,
                  counters) -> dict:
    """/detect_anomalies at in-process servers on the curve artifact and on
    the ``model: auto`` one: detect_served's checks, with the launch
    counters set to 0 just before the auto requests and read just after
    (one arima_predict a request holding a series arima won); then, with
    batching on, concurrent detection and forecast requests that share
    dispatches."""
    anomaly = port["anomaly"]
    out = {}
    for name, f, f_cpu in (("curve", fc, fc_cpu),
                           ("auto", fc_auto, fc_auto_cpu)):
        srv = port["server"].start_server(
            f, anomaly=anomaly.AnomalyScorer(
                f, anomaly.AnomalyConfig.from_conf(anomaly_conf(port))))
        try:
            pts, planted = detect_points(actuals, f, DETECT_SERIES,
                                         DETECT_DAYS)
            if name == "auto":
                arima = f.models.index("arima")
                won = set(np.flatnonzero(f.assignment == arima).tolist())
                index = {tuple(map(int, k)): i for i, k in enumerate(f.keys)}
                rows = {index[(a, b)] for a, b in zip(pts["store"],
                                                      pts["item"])}
                assert rows & won, "no arima series among the points"
            out[name] = detect_served(port, srv.server_address[1], f, f_cpu,
                                      pts, planted, counters)
            if name == "auto":
                # one batched predict a request: one arima_predict launch
                # (a rehearsal on the CPU runs the twins, which count none)
                got = out[name]["launches"]["arima_predict"]
                assert got == 1 or DEVICE == "cpu", out[name]["launches"]
        finally:
            srv.shutdown()
    out["coalescing"] = detect_coalescing(port, fc, actuals)
    return out


def detect_coalescing(port, fc, actuals) -> dict:
    """Sixteen concurrent clients at a coalescing server in this process,
    half POST /detect_anomalies of one series, half /invocations of one:
    fewer dispatches than requests, and every detection body equal to the
    scorer's answer for that series alone."""
    import threading

    anomaly = port["anomaly"]
    config = anomaly.AnomalyConfig.from_conf(anomaly_conf(port))
    srv = port["server"].start_server(
        fc, anomaly=anomaly.AnomalyScorer(fc, config),
        batching=port["batcher"].BatchingConfig(
            enabled=True, max_batch_size=64, max_wait_ms=50.0,
            max_queue_depth=64, request_timeout_s=120.0))
    pts, _ = detect_points(actuals, fc, 8, DETECT_DAYS)
    per = [g for _, g in pts.groupby(["store", "item"], sort=False)]
    solo = [json.dumps(anomaly.AnomalyScorer(fc, config).score(g)).encode()
            for g in per]
    bodies, statuses = [None] * len(per), []
    barrier = threading.Barrier(2 * len(per))
    number = srv.server_address[1]

    def detect(i):
        barrier.wait()
        status, bodies[i], _ = http_call(number, "POST", "/detect_anomalies",
                                         {"points": per[i].to_dict("records")})
        statuses.append(status)

    def forecast(i):
        barrier.wait()
        statuses.append(http_call(number, "POST", "/invocations", {
            "inputs": _inputs(fc.keys[[i]], fc.key_names),
            "horizon": SCORER_HORIZON})[0])

    try:
        threads = ([threading.Thread(target=detect, args=(i,))
                    for i in range(len(per))]
                   + [threading.Thread(target=forecast, args=(i,))
                      for i in range(len(per))])
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        snap = srv.metrics.snapshot()
    finally:
        srv.shutdown()
    assert statuses == [200] * len(threads), statuses
    assert bodies == solo, "coalesced detection != solo detection"
    requests = len(threads)
    assert snap["serving_dispatches_total"] < requests, snap
    return {"requests": requests,
            "dispatches": snap["serving_dispatches_total"],
            "detect_bodies_equal_solo": len(per)}


def scorer_detect_latency(number: int, sets: dict) -> dict:
    """DETECT_REQUESTS sequential POST /detect_anomalies per point set over
    one keep-alive connection: host wall ms from send to the last byte."""
    import http.client

    out = {}
    for name, pts in sets.items():
        conn = http.client.HTTPConnection("127.0.0.1", number, timeout=300)
        payload = {"points": pts.to_dict("records")}
        ms = []
        try:
            http_call(number, "POST", "/detect_anomalies", payload, conn=conn)
            for _ in range(DETECT_REQUESTS[int(name.split("x")[0])]):
                t0 = time.perf_counter()
                status = http_call(number, "POST", "/detect_anomalies",
                                   payload, conn=conn)[0]
                ms.append((time.perf_counter() - t0) * 1e3)
                assert status == 200, status
        finally:
            conn.close()
        out[name] = {"points": len(pts), **_pcts(ms)}
    return out


def scorer_detect_split(port, fc, sets: dict) -> dict:
    """Where a detection's time goes in this process: the predict (bound as
    the scorer's execute, ending in host pulls) against everything else of
    ``score`` (the merge and the per-point results), medians of 5 calls
    after one warm-up."""
    anomaly = port["anomaly"]
    scorer = anomaly.AnomalyScorer(
        fc, anomaly.AnomalyConfig.from_conf(anomaly_conf(port)))
    spent = []

    def execute(frame, horizon, include_history, quantiles, on_missing,
                xreg):
        t0 = time.perf_counter()
        pred = fc.predict(frame, horizon=horizon,
                          include_history=include_history,
                          on_missing=on_missing)
        spent.append((time.perf_counter() - t0) * 1e3)
        return pred

    scorer.bind_execute(execute)
    out = {}
    for name, pts in sets.items():
        total, predict = [], []
        for _ in range(6):
            spent.clear()
            t0 = time.perf_counter()
            scorer.score(pts)
            total.append((time.perf_counter() - t0) * 1e3)
            predict.append(spent[0])
        p, t = statistics.median(predict[1:]), statistics.median(total[1:])
        out[name] = {"score_ms": t, "predict_ms": p, "host_ms": t - p}
    return out


def _samples(text: str, name: str) -> dict:
    """{label string: value} of one family in a Prometheus exposition."""
    import re

    return {m.group(1) or "": float(m.group(2)) for m in re.finditer(
        rf"^{name}(\{{[^}}]*\}})? (\S+)$", text, re.M)}


def read_store(directory: str) -> list:
    """Every row of a quality store, read as plain JSON lines."""
    rows = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("seg-") and name.endswith(".jsonl"):
            with open(os.path.join(directory, name)) as f:
                rows += [json.loads(x) for x in f.read().splitlines()
                         if x.strip()]
    return rows


def slo_latency_check(number: int, client_ms: list) -> dict:
    """After one evaluation tick: the latency rule's SLI on /metrics lies
    within one histogram bucket of the client's own p95 over the same
    sequential requests."""
    import bisect

    from distributed_forecasting_tpu_torch.serving.batcher import (
        _LATENCY_BUCKETS,
    )

    time.sleep(2 * SLO_TICK_S)
    text = http_call(number, "GET", "/metrics")[1].decode()
    sli = _samples(text, "dftpu_slo_sli")['{rule="predict_latency_p95"}']
    p95 = float(np.percentile(np.asarray(client_ms), 95)) / 1e3
    buckets = [bisect.bisect_left(_LATENCY_BUCKETS, v) for v in (sli, p95)]
    assert abs(buckets[0] - buckets[1]) <= 1, (sli, p95)
    return {"sli_p95_s": sli, "client_p95_s": p95,
            "buckets": [list(_LATENCY_BUCKETS)[i] if i < len(
                _LATENCY_BUCKETS) else "+Inf" for i in buckets]}


def slo_burn_check(number: int, store_dir: str, budget: float,
                   windows) -> dict:
    """Every rule's SLI on /metrics, no evaluation error, and each burn-rate
    gauge equal to mean(bad) / error_budget recomputed from the store's own
    rows at the tick that set it (one of the last three: the loop ticks
    every second while this reads)."""
    time.sleep(2 * SLO_TICK_S)
    text = http_call(number, "GET", "/metrics")[1].decode()
    rows = [r for r in read_store(store_dir) if r["name"] == "dftpu_slo_bad"]
    rules = ("predict_latency_p95", "calibration_coverage",
             "model_staleness")
    slis = _samples(text, "dftpu_slo_sli")
    assert all(f'{{rule="{r}"}}' in slis for r in rules), slis
    assert _samples(text, "dftpu_slo_evaluation_errors_total") == {"": 0.0}
    burns = _samples(text, "dftpu_slo_burn_rate")
    stamps = sorted({r["ts"] for r in rows})[-3:]

    def recompute(now):
        out = {}
        for rule in rules:
            for w, _ in windows:
                pts = [r["value"] for r in rows
                       if r["labels"].get("rule") == rule
                       and now - w <= r["ts"] <= now]
                out[f'{{rule="{rule}",window="{w:g}s"}}'] = (
                    (sum(pts) / len(pts)) / budget if pts else 0.0)
        return out

    match = [now for now in stamps if recompute(now) == burns]
    assert match, (burns, [recompute(n) for n in stamps])
    return {"sli": {k[7:-2]: v for k, v in slis.items()},
            "burn_rates": burns, "recomputed_at_tick": match[-1],
            "bad_rows": len(rows), "evaluation_errors": 0,
            "evaluations": _samples(
                text, "dftpu_slo_evaluations_total")[""]}


def store_readback(store_dir: str, stopped_at: float) -> dict:
    """The anomaly child's store after it stopped (SIGTERM leaves no final
    scrape: the rows are the 1 s ticks'): serving, quality and SLO series,
    the newest within a few ticks of the stop."""
    rows = read_store(store_dir)
    names = {r["name"] for r in rows}
    for want in ("serving_requests_total", "serving_request_latency_"
                 "seconds_p95", "dftpu_quality_wape", "dftpu_slo_bad",
                 "dftpu_slo_evaluations_total"):
        assert want in names, (want, sorted(names)[:40])
    newest = max(r["ts"] for r in rows)
    assert stopped_at - newest <= 10 * SLO_TICK_S, (stopped_at, newest)
    return {"rows": len(rows), "series": len(names),
            "segments": len([n for n in os.listdir(store_dir)
                             if n.endswith(".jsonl")]),
            "bytes": sum(os.path.getsize(os.path.join(store_dir, n))
                         for n in os.listdir(store_dir)),
            "newest_row_s_before_stop": stopped_at - newest}


def evaluate_at_size(port, store_dir: str, slo_block: dict) -> dict:
    """One ``evaluate_once`` over the anomaly child's store as it stopped
    (each rule and window reads the segments whole, so its time grows with
    the store): medians of 3, with the rows and bytes it read."""
    from distributed_forecasting_tpu_torch.monitoring import slo, store

    st = store.TimeSeriesStore(store_dir)
    rows, size = len(read_store(store_dir)), st.stats()["bytes"]
    ev = slo.SLOEvaluator(slo.SLOConfig.from_conf(slo_block), st,
                          staleness_fn=lambda: time.time())
    now = time.time()
    ms = []
    for k in range(3):
        t0 = time.perf_counter()
        ev.evaluate_once(now=now + k)
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    st.query()
    return {"evaluate_once_ms": statistics.median(ms),
            "one_query_ms": (time.perf_counter() - t0) * 1e3,
            "rows": rows, "bytes": size}


def monitoring_cost(port, fc, root: str) -> dict:
    """What the store and the SLO evaluator cost the scorer, in this
    process: 1-series /invocations p50 / p95 at a server with the shipped
    monitoring blocks (scrape and evaluation every SLO_TICK_S) and at one
    with the quality monitor alone, LATENCY_REQUESTS each, interleaved in
    four rounds; then one ``scrape_once`` and one ``evaluate_once`` in ms,
    with the points each writes."""
    import http.client

    quality = port["quality"]
    shipped = port["config"].load_conf(SERVE_CONF)["monitoring"]
    on_conf = json.loads(json.dumps(shipped))
    on_conf["quality_store"].update(
        directory=os.path.join(root, "quality_store_cost"),
        scrape_interval_s=SLO_TICK_S)
    on_conf["slo"]["evaluation_interval_s"] = SLO_TICK_S
    off_conf = {"quality": shipped["quality"]}
    tracking = os.path.join(root, "mlruns")  # the tasks' tracking root
    assert os.path.isdir(tracking), tracking
    servers = {
        "on": port["server"].start_server(fc, quality=quality.build_quality_runtime(
            on_conf, fc, tracking_root=tracking)),
        "off": port["server"].start_server(fc, quality=quality.build_quality_runtime(
            off_conf, fc)),
    }
    payload = {"inputs": scorer_requests(fc)[1], "horizon": SCORER_HORIZON}
    ms = {"on": [], "off": []}
    try:
        conns = {k: http.client.HTTPConnection(
            "127.0.0.1", srv.server_address[1], timeout=300)
            for k, srv in servers.items()}
        for k, c in conns.items():
            http_call(None, "POST", "/invocations", payload, conn=c)
        for _ in range(4):
            for k in ("on", "off"):
                for _ in range(LATENCY_REQUESTS // 4):
                    t0 = time.perf_counter()
                    status = http_call(None, "POST", "/invocations", payload,
                                       conn=conns[k])[0]
                    ms[k].append((time.perf_counter() - t0) * 1e3)
                    assert status == 200, status
        for c in conns.values():
            c.close()
        rt = servers["on"].quality
        now = time.time()
        t0 = time.perf_counter()
        scraped = rt.scrape.scrape_once(now=now + 0.5)
        scrape_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rt.slo.evaluate_once(now=now + 0.75)
        evaluate_ms = (time.perf_counter() - t0) * 1e3
        slo_points = len(rt.store.query(name="dftpu_slo_bad",
                                        since=now + 0.75, until=now + 0.75))
        slo_points += len(rt.store.query(name="dftpu_slo_sli",
                                         since=now + 0.75, until=now + 0.75))
        assert slo_points == 4, slo_points  # latency and staleness rules
        store_bytes = rt.store.stats()["bytes"]
    finally:
        for srv in servers.values():
            srv.shutdown()
    return {"invocations_1_series": {k: _pcts(v) for k, v in ms.items()},
            "scrape_once_ms": scrape_ms, "scrape_points": scraped,
            "evaluate_once_ms": evaluate_ms, "evaluate_points": slo_points,
            "store_bytes": store_bytes,
            "tick_s": SLO_TICK_S}


def scorer_phase(port, card_line: str) -> dict:
    """Phase 12: the online scorer.  Two artifacts registered in one store
    (the curve model's calibrated one, forecasting-e2e's train on the
    committed dataset, and a default-pool ``model: auto`` one); the shipped
    serve conf, started as ``python -m
    distributed_forecasting_tpu_torch.tasks.serve`` twice (batching off and
    on), each with its own quality store directory; the batching-off child
    also runs the anomaly scorer and ticks its scrape loop and SLO evaluator
    every second.  Correctness, latency, coalescing, admission, /observe,
    the SLO gauges against the store's rows, /detect_anomalies, the store
    read back after the children stop, and the arima kernel on the serving
    path."""
    t_phase = time.perf_counter()
    reg_module = port["tracking"]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for spec in (scorer_spec(port), auto_spec(port)):
            name = spec["workflows"][0]["name"]
            res = port["runner"].WorkflowRunner(
                spec, env={"root": root}, device=DEVICE).run(name)
            assert all(r["status"] == "OK" for r in res.values()), res
        registry = reg_module.ModelRegistry(os.path.join(root, "registry"))
        load = port["serving"].resolve_from_registry
        fc, version = load(registry, SCORER_MODEL, stage="Staging",
                           device=DEVICE)
        fc_cpu, _ = load(registry, SCORER_MODEL, stage="Staging",
                         device="cpu")
        fc_auto, _ = load(registry, AUTO_MODEL, stage="Staging",
                          device=DEVICE)
        fc_auto_cpu, _ = load(registry, AUTO_MODEL, stage="Staging",
                              device="cpu")
        assert type(fc).__name__ == "BatchForecaster" and fc.coalesce_safe
        assert fc.interval_scale is not None  # the calibrated artifact
        stores = {m: os.path.join(root, f"quality_store_{m}")
                  for m in ("off", "on")}
        confs = {}
        for mode, batching in (("off", {"enabled": False}),
                               ("on", {"enabled": True, "max_batch_size": 64,
                                       "max_wait_ms": 5})):
            extra = {"monitoring.quality_store.directory": stores[mode]}
            if mode == "off":
                extra.update({
                    "serving.anomaly.enabled": True,
                    "monitoring.quality_store.scrape_interval_s": SLO_TICK_S,
                    "monitoring.slo.evaluation_interval_s": SLO_TICK_S})
            confs[mode] = scorer_conf(port, root, SCORER_MODEL, batching,
                                      extra)
            emit("scorer_conf", batching=mode,
                 derived_from="conf/tasks/serve_config.yml",
                 changed=confs[mode][2])
        slo_block = port["config"].load_conf(SERVE_CONF)["monitoring"]["slo"]
        requests = scorer_requests(fc)
        actuals = port["data"].load_sales_csv(DATA)
        with Scorer(confs["off"][0], confs["off"][1],
                    os.path.join(root, "scorer_off.log")) as off, \
                Scorer(confs["on"][0], confs["on"][1],
                       os.path.join(root, "scorer_on.log")) as on:
            out["ready"] = {"off": off.wait_ready(), "on": on.wait_ready()}
            emit("scorer_ready", **out["ready"])
            status, body, _ = http_call(off.port, "GET", "/health")
            health = json.loads(body)
            assert status == 200 and health["n_series"] == SHAPE[0], health
            assert health["version"] == str(version.version), health
            out["correctness"] = scorer_correctness(port, off.port, fc,
                                                    fc_cpu, requests)
            emit("scorer_correctness", health=health, **out["correctness"])

            out["latency"], every_ms = scorer_latency(off.port, requests)
            out["slo_latency"] = slo_latency_check(off.port, every_ms)
            out["in_process"] = scorer_breakdown(port, fc, requests)
            if DEVICE == "cuda":
                frame = pd.DataFrame(requests[fc.n_series])
                out["predict_500"] = idle_share(
                    lambda: port["server"]._encode_predictions(
                        fc.predict(frame, horizon=SCORER_HORIZON),
                        fc.key_names))
                busy = out["predict_500"].get("device_busy_ms")
                p50 = out["latency"][str(fc.n_series)]["p50_ms"]
                out["device_idle_share_500_served"] = (
                    1.0 - busy / p50 if busy else "not measured")
                out["rowwise"] = rowwise_cost(port, fc)
                emit("scorer_rowwise_cost", card=card_line,
                     **out["rowwise"])
            emit("scorer_latency", card=card_line, batching="off",
                 horizon=SCORER_HORIZON, by_series=out["latency"],
                 in_process=out["in_process"],
                 predict_and_encode_500=out.get("predict_500"),
                 device_idle_share_500_served=out.get(
                     "device_idle_share_500_served"),
                 slo_latency=out["slo_latency"])

            load_off, _ = scorer_load(off.port, fc.keys, fc.key_names, False)
            load_on, bodies = scorer_load(on.port, fc.keys, fc.key_names, True)
            solo = {k: http_call(off.port, "POST", "/invocations", {
                "inputs": _inputs(fc.keys[[k]], fc.key_names),
                "horizon": SCORER_HORIZON})[1] for k in bodies}
            mismatched = [k for k, seen in bodies.items() if seen != {solo[k]}]
            assert not mismatched, f"coalesced bodies differ: {mismatched[:5]}"
            load_on["coalesced_bodies_equal_solo"] = sum(
                len(v) for v in bodies.values())
            assert load_on["dispatches_per_request"] < 1.0, load_on
            out["load"] = {"off": load_off, "on": load_on}
            emit("scorer_coalescing", card=card_line, **out["load"])

            out["admission"] = scorer_admission(port, fc, off.port)
            emit("scorer_admission", **out["admission"])
            out["observe"] = scorer_observe(port, off.port, fc, actuals)
            emit("scorer_observe", **out["observe"])
            out["slo"] = slo_burn_check(
                off.port, stores["off"], float(slo_block["error_budget"]),
                slo_block["windows"])
            emit("scorer_slo", card=card_line, tick_s=SLO_TICK_S,
                 latency=out["slo_latency"], **out["slo"])

            sets = {f"{DETECT_SERIES}x{DETECT_DAYS}": detect_points(
                        actuals, fc, DETECT_SERIES, DETECT_DAYS),
                    f"{fc.n_series}x{DETECT_FULL_DAYS}": detect_points(
                        actuals, fc, fc.n_series, DETECT_FULL_DAYS)}
            first = next(iter(sets))
            out["detect_child"] = detect_served(port, off.port, fc, fc_cpu,
                                                *sets[first])
            frames = {k: v[0] for k, v in sets.items()}
            out["detect_latency"] = scorer_detect_latency(off.port, frames)
            out["detect_split"] = scorer_detect_split(port, fc, frames)
            emit("scorer_detect_latency", card=card_line, batching="off",
                 served=out["detect_child"], by_points=out["detect_latency"],
                 in_process=out["detect_split"])
        stopped_at = time.time()
        out["exit"] = {"off": off.returncode, "on": on.returncode}
        emit("scorer_stopped", signal="SIGTERM", returncodes=out["exit"])
        # the batching-on child scrapes at the shipped 30 s: it may have
        # written no row before it stopped
        out["store"] = {"off": store_readback(stores["off"], stopped_at),
                        "on": {"rows": len(read_store(stores["on"]))}}
        out["store"]["off"]["at_size"] = evaluate_at_size(
            port, stores["off"], slo_block)
        emit("scorer_store", **out["store"])
        out["auto"] = scorer_auto(port, fc_auto)
        emit("scorer_kernels", **out["auto"])
        fs, kal = port["fs"], port["kalman"]
        counters = {"hw_score": fs.hw_score, "hw_filter": fs.hw_filter,
                    "arima_filter": kal.arima_filter,
                    "arima_predict": kal.arima_predict}
        out["detect"] = scorer_detect(port, fc, fc_cpu, fc_auto, fc_auto_cpu,
                                      actuals, counters)
        emit("scorer_detect", **out["detect"])
        out["monitoring_cost"] = monitoring_cost(port, fc, root)
        emit("scorer_monitoring_cost", card=card_line,
             **out["monitoring_cost"])
    out["seconds"] = time.perf_counter() - t_phase
    emit("phase12", seconds=out["seconds"])
    return out


# -- phase 13: automatic data prep (engine/autoprep.py, ops/clean.py) -------

TRAIN_CONF = os.path.join(ROOT, "conf", "tasks", "train_config.yml")
PREP_SEED = 13
PREP_SPIKE = 8.0  # one spike a series: its day's sales times this
PREP_RUNS, PREP_RUN_DAYS = 50, 30  # series with a planted zero run, its days
PREP_SHIFTS, PREP_SHIFT, PREP_SHIFT_DAYS = 50, 20.0, 826  # other series
PREP_HOLDOUT = 90  # the last days, kept clean of spikes and zero runs
PREP_HORIZON = 90
# every stage on, with season and holiday detection
PREP_CONF = dict(enabled=True, season_detect=True, holiday_regressors=True)
# tie rules of the card against the CPU (tests/test_torch_autoprep.py): a
# flag may flip only where its score is within PREP_FLAG_TIE (relative) of
# the threshold; a cp_index may differ only where the row's top two valid
# |dev| are within PREP_CP_TIE * sum|y m| of each other
PREP_FLAG_TIE = 1e-5
PREP_CP_TIE = 1e-6


def prep_inputs(port):
    """The committed dataset with, from ``PREP_SEED``: one x8 spike in every
    series, a 30-day zero run in 50 series and a +20 level shift over the
    last 826 days in 50 others (spikes and zero runs before the last 90
    days).  Returns (the contaminated batch, the truth: the data with the
    shifts and without the spikes and zero runs, the planted rows)."""
    data = port["data"]
    batch = data.tensorize(data.load_sales_csv(DATA))
    S, T = batch.n_series, batch.n_time
    rng = np.random.default_rng(PREP_SEED)
    y = batch.y.cpu().numpy().astype(np.float32)
    rows = rng.permutation(S)
    runs, shifts = rows[:PREP_RUNS], rows[PREP_RUNS:PREP_RUNS + PREP_SHIFTS]
    y[shifts, T - PREP_SHIFT_DAYS:] += PREP_SHIFT
    truth = y.copy()
    last = T - PREP_HOLDOUT
    spike_day = rng.integers(7, last - 7, S)
    y[np.arange(S), spike_day] *= PREP_SPIKE
    starts = rng.integers(0, last - PREP_RUN_DAYS, PREP_RUNS)
    for s, t0 in zip(runs, starts):
        y[s, t0:t0 + PREP_RUN_DAYS] = 0.0
    mask = batch.mask.cpu().numpy()
    dirty = dataclasses.replace(
        batch, y=torch.from_numpy(y * mask).to(batch.y.device))
    return (dirty, torch.from_numpy(truth * mask).to(batch.y.device),
            dict(spikes=S, zero_runs=sorted(int(s) for s in runs),
                 shifts=sorted(int(s) for s in shifts)))


def _cusum_top_two(y, mask) -> tuple:
    """Float64 per row: the gap between the two largest valid |dev| of the
    CUSUM statistic, and sum |y m|."""
    m = mask.astype(np.float64)
    v = y.astype(np.float64) * m
    n_tot = m.sum(1, keepdims=True)
    mu = v.sum(1, keepdims=True) / np.maximum(n_tot, 1)
    dev = np.abs(np.cumsum((y - mu) * m, axis=1))
    n_left = np.cumsum(m, axis=1)
    valid = (n_left >= 2) & (n_tot - n_left >= 2)
    stat = np.sort(np.where(valid, dev, -np.inf), axis=1)
    return stat[:, -1] - stat[:, -2], np.abs(v).sum(1)


def prep_compare(got, want, y_raw: np.ndarray) -> dict:
    """The prep result on the card (``got``) against the CPU's (``want``)
    of the same batch ``y_raw``: the largest difference of each float
    output, the number of differing discrete outputs and how many of them
    each tie rule covers.  Raises on any difference outside the rules."""
    g, w = got.report, want.report
    T = w.n_time
    tol = T * F32_EPS  # float32 bound of a sum of T terms
    thr = w.config.outlier_threshold
    flips = (g.outlier_score > thr) != (w.outlier_score > thr)
    near = np.abs(w.outlier_score - thr) <= PREP_FLAG_TIE * thr
    tie_rows = flips.any(axis=1)  # a flip moves its row's repair anchors
    y_clean_w = np.where(w.repaired, w.repair_value, y_raw)
    mask_w = want.batch.mask.numpy()
    gap, mass = _cusum_top_two(y_clean_w, mask_w)
    scale = np.abs(y_clean_w).max(axis=1)
    cp_diff = (g.cp_index != w.cp_index) & ~tie_rows
    found_flip = cp_diff & ((g.cp_index < 0) != (w.cp_index < 0))
    cp_tie = cp_diff & ~found_flip & (gap <= PREP_CP_TIE * mass)
    cp_thr = w.config.changepoint_threshold
    found_tie = found_flip & (np.abs(np.maximum(g.cp_score, w.cp_score)
                                     - cp_thr) <= tol * cp_thr)
    same = (g.cp_index == w.cp_index) & ~tie_rows
    d_shift = np.abs(g.cp_shift - w.cp_shift)
    d_score = np.abs(g.cp_score - w.cp_score)
    y_got, y_want = got.batch.y.cpu().numpy(), want.batch.y.numpy()
    out = {
        "max_abs_diff": {
            "outlier_score": float(np.abs(g.outlier_score
                                          - w.outlier_score).max()),
            "outlier_scale": float(np.abs(g.outlier_scale
                                          - w.outlier_scale).max()),
            "repair_value": float(np.abs(g.repair_value
                                         - w.repair_value).max()),
            "cp_shift": float(d_shift.max()), "cp_score": float(d_score.max()),
            "y_clean": float(np.abs(y_got - y_want).max()),
            "xreg": float((got.xreg.cpu() - want.xreg).abs().max())
            if want.xreg is not None else None},
        "differing": {
            "masked_zero_cells": int((g.masked_zero_cells
                                      != w.masked_zero_cells).sum()),
            "mask_cells": int((got.batch.mask.cpu().numpy() != mask_w).sum()),
            "outlier_flags": int(flips.sum()),
            "outlier_flags_within_tie": int((flips & near).sum()),
            "repaired_cells": int((g.repaired != w.repaired).sum()),
            "repaired_cells_outside_tie_rows": int(
                (g.repaired != w.repaired)[~tie_rows].sum()),
            "cp_index": int((g.cp_index != w.cp_index).sum()),
            "cp_index_in_tie_rows": int(((g.cp_index != w.cp_index)
                                         & tie_rows).sum()),
            "cp_index_within_tie": int(cp_tie.sum() + found_tie.sum()),
            "season_length": int(g.season_length != w.season_length),
            "holiday_names": int(g.holiday_names != w.holiday_names)},
        "season_length": [g.season_length, w.season_length],
    }
    d = out["differing"]
    assert d["masked_zero_cells"] == d["mask_cells"] == 0, d
    assert d["outlier_flags"] == d["outlier_flags_within_tie"], d
    assert d["repaired_cells_outside_tie_rows"] == 0, d
    assert int(cp_diff.sum()) == d["cp_index_within_tie"], d
    assert d["season_length"] == d["holiday_names"] == 0, d
    assert (d_shift[same] <= tol * (np.abs(w.cp_shift[same])
                                    + scale[same])).all(), out
    assert (d_score[same] <= tol * np.abs(w.cp_score[same]) + 1e-6).all(), out
    # repairs and the fit tensor: bitwise where no tie moved them (the
    # interpolation is elementwise and uncontracted on both devices)
    keep = ~tie_rows
    assert np.array_equal(g.repair_value[keep], w.repair_value[keep]), out
    rows = keep & (g.cp_index == w.cp_index)
    assert np.array_equal(y_got[rows], y_want[rows]) or \
        w.config.align_level_shifts, out
    if want.xreg is not None:
        assert torch.equal(got.xreg.cpu(), want.xreg), out
    return out


def prep_bound(port, S: int, T: int, max_lag: int) -> tuple:
    """(ms, 'bytes' | 'operations') least time of the prep program: y and
    mask read once (f32), the cleaned y and mask and the outlier scores
    written once (f32) with the dropped and repaired maps (bool); the
    operations are the ACF's transforms (``engine/season.acf_work``; the
    MAD's sorts are not counted)."""
    ops, _ = port["season"].acf_work(S, T, max_lag)
    nbytes = S * T * (4 + 4) + S * T * (3 * 4 + 2 * 1)
    return bound_ms((ops, nbytes))


def prep_train_conf(port, root: str, model: str, autoprep: dict) -> dict:
    """conf/tasks/train_config.yml with ``env.root``, the model (for
    Holt-Winters, ``season_length: auto`` in place of the curve model's
    keys) and the ``engine.autoprep`` fields in ``autoprep``."""
    conf = port["config"].load_conf(TRAIN_CONF)
    conf["env"] = {"root": root}
    conf["training"]["model"] = model
    if model == "holt_winters":
        conf["training"]["model_conf"] = {"season_length": "auto"}
    block = conf["engine"]["autoprep"]
    for key in autoprep:
        assert key in block, key  # only keys the shipped conf has
    block.update(autoprep)
    return conf


def prep_task(port, root: str, conf: dict) -> tuple:
    """One train task on the card; (seconds, summary, run)."""
    t0 = time.perf_counter()
    summary = port["tasks"].TASK_TYPES["train"](init_conf=conf,
                                                 device=DEVICE).launch()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _, tracker, _ = _store(port, root)
    return seconds, summary, tracker.get_run(summary["experiment_id"],
                                             summary["run_id"])


def prep_train(port, dirty, counters, found: dict, card_line: str) -> dict:
    """(b) and (c): the train task from the shipped train_config.yml with
    ``engine.autoprep.enabled`` and season detection, ``model:
    holt_winters`` and ``season_length: auto`` (the launch counters set to
    0 just before it and read just after; both HW kernels must launch; its
    prep finds what (a) ``found`` on the same batch), alternating
    with the same task with the prep off; then the curve model (the
    shipped model conf) with every stage on, ``holiday_regressors: true``
    and ``align_level_shifts: true`` among them."""
    ap = port["autoprep"]
    S, T = dirty.n_series, dirty.n_time
    raw = dirty.key_frame().merge(pd.DataFrame({"date": dirty.dates()}),
                                  how="cross")
    raw["sales"] = dirty.y.cpu().numpy().reshape(-1)
    raw = raw[dirty.mask.cpu().numpy().reshape(-1) > 0].reset_index(drop=True)
    on = dict(enabled=True, season_detect=True)
    out = {"wall_seconds": {"prep_on": [], "prep_off": []}}
    try:
        with tempfile.TemporaryDirectory() as root:
            catalog, _, _ = _store(port, root)
            catalog.save_table("hackathon.sales.raw", raw)
            for turn in range(2):
                for k, block in (("prep_on", on),
                                 ("prep_off", dict(enabled=False))):
                    conf = prep_train_conf(port, root, "holt_winters", block)
                    for fn in counters.values():
                        fn.launches = 0
                    sec, summary, run = prep_task(port, root, conf)
                    launches = {k2: fn.launches
                                for k2, fn in counters.items()}
                    out["wall_seconds"][k].append(sec)
                    assert summary["n_failed"] == 0, summary
                    if k == "prep_on" and turn == 0:
                        out["launches"] = launches
                        for name, n in launches.items():
                            assert n >= 1, f"phase 13 never launched {name}"
                        metrics = run.metrics()
                        prep = {m: v for m, v in metrics.items()
                                if m.startswith("prep_")}
                        assert set(prep) == {
                            "prep_masked_zero_cells", "prep_repaired_points",
                            "prep_series_repaired",
                            "prep_series_with_changepoint",
                            "prep_season_length",
                            "prep_holiday_regressors"}, prep
                        report = pd.read_parquet(
                            run.artifact_path("prep_report.parquet"))
                        repairs = pd.read_parquet(
                            run.artifact_path("prep_repairs.parquet"))
                        assert len(report) == S, len(report)
                        assert len(repairs) == prep["prep_repaired_points"]
                        for m in ("prep_masked_zero_cells",
                                  "prep_repaired_points",
                                  "prep_series_repaired",
                                  "prep_series_with_changepoint",
                                  "prep_season_length"):
                            assert prep[m] == found[m], (m, prep, found)
                        assert int(run.params()["season_length"]) == 7
                        assert prep["prep_masked_zero_cells"] >= \
                            PREP_RUNS * PREP_RUN_DAYS, prep
                        out.update(metrics=prep,
                                   phase_autoprep_seconds=metrics[
                                       "phase_autoprep_seconds"],
                                   fit_seconds=metrics["fit_seconds"],
                                   report_rows=len(report),
                                   repairs_rows=len(repairs))
                    if k == "prep_off":
                        assert not any(m.startswith("prep_")
                                       for m in run.metrics())
            # (c) the curve model, the shipped model conf, every stage on:
            # the holiday columns join its regressors
            conf = prep_train_conf(port, root, "prophet", dict(
                enabled=True, holiday_regressors=True, season_detect=True,
                align_level_shifts=True))
            sec, summary, run = prep_task(port, root, conf)
            params, metrics = run.params(), run.metrics()
            n_hol = int(metrics["prep_holiday_regressors"])
            assert n_hol > 0 and int(params["n_regressors"]) == n_hol, params
            assert metrics["prep_season_length"] == 7, metrics
            for name, rows in (("prep_report.parquet", S), (
                    "prep_repairs.parquet", metrics["prep_repaired_points"])):
                assert len(pd.read_parquet(run.artifact_path(name))) == rows
            fc = port["serving"].BatchForecaster.load(
                run.artifact_path("forecaster"), device=DEVICE)
            xreg = ap.autoprep_batch(dirty, ap.AutoprepConfig(
                enabled=True, zero_run_mask=False, outlier_repair=False,
                changepoints=False, holiday_regressors=True),
                horizon=PREP_HORIZON).xreg
            assert xreg.shape == (T + PREP_HORIZON, n_hol)
            hol_names = ap.autoprep_batch(dirty.take_series([0]),
                                          ap.AutoprepConfig(
                enabled=True, zero_run_mask=False, outlier_repair=False,
                changepoints=False, holiday_regressors=True)).report\
                .holiday_names
            assert tuple(fc.config.regressor_names) == hol_names, \
                fc.config.regressor_names
            keys = pd.DataFrame(dirty.keys[:20], columns=list(dirty.key_names))
            got = fc.predict(keys, horizon=PREP_HORIZON, xreg=xreg)
            table = catalog.read_table(FORECASTS)
            want = table.merge(got[["ds", "store", "item"]],
                               on=["ds", "store", "item"])
            assert len(want) == len(got) == 20 * PREP_HORIZON
            got = got.merge(want, on=["ds", "store", "item"],
                            suffixes=("", "_table"))
            vals = got[["yhat", "yhat_upper", "yhat_lower"]].to_numpy()
            assert np.isfinite(vals).all()
            scale = np.abs(got["yhat_table"].to_numpy()).max()
            diff = float(np.abs(got["yhat"] - got["yhat_table"]).max())
            assert diff <= SCORER_RTOL * scale, (diff, scale)
            out["curve_holidays"] = dict(
                seconds=sec, n_regressors=int(params["n_regressors"]),
                holiday_regressors=n_hol, predict_vs_table=diff,
                regressor_names=list(hol_names))
    finally:
        ap.configure_autoprep(ap.AutoprepConfig())
    emit("prep_train", card=card_line, **out)
    return out


def prep_pays(port, dirty, truth) -> dict:
    """(d) Holt-Winters (m 7) fit on the first T - 90 days of the
    contaminated batch, with the prep's cleaning stages and without: the
    repaired fit's MAE over the last 90 days of the truth is lower."""
    engine, hw, ap = port["engine"], port["hw"], port["autoprep"]
    last = dirty.n_time - PREP_HOLDOUT
    train = dataclasses.replace(dirty, y=dirty.y[:, :last].contiguous(),
                                mask=dirty.mask[:, :last].contiguous(),
                                day=dirty.day[:last].contiguous())
    cfg = hw.HoltWintersConfig(season_length=7)
    mae = {}
    for name, prep in (("raw", False), ("repaired", ap.AutoprepConfig(
            enabled=True))):
        _, res = engine.fit_forecast(train, "holt_winters", config=cfg,
                                     horizon=PREP_HOLDOUT, autoprep=prep)
        err = (res.yhat[:, last:] - truth[:, last:]).abs()
        mae[name] = float((err * dirty.mask[:, last:]).sum()
                          / dirty.mask[:, last:].sum())
    out = dict(holdout_days=PREP_HOLDOUT, mae=mae,
               repaired_better=mae["repaired"] < mae["raw"])
    emit("prep_pays", **out)
    assert out["repaired_better"], out
    return out


def prep_times(port, dirty, card_line: str) -> dict:
    """(e) The prep program (``engine/autoprep._autoprep_impl``, every stage
    on) at 500 x 1,826: CUDA-event median of 5 beside its bound, its device
    events and the card's idle share over one call; ``autoprep_batch``
    whole (the program, the period selection and the host pulls of the
    report) on the host clock."""
    ap, season = port["autoprep"], port["season"]
    cfg = ap.AutoprepConfig(**PREP_CONF)
    S, T = dirty.n_series, dirty.n_time
    hol_days, _ = ap._holiday_days_array(dirty, PREP_HORIZON, cfg)
    hol_days = torch.as_tensor(hol_days, device=dirty.y.device)
    day0 = int(dirty.day[0])
    day_all = torch.arange(day0, day0 + T + PREP_HORIZON, dtype=torch.int32,
                           device=dirty.y.device)
    max_lag = season.clamp_max_lag(cfg.season_max_lag, T)
    statics = dict(
        zero_run_mask=cfg.zero_run_mask, zero_run_min=cfg.zero_run_min,
        outlier_repair=cfg.outlier_repair,
        outlier_threshold=cfg.outlier_threshold,
        outlier_window=cfg.outlier_window, changepoints=cfg.changepoints,
        changepoint_threshold=cfg.changepoint_threshold,
        align_level_shifts=cfg.align_level_shifts,
        season_detect=cfg.season_detect, acf_max_lag=max_lag)

    def program():
        return ap._autoprep_impl(dirty.y, dirty.mask, day_all, hol_days,
                                 **statics)

    ms = cuda_ms(program)
    bound, by = prep_bound(port, S, T, max_lag)
    profile = idle_share(program, top_n=8)
    batch_ms, _ = host_ms(lambda: ap.autoprep_batch(dirty, cfg,
                                                    horizon=PREP_HORIZON),
                          reps=REPS)
    out = dict(shape=[S, T], max_lag=max_lag, program_ms=ms, bound_ms=bound,
               bound_by=by, share_of_bound=bound / ms,
               autoprep_batch_host_ms=batch_ms,
               device_events=profile.get("device_events"),
               idle_share=profile.get("idle_share"), profile=profile,
               reps=REPS, statistic="median")
    emit("prep_times", card=card_line, **out)
    return out


def prep_phase(port, counters, card_line: str) -> dict:
    """Phase 13: automatic data prep on the committed dataset, contaminated
    from a seed: (a) the prep program on the card against a CPU copy within
    the tie rules, (b) the train task with the prep on (both HW kernels
    launched, the artifacts and metrics) and off, (c) the curve model with
    holiday regressors, (d) the repaired fit beating the raw one on a
    holdout, (e) times."""
    t_phase = time.perf_counter()
    ap = port["autoprep"]
    dirty, truth, planted = prep_inputs(port)
    cfg = ap.AutoprepConfig(**PREP_CONF)
    got = ap.autoprep_batch(dirty, cfg, horizon=PREP_HORIZON)
    cpu = dataclasses.replace(dirty, y=dirty.y.cpu(), mask=dirty.mask.cpu(),
                              day=dirty.day.cpu())
    want = ap.autoprep_batch(cpu, cfg, horizon=PREP_HORIZON)
    assert got.batch.y.device.type == DEVICE == got.xreg.device.type
    vs_cpu = prep_compare(got, want, cpu.y.numpy())
    summary = got.report.summary()
    assert summary["prep_series_repaired"] >= 0.9 * dirty.n_series, summary
    assert summary["prep_masked_zero_cells"] >= PREP_RUNS * PREP_RUN_DAYS
    assert summary["prep_season_length"] == 7, summary
    emit("prep_gpu_vs_cpu", card=card_line, planted=dict(
        spikes=planted["spikes"], zero_runs=len(planted["zero_runs"]),
        shifts=len(planted["shifts"])), summary=summary,
        shifted_series_found=int((got.report.cp_index[planted["shifts"]]
                                  >= 0).sum()), **vs_cpu)
    out = {"gpu_vs_cpu": vs_cpu, "summary": summary,
           "train": prep_train(port, dirty, counters, summary, card_line),
           "pays": prep_pays(port, dirty, truth),
           "times": prep_times(port, dirty, card_line)}
    out["launches"] = out["train"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    emit("phase13", seconds=out["seconds"])
    return out


# -- phase 14: arnet on the batched trainer, Monte-Carlo bands, tuning ------

SLICE13_HORIZON = 90
ARNET_REPS = 1           # timed fits of each arnet trainer
ARNET_VS_CPU = 20        # series held card against CPU on one schedule
ARNET_W_ATOL = 2e-4      # weights after 840 Adam steps (tests: 750 steps)
ARNET_PATH_RTOL = 2e-5   # fitted paths, of each row's scale
MC_SAMPLES = 1000        # Prophet's own uncertainty_samples default
MC_HOLDOUT = 90          # days held out to score the bands' coverage
TUNE_TRIALS = 8


def slice13_conf(port, root: str, training: dict) -> dict:
    """conf/tasks/train_config.yml with ``env.root`` and ``training``
    updated (its other blocks as shipped)."""
    conf = port["config"].load_conf(TRAIN_CONF)
    conf["env"] = {"root": root}
    conf["training"].update(training)
    return conf


def raw_table(batch) -> pd.DataFrame:
    """The batch's observed cells as the catalog's raw sales table."""
    raw = batch.key_frame().merge(pd.DataFrame({"date": batch.dates()}),
                                  how="cross")
    raw["sales"] = batch.y.cpu().numpy().reshape(-1)
    return raw[batch.mask.cpu().numpy().reshape(-1) > 0].reset_index(drop=True)


def arnet_fits(port, batch, card_line: str) -> dict:
    """(a) The default ArnetConfig (lags 28, 30 epochs, batch 64, adam,
    huber: 840 steps at T 1,826) through ``fit_forecast`` on the family's
    trainer and with ``engine.gradfit`` armed, bitwise equal; the engine
    path unpadded (bucket 500), padded to 512 and to 1,024, bitwise equal;
    times, device events and idle share of the family's fit; 20 series on
    the card against the CPU on one injected schedule."""
    eng, gf, an = port["engine"], port["gradfit"], port["arnet"]
    cfg = an.ArnetConfig()
    H = SLICE13_HORIZON
    fit = lambda: eng.fit_forecast(batch, "arnet", cfg, horizon=H)  # noqa: E731
    trace_ms, (p_in, r_in) = host_ms(fit, reps=ARNET_REPS)
    profile = idle_share(fit, top_n=6)
    try:
        gf.configure_gradfit({"enabled": True})
        eager_ms, (p_eg, r_eg) = host_ms(fit, reps=ARNET_REPS)
    finally:
        gf.configure_gradfit(gf.GradFitConfig())
    bitwise = {name: bool(torch.equal(getattr(r_eg, name),
                                      getattr(r_in, name)))
               for name in ("yhat", "lo", "hi")}
    bitwise["w"] = bool(torch.equal(p_eg.w, p_in.w))
    assert all(bitwise.values()), ("engine path != family trainer", bitwise)
    buckets = {}
    for base in (500, 512, 1024):
        p_b, r_b = gf.gradfit_fit_forecast(
            batch, config=cfg, horizon=H,
            gcfg=gf.GradFitConfig(enabled=True, series_bucket=base))
        buckets[base] = bool(torch.equal(p_b.w, p_in.w)
                             and torch.equal(r_b.yhat, r_in.yhat)
                             and torch.equal(r_b.hi, r_in.hi))
    assert all(buckets.values()), ("bucket growth moved a bit", buckets)
    ok = r_in.ok
    assert r_in.yhat.shape == (batch.n_series, batch.n_time + H)
    assert bool(torch.isfinite(r_in.yhat[ok]).all()), "non-finite arnet path"
    assert bool((r_in.lo <= r_in.hi).all())
    # one schedule, drawn once on the CPU, trains 20 series on both
    n, T = ARNET_VS_CPU, batch.n_time
    sched = gf.minibatch_schedule(torch.Generator().manual_seed(cfg.seed), T,
                                  cfg.batch_size, cfg.epochs)
    y, m, d = batch.y[:n], batch.mask[:n], batch.day
    t0 = time.perf_counter()
    card = an.fit(y, m, d, cfg, schedule=sched.to(y.device))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = an.fit(y.cpu(), m.cpu(), d.cpu(), cfg, schedule=sched)
    cpu_s = time.perf_counter() - t0
    w_err = float((card.w.cpu() - cpu.w).abs().max())
    scale = cpu.fitted.abs().amax(1, keepdim=True).clamp_min(1.0)
    path_err = float(((card.fitted.cpu() - cpu.fitted).abs() / scale).max())
    assert w_err <= ARNET_W_ATOL and path_err <= ARNET_PATH_RTOL, (
        w_err, path_err)
    steps = int(sched.shape[0])
    loop = arnet_step_loop(port, batch, cfg)
    out = dict(config=dataclasses.asdict(cfg), steps=steps, step_loop=loop,
               shape=[batch.n_series, T], ok=int(ok.sum()),
               fit_ms=dict(family_trainer=trace_ms, engine_path=eager_ms,
                           statistic=f"median of {ARNET_REPS}, host wall"),
               ms_per_step=trace_ms / steps,
               device_events=profile.get("device_events"),
               events_per_step=(profile["device_events"] / steps
                                if "device_events" in profile else None),
               idle_share=profile.get("idle_share"), profile=profile,
               eager_equals_family_trainer=bitwise,
               bucket_growth_bitwise={str(k): v for k, v in buckets.items()},
               gpu_vs_cpu_20_series=dict(
                   schedule="one CPU-drawn schedule for both",
                   max_abs_err_w=w_err, max_rel_err_fitted=path_err,
                   card_seconds=card_s, cpu_seconds=cpu_s))
    emit("arnet_fit", card=card_line, **out)
    return out


def arnet_step_loop(port, batch, cfg) -> dict:
    """The step loop alone (``gradfit.train_scan`` on the prepped tensors)
    and the finalize (``params_from_weights`` + ``forecast``), each between
    CUDA events, once; the loop's least time: every step reads its
    minibatch tensors once — the lag features in both layouts (2 L B S),
    targets, weights and the gradient's product (~4 B S) — and does ~4 L B
    S multiply-adds."""
    gf, an = port["gradfit"], port["arnet"]
    y, m, d = batch.y, batch.mask, batch.day
    z, _, _, xz, valid, _, _ = an.prep_training(y, m, cfg)
    sched = gf.default_schedule(cfg, batch.n_time, y.device)
    out = {}
    loop_ms = once_ms(lambda: out.update(w=gf.train_scan(z, xz, valid, cfg,
                                                         schedule=sched)[0]))
    w = out["w"]
    day_all = port["engine"].fit.day_grid(d, SLICE13_HORIZON)

    def finalize():
        p = an.params_from_weights(y, m, d, cfg, w["w"], w["beta"], w["b"])
        an.forecast(p, day_all, d[-1].to(torch.float32), cfg)

    fin_ms = once_ms(finalize)
    S, L, B = batch.n_series, cfg.lags, cfg.batch_size
    steps = int(sched.shape[0])
    bound, by = bound_ms((steps * 4 * L * B * S * 2,
                          steps * 4 * (2 * L * B * S + 4 * B * S)))
    return dict(loop_ms=loop_ms, finalize_ms=fin_ms, loop_bound_ms=bound,
                loop_bound_by=by, loop_share_of_bound=bound / loop_ms)


def arnet_cv(port, batch, card_line: str) -> dict:
    """(b) The CV pass: 3 cutoffs x 500 series as 1,500 rows of one fit."""
    cv = port["cv"]
    cfg = port["arnet"].ArnetConfig()
    ms, m = host_ms(lambda: cv.cross_validate(
        batch, "arnet", cfg, cv=cv.CVConfig(**CV), calibrate=True), reps=1)
    means = {k: float(torch.nanmean(v)) for k, v in m.items()
             if not k.startswith("_")}
    assert m["_n_cutoffs"] == 3 and all(np.isfinite(list(means.values())))
    scale = m["_interval_scale"]
    assert bool(torch.isfinite(scale).all() and (scale > 0).all())
    out = dict(rows=3 * batch.n_series, wall_ms=ms, cv_means=means,
               interval_scale_mean=float(scale.mean()))
    emit("arnet_cv", card=card_line, **out)
    return out


def slice13_tasks(port, batch, counters, card_line: str) -> dict:
    """(c) The train task with ``model: arnet`` and calibrated bands, then
    its artifact loaded and asked for every series' forecast; (d) ``model:
    auto`` over the default pool plus arnet, every launch counter set to 0
    just before the task and read just after (the Holt-Winters and arima
    members launch the four hand kernels); (e) the tuned curve path,
    ``tuning: {enabled: true, n_trials: 8}`` over both modes."""
    from distributed_forecasting_tpu_torch.serving.loader import (
        load_forecaster,
    )

    H = SLICE13_HORIZON
    out = {}
    with tempfile.TemporaryDirectory() as root:
        catalog, _, _ = _store(port, root)
        catalog.save_table("hackathon.sales.raw", raw_table(batch))
        conf = slice13_conf(port, root, dict(
            model="arnet", model_conf={}, calibrate_intervals=True,
            experiment="arnet_forecasting"))
        sec, summary, run = prep_task(port, root, conf)
        assert summary["n_failed"] < batch.n_series, summary
        metrics = run.metrics()
        assert np.isfinite(metrics["val_smape"]) and \
            np.isfinite(metrics["val_coverage_calibrated"]), metrics
        table = catalog.read_table("hackathon.sales.finegrain_forecasts")
        assert len(table) == batch.n_series * (batch.n_time + H)
        fc = load_forecaster(run.artifact_path("forecaster"), device=DEVICE)
        keys = table[["store", "item"]].drop_duplicates()
        t0 = time.perf_counter()
        served = fc.predict(keys, horizon=H)
        predict_ms = (time.perf_counter() - t0) * 1e3
        want = table["yhat"].to_numpy().reshape(batch.n_series, -1)[:, -H:]
        got = served["yhat"].to_numpy().reshape(batch.n_series, H)
        assert np.array_equal(got, want), float(np.abs(got - want).max())
        up = table["yhat_upper"].to_numpy().reshape(batch.n_series, -1)[:, -H:]
        assert np.array_equal(served["yhat_upper"].to_numpy().reshape(
            batch.n_series, H), up)
        out["arnet_task"] = dict(
            seconds=sec, fit_seconds=metrics["fit_seconds"],
            val_smape=metrics["val_smape"],
            val_coverage=metrics["val_coverage"],
            val_coverage_calibrated=metrics["val_coverage_calibrated"],
            interval_scale_mean=metrics["interval_scale_mean"],
            n_failed=summary["n_failed"], served_predict_ms=predict_ms,
            served_equals_table=True)
        emit("arnet_task", card=card_line, **out["arnet_task"])

        pool = [*DEFAULT_POOL, "arnet"]
        conf = slice13_conf(port, root, dict(
            model="auto", model_conf={"families": pool},
            experiment="auto_arnet_forecasting"))
        for fn in counters.values():  # counters to 0 just before the task
            fn.launches = 0
        sec, summary, run = prep_task(port, root, conf)
        launched = {k: fn.launches for k, fn in counters.items()}  # after
        for k, n in launched.items():
            assert n >= 1, f"the pool with arnet never launched {k}"
        table = pd.read_parquet(run.artifact_path("series_metrics.parquet"))
        chosen = table["chosen_model"].value_counts().to_dict()
        assert set(chosen) <= set(pool), chosen
        assert "smape_arnet" in table, list(table.columns)
        out["auto_arnet"] = dict(seconds=sec, families=pool,
                                 fit_seconds=run.metrics()["fit_seconds"],
                                 chosen=chosen, launches=launched,
                                 n_failed=summary["n_failed"])
        emit("auto_arnet", card=card_line, **out["auto_arnet"])

        conf = slice13_conf(port, root, dict(
            tuning={"enabled": True, "n_trials": TUNE_TRIALS},
            experiment="tuned_forecasting"))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sec, summary, run = prep_task(port, root, conf)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        series = pd.read_parquet(run.artifact_path("series_metrics.parquet"))
        trials = pd.read_parquet(run.artifact_path("trials.parquet"))
        assert len(trials) == 2 * TUNE_TRIALS, len(trials)
        assert np.isfinite(summary["metrics"]["val_smape"])
        out["tuned"] = dict(
            seconds=sec, fit_seconds=summary["fit_seconds"],
            peak_mib=peak, trials=len(trials),
            mode_split=series["best_mode"].value_counts().to_dict(),
            val_smape=summary["metrics"]["val_smape"],
            n_failed=summary["n_failed"])
        emit("tuned", card=card_line, **out["tuned"])
    return out


def monte_carlo(port, batch, card_line: str) -> dict:
    """(f) The shipped curve conf (multiplicative, US holidays) with
    ``uncertainty_samples: 1000``, fit on all but the last 90 days:
    ``fit_forecast`` time and peak memory, and the band's mean width and
    its coverage of the held-out days beside the analytic band's."""
    pg, training = port["pg"], port["training"]
    H = MC_HOLDOUT
    T = batch.n_time - H
    fit_b = dataclasses.replace(batch, y=batch.y[:, :T], mask=batch.mask[:, :T],
                                day=batch.day[:T])
    conf = training._resolve_holidays_conf(
        {"seasonality_mode": "multiplicative", "holidays": "US"}, fit_b, H)
    analytic = pg.CurveModelConfig(**conf)
    mc = dataclasses.replace(analytic, uncertainty_samples=MC_SAMPLES)
    eng = port["engine"]
    wall, peak = peak_mib(lambda: eng.fit_forecast(fit_b, "prophet", mc,
                                                   horizon=H))
    ms = once_ms(lambda: eng.fit_forecast(fit_b, "prophet", mc, horizon=H))
    _, r_mc = eng.fit_forecast(fit_b, "prophet", mc, horizon=H)
    a_ms = once_ms(lambda: eng.fit_forecast(fit_b, "prophet", analytic,
                                            horizon=H))
    _, r_an = eng.fit_forecast(fit_b, "prophet", analytic, horizon=H)
    assert torch.equal(r_mc.yhat, r_an.yhat), "the point path moved"
    # the quantile of the paths alone, against reading them once
    params, _ = eng.fit_forecast(fit_b, "prophet", analytic, horizon=H)
    day_all = r_mc.day_all
    _, _, paths = pg._predictive(params, day_all, fit_b.day[-1].to(
        torch.float32), mc, None)
    alpha = (1.0 - mc.interval_width) / 2.0
    q_ms = once_ms(lambda: pg._sample_quantiles(paths, [alpha, 1 - alpha]))
    q_bound, q_by = bound_ms((0, paths.numel() * 4 + 2 * paths.shape[0]
                              * paths.shape[2] * 4))
    draw_ms = once_ms(lambda: pg._predictive(
        params, day_all, fit_b.day[-1].to(torch.float32), mc, None))
    del paths
    truth, held = batch.y[:, T:], batch.mask[:, T:] > 0
    rows = r_mc.ok & r_an.ok

    def band(r):
        lo, hi = r.lo[:, T:], r.hi[:, T:]
        inside = ((truth >= lo) & (truth <= hi) & held)[rows]
        return dict(mean_width=float((hi - lo)[rows].mean()),
                    coverage=float(inside.sum() / held[rows].sum()))

    out = dict(samples=MC_SAMPLES, shape=[batch.n_series, T], horizon=H,
               fit_forecast_ms=ms, analytic_ms=a_ms, first_call_wall_ms=wall,
               paths_ms=draw_ms, quantile_ms=q_ms, quantile_bound_ms=q_bound,
               quantile_bound_by=q_by,
               peak_mib=peak, paths_gib=batch.n_series * MC_SAMPLES
               * (T + H) * 4 / 2 ** 30, monte_carlo=band(r_mc),
               analytic=band(r_an), series=int(rows.sum()))
    assert np.isfinite(out["monte_carlo"]["mean_width"])
    ratio = out["monte_carlo"]["mean_width"] / out["analytic"]["mean_width"]
    assert 0.8 < ratio < 1.25, ratio
    out["width_ratio"] = ratio
    emit("monte_carlo", card=card_line, **out)
    return out


def slice13_phase(port, card_line: str) -> dict:
    """Phase 14: the RNG decision's three paths on the committed dataset —
    arnet (both trainers, the bucket ladder, CV, the train task with
    calibrated bands and its served artifact, a ``model: auto`` pool with
    arnet), the Monte-Carlo curve model and the tuned curve path."""
    t_phase = time.perf_counter()
    fs, kal = port["fs"], port["kalman"]
    counters = {"hw_score": fs.hw_score, "hw_filter": fs.hw_filter,
                "arima_filter": kal.arima_filter,
                "arima_predict": kal.arima_predict}
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA))
    assert (batch.n_series, batch.n_time) == SHAPE
    out = {"arnet": arnet_fits(port, batch, card_line),
           "cv": arnet_cv(port, batch, card_line),
           "monte_carlo": monte_carlo(port, batch, card_line)}
    out.update(slice13_tasks(port, batch, counters, card_line))
    out["launches"] = out["auto_arnet"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    emit("phase14", seconds=out["seconds"])
    return out


# -- phase 15: P8's end — arima method 'mle', the bf16 gate, the sweep --------

# the kernel's Jacobian against torch.autograd through the plain filter in
# float64 on the card, of each row's scale (its largest entry, at least 1):
# within this, or within twice what float32 reverse mode (autograd through
# the same filter in float32: the reference's own method) is off float64 on
# the same inputs, whichever is larger.  Over 1,826 steps float32 itself is
# off by up to ~0.35 of a row's scale at r = 9 on the committed dataset, in
# forward and reverse mode alike (an H100); the CPU tests hold 5e-5 at
# T = 120
MLE_JAC_REL = 1e-3
# card against CPU, the MLE fit: 20 series on their last 365 days and 50
# Adam steps (the CPU copy runs the plain twin, a Python loop of ~60 small
# ops a step); every output row within this of its scale.  logf, tanh and
# the Adam scalars' division round differently on the two devices
MLE_VS_CPU = (20, 365, 50)
MLE_REL = 1e-4
# the gradient step's dependent chain at r = 2: the filter's (~50 cycles,
# ARIMA_CHAIN_CYCLES) and the tangent's behind it, ~100 cycles a step
MLE_CHAIN_CYCLES = 100
# the fit kernel against its twin at the main path's shapes: a few Adam
# steps (the twin runs ~75 launches a time step, ~2.8 s a step at T 1,826,
# so the main path's 200 steps would take ~9 minutes); the card tests hold
# 200 steps at T 150.  The kernels line's arima_mle_fit row gives the main
# path's 200-step launch (ms, bound) and this compared call (its steps, the
# kernel's and the twin's time, the error)
MLE_FIT_STEPS_COMPARED = 2
# the fit's per-step time at its first and its last 20 steps: fits of 20,
# steps - 20 and steps
MLE_STEP_WINDOW = 20
AUTOML_TRIP_BUDGET = 1e-3  # seconds: the gate closes after one evaluation


def mle_args(port, y, mask, p: int, q: int, d: int = 1, seed: int = 0):
    """The likelihood-gradient kernel's arguments on (y, mask): the centered
    differenced series and coefficients from seeded unconstrained PACF
    parameters (u ~ N(0, 0.25)), as an Adam iterate gives them."""
    ar = port["arima"]
    zc, zmask, _ = ar._centered(y, mask, d)
    g = torch.Generator().manual_seed(seed)
    u = (0.5 * torch.randn(y.shape[0], p + q, generator=g)).to(y.device)
    return (zc.contiguous(), zmask.contiguous(),
            ar._pacf_to_coef(u[:, :p]).contiguous(),
            ar._pacf_to_coef(u[:, p:]).contiguous(), max(p, q + 1, 1))


def autograd_jacobian(port, args, dtype) -> tuple:
    """(d ssq, d ldet) by torch.autograd through the plain filter
    (``_kalman_loglik_impl``) in ``dtype``, as float64."""
    zc, zmask, phi, theta, r = args
    ph = phi.to(dtype).requires_grad_(True)
    th = theta.to(dtype).requires_grad_(True)
    with torch.enable_grad():
        out = port["arima"]._kalman_loglik_impl(zc.to(dtype), zmask.to(dtype),
                                                ph, th, r)
        jac = []
        for i in range(2):
            grads = torch.autograd.grad(out[i].sum(), [ph, th],
                                        retain_graph=i == 0,
                                        allow_unused=True)
            jac.append(torch.cat([g if g is not None else torch.zeros_like(x)
                                  for g, x in zip(grads, (ph, th))],
                                 dim=1).double())
    return tuple(jac)


def jacobian_vs_autograd(port, args, got) -> dict:
    """The kernel's Jacobians against float64 autograd through the plain
    filter on the card, beside float32 autograd's distance from it."""
    want = autograd_jacobian(port, args, torch.float64)
    rev32 = autograd_jacobian(port, args, torch.float32)
    worst, ref, ok = {}, {}, True
    for name, w, r32 in zip(("dssq", "dldet"), want, rev32):
        scale = w.abs().amax(dim=1).clamp_min(1.0)
        rel = lambda a: float(((a - w).abs().amax(dim=1)  # noqa: E731
                               / scale).max())
        worst[name] = rel(getattr(got, name).double())
        ref[name] = rel(r32)
        ok &= worst[name] <= max(MLE_JAC_REL, 2 * ref[name])
    return dict(max_rel_to_scale=worst, reverse_mode_f32_rel=ref,
                limit=MLE_JAC_REL, **{"pass": ok})


def mle_kernel_case(port, case: str, args, jacobian: bool = False,
                    want=None) -> dict:
    """arima_loglik_grad on ``args`` against its twin on the same inputs,
    bit for bit, and its ssq, ldet and n against arima_filter's, bit for
    bit; with ``jacobian`` its Jacobians against float64 autograd too.
    ``want``: the twin's rows of ``args`` where the caller ran it (on
    several cases' rows at once: the twin is row-independent); else the
    twin runs here, timed (``twin_ms``, CUDA events).  Raises on a
    disagreement."""
    kal = port["kalman"]
    zc, zmask, phi, theta, r = args
    got = kal.arima_loglik_grad(*args)
    twin_ms = None
    if want is None:
        box = {}
        twin_ms = once_ms(lambda: box.update(
            want=kal.arima_loglik_grad_reference(*args)))
        want = box["want"]
    filt = kal.arima_filter(zc, zmask, None, None, phi, theta,
                            torch.zeros(zc.shape[0], device=zc.device), r, 0)
    torch.cuda.synchronize()
    res = compare_bitwise({k: (g, w) for k, g, w in zip(
        kal.LoglikGrad._fields, got, want)})
    primal = compare_bitwise({k: (getattr(got, k), getattr(filt, k))
                              for k in ("ssq", "ldet", "n")})
    res.update(S=int(zc.shape[0]), T=int(zc.shape[1]), p=int(phi.shape[1]),
               q=int(theta.shape[1]), r=r, twin_ms=twin_ms,
               primal_equals_arima_filter=primal["pass"])
    if jacobian:
        res["jacobian_vs_autograd_f64"] = jacobian_vs_autograd(port, args, got)
    emit("kernel_vs_twin", kernel="arima_loglik_grad", case=case, **res)
    if not (res["pass"] and primal["pass"]
            and res.get("jacobian_vs_autograd_f64", {"pass": True})["pass"]):
        raise AssertionError(f"arima_loglik_grad disagrees: {case}")
    return res


def mle_kernel_cases(batch, port) -> dict:
    """(a) The gradient kernel at the main path's shapes: the fit (2, 1, 1)
    on 500 x 1,826, the CV pass's 1,500 rows with the cutoffs' train masks,
    d = 0, 10% more cells masked, r = 4 (p = 4), r = 8 (p = 8: P and dP in
    shared memory) and r = 9 (p = 9, the shared-memory path); the Jacobian against float64 autograd at the fit
    shape and at r = 9; the ValueError at r = 70.  The twin runs once for
    the CV pass's and the masked case's rows together (one (p, q, d), one
    T; the twin is row-independent, so each case's rows are what a twin of
    its own rows gives) and alone, timed, for every other case."""
    rng = np.random.default_rng(2)
    drop = torch.from_numpy((rng.random(tuple(batch.y.shape)) >= 0.1)
                            .astype(np.float32)).to(batch.y.device)
    full = batch.y * batch.mask
    cv_y, cv_mask = cv_inputs(batch, port["cv"])
    cases = {
        "fit_211": (full, batch.mask, 2, 1, 1),
        "cv_1500": (cv_y, cv_mask, 2, 1, 1),
        "d0_201": (full, batch.mask, 2, 1, 0),
        "masked_10pct": (full * drop, batch.mask * drop, 2, 1, 1),
        "r4_400": (full, batch.mask, 4, 0, 1),
        "r8_800": (full, batch.mask, 8, 0, 1),
        "warp_r9": (full, batch.mask, 9, 0, 1),
    }
    args = {name: mle_args(port, y, m, p, q, d)
            for name, (y, m, p, q, d) in cases.items()}
    stacked = ("cv_1500", "masked_10pct")
    rows = [int(args[n][0].shape[0]) for n in stacked]
    joint = port["kalman"].arima_loglik_grad_reference(
        *(torch.cat([args[n][i] for n in stacked]) for i in range(4)),
        args[stacked[0]][4])
    wants = {n: type(joint)(*(x[a:a + k] for x in joint))
             for n, a, k in zip(stacked, (0, rows[0]), rows)}
    out = {}
    for name in cases:
        out[name] = mle_kernel_case(port, name, args[name],
                                    jacobian=name in ("fit_211", "warp_r9"),
                                    want=wants.get(name))
    big = mle_args(port, full[:4], batch.mask[:4], 70, 0)
    try:
        port["kalman"].arima_loglik_grad(*big)
    except ValueError as exc:
        assert "limit of 64" in str(exc), exc
        emit("kernel_refuses", kernel="arima_loglik_grad", r=70,
             error=str(exc))
    else:
        raise AssertionError("arima_loglik_grad took r = 70")
    return out


def mle_fit_case(port, case: str, y, mask, p: int, q: int,
                 steps: int = MLE_FIT_STEPS_COMPARED) -> dict:
    """arima_mle_fit on the centered series of (y, mask) against its twin
    (``mle_fit_reference``) on the same inputs, bit for bit (u, and phi and
    theta mapped from it); the twin's time (CUDA events, once).  Raises on
    a disagreement."""
    kal, ar = port["kalman"], port["arima"]
    zc, zmask, _ = ar._centered(y, mask, 1)
    zc, zmask = zc.contiguous(), zmask.contiguous()
    r = max(p, q + 1, 1)
    cfg = ar.ArimaConfig()
    fit = (zc, zmask, p, q, r, steps, cfg.learning_rate, cfg.prior_scale)
    box = {}
    twin_ms = once_ms(lambda: box.update(u=kal.mle_fit_reference(*fit)))
    want = box["u"]
    launch, got = kal._mle_fit_launcher(*fit)
    launch()
    torch.cuda.synchronize()
    res = compare_bitwise({
        "u": (got, want),
        "phi": (ar._pacf_to_coef(got[:, :p]), ar._pacf_to_coef(want[:, :p])),
        "theta": (ar._pacf_to_coef(got[:, p:]),
                  ar._pacf_to_coef(want[:, p:]))})
    res.update(S=int(zc.shape[0]), T=int(zc.shape[1]), p=p, q=q, r=r,
               steps=steps, twin_ms=twin_ms,
               rows_differ=int((got != want).any(dim=1).sum()))
    emit("kernel_vs_twin", kernel="arima_mle_fit", case=case, **res)
    if not res["pass"]:
        raise AssertionError(f"arima_mle_fit disagrees: {case}")
    return res


def mle_fit_cases(batch, port) -> dict:
    """The fit kernel at the main path's shapes: the fit (2, 1, 1) on 500 x
    1,826 and the CV pass's 1,500 rows, MLE_FIT_STEPS_COMPARED Adam steps;
    r = 8 (p = 8) and r = 9 (p = 9, the shared-memory path), one step each;
    the ValueError at r = 70."""
    full = batch.y * batch.mask
    cv_y, cv_mask = cv_inputs(batch, port["cv"])
    out = {"fit_211": mle_fit_case(port, "fit_211", full, batch.mask, 2, 1),
           "cv_1500": mle_fit_case(port, "cv_1500", cv_y, cv_mask, 2, 1),
           "r8_800": mle_fit_case(port, "r8_800", full, batch.mask, 8, 0,
                                  steps=1),
           "warp_r9": mle_fit_case(port, "warp_r9", full, batch.mask, 9, 0,
                                   steps=1)}
    zc, zmask, *_ = mle_args(port, full[:4], batch.mask[:4], 70, 0)
    try:
        port["kalman"].arima_mle_fit(zc, zmask, 70, 0, 70, 2, 0.05, 1.0)
    except ValueError as exc:
        assert "limit of 64" in str(exc), exc
        emit("kernel_refuses", kernel="arima_mle_fit", r=70, error=str(exc))
    else:
        raise AssertionError("arima_mle_fit took r = 70")
    return out


def mle_main_path(port, batch) -> dict:
    """(b) The MLE main path: fit_forecast(model="arima", method="mle") at
    the default (2, 1, 1) and 200 steps, then its CV pass (1,500 rows),
    each timed on the host clock to a synchronize."""
    engine, ar = port["engine"], port["arima"]
    cfg = ar.ArimaConfig(method="mle")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, result = engine.fit_forecast(batch, "arima", config=cfg,
                                         horizon=90)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = engine.cross_validate(batch, "arima", config=cfg,
                                    cv=engine.CVConfig(**CV))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(cfg=cfg, params=params, result=result, metrics=metrics,
                fit_seconds=t1 - t0, cv_seconds=t2 - t1)


def check_mle_outputs(run, batch) -> dict:
    """Every parameter finite, the coefficients stationary and moved off
    u = 0, every series' forecast finite with lo <= yhat <= hi, 3 CV
    cutoffs with finite metrics."""
    p, res = run["params"], run["result"]
    for f in dataclasses.fields(p):
        assert torch.isfinite(getattr(p, f.name)).all(), f.name
    assert tuple(p.phi.shape) == (batch.n_series, 2)
    assert float(p.phi.abs().max()) > 1e-2
    assert bool(res.ok.all()) and torch.isfinite(res.yhat).all()
    assert bool((res.lo <= res.yhat).all() and (res.yhat <= res.hi).all())
    m = run["metrics"]
    assert m["_n_cutoffs"] == 3
    means = {k: float(m[k].mean()) for k in ("smape", "mae", "coverage")}
    assert all(np.isfinite(v) for v in means.values()), means
    out = dict(n_failed=int((~res.ok).sum()), cv_means=means,
               phi_mean=p.phi.mean(0).tolist(),
               theta_mean=p.theta.mean(0).tolist())
    emit("arima_mle_outputs", **out)
    return out


def mle_vs_cpu(port, batch) -> dict:
    """20 series on their last 365 days, 50 Adam steps: the MLE fit and
    forecast on the card and on the CPU (the plain twin), every output row
    within MLE_REL of its scale."""
    ar = port["arima"]
    n, days, steps = MLE_VS_CPU
    sub = batch.take_series(range(n))
    y, mask = (x[:, -days:].contiguous() for x in (sub.y, sub.mask))
    day = sub.day[-days:].contiguous()
    cfg = ar.ArimaConfig(method="mle", fit_steps=steps)
    day_all = torch.arange(int(day[0]), int(day[-1]) + 91, dtype=day.dtype,
                           device=day.device)
    t0 = time.perf_counter()
    p_gpu = ar.fit(y, mask, day, cfg)
    band_gpu = ar.forecast(p_gpu, day_all, None, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p_cpu = ar.fit(y.cpu(), mask.cpu(), day.cpu(), cfg)
    band_cpu = ar.forecast(p_cpu, day_all.cpu(), None, cfg)
    t2 = time.perf_counter()
    pairs = [(f.name, getattr(p_gpu, f.name), getattr(p_cpu, f.name))
             for f in dataclasses.fields(p_cpu)]
    pairs += list(zip(("yhat", "lo", "hi"), band_gpu, band_cpu))
    worst = {}
    for k, a, b in pairs:
        if not b.numel():
            continue
        rows = b.shape[0] if b.dim() and b.shape[0] == n else 1
        a, b = a.cpu().reshape(rows, -1), b.reshape(rows, -1)
        err = (a - b).abs().amax(dim=1)
        scale = b.abs().amax(dim=1).clamp_min(1.0)
        bad = err > MLE_REL * scale
        assert not bad.any(), (k, err[bad].tolist(), scale[bad].tolist())
        worst[k] = float((err / scale).max())
    res = dict(series=n, days=days, fit_steps=steps, limit=MLE_REL,
               max_rel_to_scale=worst, card_seconds=t1 - t0,
               cpu_seconds=t2 - t1)
    emit("arima_mle_gpu_vs_cpu_20_series", **res)
    return res


def hr_vs_mle(port, batch, mle_params) -> dict:
    """The one-step in-sample MSE of the HR and the MLE fit of every series
    (observed days after the first 5, as the reference's quality test
    compares them), beside each other."""
    hr_params, _ = port["engine"].fit_forecast(batch, "arima", horizon=90)
    y, m = batch.y, batch.mask

    def mse(p):
        e = ((p.fitted - y) ** 2 * m)[:, 5:].sum(1)
        return (e / m[:, 5:].sum(1).clamp_min(1.0)).cpu().numpy()

    e_hr, e_mle = mse(hr_params), mse(mle_params)
    ratio = e_hr / e_mle
    res = dict(series=int(len(e_hr)), median_mse_hr=float(np.median(e_hr)),
               median_mse_mle=float(np.median(e_mle)),
               ratio_hr_over_mle={"median": float(np.median(ratio)),
                                  "p10": float(np.percentile(ratio, 10)),
                                  "p90": float(np.percentile(ratio, 90)),
                                  "max": float(ratio.max())},
               share_hr_within_10pct=float((e_hr < 1.1 * e_mle).mean()),
               share_mle_lower=float((e_mle < e_hr).mean()))
    emit("arima_hr_vs_mle", **res)
    return res


def mle_tasks(port, batch, counters, card_line: str) -> dict:
    """The train task with ``model: arima, model_conf: {method: mle}``
    through deploy and inference (the registered artifact predicting the
    inference table), then ``model: auto`` with ``configs: {arima:
    {method: mle}}``; the launch counters set to 0 just before each train
    task and read after (a fit is one launch of arima_mle_fit)."""
    out = {"launches": {"arima_mle_fit": 0, "arima_loglik_grad": 0}}
    with tempfile.TemporaryDirectory() as root:
        catalog, _, _ = _store(port, root)
        catalog.save_table("hackathon.sales.raw", raw_table(batch))
        for fn in counters.values():
            fn.launches = 0
        run = slice_tasks(port, root, dict(model="arima",
                                           model_conf={"method": "mle"}), {})
        launched = {k: fn.launches for k, fn in counters.items()}
        # the train task's CV pass and its full fit: one launch each;
        # inference's forecast launches arima_predict
        assert launched["arima_mle_fit"] == 2, launched
        assert launched["arima_loglik_grad"] == 0, launched
        assert launched["arima_filter"] >= 2 and launched["arima_predict"] >= 1
        served = run["served"]
        assert len(served) == batch.n_series * 90, len(served)
        assert np.isfinite(served[["yhat", "yhat_lower", "yhat_upper"]]
                           .to_numpy()).all()
        keys = served[["store", "item"]].drop_duplicates()
        got = run["registered"].predict(keys, horizon=90)
        cols = ["ds", "store", "item", "yhat", "yhat_upper", "yhat_lower"]
        pd.testing.assert_frame_equal(got[cols], served[cols],
                                      check_dtype=False)
        metrics = run["run"].metrics()
        out["task"] = dict(seconds=run["seconds"],
                           fit_seconds=metrics["fit_seconds"],
                           val_smape=metrics["val_smape"],
                           launches=launched, served_equals_registry=True)
        for k in out["launches"]:
            out["launches"][k] += launched[k]
        emit("arima_mle_task", card=card_line, **out["task"])

        conf = slice13_conf(port, root, dict(
            model="auto", model_conf={"configs": {"arima": {"method": "mle"}}},
            experiment="auto_mle_forecasting"))
        for fn in counters.values():
            fn.launches = 0
        sec, summary, run = prep_task(port, root, conf)
        launched = {k: fn.launches for k, fn in counters.items()}
        # the pool's CV pass and its full fit: one arima fit launch each
        assert launched["arima_mle_fit"] == 2, launched
        assert launched["arima_loglik_grad"] == 0, launched
        table = pd.read_parquet(run.artifact_path("series_metrics.parquet"))
        assert np.isfinite(table["smape_arima"]).all()
        chosen = table["chosen_model"].value_counts().to_dict()
        out["auto"] = dict(seconds=sec, fit_seconds=summary["fit_seconds"],
                           chosen=chosen, launches=launched,
                           n_failed=summary["n_failed"])
        for k in out["launches"]:
            out["launches"][k] += launched[k]
        emit("auto_mle", card=card_line, **out["auto"])
    return out


def bf16_gate(port, batch, card_line: str) -> dict:
    """(c) The precision gate.  On the scan route: the bf16 and float32
    score tables of the default grid, the fit with and without the gate
    (winners the argmins of their tables; where they differ, the float32
    gap between the two winners lies inside the bf16 error measured on
    those two candidates), the refit float32.  Then the HW train task with
    ``precision.bf16_scoring`` on and off, under ``filter: scan`` (runs to
    its end) and under ``filter: auto`` (the hw_score kernel, which ignores
    the gate: the forecast tables byte-equal)."""
    hw, prec = port["hw"], port["precision"]
    y, mask, day = batch.y, batch.mask, batch.day
    cfg = hw.HoltWintersConfig(filter="scan")
    A, B, G, P = hw._candidate_grid(cfg, device=y.device)
    bf = torch.bfloat16

    def scores(dt):
        return hw._filter(y.to(dt), mask.to(dt), A.to(dt)[None],
                          B.to(dt)[None], G.to(dt)[None], 7, "additive",
                          P.to(dt)[None], keep_path=False)[1].float()

    scoring_ms = {}
    for name, dt in (("float32", torch.float32), ("bf16", bf)):
        scores(dt)  # warm-up
        scoring_ms[name] = once_ms(lambda: scores(dt))  # noqa: B023
    m32, m16 = scores(torch.float32), scores(bf)
    fits = {}
    try:
        for on in (False, True):
            prec.configure_precision(prec.PrecisionConfig(bf16_scoring=on))
            fits[on] = hw.fit(y, mask, day, cfg)
    finally:
        prec.configure_precision(prec.PrecisionConfig())
    w32, w16 = m32.argmin(1), m16.argmin(1)
    assert torch.equal(fits[False].alpha, A[w32])
    assert torch.equal(fits[True].alpha, A[w16])
    assert fits[True].fitted.dtype == torch.float32
    rows = torch.arange(batch.n_series, device=y.device)
    err = (m16 - m32).abs()
    differ = w16 != w32
    gap = m32[rows, w16] - m32[rows, w32]
    inside = gap <= err[rows, w16] + err[rows, w32]
    assert bool(inside[differ].all())
    rel_err = (err / m32).amax(1)
    out = dict(series=batch.n_series, candidates=int(A.shape[0]),
               winners_differ=int(differ.sum()),
               bf16_rel_err={"median": float(rel_err.median()),
                             "max": float(rel_err.max())},
               scan_scoring_ms=scoring_ms,
               differ_inside_bf16_error=True)
    tables, seconds = {}, {}
    with tempfile.TemporaryDirectory() as root:
        catalog, _, _ = _store(port, root)
        catalog.save_table("hackathon.sales.raw", raw_table(batch))
        try:
            for filt in ("scan", "auto"):
                for on in (False, True):
                    conf = slice13_conf(port, root, dict(
                        model="holt_winters", model_conf={"filter": filt},
                        experiment=f"hw_{filt}_bf16_{on}"))
                    conf["precision"] = {"bf16_scoring": on}
                    sec, summary, _ = prep_task(port, root, conf)
                    assert summary["n_failed"] == 0, summary
                    seconds[f"{filt}_bf16_{on}"] = sec
                    tables[filt, on] = catalog.read_table(FORECASTS).drop(
                        columns=["training_date"])
        finally:
            prec.configure_precision(prec.PrecisionConfig())
    pd.testing.assert_frame_equal(tables["auto", False], tables["auto", True],
                                  check_exact=True)
    a, b = (tables["scan", on]["yhat"].to_numpy().reshape(batch.n_series, -1)
            for on in (False, True))
    out.update(task_seconds=seconds, auto_byte_equal=True,
               scan_series_changed=int((a != b).any(axis=1).sum()))
    emit("bf16_gate", card=card_line, **out)
    return out


def automl_sweep(port, batch, counters, card_line: str) -> dict:
    """(d) ``successive_halving_select`` with ``AutoMLConfig()``'s defaults
    (six families, 3 rungs, eta 2, 64 series at rung 0) on the committed
    dataset, the launch counters set to 0 just before it and read after
    (hw_score must launch); the rung ladder, survivors and seconds; then a
    1e-3 s budget trips the gate; then the train task with
    ``engine.automl.enabled: true`` against the task without it: the
    forecast tables byte-equal (the train task does not call the sweep)."""
    sel, hyper = port["select"], port["hyper"]
    cv = port["engine"].CVConfig(**CV)
    cfg = hyper.AutoMLConfig()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = sel.successive_halving_select(batch, config=cfg, cv=cv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items()}
    assert launched["hw_score"] >= 1, launched
    board = res.leaderboard
    assert not res.budget_exhausted and len(res.survivors) == 1
    rung0 = board[board.rung == 0]
    assert sorted(rung0.family) == sorted(cfg.families)
    assert set(rung0.n_series) == {min(cfg.base_series, batch.n_series)}
    assert set(rung0.n_cutoffs) == {cfg.base_cutoffs}
    assert board.rung.iloc[-1] == "final"
    assert res.selection.assignment.shape == (batch.n_series,)
    tripped = sel.successive_halving_select(
        batch, config=hyper.AutoMLConfig(
            budget_device_seconds=AUTOML_TRIP_BUDGET), cv=cv)
    assert tripped.budget_exhausted and len(tripped.leaderboard) <= len(
        cfg.families)
    assert len(set(tripped.selection.chosen.tolist())) == 1
    tables = []
    with tempfile.TemporaryDirectory() as root:
        catalog, _, _ = _store(port, root)
        catalog.save_table("hackathon.sales.raw", raw_table(batch))
        try:
            for armed in (False, True):
                conf = slice13_conf(port, root, {})
                conf["engine"]["automl"]["enabled"] = armed
                prep_task(port, root, conf)
                assert hyper.automl_config().enabled is armed
                tables.append(catalog.read_table(FORECASTS).drop(
                    columns=["training_date"]))
        finally:
            hyper.configure_automl(hyper.AutoMLConfig())
    pd.testing.assert_frame_equal(tables[0], tables[1], check_exact=True)
    out = dict(
        seconds=wall, spent_device_seconds=res.spent_device_seconds,
        survivors=list(res.survivors), launches=launched,
        leaderboard=board[["family", "rung", "n_series", "n_cutoffs",
                           "mean_smape", "device_seconds"]].to_dict("records"),
        chosen=res.selection.counts(),
        tripped={"budget": AUTOML_TRIP_BUDGET, "rows": len(tripped.leaderboard),
                 "chosen": tripped.selection.counts()},
        task_byte_equal=True)
    emit("automl_sweep", card=card_line, **out)
    return out


def mle_times(port, batch, kernel_cases, fit_cases, card_line: str) -> dict:
    """(e) The gradient kernel alone at the fit and CV shapes (CUDA events,
    median of 5, each sample 5 back-to-back launches bound beforehand)
    beside its bound and serial chain, its twin once; the fit kernel per
    fit at the fit and CV shapes (median of 5) as the main path launches it
    (all its steps), and its per-step time over the first and the last
    MLE_STEP_WINDOW steps of a fit (fits of 20, steps - 20 and steps
    steps); the compared call of the fit kernel (``fit_cases``' fit shape)
    timed again, beside its twin's time; the MLE fit_forecast's wall time
    (median of 3, host clock to a synchronize), its device events, idle
    share and host syncs.  The gradient twin's time is (a)'s fit case's
    (``kernel_cases``), on the same inputs."""
    kal, ar, engine = port["kalman"], port["arima"], port["engine"]
    cfg = ar.ArimaConfig(method="mle")
    steps = cfg.fit_steps
    full = batch.y * batch.mask
    k, fit = {}, {}
    for name, (y, m) in (("fit", (full, batch.mask)),
                         ("cv", cv_inputs(batch, port["cv"]))):
        args = mle_args(port, y, m, 2, 1)
        S, T = (int(d) for d in y.shape)
        bound, by = bound_ms(kal.arima_loglik_grad_work(S, T, 2, 3))
        launch, _ = kal._arima_loglik_grad_launcher(*args)
        ms = cuda_ms(launch, inner=5)
        k[name] = {"shape": [S, T, 2, 3], "ms": ms,
                   **device_ms(launch, inner=5), "bound_ms": bound,
                   "bound_by": by,
                   "serial_chain_ms": T * MLE_CHAIN_CYCLES / CLOCK_HZ * 1e3,
                   "cycles_per_step": ms * 1e-3 * CLOCK_HZ / T}
        if name == "fit":
            fit_args = args
        zc, zmask = args[:2]
        fit_call = (zc, zmask, 2, 1, 2, steps, cfg.learning_rate,
                    cfg.prior_scale)
        launch, _ = kal._mle_fit_launcher(*fit_call)
        ms = cuda_ms(launch)
        bound, by = bound_ms(kal.mle_fit_work(S, T, 2, 2, 1, steps))
        fit[name] = {"shape": [S, T, 2, 1], "steps": steps, "ms": ms,
                     **device_ms(launch, reps=3, inner=1),
                     "bound_ms": bound, "bound_by": by,
                     "serial_chain_ms": (steps * T * MLE_CHAIN_CYCLES
                                         / CLOCK_HZ * 1e3),
                     "cycles_per_step": ms * 1e-3 * CLOCK_HZ / (steps * T)}
        if name == "fit":
            # the first and the last MLE_STEP_WINDOW steps of a fit
            w = {}
            for n in (MLE_STEP_WINDOW, steps - MLE_STEP_WINDOW):
                launch, _ = kal._mle_fit_launcher(
                    *fit_call[:5], n, *fit_call[6:])
                w[n] = cuda_ms(launch)
            fit[name]["step_ms_first"] = w[MLE_STEP_WINDOW] / MLE_STEP_WINDOW
            fit[name]["step_ms_last"] = (
                (ms - w[steps - MLE_STEP_WINDOW]) / MLE_STEP_WINDOW)
    # the twin's time on these inputs: (a)'s fit case ran it on the same
    # mle_args (same data, same seed), CUDA events
    twin = kernel_cases["fit_211"]["twin_ms"]
    fit_forecast = lambda: engine.fit_forecast(  # noqa: E731
        batch, "arima", config=cfg, horizon=90)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_forecast()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = idle_share(fit_forecast, top_n=8)
    prof["kernel_ms"] = {name: {"count": len(v), "min": min(v),
                                "median": statistics.median(v), "max": max(v)}
                         for name, v in prof.get("kernel_ms", {}).items() if v}
    # one trace with no margins and no second attempt: what a bare trace
    # keeps this late in the process
    bare = idle_share(fit_forecast, margins=(0.0, 0.0), attempts=1)
    bare.pop("kernel_ms", None)
    # the compared call (the fit shape, MLE_FIT_STEPS_COMPARED steps):
    # kernel and twin
    row = fit_cases["fit_211"]
    launch, _ = kal._mle_fit_launcher(*fit_args[:2], 2, 1, 2, row["steps"],
                                      cfg.learning_rate, cfg.prior_scale)
    t = {"kernel": k, "fit_kernel": fit, "twin_ms": twin,
         "compared": {"steps": row["steps"], "ms": cuda_ms(launch),
                      "plain_ms": row["twin_ms"]},
         "fit_forecast_wall_s": statistics.median(walls),
         "fit_forecast_walls_s": walls, "fit_forecast_profile": prof,
         "fit_forecast_profile_bare": bare,
         "fit_forecast_host_syncs": count_syncs(fit_forecast)}
    emit("arima_mle_times", card=card_line, reps=REPS, statistic="median",
         **t)
    return t


def slice14_phase(port, card_line: str) -> dict:
    """Phase 15: P8's end on the committed dataset — arima ``method: mle``
    on the likelihood-gradient kernel (its cases, the main path with every
    launch counter set to 0 just before it and read just after, checks, 20
    series against the CPU, HR beside MLE, the train task through deploy
    and inference, ``model: auto`` with an MLE arima), the bf16 scoring
    gate, and the successive-halving sweep."""
    t_phase = time.perf_counter()
    fs, kal = port["fs"], port["kalman"]
    counters = {"hw_score": fs.hw_score, "hw_filter": fs.hw_filter,
                "arima_filter": kal.arima_filter,
                "arima_predict": kal.arima_predict,
                "arima_loglik_grad": kal.arima_loglik_grad,
                "arima_mle_fit": kal.arima_mle_fit}
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA))
    assert (batch.n_series, batch.n_time) == SHAPE
    out = {"cases": mle_kernel_cases(batch, port),
           "fit_cases": mle_fit_cases(batch, port)}
    for fn in counters.values():  # counters to 0 just before the main path
        fn.launches = 0
    run = mle_main_path(port, batch)
    launched = {k: fn.launches for k, fn in counters.items()}  # ... and after
    emit("launches", path="arima_mle", **launched,
         expected="arima_mle_fit: 1 per fit (all its Adam steps), 2 for "
                  "fit_forecast + CV pass; arima_loglik_grad 0; "
                  "arima_filter 2, arima_predict 2")
    assert launched["arima_mle_fit"] == 2, launched
    assert launched["arima_loglik_grad"] == 0, launched
    for k in ("arima_filter", "arima_predict"):
        if launched[k] < 1:
            raise AssertionError(f"the MLE path never launched {k}")
    out["launches"] = dict(launched)
    out["outputs"] = check_mle_outputs(run, batch)
    emit("arima_mle_main", card=card_line, fit_seconds=run["fit_seconds"],
         cv_seconds=run["cv_seconds"])
    out["gpu_vs_cpu"] = mle_vs_cpu(port, batch)
    out["hr_vs_mle"] = hr_vs_mle(port, batch, run["params"])
    out["tasks"] = mle_tasks(port, batch, counters, card_line)
    for k, n in out["tasks"]["launches"].items():
        out["launches"][k] += n
    out["bf16"] = bf16_gate(port, batch, card_line)
    out["automl"] = automl_sweep(port, batch, counters, card_line)
    out["times"] = mle_times(port, batch, out["cases"], out["fit_cases"],
                             card_line)
    out["seconds"] = time.perf_counter() - t_phase
    emit("phase15", seconds=out["seconds"])
    return out


# -- phase 16: streaming ingest (serving/ingest.py, engine/state_store.py,
# serving/refit.py, ops/update.py, the serve task's serving.ingest block)

STREAM_FAMILIES = ("holt_winters", "theta", "croston")
STREAM_SEED = 17
STREAM_DAILY = 60         # days posted one a request, every series each
STREAM_BURST = 30         # then one request of 30 days
STREAM_AROUND_REFIT = 10  # then 10 days, a forced refit snapshotting after 5
STREAM_CHECKED = 17       # series each /invocations check asks for
STREAM_HORIZON = 28
STREAM_BUCKET = 32        # serving.ingest.time_bucket as shipped
STREAM_PINNED_K = (1, 7, 40)
STREAM_VS_CPU = 20        # series streamed on the card and on the CPU
STREAM_TOL = 1e-5         # card vs CPU, of each row's scale
STREAM_BIG = (40, 512)    # 20,480 series, as phase 11 builds them
STREAM_LATENCY = 20       # sequential 500-series /invocations, each leg
STREAM_APPLY_REPS = 5
# runs of each workflow of phases 8-9 for the per-task medians, and samples
# of each monitor scan (host work: each run costs seconds); 2 keeps the
# drift scan (it runs from a store's second run on)
WORKFLOW_RUNS = 2
# no refit fires by itself during the run (the phase forces one), and the
# 30-day burst (15,000 points) fits in one request
STREAM_CONF = {"serving.ingest.enabled": True,
               "serving.ingest.apply_mode": "sync",
               "serving.ingest.max_points_per_request": 15000,
               "serving.ingest.refit.enabled": True,
               "serving.ingest.refit.max_applied_points": 10 ** 9,
               "serving.ingest.refit.max_staleness_s": 1e9}


def stream_tail(batch, days: int, seed: int = STREAM_SEED) -> np.ndarray:
    """(S, days) held-out daily values after the grid: each series' value
    52 weeks earlier (same weekday) times lognormal noise from ``seed``,
    rounded as sales are."""
    rng = np.random.default_rng(seed)
    y = batch.y.cpu().numpy()
    T = y.shape[1]
    base = np.concatenate([y, np.zeros((y.shape[0], days), np.float32)], 1)
    for j in range(days):
        base[:, T + j] = np.round(base[:, T + j - 364]
                                  * rng.lognormal(0.0, 0.1, y.shape[0]))
    return base[:, T:].astype(np.float32)


def day_points(fc, first_day: int, vals: np.ndarray) -> list:
    """``/ingest`` records for days ``first_day ..`` of ``vals`` (S, k),
    every series (the compact ``k`` / ``d`` form the WAL writes)."""
    keys = fc.keys.tolist()
    return [{"k": [int(v) for v in keys[s]], "d": first_day + j,
             "y": float(vals[s, j])}
            for j in range(vals.shape[1]) for s in range(vals.shape[0])]


def store_points(first_day: int, vals: np.ndarray) -> list:
    return [(s, first_day + j, float(vals[s, j]))
            for j in range(vals.shape[1]) for s in range(vals.shape[0])]


def stream_artifacts(port, root: str, batch,
                     families: tuple = STREAM_FAMILIES) -> dict:
    """Fit each family on the committed dataset (Holt-Winters on its
    96-candidate grid: hw_score, then hw_filter), save the artifact with
    its ``history.npz`` sidecar (the training y / mask, as whoever
    registers a streamed model writes it) and register it in Staging."""
    registry = port["tracking"].ModelRegistry(os.path.join(root, "registry"))
    out = {}
    for model in families:
        fns = port["models"].get_model(model)
        cfg = fns.config_cls()
        t0 = time.perf_counter()
        params = fns.fit(batch.y, batch.mask, batch.day, cfg)
        fit_s = time.perf_counter() - t0
        art = os.path.join(root, "artifacts", model)
        port["serving"].BatchForecaster.from_fit(
            batch, params, model, cfg).save(art)
        np.savez(os.path.join(art, "history.npz"), y=batch.y.cpu().numpy(),
                 mask=batch.mask.cpu().numpy())
        name = f"Stream_{model}"
        version = registry.register_model(name, art)
        registry.transition_stage(name, version.version, "Staging")
        out[model] = {"name": name, "artifact": art, "fit_seconds": fit_s}
    return out


def stream_serve_conf(port, root: str, model: str, name: str) -> tuple:
    """The shipped serve conf with ``serving.ingest`` on (:data:`STREAM_CONF`),
    the family's model, its own WAL and quality-store directories."""
    conf = port["config"].load_conf(SERVE_CONF)
    conf["env"] = {"root": root}
    conf["serving"].update(model_name=name, host="127.0.0.1", port=0)
    changed = {**STREAM_CONF,
               "serving.ingest.wal_dir": os.path.join(root, f"wal_{model}"),
               "monitoring.quality_store.directory":
                   os.path.join(root, f"quality_{model}")}
    for key, value in changed.items():
        *path, last = key.split(".")
        node = conf
        for k in path:
            node = node[k]
        assert last in node, key  # only keys the shipped conf has
        node[last] = value
    changed.update({"env.root": root, "serving.model_name": name,
                    "serving.host": "127.0.0.1", "serving.port": 0})
    return conf, changed


def _post_ms(number: int, path: str, payload) -> tuple:
    t0 = time.perf_counter()
    status, body, _ = http_call(number, "POST", path, payload)
    return status, json.loads(body), (time.perf_counter() - t0) * 1e3


def _invocations(number: int, fc, idx) -> bytes:
    req = {"inputs": _inputs(fc.keys[idx], fc.key_names),
           "horizon": STREAM_HORIZON}
    status, body, _ = http_call(number, "POST", "/invocations", req)
    assert status == 200, body[:300]
    return body


def stream_served(port, root: str, model: str, art: dict, batch, tail,
                  counters) -> dict:
    """(a) One family behind the serve task: /ingest day by day, a burst,
    then a forced refit in the middle of 10 more days.  A mirror (the same
    artifact loaded again, its own state store fed the same points) says
    what /invocations must answer after every apply; the refit's install
    is recomputed as fit-then-update."""
    serving, server = port["serving"], port["server"]
    conf, changed = stream_serve_conf(port, root, model, art["name"])
    task = port["serve_task"].ServeTask(init_conf=conf, device=DEVICE)
    kw = task.server_args()
    ingest = kw["ingest"]
    assert ingest is not None and ingest.refit is not None
    assert ingest.store.can_refit and kw["forecaster"].time_bucket == \
        STREAM_BUCKET
    srv = server.start_server(**kw)
    number = srv.server_address[1]
    fc = srv.forecaster
    mirror_fc = serving.BatchForecaster.load(art["artifact"], device=DEVICE)
    mirror = port["state_store"].SeriesStateStore(
        mirror_fc, time_bucket=STREAM_BUCKET, history_y=batch.y.cpu().numpy(),
        history_mask=batch.mask.cpu().numpy(), device=DEVICE)
    S = fc.n_series
    idx = np.linspace(0, S - 1, min(STREAM_CHECKED, S)).astype(int)
    req = pd.DataFrame(fc.keys[idx], columns=list(fc.key_names))
    encode = server._encode_predictions
    day1 = int(fc.day1)
    post_ms, checked, posted = [], 0, 0

    def post_and_check(first: int, vals) -> dict:
        nonlocal checked, posted
        pts = day_points(fc, first, vals)
        status, ack, ms = _post_ms(number, "/ingest", {"points": pts})
        assert status == 200, ack
        assert ack["written"] == len(pts), ack
        assert ack["applied"]["days"] == first + vals.shape[1] - 1 - \
            mirror.day_cur, ack
        posted += len(pts)
        mirror.ingest(store_points(first, vals))
        mirror.apply_pending()
        assert int(fc.day1) == mirror.day_cur
        got = _invocations(number, fc, idx)
        want = encode(mirror_fc.predict(req, horizon=STREAM_HORIZON),
                      fc.key_names)
        assert got == want, "/invocations does not reflect the apply"
        checked += 1
        return {"ms": ms, "ack": ack}

    try:
        j = 0
        for _ in range(STREAM_DAILY):
            post_ms.append(post_and_check(day1 + 1 + j, tail[:, j:j + 1])["ms"])
            j += 1
        burst = post_and_check(day1 + 1 + j, tail[:, j:j + STREAM_BURST])
        j += STREAM_BURST
        half = STREAM_AROUND_REFIT // 2
        for _ in range(half):
            post_and_check(day1 + 1 + j, tail[:, j:j + 1])
            j += 1
        # the forced refit: its snapshot is taken, then 5 more days apply
        # (checked against the mirror: the refit has not installed), then
        # the fit runs and the install replays them
        store, sched = ingest.store, ingest.refit
        stages = store.refit_stages
        snapped, go = threading.Event(), threading.Event()

        def gated():
            prep, dispatch, complete = stages()

            def prep_then_wait():
                out = prep()
                snapped.set()
                go.wait(600)
                return out
            return prep_then_wait, dispatch, complete

        store.refit_stages = gated
        for fn in counters.values():  # counters to 0 around the refit
            fn.launches = 0
        result, errors = {}, []

        def refit():
            try:
                t0 = time.perf_counter()
                result["trigger"] = sched.maybe_refit(force=True)
                result["done"] = sched.wait(timeout=600)
                result["seconds"] = time.perf_counter() - t0
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)

        th = threading.Thread(target=refit)
        th.start()
        assert snapped.wait(600), "the refit never took its snapshot"
        day_snap = store.day_cur
        for _ in range(STREAM_AROUND_REFIT - half):
            post_and_check(day1 + 1 + j, tail[:, j:j + 1])
            j += 1
        go.set()
        th.join(600)
        store.refit_stages = stages
        if errors:
            raise errors[0]
        refit_launches = {k: fn.launches for k, fn in counters.items()}
        if model == "holt_winters":
            assert refit_launches == {"hw_score": 1, "hw_filter": 1}, \
                refit_launches
        else:
            assert refit_launches == {"hw_score": 0, "hw_filter": 0}
        assert result["trigger"] == "forced"
        assert result["done"]["day_snap"] == day_snap
        replay = check_refit_install(port, store, model, day_snap)
        text = http_call(number, "GET", "/metrics")[1].decode()
        metrics = {k: _counter(text, k) for k in (
            "dftpu_ingest_points_total", "dftpu_ingest_applied_points_total",
            "dftpu_ingest_wal_appends_total", "dftpu_ingest_refits_total",
            "dftpu_ingest_applied_day", "dftpu_ingest_late_points_total",
            "dftpu_ingest_unknown_series_total")}
        n_posts = STREAM_DAILY + 1 + STREAM_AROUND_REFIT
        assert metrics == {
            "dftpu_ingest_points_total": posted,
            "dftpu_ingest_applied_points_total": posted,
            "dftpu_ingest_wal_appends_total": n_posts,
            "dftpu_ingest_refits_total": 1,
            "dftpu_ingest_applied_day": day1 + j,
            "dftpu_ingest_late_points_total": 0,
            "dftpu_ingest_unknown_series_total": 0}, metrics
        after = json.loads(_invocations(number, fc, idx))["predictions"]
        first = pd.Timestamp(after[0]["ds"])
        assert first == pd.Timestamp("1970-01-01") + pd.Timedelta(
            days=day1 + j + 1)
        assert all(np.isfinite(r["yhat"]) for r in after)
    finally:
        srv.shutdown()
    out = {"changed": changed, "posts": n_posts, "points": posted,
           "invocations_checked_bytes_equal": checked,
           "post_ms": _pcts(post_ms), "burst_post_ms": burst["ms"],
           "burst_ack": burst["ack"], "refit": {
               "launches": refit_launches, "day_snap": day_snap,
               "replayed_days": replay["replayed_days"],
               "install_equals_fit_then_update": replay["bitwise"],
               "seconds_incl_gate": result["seconds"]},
           "metrics": metrics, "fit_seconds": art["fit_seconds"]}
    emit("stream_served", model=model, **{k: v for k, v in out.items()
                                          if k != "changed"})
    return out


def check_refit_install(port, store, model: str, day_snap: int) -> dict:
    """The refit's install, recomputed: the family's fit of the history up
    to the snapshot, then the update of the days applied after it.  Every
    field equals the installed one bit for bit."""
    fns = port["models"].get_model(model)
    t_snap = day_snap - store.day0 + 1
    t_now = store.day_cur - store.day0 + 1
    dev = store.device
    y = torch.as_tensor(store._y[:, :t_now], device=dev)
    m = torch.as_tensor(store._mask[:, :t_now], device=dev)
    day = torch.arange(store.day0, day_snap + 1, dtype=torch.int32,
                       device=dev)
    p0 = fns.fit(y[:, :t_snap], m[:, :t_snap], day, store.config)
    aux = fns.init_update_aux(p0, y=y[:, :t_snap], mask=m[:, :t_snap])
    delta = t_now - t_snap
    p1, _, preds = fns.update_state(
        p0, aux, y[:, t_snap:], m[:, t_snap:], np.ones(delta),
        np.arange(day_snap + 1, day_snap + 1 + delta), store.config,
        day0=store.day0)
    got = store._params
    same = {}
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(p1, f.name)
        if f.name == "fitted":
            b = torch.cat([p0.fitted, preds], 1)
            a = a[:, :t_now]
        same[f.name] = bool(torch.equal(a, b))
    assert all(same.values()), same
    return {"replayed_days": delta, "bitwise": same}


def stream_exactness(port, batch, arts: dict, tail) -> dict:
    """(b) The exactness contract on the card, bit for bit."""
    hw, update = port["hw"], port["update"]
    serving, state_store = port["serving"], port["state_store"]
    y, mask, day = batch.y, batch.mask, batch.day
    T = batch.n_time
    out = {"hw_stream_equals_hw_filter_fit": {}}
    # Holt-Winters, one pinned candidate: the streamed days are the
    # dataset's own last days, the reference fit the kernel's on them
    cfg = hw.HoltWintersConfig(n_alpha=1, n_beta=1, n_gamma=1)
    T0 = T - max(STREAM_PINNED_K)
    p0 = hw.fit(y[:, :T0], mask[:, :T0], day[:T0], cfg)
    aux0 = hw.init_update_aux(p0, mask=mask[:, :T0])
    for k in STREAM_PINNED_K:
        ref = hw.fit(y[:, :T0 + k], mask[:, :T0 + k], day[:T0 + k], cfg)
        if k < max(STREAM_PINNED_K):
            got, _, preds = update.apply_update(
                "holt_winters", cfg, p0, aux0, y[:, T0:T0 + k],
                mask[:, T0:T0 + k], np.ones(k),
                day[T0:T0 + k].cpu().numpy(), day0=int(day[0]))
            fitted = preds
        else:  # through the store, across a time-bucket boundary
            fc = serving.BatchForecaster(
                "holt_winters", cfg, p0, batch.keys, batch.key_names,
                int(day[0]), int(day[T0 - 1]), freq=batch.freq)
            store = state_store.SeriesStateStore(
                fc, time_bucket=STREAM_BUCKET,
                history_y=y[:, :T0].cpu().numpy(),
                history_mask=mask[:, :T0].cpu().numpy(), device=DEVICE)
            cap0 = int(store._params.fitted.shape[1])
            yn, mn = y[:, T0:].cpu().numpy(), mask[:, T0:].cpu().numpy()
            store.ingest([(s, int(day[T0]) + j, float(yn[s, j]))
                          for j in range(k) for s in range(yn.shape[0])
                          if mn[s, j] > 0])
            assert store.apply_pending()["days"] == k
            got = store._params
            assert got.fitted.shape[1] > cap0 >= T0  # grew one bucket
            fitted = got.fitted[:, T0:T0 + k]
            assert not torch.any(got.fitted[:, T0 + k:])
        eq = {n: bool(torch.equal(getattr(got, n), getattr(ref, n)))
              for n in ("level", "trend", "season")}
        eq["preds"] = bool(torch.equal(fitted, ref.fitted[:, T0:T0 + k]))
        assert all(eq.values()), (k, eq)
        out["hw_stream_equals_hw_filter_fit"][k] = eq
    # each family: k days in one apply equal k applies of one day, and
    # padding columns leave every carry unchanged
    out["chained_equals_single"], out["padding_unchanged"] = {}, {}
    k = STREAM_BURST
    for model in STREAM_FAMILIES:
        stores = []
        for _ in range(2):
            fc = serving.BatchForecaster.load(arts[model]["artifact"],
                                              device=DEVICE)
            stores.append(state_store.SeriesStateStore(
                fc, time_bucket=STREAM_BUCKET, device=DEVICE))
        d1 = stores[0].day_cur
        for j in range(k):
            stores[0].ingest(store_points(d1 + 1 + j, tail[:, j:j + 1]))
            stores[0].apply_pending()
        stores[1].ingest(store_points(d1 + 1, tail[:, :k]))
        stores[1].apply_pending()
        a, b = stores
        eq = all(torch.equal(getattr(a._params, f.name),
                             getattr(b._params, f.name))
                 for f in dataclasses.fields(a._params))
        eq &= all(torch.equal(a._aux[key], b._aux[key]) for key in a._aux)
        assert eq, model
        out["chained_equals_single"][model] = eq
        # padding: 5 real columns alone, and with 3 padding columns
        fns = port["models"].get_model(model)
        p, aux = b._params, b._aux
        vals = torch.as_tensor(tail[:, k:k + 5], device=DEVICE)
        ones = torch.ones_like(vals)
        days = np.arange(b.day_cur + 1, b.day_cur + 6)
        plain = fns.update_state(p, aux, vals, ones, np.ones(5), days,
                                 b.config, day0=b.day0)
        padded = fns.update_state(
            p, aux, torch.nn.functional.pad(vals, (0, 3)),
            torch.nn.functional.pad(ones, (0, 3)),
            np.r_[np.ones(5), np.zeros(3)], np.r_[days, np.zeros(3, int)],
            b.config, day0=b.day0)
        eq = all(torch.equal(getattr(plain[0], f.name),
                             getattr(padded[0], f.name))
                 for f in dataclasses.fields(plain[0]))
        eq &= all(torch.equal(plain[1][key], padded[1][key])
                  for key in plain[1])
        eq &= bool(torch.equal(plain[2], padded[2][:, :5]))
        assert eq, model
        out["padding_unchanged"][model] = eq
    out["followers_converge"] = stream_followers(port, arts, tail)
    emit("stream_exactness", **out)
    return out


def stream_followers(port, arts: dict, tail) -> bool:
    """Two interval-mode runtimes following one WAL directory (their own
    follower threads) converge to the same bits."""
    serving, ingest = port["serving"], port["ingest"]
    root = tempfile.mkdtemp(prefix="stream_wal_")
    try:
        conf = {"enabled": True, "apply_mode": "interval",
                "apply_interval_ms": 20, "wal_dir": root}
        fcs = [serving.BatchForecaster.load(arts["holt_winters"]["artifact"],
                                            device=DEVICE) for _ in range(2)]
        rts = [ingest.build_ingest_runtime(conf, fc, device=DEVICE)
               for fc in fcs]
        for rt in rts:
            rt.start()
        try:
            d1 = int(fcs[0].day1)
            for j in range(10):
                rts[j % 2].submit(day_points(fcs[0], d1 + 1 + j,
                                             tail[:, j:j + 1]))
            deadline = time.perf_counter() + 120
            while (any(int(fc.day1) != d1 + 10 for fc in fcs)
                   and time.perf_counter() < deadline):
                time.sleep(0.02)
        finally:
            for rt in rts:
                rt.stop()
        a, b = (fc._state_snapshot()[0] for fc in fcs)
        same = all(int(fc.day1) == d1 + 10 for fc in fcs) and all(
            torch.equal(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
        assert same, "two followers of one WAL did not converge"
        return same
    finally:
        shutil.rmtree(root, ignore_errors=True)


def stream_vs_cpu(port, batch, arts: dict, tail) -> dict:
    """(c) 20 series through the same stream on the card and on the CPU,
    from the card's fit: the states within 1e-5 of each row's scale, the
    routing counts equal."""
    serving, state_store, convert = (port["serving"], port["state_store"],
                                     port["convert"])
    n = STREAM_VS_CPU
    idx = np.arange(n)
    scale = np.maximum(np.abs(batch.y[:n].cpu().numpy()).max(1), 1.0)
    out = {}
    for model in STREAM_FAMILIES:
        full = serving.BatchForecaster.load(arts[model]["artifact"],
                                            device=DEVICE)
        params = full.gather_params(idx)
        stores, routed = {}, {}
        for dev in (DEVICE, "cpu"):
            p = convert.params_from_numpy(
                type(params), convert.params_to_numpy(params), dev)
            fc = serving.BatchForecaster(model, full.config, p, full.keys[:n],
                                         full.key_names, full.day0, full.day1,
                                         freq=full.freq)
            st = state_store.SeriesStateStore(
                fc, time_bucket=STREAM_BUCKET,
                history_y=batch.y[:n].cpu().numpy(),
                history_mask=batch.mask[:n].cpu().numpy(), device=dev)
            d1 = st.day_cur
            counts = []
            for j in range(STREAM_DAILY):
                counts.append(st.ingest(store_points(d1 + 1 + j,
                                                     tail[:n, j:j + 1])))
                st.apply_pending()
            j = STREAM_DAILY
            # a late point, one before the grid, one past the horizon
            extra = [(0, d1 - 3, 5.0), (1, st.day0 - 1, 5.0),
                     (2, st.day_cur + 10 ** 4, 5.0)]
            counts.append(st.ingest(
                store_points(d1 + 1 + j, tail[:n, j:j + STREAM_BURST])
                + extra))
            st.apply_pending()
            stores[dev], routed[dev] = st, counts
        assert routed[DEVICE] == routed["cpu"], model
        a, b = stores[DEVICE]._params, stores["cpu"]._params
        worst = 0.0
        for f in dataclasses.fields(a):
            ga, gb = getattr(a, f.name).cpu(), getattr(b, f.name)
            if ga.dim() == 0:
                continue
            rows = torch.as_tensor(scale).reshape((-1,) + (1,) * (ga.dim() - 1))
            worst = max(worst, float(((ga - gb).abs() / rows).max()))
        assert worst <= STREAM_TOL, (model, worst)
        out[model] = {"max_rel_diff": worst, "tol": STREAM_TOL,
                      "routed_equal": True, "last_routed": routed["cpu"][-1]}
    emit("stream_gpu_vs_cpu_20_series", **out)
    return out


def _apply_timed(store, points) -> dict:
    """One apply of ``points``: the host wall (ending in a synchronize) and
    the device time between two CUDA events around it."""
    store.ingest(points)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    applied = store.apply_pending()
    stop.record()
    torch.cuda.synchronize()
    return {"wall_ms": (time.perf_counter() - t0) * 1e3,
            "events_ms": start.elapsed_time(stop), "days": applied["days"]}


def stream_apply_times(port, batch, arts: dict, tail) -> dict:
    """(d) ``apply_pending`` at K 1 and at the 30-day burst, each family:
    medians of :data:`STREAM_APPLY_REPS`, the device's idle share over one
    K 1 apply, the update's launches."""
    serving, state_store = port["serving"], port["state_store"]
    out = {}
    for model in STREAM_FAMILIES:
        fc = serving.BatchForecaster.load(arts[model]["artifact"],
                                          device=DEVICE)
        st = state_store.SeriesStateStore(fc, time_bucket=STREAM_BUCKET,
                                          device=DEVICE)
        j, k1, burst = 0, [], []
        for _ in range(STREAM_APPLY_REPS):
            k1.append(_apply_timed(st, store_points(st.day_cur + 1,
                                                    tail[:, j:j + 1])))
            j += 1
        st.ingest(store_points(st.day_cur + 1, tail[:, j:j + 1]))
        trace = idle_share(st.apply_pending, attempts=1)
        j += 1
        for _ in range(3):
            burst.append(_apply_timed(st, store_points(
                st.day_cur + 1, tail[:, j:j + STREAM_BURST])))
            j += STREAM_BURST
        out[model] = {
            "k1_wall_ms": statistics.median(r["wall_ms"] for r in k1),
            "k1_events_ms": statistics.median(r["events_ms"] for r in k1),
            "k1_idle_share": trace.get("idle_share"),
            "k1_device_events": trace.get("device_events"),
            "burst_wall_ms": statistics.median(r["wall_ms"] for r in burst),
            "burst_events_ms": statistics.median(r["events_ms"]
                                                 for r in burst),
            "burst_days": STREAM_BURST}
    return out


def stream_refit_times(port, batch, arts: dict, tail, card_line) -> dict:
    """(d) The refit's wall time, its two kernels at the refit's shapes,
    and /invocations for all 500 series idle against during refits."""
    serving, ingest, server, fs = (port["serving"], port["ingest"],
                                   port["server"], port["fs"])
    fc = serving.BatchForecaster.load(arts["holt_winters"]["artifact"],
                                      device=DEVICE)
    root = tempfile.mkdtemp(prefix="stream_refit_")
    rt = ingest.build_ingest_runtime(
        {"enabled": True, "wal_dir": root, "apply_mode": "sync",
         "max_points_per_request": 15000,
         "refit": {"enabled": True, "max_applied_points": 10 ** 9,
                   "max_staleness_s": 1e9, "check_interval_s": 3600}},
        fc, history_y=batch.y.cpu().numpy(),
        history_mask=batch.mask.cpu().numpy(), device=DEVICE)
    rt.submit(day_points(fc, int(fc.day1) + 1, tail[:, :STREAM_BURST]))
    sched = rt.refit
    out = {}
    try:
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            sched.maybe_refit(force=True)
            sched.wait(600)
            walls.append(time.perf_counter() - t0)
        out["refit_wall_s"] = statistics.median(walls)
        trace = idle_share(lambda: (sched.maybe_refit(force=True),
                                    sched.wait(600)), attempts=1)
        out["refit_idle_share"] = trace.get("idle_share")
        out["refit_kernel_ms_traced"] = trace.get("kernel_ms")
        # the kernels alone at the refit's shapes
        st = rt.store
        t_now = st.day_cur - st.day0 + 1
        y = torch.as_tensor(st._y[:, :t_now], device=DEVICE)
        m = torch.as_tensor(st._mask[:, :t_now], device=DEVICE)
        A, B, G, P = port["hw"]._candidate_grid(fc.config, device=DEVICE)
        # (the wrappers: the initial state's plain ops, then the kernel)
        out["hw_score_wrapper_ms"] = cuda_ms(
            lambda: fs.hw_score(y, m, A, B, G, P, 7))
        p = st._params
        out["hw_filter_wrapper_ms"] = cuda_ms(lambda: fs.hw_filter(
            y, m, p.alpha, p.beta, p.gamma, p.phi, 7, "additive"))
        out["shape"] = [int(y.shape[0]), t_now, int(A.shape[0])]
        srv = server.start_server(fc, ingest=rt)
        number = srv.server_address[1]
        body = {"inputs": _inputs(fc.keys, fc.key_names),
                "horizon": STREAM_HORIZON}
        try:
            http_call(number, "POST", "/invocations", body)  # warm
            idle = [_post_ms(number, "/invocations", body)[2]
                    for _ in range(STREAM_LATENCY)]
            stop, refits = threading.Event(), []

            def churn():
                while not stop.is_set():
                    sched.maybe_refit(force=True)
                    sched.wait(600)
                    refits.append(1)

            th = threading.Thread(target=churn)
            th.start()
            busy = [_post_ms(number, "/invocations", body)[2]
                    for _ in range(STREAM_LATENCY)]
            stop.set()
            th.join(600)
        finally:
            srv.shutdown()
        out["invocations_500_idle"] = _pcts(idle)
        out["invocations_500_during_refits"] = _pcts(busy)
        out["refits_during"] = len(refits)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def stream_big(port, card_line) -> dict:
    """(d) The apply at 20,480 series (built as phase 11 builds them;
    Holt-Winters on its default grid), at K 1 and at a time-bucket
    crossing (the host history grows one bucket: a copy of both (S, T)
    buffers), with the peak device memory of each."""
    data, serving, state_store = (port["data"], port["serving"],
                                  port["state_store"])
    batch = data.synthetic_series_batch(n_stores=STREAM_BIG[0],
                                        n_items=STREAM_BIG[1], seed=3,
                                        device=DEVICE)
    fns = port["models"].get_model("holt_winters")
    cfg = fns.config_cls()
    t0 = time.perf_counter()
    params = fns.fit(batch.y, batch.mask, batch.day, cfg)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fc = serving.BatchForecaster.from_fit(batch, params, "holt_winters", cfg)
    st = state_store.SeriesStateStore(
        fc, time_bucket=STREAM_BUCKET, history_y=batch.y.cpu().numpy(),
        history_mask=batch.mask.cpu().numpy(), device=DEVICE)
    tail = stream_tail(batch, STREAM_BURST + 1)
    cap0 = st._y.shape[1]
    t_len = st.day_cur - st.day0 + 1
    out = {"shape": [batch.n_series, batch.n_time], "fit_seconds": fit_s}
    res = {}
    ms, mib = peak_mib(lambda: res.update(
        _apply_timed(st, store_points(st.day_cur + 1, tail[:, :1]))))
    out["k1"] = {**res, "peak_mib": mib}
    k = cap0 - t_len  # the rest of the bucket, then one column past it
    res = {}
    ms, mib = peak_mib(lambda: res.update(_apply_timed(
        st, store_points(st.day_cur + 1, tail[:, 1:1 + k]))))
    assert st._y.shape[1] > cap0, "no bucket crossed"
    out["bucket_crossing"] = {**res, "peak_mib": mib,
                              "history_cap": [cap0, int(st._y.shape[1])]}
    emit("stream_big", card=card_line, **out)
    return out


def slice15_phase(port, card_line: str) -> dict:
    """Phase 16: streaming ingest on the committed dataset.  (a) The serve
    task with ``serving.ingest`` on for Holt-Winters, theta and croston
    artifacts: /ingest day by day, a 30-day burst, a forced refit with its
    replay; (b) the exactness contract bit for bit; (c) 20 series card vs
    CPU; (d) times."""
    t_phase = time.perf_counter()
    fs = port["fs"]
    counters = {"hw_score": fs.hw_score, "hw_filter": fs.hw_filter}
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA),
                                   device=DEVICE)
    assert (batch.n_series, batch.n_time) == SHAPE
    tail = stream_tail(batch, STREAM_DAILY + STREAM_BURST
                       + STREAM_AROUND_REFIT)
    root = tempfile.mkdtemp(prefix="stream_")
    out = {"launches": {k: 0 for k in counters}}
    try:
        for fn in counters.values():  # counters to 0 just before the path
            fn.launches = 0
        arts = stream_artifacts(port, root, batch)
        fit_launches = {k: fn.launches for k, fn in counters.items()}
        assert fit_launches == {"hw_score": 1, "hw_filter": 1}, fit_launches
        served = {model: stream_served(port, root, model, arts[model], batch,
                                       tail, counters)
                  for model in STREAM_FAMILIES}
        for k in counters:
            out["launches"][k] = fit_launches[k] + sum(
                s["refit"]["launches"][k] for s in served.values())
        emit("launches", path="streaming", **out["launches"],
             expected="hw_score, hw_filter: 1 for the Holt-Winters fit, "
                      "1 for its forced refit; 0 for the update")
        out["served"] = served
        out["exactness"] = stream_exactness(port, batch, arts, tail)
        out["gpu_vs_cpu"] = stream_vs_cpu(port, batch, arts, tail)
        applies = stream_apply_times(port, batch, arts, tail)
        refits = stream_refit_times(port, batch, arts, tail, card_line)
        big = stream_big(port, card_line)
        out["times"] = {"post_ingest_500": {m: served[m]["post_ms"]
                                            for m in STREAM_FAMILIES},
                        "apply": applies, "refit": refits, "big": big}
        emit("stream_times", card=card_line,
             **{k: v for k, v in out["times"].items() if k != "big"})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("phase16", seconds=out["seconds"])
    return out


# -- phase 17: windowed (DARIMA) arima fitting --------------------------------

WIN_SHAPE = (500, 100_000)  # windowed against sequential, and streaming
WIN_ULTRA = 1_000_000       # the reference's ultra-long case, one series
WIN_VS_CPU = (20, 40_000)   # card against CPU
WIN_TASK = (2, 10, 40_000)  # the train task's stores, items and days
WIN_HORIZON = 28            # the reference's windowed tests' horizon
WIN_SEED = 23
WIN_NEW_DAYS = 3            # days ingested before the warm refit
# tests/unit/test_windowed.py: the windowed horizon within 10% of the
# sequential one's RMS level (max-abs gap), docs/windowed.md's contract
PARITY_REL_TOL = 0.10
WIN_KERNELS = ("arima_filter", "arima_predict")


def windowed_block(port) -> dict:
    """conf/tasks/train_config.yml's ``engine.windowed`` block, armed."""
    block = port["config"].load_conf(TRAIN_CONF)["engine"]["windowed"]
    return {**block, "enabled": True}


def ar2_batch(port, S: int, T: int, seed: int):
    """(S, T) AR(2) + level series, phi (0.55, 0.20) around 10, the
    recursion of the reference's ``_ar2_batch`` (tests/unit/test_windowed.py)
    over every row at once (scipy's ``lfilter``); day ordinals 0..T-1."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, 1.0, (S, T))
    eps[:, :2] = 0.0  # y_0 = y_1 = 0, as the reference's loop leaves them
    y = lfilter([1.0], [1.0, -0.55, -0.20], eps, axis=1) + 10.0
    return port["data"].SeriesBatch(
        y=torch.tensor(y, dtype=torch.float32, device=DEVICE),
        mask=torch.ones((S, T), device=DEVICE),
        day=torch.arange(T, dtype=torch.int32, device=DEVICE),
        keys=np.arange(S)[:, None], key_names=("series",),
        start_date="1970-01-01")


def _counted(counters, fn):
    """``fn()`` with the counters set to 0 just before it and read just
    after: (its result, the launches)."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def windowed_stages(port, batch, cfg, wcfg) -> dict:
    """The windowed fit's stages on ``batch``, each a callable: the gather
    of the (S*K, W) window batch, the window statistics, the combine and the
    finalize, with the inputs the next stage takes."""
    win, comb_mod = port["windowed"], port["combine"]
    W = wcfg.window_len
    starts = win.plan_windows(batch.n_time, W, wcfg.overlap)
    t0 = starts[-1]
    yw, mw = win._gather_windows(batch.y, batch.mask, starts, W)
    stats = port["arima"].window_stats(yw, mw, cfg)
    comb = comb_mod.combine_estimates("arima", stats, len(starts))
    tail = (batch.y[:, t0:t0 + W], batch.mask[:, t0:t0 + W],
            batch.day[t0:t0 + W])
    return dict(
        starts=starts, yw=yw, stats=stats, comb=comb, tail=tail,
        gather=lambda: win._gather_windows(batch.y, batch.mask, starts, W),
        window_stats=lambda: port["arima"].window_stats(yw, mw, cfg),
        combine=lambda: comb_mod.combine_estimates("arima", stats,
                                                   len(starts)),
        finalize=lambda: win._finalize("arima", cfg, *tail, comb["coef"],
                                       comb["mean"], WIN_HORIZON,
                                       win.DEFAULT_MIN_POINTS))


def windowed_vs_sequential(port, block, counters, card_line: str) -> dict:
    """(a) fit_forecast(model="arima") at WIN_SHAPE with the shipped block
    armed (the counters around the first call: one launch of each arima
    kernel), the route checked, then the sequential whole-series fit with
    the block disarmed; both walls (CUDA events, median of 5), idle shares,
    peak memory, the windowed stages apart beside their bounds, and the
    reference's horizon parity between the two forecasts."""
    engine, win, ar = port["engine"], port["windowed"], port["arima"]
    S, T = WIN_SHAPE
    batch = ar2_batch(port, S, T, WIN_SEED)
    cfg = ar.ArimaConfig()
    wcfg = win.configure_windowed(block)
    fit = lambda: engine.fit_forecast(  # noqa: E731
        batch, "arima", config=cfg, horizon=WIN_HORIZON)
    (params, res), launched = _counted(counters, fit)
    assert launched == {"arima_filter": 1, "arima_predict": 1}, launched
    W, H = wcfg.window_len, WIN_HORIZON
    assert res.day_all.shape[0] == W + H, "the windowed route was not taken"
    assert bool(res.ok.all()) and bool(torch.isfinite(res.yhat).all())
    st = windowed_stages(port, batch, cfg, wcfg)
    SK = int(st["yw"].shape[0])
    ar_lags, ma_lags, p_eff, q_eff = ar._lag_sets(cfg)
    stats_bound, stats_by = bound_ms(ar.hr_work(
        SK, W, max(cfg.hr_ar_order, p_eff + q_eff + cfg.m),
        len(ar_lags) + len(ma_lags)))
    out = {"shape": [S, T], "windows": len(st["starts"]), "rows": SK,
           "windowed": {"ms": cuda_ms(fit), "profile": idle_share(fit),
                        "peak_mib": peak_mib(fit)[1],
                        "stages_ms": {k: cuda_ms(st[k]) for k in (
                            "gather", "window_stats", "combine",
                            "finalize")},
                        "window_stats_bound_ms": stats_bound,
                        "window_stats_bound_by": stats_by,
                        "windows_read_once_ms": 2 * 4 * SK * W / HBM_BPS
                        * 1e3}}
    win.configure_windowed(win.WindowedConfig())  # disarmed: sequential
    seq = lambda: engine.fit_forecast(  # noqa: E731
        batch, "arima", config=cfg, horizon=H)
    (_, seq_res), seq_launched = _counted(counters, seq)
    assert seq_launched == launched, seq_launched
    assert seq_res.day_all.shape[0] == T + H and bool(seq_res.ok.all())
    assert int(seq_res.day_all[-1]) == int(res.day_all[-1])
    out["sequential"] = {"ms": cuda_ms(seq), "profile": idle_share(seq),
                         "peak_mib": peak_mib(seq)[1]}
    seq_h = seq_res.yhat[:, -H:].double()
    win_h = res.yhat[:, -H:].double()
    rel = float((seq_h - win_h).abs().max() / seq_h.pow(2).mean().sqrt())
    assert rel < PARITY_REL_TOL, rel
    out["horizon_parity"] = {"rel": rel, "limit": PARITY_REL_TOL}
    out["sequential_over_windowed"] = (out["sequential"]["ms"]
                                       / out["windowed"]["ms"])
    out["launches"] = {k: launched[k] + seq_launched[k] for k in launched}
    emit("windowed_vs_sequential", card=card_line, reps=REPS,
         statistic="median", **out)
    return dict(out, batch=batch, params=params, result=res, stages=st)


def windowed_kernels(port, st, card_line: str) -> dict:
    """(b) arima_filter on the finalize's inputs (the tail window, the
    combined coefficients) and arima_predict at the windowed forecast's
    length, each against its twin bit for bit, then timed (host-paced and
    on the device) beside its bound."""
    ar, kal = port["arima"], port["kalman"]
    cfg = ar.ArimaConfig()
    y_t, m_t, _ = st["tail"]
    mean = st["comb"]["mean"]
    phi, theta = ar.coef_to_poly(st["comb"]["coef"], *ar._lag_sets(cfg))
    z, zm = ar._difference(y_t, m_t, cfg.d)
    r = ar._effective_r(cfg)
    args = (((z - mean[:, None]) * zm).contiguous(), zm.contiguous(),
            y_t.contiguous(), m_t.contiguous(), phi.contiguous(),
            theta.contiguous(), mean.contiguous(), r, cfg.d)
    S, W = (int(n) for n in y_t.shape)
    H = WIN_HORIZON + 1  # the forecast path past a W-long fit grid
    cases = {"arima_filter": {f"windowed_W{W}": arima_filter_case(
                 port, f"windowed_W{W}", args)},
             "arima_predict": {f"windowed_H{H}": arima_predict_case(
                 port, f"windowed_H{H}", args, H)}}
    launch, fout = kal._arima_filter_launcher(*args)
    bound, by = bound_ms(kal.arima_filter_work(S, W, r, cfg.d))
    times = {"arima_filter": {
        "shape": [S, W, r, cfg.d], "ms": cuda_ms(launch, inner=20),
        **device_ms(launch), "bound_ms": bound, "bound_by": by,
        "serial_chain_ms": W * ARIMA_CHAIN_CYCLES / CLOCK_HZ * 1e3}}
    launch()
    sigma2 = fout.ssq / torch.clamp_min(fout.n, 1.0)
    plaunch, _ = kal._arima_predict_launcher(phi, theta, fout.a_T, fout.P_T,
                                             sigma2, r, H)
    bound, by = bound_ms(kal.arima_predict_work(S, H, r))
    times["arima_predict"] = {"shape": [S, H, r],
                              "ms": cuda_ms(plaunch, inner=20),
                              **device_ms(plaunch), "bound_ms": bound,
                              "bound_by": by}
    emit("windowed_kernel_times", card=card_line, reps=REPS,
         statistic="median", **times)
    return {"cases": cases, "times": times}


def windowed_ultra(port, block, counters, card_line: str) -> dict:
    """(d) The reference's ultra-long case: one series of WIN_ULTRA periods
    through windowed_fit_forecast at the shipped block; ok, finite, the
    tail-anchored grid exact (int32 ordinals), its wall time."""
    win = port["windowed"]
    T = WIN_ULTRA
    batch = ar2_batch(port, 1, T, WIN_SEED + 1)
    wcfg = win.WindowedConfig(**block)
    t0 = time.perf_counter()
    (_, res), launched = _counted(counters, lambda: win.windowed_fit_forecast(
        batch, horizon=WIN_HORIZON, wconfig=wcfg))
    wall = time.perf_counter() - t0
    W = wcfg.window_len
    assert launched == {"arima_filter": 1, "arima_predict": 1}, launched
    assert bool(res.ok.all()) and bool(torch.isfinite(res.yhat).all())
    assert res.day_all.dtype == batch.day.dtype == torch.int32
    assert torch.equal(res.day_all.cpu(), torch.arange(
        T - W, T + WIN_HORIZON, dtype=torch.int32))
    out = {"shape": [1, T], "windows": len(win.plan_windows(
               T, W, wcfg.overlap)),
           "first_call_wall_s": wall, "launches": launched,
           "ms": cuda_ms(lambda: win.windowed_fit_forecast(
               batch, horizon=WIN_HORIZON, wconfig=wcfg))}
    emit("windowed_ultra_long", card=card_line, **out)
    return out


def _refit_wall(sched) -> float:
    t0 = time.perf_counter()
    assert sched.maybe_refit(force=True) == "forced"
    sched.wait(600)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def windowed_streaming(port, a, block, counters, card_line: str) -> dict:
    """(e) WindowedSeriesStateStore at WIN_SHAPE on (a)'s windowed params,
    driven by RefitScheduler (its own CUDA stream): a cold refit, then
    WIN_NEW_DAYS days of every series ingested and applied and a warm refit
    (one window's statistics computed, two tail-window refits counted on
    /metrics); a fresh store fed the same points refits cold to the same
    params bit for bit; a late point in a frozen window recomputes every
    window.  The refits' walls on the host clock."""
    win, serving = port["windowed"], port["serving"]
    batch, params = a["batch"], a["params"]
    wcfg = win.WindowedConfig(**block)
    S, T = WIN_SHAPE
    W = wcfg.window_len
    y, mask = batch.y.cpu().numpy(), batch.mask.cpu().numpy()
    rng = np.random.default_rng(WIN_SEED + 2)
    new = rng.normal(10.0, 1.0, (S, WIN_NEW_DAYS))
    points = [(s, T + d, float(new[s, d])) for d in range(WIN_NEW_DAYS)
              for s in range(S)]

    def store(metrics=None):
        fc = serving.BatchForecaster("arima", port["arima"].ArimaConfig(),
                                     params, batch.keys, batch.key_names,
                                     day0=T - W, day1=T - 1)
        st = win.WindowedSeriesStateStore(fc, y, mask, history_day0=0,
                                          wconfig=wcfg, metrics=metrics,
                                          device=DEVICE)
        return st, port["refit"].RefitScheduler(
            st, port["refit"].RefitConfig())

    def counting(st):
        calls = []
        orig = st._window_stats_one
        st._window_stats_one = lambda ys, ms: calls.append(1) or orig(ys, ms)
        return calls

    metrics = port["monitoring"].IngestMetrics()
    warm, sched = store(metrics)
    out, launches = {}, {k: 0 for k in WIN_KERNELS}
    try:
        K = len(win.plan_windows(T, W, wcfg.overlap))
        calls = counting(warm)
        out["cold_refit_s"], launched = _counted(
            counters, lambda: _refit_wall(sched))
        assert len(calls) == K and launched == {
            "arima_filter": 1, "arima_predict": 0}, (len(calls), launched)
        launches["arima_filter"] += 1
        assert warm.ingest(points)["accepted"] == len(points)
        assert warm.apply_pending() == {"days": WIN_NEW_DAYS,
                                        "points": len(points)}
        calls.clear()
        out["warm_refit_s"], launched = _counted(
            counters, lambda: _refit_wall(sched))
        launches["arima_filter"] += launched["arima_filter"]
        assert len(calls) == 1, len(calls)
        assert metrics.tail_window_refits_total.value == 2
        assert metrics.refits_total.value == 2
        text = metrics.registry.render_prometheus()
        assert "dftpu_ingest_tail_window_refits_total 2" in text
        out["warm_refits_s"] = [_refit_wall(sched) for _ in range(3)]

        cold, sched_cold = store()
        try:
            cold.ingest(points)
            cold.apply_pending()
            out["fresh_store_cold_refit_s"] = _refit_wall(sched_cold)
        finally:
            sched_cold.stop()
        unequal = [f.name for f in dataclasses.fields(warm._params)
                   if not torch.equal(getattr(warm._params, f.name),
                                      getattr(cold._params, f.name))]
        assert unequal == [], f"warm refit differs from cold: {unequal}"
        out["warm_equals_cold_bitwise"] = True

        assert warm.ingest([(0, 100, 42.0)])["late"] == 1
        calls.clear()
        out["late_point_refit_s"] = _refit_wall(sched)
        assert len(calls) == K, (len(calls), K)
        out.update(windows=K, stats_calls_after_late_point=len(calls),
                   tail_window_refits_total=metrics.tail_window_refits_total
                   .value)
    finally:
        sched.stop()
    out["launches"] = launches
    emit("windowed_streaming", card=card_line, shape=[S, T], **out)
    return out


def windowed_train_task(port, block, counters, card_line: str) -> dict:
    """(f) catalog -> ingest -> train on the card: WIN_TASK's synthetic
    daily series, conf/tasks/train_config.yml with ``model: arima``, CV
    off and ``engine.windowed`` armed at its shipped values (the counters
    set to 0 just before the train task and read after the registered
    artifact's predict).  The run routes windowed (one launch of each arima
    kernel), writes its frame over tail window + horizon and its artifact,
    anchored as the reference anchors it; the artifact predicts the
    frame's future rows."""
    types, win = port["tasks"].TASK_TYPES, port["windowed"]
    n_stores, n_items, n_days = WIN_TASK
    W = int(block["window_len"])
    out = {}
    with tempfile.TemporaryDirectory() as root:
        env = {"env": {"root": root}}
        t0 = time.perf_counter()
        types["catalog"](init_conf={**env, **port["config"].load_conf(
            os.path.join(ROOT, "conf", "tasks", "catalog_config.yml"))},
                         device=DEVICE).launch()
        types["ingest"](init_conf={**env, "input": {"synthetic": {
            "n_stores": n_stores, "n_items": n_items, "n_days": n_days}},
            "output": {"table": "hackathon.sales.raw"}},
            device=DEVICE).launch()
        out["ingest_s"] = time.perf_counter() - t0
        conf = slice13_conf(port, root, dict(
            model="arima", model_conf={}, run_cross_validation=False))
        conf["engine"]["windowed"] = block
        horizon = conf["training"]["horizon"]
        try:
            def train():
                t1 = time.perf_counter()
                summary = types["train"](init_conf=conf,
                                         device=DEVICE).launch()
                out["train_s"] = time.perf_counter() - t1
                catalog, tracker, _ = _store(port, root)
                run = tracker.get_run(summary["experiment_id"],
                                      summary["run_id"])
                fc = port["serving"].BatchForecaster.load(
                    run.artifact_path("forecaster"), device=DEVICE)
                t1 = time.perf_counter()
                served = fc.predict(pd.DataFrame(
                    fc.keys, columns=list(fc.key_names)), horizon=horizon)
                out["artifact_predict_s"] = time.perf_counter() - t1
                return summary, run, fc, served
            (summary, run, fc, served), launched = _counted(counters, train)
        finally:
            win.configure_windowed(win.WindowedConfig())
        assert summary["n_failed"] == 0, summary
        assert launched == {"arima_filter": 1, "arima_predict": 2}, launched
        S = n_stores * n_items
        table = _store(port, root)[0].read_table(FORECASTS)
        assert len(table) == S * (W + horizon), len(table)
        params = run.params()
        assert int(params["n_time"]) == n_days, params
        first, last = pd.Timestamp("2013-01-01"), pd.Timestamp(
            "2013-01-01") + pd.Timedelta(days=n_days - 1)
        assert table["ds"].min() == last - pd.Timedelta(days=W - 1)
        assert table["ds"].max() == last + pd.Timedelta(days=horizon)
        # anchored as the reference's train task anchors it: day0 at the
        # history's first day, the params' own day0 at the tail window
        assert fc.day0 == (first - pd.Timestamp("1970-01-01")).days
        assert float(fc.params.day0) == fc.day1 - W + 1
        future = table[table["ds"] > last].sort_values(
            ["store", "item", "ds"])
        got = served.sort_values(["store", "item", "ds"])
        worst = float(np.max(np.abs(got["yhat"].to_numpy()
                                    - future["yhat"].to_numpy())
                             / np.maximum(np.abs(future["yhat"].to_numpy()),
                                          1.0)))
        assert worst <= ARIMA_REL, worst
        out.update(series=S, n_time=n_days, rows=len(table),
                   fit_seconds=run.metrics()["fit_seconds"],
                   launches=launched, artifact_vs_table_rel=worst)
    emit("windowed_train_task", card=card_line, **out)
    return out


def slice17_phase(port, card_line: str) -> dict:
    """Phase 17: windowed (DARIMA) arima fitting.  (a) windowed against
    sequential at WIN_SHAPE; (b) both arima kernels against their twins and
    timed at the window's shapes; (c) 20 series card against CPU; (d) the
    ultra-long case; (e) the tail-window streaming refit; (f) the train
    task.  The counters are set to 0 around each main path."""
    t_phase = time.perf_counter()
    kal, win = port["kalman"], port["windowed"]
    counters = {k: getattr(kal, k) for k in WIN_KERNELS}
    block = windowed_block(port)
    out = {"launches": {k: 0 for k in WIN_KERNELS}}
    try:
        a = windowed_vs_sequential(port, block, counters, card_line)
        b = windowed_kernels(port, a["stages"], card_line)
        win.configure_windowed(block)
        out["gpu_vs_cpu"] = arima_vs_cpu(
            port, ar2_batch(port, *WIN_VS_CPU, WIN_SEED + 3),
            n=WIN_VS_CPU[0], horizon=WIN_HORIZON,
            phase="windowed_gpu_vs_cpu_20_series")
        assert out["gpu_vs_cpu"]["T_all"] == block["window_len"] + WIN_HORIZON
    finally:
        win.configure_windowed(win.WindowedConfig())
    d = windowed_ultra(port, block, counters, card_line)
    e = windowed_streaming(port, a, block, counters, card_line)
    f = windowed_train_task(port, block, counters, card_line)
    for part in (a, d, e, f):
        for k in WIN_KERNELS:
            out["launches"][k] += part["launches"][k]
    emit("launches", path="windowed", **out["launches"],
         expected="arima_filter: 1 per fit and per tail refit; arima_predict"
                  ": 1 per fit and per predict")
    out.update(cases=b["cases"], times=dict(b["times"], ultra_ms=d["ms"]))
    out["seconds"] = time.perf_counter() - t_phase
    emit("phase17", seconds=out["seconds"])
    return out


# -- phase 18: the training runtime (slice 19) ---------------------------------

RUNTIME_FAMILIES = ("holt_winters", "arima", "theta", "prophet")
RUNTIME_HORIZON = 90
RUNTIME_REPS = 2           # pipelined / serial run_many pairs (in turns)
RUNTIME_TRACE_REPS = 2     # tracer on / off train-task pairs (in turns)
RUNTIME_COST_REPS = 5      # HW fits timed for the cost registry
RUNTIME_WINDOWED = (20, 8192, 1024, 64)  # S, T, W, overlap of (e)'s fit
ANNOTATION = "chip_smoke.hw_score"
# the timings of a run, outside the byte-identity contract
RUNTIME_TIMINGS = ("fit_seconds", "series_per_second")


def _timing(name: str) -> bool:
    return name in RUNTIME_TIMINGS or name.startswith(("phase_",
                                                       "pipeline_"))


def _frames_identical(a: pd.DataFrame, b: pd.DataFrame) -> bool:
    """Same columns, dtypes and values, NaNs in the same places."""
    if list(a.columns) != list(b.columns) or len(a) != len(b):
        return False
    for col in a.columns:
        x, y = a[col].to_numpy(), b[col].to_numpy()
        if x.dtype != y.dtype:
            return False
        if x.dtype.kind in "fc":
            if not np.array_equal(x, y, equal_nan=True):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def _dirs_identical(a: str, b: str) -> bool:
    """Every file under ``a`` and ``b`` byte for byte."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return False
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            if not _dirs_identical(pa, pb):
                return False
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    return False
    return True


def runtime_spec(model: str, table: str, experiment: str) -> dict:
    """One run_many experiment on the committed dataset at the reference
    workload's size: ``model`` (the curve model with the shipped model
    conf), CV 730/360/90, horizon 90."""
    model_conf = (port_train_conf()["training"]["model_conf"]
                  if model == "prophet" else {})
    return dict(source_table="hackathon.sales.raw", output_table=table,
                model=model, model_conf=model_conf, cv_conf=dict(CV),
                horizon=RUNTIME_HORIZON, experiment=experiment)


def port_train_conf() -> dict:
    import yaml

    with open(TRAIN_CONF) as f:
        return yaml.safe_load(f)


def runtime_runs_identical(port, roots: tuple, runs: tuple,
                           table: str) -> dict:
    """Two runs of one experiment, each in its own env root: the forecast
    table, the tracked params, tags, series table and non-timing metrics,
    and the artifact, byte for byte; the timings are left out."""
    (ra, rb), out = runs, {}
    ca, ta, _ = _store(port, roots[0])
    cb, tb, _ = _store(port, roots[1])
    out["table"] = _frames_identical(ca.read_table(table),
                                     cb.read_table(table))
    a = ta.get_run(ra["experiment_id"], ra["run_id"])
    b = tb.get_run(rb["experiment_id"], rb["run_id"])
    out["params"] = a.params() == b.params()
    out["tags"] = a.meta()["tags"] == b.meta()["tags"]
    ma, mb = a.metrics(), b.metrics()
    out["metric_names"] = set(ma) == set(mb)
    out["metrics"] = ({k: v for k, v in ma.items() if not _timing(k)}
                      == {k: v for k, v in mb.items() if not _timing(k)})
    out["series_table"] = _frames_identical(
        pd.read_parquet(a.artifact_path("series_metrics.parquet")),
        pd.read_parquet(b.artifact_path("series_metrics.parquet")))
    out["artifact"] = _dirs_identical(a.artifact_path("forecaster"),
                                      b.artifact_path("forecaster"))
    return out


def runtime_train_tasks(port, batch, card_line: str) -> dict:
    """(a) conf/tasks/train_config.yml as shipped (the curve model), then
    with ``model: holt_winters``, each pipelined (``pipeline`` as shipped)
    and with ``async_tracking: false``, two of each in turns, the six
    counters set to 0 just before each task and read after: the frames,
    artifacts and tracking
    rows are byte-identical, the pipelined run logs the reference's
    ``pipeline_*`` run metrics, and the Holt-Winters tasks launch hw_score
    and hw_filter through the executor."""
    ex_mod = port["executor"]
    counters = {k: wrapper(k) for k in KERNELS}
    raw = raw_table(batch)
    out = {"launches": {k: 0 for k in KERNELS}}
    pipes = {"serial": {"async_tracking": False}, "pipelined": {}}
    for model in ("prophet", "holt_winters"):
        kept, walls, launched = {}, {"serial": [], "pipelined": []}, {}
        # in turns, so that neither mode has the warm-up to itself
        for mode in ("serial", "pipelined", "pipelined", "serial"):
            root = tempfile.mkdtemp(prefix=f"dftt-a-{model}-{mode}-")
            _store(port, root)[0].save_table("hackathon.sales.raw", raw)
            conf = port_train_conf()
            conf["env"] = {"root": root}
            if model == "holt_winters":
                conf["training"].update(model=model, model_conf={})
            conf["pipeline"].update(pipes[mode])
            try:
                (summary, dt), n = _counted(counters, lambda: _timed_task(
                    port, conf))
            finally:
                ex_mod.configure_pipeline(ex_mod.PipelineConfig())
            walls[mode].append(dt)
            launched.setdefault(mode, n)
            for k in KERNELS:
                out["launches"][k] += n[k]
            if mode in kept:
                shutil.rmtree(root, ignore_errors=True)
            else:
                kept[mode] = (root, summary)
        roots = (kept["serial"][0], kept["pipelined"][0])
        same = runtime_runs_identical(
            port, roots, (kept["serial"][1], kept["pipelined"][1]),
            FORECASTS)
        piped = _store(port, roots[1])[1].get_run(
            kept["pipelined"][1]["experiment_id"],
            kept["pipelined"][1]["run_id"]).metrics()
        logged = {k: piped[k] for k in sorted(piped)
                  if k.startswith("pipeline_")}
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
        assert all(same.values()), (model, same)
        assert set(logged) == {"pipeline_prep_seconds",
                               "pipeline_dispatch_seconds",
                               "pipeline_pull_seconds"}, logged
        if model == "holt_winters":
            for mode in launched:
                assert launched[mode]["hw_score"] >= 1, launched
                assert launched[mode]["hw_filter"] >= 1, launched
        out[model] = dict(identical=same, pipeline_metrics=logged,
                          wall_s=walls, launches=launched)
    emit("runtime_train_task", card=card_line, **{
        k: v for k, v in out.items() if k != "launches"})
    return out


def _timed_task(port, conf) -> tuple:
    t0 = time.perf_counter()
    summary = port["tasks"].TASK_TYPES["train"](init_conf=conf,
                                                 device=DEVICE).launch()
    torch.cuda.synchronize()
    return summary, time.perf_counter() - t0


def runtime_run_many(port, batch, card_line: str) -> dict:
    """(b) ``run_many`` of RUNTIME_FAMILIES on the committed dataset,
    pipelined (``max_in_flight`` 2) and serial (``async_tracking: false``)
    in turns, RUNTIME_REPS of each, each run in its own env root with the
    counters set to 0 around it: the walls, ``stage_metrics`` and the idle
    fraction the executor reports; each experiment's table, artifact and
    tracking rows byte-identical between the first pipelined and the first
    serial run; then one pipelined run traced (``idle_share``) for the
    device's idle share beside the executor's lower bound."""
    ex_mod = port["executor"]
    counters = {k: wrapper(k) for k in KERNELS}
    raw = raw_table(batch)
    specs = [runtime_spec(m, f"runtime.fc.{m}", f"runtime_{m}")
             for m in RUNTIME_FAMILIES]
    cfgs = {"pipelined": ex_mod.PipelineConfig(max_in_flight=2),
            "serial": ex_mod.PipelineConfig(async_tracking=False)}

    def one(mode):
        root = tempfile.mkdtemp(prefix=f"dftt-b-{mode}-")
        catalog, tracker, _ = _store(port, root)
        catalog.save_table("hackathon.sales.raw", raw)
        pipe = port["training"].TrainingPipeline(catalog, tracker,
                                                 device=DEVICE)
        t0 = time.perf_counter()
        got = pipe.run_many(specs, pipeline=cfgs[mode])
        torch.cuda.synchronize()
        return root, got, time.perf_counter() - t0

    out = {"launches": {k: 0 for k in KERNELS}, "wall_s": {
        "pipelined": [], "serial": []}, "stage_metrics": {}}
    kept = {}
    for mode in ("serial", "pipelined", "pipelined", "serial")[
            :2 * RUNTIME_REPS]:
        (root, got, wall), n = _counted(counters, lambda: one(mode))
        out["wall_s"][mode].append(wall)
        out["stage_metrics"].setdefault(mode, []).append(got["pipeline"])
        for k in KERNELS:
            out["launches"][k] += n[k]
        assert len(got["results"]) == len(specs)
        if mode in kept:
            shutil.rmtree(root, ignore_errors=True)
        else:
            kept[mode] = (root, got)
    same = {}
    for i, spec in enumerate(specs):
        same[spec["model"]] = runtime_runs_identical(
            port, (kept["serial"][0], kept["pipelined"][0]),
            (kept["serial"][1]["results"][i],
             kept["pipelined"][1]["results"][i]), spec["output_table"])
    for root, _ in kept.values():
        shutil.rmtree(root, ignore_errors=True)
    assert all(all(v.values()) for v in same.values()), same
    assert out["launches"]["hw_score"] >= 1 and \
        out["launches"]["arima_filter"] >= 1, out["launches"]

    traced = {}

    def traced_run():
        root, got, wall = one("pipelined")
        traced.update(root=root, stage=got["pipeline"], wall=wall)

    share = idle_share(traced_run, attempts=2)
    shutil.rmtree(traced.get("root", ""), ignore_errors=True)
    out.update(identical=same, traced=share,
               traced_executor_idle_fraction=traced.get("stage", {}).get(
                   "pipeline_device_idle_fraction"),
               pipelined_over_serial=(statistics.median(
                   out["wall_s"]["pipelined"]) / statistics.median(
                   out["wall_s"]["serial"])))
    emit("runtime_run_many", card=card_line, families=RUNTIME_FAMILIES,
         **{k: v for k, v in out.items() if k != "launches"})
    return out


# what a library-store child process runs: configure the store, load the
# library (optionally from another copy of the sources, optionally with
# the nvcc build refused), launch hw_score once against its twin, and print
# the load's seconds, the build count, the cache's counts and outcomes and
# the span kinds its flight recorder holds
STORE_CHILD = r"""
import json, sys, time
import torch
from distributed_forecasting_tpu_torch.engine import compile_cache as cc
from distributed_forecasting_tpu_torch.monitoring import trace
from distributed_forecasting_tpu_torch.ops import _build
from distributed_forecasting_tpu_torch.ops import fused_scan as fs
store, csrc, no_nvcc = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
if csrc:
    _build.CSRC = csrc
if no_nvcc:
    import torch.utils.cpp_extension as ext
    def refused(*a, **k):
        raise RuntimeError("nvcc invoked on a warm store")
    ext.load = refused
tr = trace.configure_tracing(trace.TraceConfig(enabled=True))
cc.configure_compile_cache(cc.CompileCacheConfig(enabled=True,
                                                 directory=store))
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t0 = time.perf_counter()
_build.library()
seconds = time.perf_counter() - t0
g = torch.Generator().manual_seed(3)
y = (10 + torch.randn(64, 400, generator=g)).cuda()
mask = (torch.rand(64, 400, generator=g) > 0.1).float().cuda()
grid = [torch.full((8,), v, device="cuda") for v in (0.3, 0.1, 0.2, 1.0)]
got = fs.hw_score(y, mask, *grid, 7)
want = fs.hw_score_reference(y, mask, *grid, 7)
err = float((got - want).abs().max() / want.abs().max())
print(json.dumps({"seconds": seconds, "builds": _build.builds,
                  "stats": cc.cache_stats(),
                  "outcomes": cc._entry_requests.snapshot(),
                  "hw_score_rel_err": err,
                  "spans": sorted({s.name for s in tr.recorder.snapshot()})}))
"""


def _start_store_child(store: str, csrc: str, no_nvcc: bool) -> tuple:
    """Start one STORE_CHILD process on ``(store, csrc, no_nvcc)``; its
    output goes to files beside the store (a child started long before it
    is read must not stall on a full pipe)."""
    base = tempfile.mkdtemp(prefix="dftt-child-")
    atexit.register(shutil.rmtree, base, True)
    out = open(os.path.join(base, "out"), "w+")
    err = open(os.path.join(base, "err"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", STORE_CHILD, store, csrc,
         "1" if no_nvcc else "0"], cwd=ROOT, stdout=out, stderr=err,
        text=True)
    return proc, out, err


def _store_child_report(child: tuple) -> dict:
    """A started STORE_CHILD's report, once it has exited."""
    proc, out, err = child
    proc.wait(timeout=600)
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        raise AssertionError(f"library-store child failed: {stderr}")
    rep = json.loads(stdout.strip().splitlines()[-1])
    assert rep["hw_score_rel_err"] <= 1e-5, rep
    return rep


def _store_children(*args) -> list:
    """Run one STORE_CHILD process for each ``(store, csrc, no_nvcc)``, all
    at once, and return their reports in order."""
    children = [_start_store_child(*a) for a in args]
    return [_store_child_report(c) for c in children]


# the kernel store phase 18's cold child filled: phase 20's fleet boots
# from it (the cold build is measured once, in phase 18)
KERNEL_STORE = None
# phase 18 (c)'s cold child (its store and its process), started beside
# phase 2's build by ``start_cold_store_child``: the two nvcc builds share
# the host, and (c) reads the child's report when it runs
COLD_CHILD = None


def start_cold_store_child() -> None:
    """Start (c)'s cold child now: a fresh process on an empty store."""
    global COLD_CHILD
    store = tempfile.mkdtemp(prefix="dftt-store-")
    atexit.register(shutil.rmtree, store, True)
    COLD_CHILD = (store, _start_store_child(store, "", False))


def runtime_compile_cache(port, card_line: str) -> dict:
    """(c) the kernel library's store, each step a fresh process: an empty
    store (cold: nvcc builds, the library is stored), the same store (warm:
    loaded with the build refused), the entry truncated (error: rebuilt),
    one source changed in a copy of csrc/ (a new key: rebuilt).  The cold
    child ran beside phase 2's build (:func:`start_cold_store_child`; here
    when the phase runs alone); after it the other three run at once, the
    truncated entry in a copy of the store (two builds and the warm load
    share the host's cores).  Each child launches hw_score once against
    its twin.  The store is kept for the run as :data:`KERNEL_STORE`."""
    global KERNEL_STORE
    out = {}
    if COLD_CHILD is None:
        start_cold_store_child()
    store, child = COLD_CHILD
    with tempfile.TemporaryDirectory(prefix="dftt-c-") as tmp:
        kernels = os.path.join(store, "kernels")
        cold = _store_child_report(child)
        out["cold"] = cold
        assert cold["builds"] == 1 and cold["stats"]["misses"] == 1 \
            and cold["stats"]["stores"] == 1, cold
        damaged = os.path.join(tmp, "damaged")
        shutil.copytree(store, damaged)
        (entry,) = [n for n in os.listdir(kernels) if n.endswith(".aot")]
        path = os.path.join(damaged, "kernels", entry)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(port["build"].CSRC, csrc)
        with open(os.path.join(csrc, port["build"].SOURCES[0]), "a") as f:
            f.write("\n// a changed source: a new key\n")
        warm, trunc, changed = _store_children(
            (store, "", True), (damaged, "", False), (store, csrc, False))
        out["warm"] = warm
        assert warm["builds"] == 0 and warm["stats"]["hits"] == 1 \
            and warm["stats"]["misses"] == 0, warm
        out["truncated"], out["changed_source"] = trunc, changed
        assert trunc["builds"] == 1 and trunc["stats"]["errors"] == 1, trunc
        assert any("outcome=error" in k for k in trunc["outcomes"]), trunc
        assert changed["builds"] == 1 and changed["stats"]["misses"] == 1 \
            and changed["stats"]["errors"] == 0, changed
        out["entries"] = sorted(n for n in os.listdir(kernels)
                                if n.endswith(".aot"))
        assert len(out["entries"]) == 2, out["entries"]
        out["entry_bytes"] = size
    KERNEL_STORE = store
    emit("runtime_compile_cache", card=card_line,
         cold_load_s=cold["seconds"], cold_beside="phase 2's build",
         warm_load_s=warm["seconds"],
         truncated_load_s=trunc["seconds"],
         changed_source_load_s=changed["seconds"], **out)
    return out


def _program_rows(cm, entry: str) -> dict:
    rows = {}
    for field in ("flops", "bytes_accessed"):
        for label, v in cm.program[field].snapshot().items():
            e, key = (part.partition("=")[2] for part in label.split(","))
            if e == entry:
                rows.setdefault(key, {})[field] = v
    return rows


def runtime_cost(port, batch, card_line: str) -> dict:
    """(d) a fresh cost registry, then Holt-Winters, arima and the curve
    model's fit_forecast at the fit shape: every kernel row's FLOPs and
    bytes equal its ``*_work`` count at the row's shape (hw_score's on the
    batch's mask, the only one at that shape here); then RUNTIME_COST_REPS
    Holt-Winters fits, each between two CUDA events, beside the seconds the
    registry charged ``fit_forecast:holt_winters``."""
    cost, fs, kal, solve = (port["cost"], port["fs"], port["kalman"],
                            port["solve"])
    with cost._state_lock:
        cost._cost_metrics = None  # a fresh registry for this check
    eng = port["engine"]
    hw_cfg = port["hw"].HoltWintersConfig()
    eng.fit_forecast(batch, model="holt_winters", config=hw_cfg,
                     horizon=RUNTIME_HORIZON)
    eng.fit_forecast(batch, model="arima", horizon=RUNTIME_HORIZON)
    eng.fit_forecast(batch, model="prophet", config=curve_config(batch, port),
                     horizon=RUNTIME_HORIZON)
    torch.cuda.synchronize()
    cm = cost.cost_metrics()

    def dims(key):
        return [int(x) for x in key.split(":")[0].split("x")]

    def param(key, name):
        return next(int(p[len(name):]) for p in key.split(":")[1:]
                    if p.startswith(name))

    counts = {
        "hw_score": lambda k: fs.hw_score_work(batch.mask, param(k, "C"),
                                               param(k, "m")),
        "hw_filter": lambda k: fs.hw_filter_work(*dims(k), param(k, "m")),
        "arima_filter": lambda k: kal.arima_filter_work(
            *dims(k), param(k, "r"), param(k, "d")),
        "arima_predict": lambda k: kal.arima_predict_work(*dims(k),
                                                          param(k, "r")),
        "masked_gram": lambda k: solve.gram_work(*dims(k), param(k, "F")),
        "batched_cho_solve": lambda k: solve.cho_solve_work(
            *dims(k), param(k, "F")),
    }
    out = {"rows": {}}
    for entry, count in counts.items():
        rows = _program_rows(cm, entry)
        assert rows, f"no cost row for {entry}"
        for key, got in rows.items():
            ops, nbytes = count(key)
            want = {"flops": float(ops), "bytes_accessed": float(nbytes)}
            assert got == want, (entry, key, got, want)
            out["rows"][f"{entry}|{key}"] = got
    label = "entry=fit_forecast:holt_winters,family=holt_winters"
    s0 = cm.device_seconds_total.snapshot().get(label, 0.0)
    n0 = cm.dispatches_total.snapshot().get(label, 0.0)
    events = []
    for _ in range(RUNTIME_COST_REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.fit_forecast(batch, model="holt_winters", config=hw_cfg,
                         horizon=RUNTIME_HORIZON)
        stop.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(stop))
    n = cm.dispatches_total.snapshot()[label] - n0
    assert n == RUNTIME_COST_REPS, n
    recorded = (cm.device_seconds_total.snapshot()[label] - s0) / n * 1e3
    out.update(hw_fit_recorded_ms=recorded,
               hw_fit_cuda_event_ms=statistics.median(events),
               hw_fit_cuda_event_ms_all=events,
               recorded_over_events=recorded / statistics.mean(events),
               cost_table=[r for r in cm.cost_table() if r["entry"] in (
                   "hw_score", "hw_filter", "fit_forecast:holt_winters")])
    emit("runtime_cost", card=card_line, **out)
    return out


def _annotation_encloses_kernel(path: str, name: str, kernel: str) -> dict:
    """In a Chrome trace exported by ``torch.profiler``: whether a
    ``name`` range encloses a ``kernel`` launch — on the device timeline (a
    ``gpu_user_annotation`` around the kernel) or on the host's (the host
    range around the ``cudaLaunchKernel`` whose correlation id is the
    kernel's)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels = [e for e in events if kernel in e.get("name", "")
               and e.get("cat") == "kernel"]
    gpu = [e for e in events if e.get("name") == name
           and e.get("cat") == "gpu_user_annotation"]
    host = [e for e in events if e.get("name") == name
            and e.get("cat") == "user_annotation"]
    corr = {e.get("args", {}).get("correlation") for e in kernels}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("args", {}).get("correlation") in corr]

    def inside(a, b):
        return a["ts"] <= b["ts"] and b["ts"] + b.get("dur", 0) <= \
            a["ts"] + a.get("dur", 0)

    return {"kernels": len(kernels), "gpu_annotations": len(gpu),
            "host_annotations": len(host),
            "device_timeline": any(inside(a, k) for a in gpu
                                   for k in kernels),
            "host_timeline": any(inside(a, ln) for a in host
                                 for ln in launches)}


def runtime_tracing(port, batch, card_line: str) -> dict:
    """(e) tracing on: a pipelined Holt-Winters train task and a small
    windowed arima fit; the flight recorder dumped as a Chrome trace holds
    the ``pipeline.*``, ``aot.call`` and ``windowed.*`` kinds (the
    ``aot.load`` / ``aot.compile`` kinds come from (c)'s children).  A
    ``ProfilerSession`` capture while another thread launches hw_score
    inside ``device_annotation(ANNOTATION)``: the annotation encloses a
    launch
    (head and tail margins, TRACE_ATTEMPTS tries, as ``idle_share``).  The
    train task's wall with the tracer on and off, in turns."""
    trace, win = port["trace"], port["windowed"]
    out = {}
    raw = raw_table(batch)
    with tempfile.TemporaryDirectory(prefix="dftt-e-") as tmp:
        def task(tag):
            root = os.path.join(tmp, tag)
            _store(port, root)[0].save_table("hackathon.sales.raw", raw)
            conf = port_train_conf()
            conf["env"] = {"root": root}
            conf["training"].update(model="holt_winters", model_conf={})
            return _timed_task(port, conf)[1]

        tr = trace.configure_tracing(trace.TraceConfig(
            enabled=True, ring_size=1 << 16, dump_dir=tmp))
        try:
            task("traced")
            S, T, W, ov = RUNTIME_WINDOWED
            wb = ar2_batch(port, S, T, WIN_SEED + 7)
            win.windowed_fit_forecast(
                wb, model="arima", horizon=WIN_HORIZON,
                wconfig=win.WindowedConfig(enabled=True, window_len=W,
                                           overlap=ov, min_windows=4))
            torch.cuda.synchronize()
            path = trace.dump_flight_recorder("phase18", tracer=tr)
        finally:
            trace.configure_tracing(trace.TraceConfig())
        with open(path) as f:
            kinds = sorted({e["name"] for e in json.load(f)["traceEvents"]
                            if e.get("ph") == "X"})
        want = {"pipeline.prep", "pipeline.dispatch", "pipeline.pull",
                "pipeline.complete", "aot.call", "windowed.fit",
                "windowed.combine", "windowed.finalize"}
        assert want <= set(kinds), kinds
        out["flight_recorder_kinds"] = kinds

        fs = port["fs"]
        grid = port["hw"]._candidate_grid(port["hw"].HoltWintersConfig(),
                                          device=batch.y.device)
        sess = trace.ProfilerSession(os.path.join(tmp, "prof"),
                                     max_seconds=30.0)
        def launches():
            # inside the capture's window, after its head margin
            time.sleep(TRACE_HEAD_S)
            t_end = time.perf_counter() + 1.0
            while time.perf_counter() < t_end:
                with trace.device_annotation(ANNOTATION):
                    fs.hw_score(batch.y, batch.mask, *grid, 7)
                torch.cuda.synchronize()

        for attempt in range(1, TRACE_ATTEMPTS + 1):
            # the capture on this thread (the profiler's own), the annotated
            # launches on another: the session records every thread
            th = threading.Thread(target=launches)
            th.start()
            captured = sess.capture(TRACE_HEAD_S + 1.0 + TRACE_TAIL_S)
            th.join(120)
            assert not th.is_alive()
            found = _annotation_encloses_kernel(
                os.path.join(captured, "trace.json"), ANNOTATION,
                "hw_score_kernel")
            found["attempt"] = attempt
            if found["device_timeline"] or found["host_timeline"]:
                break
        assert found["device_timeline"] or found["host_timeline"], found
        out["profiler_capture"] = found

        walls = {"on": [], "off": []}
        for i, mode in enumerate(("off", "on", "on", "off")[
                :2 * RUNTIME_TRACE_REPS]):
            trace.configure_tracing(trace.TraceConfig(enabled=mode == "on"))
            try:
                walls[mode].append(task(f"wall{i}-{mode}"))
            finally:
                trace.configure_tracing(trace.TraceConfig())
        out["train_task_wall_s"] = walls
        out["tracer_on_over_off"] = (statistics.median(walls["on"])
                                     / statistics.median(walls["off"]))
    emit("runtime_tracing", card=card_line, **out)
    return out


def slice19_phase(port, card_line: str) -> dict:
    """Phase 18: the training runtime.  (a) the shipped train conf
    pipelined against serial; (b) run_many of four families; (c) the
    kernel library's store in fresh processes; (d) the cost registry;
    (e) tracing.  The launches of (a) and (b), the main paths here, are
    added to the kernels line."""
    t_phase = time.perf_counter()
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA))
    parts, seconds = {}, {}
    for name, run in (
            ("train_tasks", lambda: runtime_train_tasks(port, batch,
                                                        card_line)),
            ("run_many", lambda: runtime_run_many(port, batch, card_line)),
            ("compile_cache", lambda: runtime_compile_cache(port,
                                                            card_line)),
            ("cost", lambda: runtime_cost(port, batch, card_line)),
            ("tracing", lambda: runtime_tracing(port, batch, card_line))):
        t0 = time.perf_counter()
        parts[name] = run()
        seconds[name] = time.perf_counter() - t0
    out = {"launches": {k: parts["train_tasks"]["launches"][k]
                        + parts["run_many"]["launches"][k]
                        for k in KERNELS}, **parts}
    emit("launches", path="runtime", **out["launches"],
         expected="hw_score, hw_filter: each HW train task and HW "
                  "experiment; arima_filter, arima_predict: each arima "
                  "experiment")
    out["seconds"] = time.perf_counter() - t_phase
    emit("phase18", seconds=out["seconds"], parts=seconds)
    return out


# -- phase 19: the scorer's runtime -------------------------------------------

RT_FAMILIES = ("holt_winters", "arima")
RT_HORIZON = 28
RT_CHECKED = 17            # series of the traced requests
RT_DAYS = 14               # days of actuals the traced /observe and
                           # /detect_anomalies send for each of them
RT_TIMEOUT_S = 2.0         # the arima scorer's request_timeout_s, for (c)
RT_PROFILE_S = 2.0         # the /debug/profile window of (b)
RT_COST_SIZES = (1, 5, 100, 500)  # request sizes of (d): pads 0, 1, 28, 0
RT_COST_REPS = 10          # direct predicts of each size in (d)
RT_LAT_REQUESTS = 60       # (e): /invocations per size and tracing mode
RT_LAT_HORIZON = 7         # (e)'s horizon: the 500-series body's encoding
                           # (host JSON) stays a few tens of ms
RT_LAT_BLOCK = 10          # requests in a row before the mode flips
RT_ANNOTATION_CALLS = 20_000
RT_DEVICE_SECONDS = (0.8, 1.2)  # charged over CUDA-event seconds, (d)


def rt_serve_conf(port, root: str, model: str, name: str, tmp: str) -> tuple:
    """The shipped serve conf for one artifact of (a)-(e): Holt-Winters with
    ``serving.ingest`` on (:func:`stream_serve_conf`), arima without (no
    streaming update) and with ``request_timeout_s`` RT_TIMEOUT_S; both
    with batching, the anomaly scorer, and ``serving.tracing`` with
    ``debug_endpoints``, ``profile_dir``, ``dump_dir`` and ``jsonl_path``
    under ``tmp``; each its own store and stream directories."""
    if model == "holt_winters":
        conf, changed = stream_serve_conf(port, root, model, name)
    else:
        conf = port["config"].load_conf(SERVE_CONF)
        conf["env"] = {"root": root}
        conf["serving"].update(model_name=name, host="127.0.0.1", port=0)
        changed = {"env.root": root, "serving.model_name": name,
                   "serving.host": "127.0.0.1", "serving.port": 0,
                   "serving.batching.request_timeout_s": RT_TIMEOUT_S,
                   "monitoring.quality_store.directory":
                       os.path.join(root, f"quality_{model}")}
    changed.update({
        "serving.batching.enabled": True,
        "serving.anomaly.enabled": True,
        "serving.anomaly.stream_store_dir":
            os.path.join(root, f"anomaly_{model}"),
        "serving.tracing.debug_endpoints": True,
        "serving.tracing.profile_dir": os.path.join(tmp, "profile"),
        "serving.tracing.dump_dir": os.path.join(tmp, "dumps"),
        "serving.tracing.jsonl_path": os.path.join(tmp, "trace.jsonl")})
    for key, value in changed.items():
        *path, last = key.split(".")
        node = conf
        for k in path:
            node = node[k]
        if key.startswith(("serving.", "monitoring.")):
            assert last in node, key  # only keys the shipped conf has
        node[last] = value
    return conf, changed


def rt_spans(number: int) -> list:
    """``GET /debug/trace`` -> its complete events."""
    status, body, _ = http_call(number, "GET", "/debug/trace")
    assert status == 200, body[:300]
    return [e for e in json.loads(body)["traceEvents"] if e.get("ph") == "X"]


def rt_route(number: int, path: str, payload, trace_id: str, want: set,
             threads: int) -> dict:
    """One traced request: 200, its X-Trace-Id echoed; under that id the
    ``want`` kinds on at least ``threads`` threads, one ``http.request``
    root with ``status`` 200 and every other span's parent in the tree."""
    status, body, head = http_call(number, "POST", path, payload,
                                   headers={"X-Trace-Id": trace_id})
    assert status == 200, body[:300]
    assert head.get("X-Trace-Id") == trace_id, head
    time.sleep(0.2)  # the root span closes after the response is written
    mine = [e for e in rt_spans(number)
            if e["args"].get("trace_id") == trace_id]
    kinds = {e["name"] for e in mine}
    assert want <= kinds, (path, sorted(kinds))
    roots = [e for e in mine if e["name"] == "http.request"]
    assert len(roots) == 1 and roots[0]["args"]["parent_id"] is None
    assert roots[0]["args"]["status"] == 200
    ids = {e["args"]["span_id"] for e in mine}
    assert all(e["args"]["parent_id"] in ids for e in mine
               if e is not roots[0]), path
    tids = {e["tid"] for e in mine}
    assert len(tids) >= threads, (path, tids)
    out = {"kinds": sorted(kinds), "spans": len(mine), "threads": len(tids)}
    if "batcher.dispatch" in kinds:
        dispatch = next(e for e in mine if e["name"] == "batcher.dispatch")
        out["dispatch_parent_is_root"] = (dispatch["args"]["parent_id"]
                                          == roots[0]["args"]["span_id"])
        out["dispatch_device_seconds"] = dispatch["args"]["device_seconds"]
    return out


def rt_actuals(fc, batch, n_series: int, days: int) -> list:
    """The last ``days`` training days of ``n_series`` series as
    ``{<keys>, ds, y}`` rows (observed cells only)."""
    idx = np.linspace(0, fc.n_series - 1, n_series).astype(int)
    y = batch.y[idx, -days:].cpu().numpy()
    m = batch.mask[idx, -days:].cpu().numpy()
    dates = pd.Timestamp("1970-01-01") + pd.to_timedelta(
        batch.day[-days:].cpu().numpy().astype(np.int64), unit="D")
    return [{**dict(zip(fc.key_names, map(int, fc.keys[s]))),
             "ds": str(dates[j].date()), "y": float(y[i, j])}
            for i, s in enumerate(idx) for j in range(days) if m[i, j] > 0]


def rt_trees(servers: dict, batch) -> dict:
    """(a) The correlated span trees of /invocations, /observe,
    /detect_anomalies and /ingest on the Holt-Winters scorer and
    /invocations on the arima one.  /observe predicts on its handler
    thread (the reference's QualityMonitor), so one thread is its tree's
    whole; the routes through the coalescer hold two or more."""
    hw_srv, ar_srv = servers["holt_winters"], servers["arima"]
    hw, ar = hw_srv.server_address[1], ar_srv.server_address[1]
    fc = hw_srv.forecaster
    idx = np.linspace(0, fc.n_series - 1, RT_CHECKED).astype(int)
    inputs = _inputs(fc.keys[idx], fc.key_names)
    actuals = rt_actuals(fc, batch, RT_CHECKED, RT_DAYS)
    day = int(fc.day1) + 1
    served = {"invocations": (hw, "/invocations",
                              {"inputs": inputs, "horizon": RT_HORIZON},
                              {"batcher.queue_wait", "batcher.dispatch",
                               "serving.predict", "aot.call"}, 2),
              "observe": (hw, "/observe", {"observations": actuals},
                          {"quality.observe", "serving.predict", "aot.call"},
                          1),
              "detect_anomalies": (hw, "/detect_anomalies",
                                   {"points": actuals},
                                   {"anomaly.score", "batcher.queue_wait",
                                    "batcher.dispatch", "serving.predict",
                                    "aot.call"}, 2),
              "ingest": (hw, "/ingest",
                         {"points": day_points(
                             fc, day, np.full((fc.n_series, 1), 7.0,
                                              np.float32))},
                         {"ingest.append", "anomaly.score",
                          "batcher.dispatch", "serving.predict",
                          "state.update", "aot.call"}, 2),
              "arima_invocations": (ar, "/invocations",
                                    {"inputs": inputs,
                                     "horizon": RT_HORIZON},
                                    {"batcher.queue_wait",
                                     "batcher.dispatch", "serving.predict",
                                     "aot.call"}, 2)}
    out = {}
    for i, (route, (number, path, payload, want, threads)) in enumerate(
            served.items()):
        out[route] = rt_route(number, path, payload, f"smoke20route{i}",
                              {"http.request", *want}, threads)
    for route in ("invocations", "arima_invocations"):
        assert out[route]["dispatch_parent_is_root"], out[route]
    return out


def rt_profile(servers: dict) -> dict:
    """(b) ``GET /debug/profile?seconds=RT_PROFILE_S`` on one thread; a
    second capture meanwhile (409); a forced Holt-Winters refit and arima
    /invocations traffic inside the window.  The capture's Chrome trace
    must hold hw_score and hw_filter inside the refit's
    ``pipeline_dispatch:refit:forced`` annotation and arima_predict inside
    ``serving_predict:arima`` (host or device timeline, as phase 18's
    capture).  Kineto may drop a window's records late in a process
    (PERF.md section 7): a capture missing one is taken again, up to
    TRACE_ATTEMPTS times."""
    hw_srv, ar_srv = servers["holt_winters"], servers["arima"]
    hw, ar = hw_srv.server_address[1], ar_srv.server_address[1]
    fc = ar_srv.forecaster
    payload = {"inputs": _inputs(fc.keys[:8], fc.key_names),
               "horizon": RT_HORIZON}
    want = {"hw_score": ("pipeline_dispatch:refit:forced", "hw_score_kernel"),
            "hw_filter": ("pipeline_dispatch:refit:forced",
                          "hw_filter_kernel"),
            "arima_predict": ("serving_predict:arima",
                              "arima_predict_kernel")}
    refit = hw_srv.ingest.refit
    tries = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        got, stop = {}, threading.Event()
        t_try = time.perf_counter()

        def capture():
            got["capture"] = http_call(
                hw, "GET", f"/debug/profile?seconds={RT_PROFILE_S}")

        def traffic():
            # paced, so the capture's host events stay few to export
            n = 0
            while not stop.wait(0.02):
                assert http_call(ar, "POST", "/invocations", payload)[0] == 200
                n += 1
            got["arima_requests"] = n

        th = threading.Thread(target=capture)
        th.start()
        time.sleep(0.5)  # the capture is running
        busy = http_call(ar, "GET", "/debug/profile?seconds=1")
        assert busy[0] == 409, busy[:2]
        tr = threading.Thread(target=traffic)
        tr.start()
        t0 = time.perf_counter()
        assert refit.maybe_refit(force=True) == "forced"
        done = refit.wait(timeout=120)
        refit_s = time.perf_counter() - t0
        th.join(120)
        stop.set()
        tr.join(120)
        assert not th.is_alive() and not tr.is_alive()
        status, body, _ = got["capture"]
        assert status == 200, body[:300]
        path = os.path.join(json.loads(body)["capture_dir"], "trace.json")
        found = {k: _annotation_encloses_kernel(path, name, kernel)
                 for k, (name, kernel) in want.items()}
        ok = all(f["device_timeline"] or f["host_timeline"]
                 for f in found.values())
        tries.append({"seconds": time.perf_counter() - t_try,
                      "kernels": {k: f["kernels"] for k, f in found.items()},
                      "enclosed": {k: f["device_timeline"]
                                   or f["host_timeline"]
                                   for k, f in found.items()}})
        if ok:
            break
    assert ok, (found, tries)
    return {"attempt": attempt, "tries": tries, "kernels": found,
            "refit_day_snap":
            done["day_snap"], "refit_wall_s": refit_s,
            "arima_requests_in_window": got["arima_requests"],
            "second_capture_status": busy[0]}


# (b) runs in a fresh process: late in the smoke's long process the
# capture kept the default stream's kernels and lost every record of the
# refit's own stream, three attempts running, while a fresh process keeps
# both (PERF.md, section 7); a process's first capture records no device
# activity at all, so the child takes a throwaway one first
RT_PROFILE_CHILD = r"""
import json, sys
import chip_smoke as cs
port = cs.load_port()
port["build"].library()
servers = {}
try:
    for model, path in json.loads(sys.argv[1]).items():
        with open(path) as f:
            conf = json.load(f)
        kw = port["serve_task"].ServeTask(init_conf=conf,
                                         device=sys.argv[2]).server_args()
        servers[model] = port["server"].start_server(**kw)
    tracer = port["trace"].get_tracer()
    tracer.profiler.capture(0.5)
    out = cs.rt_profile(servers)
    out["ring_kinds"] = sorted({s.name for s in tracer.recorder.snapshot()})
    out["launches"] = cs.hand_launches()
finally:
    for srv in servers.values():
        srv.shutdown()
print(json.dumps(out))
"""


def rt_profile_child(confs: dict, root: str, tmp: str):
    """(b) in a child process (RT_PROFILE_CHILD): both scorers started
    again from ``confs`` with their own WAL, store, stream and trace
    directories, then :func:`rt_profile`.  Starts the child and returns a
    function that waits for it and returns its report, the child's span
    kinds (``refit.swap`` among them) and launch counts."""
    import copy

    paths = {}
    for model, conf in confs.items():
        conf = copy.deepcopy(conf)
        conf["serving"]["ingest"]["wal_dir"] = os.path.join(
            root, f"wal_{model}_child")
        conf["monitoring"]["quality_store"]["directory"] = os.path.join(
            root, f"quality_{model}_child")
        conf["serving"]["anomaly"]["stream_store_dir"] = os.path.join(
            root, f"anomaly_{model}_child")
        conf["serving"]["tracing"].update(
            jsonl_path=None, profile_dir=os.path.join(tmp, "profile_child"),
            dump_dir=os.path.join(tmp, "dumps_child"))
        paths[model] = os.path.join(root, f"serve_{model}_child.json")
        with open(paths[model], "w") as f:
            json.dump(conf, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    # files, not pipes: the child logs every request while this process
    # is busy elsewhere, and a full pipe would stall it
    logs = [open(os.path.join(root, f"profile_child.{k}"), "w+")
            for k in ("out", "err")]
    proc = subprocess.Popen([sys.executable, "-c", RT_PROFILE_CHILD,
                             json.dumps(paths), DEVICE], cwd=ROOT, env=env,
                            stdout=logs[0], stderr=logs[1], text=True)

    def finish() -> dict:
        proc.wait(timeout=600)
        stdout, stderr = (f.seek(0) or f.read() for f in logs)
        for f in logs:
            f.close()
        if proc.returncode != 0:
            raise AssertionError(f"the profile child failed: {stderr[-4000:]}")
        out = json.loads(stdout.strip().splitlines()[-1])
        assert "refit.swap" in out["ring_kinds"], out["ring_kinds"]
        return out

    return finish


def rt_dump(servers: dict, tmp: str) -> dict:
    """(c) An arima /invocations held past RT_TIMEOUT_S (its predict waits
    on the forecaster's state lock, held here) answers 503 with
    Retry-After, and the handler leaves a ``flight-*-http-503`` dump with
    events once the response is written."""
    import re

    srv = servers["arima"]
    fc = srv.forecaster
    dumps = os.path.join(tmp, "dumps")
    before = set(os.listdir(dumps)) if os.path.isdir(dumps) else set()
    payload = {"inputs": _inputs(fc.keys[:1], fc.key_names), "horizon": 7}
    t0 = time.perf_counter()
    with fc._state_lock:
        status, body, head = http_call(srv.server_address[1], "POST",
                                       "/invocations", payload)
    waited = time.perf_counter() - t0
    assert status == 503 and head.get("Retry-After") == "1", (status, body)
    deadline = time.time() + 10
    new = []
    while time.time() < deadline and not new:
        new = [f for f in (set(os.listdir(dumps)) - before
                           if os.path.isdir(dumps) else ())
               if re.fullmatch(r"flight-\d{8}T\d{6}-\d+-http-503\.trace\.json",
                               f)]
        time.sleep(0.05)
    assert len(new) == 1, new
    with open(os.path.join(dumps, new[0])) as f:
        events = json.load(f)["traceEvents"]
    assert events
    return {"status": status, "waited_s": waited, "dump": new[0],
            "events": len(events)}


def rt_cost(port, servers: dict, card_line: str) -> dict:
    """(d) RT_COST_REPS direct predicts of the arima forecaster at each of
    RT_COST_SIZES (and 5 quantile predicts): the seconds the registry
    charged ``serving_predict:arima`` against CUDA events recorded at the
    same two host instants (the predictor's two clock reads: dispatch, and
    after the pulls), so every device interval the charge covers ends
    before its second event, within RT_DEVICE_SECONDS; the events around
    each whole predict call beside them; the pad rows charged equal to the
    sum of (bucket - k).  ``/debug/cost`` then has a row for every
    ``serving_predict*`` entry, and one scrape tick writes the
    ``dftpu_cost_*`` rows into the quality store."""
    from distributed_forecasting_tpu_torch.serving import predictor as pred

    cost = port["cost"]
    cm = cost.cost_metrics()
    srv = servers["arima"]
    fc = srv.forecaster
    entry = "serving_predict:arima"
    label = f"entry={entry},family=arima"
    pad_label = f"entry={entry},kind=pad"
    clock = pred.trace_clock
    out = {"sizes": {}}
    for k in RT_COST_SIZES:
        req = pd.DataFrame(fc.keys[:k], columns=list(fc.key_names))
        fc.predict(req, horizon=RT_HORIZON)  # warm
        torch.cuda.synchronize()
        s0 = cm.device_seconds_total.snapshot().get(label, 0.0)
        n0 = cm.dispatches_total.snapshot().get(label, 0.0)
        p0 = cm.padding_rows_total.snapshot().get(pad_label, 0.0)
        marks, whole = [], []

        def evented():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            return clock()

        pred.trace_clock = evented
        try:
            for _ in range(RT_COST_REPS):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fc.predict(req, horizon=RT_HORIZON)
                stop.record()
                whole.append((start, stop))
        finally:
            pred.trace_clock = clock
        torch.cuda.synchronize()
        assert len(marks) == 2 * RT_COST_REPS, len(marks)
        charged = cm.device_seconds_total.snapshot()[label] - s0
        n = cm.dispatches_total.snapshot()[label] - n0
        pads = cm.padding_rows_total.snapshot().get(pad_label, 0.0) - p0
        assert n == RT_COST_REPS, n
        bucket = fc._bucket(k)
        assert pads == RT_COST_REPS * (bucket - k), (k, pads)
        event_s = sum(marks[2 * i].elapsed_time(marks[2 * i + 1])
                      for i in range(RT_COST_REPS)) / 1e3
        whole_s = sum(a.elapsed_time(b) for a, b in whole) / 1e3
        ratio = charged / event_s
        lo, hi = RT_DEVICE_SECONDS
        assert lo <= ratio <= hi, (k, charged, event_s)
        out["sizes"][str(k)] = {
            "bucket": bucket, "pad_rows": pads,
            "charged_ms_per_predict": charged / n * 1e3,
            "events_ms_per_predict": event_s / n * 1e3,
            "whole_predict_events_ms": whole_s / n * 1e3,
            "charged_over_events": ratio,
            "charged_over_whole_predict": charged / whole_s}
    for _ in range(5):
        fc.predict_quantiles(pd.DataFrame(fc.keys[:5],
                                          columns=list(fc.key_names)),
                             quantiles=(0.1, 0.9), horizon=RT_HORIZON)
    status, body, _ = http_call(srv.server_address[1], "GET", "/debug/cost")
    assert status == 200, body[:300]
    rows = {r["entry"]: r for r in json.loads(body)["entries"]}
    entries = sorted(e for e in rows if e.startswith("serving_predict"))
    want = {f"serving_predict:{m}" for m in RT_FAMILIES} | {
        "serving_predict_quantiles:arima"}
    assert want <= set(entries), entries
    assert all(rows[e]["dispatches"] > 0 and rows[e]["device_seconds"] > 0
               for e in entries), [rows[e] for e in entries]
    out["debug_cost"] = {e: {"dispatches": rows[e]["dispatches"],
                             "device_seconds": rows[e]["device_seconds"]}
                         for e in entries}
    quality = servers["holt_winters"].quality
    at = time.time()
    quality.scrape.scrape_once(now=at)
    stored = [p for p in quality.store.query(since=at)
              if p["name"].startswith("dftpu_cost_")]
    names = {p["name"] for p in stored}
    assert {"dftpu_cost_device_seconds_total", "dftpu_cost_dispatches_total",
            "dftpu_cost_padding_rows_total",
            "dftpu_cost_watermark_device_bytes"} <= names, sorted(names)
    device_bytes = next(p["value"] for p in stored
                        if p["name"] == "dftpu_cost_watermark_device_bytes")
    assert device_bytes > 0
    out["store_rows"] = {"rows": len(stored), "names": sorted(names),
                         "device_bytes": device_bytes}
    emit("scorer_runtime_cost", card=card_line, **out)
    return out


def rt_latency(port, servers: dict, on_conf, card_line: str) -> dict:
    """(e) /invocations on the arima scorer at 1 and 500 series, horizon
    RT_LAT_HORIZON, RT_LAT_REQUESTS each with the shipped tracing block
    (``on_conf``) and with ``tracing.enabled: false``, flipped every
    RT_LAT_BLOCK requests over one keep-alive connection: p50 / p95.
    Beside them, what the predict path pays on every call either way: one
    ``device_annotation`` (``torch.profiler.record_function``, no profiler
    running) and one span, each timed over RT_ANNOTATION_CALLS calls."""
    import http.client

    trace = port["trace"]
    srv = servers["arima"]
    number, fc = srv.server_address[1], srv.forecaster
    out = {}
    try:
        for n in (1, fc.n_series):
            payload = {"inputs": _inputs(fc.keys[:n], fc.key_names),
                       "horizon": RT_LAT_HORIZON}
            ms = {"on": [], "off": []}
            conn = http.client.HTTPConnection("127.0.0.1", number,
                                              timeout=300)
            try:
                http_call(number, "POST", "/invocations", payload, conn=conn)
                for block in range(2 * RT_LAT_REQUESTS // RT_LAT_BLOCK):
                    mode = ("on", "off")[block % 2]
                    trace.configure_tracing(
                        on_conf if mode == "on"
                        else trace.TraceConfig(enabled=False))
                    for _ in range(RT_LAT_BLOCK):
                        t0 = time.perf_counter()
                        status = http_call(number, "POST", "/invocations",
                                           payload, conn=conn)[0]
                        ms[mode].append((time.perf_counter() - t0) * 1e3)
                        assert status == 200, status
            finally:
                conn.close()
            out[str(n)] = {m: _pcts(v) for m, v in ms.items()}
            out[str(n)]["p50_on_minus_off_ms"] = (
                out[str(n)]["on"]["p50_ms"] - out[str(n)]["off"]["p50_ms"])
        tracer = trace.configure_tracing(on_conf)
        off = trace.Tracer(trace.TraceConfig(enabled=False))
        per_call = {}
        for what, make in (
                ("device_annotation_us",
                 lambda: trace.device_annotation("serving_predict:arima")),
                ("span_on_us", lambda: tracer.span("serving.predict", k=1)),
                ("span_off_us", lambda: off.span("serving.predict", k=1))):
            t0 = time.perf_counter()
            for _ in range(RT_ANNOTATION_CALLS):
                with make():
                    pass
            per_call[what] = (time.perf_counter() - t0) / \
                RT_ANNOTATION_CALLS * 1e6
        out["per_call"] = per_call
    finally:
        trace.configure_tracing(trace.TraceConfig())
    emit("scorer_runtime_latency", card=card_line, horizon=RT_LAT_HORIZON,
         **out)
    return out


def slice20_phase(port, card_line: str) -> dict:
    """Phase 19: the scorer's runtime.  Holt-Winters (with its history
    sidecar, ``serving.ingest`` on) and arima fit on the committed
    dataset and served in this process from the shipped serve conf with
    the debug endpoints, a profile, dump and JSONL directory, batching and
    the anomaly scorer on (:func:`rt_serve_conf`), the launch counters set
    to 0 before the fits and read after (e).  (a) correlated span trees,
    (b) a profiler capture of a refit and arima traffic, (c) the 503 dump,
    (d) the cost charges against CUDA events, /debug/cost and the store
    rows, (e) /invocations with tracing on and off."""
    t_phase = time.perf_counter()
    trace = port["trace"]
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA),
                                   device=DEVICE)
    assert (batch.n_series, batch.n_time) == SHAPE
    root = tempfile.mkdtemp(prefix="scorer_rt_")
    tmp = os.path.join(root, "trace")
    servers, confs, out, seconds = {}, {}, {}, {}
    try:
        for k in KERNELS:  # counters to 0 just before the path
            wrapper(k).launches = 0
        arts = stream_artifacts(port, root, batch, families=RT_FAMILIES)
        for model in RT_FAMILIES:
            conf, changed = rt_serve_conf(port, root, model,
                                          arts[model]["name"], tmp)
            confs[model] = conf
            kw = port["serve_task"].ServeTask(
                init_conf=conf, device=DEVICE).server_args()
            assert (kw["ingest"] is not None) == (model == "holt_winters")
            servers[model] = port["server"].start_server(**kw)
        tracer = trace.get_tracer()
        on_conf = trace.TraceConfig.from_conf(
            port["config"].load_conf(SERVE_CONF)["serving"]["tracing"])
        assert tracer.config.debug_endpoints and tracer.config.enabled
        # (b)'s child boots and runs while (a) and (c), which time nothing,
        # run here; (d) and (e) time, so they wait for it
        t0 = time.perf_counter()
        profile = rt_profile_child(confs, root, tmp)
        seconds["profile_start"] = time.perf_counter() - t0
        for name, run in (
                ("trees", lambda: rt_trees(servers, batch)),
                ("dump", lambda: rt_dump(servers, tmp)),
                ("profile", profile),
                ("cost", lambda: rt_cost(port, servers, card_line)),
                ("latency", lambda: rt_latency(port, servers, on_conf,
                                               card_line))):
            t0 = time.perf_counter()
            out[name] = run()
            seconds[name] = time.perf_counter() - t0
        # this process's launches and the profile child's (its refit)
        child = out["profile"].pop("launches")
        out["launches"] = {k: n + child[k]
                           for k, n in hand_launches().items()}
        with open(os.path.join(tmp, "trace.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        out["jsonl"] = {"lines": len(lines),
                        "kinds": sorted({r["name"] for r in lines})}
        assert "http.request" in out["jsonl"]["kinds"], out["jsonl"]
    finally:
        for srv in servers.values():
            srv.shutdown()
        trace.configure_tracing(trace.TraceConfig())
        shutil.rmtree(root, ignore_errors=True)
    launches = out["launches"]
    emit("launches", path="scorer_runtime", **launches,
         expected="hw_score, hw_filter: the Holt-Winters fit and its forced "
                  "refit; arima_filter: the arima fit; arima_predict: every "
                  "arima predict")
    assert launches["hw_score"] >= 2 and launches["hw_filter"] >= 2
    assert launches["arima_filter"] >= 1
    assert launches["arima_predict"] >= RT_COST_REPS * len(RT_COST_SIZES)
    emit("scorer_runtime", card=card_line, trees=out["trees"],
         profile=out["profile"], dump=out["dump"], jsonl=out["jsonl"])
    out["seconds"] = time.perf_counter() - t_phase
    emit("phase19", seconds=out["seconds"], parts=seconds)
    return out


# -- phase 20: the serving fleet -----------------------------------------------

FLEET_HORIZON = 28          # /invocations horizon of (a), (c) and (d)
FLEET_SIZES = (1, 17, 500)
FLEET_LATENCY = {1: 20, 17: 20, 500: 20}  # sequential requests a size, leg
FLEET_STREAM = (15, 30)     # (d): keep-alive requests before / after the kill
FLEET_POINTS = 500          # (b): one ingest of this many points
FLEET_PROFILE_S = 2.0       # (c): the capture's window around the ingest
FLEET_BOOT_S = 600.0        # a replica on a cold store builds the library
# gauges whose value depends on the scraper's own connections
FLEET_OBSERVER_GAUGES = ("dftpu_http_workers_busy",)
FLEET_CONF = {"serving.fleet.enabled": True,
              "serving.fleet.replicas": 2,
              "serving.sharding.enabled": True,
              "serving.resilience.breaker_failures": 3,
              "serving.ingest.enabled": True,
              # a replica follows the shared WAL on an interval (the fleet
              # default); the single process applies in the POST
              "serving.ingest.apply_mode": None,
              "serving.ingest.refit.enabled": True,
              # (b)'s ingest is the backlog that forces (c)'s refit
              "serving.ingest.refit.max_applied_points": FLEET_POINTS,
              "serving.ingest.refit.max_staleness_s": 1e9,
              "serving.ingest.refit.check_interval_s": 0.5,
              "serving.tracing.debug_endpoints": True,
              "compile_cache.enabled": True}


def fleet_conf(port, root: str, name: str, number: int) -> dict:
    """The shipped serve conf for phase 20: :data:`FLEET_CONF` on top, the
    model, localhost, the front door on ``number``, and its own WAL,
    quality-store and profile directories under ``root``; the kernel store
    phase 18 filled (:data:`KERNEL_STORE`), or a fresh one under ``root``
    when phase 20 runs alone."""
    conf = port["config"].load_conf(SERVE_CONF)
    conf["env"] = {"root": root}
    conf["serving"].update(model_name=name, host="127.0.0.1", port=number)
    changed = {**FLEET_CONF,
               "serving.ingest.wal_dir": os.path.join(root, "wal_fleet"),
               "serving.tracing.profile_dir": os.path.join(root, "profile"),
               "monitoring.quality_store.directory":
                   os.path.join(root, "quality_fleet"),
               "compile_cache.directory": (KERNEL_STORE or
                                           os.path.join(root, "kernels"))}
    for key, value in changed.items():
        *path, last = key.split(".")
        node = conf
        for k in path:
            node = node[k]
        assert last in node, key  # only keys the shipped conf has
        node[last] = value
    return conf


class FleetProcess:
    """``python -m distributed_forecasting_tpu_torch.tasks.fleet`` as a
    child process in a session of its own (its replica children with it):
    started, polled through the front door, drained with SIGTERM, and the
    whole process group killed whatever happens in between."""

    def __init__(self, conf_path: str, number: int, log_path: str,
                 env: dict = None):
        self.conf_path, self.port, self.log_path = conf_path, number, log_path
        self.env = env or {}  # added to the task's (and its replicas')

    def __enter__(self):
        env = dict(os.environ, **self.env)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
        env["DFTPU_PLATFORM"] = "cpu" if DEVICE == "cpu" else "cuda"
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "distributed_forecasting_tpu_torch.tasks.fleet",
             "--conf-file", self.conf_path], cwd=ROOT, env=env,
            stdout=self.log, stderr=subprocess.STDOUT,
            start_new_session=True)
        self.t0 = time.perf_counter()
        return self

    def replicas(self) -> list:
        return json.loads(http_call(self.port, "GET", "/fleet")[1])[
            "replicas"]

    def wait(self, ready, timeout: float = FLEET_BOOT_S) -> list:
        """Poll ``/fleet`` until ``ready(replicas)``; connection refusals
        (the front door binds once a replica is ready) count as not
        yet.  Fails if the task exits or the wait runs out."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"the fleet task exited with {self.proc.returncode}: "
                    f"{self.log_tail()}")
            try:
                reps = self.replicas()
                if ready(reps):
                    return reps
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.05)
        raise AssertionError(f"the fleet was not ready in {timeout} s: "
                             f"{self.log_tail()}")

    def pid_of(self, replica_port: int) -> int:
        """The pid of the replica child serving ``replica_port`` (a child
        of the task whose ``--conf`` names the port, read from /proc)."""
        for pid in (int(d) for d in os.listdir("/proc") if d.isdigit()):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    ppid = int(f.read().rpartition(")")[2].split()[1])
                if ppid != self.proc.pid:
                    continue
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().split(b"\0")
            except (OSError, ValueError, IndexError):
                continue
            if b"--conf" in argv:
                rconf = json.loads(argv[argv.index(b"--conf") + 1])
                if int(rconf["port"]) == int(replica_port):
                    return pid
        raise AssertionError(f"no replica child on port {replica_port}")

    def log_text(self) -> str:
        self.log.flush()
        with open(self.log_path) as f:
            return f.read()

    def log_tail(self, n: int = 4000) -> str:
        return self.log_text()[-n:]

    def drain(self, timeout: float = 60.0) -> float:
        """SIGTERM the task (it drains the front door and every replica);
        returns the seconds the drain took."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        self.proc.wait(timeout)
        return time.perf_counter() - t0

    def __exit__(self, *exc):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                pass
        try:  # the task and any replica it left behind
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait(30)
        self.log.close()


def boot_lines(log: str, number: int) -> list:
    """The ready lines a replica on ``number`` logged (one a boot): the
    seconds from its ``main`` to ready, the stages' seconds, and
    compile-cache hits and misses."""
    import re

    out = []
    for m in re.finditer(
            rf"replica ready on 127\.0\.0\.1:{number} on (\S+) in "
            rf"([0-9.]+)s \(([^;]*); compile cache (\d+) hit\(s\), "
            rf"(\d+) miss\(es\)\)", log):
        stages = {k: float(v.rstrip("s")) for k, v in (
            part.split() for part in m.group(3).split(", ") if part)}
        out.append({"device": m.group(1), "seconds": float(m.group(2)),
                    "stages": stages, "cache_hits": int(m.group(4)),
                    "cache_misses": int(m.group(5))})
    return out


def drain_launches(log: str) -> list:
    """Each drained replica's hand-kernel launch counts (its drain line)."""
    import re

    return [json.loads(m.group(1)) for m in re.finditer(
        r"drained; hand-kernel launches in this process: (\{[^}]*\})", log)]


def fleet_points(fc, shard: int, num_shards: int, first_day: int,
                 n: int, seed: int) -> list:
    """``n`` ``/ingest`` records (``k`` / ``d`` form) for the series of one
    shard, day by day from ``first_day``, values from ``seed``."""
    from distributed_forecasting_tpu_torch.serving.sharding import (
        shard_of_key,
    )

    keys = [k for k in fc.keys.tolist() if shard_of_key(k, num_shards)
            == shard]
    rng = np.random.default_rng(seed)
    out = []
    day = first_day
    while len(out) < n:
        for k in keys[:n - len(out)]:
            out.append({"k": [int(v) for v in k], "d": day,
                        "y": float(np.round(rng.lognormal(3.5, 0.3)))})
        day += 1
    return out


def _metric(text: str, name: str) -> float:
    """Sum of every sample of ``name`` (any labels) in an exposition."""
    import re

    return sum(float(m.group(1)) for m in re.finditer(
        rf"^{name}(?:\{{[^}}]*\}})? (\S+)$", text, re.M))


def _samples_of(text: str) -> dict:
    return {line.rpartition(" ")[0]: float(line.rpartition(" ")[2])
            for line in text.splitlines()
            if line and not line.startswith("#")}


def fleet_requests(fc, size: int) -> dict:
    return {"inputs": _inputs(fc.keys[:size][::-1], fc.key_names),
            "horizon": FLEET_HORIZON}


def fleet_latency(front: int, direct: int, fc, card_line: str) -> dict:
    """(a)'s times: /invocations p50 / p95 at each size through the front
    door and straight to a replica, in turns; the scatter-gather
    overhead is the front door's p50 over the direct one."""
    out = {}
    for size, n in FLEET_LATENCY.items():
        req = fleet_requests(fc, size)
        ms = {"front_door": [], "direct": []}
        for _ in range(n):
            for leg, number in (("front_door", front), ("direct", direct)):
                t0 = time.perf_counter()
                status, body, _ = http_call(number, "POST", "/invocations",
                                            req)
                ms[leg].append((time.perf_counter() - t0) * 1e3)
                assert status == 200, body[:300]
        got = {leg: _pcts(v) for leg, v in ms.items()}
        got["overhead_p50_ms"] = (got["front_door"]["p50_ms"]
                                  - got["direct"]["p50_ms"])
        out[size] = got
    emit("fleet_latency", card=card_line, horizon=FLEET_HORIZON,
         sizes=out)
    return out


def fleet_refit(fleet, single, fc, replicas, num_shards: int) -> dict:
    """(b) and (c): one ``/ingest`` of FLEET_POINTS points for the series
    of one shard through the front door (and the same body to the single
    process) while replica 0 runs ``/debug/profile`` (a throwaway capture
    first: a process's first records no device activity).  Every owner
    applies the points; the backlog trigger (max_applied_points) forces a
    refit in each replica, whose capture must hold hw_score and hw_filter
    inside ``pipeline_dispatch:refit:backlog``.  A capture that misses
    them is taken again with the next days' points, up to
    TRACE_ATTEMPTS."""
    from distributed_forecasting_tpu_torch.serving.sharding import (
        shard_of_key,
    )

    r0 = replicas[0]["port"]
    shard = shard_of_key(fc.keys[0].tolist(), num_shards)
    owners = [r["port"] for r in replicas if shard in r["shards"]]
    t0 = time.perf_counter()
    status, body, _ = http_call(r0, "GET", "/debug/profile?seconds=0.5")
    assert status == 200, body[:300]
    seconds = {"throwaway_capture": time.perf_counter() - t0}
    want = {"hw_score": "hw_score_kernel", "hw_filter": "hw_filter_kernel"}
    tries, day = [], int(fc.day1) + 1
    refits0 = {p: _metric(http_call(p, "GET", "/metrics")[1].decode(),
                          "dftpu_ingest_refits_total") for p in owners}
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        points = fleet_points(fc, shard, num_shards, day, FLEET_POINTS,
                              seed=31 + attempt)
        day = max(p["d"] for p in points) + 1
        got = {}

        def capture():
            got["capture"] = http_call(
                r0, "GET", f"/debug/profile?seconds={FLEET_PROFILE_S}")

        th = threading.Thread(target=capture)
        t_cap = time.perf_counter()
        th.start()
        time.sleep(0.3)  # the capture is running
        t0 = time.perf_counter()
        status, body, headers = http_call(fleet.port, "POST", "/ingest",
                                          {"points": points})
        post_ms = (time.perf_counter() - t0) * 1e3
        assert status == 200, body[:300]
        ack = json.loads(body)
        assert ack["written"] == FLEET_POINTS, ack
        assert headers.get("X-Fleet-Shard") == str(shard), headers
        status, body, _ = http_call(single.server_address[1], "POST",
                                    "/ingest", {"points": points})
        assert status == 200 and json.loads(body)["written"] == \
            FLEET_POINTS, body[:300]
        th.join(60)
        assert not th.is_alive()
        seconds[f"capture_{attempt}"] = time.perf_counter() - t_cap
        status, body, _ = got["capture"]
        assert status == 200, body[:300]
        path = os.path.join(json.loads(body)["capture_dir"], "trace.json")
        found = {k: _annotation_encloses_kernel(
            path, "pipeline_dispatch:refit:backlog", kernel)
            for k, kernel in want.items()}
        ok = all(f["device_timeline"] or f["host_timeline"]
                 for f in found.values())
        tries.append({"post_ms": post_ms,
                      "kernels": {k: f["kernels"] for k, f in found.items()},
                      "enclosed": {k: f["device_timeline"]
                                   or f["host_timeline"]
                                   for k, f in found.items()}})
        if ok:
            break
    assert ok, (found, tries)
    # every owner applied every point and refit once an ingest; the single
    # process did the same
    t0 = time.perf_counter()
    deadline = time.perf_counter() + 60
    while True:
        texts = {p: http_call(p, "GET", "/metrics")[1].decode()
                 for p in owners}
        done = all(_metric(t, "dftpu_ingest_refits_total") - refits0[p]
                   >= attempt for p, t in texts.items())
        if done or time.perf_counter() > deadline:
            break
        time.sleep(0.1)
    assert done, {p: _metric(t, "dftpu_ingest_refits_total")
                  for p, t in texts.items()}
    applied = {}
    for p, t in texts.items():
        applied[p] = {
            "applied_points": _metric(t, "dftpu_ingest_applied_points_total"),
            "late_points": _metric(t, "dftpu_ingest_late_points_total"),
            "shard_points": _metric(t, "dftpu_shard_ingest_points_total"),
            "refits": _metric(t, "dftpu_ingest_refits_total")}
        assert applied[p]["shard_points"] == attempt * FLEET_POINTS, applied
        assert applied[p]["applied_points"] == attempt * FLEET_POINTS, \
            applied
    seconds["replica_refits"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refit = single.ingest.refit
    deadline = time.perf_counter() + 60
    while refit.snapshot()["refits_done"] < attempt and \
            time.perf_counter() < deadline:
        refit.wait(timeout=60)
        time.sleep(0.05)
    assert refit.snapshot()["refits_done"] >= attempt, refit.snapshot()
    seconds["single_refit"] = time.perf_counter() - t0
    return {"shard": shard, "owners": owners, "attempt": attempt,
            "seconds": seconds,
            "tries": tries, "applied": applied,
            "single_refits": refit.snapshot()["refits_done"],
            "kernels": found}


def fleet_equal(front: int, single: int, fc, when: str) -> dict:
    """Front-door /invocations bodies at 1, 17 and 500 series byte-equal
    to the single process's; the 1-series request routed to one shard,
    the others scattered."""
    out = {}
    for size in FLEET_SIZES:
        req = fleet_requests(fc, size)
        status, body, headers = http_call(front, "POST", "/invocations", req)
        want = http_call(single, "POST", "/invocations", req)
        assert status == want[0] == 200, body[:300]
        assert body == want[1], (when, size, len(body), len(want[1]))
        route = ("shard" if "X-Fleet-Shard" in headers
                 else f"scatter {headers.get('X-Fleet-Scatter')}")
        assert (route == "shard") == (size == 1), (size, headers)
        out[size] = {"bytes": len(body), "route": route}
    return out


def fleet_kill(fleet, fc, replicas, card_line: str) -> dict:
    """(d) and (e): one keep-alive client streams /invocations (1 and 17
    series in turns) through the front door; after FLEET_STREAM[0]
    requests replica 1 gets SIGKILL, and every request still answers 200
    on the same connection.  Replica 0 is killed when the stream ends, so
    each replica boots warm; both restarts are timed from the kill to
    ready in /fleet, their boots read from their ready lines, their kernel
    library a store hit with no miss."""
    import http.client
    import signal

    conn = http.client.HTTPConnection("127.0.0.1", fleet.port, timeout=300)
    reqs = [fleet_requests(fc, 1), fleet_requests(fc, 17)]
    statuses, killed, sockets = [], {}, set()
    victim = replicas[1]
    try:
        for i in range(sum(FLEET_STREAM)):
            if i == FLEET_STREAM[0]:
                pid = fleet.pid_of(victim["port"])
                os.kill(pid, signal.SIGKILL)
                killed[victim["index"]] = (time.perf_counter(), pid)
            status, _, headers = http_call(
                fleet.port, "POST", "/invocations", reqs[i % 2], conn=conn)
            assert headers.get("Connection", "").lower() != "close"
            statuses.append(status)
            # http.client dials again after a closed response: one local
            # address over the stream is one connection
            sockets.add(conn.sock.getsockname() if conn.sock else None)
    finally:
        conn.close()
    assert statuses == [200] * len(statuses), statuses
    assert len(sockets) == 1 and None not in sockets, sockets
    other = replicas[0]
    pid = fleet.pid_of(other["port"])
    os.kill(pid, signal.SIGKILL)
    killed[other["index"]] = (time.perf_counter(), pid)
    ready_at = {}
    t_end = time.perf_counter() + FLEET_BOOT_S
    while len(ready_at) < len(killed) and time.perf_counter() < t_end:
        try:
            for r in fleet.replicas():
                if (r["index"] in killed and r["index"] not in ready_at
                        and r["ready"] and r["restarts"] >= 1):
                    ready_at[r["index"]] = time.perf_counter()
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    assert len(ready_at) == len(killed), fleet.log_tail()
    log = fleet.log_text()
    out = {"stream_requests": len(statuses),
           "client_connections": len(sockets),
           "replicas": {}}
    for r in replicas:
        boots = boot_lines(log, r["port"])
        assert len(boots) == 2, (r["port"], boots)
        first, warm = boots
        text = http_call(r["port"], "GET", "/metrics")[1].decode()
        samples = _samples_of(text)
        outcomes = {o: samples.get(
            'compile_cache_entry_requests_total{entry="kernel_library",'
            f'outcome="{o}"}}', 0.0) for o in ("hit", "miss", "error")}
        if DEVICE == "cuda":  # the restart loaded the store's library
            assert (warm["cache_hits"], warm["cache_misses"]) == (1, 0), warm
            assert outcomes == {"hit": 1.0, "miss": 0.0, "error": 0.0}, \
                outcomes
        restart = ready_at[r["index"]] - killed[r["index"]][0]
        out["replicas"][r["index"]] = {
            "port": r["port"], "first_boot": first, "warm_boot": warm,
            "restart_to_ready_s": restart,
            # the respawn, the interpreter's start and the imports (and the
            # supervisor's next poll): the restart outside the boot's main
            "restart_outside_main_s": restart - warm["seconds"],
            "kernel_library_after_restart": outcomes}
    emit("fleet_restart", card=card_line, **out)
    return out


def fleet_front_door(fleet, replicas) -> dict:
    """(f): the fleet ``/metrics`` is ``aggregate_prometheus`` of the
    replicas' scrapes (every sample present; each value equal wherever
    the replicas' own values held still across the front door's scrape,
    :data:`FLEET_OBSERVER_GAUGES` aside) plus the supervisor's families, and the front-door process holds no
    CUDA context (its log line, and the count of ``nvidia-smi``'s compute
    processes)."""
    from distributed_forecasting_tpu_torch.serving.fleet import (
        aggregate_prometheus,
    )

    before = [http_call(r["port"], "GET", "/metrics")[1].decode()
              for r in replicas]
    front = http_call(fleet.port, "GET", "/metrics")[1].decode()
    after = [http_call(r["port"], "GET", "/metrics")[1].decode()
             for r in replicas]
    want = _samples_of(aggregate_prometheus(before))
    got = _samples_of(front)
    missing = sorted(set(want) - set(got))
    assert not missing, missing[:10]
    # busy workers count the connections open to a replica, which
    # depend on who scrapes: the front door's pooled legs or this client
    steady = [k for k in want if not k.startswith(FLEET_OBSERVER_GAUGES)
              and all(_samples_of(b).get(k) == _samples_of(a).get(k)
                      for b, a in zip(before, after))]
    differ = [k for k in steady if got[k] != want[k]]
    assert not differ, [(k, got[k], want[k]) for k in differ[:10]]
    assert "fleet_replicas_ready 2" in front
    notes = [line for line in fleet.log_text().splitlines()
             if "CUDA initialized in this process" in line]
    assert notes and all(line.endswith("CUDA initialized in this "
                                       "process: False)") for line in notes)
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True) if shutil.which("nvidia-smi") else None
    pids = ([int(p) for p in smi.stdout.split()]
            if smi is not None and smi.returncode == 0 else [])
    # this process and each replica hold a context; a container's pid
    # namespace may show every pid as 1, so the count is what tells
    if pids:
        assert fleet.proc.pid not in pids or set(pids) == {1}, pids
        assert len(pids) <= len(replicas) + 1, pids
    return {"samples": len(want), "steady_equal": len(steady),
            "moving": len(want) - len(steady),
            "front_door_log": notes[-1].rpartition("(")[2].rstrip(")"),
            "nvidia_smi_compute_processes": len(pids),
            "nvidia_smi_compute_pids": pids}


def slice21_phase(port, card_line: str) -> dict:
    """Phase 20: the serving fleet.  A Holt-Winters artifact of the
    committed dataset (uncut, history sidecar) registered in Staging; the
    fleet task started as a user starts it on the shipped serve conf with
    :data:`FLEET_CONF` (2 replicas, 8 shards x replication 2, ingest with
    refits, breakers after 3 failures, the kernel store phase 18 filled),
    beside a single ``tasks.serve`` scorer in this process on the same
    conf without the fleet.  (a) byte-equal bodies and latency, (b)-(c) the
    ingest and the refit in a replica, (d)-(e) kills and warm boots, (f)
    the front door, then a drain: each replica's launches from its drain
    line."""
    t_phase = time.perf_counter()
    trace = port["trace"]
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA),
                                   device=DEVICE)
    assert (batch.n_series, batch.n_time) == SHAPE
    root = tempfile.mkdtemp(prefix="fleet_")
    out, seconds, single = {}, {}, None
    try:
        art = stream_artifacts(port, root, batch,
                               families=("holt_winters",))["holt_winters"]
        number = free_port()
        conf = fleet_conf(port, root, art["name"], number)
        conf_path = os.path.join(root, "fleet.json")
        with open(conf_path, "w") as f:
            json.dump(conf, f)  # JSON is YAML
        with FleetProcess(conf_path, number,
                          os.path.join(root, "fleet.log")) as fleet:
            # the single process, meanwhile: the same conf, no fleet, its
            # own WAL and store, the library already loaded here
            sconf = json.loads(json.dumps(conf))
            sconf["serving"]["fleet"]["enabled"] = False
            sconf["serving"]["port"] = 0
            sconf["serving"]["tracing"]["debug_endpoints"] = False
            sconf["serving"]["ingest"].update(
                apply_mode="sync", wal_dir=os.path.join(root, "wal_single"))
            sconf["monitoring"]["quality_store"]["directory"] = \
                os.path.join(root, "quality_single")
            sconf["compile_cache"]["enabled"] = False
            kw = port["serve_task"].ServeTask(init_conf=sconf,
                                              device=DEVICE).server_args()
            single = port["server"].start_server(**kw)
            fc = single.forecaster
            t0 = time.perf_counter()
            replicas = fleet.wait(lambda reps: len(reps) == 2 and all(
                r["ready"] for r in reps))
            seconds["first_boot"] = time.perf_counter() - fleet.t0
            owned = sorted({k for r in replicas for k in r["shards"]})
            assert owned == list(range(conf["serving"]["sharding"][
                "num_shards"])), replicas
            num_shards = conf["serving"]["sharding"]["num_shards"]
            for name, run in (
                    ("forecasts", lambda: fleet_equal(
                        fleet.port, single.server_address[1], fc,
                        "before the ingest")),
                    ("latency", lambda: fleet_latency(
                        fleet.port, replicas[0]["port"], fc, card_line)),
                    ("refit", lambda: fleet_refit(
                        fleet, single, fc, replicas, num_shards)),
                    ("forecasts_after_refit", lambda: fleet_equal(
                        fleet.port, single.server_address[1], fc,
                        "after the refit")),
                    ("restart", lambda: fleet_kill(fleet, fc, replicas,
                                                   card_line)),
                    ("front_door", lambda: fleet_front_door(
                        fleet, replicas))):
                t0 = time.perf_counter()
                out[name] = run()
                seconds[name] = time.perf_counter() - t0
            # the restarted replicas replayed the shard WAL and refit on
            # its backlog: the forecasts still equal the single process's
            t0 = time.perf_counter()
            deadline = time.perf_counter() + 60
            while not all(_metric(http_call(r["port"], "GET", "/metrics")[
                    1].decode(), "dftpu_ingest_refits_total") >= 1
                    for r in replicas) and time.perf_counter() < deadline:
                time.sleep(0.1)
            out["forecasts_after_restart"] = fleet_equal(
                fleet.port, single.server_address[1], fc,
                "after the restarts")
            seconds["after_restart"] = time.perf_counter() - t0
            seconds["drain"] = fleet.drain()
            log = fleet.log_text()
        assert fleet.proc.returncode == 0, log[-3000:]
        launches = drain_launches(log)
        assert len(launches) == 2, log[-3000:]
        out["launches"] = {k: sum(d[k] for d in launches) for k in KERNELS}
        out["launches_by_replica"] = launches
    finally:
        if single is not None:
            single.shutdown()
        trace.configure_tracing(trace.TraceConfig())
        shutil.rmtree(root, ignore_errors=True)
    launches = out["launches"]
    emit("launches", path="fleet", **launches,
         expected="hw_score, hw_filter: one refit a replica after its "
                  "restart (the replayed backlog); the refits before the "
                  "kills died with their processes (the capture shows "
                  "them); arima_predict: none (a Holt-Winters artifact)")
    if DEVICE == "cuda":
        assert launches["hw_score"] >= 2 and launches["hw_filter"] >= 2
    out["seconds"] = time.perf_counter() - t_phase
    emit("fleet", card=card_line, forecasts=out["forecasts"],
         refit={k: out["refit"][k] for k in (
             "shard", "owners", "attempt", "tries", "applied",
             "single_refits", "seconds")},
         front_door=out["front_door"],
         after_restart=out["forecasts_after_restart"])
    emit("phase20", card=card_line, seconds=out["seconds"], parts=seconds)
    return out


# -- phase 21: the materialized forecast cache --------------------------------

CACHE_FAMILIES = ("arima", "holt_winters", "theta", "prophet")
CACHE_HORIZON = 90            # the shipped warmup horizon and phase 12's
CACHE_QSET = [0.1, 0.5, 0.9]  # the one quantile set served cached
CACHE_REBUILD_REPS = 3        # full-S rebuilds timed per signature
CACHE_LATENCY = {1: 20, 17: 20, 500: 20}  # requests a size and leg, (c)
CACHE_LOAD_SECONDS = 1.5      # each leg of (c)'s 32-client load
CACHE_HOT_KEYS = 64           # the keys (c)'s load draws, spread over S
CACHE_INGEST_DAYS = 6         # (d): one-day POSTs to each scorer


def cache_serve_conf(port, root: str, model: str, name: str, tag: str,
                     cache: bool, mmap_dir=None) -> dict:
    """The shipped serve conf for one scorer of phase 21: ``serving.cache``
    on (with the quantile set ``CACHE_QSET``) or off, the model, localhost,
    and the scorer's own quality-store (and, for Holt-Winters behind
    ``serving.ingest`` as phase 16 serves it, WAL) directories."""
    if model == "holt_winters":
        conf, _ = stream_serve_conf(port, root, f"{model}_{tag}", name)
    else:
        conf = port["config"].load_conf(SERVE_CONF)
        conf["env"] = {"root": root}
        conf["serving"].update(model_name=name, host="127.0.0.1", port=0)
        conf["monitoring"]["quality_store"]["directory"] = os.path.join(
            root, f"quality_{model}_{tag}")
    block = conf["serving"]["cache"]
    assert {"enabled", "quantile_sets", "mmap_dir"} <= set(block)
    block.update(enabled=cache, quantile_sets=[CACHE_QSET], mmap_dir=mmap_dir)
    return conf


class _CacheProbe:
    """Wraps a cache's rebuild and persist: the wall ms of each, whether
    each rebuild's predict ran on the default stream and on which thread,
    and rebuilds that raised (the metric does not count them)."""

    def __init__(self, cache):
        self.cache, self.rebuilds, self.persists = cache, [], []
        inner_rebuild, inner_persist = cache._rebuild_locked, cache._persist

        def rebuild(sig):
            before = cache.metrics.rebuilds.value
            default = (DEVICE != "cuda" or torch.cuda.current_stream()
                       == torch.cuda.default_stream())
            t0 = time.perf_counter()
            ok = inner_rebuild(sig)
            self.rebuilds.append({
                "sig": [sig[0], sig[1] is not None],
                "ms": (time.perf_counter() - t0) * 1e3, "published": ok,
                "error": cache.metrics.rebuilds.value == before,
                "default_stream": default,
                "thread": threading.current_thread().name})
            return ok

        def persist(entry):
            t0 = time.perf_counter()
            inner_persist(entry)
            self.persists.append((time.perf_counter() - t0) * 1e3)

        cache._rebuild_locked, cache._persist = rebuild, persist

    def check(self) -> None:
        bad = [r for r in self.rebuilds
               if r["error"] or not r["default_stream"]]
        assert not bad, (
            f"rebuilds that raised or left the default stream: {bad}")


def _cache_counts(cache) -> dict:
    m = cache.metrics
    return {"hits": m.hits.value, "rebuilds": m.rebuilds.value,
            "invalidations": m.invalidations.value,
            "evictions": m.evictions.value, "persists": m.persists.value,
            "loads": m.loads.value, "load_errors": m.load_errors.value,
            "misses": {r: m.misses.value(reason=r) for r in (
                "cold", "stale", "rebuilding", "bypass", "horizon_cap")}}


def cache_payloads(fc) -> dict:
    """``/invocations`` bodies of phase 21: 1, 17 and every series, point
    and ``CACHE_QSET`` quantiles, at ``CACHE_HORIZON``."""
    out = {}
    for n, inputs in scorer_requests(fc).items():
        out[f"{n}"] = {"inputs": inputs, "horizon": CACHE_HORIZON}
        out[f"{n}q"] = {"inputs": inputs, "horizon": CACHE_HORIZON,
                        "quantiles": CACHE_QSET}
    return out


def cache_equal(pairs: dict) -> dict:
    """(b) Every family's bodies byte-equal with the cache on (twice: the
    gather, then the encoded-body memo) and off, at 1, 17 and 500 series;
    a read served from the cache launches no kernel."""
    out = {}
    for model, (on, off) in pairs.items():
        payloads = cache_payloads(on.forecaster)
        for name, payload in payloads.items():
            status, want, _ = http_call(off.server_address[1], "POST",
                                        "/invocations", payload)
            assert status == 200, want[:300]
            for read in ("gather", "memo"):
                before = hand_launches()
                status, got, _ = http_call(on.server_address[1], "POST",
                                           "/invocations", payload)
                assert status == 200, got[:300]
                assert got == want, (model, name, read)
                if read == "memo":
                    assert hand_launches() == before, (model, name)
        counts = _cache_counts(on.cache)
        assert counts["rebuilds"] == 2 and counts["hits"] == 12, counts
        out[model] = {"bodies": list(payloads), **counts}
    return out


def _event_ms(fn) -> tuple:
    """(result, wall ms, CUDA-event ms on the current stream) of one
    ``fn()``; the event ms is None on the CPU."""
    if DEVICE == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        res = fn()
        stop.record()
        torch.cuda.synchronize()
        return (res, (time.perf_counter() - t0) * 1e3,
                start.elapsed_time(stop))
    t0 = time.perf_counter()
    res = fn()
    return res, (time.perf_counter() - t0) * 1e3, None


def cache_rebuilds(pairs: dict, card_line: str) -> dict:
    """(a) Full-S rebuild ms per family at ``CACHE_HORIZON``, point and
    quantile set: wall and CUDA-event medians of ``CACHE_REBUILD_REPS``;
    an arima rebuild launches arima_predict once."""
    out = {}
    for model, (on, _) in pairs.items():
        cache = on.cache
        for label, sig in (("point", (CACHE_HORIZON, None)),
                           ("quantiles", (CACHE_HORIZON, tuple(CACHE_QSET)))):
            wall, event = [], []
            for _ in range(CACHE_REBUILD_REPS):
                before = hand_launches()
                ok, w, e = _event_ms(lambda: cache.rebuild(sig))
                assert ok, (model, label)
                wall.append(w)
                event.append(e)
                if model == "arima" and DEVICE == "cuda":
                    after = hand_launches()
                    assert after["arima_predict"] == \
                        before["arima_predict"] + 1, (before, after)
            out.setdefault(model, {})[label] = {
                "wall_ms": statistics.median(wall),
                "cuda_event_ms": (None if None in event
                                  else statistics.median(event)),
                "bytes": cache._entries[sig].nbytes}
    emit("cache_rebuild", card=card_line, horizon=CACHE_HORIZON,
         series=SHAPE[0], reps=CACHE_REBUILD_REPS, **out)
    return out


def cache_latency(pairs: dict, card_line: str) -> dict:
    """(c) The arima scorer, cache on (encoded-body memo hits) against off
    (a dispatch: arima_predict, then the encoding): /invocations p50 / p95
    at 1, 17 and 500 series over one keep-alive connection each, in
    turns, after one untimed read of each size on each leg; then 32
    clients of 1-series requests for ``CACHE_LOAD_SECONDS`` against each,
    drawn from ``CACHE_HOT_KEYS`` keys (a dashboard's popular series),
    each memoized first.  (a) republished the entry, so the warm-up reads
    fill its memo; the timed and the loaded reads are asserted to be memo
    hits: the same entry, no memo added, no miss."""
    import http.client

    on, off = pairs["arima"]
    fc, cache = on.forecaster, on.cache
    sig = (CACHE_HORIZON, None)
    out = {}
    conns = {leg: http.client.HTTPConnection(
        "127.0.0.1", srv.server_address[1], timeout=300)
        for leg, srv in (("on", on), ("off", off))}

    def call(leg, payload):
        status = http_call(0, "POST", "/invocations", payload,
                           conn=conns[leg])[0]
        assert status == 200, status

    try:
        requests = {n: {"inputs": inputs, "horizon": CACHE_HORIZON}
                    for n, inputs in scorer_requests(fc).items()}
        for payload in requests.values():
            for leg in ("on", "off"):
                call(leg, payload)
        hot = np.unique(np.linspace(0, fc.n_series - 1,
                                    CACHE_HOT_KEYS).astype(int))
        for k in hot:  # the load's keys (row 0 is the 1-series request's)
            call("on", {"inputs": _inputs(fc.keys[[k]], fc.key_names),
                        "horizon": CACHE_HORIZON})
        entry = cache._entries[sig]
        memo = len(entry.body_memo)
        assert memo == len(hot) + 2, memo  # + the 17 and 500 subsets
        start = _cache_counts(cache)
        hits = 0
        for n, payload in requests.items():
            ms = {"on": [], "off": []}
            for _ in range(CACHE_LATENCY[n]):
                for leg in ("on", "off"):
                    t0 = time.perf_counter()
                    call(leg, payload)
                    ms[leg].append((time.perf_counter() - t0) * 1e3)
            hits += CACHE_LATENCY[n]
            out[str(n)] = {leg: _pcts(v) for leg, v in ms.items()}
            out[str(n)]["p50_off_over_on"] = (out[str(n)]["off"]["p50_ms"]
                                              / out[str(n)]["on"]["p50_ms"])
    finally:
        for conn in conns.values():
            conn.close()
    for leg, srv in (("on", on), ("off", off)):
        out[f"load_{leg}"], _ = scorer_load(
            srv.server_address[1], fc.keys[hot], fc.key_names,
            keep_bodies=False, seconds=CACHE_LOAD_SECONDS)
    hits += out["load_on"]["requests"]
    end = _cache_counts(cache)
    assert cache._entries[sig] is entry and len(entry.body_memo) == memo
    assert end["hits"] - start["hits"] == hits, (start, end, hits)
    assert end["misses"] == start["misses"], (start, end)
    out["memo_hits"] = hits
    emit("cache_latency", card=card_line, model="arima",
         horizon=CACHE_HORIZON, **out)
    return out


def cache_writes(port, pairs: dict, batch, card_line: str) -> dict:
    """(d) The Holt-Winters scorers behind ``serving.ingest``: one-day
    POSTs to the cache-on and cache-off scorer in turns (the apply pays
    the rebuilds on the writer's thread), then a forced refit in the
    cache-on one.  After every write the first reads (17 and 500 series,
    point and quantiles) equal ``_encode_predictions`` of a fresh
    dispatch on the new state, and the cache-off scorer's bodies."""
    on, off = pairs["holt_winters"]
    fc, encode = on.forecaster, port["server"]._encode_predictions
    probe = on.cache._probe
    swaps, writers = [], []
    inner_swap = fc.swap_state

    def swap_state(*a, **k):  # the install, then the listeners' rebuilds
        t0 = time.perf_counter()
        inner_swap(*a, **k)
        swaps.append((time.perf_counter() - t0) * 1e3)
        writers.append(threading.current_thread().name)

    fc.swap_state = swap_state
    payloads = {k: v for k, v in cache_payloads(fc).items()
                if int(k.rstrip("q")) > 1}  # 17 and every series

    def fresh_reads(when: str) -> int:
        # each read a hit on the republished frame, not a dispatch
        start = _cache_counts(on.cache)
        for name, payload in payloads.items():
            req = pd.DataFrame([[r[k] for k in fc.key_names]
                                for r in payload["inputs"]],
                               columns=list(fc.key_names))
            if "quantiles" in payload:
                want = encode(fc.predict_quantiles(
                    req, quantiles=tuple(CACHE_QSET),
                    horizon=CACHE_HORIZON), fc.key_names)
            else:
                want = encode(fc.predict(req, horizon=CACHE_HORIZON),
                              fc.key_names)
            got = http_call(on.server_address[1], "POST", "/invocations",
                            payload)[1]
            assert got == want, (when, name)
            assert http_call(off.server_address[1], "POST", "/invocations",
                             payload)[1] == want or when == "refit", (
                when, name)
        end = _cache_counts(on.cache)
        assert end["hits"] - start["hits"] == len(payloads), (when, end)
        assert end["misses"] == start["misses"], (when, start, end)
        return len(payloads)

    tail = stream_tail(batch, CACHE_INGEST_DAYS)
    day1 = int(fc.day1)
    ms = {"on": [], "off": []}
    before = _cache_counts(on.cache)
    first_rebuild = len(probe.rebuilds)
    for d in range(CACHE_INGEST_DAYS):
        points = day_points(fc, day1 + 1 + d, tail[:, d:d + 1])
        for leg, srv in (("on", on), ("off", off)):
            status, ack, t = _post_ms(srv.server_address[1], "/ingest",
                                      {"points": points})
            assert status == 200 and ack["applied"]["points"] == len(points)
            ms[leg].append(t)
        if d == 0:
            checked = fresh_reads("ingest")
    after_ingest = _cache_counts(on.cache)
    refit = on.ingest.refit
    n_swaps = len(swaps)
    t0 = time.perf_counter()
    assert refit.maybe_refit(force=True) == "forced"
    refit.wait(timeout=600)
    refit_s = time.perf_counter() - t0
    assert len(swaps) == n_swaps + 1, "the refit installed no state"
    checked += fresh_reads("refit")
    after_refit = _cache_counts(on.cache)
    # the refit's install rebuilt both entries on the writer's thread
    refit_rebuilds = probe.rebuilds[-2:]
    assert [r["thread"] for r in refit_rebuilds] == [writers[-1]] * 2, (
        refit_rebuilds, writers[-1])
    # every write's rebuilds published: none superseded or refused
    written = probe.rebuilds[first_rebuild:]
    assert len(written) == 2 * (CACHE_INGEST_DAYS + 1), written
    assert all(r["published"] for r in written), written
    out = {
        "ingest_ms": {leg: _pcts(v) for leg, v in ms.items()},
        "ingest_p50_on_minus_off_ms": (np.percentile(ms["on"], 50)
                                       - np.percentile(ms["off"], 50)),
        "swap_to_republished_ms": {"ingest": swaps[:n_swaps],
                                   "refit": swaps[n_swaps]},
        "ingest": {k: after_ingest[k] - before[k]
                   for k in ("invalidations", "rebuilds")},
        "refit": {k: after_refit[k] - after_ingest[k]
                  for k in ("invalidations", "rebuilds")},
        "refit_seconds": refit_s,
        "writer_threads": {"ingest": sorted(set(writers[:n_swaps])),
                           "refit": writers[-1]},
        "reads_checked": checked}
    assert out["ingest"]["invalidations"] == 2 * CACHE_INGEST_DAYS, out
    assert out["refit"]["invalidations"] == 2, out
    emit("cache_writes", card=card_line, **out)
    return out


def cache_persist(port, root: str, art: dict, batch,
                  card_line: str) -> dict:
    """(e) The theta scorer with ``serving.cache.mmap_dir`` set: persist ms
    and bytes of its two 500-series entries; the task restarted on the
    same registered state adopts both (its ms) and serves them with no
    rebuild, byte-equal; a copy of one frame is discarded by a cache over
    the state a streaming apply of one day moved to."""
    serving, server = port["serving"], port["server"]
    mmap_dir = os.path.join(root, "cache_persist")

    def task_args(tag):
        conf = cache_serve_conf(port, root, "theta", art["name"], tag, True,
                                mmap_dir=mmap_dir)
        return port["serve_task"].ServeTask(init_conf=conf,
                                            device=DEVICE).server_args()

    kw = task_args("persist")
    probe = _CacheProbe(kw["cache"])
    first = server.start_server(**kw)
    S = first.forecaster.n_series
    payloads = {k: v for k, v in cache_payloads(first.forecaster).items()
                if int(k.rstrip("q")) == S}  # every series, both entries
    try:
        bodies = {k: http_call(first.server_address[1], "POST",
                               "/invocations", p)[1]
                  for k, p in payloads.items()}
    finally:
        first.shutdown()
    probe.check()
    files = sorted(os.listdir(mmap_dir))
    assert len(files) == 4 and len(probe.persists) == 2, files
    sizes = {}
    for f in files:
        stem = f.split(".")[0]
        sizes[stem] = sizes.get(stem, 0) + os.path.getsize(
            os.path.join(mmap_dir, f))
    adopt = {}
    inner = serving.ForecastCache._load_persisted

    def timed(self):
        t0 = time.perf_counter()
        inner(self)
        adopt["ms"] = (time.perf_counter() - t0) * 1e3

    serving.ForecastCache._load_persisted = timed
    try:  # the restart: a new task over the same registered version
        kw = task_args("restart")
    finally:
        serving.ForecastCache._load_persisted = inner
    cache = kw["cache"]
    assert (cache.metrics.loads.value, cache.metrics.load_errors.value) \
        == (2, 0), _cache_counts(cache)
    second = server.start_server(**kw)
    try:
        for k, p in payloads.items():
            got = http_call(second.server_address[1], "POST",
                            "/invocations", p)[1]
            assert got == bodies[k], k
        assert cache.metrics.rebuilds.value == 0
        assert cache.metrics.hits.value == len(payloads)
    finally:
        second.shutdown()
    # changed state: one streamed day moves the artifact's state; a cache
    # over it boots on a copy of the persisted point frame
    stale = os.path.join(root, "cache_stale")
    os.makedirs(stale)
    for suffix in (".npy", ".meta.json"):
        shutil.copy(os.path.join(mmap_dir, f"h{CACHE_HORIZON}{suffix}"),
                    stale)
    moved = serving.BatchForecaster.load(art["artifact"], device=DEVICE)
    store = port["state_store"].SeriesStateStore(
        moved, time_bucket=STREAM_BUCKET, history_y=batch.y.cpu().numpy(),
        history_mask=batch.mask.cpu().numpy(), device=DEVICE)
    tail = stream_tail(batch, 1)
    store.ingest(store_points(moved.day1 + 1, tail))
    assert store.apply_pending()["points"] == moved.n_series
    discarded = serving.build_forecast_cache(
        {"enabled": True, "mmap_dir": stale}, moved)
    assert (discarded.metrics.loads.value,
            discarded.metrics.load_errors.value) == (0, 1)
    assert os.listdir(stale) == []
    out = {"persist_ms": probe.persists, "bytes_by_entry": sizes,
           "adopt_ms": adopt["ms"], "adopted": 2, "discarded_stale": 1,
           "restart_rebuilds": 0}
    emit("cache_persist", card=card_line, series=SHAPE[0], **out)
    return out


def cache_fleet_conf(port, root: str, name: str, number: int,
                     cache: bool) -> dict:
    """The shipped serve conf as a fleet of 2 replicas (no sharding, no
    ingest, as shipped) on the front door ``number``, with the cache on
    (``mmap_dir`` unset: each replica persists under its own
    ``<artifact_dir>/forecast_cache/replica-<port>``) or off, and the
    kernel library loaded from this checkout's build directory (the
    compile-cache store off: this process built it)."""
    conf = port["config"].load_conf(SERVE_CONF)
    conf["env"] = {"root": root}
    conf["serving"].update(model_name=name, host="127.0.0.1", port=number)
    conf["serving"]["fleet"].update(enabled=True, replicas=2)
    conf["serving"]["cache"].update(enabled=cache,
                                    quantile_sets=[CACHE_QSET])
    conf["monitoring"]["quality_store"]["directory"] = os.path.join(
        root, f"quality_fleet_{'on' if cache else 'off'}")
    conf["compile_cache"]["enabled"] = False
    return conf


def cache_fleet(fleets: dict, fc, art_dir: str) -> dict:
    """(f) The two fleets, cache on and off: front-door bodies byte-equal
    at 1, 17 and 500 series, point and quantiles, each request twice on
    (round-robin puts it on both replicas); each cache-on replica
    persisted into its own ``replica-<port>`` directory; the front door's
    ``/metrics`` max-merges ``dftpu_cache_entry_age_seconds`` and sums the
    hits of the replicas' scrapes."""
    reps = {leg: f.wait(lambda r: len(r) == 2 and all(x["ready"]
                                                       for x in r))
            for leg, f in fleets.items()}
    on, off = fleets["on"].port, fleets["off"].port
    for name, payload in cache_payloads(fc).items():
        want = http_call(off, "POST", "/invocations", payload)
        assert want[0] == 200, want[1][:300]
        for _ in range(2):
            got = http_call(on, "POST", "/invocations", payload)
            assert got[:2] == want[:2], name
    dirs = {}
    for r in reps["on"]:
        d = os.path.join(art_dir, "forecast_cache", f"replica-{r['port']}")
        dirs[r["port"]] = sorted(os.listdir(d))
        assert len(dirs[r["port"]]) == 4, dirs  # 2 entries: npy + meta
    scrapes = [http_call(r["port"], "GET", "/metrics")[1].decode()
               for r in reps["on"]]
    front = http_call(on, "GET", "/metrics")[1].decode()
    ages = [_metric(t, "dftpu_cache_entry_age_seconds") for t in scrapes]
    merged = _metric(front, "dftpu_cache_entry_age_seconds")
    hits = [_metric(t, "dftpu_cache_hits_total") for t in scrapes]
    # the max of the replicas' ages, read a few ms later; a sum would sit
    # a whole min(ages) above it
    assert min(ages) > 0 and abs(merged - max(ages)) < min(ages), (
        merged, ages)
    assert _metric(front, "dftpu_cache_hits_total") == sum(hits) > 0
    assert _metric(front, "dftpu_cache_entries") == 4
    return {"bodies": len(cache_payloads(fc)), "replica_dirs": dirs,
            "entry_age_s": {"replicas": ages, "front_door": merged},
            "hits": hits}


def slice22_phase(port, card_line: str, before_timing=None) -> dict:
    """Phase 21: the materialized forecast cache.  arima, Holt-Winters
    (history sidecar, ``serving.ingest`` on), theta and the curve model
    fit on the committed dataset and served in this process by the serve
    task from the shipped conf twice, ``serving.cache`` on (quantile set
    ``CACHE_QSET``) and off (:func:`cache_serve_conf`), the launch
    counters set to 0 before the fits and read after (f); two fleets of
    the theta artifact boot meanwhile.  (b) byte-equal bodies, (f) the
    fleets, ``before_timing()`` (``main`` passes a wait for phase 23's
    fleets, which boot beside these), then the timed parts: (a) rebuilds,
    (c) hit against dispatch, (d) writes, (e) persistence."""
    t_phase = time.perf_counter()
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA),
                                   device=DEVICE)
    assert (batch.n_series, batch.n_time) == SHAPE
    root = tempfile.mkdtemp(prefix="cache_")
    pairs, out, seconds, probes = {}, {}, {}, []
    try:
        for k in KERNELS:  # counters to 0 just before the path
            wrapper(k).launches = 0
        t0 = time.perf_counter()
        # theta first: the fleets boot on it while the rest fit
        arts = stream_artifacts(port, root, batch, families=("theta",))
        theta = arts["theta"]
        registry = port["tracking"].ModelRegistry(
            os.path.join(root, "registry"))
        art_dir = registry.latest_version(theta["name"]).artifact_dir
        fleets = {}
        with contextlib.ExitStack() as stack:
            for leg in ("on", "off"):
                number = free_port()
                path = os.path.join(root, f"fleet_{leg}.json")
                with open(path, "w") as f:
                    json.dump(cache_fleet_conf(port, root, theta["name"],
                                               number, leg == "on"), f)
                fleets[leg] = stack.enter_context(FleetProcess(
                    path, number, os.path.join(root, f"fleet_{leg}.log")))
            arts.update(stream_artifacts(
                port, root, batch,
                families=tuple(f for f in CACHE_FAMILIES if f != "theta")))
            seconds["fits"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for model in CACHE_FAMILIES:
                servers = []
                for leg in ("on", "off"):
                    conf = cache_serve_conf(port, root, model,
                                            arts[model]["name"], leg,
                                            leg == "on")
                    kw = port["serve_task"].ServeTask(
                        init_conf=conf, device=DEVICE).server_args()
                    assert (kw["cache"] is not None) == (leg == "on")
                    servers.append(port["server"].start_server(**kw))
                pairs[model] = tuple(servers)
                probe = _CacheProbe(servers[0].cache)
                servers[0].cache._probe = probe
                probes.append(probe)
            seconds["servers"] = time.perf_counter() - t0
            for name, run in (
                    ("equal", lambda: cache_equal(pairs)),
                    ("fleet", lambda: cache_fleet(
                        fleets, pairs["theta"][0].forecaster, art_dir))):
                t0 = time.perf_counter()
                out[name] = run()
                seconds[name] = time.perf_counter() - t0
            seconds["fleet_boot"] = time.perf_counter() - fleets["on"].t0
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(fleets)) as pool:
                drains = dict(zip(fleets, pool.map(lambda f: f.drain(),
                                                   fleets.values())))
            seconds["fleet_drain"] = time.perf_counter() - t0
            logs = {leg: f.log_text() for leg, f in fleets.items()}
        for leg, f in fleets.items():
            assert f.proc.returncode == 0, logs[leg][-3000:]
        fleet_launches = [d for log in logs.values()
                          for d in drain_launches(log)]
        assert len(fleet_launches) == 4, logs["on"][-3000:]
        out["fleet"]["drain_seconds"] = drains
        if before_timing is not None:
            t0 = time.perf_counter()
            before_timing()
            seconds["before_timing"] = time.perf_counter() - t0
        for name, run in (
                ("rebuild", lambda: cache_rebuilds(pairs, card_line)),
                ("latency", lambda: cache_latency(pairs, card_line)),
                ("writes", lambda: cache_writes(port, pairs, batch,
                                                card_line)),
                ("persist", lambda: cache_persist(port, root, theta, batch,
                                                  card_line))):
            t0 = time.perf_counter()
            out[name] = run()
            seconds[name] = time.perf_counter() - t0
        for probe in probes:
            probe.check()
        out["rebuild_calls"] = sum(len(p.rebuilds) for p in probes)
        out["launches"] = {k: n + sum(d[k] for d in fleet_launches)
                           for k, n in hand_launches().items()}
    finally:
        for srv in (s for pair in pairs.values() for s in pair):
            srv.shutdown()
        port["trace"].configure_tracing(port["trace"].TraceConfig())
        shutil.rmtree(root, ignore_errors=True)
    launches = out["launches"]
    emit("launches", path="forecast_cache", **launches,
         expected="hw_score, hw_filter: the Holt-Winters fit and its forced "
                  "refit; arima_filter: the arima fit; arima_predict: every "
                  "arima dispatch and cache rebuild (a cached read "
                  "launches none)")
    if DEVICE == "cuda":
        assert launches["hw_score"] >= 2 and launches["hw_filter"] >= 2
        assert launches["arima_filter"] >= 1
        assert launches["arima_predict"] >= 2 * CACHE_REBUILD_REPS
    out["seconds"] = time.perf_counter() - t_phase
    emit("forecast_cache", card=card_line, equal=out["equal"],
         fleet=out["fleet"], rebuild_calls=out["rebuild_calls"])
    emit("phase21", card=card_line, seconds=out["seconds"], parts=seconds)
    return out


# -- phase 22: parallel/* over torch.distributed -----------------------------

PAR_WORLD = 2              # (b): two processes on the one card, over gloo
PAR_SCAN_T = 1 << 20       # (b): one series of two years of minutes
PAR_SCAN_SEED = 29
PAR_HW = (0.3, 0.1, 0.2, 7)               # alpha, beta, gamma, m
PAR_ARMA = ((0.6, -0.2), (0.3,))          # phi, theta of the Kalman case
PAR_RANK_TIMEOUT_S = 600.0
PAR_KERNELS = ("hw_score", "hw_filter", "arima_filter", "arima_predict")
# tolerances, each the reference's own for the same comparison: the affine
# scan's the multi-host worker's bound (max abs), the Holt-Winters and
# Kalman filters' its time-sharded tests' (rtol, atol); the MSE and the
# likelihood sums against the sequential filter's own per-step terms
# summed in float64 (a sequential float32 sum over 2^20 steps is not a
# reference).  Holt-Winters' level and season are held as l + s_j, what
# the forecasts read, at the level's tolerance: the additive state has an
# invariant direction (level + d, every season - d; eigenvalue 1) along
# which float32 rounding is never damped, so over 2^20 steps l and s drift
# apart by equal and opposite amounts in both filters (0.028 in the level
# on the card, PERF.md), while l + s_j stays within ~1e-6 of float64
PAR_AFFINE_ATOL = 1e-3
PAR_HW_TOL = {"preds": (1e-3, 1e-2), "l_plus_s": (1e-4, 0.0),
              "b": (1e-3, 1e-4), "mse": (1e-4, 0.0)}
PAR_KALMAN_TOL = {"ssq": (1e-3, 0.0), "ldet": (1e-3, 1e-3),
                  "preds": (1e-3, 1e-3), "Fs": (1e-3, 1e-4),
                  "a_T": (1e-3, 1e-3), "P_T": (1e-3, 1e-4)}
PAR_MAPE_RTOL = 1e-4      # the reference's: 2 ranks' mean against 1 process
PAR_MEAN_RTOL = 1e-5      # float32 tree sums of 500 against float64
PAR_WIN_TOL = 2e-4        # the reference's windowed mesh case


def par_scan_inputs(T: int, device) -> dict:
    """The time-sharded scans' one series of T steps, from a seed, float32
    on ``device``: an affine problem (spectral radius below 1, the
    reference's), a weekly series with a trend and a 1,000-step gap across
    the ranks' boundary, and an ARMA(2, 1) series with another."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(PAR_SCAN_SEED)
    d = 3
    A = (0.9 * rng.uniform(-1, 1, (T, d, d)) / d
         + 0.5 * np.eye(d)).astype(np.float32)
    c = rng.normal(size=(T, d)).astype(np.float32)
    x0 = rng.normal(size=d).astype(np.float32)
    t = np.arange(T)
    y = (50 + 1e-5 * t + 8 * np.sin(2 * np.pi * t / PAR_HW[3])
         + rng.normal(0, 1.5, T))
    ymask = np.ones(T, np.float32)
    ymask[T // 2 - 500:T // 2 + 500] = 0.0
    (p1, p2), (t1,) = PAR_ARMA
    z = lfilter([1.0, t1], [1.0, -p1, -p2], rng.normal(0, 1.0, T + 50))[50:]
    zmask = np.ones(T, np.float32)
    zmask[T // 2 - 300:T // 2 + 200] = 0.0
    out = dict(A=A, c=c, x0=x0, y=(y * ymask)[None], ymask=ymask[None],
               z=(z * zmask)[None], zmask=zmask[None])
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in out.items()}


def par_kalman_system(port, S: int, device):
    """T_mat, RRt, P0 of the ARMA(2, 1) case for ``S`` rows, and (phi,
    theta, r)."""
    ar = port["arima"]
    ph = torch.tensor([PAR_ARMA[0]] * S, device=device)
    th = torch.tensor([PAR_ARMA[1]] * S, device=device)
    r = max(len(PAR_ARMA[0]), len(PAR_ARMA[1]) + 1)
    T_mat, _ = ar._build_ssm(ph, th, r)
    p_pad, _, RRt = ar._model(ph, th, r)
    return (T_mat, RRt, ar._init_cov(p_pad, RRt)), (ph, th, r)


class _CollectiveClock:
    """Wall seconds and calls of the port's two collectives in this process
    (``parallel/mesh.all_reduce_sum`` / ``all_gather_rows``), each timed
    between device synchronizations: installed by patching the names every
    caller reads."""

    def __init__(self, sync):
        from distributed_forecasting_tpu_torch.parallel import mesh, sharded

        self.sync = sync
        self.seconds, self.calls = 0.0, 0
        self._patched = []
        for mod, name in ((mesh, "all_reduce_sum"), (mesh, "all_gather_rows"),
                          (sharded, "all_reduce_sum")):
            fn = getattr(mod, name)
            self._patched.append((mod, name, fn))
            setattr(mod, name, self._timed(fn))

    def _timed(self, fn):
        def timed(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        return timed

    def reset(self) -> None:
        self.seconds, self.calls = 0.0, 0


def parallel_rank(plan: dict) -> dict:
    """One rank of (b): brought up through ``initialize_distributed`` (what
    the ``distributed:`` block calls), the library loaded from the build the
    parent made (no ``nvcc``), then each step of the reference's multi-host
    scenario at full width, timed with its collectives.  Writes its arrays
    to ``rank<r>.npz`` in ``plan["out"]`` and returns its report."""
    global DEVICE
    DEVICE = plan["device"]  # what ar2_batch places on
    port = load_port()
    from distributed_forecasting_tpu_torch import parallel as par
    from distributed_forecasting_tpu_torch.ops import metrics as M
    from distributed_forecasting_tpu_torch.ops import pkalman, pscan
    from distributed_forecasting_tpu_torch.parallel import mesh as pmesh
    from distributed_forecasting_tpu_torch.parallel.distributed import (
        host_local_frame,
    )
    import torch.distributed as dist

    rank, world = plan["rank"], plan["world"]
    dev_arg = "cpu" if plan["device"] == "cpu" else None
    par.initialize_distributed(f"127.0.0.1:{plan['port']}", world, rank,
                               device=dev_arg)
    dev = pmesh._RANK_DEVICE
    t0 = time.perf_counter()
    if dev.type == "cuda":
        port["build"].library()
    library_s = time.perf_counter() - t0
    mesh = par.make_mesh(world)
    # from the parent's spawn to a rank with its group, mesh and library
    ready_s = time.time() - plan["spawned_at"]
    group = pmesh.mesh_group(mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for k in KERNELS:
        wrapper(k).launches = 0
    clock = _CollectiveClock(sync)
    steps, arrays = {}, {}

    def step(name, fn):
        clock.reset()
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t
        steps[name] = {"wall_s": wall, "collective_s": clock.seconds,
                       "collectives": clock.calls,
                       "collective_share": clock.seconds / wall}
        return out

    eng, data = port["engine"], port["data"]
    df = data.load_sales_csv(plan["data"])
    H = plan["horizon"]

    def local_fit():
        # the reference's worker: this rank's hash-owned series, tensorized
        # alone, fit, and the global mean MAPE through one all-reduce
        b = data.tensorize(host_local_frame(df), device=dev)
        _, res = eng.fit_forecast(b, "holt_winters", horizon=H)
        mape = M.mape(b.y, res.yhat[:, :b.n_time], b.mask)
        tot = pmesh.all_reduce_sum(torch.stack(
            [mape.sum(), torch.tensor(float(mape.shape[0]), device=dev)]),
            group)
        return b.n_series, bool(res.ok.all()), float(tot[0] / tot[1])

    n_local, local_ok, mape_mean = step("host_local_fit", local_fit)
    batch = data.tensorize(df, device=dev)
    assert (batch.n_series, batch.n_time) == tuple(plan["shape"])
    _, res = step("sharded_fit", lambda: par.sharded_fit_forecast(
        batch, "holt_winters", horizon=H, mesh=mesh))
    cvm = step("sharded_cv", lambda: par.sharded_cv_metrics(
        batch, "holt_winters", cv=port["cv"].CVConfig(**plan["cv"]),
        mesh=mesh))
    ok = torch.ones(cvm["mape"].shape[0], dtype=torch.bool, device=dev)
    means = step("global_means", lambda: par.global_metric_means(
        cvm, ok, mesh))
    arrays["bottoms"] = step(
        "gather_bottoms", lambda: port["reconcile"].gather_bottom_sharded(
            res.yhat, mesh, "series")).cpu().numpy()

    T = plan["scan_t"]
    inp = par_scan_inputs(T, dev)
    mine = slice(rank * T // world, (rank + 1) * T // world)
    blk = T // world  # one associative scan of the rank's steps
    arrays["affine"] = step(
        "affine_scan_time_sharded", lambda: pscan.affine_scan_time_sharded(
            inp["A"][mine], inp["c"][mine], inp["x0"], mesh,
            block_size=blk)).cpu().numpy()
    a, b_, g, m = PAR_HW
    (l, bb, s), mse, preds = step(
        "hw_filter_time_sharded",
        lambda: port["hw"].parallel_filter_time_sharded(
            inp["y"][:, mine], inp["ymask"][:, mine], a, b_, g, m, mesh))
    arrays.update(hw_l=l.cpu().numpy(), hw_b=bb.cpu().numpy(),
                  hw_s=s.cpu().numpy(), hw_mse=mse.cpu().numpy(),
                  hw_preds=preds.cpu().numpy())
    system, _ = par_kalman_system(port, 1, dev)
    kal = step("kalman_time_sharded",
               lambda: pkalman.parallel_kalman_filter_time_sharded(
                   inp["z"][:, mine], inp["zmask"][:, mine], *system, mesh,
                   block_size=blk))
    for name, v in zip(("ssq", "ldet", "n", "preds", "Fs", "a_T", "P_T"),
                       kal):
        arrays[f"kalman_{name}"] = v.cpu().numpy()

    win = port["windowed"]
    wcfg = win.WindowedConfig.from_conf(plan["win_block"])
    S_w, T_w = plan["win_shape"]
    wbatch = ar2_batch(port, S_w, T_w, plan["win_seed"])
    wp, wr = step("windowed_mesh", lambda: win.windowed_fit_forecast(
        wbatch, "arima", horizon=plan["win_horizon"], mesh=mesh,
        wconfig=wcfg))
    launches = hand_launches()
    digest = hashlib.sha256()
    for x in (wr.yhat, wr.lo, wr.hi, wr.ok, wp.phi, wp.theta, wp.sigma2):
        digest.update(x.cpu().numpy().tobytes())
    report = {"rank": rank, "backend": dist.get_backend(),
              "device": str(dev), "library_s": library_s,
              "ready_s": ready_s, "steps": steps,
              "launches": launches, "n_local_series": n_local,
              "local_all_ok": local_ok, "global_mean_mape": mape_mean,
              "means": {k: float(v) for k, v in means.items()},
              "cv_rows": int(cvm["mape"].shape[0]),
              "windowed_digest": digest.hexdigest()}
    if rank == 0:
        # the comparison after the timed steps: the unsharded windowed fit
        up, ur = win.windowed_fit_forecast(
            wbatch, "arima", horizon=plan["win_horizon"], wconfig=wcfg)
        diff = {k: float((getattr(wr, k) - getattr(ur, k)).abs().max())
                for k in ("yhat", "lo", "hi")}
        diff.update({f.name: float((getattr(wp, f.name)
                                    - getattr(up, f.name)).abs().max())
                     for f in dataclasses.fields(up)})
        report["windowed_vs_unsharded"] = {
            "max_abs": diff, "ok_equal": bool(torch.equal(wr.ok, ur.ok)),
            "day_all_equal": bool(torch.equal(wr.day_all, ur.day_all)),
            "shape": list(wr.yhat.shape)}
    np.savez(os.path.join(plan["out"], f"rank{rank}.npz"), **arrays)
    dist.destroy_process_group()
    return report


def parallel_one_rank(port, card_line: str) -> dict:
    """(a) One rank over NCCL on the card, through ``make_mesh()`` (a
    one-rank group this process brings up): ``sharded_fit_forecast`` of
    Holt-Winters, arima and the curve model and ``sharded_cv_metrics`` of
    Holt-Winters with ``global_metric_means``, the launch counters set to 0
    just before and read just after; each against the unsharded fit / CV
    on the card (bitwise for Holt-Winters and arima, the curve model within
    ``CURVE_RTOL`` of each row's scale), the means against a float64 host
    mean; sharded and unsharded walls as CUDA-event medians and the idle
    share of the sharded fit.  The group is torn down at the end."""
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch import parallel as par
    from distributed_forecasting_tpu_torch.parallel import mesh as pmesh

    eng, cvmod = port["engine"], port["cv"]
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA),
                                   device=DEVICE)
    assert (batch.n_series, batch.n_time) == SHAPE
    cv = cvmod.CVConfig(**CV)
    configs = {"holt_winters": None, "arima": None,
               "prophet": curve_config(batch, port)}
    out = {}
    mesh = par.make_mesh(device=DEVICE)
    try:
        backend = dist.get_backend()
        if DEVICE == "cuda":
            assert backend == "nccl", backend
        for k in KERNELS:
            wrapper(k).launches = 0
        sharded = {m: par.sharded_fit_forecast(batch, m, config=c, mesh=mesh)
                   for m, c in configs.items()}
        cvm = par.sharded_cv_metrics(batch, "holt_winters", cv=cv, mesh=mesh)
        ok = sharded["holt_winters"][1].ok
        means = par.global_metric_means(cvm, ok, mesh)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        launches = hand_launches()
        plain = {m: eng.fit_forecast(batch, m, c)
                 for m, c in configs.items()}
        plain_cv = cvmod.cross_validate(batch, "holt_winters", cv=cv)
        checks = {}
        for m in ("holt_winters", "arima"):
            checks[m] = {k: bool(torch.equal(getattr(sharded[m][1], k),
                                             getattr(plain[m][1], k)))
                         for k in ("yhat", "lo", "hi", "ok")}
            assert all(checks[m].values()), (m, checks[m])
        got, want = sharded["prophet"][1], plain["prophet"][1]
        scale = want.yhat.abs().amax(1, keepdim=True).clamp_min(1.0)
        rel = {k: float(((getattr(got, k) - getattr(want, k)).abs()
                         / scale).max()) for k in ("yhat", "lo", "hi")}
        assert max(rel.values()) <= CURVE_RTOL, rel
        assert torch.equal(got.ok, want.ok)
        checks["prophet"] = {"max_rel_of_row_scale": rel,
                             "tolerance": CURVE_RTOL}
        checks["cv_bitwise"] = {k: bool(torch.equal(cvm[k], plain_cv[k]))
                                for k in cvm if not k.startswith("_")}
        assert all(checks["cv_bitwise"].values()), checks["cv_bitwise"]
        okh = ok.cpu().numpy()
        host = {k: float(np.mean(cvm[k].double().cpu().numpy()[okh]))
                for k in means}
        mean_rel = {k: abs(float(means[k]) - host[k]) / max(abs(host[k]),
                                                          1e-12)
                    for k in means}
        assert max(mean_rel.values()) <= PAR_MEAN_RTOL, mean_rel
        checks["means_vs_float64"] = {"max_rel": max(mean_rel.values()),
                                      "tolerance": PAR_MEAN_RTOL}
        from distributed_forecasting_tpu_torch.ops import metrics as M

        one_mape = M.mape(batch.y, plain["holt_winters"][1].yhat[
            :, :batch.n_time], batch.mask).double()
        times = {}
        if DEVICE == "cuda":
            hw = lambda: par.sharded_fit_forecast(  # noqa: E731
                batch, "holt_winters", mesh=mesh)
            times = {
                "fit_ms": _turns_ms({
                    "sharded": hw, "unsharded": lambda: eng.fit_forecast(
                        batch, "holt_winters")}),
                "cv_ms": _turns_ms({
                    "sharded": lambda: par.sharded_cv_metrics(
                        batch, "holt_winters", cv=cv, mesh=mesh),
                    "unsharded": lambda: cvmod.cross_validate(
                        batch, "holt_winters", cv=cv)}),
                "sharded_fit_profile": idle_share(hw)}
        out = {"backend": backend, "launches": launches, "checks": checks,
               "means": {k: float(v) for k, v in means.items()},
               "one_process_mean_mape": float(one_mape.mean()),
               "hw_yhat": sharded["holt_winters"][1].yhat, "times": times}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        pmesh._RANK_DEVICE = None
    emit("parallel_one_rank", card=card_line, backend=out["backend"],
         device=str(batch.y.device), launches=out["launches"],
         checks=out["checks"], means=out["means"], reps=REPS,
         statistic="median", **out["times"])
    for k in PAR_KERNELS:
        if DEVICE == "cuda":
            assert out["launches"][k] >= 1, (k, out["launches"])
    return out


def parallel_two_ranks(port, one: dict, card_line: str) -> dict:
    """(b) ``PAR_WORLD`` processes on the one card over gloo (NCCL refuses
    two ranks on one device), each ``python3 chip_smoke.py
    --parallel-rank`` with its plan (:func:`parallel_rank`), started at
    once; their output to files.  Fails if a rank exits nonzero or runs
    past ``PAR_RANK_TIMEOUT_S``.  Then the checks: both ranks' gathered
    bottoms bitwise (a)'s sharded forecasts; the global MAPE mean equal on
    both and within ``PAR_MAPE_RTOL`` of one process's; the 2-rank CV means
    within ``PAR_MEAN_RTOL`` of (a)'s; the time-sharded scans against the
    sequential filters on the card (``hw_filter``, ``arima_filter``) and the
    unsharded ``affine_scan``; the windowed fit over the mesh equal on both
    ranks and within ``PAR_WIN_TOL`` of the unsharded one."""
    from distributed_forecasting_tpu_torch.ops import pscan

    lib = os.path.join(port["build"].BUILD_DIR or "", "dftt_kernels.so")
    stamp = os.stat(lib).st_mtime_ns if os.path.exists(lib) else None
    tmp = tempfile.mkdtemp(prefix="dftt-par-")
    number = free_port()
    procs, files, reports = [], [], []
    t0 = time.perf_counter()
    try:
        for r in range(PAR_WORLD):
            plan = {"rank": r, "world": PAR_WORLD, "port": number,
                    "out": tmp, "device": DEVICE, "data": DATA,
                    "shape": list(SHAPE), "horizon": 90, "cv": CV,
                    "scan_t": PAR_SCAN_T, "win_shape": list(WIN_SHAPE),
                    "win_seed": WIN_SEED, "win_horizon": WIN_HORIZON,
                    "win_block": windowed_block(port),
                    "spawned_at": time.time()}
            fo = open(os.path.join(tmp, f"rank{r}.out"), "w")
            fe = open(os.path.join(tmp, f"rank{r}.err"), "w")
            files += [fo, fe]
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--parallel-rank", json.dumps(plan)], cwd=ROOT,
                stdout=fo, stderr=fe))
        deadline = time.perf_counter() + PAR_RANK_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                p.wait(max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} ran past "
                                     f"{PAR_RANK_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        for r, p in enumerate(procs):
            with open(os.path.join(tmp, f"rank{r}.err")) as f:
                err = f.read()
            with open(os.path.join(tmp, f"rank{r}.out")) as f:
                lines = f.read().strip().splitlines()
            assert p.returncode == 0 and lines, (
                f"rank {r} exited {p.returncode}: {err[-3000:]}")
            reports.append(json.loads(lines[-1]))
        arrays = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                  for r in range(PAR_WORLD)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if stamp is not None:
        assert os.stat(lib).st_mtime_ns == stamp, "a rank rebuilt the library"
    checks = {}
    if DEVICE == "cuda":
        assert all(r["backend"] == "gloo" and r["device"] == "cuda:0"
                   for r in reports), reports
    want = one["hw_yhat"].cpu().numpy()
    for r, a in enumerate(arrays):
        assert np.array_equal(a["bottoms"], want), f"rank {r}'s bottoms"
    checks["bottoms_bitwise_one_rank"] = True
    mapes = [r["global_mean_mape"] for r in reports]
    assert len(set(mapes)) == 1, mapes
    one_mape = one["one_process_mean_mape"]
    checks["global_mean_mape"] = {"ranks": mapes, "one_process": one_mape,
                                  "rel": abs(mapes[0] - one_mape) / one_mape}
    assert checks["global_mean_mape"]["rel"] <= PAR_MAPE_RTOL, checks
    assert sum(r["n_local_series"] for r in reports) == SHAPE[0]
    assert all(r["local_all_ok"] for r in reports)
    for r in reports[1:]:
        assert r["means"] == reports[0]["means"], (r["means"], reports[0])
    mean_rel = {k: abs(v - one["means"][k]) / max(abs(one["means"][k]),
                                                  1e-12)
                for k, v in reports[0]["means"].items()}
    checks["cv_means_vs_one_rank"] = max(mean_rel.values())
    assert checks["cv_means_vs_one_rank"] <= PAR_MEAN_RTOL, mean_rel
    assert [r["cv_rows"] for r in reports] == [SHAPE[0] // PAR_WORLD] * 2

    # the time-sharded scans against the sequential filters on the card
    dev = torch.device(DEVICE)
    T = PAR_SCAN_T
    inp = par_scan_inputs(T, dev)
    states = np.concatenate([a["affine"] for a in arrays])
    ref = pscan.affine_scan(inp["A"], inp["c"], inp["x0"],
                            block_size=T).cpu().numpy()
    checks["affine_max_abs"] = float(np.abs(states - ref).max())
    assert checks["affine_max_abs"] <= PAR_AFFINE_ATOL, checks
    al, be, ga, m = PAR_HW
    one_row = lambda v: torch.full((1,), v, device=dev)  # noqa: E731
    (l, b, s), _, fitted = port["fs"].hw_filter(
        inp["y"], inp["ymask"], one_row(al), one_row(be), one_row(ga),
        one_row(1.0), m, "additive")
    err = ((inp["y"] - fitted) * inp["ymask"]).double()
    mse64 = (err * err).sum() / inp["ymask"].double().sum().clamp_min(1.0)
    hw_want = {"preds": fitted, "l_plus_s": l[:, None] + s, "b": b,
               "mse": mse64}
    hw_got = {"preds": np.concatenate([a["hw_preds"] for a in arrays], 1)}
    for k in ("l", "b", "s", "mse"):
        for a in arrays[1:]:
            assert np.array_equal(a[f"hw_{k}"], arrays[0][f"hw_{k}"]), k
        hw_got[k] = arrays[0][f"hw_{k}"]
    hw_got["l_plus_s"] = hw_got["l"][:, None] + hw_got["s"]
    checks["hw_filter"] = _par_close(hw_got, hw_want, PAR_HW_TOL)
    system, (ph, th, r) = par_kalman_system(port, 1, dev)
    seq = port["kalman"].arima_filter(
        inp["z"], inp["zmask"], None, None, ph, th,
        torch.zeros(1, device=dev), r, 0)
    obs = inp["zmask"] > 0
    v = (inp["z"] - seq.preds).double()
    kal_want = {"ssq": torch.where(obs, v * v / seq.Fs.double(), 0.0).sum(1),
                "ldet": torch.where(obs, seq.Fs.double().log(), 0.0).sum(1),
                "preds": seq.preds, "Fs": seq.Fs, "a_T": seq.a_T,
                "P_T": seq.P_T}
    kal_got = {k: np.concatenate([a[f"kalman_{k}"] for a in arrays], 1)
               for k in ("preds", "Fs")}
    for k in ("ssq", "ldet", "n", "a_T", "P_T"):
        for a in arrays[1:]:
            assert np.array_equal(a[f"kalman_{k}"],
                                  arrays[0][f"kalman_{k}"]), k
        kal_got[k] = arrays[0][f"kalman_{k}"]
    assert float(kal_got["n"][0]) == float(inp["zmask"].sum())
    checks["kalman_filter"] = _par_close(kal_got, kal_want, PAR_KALMAN_TOL)
    assert len({r["windowed_digest"] for r in reports}) == 1
    wv = reports[0]["windowed_vs_unsharded"]
    assert wv["ok_equal"] and wv["day_all_equal"], wv
    checks["windowed_vs_unsharded"] = wv
    assert max(wv["max_abs"].values()) <= PAR_WIN_TOL, wv
    launches = {k: sum(r["launches"][k] for r in reports) for k in KERNELS}
    out = {"wall_s": wall, "ranks": [
        {k: r[k] for k in ("rank", "backend", "device", "library_s",
                           "ready_s", "steps", "launches")}
        for r in reports], "checks": checks, "launches": launches}
    emit("parallel_two_ranks", card=card_line, world=PAR_WORLD,
         scan_steps=T, windowed_shape=list(WIN_SHAPE), **out)
    return out


def _turns_ms(fns: dict, reps: int = REPS) -> dict:
    """Each callable's median device time over ``reps`` turns, every turn
    one call of each in order between two CUDA events, after a warm-up
    call of each (two paths compared in turns on one card)."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(stop))
    return {k: statistics.median(v) for k, v in times.items()}


def _par_close(got: dict, want: dict, tol: dict) -> dict:
    """Each output within its (rtol, atol); the largest error of each."""
    out = {}
    for k, (rtol, atol) in tol.items():
        w = np.asarray(want[k].cpu().numpy() if torch.is_tensor(want[k])
                       else want[k], np.float64)
        g = np.asarray(got[k], np.float64).reshape(w.shape)
        err = np.abs(g - w)
        out[k] = {"max_abs": float(err.max()),
                  "max_rel": float((err / np.maximum(np.abs(w), 1e-30)).max()),
                  "rtol": rtol, "atol": atol}
        assert np.all(err <= atol + rtol * np.abs(w)), (k, out[k])
    return out


def slice23_phase(port, card_line: str) -> dict:
    """Phase 22: ``parallel/*`` over ``torch.distributed``.  (a)
    :func:`parallel_one_rank`, then (b) :func:`parallel_two_ranks`; the
    phase's launches are (a)'s counted main path and (b)'s ranks'."""
    t_phase = time.perf_counter()
    emit("parallel", card=card_line,
         measures="(a) one rank over NCCL on cuda:0: the sharded entry "
                  "points against the unsharded ones, no cross-rank "
                  "traffic; (b) two ranks over gloo on the same card: the "
                  "collectives between two processes")
    one = parallel_one_rank(port, card_line)
    t_b = time.perf_counter()
    two = parallel_two_ranks(port, one, card_line)
    launches = {k: one["launches"][k] + two["launches"][k] for k in KERNELS}
    emit("launches", path="parallel", **launches,
         expected="(a): hw_score and hw_filter 2 (the sharded fit, the CV "
                  "pass), arima_filter and arima_predict 1; (b): each rank's "
                  "local fit, sharded fit and CV pass (hw_score, hw_filter "
                  "3 each) and windowed fit (arima_filter, arima_predict 1 "
                  "each)")
    out = {"launches": launches, "seconds": time.perf_counter() - t_phase,
           "parts": {"one_rank": t_b - t_phase,
                     "two_ranks": time.perf_counter() - t_b}}
    emit("phase22", card=card_line, seconds=out["seconds"],
         parts=out["parts"])
    return out


# -- phase 23: a replica's predict over a mesh of ranks ----------------------

MESH_RANKS = 2              # a serving rank and one follower on the card
MESH_SIZES = (1, 17, 500)
MESH_HORIZON = 28
MESH_QSET = [0.1, 0.5, 0.9]
MESH_LATENCY = 20           # sequential /invocations a size and fleet, (a)
MESH_POINTS = 500           # (b): one ingest, the backlog that forces a refit


def mesh_fleet_conf(port, root: str, name: str, number: int, mesh: int,
                    tag: str, ingest: bool) -> dict:
    """The shipped serve conf as a fleet of one replica at ``mesh_devices``
    ``mesh`` on the front door ``number``: no cache and no sharding, as
    shipped; with ``ingest``, ``serving.ingest`` on (the fleet's interval
    follower) with a refit forced by a backlog of :data:`MESH_POINTS`;
    the kernel library loaded from this checkout's build directory (the
    compile-cache store off: this process built it)."""
    conf = port["config"].load_conf(SERVE_CONF)
    conf["env"] = {"root": root}
    conf["serving"].update(model_name=name, host="127.0.0.1", port=number)
    conf["serving"]["fleet"].update(enabled=True, replicas=1,
                                    mesh_devices=mesh)
    conf["serving"]["ingest"].update(
        enabled=ingest, apply_mode=None,
        wal_dir=os.path.join(root, f"wal_{tag}"))
    conf["serving"]["ingest"]["refit"].update(
        enabled=ingest, max_applied_points=MESH_POINTS,
        max_staleness_s=1e9, check_interval_s=0.5)
    conf["monitoring"]["quality_store"]["directory"] = os.path.join(
        root, f"quality_{tag}")
    conf["compile_cache"]["enabled"] = False
    return conf


def follower_pids(replica_pid: int) -> list:
    """Pids of a replica's follower ranks: its child processes, the ones it
    forked (read from /proc)."""
    out = []
    for pid in (int(d) for d in os.listdir("/proc") if d.isdigit()):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rpartition(")")[2].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == replica_pid:
            out.append(pid)
    return out


def pid_alive(pid: int) -> bool:
    """The pid runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except OSError:
        return False


def mesh_drains(log: str) -> list:
    """Each drained replica's launches: its own and its follower ranks'
    (the drain line)."""
    import re

    return [{"rank0": json.loads(m.group(1)),
             "followers": json.loads(m.group(2))} for m in re.finditer(
        r"drained; hand-kernel launches in this process: (\{[^}]*\}); in "
        r"its follower ranks: (\[[^\]]*\])", log)]


def mesh_payloads(fc) -> dict:
    """(a)'s bodies: 1, 17 and 500 series at :data:`MESH_HORIZON`, point
    and :data:`MESH_QSET` quantiles."""
    out = {}
    for size in MESH_SIZES:
        inputs = _inputs(fc.keys[:size][::-1], fc.key_names)
        out[f"{size}"] = {"inputs": inputs, "horizon": MESH_HORIZON}
        out[f"{size}q"] = {"inputs": inputs, "horizon": MESH_HORIZON,
                           "quantiles": MESH_QSET}
    return out


def mesh_bodies(number: int, payloads: dict) -> dict:
    out = {}
    for name, payload in payloads.items():
        status, body, _ = http_call(number, "POST", "/invocations", payload)
        assert status == 200, (name, body[:300])
        out[name] = body
    return out


def mesh_latency(fleets: dict, fc, card_line: str) -> dict:
    """(a)'s times: /invocations p50 / p95 at each size through each
    fleet's front door, the fleets in turns."""
    out = {}
    for size in MESH_SIZES:
        req = {"inputs": _inputs(fc.keys[:size][::-1], fc.key_names),
               "horizon": MESH_HORIZON}
        ms = {leg: [] for leg in fleets}
        for _ in range(MESH_LATENCY):
            for leg, f in fleets.items():
                t0 = time.perf_counter()
                status, body, _ = http_call(f.port, "POST", "/invocations",
                                            req)
                ms[leg].append((time.perf_counter() - t0) * 1e3)
                assert status == 200, body[:300]
        out[size] = {leg: _pcts(v) for leg, v in ms.items()}
    emit("mesh_latency", card=card_line, horizon=MESH_HORIZON, sizes=out)
    return out


def mesh_ingest(fleet, single, fc) -> dict:
    """(b): bodies of the mesh replica byte-equal to the single scorer's,
    then one /ingest of :data:`MESH_POINTS` points (the next day of the
    first 500 series) to both; the replica applies them on its serving
    rank and the backlog forces a refit there (hw_score, hw_filter), the
    single scorer applies in the POST and refits too; the bodies after
    are byte-equal again."""
    payloads = {k: v for k, v in mesh_payloads(fc).items()
                if not k.endswith("q")}
    number = single.server_address[1]
    before = mesh_bodies(fleet.port, payloads)
    assert before == mesh_bodies(number, payloads), "before the apply"
    rep = fleet.replicas()[0]["port"]
    day = int(fc._state_snapshot()[1]) + 1
    points = [{"k": [int(v) for v in k], "d": day,
               "y": float(np.round(np.random.default_rng(37).lognormal(
                   3.5, 0.3)))} for k in fc.keys[:MESH_POINTS].tolist()]
    t0 = time.perf_counter()
    for target in (fleet.port, number):
        status, body, _ = http_call(target, "POST", "/ingest",
                                    {"points": points})
        assert status == 200 and json.loads(body)["written"] == \
            MESH_POINTS, body[:300]
    deadline = time.perf_counter() + 120
    while True:
        text = http_call(rep, "GET", "/metrics")[1].decode()
        applied = _metric(text, "dftpu_ingest_applied_points_total")
        refits = _metric(text, "dftpu_ingest_refits_total")
        if (applied >= MESH_POINTS and refits >= 1) or \
                time.perf_counter() > deadline:
            break
        time.sleep(0.1)
    assert applied == MESH_POINTS and refits >= 1, (applied, refits)
    refit = single.ingest.refit
    while refit.snapshot()["refits_done"] < 1 and \
            time.perf_counter() < deadline:
        refit.wait(timeout=60)
        time.sleep(0.05)
    assert refit.snapshot()["refits_done"] >= 1, refit.snapshot()
    seconds = time.perf_counter() - t0
    after = mesh_bodies(fleet.port, payloads)
    assert after == mesh_bodies(number, payloads), "after the apply"
    assert after != before
    return {"applied": applied, "replica_refits": refits,
            "single_refits": refit.snapshot()["refits_done"],
            "apply_and_refit_seconds": seconds,
            "bytes": {k: len(v) for k, v in after.items()}}


def mesh_kill(fleet) -> dict:
    """(c), first half: SIGKILL the follower of the fleet's one replica and
    wait for the replica to leave (it exits 75: its rank can no longer
    dispatch in step).  Returns the kill's time and both pids."""
    import signal

    (rep,) = fleet.replicas()
    replica = fleet.pid_of(rep["port"])
    (follower,) = follower_pids(replica)
    t0 = time.perf_counter()
    os.kill(follower, signal.SIGKILL)
    while pid_alive(replica):
        assert time.perf_counter() - t0 < 60, "the replica outlived its rank"
        time.sleep(0.02)
    return {"t_kill": t0, "replica_exit_s": time.perf_counter() - t0,
            "pids": [replica, follower]}


def mesh_restarted(fleet, kill: dict, payloads: dict, want: dict,
                   card_line: str) -> dict:
    """(c), second half: the supervisor restarted the replica (one restart,
    ready again, a new follower), the log says why the old one left
    /readyz, and the bodies equal ``want`` again."""
    reps = fleet.wait(lambda r: r[0]["restarts"] >= 1 and r[0]["ready"])
    restart_s = time.perf_counter() - kill["t_kill"]
    assert reps[0]["restarts"] == 1, reps
    replica, follower = kill["pids"]
    log = fleet.log_text()
    assert f"follower rank 1 (pid {follower}) exited with -9; the replica " \
           f"leaves /readyz and exits 75" in log, log[-3000:]
    assert mesh_bodies(fleet.port, payloads) == want, "after the restart"
    new = fleet.pid_of(reps[0]["port"])
    (new_follower,) = follower_pids(new)
    out = {"replica_exit_s": kill["replica_exit_s"],
           "restart_to_ready_s": restart_s,
           "pids": [replica, follower, new, new_follower]}
    emit("mesh_restart", card=card_line, **out)
    return out


MESH_LEGS = {"mesh": ("arima", MESH_RANKS, False),
             "plain": ("arima", 0, False),
             "ingest": ("holt_winters", MESH_RANKS, True)}


def start_mesh_fleets(port) -> dict:
    """Phase 23's fits and its three fleets (:data:`MESH_LEGS`), started
    before phase 21 so that they boot beside phase 21's two fleets: a boot
    waits on its processes' start-up, not on the card.  Phase 21 waits for
    them (:func:`mesh_fleets_ready`) before its timed parts; phase 22 runs
    beside them idle.  The launch counters go to 0 just before the fits
    and are read just after them.  Returns the state
    :func:`slice24_phase` takes; :func:`stop_mesh_fleets` ends it."""
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA),
                                   device=DEVICE)
    assert (batch.n_series, batch.n_time) == SHAPE
    st = {"root": tempfile.mkdtemp(prefix="mesh_"),
          "stack": contextlib.ExitStack(), "fleets": {}}
    try:
        for k in KERNELS:  # counters to 0 just before the fits
            wrapper(k).launches = 0
        t0 = time.perf_counter()
        st["arts"] = stream_artifacts(port, st["root"], batch,
                                      families=("arima", "holt_winters"))
        st["fits_s"] = time.perf_counter() - t0
        st["fit_launches"] = hand_launches()  # ... and after them
        st["t_boot"] = time.perf_counter()
        for leg, (model, mesh, ingest) in MESH_LEGS.items():
            number = free_port()
            conf = mesh_fleet_conf(port, st["root"],
                                   st["arts"][model]["name"], number, mesh,
                                   leg, ingest)
            path = os.path.join(st["root"], f"fleet_{leg}.json")
            with open(path, "w") as f:
                json.dump(conf, f)  # JSON is YAML
            st["fleets"][leg] = st["stack"].enter_context(FleetProcess(
                path, number, os.path.join(st["root"], f"fleet_{leg}.log")))
    except BaseException:
        stop_mesh_fleets(st)
        raise
    emit("mesh_fleets_started", legs=list(MESH_LEGS),
         beside="phase 21's two fleets boot beside these; phase 21 waits "
                "for them before its timed parts, phase 22 runs beside them "
                "idle")
    return st


def mesh_fleets_ready(st: dict) -> dict:
    """Wait until each of phase 23's fleets has its one replica ready;
    returns the seconds from their start until each was seen ready (an
    upper bound: the first look may come after it)."""
    if "ready_s" not in st:
        ready = {}
        for leg, f in st["fleets"].items():
            f.wait(lambda r: len(r) == 1 and r[0]["ready"])
            ready[leg] = time.perf_counter() - st["t_boot"]
        st["ready_s"] = ready
    return st["ready_s"]


def stop_mesh_fleets(st: dict) -> None:
    """End phase 23's fleets (SIGTERM, then their process groups killed)
    and remove their directory."""
    try:
        st["stack"].close()
    finally:
        shutil.rmtree(st["root"], ignore_errors=True)


def slice24_phase(port, card_line: str, started: dict = None) -> dict:
    """Phase 23: a replica's predict over a mesh of ranks.  The fleet task
    with one replica at ``mesh_devices`` :data:`MESH_RANKS` (a serving rank
    and one follower process on cuda:0 over gloo) on an arima artifact of
    the committed dataset, beside the same fleet at ``mesh_devices`` 0 and
    a Holt-Winters fleet at :data:`MESH_RANKS` with ``serving.ingest`` on
    (:func:`start_mesh_fleets`: ``started``, or started here), and a single
    ``tasks.serve`` scorer of the Holt-Winters artifact in this process.
    (a) Byte-equal bodies and p50 / p95 at 1, 17 and 500 series; (c) the
    follower's death, and while its replica restarts (b) an apply and a
    forced refit on the ingest fleet's serving rank and the other two
    fleets' drains; then the restarted replica's bodies and its drain.
    The drain lines give every rank's launches, and no process of a
    replica is left after its drain."""
    t_phase = time.perf_counter()
    emit("mesh_predict", card=card_line,
         measures="two ranks of one replica sharing the one card over gloo: "
                  "the mesh predict protocol's cost and its bytes against "
                  "one device, not a speedup")
    own = started is None
    if own:
        started = start_mesh_fleets(port)
    root, arts, fleets = started["root"], started["arts"], started["fleets"]
    out, seconds, single, logs = {}, {"fits": started["fits_s"]}, None, {}
    try:
        for k in KERNELS:  # counters to 0 just before the path
            wrapper(k).launches = 0
        # the single Holt-Winters scorer: the ingest fleet's conf, no
        # fleet, applying in the POST
        sconf = mesh_fleet_conf(port, root, arts["holt_winters"]["name"],
                                0, 0, "single", True)
        sconf["serving"]["fleet"]["enabled"] = False
        sconf["serving"]["ingest"]["apply_mode"] = "sync"
        single = port["server"].start_server(**port["serve_task"].ServeTask(
            init_conf=sconf, device=DEVICE).server_args())
        t0 = time.perf_counter()
        out["boot"] = {"ready_s": mesh_fleets_ready(started)}
        seconds["boot_wait"] = time.perf_counter() - t0
        for leg, f in fleets.items():
            (rep,) = f.replicas()
            (line,) = boot_lines(f.log_text(), rep["port"])
            out["boot"][leg] = {"seconds": line["seconds"],
                                "stages": line["stages"]}
        fc = port["serving"].BatchForecaster.load(
            arts["arima"]["artifact"], device=DEVICE)
        payloads = mesh_payloads(fc)
        t0 = time.perf_counter()
        want = mesh_bodies(fleets["plain"].port, payloads)
        got = mesh_bodies(fleets["mesh"].port, payloads)
        assert got == want, [k for k in want if got[k] != want[k]]
        out["equal"] = {k: len(v) for k, v in want.items()}
        seconds["equal"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["latency"] = mesh_latency(
            {"mesh": fleets["mesh"], "plain": fleets["plain"]}, fc,
            card_line)
        seconds["latency"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kill = mesh_kill(fleets["mesh"])
        # while the replica restarts: (b), then the other fleets' drains
        t1 = time.perf_counter()
        out["ingest"] = mesh_ingest(fleets["ingest"], single,
                                    single.forecaster)
        seconds["ingest"] = time.perf_counter() - t1
        pids = []
        for leg in ("ingest", "plain"):
            (rep,) = fleets[leg].replicas()
            pids.append(fleets[leg].pid_of(rep["port"]))
        pids += follower_pids(pids[0])  # the ingest replica's follower
        for leg in ("ingest", "plain"):
            fleets[leg].drain()
            logs[leg] = fleets[leg].log_text()
        out["restart"] = mesh_restarted(fleets["mesh"], kill, payloads,
                                        want, card_line)
        seconds["kill_to_checked"] = time.perf_counter() - t0
        pids += out["restart"]["pids"]
        t0 = time.perf_counter()
        fleets["mesh"].drain()
        logs["mesh"] = fleets["mesh"].log_text()
        seconds["drain"] = time.perf_counter() - t0
        # SIGTERM drained each replica and its follower: none is left
        left = [p for p in pids if pid_alive(p)]
        assert not left, (left, pids)
        for leg, f in fleets.items():
            assert f.proc.returncode == 0, logs[leg][-3000:]
        drains = {leg: mesh_drains(logs[leg]) for leg in fleets}
        assert [len(d) for d in drains.values()] == [1, 1, 1], drains
        assert [len(d[0]["followers"]) for d in drains.values()] == [
            MESH_RANKS - 1, 0, MESH_RANKS - 1], drains
        out["drains"] = drains
        if DEVICE == "cuda":
            # both ranks of the arima replica (the restarted one: its warmup
            # and the bodies after the restart) launched arima_predict; the
            # refit launched hw_score and hw_filter on the serving rank
            mesh = drains["mesh"][0]
            assert mesh["rank0"]["arima_predict"] > 0, mesh
            assert mesh["followers"][0]["arima_predict"] > 0, mesh
            ing = drains["ingest"][0]
            assert ing["rank0"]["hw_score"] >= 1, ing
            assert ing["rank0"]["hw_filter"] >= 1, ing
            assert ing["followers"][0]["hw_score"] == 0, ing
        fleet_launches = [d for ds in drains.values() for dr in ds
                          for d in (dr["rank0"], *dr["followers"])]
        out["launches"] = {k: n + started["fit_launches"][k]
                           + sum(d[k] for d in fleet_launches)
                           for k, n in hand_launches().items()}
    finally:
        if single is not None:
            single.shutdown()
        port["trace"].configure_tracing(port["trace"].TraceConfig())
        if own:
            stop_mesh_fleets(started)
    launches = out["launches"]
    emit("launches", path="mesh_predict", **launches,
         expected="hw_score, hw_filter: the Holt-Winters fit and its two "
                  "refits (the single scorer's, the serving rank's); "
                  "arima_filter: the arima fit; arima_predict: the mesh "
                  "replica's dispatches on both ranks and the plain "
                  "replica's, from their drain lines")
    out["seconds"] = time.perf_counter() - t_phase
    emit("mesh", card=card_line, equal=out["equal"], boot=out["boot"],
         ingest=out["ingest"], drains=out["drains"])
    emit("phase23", card=card_line, seconds=out["seconds"], parts=seconds)
    return out

# -- phase 24: the sanitizer armed on the card; the Prophet MAP oracle -------

# the reference's `make tsan` settings: armed at import, a report a process
# at exit, every instrumented acquire and release a 5% chance of a 1 ms
# sleep from a seeded draw
TSAN_ENV = {"DFTPU_TSAN": "1",
            "DFTPU_FAILPOINTS": "sanitizer.yield=sleep 1:0.05",
            "DFTPU_FAILPOINTS_SEED": "42"}
TSAN_SIZES = (1, 17, 500)
TSAN_HORIZON = 28
TSAN_CLIENTS = 8          # client threads of (a)'s drive
TSAN_DRIVE_S = 10.0       # seconds of (a)'s drive
TSAN_POINTS = 500         # one /ingest, the backlog that forces the refit
TSAN_SCRAPE_EVERY = 5     # a client's /metrics scrape every n requests
# the classes that call sanitizer.attach: every one must show in the reports
TSAN_CLASSES = ("SeriesStateStore", "ForecastCache", "ConnectionPool",
                "WriteAheadLog", "RequestBatcher", "BatchForecaster",
                "FleetSupervisor")
TSAN_REPORTS = 4          # the fleet task, its two replicas, the scorer
ORACLE_SERIES = 50        # scripts/prophet_parity.py --real's default

TSAN_SCORER_CHILD = r"""
import json, signal, sys, threading
from distributed_forecasting_tpu_torch.ops import fused_scan, kalman, ses
from distributed_forecasting_tpu_torch.serving import server
from distributed_forecasting_tpu_torch.tasks import serve
with open(sys.argv[1]) as f:
    conf = json.load(f)
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: stop.set())
srv = server.start_server(**serve.ServeTask(
    init_conf=conf, device=sys.argv[2]).server_args())
stop.wait()
srv.shutdown()
srv.server_close()
print(json.dumps({k: getattr(m, k).launches for m, ks in (
    (fused_scan, ("hw_score", "hw_filter")),
    (kalman, ("arima_filter", "arima_predict", "arima_loglik_grad",
              "arima_mle_fit")),
    (ses, ("croston_filter", "ses_filter"))) for k in ks}), flush=True)
"""

ORACLE_CHILD = r"""
import json, sys, time
import numpy as np
import pandas as pd
from distributed_forecasting_tpu_torch.data.dataset import load_sales_csv
from distributed_forecasting_tpu_torch.models import prophet_map as pm
df = load_sales_csv(sys.argv[1])
keys = df[["store", "item"]].drop_duplicates().sort_values(
    ["store", "item"]).head(int(sys.argv[2]))
out = []
t0 = time.perf_counter()
for store, item in keys.itertuples(index=False):
    sub = df[(df["store"] == store) & (df["item"] == item)]
    day = (pd.to_datetime(sub["date"]) - pd.Timestamp("1970-01-01")
           ).dt.days.to_numpy(np.float64)
    try:
        mape = pm.cv_mape(day, sub["sales"].to_numpy(np.float64))
    except Exception as e:  # recorded: a non-finite result fails the phase
        print(f"oracle failed on ({store}, {item}): {e!r}", file=sys.stderr)
        mape = float("nan")
    out.append({"key": [int(store), int(item)], "mape": mape})
print(json.dumps({"series": out, "wall_s": time.perf_counter() - t0}))
"""

DFTSAN_CHILD = r"""
import json, sys, time
from distributed_forecasting_tpu_torch.analysis import dftsan
spent = {}
def timed(name, fn):
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
    return run
dftsan.build_project = timed("build_project", dftsan.build_project)
dftsan.get_lock_analysis = timed("lock_model", dftsan.get_lock_analysis)
rc = dftsan.main(sys.argv[1:])
print(json.dumps({"static_model_s": spent}), file=sys.stderr)
sys.exit(rc)
"""


def _child(code: str, args: list, log_dir: str, name: str,
           env: dict = None) -> tuple:
    """Start ``python -c code args`` from the checkout's root with its
    output in files under ``log_dir`` (a child read long after it started
    must not stall on a full pipe)."""
    full = dict(os.environ, **(env or {}))
    full["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, full.get("PYTHONPATH")) if p)
    logs = [open(os.path.join(log_dir, f"{name}.{k}"), "w+")
            for k in ("out", "err")]
    proc = subprocess.Popen([sys.executable, "-c", code, *args], cwd=ROOT,
                            env=full, stdout=logs[0], stderr=logs[1],
                            text=True)
    return proc, logs


def _child_output(child: tuple, timeout: float) -> tuple:
    """(exit code, stdout, stderr) of a started :func:`_child`."""
    proc, logs = child
    proc.wait(timeout=timeout)
    stdout, stderr = (f.seek(0) or f.read() for f in logs)
    for f in logs:
        f.close()
    return proc.returncode, stdout, stderr


def tsan_conf(port, root: str, name: str, number: int, tag: str,
              fleet: bool) -> dict:
    """The shipped serve conf for (a): with ``fleet``, phase 20's fleet
    (:data:`FLEET_CONF`: two replicas, 8 shards x 2, ingest with the
    backlog refit at :data:`TSAN_POINTS`) on the front door ``number``;
    else a single scorer on ``number`` (0: a free port).  Both with the
    coalescer and the forecast cache on, their own WAL and store
    directories, and the kernel library loaded from this checkout's build
    directory (the compile-cache store off: this process built it)."""
    conf = fleet_conf(port, root, name, number)
    conf["serving"]["fleet"]["enabled"] = fleet
    conf["serving"]["sharding"]["enabled"] = fleet
    conf["serving"]["ingest"].update(
        enabled=fleet, wal_dir=os.path.join(root, f"wal_{tag}"))
    conf["serving"]["ingest"]["refit"]["max_applied_points"] = TSAN_POINTS
    conf["serving"]["batching"]["enabled"] = True
    conf["serving"]["cache"]["enabled"] = True
    conf["serving"]["tracing"]["debug_endpoints"] = False
    conf["monitoring"]["quality_store"]["directory"] = os.path.join(
        root, f"quality_{tag}")
    conf["compile_cache"]["enabled"] = False
    return conf


def start_tsan(port, arts: dict = None, root: str = None) -> dict:
    """(a)'s armed processes and (b)'s oracle child, started so that they
    boot beside phase 21's fleets (``main`` calls this after
    :func:`start_mesh_fleets`, on its artifacts in its ``root``); fits
    its own Holt-Winters and arima artifacts when given none.  Returns the
    state :func:`slice25_phase` takes; :func:`stop_tsan` ends it."""
    st = {"tmp": tempfile.mkdtemp(prefix="tsan_"),
          "stack": contextlib.ExitStack(), "fit_launches": None}
    try:
        st["reports"] = os.path.join(st["tmp"], "reports")
        os.makedirs(st["reports"])
        env = dict(TSAN_ENV, DFTPU_TSAN_REPORT_DIR=st["reports"])
        one = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                "MKL_NUM_THREADS")}
        st["oracle"] = _child(ORACLE_CHILD, [DATA, str(ORACLE_SERIES)],
                              st["tmp"], "oracle", env=one)
        st["t_oracle"] = time.perf_counter()
        if arts is None:
            batch = port["data"].tensorize(port["data"].load_sales_csv(DATA),
                                           device=DEVICE)
            root = os.path.join(st["tmp"], "store")
            before = hand_launches()
            arts = stream_artifacts(port, root, batch,
                                    families=("arima", "holt_winters"))
            st["fit_launches"] = {k: n - before[k]
                                  for k, n in hand_launches().items()}
        st["root"], st["arts"] = root, arts
        st["t_boot"] = time.perf_counter()
        number = free_port()
        conf = tsan_conf(port, root, arts["holt_winters"]["name"], number,
                         "tsan_fleet", True)
        path = os.path.join(st["tmp"], "fleet.json")
        with open(path, "w") as f:
            json.dump(conf, f)  # JSON is YAML
        st["fleet"] = st["stack"].enter_context(FleetProcess(
            path, number, os.path.join(st["tmp"], "fleet.log"), env=env))
        st["scorer_port"] = free_port()
        conf = tsan_conf(port, root, arts["arima"]["name"],
                         st["scorer_port"], "tsan_scorer", False)
        path = os.path.join(st["tmp"], "scorer.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        st["scorer"] = _child(TSAN_SCORER_CHILD, [path, DEVICE], st["tmp"],
                              "scorer", env=env)
    except BaseException:
        stop_tsan(st)
        raise
    emit("tsan_started", beside="phase 21's fleets boot beside these",
         armed=TSAN_ENV, oracle_series=ORACLE_SERIES)
    return st


def tsan_ready(st: dict) -> dict:
    """Wait until (a)'s fleet has both replicas ready and its scorer
    answers /readyz; returns the seconds from their start until each was
    seen ready (an upper bound)."""
    if "ready_s" not in st:
        ready = {}
        st["fleet"].wait(lambda r: len(r) == 2 and all(x["ready"] for x in r))
        ready["fleet"] = time.perf_counter() - st["t_boot"]
        t0 = time.perf_counter()
        while True:
            proc = st["scorer"][0]
            if proc.poll() is not None:
                raise AssertionError(
                    "the armed scorer exited with "
                    f"{_child_output(st['scorer'], 10)}")
            try:
                if http_call(st["scorer_port"], "GET", "/readyz")[0] == 200:
                    break
            except OSError:
                pass
            assert time.perf_counter() - t0 < FLEET_BOOT_S, "scorer boot"
            time.sleep(0.05)
        ready["scorer"] = time.perf_counter() - st["t_boot"]
        st["ready_s"] = ready
    return st["ready_s"]


def stop_tsan(st: dict) -> None:
    """End whatever of (a) and (b) still runs and remove its directory."""
    import signal

    try:
        st["stack"].close()
    finally:
        for key in ("scorer", "oracle", "dftsan"):
            if key in st and st[key][0].poll() is None:
                st[key][0].send_signal(signal.SIGTERM)
                try:
                    st[key][0].wait(30)
                except subprocess.TimeoutExpired:
                    st[key][0].kill()
                    st[key][0].wait(30)
        shutil.rmtree(st["tmp"], ignore_errors=True)


def fleet_conf_shards(fleet) -> int:
    """``serving.sharding.num_shards`` of a started fleet's conf."""
    with open(fleet.conf_path) as f:
        return int(json.load(f)["serving"]["sharding"]["num_shards"])


def tsan_bodies(number: int, fc) -> dict:
    """/invocations bodies at :data:`TSAN_SIZES` series, horizon
    :data:`TSAN_HORIZON`, from the scorer on ``number``."""
    out = {}
    for size in TSAN_SIZES:
        req = {"inputs": _inputs(fc.keys[:size][::-1], fc.key_names),
               "horizon": TSAN_HORIZON}
        status, body, _ = http_call(number, "POST", "/invocations", req)
        assert status == 200, (size, body[:300])
        out[size] = body
    return out


def tsan_drive(targets: dict, fcs: dict, ingest) -> dict:
    """:data:`TSAN_CLIENTS` threads for :data:`TSAN_DRIVE_S` seconds, each
    on one of ``targets`` (name -> port) in turn: /invocations at
    :data:`TSAN_SIZES` series and a /metrics scrape every
    :data:`TSAN_SCRAPE_EVERY` requests; ``ingest()`` runs on this thread
    a second in.  Every answer must be a 200."""
    names = sorted(targets)
    counts = {n: {"invocations": 0, "metrics": 0} for n in names}
    errors, lock = [], threading.Lock()
    deadline = time.perf_counter() + TSAN_DRIVE_S

    def client(i: int) -> None:
        name = names[i % len(names)]
        fc, k = fcs[name], i
        try:
            while time.perf_counter() < deadline:
                size = TSAN_SIZES[k % len(TSAN_SIZES)]
                k += 1
                req = {"inputs": _inputs(fc.keys[:size][::-1], fc.key_names),
                       "horizon": TSAN_HORIZON}
                status, body, _ = http_call(targets[name], "POST",
                                            "/invocations", req)
                assert status == 200, (name, size, body[:300])
                kind = "invocations"
                if k % TSAN_SCRAPE_EVERY == 0:
                    status, body, _ = http_call(targets[name], "GET",
                                                "/metrics")
                    assert status == 200, (name, body[:300])
                    with lock:
                        counts[name]["metrics"] += 1
                with lock:
                    counts[name][kind] += 1
        except BaseException as e:  # noqa: BLE001 — re-raised below
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(TSAN_CLIENTS)]
    for th in threads:
        th.start()
    time.sleep(1.0)
    ingested = ingest()
    for th in threads:
        th.join(TSAN_DRIVE_S + 300)
    assert not any(th.is_alive() for th in threads), "a client hangs"
    assert not errors, errors[:3]
    return {"requests": counts, "ingest": ingested}


def tsan_refits(replicas: list, single) -> dict:
    """Wait until each replica and the disarmed single scorer have run the
    refit the ingest's backlog forces."""
    t0 = time.perf_counter()
    deadline = t0 + 60
    while True:
        refits = {r["port"]: _metric(http_call(r["port"], "GET", "/metrics")[
            1].decode(), "dftpu_ingest_refits_total") for r in replicas}
        single_done = single.ingest.refit.snapshot()["refits_done"]
        if (all(n >= 1 for n in refits.values()) and single_done >= 1) or \
                time.perf_counter() > deadline:
            break
        time.sleep(0.1)
    assert all(n >= 1 for n in refits.values()) and single_done >= 1, (
        refits, single_done)
    return {"replicas": refits, "single": single_done,
            "seconds": time.perf_counter() - t0}


def tsan_dynamic(port, st: dict) -> dict:
    """(a): bodies against disarmed scorers, the drive, the bodies again,
    SIGTERM to every armed process; returns the drains' launches and
    starts the dftsan CLI child over the reports (``st["dftsan"]``)."""
    out, seconds, servers = {}, {}, {}
    root, arts = st["root"], st["arts"]
    try:
        # the disarmed scorers, in this process (not armed: TSAN_ENV goes
        # to the children only), on the same artifacts and confs
        t0 = time.perf_counter()
        for model, tag, ingest in (("holt_winters", "tsan_hw_plain", True),
                                   ("arima", "tsan_arima_plain", False)):
            conf = tsan_conf(port, root, arts[model]["name"], 0, tag, False)
            conf["serving"]["ingest"].update(enabled=ingest,
                                             apply_mode="sync")
            servers[model] = port["server"].start_server(
                **port["serve_task"].ServeTask(
                    init_conf=conf, device=DEVICE).server_args())
        seconds["disarmed_boot"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["ready_s"] = tsan_ready(st)
        seconds["ready_wait"] = time.perf_counter() - t0
        fleet, single = st["fleet"], servers["holt_winters"]
        replicas = fleet.replicas()
        fcs = {"fleet": single.forecaster,
               "scorer": servers["arima"].forecaster}
        targets = {"fleet": fleet.port, "scorer": st["scorer_port"]}
        plain = {"fleet": single.server_address[1],
                 "scorer": servers["arima"].server_address[1]}

        def equal(when: str) -> dict:
            got = {}
            for name in targets:
                armed = tsan_bodies(targets[name], fcs[name])
                want = tsan_bodies(plain[name], fcs[name])
                assert armed == want, (when, name, [
                    k for k in want if armed[k] != want[k]])
                got[name] = {k: len(v) for k, v in armed.items()}
            return got

        t0 = time.perf_counter()
        out["equal_before"] = equal("before the drive")
        seconds["equal_before"] = time.perf_counter() - t0

        def ingest() -> dict:
            # one shard's series, as phase 20 posts them: both replicas own
            # it (replication 2) and refit on the backlog
            from distributed_forecasting_tpu_torch.serving.sharding import (
                shard_of_key,
            )

            fc = single.forecaster
            shards = fleet_conf_shards(fleet)
            points = fleet_points(fc, shard_of_key(fc.keys[0].tolist(),
                                                   shards), shards,
                                  int(fc.day1) + 1, TSAN_POINTS, seed=41)
            acks = {}
            for name, number in (("fleet", fleet.port),
                                 ("single", single.server_address[1])):
                status, body, _ = http_call(number, "POST", "/ingest",
                                            {"points": points})
                assert status == 200, (name, body[:300])
                acks[name] = json.loads(body)["written"]
            assert acks == {"fleet": TSAN_POINTS, "single": TSAN_POINTS}, acks
            return acks

        t0 = time.perf_counter()
        out["drive"] = tsan_drive(targets, fcs, ingest)
        seconds["drive"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["refits"] = tsan_refits(replicas, single)
        seconds["refits"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["equal_after"] = equal("after the drive and the refit")
        seconds["equal_after"] = time.perf_counter() - t0
        # SIGTERM: each armed process drains and writes its report at exit
        t0 = time.perf_counter()
        seconds["fleet_drain"] = fleet.drain()
        log = fleet.log_text()
        assert fleet.proc.returncode == 0, log[-3000:]
        drains = drain_launches(log)
        assert len(drains) == 2, log[-3000:]
        import signal

        st["scorer"][0].send_signal(signal.SIGTERM)
        rc, stdout, stderr = _child_output(st["scorer"], 60)
        assert rc == 0, stderr[-3000:]
        drains.append(json.loads(stdout.strip().splitlines()[-1]))
        seconds["drains"] = time.perf_counter() - t0
        out["drains"] = drains
        if DEVICE == "cuda":
            # each replica's backlog refit ran both HW kernels; the scorer's
            # dispatches ran arima_predict
            for d in drains[:2]:
                assert d["hw_score"] >= 1 and d["hw_filter"] >= 1, drains
            assert drains[2]["arima_predict"] >= 1, drains
        st["t_dftsan"] = time.perf_counter()
        st["dftsan"] = _child(DFTSAN_CHILD, [st["reports"], "--format",
                                              "json"], st["tmp"], "dftsan")
    finally:
        for srv in servers.values():
            srv.shutdown()
        port["trace"].configure_tracing(port["trace"].TraceConfig())
    out["seconds"] = seconds
    return out


def tsan_findings(st: dict) -> dict:
    """The dftsan CLI child's verdict over (a)'s reports, read with the
    port's own ``analysis.dftsan.load_reports`` too: reports, locks, edges
    and violations observed, the attach classes seen, each rule's finding
    count, the static model's build time."""
    from distributed_forecasting_tpu_torch.analysis.dftsan import (
        load_reports,
    )

    rc, stdout, stderr = _child_output(st["dftsan"], 600)
    wall = time.perf_counter() - st["t_dftsan"]
    assert rc == 0, (rc, stdout[-3000:], stderr[-3000:])
    verdict = json.loads(stdout)
    spent = json.loads(stderr.strip().splitlines()[-1])["static_model_s"]
    merged, loaded = load_reports([st["reports"]])
    classes = sorted({lid[1] for lid in merged["locks"] if lid[1]})
    rules = {}
    for f in verdict["findings"]:
        rules[f["rule"]] = rules.get(f["rule"], 0) + 1
    out = {"reports": len(loaded), "locks": len(merged["locks"]),
           "edges": len(merged["edges"]),
           "violations": len(merged["violations"]),
           "modeled_edges": verdict["observed"]["modeled_edges"],
           "classes": classes, "rules": rules,
           "findings": [f"{f['path']}:{f['line']}: [{f['rule']}] "
                        f"{f['message']}" for f in verdict["findings"]],
           "counts": verdict["counts"], "suppressed": verdict["suppressed"],
           "baselined": verdict["baselined"],
           "static_model_s": spent, "cli_s": wall}
    assert len(loaded) == TSAN_REPORTS, loaded
    assert verdict["counts"]["error"] == 0, verdict["findings"]
    missing = sorted(set(TSAN_CLASSES) - set(classes))
    assert not missing, (missing, classes)
    return out


def oracle_compare(port, st: dict, card_line: str) -> dict:
    """(b): the oracle child's per-series CV MAPE against the curve
    model's CV on the card over the same series, summarized as
    ``scripts/prophet_parity.compare`` summarizes (its keys; the oracle's
    never say ``prophet``)."""
    rc, stdout, stderr = _child_output(st["oracle"], 600)
    assert rc == 0, stderr[-3000:]
    oracle = json.loads(stdout.strip().splitlines()[-1])
    oracle_wall = oracle["wall_s"]
    df = port["data"].load_sales_csv(DATA)
    keys = df[["store", "item"]].drop_duplicates().sort_values(
        ["store", "item"]).head(ORACLE_SERIES)
    batch = port["data"].tensorize(df.merge(keys, on=["store", "item"]),
                                   device=DEVICE)
    t0 = time.perf_counter()
    glm = port["cv"].cross_validate(batch, model="prophet",
                                    cv=port["cv"].CVConfig())["mape"]
    glm = glm.cpu().numpy().astype(np.float64)
    t_glm = time.perf_counter() - t0
    by_key = {tuple(r["key"]): r["mape"] for r in oracle["series"]}
    ref = np.asarray([by_key[tuple(int(v) for v in k)]
                      for k in batch.keys.tolist()], dtype=np.float64)
    assert ref.size == ORACLE_SERIES and np.isfinite(ref).all(), ref
    ok = np.isfinite(ref) & np.isfinite(glm)
    p_mean, g_mean = float(ref[ok].mean()), float(glm[ok].mean())
    rel = (g_mean - p_mean) / p_mean
    return {"dataset": f"real-shaped dataset, first {ORACLE_SERIES} series",
            "estimator": "prophet_map_oracle",
            "oracle_mape": round(p_mean, 5), "glm_mape": round(g_mean, 5),
            "rel_delta": round(rel, 5), "within_5pct": bool(rel <= 0.05),
            "n_series": int(ok.sum()),
            "glm_wins": int((glm[ok] <= ref[ok]).sum()),
            "oracle_wall_s": round(oracle_wall, 1),
            "glm_wall_s": round(t_glm, 2), "card": card_line}


def slice25_phase(port, card_line: str, started: dict = None) -> dict:
    """Phase 24: (a) the sanitizer armed on the card over the serving paths
    that launch the hand kernels, its reports joined by the port's dftsan;
    (b) the Prophet MAP oracle against the curve model's CV (the module
    docstring).  ``started``: :func:`start_tsan`'s state, or started
    here."""
    t_phase = time.perf_counter()
    own = started is None
    if own:
        started = start_tsan(port)
    out, seconds = {}, {}
    try:
        for k in KERNELS:  # counters to 0 just before the path
            wrapper(k).launches = 0
        t0 = time.perf_counter()
        out["dynamic"] = tsan_dynamic(port, started)
        seconds["dynamic"] = time.perf_counter() - t0
        # (b) on this thread while the dftsan child builds its model
        t0 = time.perf_counter()
        out["oracle"] = oracle_compare(port, started, card_line)
        seconds["oracle"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dftsan"] = tsan_findings(started)
        seconds["dftsan_wait"] = time.perf_counter() - t0
        here = hand_launches()  # ... and after it
    finally:
        stop_tsan(started)
    fit = started["fit_launches"] or {k: 0 for k in KERNELS}
    out["launches"] = {k: here[k] + fit[k] + sum(
        d[k] for d in out["dynamic"]["drains"]) for k in KERNELS}
    emit("launches", path="tsan", **out["launches"],
         expected="hw_score, hw_filter: the disarmed Holt-Winters scorer's "
                  "refit and each armed replica's (from their drain "
                  "lines); arima_predict: both arima scorers' dispatches "
                  "(the armed one's from its exit line)")
    out["seconds"] = time.perf_counter() - t_phase
    dyn = out["dynamic"]
    emit("tsan", card=card_line, ready_s=dyn["ready_s"],
         equal_before=dyn["equal_before"], equal_after=dyn["equal_after"],
         drive=dyn["drive"], refits=dyn["refits"], drains=dyn["drains"],
         **out["dftsan"])
    emit("oracle", **out["oracle"])
    emit("phase24", card=card_line, seconds=out["seconds"],
         parts={**seconds, **dyn["seconds"]})
    return out


# -- phase 25: the croston and theta recurrences on their kernels (ses.cu) ---

SES_VARIANTS = ("croston", "sba", "tsb")
# held-out days the streaming forms are compared and applied over
SES_STREAM_DAYS = 7
# each kernel's device time at the fit shape tiled this many times over T:
# the slope over T is its cycles a step (as SLOPE_TILES for hw_filter)
SES_SLOPE_TILES = (1, 2, 4)


def _same_bits(a, b) -> bool:
    """Equal element for element, NaN where the other has NaN."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def ses_shape_cases(port, y, mask, day) -> dict:
    """The kernels' inputs for one (y, mask) grid, time-major, as the fits
    form them: croston under every variant from the fit's own carries,
    and theta's SES of the seven alphas from its theta line and head
    means."""
    cr, th = port["croston"], port["theta"]
    tm = lambda x: x.t().contiguous()  # noqa: E731
    out = {}
    for v in SES_VARIANTS:
        out[f"croston_{v}"] = ("croston_filter", (
            tm(y), tm(mask), cr.initial_carry(y, mask, v),
            cr.CrostonConfig(variant=v), None))
    cfg = th.ThetaConfig()
    zl = th._lines(y, mask, day, cfg)[5]
    alpha = torch.tensor(cfg.alphas, device=y.device)[None].expand(
        y.shape[0], len(cfg.alphas)).contiguous()
    out["theta"] = ("ses_filter", (tm(zl), tm(mask), th.head_level(zl, mask),
                                   alpha, None))
    return out


def ses_stream_cases(port, batch) -> dict:
    """The streaming update's forms over SES_STREAM_DAYS held-out days (one
    a gap): croston's with its squared-error sums, every variant, and
    theta's scored form (one alpha a row), from seeded carries."""
    cr, th = port["croston"], port["theta"]
    g = torch.Generator().manual_seed(25)
    S, dev = batch.n_series, batch.y.device
    tm = lambda x: x.t().contiguous()  # noqa: E731
    rnd = lambda lo, hi: (lo + (hi - lo) * torch.rand(  # noqa: E731
        S, generator=g)).to(dev)
    y = torch.as_tensor(stream_tail(batch, SES_STREAM_DAYS), device=dev)
    m = torch.ones_like(y)
    m[:, 2] = 0.0
    out = {}
    for v in SES_VARIANTS:
        carry = ((rnd(1, 20), rnd(0.05, 1)) if v == "tsb"
                 else (rnd(1, 20), rnd(1, 10), rnd(0, 5).round()))
        out[f"stream_croston_{v}"] = ("croston_filter", (
            tm(y), tm(m), carry, cr.CrostonConfig(variant=v),
            (rnd(0, 1e4), rnd(100, 1000).round())))
    alphas = torch.tensor(th.ThetaConfig().alphas)
    one = alphas[torch.randint(0, len(alphas), (S,), generator=g)]
    ones = torch.ones_like(y)
    out["stream_theta"] = ("ses_filter", (
        tm(y * 0.9 + 2.0), tm(m), rnd(1, 50), one[:, None].to(dev),
        (tm(y), tm(ones * rnd(5, 50)[:, None]),
         tm(ones * rnd(0.5, 1.5)[:, None]), 2.0, rnd(0, 1e4),
         rnd(100, 1000).round())))
    return out


def _ses_call(port, kernel, case, twin=False) -> tuple:
    """One call of ``kernel`` (or its twin) on a case: its outputs, flat."""
    ses = port["ses"]
    if kernel == "croston_filter":
        y, mask, carry, cfg, sums = case
        fn = ses.croston_filter_reference if twin else ses.croston_filter
        path, c, s = fn(y, mask, carry, cfg.alpha, cfg.variant, cfg.beta,
                        sums=sums)
        return (path, *c, *(s or ()))
    fn = ses.ses_filter_reference if twin else ses.ses_filter
    out = fn(*case[:4], scored=case[4])
    return out if case[4] is not None else (out,)


def _ses_launch(port, kernel, case):
    """The bound launch of a case (``ops/ses._*_launcher``): timed calls
    then only launch."""
    ses = port["ses"]
    if kernel == "croston_filter":
        y, mask, carry, cfg, sums = case
        return ses._croston_filter_launcher(y, mask, carry, cfg.alpha,
                                            cfg.variant, cfg.beta, sums)[0]
    return ses._ses_filter_launcher(*case)[0]


def _ses_work(port, kernel, case) -> tuple:
    """(operations, bytes) of a case (``ops/ses.*_work``)."""
    T, S = case[0].shape
    if kernel == "croston_filter":
        return port["ses"].croston_filter_work(S, T, case[3].variant,
                                               case[4] is not None)
    return port["ses"].ses_filter_work(S, T, case[3].shape[1],
                                       case[4] is not None)


def ses_kernel_cases(port, cases: dict) -> dict:
    """Each kernel against its twin on the card, bit for bit, case by case;
    each twin runs once (its time one CUDA-event interval), the kernel's
    time is the median of REPS samples of 20 back-to-back bound launches,
    beside the device-paced time and the bound of the case's work."""
    out = {k: {} for k in SES_KERNELS}
    for name, (kernel, case) in cases.items():
        got = _ses_call(port, kernel, case)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = _ses_call(port, kernel, case, twin=True)
        stop.record()
        torch.cuda.synchronize()
        equal = all(_same_bits(a, b) for a, b in zip(got, want))
        err = max(float((a - b).abs().nan_to_num(0.0).max())
                  for a, b in zip(got, want))
        launch = _ses_launch(port, kernel, case)
        bound, by = bound_ms(_ses_work(port, kernel, case))
        T, S = case[0].shape
        out[kernel][name] = {
            "shape": [S, T] + ([case[3].shape[1]] if kernel == "ses_filter"
                               else []),
            "bitwise": equal, "max_abs_err": err,
            "ms": cuda_ms(launch, inner=20), **device_ms(launch),
            "plain_ms": start.elapsed_time(stop), "bound_ms": bound,
            "bound_by": by, "pass": equal}
        if not equal:
            DEFERRED.append(f"{kernel} differs from its twin at {name}")
    return out


def ses_slopes(port, batch) -> dict:
    """SBA's and the seven-alpha SES's device times at the fit shape with
    T tiled SES_SLOPE_TILES times: the slope over T in cycles a step at
    CLOCK_HZ, beside the chain read from the SASS."""
    times = {"croston_filter": [], "ses_filter": []}
    steps = []
    for n in SES_SLOPE_TILES:
        y, mask = batch.y.repeat(1, n), batch.mask.repeat(1, n)
        day = torch.arange(y.shape[1], device=y.device)
        cases = ses_shape_cases(port, y, mask, day)
        steps.append(int(y.shape[1]))
        for name in ("croston_sba", "theta"):
            kernel, case = cases[name]
            launch = _ses_launch(port, kernel, case)
            times[kernel].append(device_ms(launch)["device_ms"]
                                 or cuda_ms(launch, inner=20))
        del cases
    out = {}
    for kernel, chain in (("croston_filter", CROSTON_CHAIN_CYCLES),
                          ("ses_filter", SES_CHAIN_CYCLES)):
        slope, icpt = np.polyfit(steps, times[kernel], 1)
        out[kernel] = {"T": steps, "device_ms": times[kernel],
                       "cycles_per_step": slope * 1e-3 * CLOCK_HZ,
                       "intercept_ms": icpt,
                       "chain_cycles_per_step": chain}
    return out


def ses_main_path(port, batch) -> dict:
    """The slice's main path through the entry points a user calls, at the
    full width: ``engine.fit_forecast`` of croston under each variant and
    of theta, ``engine.cv.cross_validate`` of each (one CV pass), and one
    streaming apply (``ops/update.apply_update``) of SES_STREAM_DAYS
    held-out days from each family's fit."""
    eng, cvm, upd = port["engine"], port["cv"], port["update"]
    cr, th, models = port["croston"], port["theta"], port["models"]
    out = {}
    for v in SES_VARIANTS:
        out[f"croston_{v}"] = eng.fit_forecast(
            batch, "croston", cr.CrostonConfig(variant=v), horizon=90)
    out["theta"] = eng.fit_forecast(batch, "theta", th.ThetaConfig(),
                                    horizon=90)
    for model in ("croston", "theta"):
        out[f"{model}_cv"] = cvm.cross_validate(batch, model,
                                                cv=cvm.CVConfig(**CV))
    y_new = torch.as_tensor(stream_tail(batch, SES_STREAM_DAYS),
                            device=batch.y.device)
    m_new = torch.ones_like(y_new)
    days = np.arange(int(batch.day[-1]) + 1,
                     int(batch.day[-1]) + 1 + SES_STREAM_DAYS)
    for model, key in (("croston", "croston_sba"), ("theta", "theta")):
        params = out[key][0]
        fns = models.get_model(model)
        aux = fns.init_update_aux(params, y=batch.y, mask=batch.mask)
        out[f"{model}_update"] = upd.apply_update(
            model, fns.config_cls(), params, aux, y_new, m_new,
            np.ones(SES_STREAM_DAYS, np.float32), days)
    return out


def ses_check(port, batch, run: dict) -> dict:
    """What the main path gave: finite forecasts of the grid's shape on
    every healthy row, finite CV metrics, updated states of the right
    shape; then 20 series on the CPU (the twins) against the card within
    1e-5 of each row's scale (the kernels are bitwise their twins; the
    means before them reduce in another order on each device)."""
    S, T = batch.n_series, batch.n_time
    for key in ("croston_croston", "croston_sba", "croston_tsb", "theta"):
        _, res = run[key]
        assert res.yhat.shape == (S, T + 90), (key, res.yhat.shape)
        assert bool(res.ok.any()), key
        assert bool(torch.isfinite(res.yhat[res.ok]).all()), key
    for key in ("croston_cv", "theta_cv"):
        assert bool(torch.isfinite(run[key]["rmse"]).all()), key
    for key in ("croston_update", "theta_update"):
        params, aux, preds = run[key]
        assert preds.shape == (S, SES_STREAM_DAYS), preds.shape
        assert bool(torch.isfinite(preds).all()), key
    eng, cr, th = port["engine"], port["croston"], port["theta"]
    cpu = dataclasses.replace(batch, y=batch.y[:20].cpu(),
                              mask=batch.mask[:20].cpu(),
                              day=batch.day.cpu(), keys=batch.keys[:20])
    scale = cpu.y.abs().amax(1, keepdim=True).clamp_min(1.0)
    worst = {}
    for key, model, cfg in (("croston_sba", "croston", cr.CrostonConfig()),
                            ("theta", "theta", th.ThetaConfig())):
        want = eng.fit_forecast(cpu, model, cfg, horizon=90)[1]
        got = run[key][1]
        err = float(((got.yhat[:20].cpu() - want.yhat).abs()
                     / scale).max())
        assert err <= 1e-5, (key, err)
        worst[key] = err
    return {"rows": 20, "max_rel_diff": worst}


def slice26_phase(port, card_line: str, earlier: dict) -> dict:
    """Phase 25: the croston and theta recurrences on their hand kernels
    (``csrc/ses.cu``).  (a) Each kernel against its twin on the card, bit
    for bit, at the fit and CV shapes (every croston variant) and in the
    streaming update's forms, with its times beside its bounds and the
    twin's time; the slopes over T.  (b) The main path through the entry
    points, the counters set to 0 just before it and read after: one
    launch a fit, a CV pass and an update.  (c) Of the earlier phases, now
    on the kernels: the blend dispatch's time, idle share and device
    events (phase 8), the theta fit's time (phase 9), the /ingest p99 per
    family (phase 16), and each phase's launches of the two kernels."""
    t_phase = time.perf_counter()
    batch = port["data"].tensorize(port["data"].load_sales_csv(DATA))
    assert (batch.n_series, batch.n_time) == SHAPE
    cases = ses_shape_cases(port, batch.y, batch.mask, batch.day)
    cv_y, cv_mask = cv_inputs(batch, port["cv"])
    cases.update({f"cv_{k}": v for k, v in ses_shape_cases(
        port, cv_y, cv_mask, batch.day).items()})
    cases = {(k if k.startswith("cv_") else f"fit_{k}"): v
             for k, v in cases.items()}
    cases.update(ses_stream_cases(port, batch))
    out = {"cases": ses_kernel_cases(port, cases)}
    del cases
    out["slopes"] = ses_slopes(port, batch)
    for k in SES_KERNELS:  # counters to 0 just before the path
        wrapper(k).launches = 0
    t0 = time.perf_counter()
    run = ses_main_path(port, batch)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    out["launches"] = {k: wrapper(k).launches for k in SES_KERNELS}  # after
    expected = {"croston_filter": len(SES_VARIANTS) + 2, "ses_filter": 3}
    emit("launches", path="ses", **out["launches"],
         expected="croston_filter: 1 a fit (3 variants), 1 for the CV "
                  "pass, 1 for the update; ses_filter: 1 for the fit, 1 "
                  "for the CV pass, 1 for the update")
    assert out["launches"] == expected, (out["launches"], expected)
    out["check"] = ses_check(port, batch, run)
    del run
    pooled, complete, streaming = (earlier["pooled"], earlier["complete"],
                                   earlier["streaming"])
    dispatch = pooled["times"]["dispatch_profile"]
    out["earlier"] = {
        "blend_dispatch": {
            "ms": pooled["times"]["dispatch_ms"],
            "idle_share": dispatch.get("idle_share"),
            "device_events": dispatch.get("device_events"),
            "hand_launches": dispatch.get("hand_launches"),
            "events_by_kind": dispatch.get("events_by_kind")},
        "croston_fit": pooled["times"]["croston"],
        "theta_fit": complete["times"]["theta_fit"],
        "ses": complete["times"]["ses"],
        "post_ingest_500": streaming["times"]["post_ingest_500"],
        "launches_by_phase": earlier["launches_by_phase"]}
    out["seconds"] = time.perf_counter() - t_phase
    emit("slice26", card=card_line, cases=out["cases"], slopes=out["slopes"],
         main_path_s=path_s, check=out["check"], **out["earlier"])
    emit("phase25", card=card_line, seconds=out["seconds"])
    return out


# -- kernel times on the device: cycles a step, chains, the launch floor -----

# hw_filter at T = 1,826 x each of these tiles of the committed rows: the
# slope of its device time over T is its cycles a step (at CLOCK_HZ), the
# intercept its launch, prologue and epilogue
SLOPE_TILES = (1, 2, 4)
SLOPE_CASES = (("additive_m7", 7, "additive"),
               ("multiplicative_m7", 7, "multiplicative"),
               ("additive_m30", 30, "additive"))
# hw_filter's serial chain a step, read from the SASS of its m 7 additive
# step loop (scripts/cuda_kernel_report.py --chain
# hw_filter_kernelILi7ELb0ELb0ELi480E: 784 cycles a 28-step block): the
# longest dependent path the loop carries from b at step t to b at step
# t + 1, 7 instructions (FMUL FADD FMUL FADD FADD FMUL FADD: the select is a
# predicated write) at 4 cycles each; the same 7 in the first design's loop
HW_CHAIN_CYCLES = 28
# arima_predict's chain a forecast step at r 2, read the same way from its
# chain warp's loop (--chain arima_predict_kernelILi2E: 80 cycles a 4-step
# trip), 5 instructions from P_00 to the next P_00
ARIMA_PREDICT_CHAIN_CYCLES = 20
PROBE_FIELDS = 7  # csrc/hw_filter.cu: what a probe block records


def measurement_entries(lib):
    """Bind the library's measurement-only C entries, where it has them
    (csrc/arima_kalman.cu's empty kernel, csrc/hw_filter.cu's probe
    instance); no module of the port calls them."""
    if hasattr(lib, "arima_empty_launch"):
        lib.arima_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.arima_empty_launch.restype = ctypes.c_int
    if hasattr(lib, "hw_filter_probe_launch"):
        lib.hw_filter_probe_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.hw_filter_probe_launch.restype = ctypes.c_int
    return lib


def hw_filter_probe(lib, y, mask, won, init, m: int, mode: str,
                    want) -> dict:
    """One launch of hw_filter's measurement instance on the same inputs as
    the launcher whose outputs are ``want``: the consumer's cycles a step
    in its step loop and in the chunk barriers, the prologue's cycles, the
    SM clock (clock64 over the global timer), and whether its outputs equal
    the kernel's bit for bit."""
    S, T = (int(d) for d in y.shape)
    dev = y.device
    blocks = (S + 31) // 32
    probe = torch.zeros(blocks * PROBE_FIELDS, dtype=torch.int64, device=dev)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    outs = (new(S), new(S), new(S, m), new(S), new(S, T))
    tensors = (y, mask, *won, *init, *outs, probe)
    args = [ctypes.c_void_p(x.data_ptr()) for x in tensors]
    args += [S, T, m, int(mode == "multiplicative"),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)]
    for _ in range(2):  # the second launch is read
        with torch.cuda.device(dev):
            err = lib.hw_filter_probe_launch(*args)
        assert err == 0, f"hw_filter_probe_launch: {err}"
    torch.cuda.synchronize()
    p = probe.cpu().numpy().reshape(blocks, PROBE_FIELDS).astype(np.float64)
    (l, b, s), mse, path = want
    equal = all(torch.equal(torch.nan_to_num(a, nan=0.0),
                            torch.nan_to_num(w, nan=0.0))
                for a, w in zip(outs, (l, b, s, mse, path)))
    loop, waited = p[:, 2] - p[:, 1], p[:, 3]
    return {"cycles_per_step": float(np.median((loop - waited) / T)),
            "barrier_cycles_per_step": float(np.median(waited / T)),
            "prologue_cycles": float(np.median(p[:, 1] - p[:, 0])),
            "clock_ghz": float(np.median((p[:, 2] - p[:, 0])
                                         / (p[:, 5] - p[:, 4]))),
            "blocks": blocks, "sms": int(len(np.unique(p[:, 6]))),
            "equals_kernel": bool(equal)}


def hw_filter_slope(port, batch, lib=None) -> dict:
    """hw_filter's device time (:func:`device_ms`) and host-paced time
    (:func:`cuda_ms`) at the fit width and T = 1,826 x :data:`SLOPE_TILES`
    for each of :data:`SLOPE_CASES` (the default grid's winners on the
    committed rows, tiled along time); the least-squares slope in cycles a
    step and the intercept (None where a device time is); the chain read
    from the SASS and its share of the time; and, given ``lib`` with the
    probe entry, the probe instance's split at T = 1,826."""
    hw, fs = port["hw"], port["fs"]
    probe_ok = lib is not None and hasattr(lib, "hw_filter_probe_launch")
    out = {}
    for name, m, mode in SLOPE_CASES:
        grid = hw._candidate_grid(hw.HoltWintersConfig(season_length=m),
                                  device=batch.y.device)
        best = fs.hw_score(batch.y, batch.mask, *grid, m).argmin(1)
        won = tuple(x[best].contiguous() for x in grid)
        rows = []
        for k in SLOPE_TILES:
            y = batch.y.repeat(1, k).contiguous()
            mask = batch.mask.repeat(1, k).contiguous()
            init = [x.contiguous() for x in hw._init_state(y, mask, m, mode)]
            launch, result = fs._hw_filter_launcher(y, mask, *won, *init,
                                                    mode)
            row = {"T": int(y.shape[1]), **device_ms(launch),
                   "ms": cuda_ms(launch, inner=20)}
            if k == 1 and probe_ok:
                row["probe"] = hw_filter_probe(lib, y, mask, won, init, m,
                                               mode, result)
            rows.append(row)
        T = rows[0]["T"]
        chain = T * HW_CHAIN_CYCLES / CLOCK_HZ * 1e3
        out[name] = {"S": int(batch.y.shape[0]), "m": m, "mode": mode,
                     "rows": rows, "cycles_per_step": None,
                     "intercept_ms": None, "sass_chain_ms": chain,
                     "chain_share": None}
        if all(r["covered"] for r in rows):
            slope, icpt = np.polyfit([r["T"] for r in rows],
                                     [r["device_ms"] for r in rows], 1)
            out[name].update(cycles_per_step=float(slope) * 1e-3 * CLOCK_HZ,
                             intercept_ms=float(icpt),
                             chain_share=chain / rows[0]["device_ms"])
    return out


# hw_filter across fleet sizes (kernel_times): the fit width, one row past
# one block an SM, and the streaming phase's 20,480 series, all at
# T 1,826, m 7, additive (the rows of the committed data repeated)
FLEET_ROWS = (500, "wave+1", 20_480)


def hw_filter_fleet(port, batch) -> dict:
    """hw_filter's device time and host-paced time at each of
    :data:`FLEET_ROWS` ("wave+1": 32 rows an SM, plus one), with its blocks
    and the card's SMs: the kernel takes fifteen producer warps a block
    while its grid fits one wave of them, seven past it."""
    hw, fs = port["hw"], port["fs"]
    sms = torch.cuda.get_device_properties(batch.y.device).multi_processor_count
    grid = hw._candidate_grid(hw.HoltWintersConfig(), device=batch.y.device)
    best = fs.hw_score(batch.y, batch.mask, *grid, 7).argmin(1)
    out = []
    for rows in FLEET_ROWS:
        S = 32 * sms + 1 if rows == "wave+1" else rows
        idx = torch.arange(S, device=batch.y.device) % batch.y.shape[0]
        y, mask = batch.y[idx].contiguous(), batch.mask[idx].contiguous()
        won = tuple(x[best[idx]].contiguous() for x in grid)
        init = [x.contiguous() for x in hw._init_state(y, mask, 7,
                                                       "additive")]
        launch, _ = fs._hw_filter_launcher(y, mask, *won, *init, "additive")
        out.append({"S": S, "blocks": (S + 31) // 32, "sms": sms,
                    **device_ms(launch), "ms": cuda_ms(launch, inner=20)})
    return out


def arima_predict_floor(port, pargs, lib) -> dict:
    """arima_predict at ``pargs`` timed two ways (host-paced ``ms``, and
    ``device_ms``), beside an empty kernel launched the same way (the bound
    Python launcher's ``torch.cuda.device``, ctypes call and status check)
    timed both ways; its byte bound, its chain (H x
    ARIMA_PREDICT_CHAIN_CYCLES), the largest of the three as
    ``floor_bound_ms`` and its share of the device time; and the host's
    part, the wall time of one ``arima_predict()`` call with no sync."""
    kal = port["kalman"]
    phi, theta, a0, P0, sigma2, r, H = pargs
    S = int(a0.shape[0])
    dev = a0.device
    launch, _ = kal._arima_predict_launcher(*pargs)
    out = {"shape": [S, H, r], "ms": cuda_ms(launch, inner=20),
           **device_ms(launch)}
    host = []
    for _ in range(5):
        for _ in range(40):
            t0 = time.perf_counter()
            kal.arima_predict(*pargs)
            host.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    bytes_ms, _ = bound_ms(kal.arima_predict_work(S, H, r))
    chain_ms = H * ARIMA_PREDICT_CHAIN_CYCLES / CLOCK_HZ * 1e3
    out.update(host_call_us=statistics.median(host), bytes_bound_ms=bytes_ms,
               sass_chain_ms=chain_ms)
    if hasattr(lib, "arima_empty_launch"):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        blocks = (S + 31) // 32

        def empty():
            with torch.cuda.device(dev):
                err = lib.arima_empty_launch(blocks, stream)
            if err:
                raise RuntimeError(f"arima_empty_launch: {err}")

        e = device_ms(empty)
        floors = {"bytes": bytes_ms, "chain": chain_ms}
        if e["covered"]:
            floors["launch floor"] = e["device_ms"]
        by = max(floors, key=floors.get)
        out.update(empty_ms=cuda_ms(empty, inner=20),
                   empty_device_ms=e["device_ms"],
                   empty_covered=e["covered"],
                   floor_bound_ms=floors[by], floor_bound_by=by,
                   floor_share=(floors[by] / out["device_ms"]
                                if out["covered"] else None))
    return out


def predict_args(port, batch) -> tuple:
    """arima_predict's arguments on the main path's forecast at the fit
    shape: the default (2, 1, 1) fit's state after the grid, H 91."""
    kal = port["kalman"]
    fit_args = arima_args(port, batch.y * batch.mask, batch.mask,
                          port["arima"].ArimaConfig())
    out = kal.arima_filter(*fit_args)
    sigma2 = out.ssq / torch.clamp_min(out.n, 1.0)
    return (fit_args[4], fit_args[5], out.a_T, out.P_T, sigma2,
            fit_args[7], 91)


def kernel_times(port, card_line: str, probe: bool = True) -> dict:
    """``chip_smoke.py --kernel-times``: hw_filter's slope and, with
    ``probe``, split (:func:`hw_filter_slope`), its times across fleet sizes
    (:func:`hw_filter_fleet`), arima_predict against its launch floor
    (:func:`arima_predict_floor`), hw_score's two times at the fit shape,
    and croston_filter's and ses_filter's slopes over T
    (:func:`ses_slopes`), nothing else.  Runs against whichever copy of the port
    ``--package-root`` put first on the path (the probe is skipped for
    another copy, whose entry may take other arguments, and the empty
    kernel where its library lacks it), so that two commits can be compared
    in one call on one card."""
    from distributed_forecasting_tpu_torch.ops import _build

    data, hw, fs = port["data"], port["hw"], port["fs"]
    lib = measurement_entries(_build.library())
    batch = data.tensorize(data.load_sales_csv(DATA))
    grid = hw._candidate_grid(hw.HoltWintersConfig(), device=batch.y.device)
    init = [x.contiguous() for x in hw._init_state(batch.y, batch.mask, 7,
                                                   "additive")]
    launch, _ = fs._hw_score_launcher(batch.y, batch.mask, *grid, *init)
    out = {"package": os.path.dirname(os.path.dirname(
               os.path.abspath(fs.__file__))),
           "hw_filter": hw_filter_slope(port, batch,
                                        lib if probe else None),
           "hw_filter_fleet": hw_filter_fleet(port, batch),
           "arima_predict": arima_predict_floor(
               port, predict_args(port, batch), lib),
           "hw_score": {"ms": cuda_ms(launch, inner=20),
                        **device_ms(launch)}}
    if port["ses"] is not None:  # a copy that has the kernels
        out["ses"] = ses_slopes(port, batch)
    emit("kernel_times", card=card_line, reps=REPS, statistic="median",
         hw_chain_cycles_read_from_sass=HW_CHAIN_CYCLES,
         arima_predict_chain_cycles_read_from_sass=ARIMA_PREDICT_CHAIN_CYCLES,
         clock_hz=CLOCK_HZ, **out)
    return out


KERNELS = {
    "hw_score": ("distributed_forecasting_tpu_torch/csrc/hw_score.cu",
                 "distributed_forecasting_tpu/ops/fused_scan.py:199"),
    # no Pallas origin: the reference's lax.scan filter
    "hw_filter": ("distributed_forecasting_tpu_torch/csrc/hw_filter.cu",
                  "distributed_forecasting_tpu/models/holt_winters.py:170"),
    # no Pallas origin: the reference's Kalman lax.scan (and, for d = 1, the
    # integration scan) and the forecast's predict-only lax.scan
    "arima_filter": ("distributed_forecasting_tpu_torch/csrc/arima_kalman.cu",
                     "distributed_forecasting_tpu/models/arima.py:224"),
    "arima_predict": ("distributed_forecasting_tpu_torch/csrc/arima_kalman.cu",
                      "distributed_forecasting_tpu/models/arima.py:587"),
    # no Pallas origin: the reference's reverse-mode autodiff of its Kalman
    # scan inside the MLE fit's Adam loop (jax.value_and_grad of nll_one)
    "arima_loglik_grad": ("distributed_forecasting_tpu_torch/csrc/arima_mle.cu",
                          "distributed_forecasting_tpu/models/arima.py:418"),
    # no Pallas origin: the reference's lax.scan of fit_steps Adam steps
    # (fit_one), each a value_and_grad of nll_one
    "arima_mle_fit": ("distributed_forecasting_tpu_torch/csrc/arima_mle.cu",
                      "distributed_forecasting_tpu/models/arima.py:427"),
    # no Pallas origin: the reference's Croston / SBA lax.scan (TSB's at
    # :127, the streaming update's at :210 and :231)
    "croston_filter": ("distributed_forecasting_tpu_torch/csrc/ses.cu",
                       "distributed_forecasting_tpu/models/croston.py:142"),
    # no Pallas origin: theta's SES lax.scan (_ses_path; the streaming
    # update's at :236)
    "ses_filter": ("distributed_forecasting_tpu_torch/csrc/ses.cu",
                   "distributed_forecasting_tpu/models/theta.py:104"),
}
# the kernels of ops/ses.py (the croston and theta recurrences)
SES_KERNELS = ("croston_filter", "ses_filter")


def load_port() -> dict:
    """The port's modules the phases use, by name (a phase run alone takes
    this dict, after ``ops._build.library()``)."""
    from distributed_forecasting_tpu_torch import data, engine, serving
    from distributed_forecasting_tpu_torch.engine import cv
    from distributed_forecasting_tpu_torch.models import holt_winters as hw
    from distributed_forecasting_tpu_torch.models import prophet_glm as pg
    from distributed_forecasting_tpu_torch.ops import fused_scan as fs
    from distributed_forecasting_tpu_torch.ops import solve
    from distributed_forecasting_tpu_torch.pipelines import training
    from distributed_forecasting_tpu_torch import tracking
    from distributed_forecasting_tpu_torch.engine import blend, season
    from distributed_forecasting_tpu_torch.engine import calibrate as cal
    from distributed_forecasting_tpu_torch.models import arima, croston, theta
    from distributed_forecasting_tpu_torch.engine import order
    from distributed_forecasting_tpu_torch.ops import kalman
    from distributed_forecasting_tpu_torch import monitoring, tasks
    from distributed_forecasting_tpu_torch.reconcile import hierarchy
    from distributed_forecasting_tpu_torch.tasks import reconcile as rec_task
    from distributed_forecasting_tpu_torch.utils import config
    from distributed_forecasting_tpu_torch.workflows import runner
    from distributed_forecasting_tpu_torch.data import dataset, native
    from distributed_forecasting_tpu_torch.monitoring import quality
    from distributed_forecasting_tpu_torch.serving import anomaly, batcher, server
    from distributed_forecasting_tpu_torch.engine import autoprep
    from distributed_forecasting_tpu_torch.engine import gradfit
    from distributed_forecasting_tpu_torch.models import arnet
    from distributed_forecasting_tpu_torch.engine import hyper, select
    from distributed_forecasting_tpu_torch.ops import precision
    from distributed_forecasting_tpu_torch import convert, models
    from distributed_forecasting_tpu_torch.engine import state_store
    from distributed_forecasting_tpu_torch.ops import update
    from distributed_forecasting_tpu_torch.serving import ingest
    from distributed_forecasting_tpu_torch.tasks import serve as serve_task
    from distributed_forecasting_tpu_torch.engine import windowed
    from distributed_forecasting_tpu_torch.ops import combine
    from distributed_forecasting_tpu_torch.serving import refit
    from distributed_forecasting_tpu_torch.engine import (
        compile_cache,
        executor,
    )
    from distributed_forecasting_tpu_torch.monitoring import cost, trace
    from distributed_forecasting_tpu_torch.ops import _build
    try:
        from distributed_forecasting_tpu_torch.ops import ses
    except ImportError:  # a copy from before csrc/ses.cu (--package-root)
        ses = None

    return dict(data=data, engine=engine, cv=cv, serving=serving, hw=hw, fs=fs,
                pg=pg, solve=solve, training=training, tracking=tracking,
                cal=cal, config=config, runner=runner, blend=blend,
                croston=croston, season=season, theta=theta,
                monitoring=monitoring, tasks=tasks, reconcile=hierarchy,
                reconcile_task=rec_task, arima=arima, kalman=kalman,
                order=order, dataset=dataset, native=native,
                quality=quality, batcher=batcher, server=server,
                anomaly=anomaly, autoprep=autoprep, gradfit=gradfit,
                arnet=arnet, hyper=hyper, select=select, precision=precision,
                convert=convert, models=models, state_store=state_store,
                update=update, ingest=ingest, serve_task=serve_task,
                windowed=windowed, combine=combine, refit=refit,
                compile_cache=compile_cache, executor=executor, cost=cost,
                trace=trace, build=_build, ses=ses)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "NVIDIA GPU (see the module docstring).")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only build and time the kernels (kernel_times)")
    ap.add_argument("--package-root",
                    help="import the port from this directory (a checkout "
                         "of another commit) instead of this one")
    ap.add_argument("--parallel-rank", metavar="PLAN",
                    help="run one rank of phase 22 (b) from its JSON plan "
                         "(parallel_rank); the phase starts these itself")
    ns = ap.parse_args(argv)
    if ns.parallel_rank:
        print(json.dumps(parallel_rank(json.loads(ns.parallel_rank))),
              flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if ns.package_root:
        sys.path.insert(0, os.path.abspath(ns.package_root))
    if ns.kernel_times:
        port = load_port()
        card_line = card()
        print(card_line, flush=True)
        kernel_times(port, card_line, probe=not ns.package_root)
        return 0
    t_start = time.perf_counter()
    # the port comes from this checkout: without it, fail before any output
    port = load_port()
    from distributed_forecasting_tpu_torch.ops import _build
    fs = port["fs"]
    data = port["data"]
    native_before = native_snapshot()
    card_line = card()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(card_line, flush=True)

    t0 = time.perf_counter()
    # phase 18 (c)'s cold child builds beside this build (see there)
    start_cold_store_child()
    _build.library()
    emit("build", kernels=list(KERNELS), sources=_build.SOURCES,
         seconds=time.perf_counter() - t0,
         beside="phase 18 (c)'s cold library-store child, building too")

    batch = data.tensorize(data.load_sales_csv(DATA))
    cases = kernel_cases(batch, port)
    curve_solve_cases(batch, port)

    counters = {"hw_score": fs.hw_score, "hw_filter": fs.hw_filter}
    for fn in counters.values():  # counters to 0 just before the main path
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        run = main_path(port, tmp)
    launches = {k: fn.launches for k, fn in counters.items()}  # ... and after
    emit("launches", **launches,
         expected="each: 1 per fit_forecast + 1 per CV pass")
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched {k}")

    check_outputs(run, port)
    t = timings(run, port, card_line)

    for fn in counters.values():  # the curve path: counters to 0 again
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        curve_run = curve_main_path(port, tmp)
    emit("launches", path="curve", **{k: fn.launches for k, fn in
                                      counters.items()},
         expected="0: the curve path runs no hand kernel")
    check_curve_outputs(curve_run, port)
    curve_timings(curve_run, port, card_line)

    spec = e2e_spec(port)
    with tempfile.TemporaryDirectory() as root:
        # twice in one env root: the second run's monitor scans drift
        # against the first run's forecast table
        for version in (1, 2):
            for fn in counters.values():  # the workflow path: counters to 0
                fn.launches = 0
            wf_run = workflow_main_path(port, root, spec)
            emit("launches", path="workflow", **{k: fn.launches for k, fn in
                                                 counters.items()},
                 expected="0: the workflow's curve model runs no hand kernel")
            check_workflow(wf_run, port, root, spec, version=version)
        wt = workflow_timings(port, root, spec, card_line)
        conformal_vs_cpu(port, wt["state"]["batch"], wt["state"]["config"],
                         wt["cv_conf"])
    by_phase = {}  # each phase's launches of the croston and theta kernels

    def tracked(name, fn):
        """``fn()``, with its launches of SES_KERNELS: the phase's own
        count where it reports one (the phases that set every counter to
        0 themselves), else the counters' difference across it."""
        before = {k: wrapper(k).launches for k in SES_KERNELS}
        res = fn()
        own = res.get("launches", {}) if isinstance(res, dict) else {}
        by_phase[name] = {k: own[k] if k in own
                          else wrapper(k).launches - before[k]
                          for k in SES_KERNELS}
        return res

    pooled = tracked("8_pooled", lambda: pooled_phase(port, counters,
                                                      card_line))
    complete = tracked("9_complete", lambda: complete_phase(port, counters,
                                                            card_line))
    arima_out = tracked("10_arima", lambda: arima_phase(port, card_line))
    ragged = tracked("11_slice9", lambda: slice9_phase(port, counters,
                                                       card_line))["bucketed"]
    scorer = tracked("12_scorer", lambda: scorer_phase(port, card_line))
    prep = tracked("13_prep", lambda: prep_phase(port, counters, card_line))
    rng_paths = tracked("14_slice13", lambda: slice13_phase(port, card_line))
    p8_end = tracked("15_slice14", lambda: slice14_phase(port, card_line))
    streaming = tracked("16_streaming", lambda: slice15_phase(port,
                                                             card_line))
    windowed = tracked("17_windowed", lambda: slice17_phase(port, card_line))
    runtime = tracked("18_runtime", lambda: slice19_phase(port, card_line))
    scorer_rt = tracked("19_scorer_runtime", lambda: slice20_phase(
        port, card_line))
    fleet = tracked("20_fleet", lambda: slice21_phase(port, card_line))
    # phases 23's and 24's processes boot beside phase 21's fleets (see
    # start_mesh_fleets, start_tsan); phase 24's on phase 23's artifacts
    mesh_fleets = start_mesh_fleets(port)
    try:
        tsan = start_tsan(port, mesh_fleets["arts"], mesh_fleets["root"])
        try:
            cache = tracked("21_cache", lambda: slice22_phase(
                port, card_line, before_timing=lambda: (
                    mesh_fleets_ready(mesh_fleets), tsan_ready(tsan))))
            parallel = tracked("22_parallel", lambda: slice23_phase(
                port, card_line))
            mesh = tracked("23_mesh", lambda: slice24_phase(
                port, card_line, mesh_fleets))
            sanitized = tracked("24_tsan", lambda: slice25_phase(
                port, card_line, tsan))
        finally:
            stop_tsan(tsan)
    finally:
        stop_mesh_fleets(mesh_fleets)
    # the phases that fit croston or theta on the card must have launched
    # the kernels: phase 8's blends (croston), phase 9's theta workflow and
    # pool, phase 10's model: auto, phase 16's streamed families
    emit("launches", path="ses_by_phase", **by_phase,
         expected="croston_filter and ses_filter >= 1 in phases 8, 9, 10 "
                  "and 16 (each fits croston or theta on the card)")
    for phase in ("8_pooled", "9_complete", "10_arima", "16_streaming"):
        for k, n in by_phase[phase].items():
            if n < 1 and not (phase == "8_pooled" and k == "ses_filter"):
                DEFERRED.append(f"phase {phase} never launched {k}")
    ses_out = slice26_phase(port, card_line, {
        "pooled": pooled, "complete": complete, "streaming": streaming,
        "launches_by_phase": by_phase})
    # nothing the smoke ran wrote into native/
    unchanged = native_snapshot() == native_before
    git = None  # a checkout with git: its own account of native/ too
    if os.path.isdir(os.path.join(ROOT, ".git")) and shutil.which("git"):
        st = subprocess.run(["git", "status", "--porcelain", "native/"],
                            cwd=ROOT, capture_output=True, text=True)
        if st.returncode == 0:
            git = st.stdout
            unchanged &= git == ""
    emit("native_dir_unchanged", unchanged=unchanged, git_status=git)
    assert unchanged, "the run changed files under native/"
    if DEFERRED:
        raise AssertionError("; ".join(DEFERRED))

    at = arima_out["times"]
    rows = {k: dict(launches=(launches[k] + pooled["launches"][k]
                              + complete["launches"][k]
                              + ragged["launches"][k]
                              + prep["launches"][k]
                              + rng_paths["launches"][k]
                              + p8_end["launches"][k]
                              + streaming["launches"][k]
                              + runtime["launches"][k]
                              + scorer_rt["launches"][k]
                              + fleet["launches"][k]
                              + cache["launches"][k]
                              + parallel["launches"][k]
                              + mesh["launches"][k]
                              + sanitized["launches"][k]),
                    max_abs_err=max(c["max_abs_err"] for c in (
                        *cases[k].values(), *pooled["cases"][k].values(),
                        *ragged["cases"][k].values())),
                    ms=t[k]["ms"], device_ms=t[k]["device_ms"],
                    covered=t[k]["covered"], plain_ms=t[f"{k}_twin_ms"],
                    bound_ms=t[k]["bound_ms"], bound_by=t[k]["bound_by"])
            for k in ("hw_score", "hw_filter")}
    rows["hw_filter"]["cycles_per_step"] = (
        t["hw_filter_slope"]["additive_m7"]["cycles_per_step"])
    for k, timed in (("arima_filter", at["arima_filter"]["fit"]),
                     ("arima_predict", at["arima_predict"])):
        rows[k] = dict(launches=(arima_out["launches"][k]
                                 + scorer["auto"]["launches"][k]
                                 + scorer["detect"]["auto"]["launches"][k]
                                 + rng_paths["launches"][k]
                                 + p8_end["launches"][k]
                                 + windowed["launches"][k]
                                 + runtime["launches"][k]
                                 + scorer_rt["launches"][k]
                                 + fleet["launches"][k]
                                 + cache["launches"][k]
                                 + parallel["launches"][k]
                                 + mesh["launches"][k]
                                 + sanitized["launches"][k]),
                       max_abs_err=max(c["max_abs_err"] for c in (
                           *arima_out["cases"][k].values(),
                           *windowed["cases"][k].values())),
                       ms=timed["ms"], device_ms=timed["device_ms"],
                       covered=timed["covered"], plain_ms=at[f"{k}_twin_ms"],
                       bound_ms=timed["bound_ms"], bound_by=timed["bound_by"],
                       windowed_shape=windowed["times"][k]["shape"],
                       windowed_device_ms=windowed["times"][k]["device_ms"])
    ap = at["arima_predict"]
    rows["arima_predict"].update(
        launch_floor_device_ms=ap["empty_device_ms"],
        host_call_us=ap["host_call_us"])
    mt = p8_end["times"]["kernel"]["fit"]
    rows["arima_loglik_grad"] = dict(
        launches=(p8_end["launches"]["arima_loglik_grad"]
                  + parallel["launches"]["arima_loglik_grad"]
                  + mesh["launches"]["arima_loglik_grad"]
                  + sanitized["launches"]["arima_loglik_grad"]),
        max_abs_err=max(c["max_abs_err"] for c in p8_end["cases"].values()),
        ms=mt["ms"], device_ms=mt["device_ms"], covered=mt["covered"],
        plain_ms=p8_end["times"]["twin_ms"],
        bound_ms=mt["bound_ms"], bound_by=mt["bound_by"])
    # ms and bound_ms: the main path's launch (200 steps at the fit shape);
    # max_abs_err and plain_ms: the compared calls (compared_steps steps:
    # the twin takes ~2.8 s a step), with the kernel's time on that call
    fm, fc = p8_end["times"]["fit_kernel"]["fit"], p8_end["times"]["compared"]
    rows["arima_mle_fit"] = dict(
        launches=(p8_end["launches"]["arima_mle_fit"]
                  + parallel["launches"]["arima_mle_fit"]
                  + mesh["launches"]["arima_mle_fit"]
                  + sanitized["launches"]["arima_mle_fit"]),
        max_abs_err=max(c["max_abs_err"]
                        for c in p8_end["fit_cases"].values()),
        ms=fm["ms"], device_ms=fm["device_ms"], covered=fm["covered"],
        plain_ms=fc["plain_ms"],
        bound_ms=fm["bound_ms"],
        bound_by=fm["bound_by"], steps=fm["steps"],
        compared_steps=fc["steps"], compared_ms=fc["ms"])
    for k in SES_KERNELS:
        fit = ses_out["cases"][k]["fit_croston_sba" if k == "croston_filter"
                                  else "fit_theta"]
        rows[k] = dict(
            launches=ses_out["launches"][k],
            max_abs_err=max(c["max_abs_err"]
                            for c in ses_out["cases"][k].values()),
            ms=fit["ms"], device_ms=fit["device_ms"], covered=fit["covered"],
            plain_ms=fit["plain_ms"], bound_ms=fit["bound_ms"],
            bound_by=fit["bound_by"], shape=fit["shape"],
            cycles_per_step=ses_out["slopes"][k]["cycles_per_step"],
            launches_by_phase={p: n[k] for p, n in by_phase.items()})
    emit("smoke", seconds=time.perf_counter() - t_start)
    # no single PyTorch call runs a filter or its gradient: no library time
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": origin,
        **rows[k], "library_ms": None,
    } for k, (src, origin) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
