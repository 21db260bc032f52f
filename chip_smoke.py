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
    96-candidate grid, then ``hw_filter``) with its replay.

Phases, each printing one JSON line; any failure raises, so the exit code
is not 0:

  1. device   the card's name, and its name and power limit from nvidia-smi
  2. build    every kernel built from csrc/ in one build call (seconds)
  3. kernels  each kernel against its plain twin on the card at the main
              path's shapes.  hw_score (default grid, damped grid, 10% more
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
              bounds, both twins, fit_forecast broken down into scoring,
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
  8. blend    real-data-e2e five times in one env.root (the monitor scans
              drift from the second run on; then the monitor task rerun on
              the CPU over the same stored table must write equal tables,
              and its four scans are timed), then forecasting-blend twice in
              one env.root (the second promote decides by its rule against
              the first run's champion) and three more times, each workflow
              five times in all for the per-task medians, with the launch
              counters set to 0
              as each train task starts: both kernels must launch in every
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
              and ``fit_seconds`` (medians of 5 runs), the train task's
              dispatch stage (CUDA events, median of 5; idle share; the
              host syncs PyTorch reports), the croston recurrence at the
              fit and CV shapes beside its bounds, and season detection
  9. complete allocated-baseline and hierarchical-m5, each five times in
              one env.root, the launch counters set to 0 before each run
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
              kernels.  Times: per task (medians of 5), the SES loop and the
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
              times: both kernels beside their bounds and their twins (once),
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
              dispatches.  Times: p50 / p95 / p99 of 200 sequential requests
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

The line before the last lists the kernels (launches, error, times, bound;
launches and error include phase 11's bucketed calls, phase 12's
arima_predict launches through HTTP, /invocations and /detect_anomalies,
phase 13's train task, phases 14-15's main paths and tasks, and phase 16's
fit and forced refit);
the last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA device;
without one it exits 1 and prints no result.
"""

from __future__ import annotations

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


def score_case(port, case: str, args, got) -> dict:
    """hw_score's output ``got`` on ``args`` (y, mask, alpha, beta, gamma,
    phi, m) against hw_score_reference on the same inputs; raises on a
    disagreement."""
    y, mask, a, b, g, p, m = args
    want = port["fs"].hw_score_reference(y, mask, a, b, g, p, m)
    res = compare_scores(got, want)
    res.update(S=int(y.shape[0]), T=int(y.shape[1]), C=int(a.numel()), m=m)
    emit("kernel_vs_twin", kernel="hw_score", case=case, **res)
    if not res["pass"]:
        raise AssertionError(f"hw_score disagrees with its twin: {case}")
    return res


def filter_case(port, case: str, args, got) -> dict:
    """hw_filter's output ``got`` on ``args`` (y, mask, alpha, beta, gamma,
    phi, m, mode) against _filter on the same inputs; raises on a
    disagreement."""
    y, mask, a, b, g, p, m, mode = args
    want = port["hw"]._filter(y, mask, a, b, g, m, mode, p)
    res = compare_filter(got, want)
    res.update(S=int(y.shape[0]), T=int(y.shape[1]), m=m, mode=mode)
    emit("kernel_vs_twin", kernel="hw_filter", case=case, **res)
    if not res["pass"]:
        raise AssertionError(f"hw_filter disagrees with its twin: {case}")
    return res


def kernel_cases(batch, port) -> dict:
    """Phase 3: each kernel against its twin on the card.  hw_filter refits
    the winners of the kernel's own scores, as ``fit`` does."""
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
    for name, (cfg, y, mask) in cases.items():
        args = (y, mask, *hw._candidate_grid(cfg, device=y.device),
                cfg.season_length)
        got = fs.hw_score(*args)
        torch.cuda.synchronize()
        out["hw_score"][name] = score_case(port, name, args, got)
        best = got.argmin(1)
        winners[name] = (y, mask, *(x[best] for x in args[2:6]),
                         cfg.season_length)

    refits = {
        "fit_default_winners": (*winners["default_C96"], "additive"),
        "fit_damped_winners": (*winners["damped_C288"], "additive"),
        "fit_multiplicative": (*winners["default_C96"], "multiplicative"),
        "season_m30": (*winners["season_m30"], "additive"),
        "cv_1500": (*winners["cv_1500"], "additive"),
    }
    for name, args in refits.items():
        got = fs.hw_filter(*args)
        torch.cuda.synchronize()
        out["hw_filter"][name] = filter_case(port, name, args, got)
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


def hand_launches() -> dict:
    """The launch counter of every hand kernel (:data:`KERNELS`)."""
    from distributed_forecasting_tpu_torch.ops import fused_scan, kalman

    return {k: getattr(fused_scan if k.startswith("hw_") else kalman,
                       k).launches for k in KERNELS}


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
        events = prof.events()
        # kernels and copies only: user annotations on the card's timeline
        # (torch.optim's "Optimizer.step#Adam.step") are not device work
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
        tail = [e for e in device if "spin_kernel" in e.name]
        device = [e for e in device if "spin_kernel" not in e.name]
        mark = [e for e in events if e.name == TAIL_MARK
                and e.device_type == DeviceType.CPU]
        spans = sorted((e.time_range.start, e.time_range.end) for e in device)
        own = {k: [(e.time_range.end - e.time_range.start) / 1e3
                   for e in device if f"{k}_kernel" in e.name]
               for k in KERNELS}
        names = {}
        for e in device:
            n, ms = names.get(e.name, (0, 0.0))
            names[e.name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    except Exception as exc:  # noqa: BLE001 — reported, not hidden
        return {"idle_share": "not measured", "reason": repr(exc)}
    missing = {k: n - len(own[k]) for k, n in launched.items()
               if len(own[k]) < n}
    lag_ms = ((tail[0].time_range.start - mark[0].time_range.start) / 1e3
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
                     "arima_loglik_grad_kernel", "arima_mle_fit_kernel"),
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
        return {"ms": ms, "bound_ms": bound, "bound_by": by,
                "shape": [int(y.shape[0]), int(y.shape[1]), C, m]}

    def refit(y, mask, cfg):
        _, init, won, m = inputs(y, mask, cfg)
        launch, _ = fs._hw_filter_launcher(y, mask, *won, *init, "additive")
        ms = cuda_ms(launch, inner=20)
        S, T = (int(d) for d in y.shape)
        bound, by = bound_ms(fs.hw_filter_work(S, T, m))
        return {"ms": ms, "bound_ms": bound, "bound_by": by, "shape": [S, T, m]}

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
            y, mask, *grid, 7)),
        "hw_filter_twin_ms": cuda_ms(lambda: hw._filter(
            y, mask, p.alpha, p.beta, p.gamma, 7, "additive", p.phi)),
        "fit_forecast_ms": cuda_ms(fit_forecast),
        "fit_forecast_stages_ms": {k: statistics.median(s[k] for s in stages)
                                   for k in stages[0]},
        "cv_pass_ms": cuda_ms(lambda: engine.cross_validate(
            batch, "holt_winters", config=cfg, cv=cv)),
        "predict_500_ms": cuda_ms(lambda: fc.predict(req)),
    }
    fit_forecast()
    t["fit_forecast_profile"] = idle_share(fit_forecast)
    emit("times", card=card_line, reps=REPS, statistic="median",
         hw_score=k_score, hw_filter=k_filter, **t)
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
# the croston recurrence's dependent chain per step: the size (and interval)
# update, a multiply, an add and a select, ~16 cycles; T such steps at the
# card's 1.98 GHz boost clock, whatever the width (as hw_filter.cu:37-43
# reckons its own chain)
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
    for kernel, case in (("hw_score", score_case),
                         ("hw_filter", filter_case)):
        calls = run["calls"][kernel]
        assert len(calls) == run["launches"][kernel], (kernel, len(calls))
        for i, (args, got) in enumerate(calls):
            name = f"{path}_call{i}_{args[0].shape[0]}x{args[0].shape[1]}"
            out[kernel][name] = case(port, name, args, got)
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


def pooled_timings(port, root: str, spec: dict, card_line: str) -> dict:
    """Phase 8's device times on the real dataset: the train task's dispatch
    stage (CUDA events, median of 5; the device's idle share; its host
    syncs), the croston recurrence at the fit and CV shapes beside its
    bounds, and season detection (the ACF alone on the card, and the whole
    detection with its host pull)."""
    cr, season, cvm = port["croston"], port["season"], port["cv"]
    prep, dispatch, _ = train_stages(port, root, spec)
    state = prep()
    batch = state["batch"]
    dispatch(dict(state))  # warm-up
    t = {"dispatch_ms": cuda_ms(lambda: dispatch(dict(state))),
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
        bound, by = bound_ms(cr.fit_work(S, T))
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
    task calls it (host clock, median of 5: pandas and numpy on the host,
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
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
        times[k] = statistics.median(samples)
    out = {"workflow": spec["workflows"][0]["name"], "table": table,
           "rows": len(df), "versions": len(catalog.table_versions(table)),
           "cpu_rerun_equal": True, "summary": summary,
           "scan_ms_host": times}
    emit("monitor", card=card_line, reps=REPS, statistic="median", **out)
    return out


def pooled_phase(port, counters, card_line: str) -> dict:
    """Phase 8: real-data-e2e (five runs in one env root, the monitor's
    drift scan from the second on, then its monitor rerun on the CPU),
    then forecasting-blend twice in one env root (the second promote
    against the first's champion) and three more times, for the per-task
    medians; the first train task of each workflow's kernel calls against
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
                while len(checked) < REPS:
                    checked.append(check_pooled(
                        pooled_run(port, root, spec, counters), port, root,
                        spec, len(checked) + 1))
                out["monitor"] = monitor_rerun(port, root, spec, card_line)
            del first
        while len(checked) < REPS:
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
# the SES step's dependent chain: (1 - alpha) * level, the add and the
# select, ~12 cycles; T such steps at the boost clock, whatever the width
# (as hw_filter.cu:37-43 reckons its own chain)
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
        bound, by = bound_ms(th.ses_work(S, T, A))
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
    each five times in one env root, the launch counters set to 0 before
    each run (neither launches a hand kernel: the curve model and theta);
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
            for _ in range(REPS):
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
             expected="0: the curve model and theta run no hand kernel")
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


def arima_filter_case(port, case: str, args) -> dict:
    """arima_filter on ``args`` against its twin on the same inputs, bit for
    bit (the kernel repeats the twin's float32 operations in order, built
    without contraction); raises on a disagreement."""
    kal = port["kalman"]
    got = kal.arima_filter(*args)
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
    ValueError for an r past the kernels' limit."""
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
    args = {}
    for name, (cfg, y, mask) in cases.items():
        args[name] = arima_args(port, y, mask, cfg)
        out["arima_filter"][name] = arima_filter_case(port, name, args[name])
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


def arima_vs_cpu(port, batch, n: int = 20) -> dict:
    """A 20-series arima fit_forecast on the card and on the CPU: every row
    of every output within ARIMA_REL of that row's own scale (its largest
    magnitude, at least 1: the unit of the dimensionless coefficients, where
    a phi near 0 carries the solves' absolute rounding), ok flags equal."""
    engine = port["engine"]
    sub = batch.take_series(range(n))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    p_gpu, r_gpu = engine.fit_forecast(sub, "arima", horizon=90)
    p_cpu, r_cpu = engine.fit_forecast(cpu, "arima", horizon=90)
    assert torch.equal(r_gpu.ok.cpu(), r_cpu.ok)
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
    res = dict(series=n, max_rel_to_scale=worst, limit=ARIMA_REL)
    emit("arima_gpu_vs_cpu_20_series", **res)
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
                   "ms": cuda_ms(launch, inner=20),
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
    launch, _ = kal._arima_predict_launcher(*pargs)
    predict = {"shape": [batch.n_series, 91, 2],
               "ms": cuda_ms(launch, inner=20),
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
LATENCY_REQUESTS = 200  # sequential requests per request size
LOAD_CLIENTS = 32  # concurrent 1-series clients
LOAD_SECONDS = 5.0
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


def scorer_load(number: int, keys, key_names, keep_bodies: bool) -> dict:
    """LOAD_CLIENTS threads of 1-series requests for LOAD_SECONDS, each with
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
            stop = time.perf_counter() + LOAD_SECONDS
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
        t.join(LOAD_SECONDS + 300)
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


def rowwise_cost(port, fc) -> dict:
    """What bit-identical blocks across request buckets cost on the card:
    the curve model's row-wise design product against the one GEMM it
    replaces, and the in-order row scan against ``torch.cumsum``, at the
    serving and training row counts (CUDA events, median of 5 samples of
    20 back-to-back calls)."""
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
                                         inner=20),
            "gemm_ms": cuda_ms(lambda: beta @ X.T, inner=20),
            "cumsum_rows_ms": cuda_ms(lambda: cumsum_rows(v), inner=20),
            "torch_cumsum_ms": cuda_ms(lambda: torch.cumsum(v, 1), inner=20)}
    return out


# -- phase 12, slice 11: the store, the SLO evaluator, /detect_anomalies ----

DETECT_DAYS, DETECT_SERIES = 28, 17
DETECT_FULL_DAYS = 20  # x 500 series: 10,000 points, the shipped maximum
DETECT_REQUESTS = {17: 50, 500: 10}  # sequential requests per size
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
                       and r["ts"] >= now - w]
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
ARNET_REPS = 3           # timed fits of each arnet trainer
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


def mle_kernel_case(port, case: str, args, jacobian: bool = False) -> dict:
    """arima_loglik_grad on ``args`` against its twin on the same inputs,
    bit for bit, and its ssq, ldet and n against arima_filter's, bit for
    bit; with ``jacobian`` its Jacobians against float64 autograd too.
    Raises on a disagreement."""
    kal = port["kalman"]
    zc, zmask, phi, theta, r = args
    got = kal.arima_loglik_grad(*args)
    want = kal.arima_loglik_grad_reference(*args)
    filt = kal.arima_filter(zc, zmask, None, None, phi, theta,
                            torch.zeros(zc.shape[0], device=zc.device), r, 0)
    torch.cuda.synchronize()
    res = compare_bitwise({k: (g, w) for k, g, w in zip(
        kal.LoglikGrad._fields, got, want)})
    primal = compare_bitwise({k: (getattr(got, k), getattr(filt, k))
                              for k in ("ssq", "ldet", "n")})
    res.update(S=int(zc.shape[0]), T=int(zc.shape[1]), p=int(phi.shape[1]),
               q=int(theta.shape[1]), r=r,
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
    shape and at r = 9; the ValueError at r = 70."""
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
    out = {}
    for name, (y, m, p, q, d) in cases.items():
        out[name] = mle_kernel_case(port, name, mle_args(port, y, m, p, q, d),
                                    jacobian=name in ("fit_211", "warp_r9"))
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


def mle_times(port, batch, fit_cases, card_line: str) -> dict:
    """(e) The gradient kernel alone at the fit and CV shapes (CUDA events,
    median of 5, each sample 5 back-to-back launches bound beforehand)
    beside its bound and serial chain, its twin once; the fit kernel per
    fit at the fit and CV shapes (median of 5) as the main path launches it
    (all its steps), and its per-step time over the first and the last
    MLE_STEP_WINDOW steps of a fit (fits of 20, steps - 20 and steps
    steps); the compared call of the fit kernel (``fit_cases``' fit shape)
    timed again, beside its twin's time; the MLE fit_forecast's wall time
    (median of 3, host clock to a synchronize), its device events, idle
    share and host syncs."""
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
        k[name] = {"shape": [S, T, 2, 3], "ms": ms, "bound_ms": bound,
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
    twin = once_ms(lambda: kal.arima_loglik_grad_reference(*fit_args))
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
    out["times"] = mle_times(port, batch, out["fit_cases"], card_line)
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
STREAM_LATENCY = 100      # sequential 500-series /invocations, each leg
STREAM_APPLY_REPS = 5
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


def stream_artifacts(port, root: str, batch) -> dict:
    """Fit each streamed family on the committed dataset (Holt-Winters on
    its 96-candidate grid: hw_score, then hw_filter), save the artifact
    with its ``history.npz`` sidecar (the training y / mask, as whoever
    registers a streamed model writes it) and register it in Staging."""
    registry = port["tracking"].ModelRegistry(os.path.join(root, "registry"))
    out = {}
    for model in STREAM_FAMILIES:
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
}


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
                update=update, ingest=ingest, serve_task=serve_task)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
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
    _build.library()
    emit("build", kernels=list(KERNELS), sources=_build.SOURCES,
         seconds=time.perf_counter() - t0)

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
    pooled = pooled_phase(port, counters, card_line)
    complete = complete_phase(port, counters, card_line)
    arima_out = arima_phase(port, card_line)
    ragged = slice9_phase(port, counters, card_line)["bucketed"]
    scorer = scorer_phase(port, card_line)
    prep = prep_phase(port, counters, card_line)
    rng_paths = slice13_phase(port, card_line)
    p8_end = slice14_phase(port, card_line)
    streaming = slice15_phase(port, card_line)
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
                              + streaming["launches"][k]),
                    max_abs_err=max(c["max_abs_err"] for c in (
                        *cases[k].values(), *pooled["cases"][k].values(),
                        *ragged["cases"][k].values())),
                    ms=t[k]["ms"], plain_ms=t[f"{k}_twin_ms"],
                    bound_ms=t[k]["bound_ms"], bound_by=t[k]["bound_by"])
            for k in ("hw_score", "hw_filter")}
    for k, timed in (("arima_filter", at["arima_filter"]["fit"]),
                     ("arima_predict", at["arima_predict"])):
        rows[k] = dict(launches=(arima_out["launches"][k]
                                 + scorer["auto"]["launches"][k]
                                 + scorer["detect"]["auto"]["launches"][k]
                                 + rng_paths["launches"][k]
                                 + p8_end["launches"][k]),
                       max_abs_err=max(c["max_abs_err"] for c in
                                       arima_out["cases"][k].values()),
                       ms=timed["ms"], plain_ms=at[f"{k}_twin_ms"],
                       bound_ms=timed["bound_ms"], bound_by=timed["bound_by"])
    mt = p8_end["times"]["kernel"]["fit"]
    rows["arima_loglik_grad"] = dict(
        launches=p8_end["launches"]["arima_loglik_grad"],
        max_abs_err=max(c["max_abs_err"] for c in p8_end["cases"].values()),
        ms=mt["ms"], plain_ms=p8_end["times"]["twin_ms"],
        bound_ms=mt["bound_ms"], bound_by=mt["bound_by"])
    # ms and bound_ms: the main path's launch (200 steps at the fit shape);
    # max_abs_err and plain_ms: the compared calls (compared_steps steps:
    # the twin takes ~2.8 s a step), with the kernel's time on that call
    fm, fc = p8_end["times"]["fit_kernel"]["fit"], p8_end["times"]["compared"]
    rows["arima_mle_fit"] = dict(
        launches=p8_end["launches"]["arima_mle_fit"],
        max_abs_err=max(c["max_abs_err"]
                        for c in p8_end["fit_cases"].values()),
        ms=fm["ms"], plain_ms=fc["plain_ms"], bound_ms=fm["bound_ms"],
        bound_by=fm["bound_by"], steps=fm["steps"],
        compared_steps=fc["steps"], compared_ms=fc["ms"])
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
