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
    deploy -> inference, without its monitor node (not ported);
  * its ``real-data-e2e`` (the committed dataset through the CSV ingest)
    and ``forecasting-blend`` (4 x 25 x 1,096 synthetic days, Holt-Winters
    at ``season_length: auto``, then promote): train with ``model: blend``
    over prophet, holt_winters and croston — each family's CV pass for the
    weights, the pooled CV pass for the conformal scale, one full-history
    fit each; the Holt-Winters member on both hand kernels — deploy,
    inference, without the monitor node.

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
  7. workflow forecasting-e2e minus monitor, in a temporary env.root, with
              the launch counters set to 0 before it (its curve model
              launches no hand kernel).  Checks: every task OK; the train
              run's batch, forecast and conformal scales on the card; the
              forecast and inference tables' keys, dates and rows, finite,
              lo <= yhat <= hi; 500 finite positive scales;
              val_coverage_calibrated logged beside val_coverage; version 1
              registered, tagged model_family prophet, in Staging; the
              registered artifact predicting the train run's artifact's
              frame, the inference table, and the train run's forecast
              within 1e-5.  Times: per task, the train run's phase_* and
              fit_seconds, the device's idle share over the train task's
              dispatch stage, and the conformal scale alone at the CV shape
              beside its bound (its sorts counted, no host sync).  A
              20-series cross_validate(calibrate=True) on the card equals
              the CPU's: ranks equal, scales within their scores' change
  8. blend    real-data-e2e minus monitor, then forecasting-blend twice in
              one env.root (the second promote decides by its rule against
              the first run's champion), each workflow five times in all
              for the per-task medians, with the launch counters set to 0
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

The line before the last lists the kernels (launches, error, times, bound);
the last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA device;
without one it exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
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


def idle_share(fn, top_n: int = 0) -> dict:
    """The device's busy time (union of kernel intervals in a torch.profiler
    trace) over the host wall time of one ``fn()`` ending in a synchronize,
    the traced durations of the port's own kernels in it, the device events
    counted and timed by kind (:data:`EVENT_KINDS`), and the ``top_n``
    device event names by time with their counts.  Reports
    ``not measured`` if the trace holds no device time (the profiler is
    optional on the card's machine; the rest of the run does not rest on
    it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
            "kernel_ms": own,
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
    "hand kernels": ("hw_score_kernel", "hw_filter_kernel"),
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


def curve_systems(y, mask, day, cfg, port):
    """The penalized normal equations ``fit`` solves for these rows, built
    by the same functions: (X, A, b)."""
    pg, solve = port["pg"], port["solve"]
    zn, _, _ = pg._fit_target(y, mask, cfg)
    X, layout = pg._design(day, day[0].to(torch.float32),
                           day[-1].to(torch.float32), cfg)
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


def e2e_spec(port, name: str = E2E) -> dict:
    """``conf/workflows.yml``'s workflow ``name`` as the runner reads it,
    without its monitor node (the port has no monitor task yet) and with
    its conf_file and input paths made absolute."""
    spec = port["config"].load_conf(WORKFLOWS)
    spec["workflows"] = [w for w in spec["workflows"] if w["name"] == name]
    wf = spec["workflows"][0]
    wf["tasks"] = [t for t in wf["tasks"] if t["task"] != "monitor"]
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
    """Phase 7's main path: the workflow, start to end, on ``device``."""
    t0 = time.perf_counter()
    with DeviceSpy(port["training"]) as spy:
        results = port["runner"].WorkflowRunner(
            spec, env={"root": root}, device=device).run(E2E)
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


def check_workflow(run, port, root: str, spec: dict, device="cuda") -> dict:
    """Phase 7's checks: every task OK, the train run on the card, both
    tables' keys, dates, rows and values, the 500 conformal scales, the
    calibrated coverage logged beside the raw, the registered version and
    its tags and stage, and the registered artifact predicting what the
    train run's artifact predicts."""
    results = run["results"]
    assert list(results) == TASKS, list(results)
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
    table = pd.read_parquet(train_run.artifact_path("series_metrics.parquet"))
    scales = table["interval_scale"].to_numpy()
    assert scales.shape == (S,) and np.isfinite(scales).all()
    assert (scales > 0).all()

    model_name = inf_conf["inference"]["model_name"]
    version = registry.latest_version(model_name)
    assert (version.version, version.stage) == (1, "Staging"), version
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
        val_coverage=metrics["val_coverage"],
        val_coverage_calibrated=metrics["val_coverage_calibrated"],
        interval_scale_mean=metrics["interval_scale_mean"],
        interval_scale_range=[float(scales.min()), float(scales.max())],
        registry={"version": version.version, "stage": version.stage,
                  "model_family": version.tags["model_family"]},
        devices=run["devices"])
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
POOLED_TASKS = {REAL: TASKS, BLEND: TASKS + ["promote"]}
# the croston recurrence's dependent chain per step: the size (and interval)
# update, a multiply, an add and a select, ~16 cycles; T such steps at the
# card's 1.98 GHz boost clock, whatever the width (as hw_filter.cu:37-43
# reckons its own chain)
CROSTON_CHAIN_CYCLES = 16
CLOCK_HZ = 1.98e9


class PoolSpy:
    """For each train task of a pooled workflow: sets the launch counters
    to 0 as the training pipeline starts and reads them as it returns, and
    records the devices of the batch and the blended forecast, and the
    member configs the blend was given.  With ``hw`` (the
    Holt-Winters module) it also records every hw_score and hw_filter call
    that module makes, inputs and output, for :func:`pooled_kernel_cases`."""

    def __init__(self, training, counters, hw=None):
        self.training, self.counters, self.hw = training, counters, hw
        self.launches, self.devices, self.configs = [], {}, {}
        self.calls = {"hw_score": [], "hw_filter": []}

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

        def recorder(name, fn):
            def call(*args):
                out = fn(*args)
                spy.calls[name].append((args, out))
                return out
            return call

        tr.TrainingPipeline.fine_grained = fine_spy
        tr.fit_forecast_blend = blend_spy
        if self.hw is not None:
            self._hw = (self.hw.hw_score, self.hw.hw_filter)
            self.hw.hw_score = recorder("hw_score", self._hw[0])
            self.hw.hw_filter = recorder("hw_filter", self._hw[1])
        return self

    def __exit__(self, *exc):
        tr = self.training
        tr.TrainingPipeline.fine_grained, tr.fit_forecast_blend = self._orig
        if self.hw is not None:
            self.hw.hw_score, self.hw.hw_filter = self._hw


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
# rounds; croston: the same selects and FMAs) drift apart by a few ulp a
# step; 1e-5 is ~80 ulp.  The curve member's comes from its conditioning.
POOL_RTOL = {"holt_winters": 1e-5, "croston": 1e-5}


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
    """A 20-series ``fit_forecast_blend(calibrate=True)`` on the card and on
    the CPU, with the train task's pool, member configs and CV.  Each
    family's scores within its own limit: :data:`POOL_RTOL` for the
    recurrences, and for the curve member 10 cond(A) 2^-24 of its CV
    systems (phase 3's bound on its paths).  The argmax-weight family equal
    wherever a series' best and second-best scores are more than twice the
    largest limit apart; weights within 2 d w + 1e-7 of each other, d the
    row's own largest relative score change (weights move by at most 2 d
    for a relative change d of the scores); the pooled conformal ranks
    equal and each scale within the largest change of the pooled scores it
    is an order statistic of (of every series' scores where the pooled one
    stands in), as phase 7 holds the curve model's; ok flags equal."""
    blend, cvm = port["blend"], port["cv"]
    tr = task_conf(spec, "train")["training"]
    families = tuple(tr["model_conf"]["families"])
    sub = batch.take_series(range(n))
    cpu = dataclasses.replace(sub, y=sub.y.cpu(), mask=sub.mask.cpu(),
                              day=sub.day.cpu())
    kw = dict(models=families, configs=configs, cv=cvm.CVConfig(**tr["cv"]),
              horizon=int(tr["horizon"]), calibrate=True)
    _, b_gpu, r_gpu = blend.fit_forecast_blend(sub, **kw)
    _, b_cpu, r_cpu = blend.fit_forecast_blend(cpu, **kw)

    limits = dict(POOL_RTOL)
    curve, _ = cvm._cv_entry(sub, "prophet", configs.get("prophet"), None,
                             "pool")
    _, A, _ = curve_systems(*cv_inputs(sub, cvm, tr["cv"]), sub.day, curve,
                            port)
    limits["prophet"], kappa = cond_tolerance(A)
    g = b_gpu.scores[list(families)].to_numpy()
    c = b_cpu.scores[list(families)].to_numpy()
    assert np.isfinite(g).all() and np.isfinite(c).all()
    rel = np.abs(g - c) / np.abs(c)
    for i, f in enumerate(families):
        assert rel[:, i].max() <= limits[f], (f, rel[:, i].max(), limits[f])
    srt = np.sort(c, axis=1)
    apart = (srt[:, 1] - srt[:, 0]) > 2 * max(limits.values()) * srt[:, 0]
    a_gpu = b_gpu.weights.argmax(axis=1)
    a_cpu = b_cpu.weights.argmax(axis=1)
    assert (a_gpu[apart] == a_cpu[apart]).all()
    d = rel.max(axis=1, keepdims=True)
    wdiff = np.abs(b_gpu.weights - b_cpu.weights)
    assert (wdiff <= 2 * d * b_cpu.weights + 1e-7).all(), wdiff.max()

    pg = pooled_ratios(port, sub, b_gpu, configs, tr["cv"])
    pc = pooled_ratios(port, cpu, b_cpu, configs, tr["cv"])
    assert torch.equal(pg["obs"], pc["obs"]) and torch.equal(pg["k"], pc["k"])
    diff = (pg["r"] - pc["r"]).abs()
    bound = torch.where(pc["n"] >= 30, diff.amax((0, 2)), diff.max()).numpy()
    s_gpu, s_cpu = b_gpu.interval_scale, b_cpu.interval_scale
    err = np.abs(s_gpu - s_cpu)
    assert (err <= bound + F32_EPS * 2 * np.abs(s_cpu)).all(), (err, bound)
    assert torch.equal(r_gpu.ok.cpu(), r_cpu.ok)
    res = dict(series=n, families=list(families),
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
    emit("blend_gpu_vs_cpu_20_series", **res)
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


def pooled_phase(port, counters, card_line: str) -> dict:
    """Phase 8: real-data-e2e minus monitor, then forecasting-blend twice
    in one env root (the second promote against the first's champion),
    each five times in all for the per-task medians; the first train task
    of each workflow's kernel calls against their twins; checks, times,
    and the 20-series card-vs-CPU blend."""
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


KERNELS = {
    "hw_score": ("distributed_forecasting_tpu_torch/csrc/hw_score.cu",
                 "distributed_forecasting_tpu/ops/fused_scan.py:199"),
    # no Pallas origin: the reference's lax.scan filter
    "hw_filter": ("distributed_forecasting_tpu_torch/csrc/hw_filter.cu",
                  "distributed_forecasting_tpu/models/holt_winters.py:170"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    # the port comes from this checkout: without it, fail before any output
    from distributed_forecasting_tpu_torch import data, engine, serving
    from distributed_forecasting_tpu_torch.engine import cv
    from distributed_forecasting_tpu_torch.models import holt_winters as hw
    from distributed_forecasting_tpu_torch.models import prophet_glm as pg
    from distributed_forecasting_tpu_torch.ops import _build, fused_scan as fs
    from distributed_forecasting_tpu_torch.ops import solve
    from distributed_forecasting_tpu_torch.pipelines import training
    from distributed_forecasting_tpu_torch import tracking
    from distributed_forecasting_tpu_torch.engine import blend, season
    from distributed_forecasting_tpu_torch.engine import calibrate as cal
    from distributed_forecasting_tpu_torch.models import croston
    from distributed_forecasting_tpu_torch.utils import config
    from distributed_forecasting_tpu_torch.workflows import runner

    card_line = card()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(card_line, flush=True)

    port = dict(data=data, engine=engine, cv=cv, serving=serving, hw=hw, fs=fs,
                pg=pg, solve=solve, training=training, tracking=tracking,
                cal=cal, config=config, runner=runner, blend=blend,
                croston=croston, season=season)
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
        for fn in counters.values():  # the workflow path: counters to 0
            fn.launches = 0
        wf_run = workflow_main_path(port, root, spec)
        emit("launches", path="workflow", **{k: fn.launches for k, fn in
                                             counters.items()},
             expected="0: the workflow's curve model runs no hand kernel")
        check_workflow(wf_run, port, root, spec)
        wt = workflow_timings(port, root, spec, card_line)
        conformal_vs_cpu(port, wt["state"]["batch"], wt["state"]["config"],
                         wt["cv_conf"])
    pooled = pooled_phase(port, counters, card_line)
    if DEFERRED:
        raise AssertionError("; ".join(DEFERRED))

    plain = {"hw_score": t["hw_score_twin_ms"],
             "hw_filter": t["hw_filter_twin_ms"]}
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": src,
        "replaces": origin,
        "launches": launches[k] + pooled["launches"][k],
        "max_abs_err": max(c["max_abs_err"] for c in (
            *cases[k].values(), *pooled["cases"][k].values())),
        "ms": t[k]["ms"],
        "plain_ms": plain[k],
        "bound_ms": t[k]["bound_ms"],
        "bound_by": t[k]["bound_by"],
        "library_ms": None,
    } for k, (src, origin) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
