"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once, on the card, at the reference workload's
full size — the committed ``datasets/store_item_demand.csv.gz`` (500 store x
item series, 1,826 days): load -> tensorize -> Holt-Winters fit + forecast
(candidates scored by the ``hw_score`` CUDA kernel, the winner refit by the
``hw_filter`` CUDA kernel) -> fail-safe -> forecast frame -> rolling-origin CV
(730/360/90) -> artifact save/load -> batched predict.  Phases, each printing
one JSON line; any failure raises, so the exit code is not 0:

  1. device   the card's name, and its name and power limit from nvidia-smi
  2. build    every kernel built from csrc/ in one build call (seconds)
  3. kernels  each kernel against its plain twin on the card at the main
              path's shapes.  hw_score (default grid, damped grid, 10% more
              cells masked, a 30-day season, and the CV pass's 1,500 rows
              with the three cutoffs' train masks): rtol 1e-5 / atol 1e-6,
              argmins equal or near ties within that tolerance.  hw_filter
              (the winners of the default and the damped grid, the
              multiplicative mode, a 30-day season, the CV pass's 1,500
              rows): bitwise equal to _filter in path, states and MSE
  4. main     the main path with the launch counters set to 0 just before it
              and read just after: every kernel must have launched
  5. checks   what came out is right: finite, the expected shapes and key
              order, the kernel-scored fit bitwise the scan-scored fit where
              the argmins agree, and a 20-series run equal to the same run on
              the CPU within float32 tolerance
  6. times    CUDA-event medians of 5 runs after a warm-up: both kernels at
              the fit, CV and damped shapes beside their bounds, both twins,
              fit_forecast broken down into scoring, refit, forecast and
              fail-safe (a staged copy of it whose outputs must equal
              fit_forecast's), the CV pass, one 500-series predict, and the
              device's idle share over one fit_forecast (torch.profiler)

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


def cv_inputs(batch, cv):
    """The CV pass's kernel inputs: the series repeated once per cutoff and
    each cutoff's train mask, ``(C*S, T)`` rows, as ``cross_validate`` gives
    them to the kernel (each row ends in a masked run of predict-only steps)."""
    T = batch.n_time
    cuts = cv.cutoff_indices(T, cv.CVConfig(**CV))
    train_masks = cv.cv_windows(batch.mask, batch.day, cuts, CV["horizon"])[0]
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
        grid = hw._candidate_grid(cfg, device=y.device)
        got = fs.hw_score(y, mask, *grid, cfg.season_length)
        torch.cuda.synchronize()
        want = fs.hw_score_reference(y, mask, *grid, cfg.season_length)
        res = compare_scores(got, want)
        res.update(S=int(y.shape[0]), T=int(y.shape[1]),
                   C=int(grid[0].numel()), m=cfg.season_length)
        emit("kernel_vs_twin", kernel="hw_score", case=name, **res)
        if not res["pass"]:
            raise AssertionError(f"hw_score disagrees with its twin: {name}")
        out["hw_score"][name] = res
        best = got.argmin(1)
        winners[name] = (y, mask, tuple(x[best] for x in grid),
                         cfg.season_length)

    refits = {
        "fit_default_winners": (*winners["default_C96"], "additive"),
        "fit_damped_winners": (*winners["damped_C288"], "additive"),
        "fit_multiplicative": (*winners["default_C96"], "multiplicative"),
        "season_m30": (*winners["season_m30"], "additive"),
        "cv_1500": (*winners["cv_1500"], "additive"),
    }
    for name, (y, mask, (a, b, g, p), m, mode) in refits.items():
        got = fs.hw_filter(y, mask, a, b, g, p, m, mode)
        torch.cuda.synchronize()
        want = hw._filter(y, mask, a, b, g, m, mode, p)
        res = compare_filter(got, want)
        res.update(S=int(y.shape[0]), T=int(y.shape[1]), m=m, mode=mode)
        emit("kernel_vs_twin", kernel="hw_filter", case=name, **res)
        if not res["pass"]:
            raise AssertionError(f"hw_filter disagrees with its twin: {name}")
        out["hw_filter"][name] = res
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
    """Phase 5: what came out of the main path is right."""
    engine, hw = port["engine"], port["hw"]
    batch, frame, res = run["batch"], run["frame"], run["result"]
    S, T = batch.n_series, batch.n_time
    assert (S, T) == SHAPE, (S, T)
    assert len(frame) == S * (T + 90), len(frame)
    vals = frame[["yhat", "yhat_upper", "yhat_lower"]].to_numpy()
    assert np.isfinite(vals).all()
    assert (frame["yhat_lower"] <= frame["yhat_upper"]).all()
    n_ok = int(res.ok.sum())
    means = {k: float(torch.nanmean(v)) for k, v in run["metrics"].items()
             if not k.startswith("_")}
    assert all(np.isfinite(v) for v in means.values()), means
    assert run["metrics"]["_n_cutoffs"] == 3
    for k, keys in run["requests"].items():
        out = run["answers"][k]
        assert len(out) == 90 * len(keys)
        assert np.isfinite(out[["yhat", "yhat_upper", "yhat_lower"]]
                           .to_numpy()).all()
        got = out[["store", "item"]].to_numpy()[::90]
        np.testing.assert_array_equal(got, keys)
    q = run["quantiles"]
    assert len(q) == 90 * len(run["requests"][17])
    assert np.isfinite(q[["q0.1", "q0.5", "q0.9"]].to_numpy()).all()
    assert ((q["q0.1"] <= q["q0.5"]) & (q["q0.5"] <= q["q0.9"])).all()
    emit("main_path", series=S, days=T, frame_rows=len(frame), ok=n_ok,
         cv_cutoffs=3, cv_means=means, seconds=run["seconds"])

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


def idle_share(fn) -> dict:
    """The device's busy time (union of kernel intervals in a torch.profiler
    trace) over the host wall time of one ``fn()`` ending in a synchronize,
    and the traced durations of the port's own kernels in it.  Reports
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
    return {"idle_share": 1.0 - busy_ms / wall, "device_busy_ms": busy_ms,
            "wall_ms_profiled": wall, "device_events": len(spans),
            "kernel_ms": own}


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
    from distributed_forecasting_tpu_torch.ops import _build, fused_scan as fs

    card_line = card()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(card_line, flush=True)

    port = dict(data=data, engine=engine, cv=cv, serving=serving, hw=hw, fs=fs)
    t0 = time.perf_counter()
    _build.library()
    emit("build", kernels=list(KERNELS), sources=_build.SOURCES,
         seconds=time.perf_counter() - t0)

    batch = data.tensorize(data.load_sales_csv(DATA))
    cases = kernel_cases(batch, port)

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

    plain = {"hw_score": t["hw_score_twin_ms"],
             "hw_filter": t["hw_filter_twin_ms"]}
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": src,
        "replaces": origin,
        "launches": launches[k],
        "max_abs_err": max(c["max_abs_err"] for c in cases[k].values()),
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
