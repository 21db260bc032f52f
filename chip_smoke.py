"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once, on the card, at the reference workload's
full size — the committed ``datasets/store_item_demand.csv.gz`` (500 store x
item series, 1,826 days): load -> tensorize -> Holt-Winters fit + forecast
(candidates scored by the hand-written CUDA kernel) -> fail-safe ->
forecast frame -> rolling-origin CV (730/360/90) -> artifact save/load ->
batched predict.  Phases, each printing one JSON line; any failure raises,
so the exit code is not 0:

  1. device   the card's name, and its name and power limit from nvidia-smi
  2. build    every kernel built from csrc/ (seconds)
  3. kernels  each kernel against its plain twin on the card at the main
              path's shapes (default grid, damped grid, 10% more cells
              masked, a 30-day season, and the CV pass's 1,500 rows with the
              three cutoffs' train masks), rtol 1e-5 / atol 1e-6, argmins
              equal or near ties within that tolerance
  4. main     the main path with the launch counters set to 0 just before it
              and read just after: every kernel must have launched
  5. checks   what came out is right: finite, the expected shapes and key
              order, the kernel-scored fit bitwise the scan-scored fit where
              the argmins agree, and a 20-series run equal to the same run on
              the CPU within float32 tolerance
  6. times    CUDA-event medians of 5 runs after a warm-up: kernel, twin,
              winner refit, fit_forecast, the CV pass, one 500-series predict

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
# float32 operations of one Holt-Winters filter step (csrc/hw_score.cu), and
# of a masked (predict-only) step: phi * b, l + phi * b
HW_FLOP_PER_STEP, HW_MASKED_FLOP = 20, 2
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


def hw_bound_ms(mask, C: int, m: int) -> tuple:
    """Least time for the scoring kernel's work on this ``mask``: each input
    read once and the output written once at HBM rate, or its float32
    operations at the float32 peak, whichever is larger.  An observed step
    needs the whole update; a masked step only advances the level by the
    damped trend (two operations)."""
    S, T = mask.shape
    n_obs = int((mask > 0).sum())
    nbytes = 4 * (2 * S * T + 4 * C + 2 * S + S * m + S * C)
    t_bytes = nbytes / HBM_BPS * 1e3
    ops = C * (HW_FLOP_PER_STEP * n_obs + HW_MASKED_FLOP * (S * T - n_obs))
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


def kernel_cases(batch, port) -> dict:
    """Phase 3: the kernel against its twin on the card."""
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
    out = {}
    for name, (cfg, y, mask) in cases.items():
        grid = hw._candidate_grid(cfg, device=y.device)
        got = fs.hw_score(y, mask, *grid, cfg.season_length)
        torch.cuda.synchronize()
        want = fs.hw_score_reference(y, mask, *grid, cfg.season_length)
        res = compare_scores(got, want)
        res.update(S=int(y.shape[0]), T=int(y.shape[1]),
                   C=int(grid[0].numel()), m=cfg.season_length)
        emit("kernel_vs_twin", case=name, **res)
        if not res["pass"]:
            raise AssertionError(f"hw_score disagrees with its twin: {name}")
        out[name] = res
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
    # candidates agree (the winner refit is the same sequential filter)
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


def timings(run, port, card_line: str) -> dict:
    """Phase 6: device times at the main path's shapes.  The kernel alone
    (initial states computed beforehand) is timed over 20 back-to-back
    launches per sample, with y and mask warm in the 50 MB L2 as they are
    after ``_init_state`` reads them on the main path."""
    engine, hw, fs = port["engine"], port["hw"], port["fs"]
    batch = run["batch"]
    y, mask, p = batch.y, batch.mask, run["params"]
    cfg = hw.HoltWintersConfig(filter="auto")

    def kernel(y, mask, cfg):
        grid = hw._candidate_grid(cfg, device=y.device)
        init = [x.contiguous() for x in hw._init_state(
            y, mask, cfg.season_length, "additive")]
        ms = cuda_ms(lambda: fs._hw_score_cuda(y, mask, *grid, *init), inner=20)
        C = int(grid[0].numel())
        bound, by = hw_bound_ms(mask, C, cfg.season_length)
        shape = [int(y.shape[0]), int(y.shape[1]), C, cfg.season_length]
        return {"ms": ms, "bound_ms": bound, "bound_by": by, "shape": shape}

    k = {"fit": kernel(y, mask, cfg),
         "cv": kernel(*cv_inputs(batch, port["cv"]), cfg),
         "damped": kernel(y, mask, hw.HoltWintersConfig(damped=True))}
    grid = hw._candidate_grid(cfg, device=y.device)
    cv = engine.CVConfig(**CV)
    fc = port["serving"].BatchForecaster.from_fit(batch, p, "holt_winters", cfg)
    req = _request(batch.keys)
    t = {
        "twin_ms": cuda_ms(lambda: fs.hw_score_reference(y, mask, *grid, 7)),
        "winner_refit_ms": cuda_ms(lambda: hw._filter(
            y, mask, p.alpha, p.beta, p.gamma, 7, "additive", p.phi)),
        "fit_forecast_ms": cuda_ms(lambda: engine.fit_forecast(
            batch, "holt_winters", config=cfg, horizon=90)),
        "cv_pass_ms": cuda_ms(lambda: engine.cross_validate(
            batch, "holt_winters", config=cfg, cv=cv)),
        "predict_500_ms": cuda_ms(lambda: fc.predict(req)),
    }
    emit("times", card=card_line, reps=REPS, statistic="median",
         kernel=k, **t)
    return dict(t, kernel_ms=k["fit"]["ms"], bound_ms=k["fit"]["bound_ms"],
                bound_by=k["fit"]["bound_by"])


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
    _build.hw_score_library()
    emit("build", kernels=["hw_score"], seconds=time.perf_counter() - t0)

    batch = data.tensorize(data.load_sales_csv(DATA))
    cases = kernel_cases(batch, port)

    fs.hw_score.launches = 0  # counters to 0 just before the main path
    with tempfile.TemporaryDirectory() as tmp:
        run = main_path(port, tmp)
    launches = fs.hw_score.launches  # ... and read just after
    emit("launches", hw_score=launches, expected="1 per fit_forecast + 1 per CV pass")
    if launches < 1:
        raise AssertionError("the main path never launched hw_score")

    check_outputs(run, port)
    t = timings(run, port, card_line)

    print(json.dumps({"kernels": [{
        "name": "hw_score",
        "route": "cuda",
        "source": "distributed_forecasting_tpu_torch/csrc/hw_score.cu",
        "replaces": "distributed_forecasting_tpu/ops/fused_scan.py:199",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": t["kernel_ms"],
        "plain_ms": t["twin_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
