"""Port parity: ``parallel/*`` (the series mesh over ``torch.distributed``)
against the JAX reference's mesh, with three real ranks.

A module fixture spawns one gloo group of three CPU ranks, each running this
file's ``__main__`` (no JAX there): every rank brings itself up through
``initialize_distributed`` (what a ``distributed:`` conf block calls), runs
every scenario on the same seeded data and writes its outputs to an
``.npz``.  Three ranks pad S = 10 series to 12, so the last rank holds two
padding rows, as in the reference's ``test_uneven_shard_fit_and_metrics``.
The parent computes each JAX reference once while the ranks run.

The rule held (``parallel/__init__``): concatenated in rank order, the
ranks' outputs are the reference's global array; a replicated result is the
same on every rank.  Tolerances:
  * the shard layout, owners and host-local frames: exact;
  * fits and CV metric means against the reference's unsharded fit and CV
    (the reference's own tests hold its sharded results to its unsharded
    ones), each family under its port-parity tolerance: Holt-Winters
    forecasts 1e-5 of the data's scale (``test_torch_engine.py``), arima
    1e-3 (``test_torch_arima.py``), the curve model 2e-4
    (``test_torch_prophet.py``, ``test_torch_regressors.py``); CV means rtol
    1e-4 (Holt-Winters), 1e-3 (arima, the curve model), the curve model's
    coverage within one point a cutoff (``test_torch_engine.py``, whose CV
    also drops the yearly terms: at a 300-day cutoff they are nearly
    collinear with the trend);
  * the port's all-reduced means against the reference's ``psum`` means of
    the same per-series values: rtol 1e-6 (float32 sums in another order);
  * the windowed fit over the mesh against the port's unsharded fit: 2e-4,
    the reference's own (``tests/unit/test_windowed.py:303-320``); the
    unsharded fit against the reference's as ``test_torch_windowed.py``
    holds it.
"""

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)

WORLD = 3
SALES = dict(n_stores=2, n_items=5, n_days=500, seed=3)   # S 10 -> 12
HORIZON = 30
CV = dict(initial=300, period=90, horizon=60)             # 2 cutoffs
N_REG = 2
WIN = dict(S=3, T=4096, seed=5, horizon=14)
RANK_TIMEOUT_S = 300

# family -> (model, xreg kind, forecast rel tol of scale, CV means rtol)
FAMILIES = {
    "holt_winters": ("holt_winters", None, 1e-5, 1e-4),
    "arima": ("arima", None, 1e-3, 1e-3),
    "curve": ("prophet", None, 2e-4, 1e-3),
    "curve_shared_xreg": ("prophet", "shared", 2e-4, 1e-3),
    "curve_per_series_xreg": ("prophet", "per_series", 2e-4, 1e-3),
}
METRICS = ("coverage", "mae", "mape", "mase", "mdape", "mse", "rmse",
           "smape")


def _sales():
    from distributed_forecasting_tpu_torch import data as tdata

    return tdata.synthetic_store_item_sales(**SALES)


def _xreg(kind, S, T):
    """(T, R) shared or (S, T, R) per-series regressors from a seed."""
    if kind is None:
        return None
    t = np.arange(T)
    shared = np.stack([np.sin(t / 9.0), (t % 13 < 2).astype(float)], axis=1)
    if kind == "shared":
        return shared.astype(np.float32)
    scale = np.random.default_rng(3).uniform(0.5, 2.0, (S, 1, N_REG))
    return (shared[None] * scale).astype(np.float32)


def _ar2(S, T, seed, level=10.0):
    """(S, T) float32 AR(2) + level, the reference's ``_ar2_batch``."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, 1.0, (S, T))
    y = np.zeros((S, T))
    for t in range(2, T):
        y[:, t] = 0.55 * y[:, t - 1] + 0.20 * y[:, t - 2] + eps[:, t]
    return (y + level).astype(np.float32)


def _win_batch(y):
    from distributed_forecasting_tpu_torch.data import SeriesBatch

    S, T = y.shape
    return SeriesBatch(y=torch.from_numpy(y), mask=torch.ones(S, T),
                       day=torch.arange(T, dtype=torch.int32),
                       keys=np.arange(S)[:, None], key_names=("series",),
                       start_date="1970-01-01")


def _win_config():
    from distributed_forecasting_tpu_torch.engine.windowed import (
        WindowedConfig,
    )

    return WindowedConfig(enabled=True, window_len=512, overlap=64,
                          min_windows=2)


# -- the ranks -------------------------------------------------------------------

def _rank_outputs(rank: int, world: int, port: int) -> dict:
    """Every scenario on this rank; its outputs by name."""
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch import data as tdata
    from distributed_forecasting_tpu_torch.engine import CVConfig
    from distributed_forecasting_tpu_torch.engine.windowed import (
        windowed_fit_forecast,
    )
    from distributed_forecasting_tpu_torch.models.prophet_glm import (
        CurveModelConfig,
    )
    from distributed_forecasting_tpu_torch.parallel import (
        global_metric_means,
        initialize_distributed,
        make_mesh,
        shard_batch,
        sharded_cv_metrics,
        sharded_fit_forecast,
    )
    from distributed_forecasting_tpu_torch.parallel import mesh as tmesh
    from distributed_forecasting_tpu_torch.parallel.distributed import (
        host_local_frame,
        series_owner,
    )
    from distributed_forecasting_tpu_torch.reconcile.hierarchy import (
        gather_bottom_sharded,
    )

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = make_mesh(world)
    out = {"backend": np.array(dist.get_backend()),
           "rank": np.array(tmesh.mesh_rank(mesh)),
           "world": np.array(tmesh.mesh_size(mesh))}
    df = _sales()
    batch = tdata.tensorize(df, device="cpu")
    S, T = batch.n_series, batch.n_time

    local = shard_batch(batch, mesh)
    out.update(shard_y=local.y.numpy(), shard_mask=local.mask.numpy(),
               shard_keys=local.keys, shard_day=local.day.numpy())
    mine = host_local_frame(df)  # the group's rank and size
    out.update(local_store=mine["store"].to_numpy(),
               local_item=mine["item"].to_numpy(),
               local_sales=mine["sales"].to_numpy(),
               owner=series_owner(batch.keys, world))

    cv = CVConfig(**CV)
    for name, (model, kind, _, _) in FAMILIES.items():
        cfg = CurveModelConfig(n_regressors=N_REG) if kind else None
        xr = _xreg(kind, S, T + HORIZON)
        _, res = sharded_fit_forecast(
            batch, model, config=cfg, horizon=HORIZON, mesh=mesh,
            xreg=None if xr is None else torch.from_numpy(xr))
        for k in ("yhat", "lo", "hi", "ok"):
            out[f"fit_{name}_{k}"] = getattr(res, k).numpy()
        if model == "prophet":
            cfg = CurveModelConfig(n_regressors=N_REG if kind else 0,
                                   yearly_order=0)
        cvm = sharded_cv_metrics(
            batch, model, config=cfg, cv=cv, mesh=mesh,
            xreg=None if xr is None else torch.from_numpy(xr))
        out[f"cv_{name}_n_cutoffs"] = np.array(cvm["_n_cutoffs"])
        out[f"cv_{name}_keys"] = np.array(sorted(
            k for k in cvm if not k.startswith("_")))
        for k in METRICS:
            out[f"cv_{name}_{k}"] = cvm[k].numpy()
        if name == "holt_winters":
            ok = torch.ones(cvm["mape"].shape[0], dtype=torch.bool)
            for k, v in global_metric_means(cvm, ok, mesh).items():
                out[f"means_{k}"] = v.numpy()
            # padding rows (ok False) must not move a mean
            err = {"err": torch.where(res.ok[:, None], 1.0, 100.0).mean(1)}
            out["means_padding"] = global_metric_means(
                err, res.ok, mesh)["err"].numpy()
    # a per-series xreg with the wrong rows fails before any collective
    try:
        sharded_fit_forecast(
            batch, "prophet", config=CurveModelConfig(n_regressors=N_REG),
            horizon=HORIZON, mesh=mesh,
            xreg=torch.from_numpy(_xreg("per_series", S, T + HORIZON)[:3]))
        out["xreg_rows_error"] = np.array("")
    except ValueError as e:
        out["xreg_rows_error"] = np.array(str(e))

    out["gather"] = gather_bottom_sharded(local.y[:, :16], mesh,
                                          "series").numpy()

    wy = _ar2(WIN["S"], WIN["T"], WIN["seed"])
    params, res = windowed_fit_forecast(
        _win_batch(wy), horizon=WIN["horizon"], mesh=mesh,
        wconfig=_win_config())
    for f in dataclasses.fields(params):
        out[f"win_p_{f.name}"] = getattr(params, f.name).numpy()
    for k in ("yhat", "lo", "hi", "ok", "day_all"):
        out[f"win_{k}"] = getattr(res, k).numpy()
    dist.destroy_process_group()
    return out


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of the parity group")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = _rank_outputs(args.rank, args.world, args.port)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` processes of ``script`` joined in one gloo group on the
    CPU, started at once.  Their standard output and error go to files, not
    pipes: the ranks run concurrently and rendezvous, and an undrained pipe
    would stall a chatty rank inside a collective."""

    def __init__(self, script: str, world: int, workdir: str):
        self.workdir, self.world = workdir, world
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
        env["OMP_NUM_THREADS"] = "1"
        port = free_port()
        self.files, self.procs = [], []
        for r in range(world):
            fo = open(os.path.join(workdir, f"rank{r}.out"), "w")
            fe = open(os.path.join(workdir, f"rank{r}.err"), "w")
            self.files += [fo, fe]
            self.procs.append(subprocess.Popen(
                [sys.executable, script, "--rank", str(r), "--world",
                 str(world), "--port", str(port), "--out", workdir],
                cwd=ROOT, env=env, stdout=fo, stderr=fe))

    def wait(self, timeout: float = RANK_TIMEOUT_S) -> list:
        """Every rank's outputs in rank order; fails (and kills the rest)
        when a rank exits nonzero or outlives ``timeout``."""
        try:
            for r, p in enumerate(self.procs):
                try:
                    p.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    raise AssertionError(
                        f"rank {r} ran past {timeout} s: {self._err(r)}")
                assert p.returncode == 0, (
                    f"rank {r} exited {p.returncode}: {self._err(r)}")
        finally:
            self.close()
        return [dict(np.load(os.path.join(self.workdir, f"rank{r}.npz")))
                for r in range(self.world)]

    def close(self) -> None:
        """Kill any rank still running and close the output files."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.files:
            f.close()

    def _err(self, r: int) -> str:
        with open(os.path.join(self.workdir, f"rank{r}.err")) as f:
            return f.read()[-3000:]


# -- the parent ------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    """The three ranks, started first so the reference below runs meanwhile;
    their outputs in rank order."""
    with tempfile.TemporaryDirectory(prefix="dftt-ranks-") as tmp:
        group = Ranks(os.path.abspath(__file__), WORLD, tmp)
        try:
            yield group
        finally:
            group.close()


@pytest.fixture(scope="module")
def reference():
    """The reference's results on the same data, each computed once: the
    unsharded fits and CV passes, its shard layout, host frames, gather and
    windowed fit on a 3-device mesh."""
    import jax.numpy as jnp

    import distributed_forecasting_tpu.data as jdata
    from distributed_forecasting_tpu.engine import CVConfig as JCV
    from distributed_forecasting_tpu.engine import cross_validate
    from distributed_forecasting_tpu.engine.fit import fit_forecast
    from distributed_forecasting_tpu.models.holt_winters import (
        HoltWintersConfig,
    )
    from distributed_forecasting_tpu.models.prophet_glm import (
        CurveModelConfig as JCurve,
    )
    from distributed_forecasting_tpu.parallel import make_mesh, shard_batch
    from distributed_forecasting_tpu.parallel.distributed import (
        host_local_frame,
        series_owner,
    )
    from distributed_forecasting_tpu.reconcile.hierarchy import (
        gather_bottom_sharded,
    )

    df = _sales()
    jb = jdata.tensorize(df)
    S, T = jb.n_series, jb.n_time
    mesh = make_mesh(WORLD)
    sb = shard_batch(jb, mesh)
    ref = {"batch": jb, "mesh": mesh, "df": df,
           "shard_y": np.asarray(sb.y), "shard_mask": np.asarray(sb.mask),
           "shard_keys": np.asarray(sb.keys), "day": np.asarray(sb.day),
           "owner": series_owner(np.asarray(jb.keys), WORLD),
           "frames": [host_local_frame(df, r, WORLD) for r in range(WORLD)],
           "gather": np.asarray(gather_bottom_sharded(sb.y[:, :16], mesh,
                                                      "series"))}
    cv = JCV(**CV)
    for name, (model, kind, _, _) in FAMILIES.items():
        # the reference scans Holt-Winters: its Pallas route is bitwise the
        # same fit, and its interpreter is slow
        cfg = (HoltWintersConfig(filter="scan") if model == "holt_winters"
               else JCurve(n_regressors=N_REG) if kind else None)
        xr = _xreg(kind, S, T + HORIZON)
        xr = None if xr is None else jnp.asarray(xr)
        _, res = fit_forecast(jb, model=model, config=cfg, horizon=HORIZON,
                              xreg=xr, autoprep=False)
        ref[f"fit_{name}"] = {k: np.asarray(getattr(res, k))
                              for k in ("yhat", "lo", "hi", "ok")}
        if model == "prophet":
            cfg = JCurve(n_regressors=N_REG if kind else 0, yearly_order=0)
        ref[f"cv_{name}"] = {k: (v if k.startswith("_") else np.asarray(v))
                             for k, v in cross_validate(
                                 jb, model=model, config=cfg, cv=cv,
                                 xreg=xr).items()}
    return ref


@pytest.fixture(scope="module")
def outs(ranks, reference):
    return ranks.wait()


def _cat(outs, key):
    return np.concatenate([o[key] for o in outs])


def _close_to_scale(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def test_each_rank_joined_the_group_over_gloo(outs):
    assert [int(o["rank"]) for o in outs] == list(range(WORLD))
    assert all(int(o["world"]) == WORLD for o in outs)
    assert all(str(o["backend"]) == "gloo" for o in outs)


def test_shard_batch_layout_matches_reference(outs, reference):
    """S 10 padded to 12: the ranks' blocks, in order, are the reference's
    sharded rows bit for bit; padding rows are mask 0 with keys -1; the day
    grid is replicated."""
    np.testing.assert_array_equal(_cat(outs, "shard_y"), reference["shard_y"])
    np.testing.assert_array_equal(_cat(outs, "shard_mask"),
                                  reference["shard_mask"])
    np.testing.assert_array_equal(_cat(outs, "shard_keys"),
                                  reference["shard_keys"])
    assert [o["shard_y"].shape[0] for o in outs] == [4, 4, 4]
    assert outs[-1]["shard_mask"][2:].sum() == 0
    for o in outs:
        np.testing.assert_array_equal(o["shard_day"], reference["day"])


def test_series_owner_and_host_local_frame_match_reference(outs, reference):
    """The same uint64 hash: owners bitwise; each rank's frame (read from
    the group's rank and size) is the reference's frame for that process,
    and the frames cover every row once."""
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["owner"], reference["owner"])
        want = reference["frames"][r]
        np.testing.assert_array_equal(o["local_store"], want["store"])
        np.testing.assert_array_equal(o["local_item"], want["item"])
        np.testing.assert_array_equal(o["local_sales"], want["sales"])
    assert sum(len(o["local_sales"]) for o in outs) == len(reference["df"])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_sharded_fit_matches_reference(outs, reference, name):
    """Concatenated fits equal the reference's unsharded fit of the 10
    series within the family's tolerance; padding rows are not ok."""
    rel = FAMILIES[name][2]
    want = reference[f"fit_{name}"]
    ok = _cat(outs, f"fit_{name}_ok")
    assert ok.shape == (12,)
    np.testing.assert_array_equal(ok[:10], want["ok"])
    assert not ok[10:].any()
    for k in ("yhat", "lo", "hi"):
        _close_to_scale(_cat(outs, f"fit_{name}_{k}")[:10], want[k], rel,
                        f"{name} {k}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_sharded_cv_matches_reference(outs, reference, name):
    """Per-series CV means, trimmed to the 10 series (the last rank returns
    its two real rows), the reference's cutoff count and metric set, the
    values within the family's CV tolerance."""
    rtol = FAMILIES[name][3]
    want = reference[f"cv_{name}"]
    assert [o[f"cv_{name}_mape"].shape[0] for o in outs] == [4, 4, 2]
    for o in outs:
        assert int(o[f"cv_{name}_n_cutoffs"]) == want["_n_cutoffs"] == 2
        assert list(o[f"cv_{name}_keys"]) == sorted(
            k for k in want if not k.startswith("_"))
    for k in METRICS:
        if k == "coverage" and FAMILIES[name][0] == "prophet":
            # one scored point a cutoff, on the band's edge
            tol = dict(rtol=0, atol=1 / CV["horizon"] / 2)
        else:
            tol = dict(rtol=rtol, atol=1e-6)
        np.testing.assert_allclose(_cat(outs, f"cv_{name}_{k}"), want[k],
                                   err_msg=k, **tol)


def test_global_metric_means_match_the_references_psum(outs, reference):
    """The port's one all-reduce against the reference's ``psum`` over the
    same per-series values on a 3-device mesh (padded to 12 rows, the
    padding not ok); every rank holds the same means."""
    import jax.numpy as jnp

    from distributed_forecasting_tpu.parallel import global_metric_means

    per = {k: np.concatenate([_cat(outs, f"cv_holt_winters_{k}"),
                              np.zeros(2, np.float32)]) for k in METRICS}
    ok = np.arange(12) < 10
    want = global_metric_means({k: jnp.asarray(v) for k, v in per.items()},
                               jnp.asarray(ok), reference["mesh"])
    for k in METRICS:
        assert len({float(o[f"means_{k}"]) for o in outs}) == 1, k
        np.testing.assert_allclose(float(outs[0][f"means_{k}"]),
                                   float(want[k]), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(outs[0][f"means_{k}"]),
                                   np.mean(per[k][:10], dtype=np.float64),
                                   rtol=1e-6, err_msg=k)


def test_padding_rows_leave_the_means_alone(outs):
    """The reference's uneven-shard check: 1.0 on every healthy row, 100 on
    padding, so any padding row in the mean would move it."""
    for o in outs:
        assert float(o["means_padding"]) == 1.0


def test_gather_bottom_sharded_matches_reference(outs, reference):
    for o in outs:
        np.testing.assert_array_equal(o["gather"], reference["gather"])


def test_sharded_fit_refuses_per_series_xreg_of_the_wrong_rows(outs):
    for o in outs:
        assert "leads with 3 rows, expected 10" in str(o["xreg_rows_error"])


def test_windowed_mesh_matches_unsharded(outs):
    """``windowed_fit_forecast(mesh=...)`` over 3 ranks (one series each)
    against the port's unsharded windowed fit, at the reference's 2e-4;
    every rank returns the whole, identical result."""
    from distributed_forecasting_tpu_torch.engine.windowed import (
        windowed_fit_forecast,
    )

    wy = _ar2(WIN["S"], WIN["T"], WIN["seed"])
    params, res = windowed_fit_forecast(
        _win_batch(wy), horizon=WIN["horizon"], wconfig=_win_config())
    for o in outs[1:]:
        for k in o:
            if k.startswith("win_"):
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    got = outs[0]
    assert got["win_yhat"].shape == tuple(res.yhat.shape)
    for k in ("yhat", "lo", "hi"):
        np.testing.assert_allclose(got[f"win_{k}"], getattr(res, k).numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    np.testing.assert_array_equal(got["win_ok"], res.ok.numpy())
    np.testing.assert_array_equal(got["win_day_all"], res.day_all.numpy())
    for f in dataclasses.fields(params):
        np.testing.assert_allclose(got[f"win_p_{f.name}"],
                                   getattr(params, f.name).numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=f.name)


def test_windowed_unsharded_matches_reference():
    """The other half of the windowed chain at the mesh case's size: the
    port's unsharded fit against the reference's (the tolerances of
    ``test_torch_windowed.py``)."""
    import jax
    import jax.numpy as jnp

    from distributed_forecasting_tpu.data.tensorize import SeriesBatch
    from distributed_forecasting_tpu.engine import windowed as jwin
    from distributed_forecasting_tpu_torch.engine.windowed import (
        windowed_fit_forecast,
    )

    wy = _ar2(WIN["S"], WIN["T"], WIN["seed"])
    S, T = wy.shape
    params, res = windowed_fit_forecast(
        _win_batch(wy), horizon=WIN["horizon"], wconfig=_win_config())
    jp, jr = jwin.windowed_fit_forecast(
        SeriesBatch(y=jnp.asarray(wy), mask=jnp.ones((S, T), jnp.float32),
                    day=jnp.arange(T, dtype=jnp.int32),
                    keys=jnp.arange(S, dtype=jnp.int32)[:, None],
                    key_names=("series",), start_date="1970-01-01"),
        horizon=WIN["horizon"], key=jax.random.PRNGKey(0),
        wconfig=jwin.WindowedConfig(enabled=True, window_len=512, overlap=64,
                                    min_windows=2))
    for f in dataclasses.fields(params):
        g, w = getattr(params, f.name).numpy(), np.asarray(getattr(jp, f.name))
        if f.name in ("phi", "theta"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                       err_msg=f.name)
        else:
            _close_to_scale(g, w, 1e-4, f.name)
    for k in ("yhat", "lo", "hi"):
        _close_to_scale(getattr(res, k).numpy(), np.asarray(getattr(jr, k)),
                        1e-4, k)
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jr.ok))


# -- one process, no group --------------------------------------------------------

@pytest.fixture()
def no_group(monkeypatch):
    """A process with no group (another test in this process may have one):
    ``init_process_group`` records its arguments instead of joining."""
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.parallel import mesh as tmesh

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(tmesh, "_DISTRIBUTED_UP", False)
    monkeypatch.setattr(tmesh, "_RANK_DEVICE", None)
    return calls


def test_mesh_too_many_devices_errors(no_group):
    from distributed_forecasting_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="devices"):
        make_mesh(1024, device="cpu")
    assert no_group == []


def test_initialize_distributed_plumbing(no_group):
    """The reference's ``test_initialize_distributed_plumbing``: single
    process confs are a no-op; a multi-process conf is forwarded once (the
    backend by the rule, the coordinator as a tcp:// init method), and a
    second call in the process joins nothing again."""
    from distributed_forecasting_tpu_torch.parallel import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu")
    initialize_distributed(num_processes=1, device="cpu")
    initialize_distributed(num_processes=0, device="cpu")
    assert no_group == []
    for _ in range(2):
        initialize_distributed(coordinator_address="10.0.0.1:1234",
                               num_processes=4, process_id=2, device="cpu")
    assert no_group == [{"backend": "gloo",
                         "init_method": "tcp://10.0.0.1:1234",
                         "world_size": 4, "rank": 2}]


def test_initialize_distributed_from_a_store(no_group, monkeypatch):
    """A store the caller holds (a replica's own ranks) is forwarded in
    place of an init method, with the timeout; every rank is on this host,
    so a launcher's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` are not read."""
    import datetime

    from distributed_forecasting_tpu_torch.parallel import (
        initialize_distributed,
    )

    monkeypatch.setenv("LOCAL_RANK", "5")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    store, timeout = object(), datetime.timedelta(seconds=7)
    dev = initialize_distributed(num_processes=3, process_id=1,
                                 device="cpu", store=store, timeout=timeout)
    assert dev == torch.device("cpu")
    assert no_group == [{"backend": "gloo", "store": store, "timeout": timeout,
                         "world_size": 3, "rank": 1}]
    assert initialize_distributed(num_processes=3, process_id=1,
                                  device="cpu", store=store) == dev
    assert len(no_group) == 1


@pytest.mark.parametrize("device_type, local_ranks, cards, backend", [
    ("cpu", 3, 0, "gloo"),
    ("cpu", 1, 8, "gloo"),
    ("cuda", 2, 1, "gloo"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 8, 4, "gloo"),
], ids=["cpu_ranks", "cpu_rank_beside_cards", "two_ranks_one_card",
        "one_rank_one_card", "a_card_each", "cards_shared"])
def test_backend_rule(device_type, local_ranks, cards, backend):
    from distributed_forecasting_tpu_torch.parallel.mesh import choose_backend

    assert choose_backend(device_type, local_ranks, cards) == backend


def test_entry_points_refuse_without_a_mesh():
    from distributed_forecasting_tpu_torch import data as tdata
    from distributed_forecasting_tpu_torch.parallel import (
        sharded_cv_metrics,
        sharded_fit_forecast,
    )

    batch = tdata.tensorize(_sales(), device="cpu")
    for fn in (sharded_fit_forecast, sharded_cv_metrics):
        with pytest.raises(ValueError, match="make_mesh"):
            fn(batch, "holt_winters")


if __name__ == "__main__":
    sys.exit(_rank_main())
