"""Port parity: a replica's predict over a mesh of ranks
(``BatchForecaster.enable_mesh``, ``parallel.shard_forecast_inputs``,
``serving/predictor.serve_mesh_followers``), held to the port's own
single-device predict and to the reference's mesh predict.

A module fixture fits every family of the port's registry on the CPU
(``synthetic_store_item_sales`` 2 x 3 x 120 days at seed 11: S 6, a
multiple of neither 3 nor 4, as ``tests/unit/test_sharded_serving.py``
chooses) and saves each artifact, then spawns one gloo group of three CPU
ranks running this file's ``__main__`` (no JAX there).  Rank 0 is the
serving rank: it loads each artifact, predicts requests of 1, S - 1 and S
series at horizon 5 on its own device and over the mesh, and saves the
frames; ranks 1 and 2 run the follower loop until rank 0's stop message.
Between the two, rank 0 sends two curve dispatches whose blocks raise (a
malformed request on every rank, an injected fault on rank 1 alone) and
one predict after them.
Before that, every rank calls ``shard_forecast_inputs`` on two seeded
input sets and saves its block.  The parent computes the reference's
results meanwhile, on the conftest's 8 virtual CPU devices.

Tolerances:
  * the mesh predict and ``predict_quantiles`` against the single-device
    ones: byte-equal frames (every family's forecast works row by row);
  * each rank's block against the reference's shard on device ``r``:
    exact (no arithmetic, only placement);
  * the port's mesh predict against the reference's ``enable_mesh(
    make_mesh(3))`` predict of the same artifact, each family under the
    tolerance its port predict test states: Holt-Winters and theta rtol
    1e-5 / atol 1e-5 of the data's scale (``test_torch_predictor.py``,
    ``test_torch_theta.py``), the curve models rtol 1e-5 / atol 1e-5 of
    scale (``test_torch_predictor.py``), arima atol 1e-3 of scale
    (``test_torch_arima.py``), croston rtol 1e-5 / atol 1e-6
    (``test_torch_croston.py``), arnet rtol 1e-5 (``test_torch_arnet.py``).
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)

WORLD = 3
SALES = dict(n_stores=2, n_items=3, n_days=120, seed=11)   # S 6
HORIZON = 5
QS = (0.1, 0.5, 0.9)
FAMILIES = ["arima", "arnet", "croston", "curve", "holt_winters", "prophet",
            "prophet_ar", "theta"]
# family -> (rtol, atol as a multiple of the data's scale, absolute atol)
TOL = {"holt_winters": (1e-5, 1e-5, 0.0), "theta": (1e-5, 1e-5, 0.0),
       "curve": (1e-5, 1e-5, 0.0), "prophet": (1e-5, 1e-5, 0.0),
       "prophet_ar": (1e-5, 1e-5, 0.0), "arima": (0.0, 1e-3, 0.0),
       "croston": (1e-5, 0.0, 1e-6), "arnet": (1e-5, 0.0, 0.0)}
T_SFI = 40         # the per-series case's grid; the shared case's is 6
FAULT_HORIZON = 7  # rank 1's block of a dispatch at this horizon raises
FAULT_DISPATCHES = 3  # the two that raise and the predict after them
SFI_CASES = ("per_series", "shared_calendar")


def _sizes(S: int) -> tuple:
    return (1, S - 1, S)


def _request(fc, k: int) -> pd.DataFrame:
    return pd.DataFrame(np.asarray(fc.keys[:k]), columns=list(fc.key_names))


def _frame_arrays(frame: pd.DataFrame, prefix: str) -> dict:
    return {f"{prefix}|{col}": frame[col].to_numpy() for col in frame.columns}


def sfi_inputs(case: str) -> dict:
    """Seeded numpy inputs of one ``shard_forecast_inputs`` case: a bucket
    of 6 rows (two a rank), the curve artifact's params gathered to it
    (0-d and empty leaves replicate), a scale, and a per-series (6, 40, 2)
    ``xreg`` or a shared (6, 2) calendar over a 6-day grid (T_all ==
    bucket: it still replicates)."""
    rng = np.random.default_rng(5 if case == "per_series" else 6)
    T = T_SFI if case == "per_series" else 6
    xreg = (rng.normal(size=(6, T, 2)) if case == "per_series"
            else rng.normal(size=(T, 2))).astype(np.float32)
    return {"rows": np.array([0, 1, 2, 3, 4, 0]),
            "day_all": np.arange(100, 100 + T, dtype=np.int32),
            "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "xreg": xreg}


# -- one rank (this file's __main__) --------------------------------------------

def _rank_outputs(rank: int, world: int, port: int, art: str) -> dict:
    import dataclasses

    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        shard_forecast_inputs,
    )
    from distributed_forecasting_tpu_torch.serving.ensemble import (
        MultiModelForecaster,
    )
    from distributed_forecasting_tpu_torch.serving.predictor import (
        BatchForecaster,
        mesh_refusal,
        serve_mesh_followers,
    )

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = make_mesh(world, device="cpu")
    out = {}

    curve = BatchForecaster.load(os.path.join(art, "curve"), device="cpu")
    for case in SFI_CASES:
        got = (None,) * 4
        if rank == 0:
            x = sfi_inputs(case)
            got = (curve.gather_params(x["rows"]),
                   torch.from_numpy(x["day_all"]),
                   torch.from_numpy(x["scale"]),
                   {"xreg": torch.from_numpy(x["xreg"])})
        params, day_all, scale, kw = shard_forecast_inputs(
            *got, mesh, 6 if rank == 0 else None)
        for f in dataclasses.fields(params):
            out[f"sfi|{case}|params|{f.name}"] = \
                getattr(params, f.name).numpy()
        out[f"sfi|{case}|day_all"] = day_all.numpy()
        out[f"sfi|{case}|scale"] = scale.numpy()
        out[f"sfi|{case}|xreg"] = kw["xreg"].numpy()

    if rank != 0:
        if rank == 1:  # this rank's block of a FAULT_HORIZON dispatch raises
            from distributed_forecasting_tpu_torch.serving import predictor

            block_outputs = predictor._block_outputs

            def faulty(fns, header, *args):
                if header["horizon"] == FAULT_HORIZON:
                    raise RuntimeError("injected fault on rank 1")
                return block_outputs(fns, header, *args)

            predictor._block_outputs = faulty
        served = serve_mesh_followers(mesh, report=lambda: {"rank": rank})
        out["served"] = np.array(served)
        dist.destroy_process_group()
        return out

    try:
        curve.gather_params(np.array([0]))
        shard_forecast_inputs(*(None,) * 4, mesh, 5)
    except ValueError as e:
        out["off_mesh_error"] = np.array(str(e))
    fcs = {}
    for model in FAMILIES:
        fc = BatchForecaster.load(os.path.join(art, model), device="cpu")
        fcs[model] = fc
        S = fc.n_series
        for leg in ("single", "mesh"):
            if leg == "mesh":
                fc.enable_mesh(mesh)
                out[f"{model}|entry"] = np.array(
                    fc._aot_entry("serving_predict"))
                out[f"{model}|buckets"] = np.array(
                    [fc._bucket(k) for k in _sizes(S)])
            for k in _sizes(S):
                req = _request(fc, k)
                out.update(_frame_arrays(
                    fc.predict(req, horizon=HORIZON), f"{model}|{leg}|{k}"))
                out.update(_frame_arrays(
                    fc.predict_quantiles(req, quantiles=QS, horizon=HORIZON),
                    f"{model}|{leg}|q{k}"))
            if leg == "mesh":
                fc.disable_mesh()

    # blocks that raise: a malformed request raises on every rank (an xreg
    # for a model fit without regressors), rank 1's block alone raises at
    # FAULT_HORIZON; then a predict over the same mesh
    fc = fcs["curve"]
    fc.enable_mesh(mesh)
    T_all = fc.day1 - fc.day0 + HORIZON + 1
    for name, kwargs in (
            ("xreg", {"horizon": HORIZON,
                      "xreg": torch.zeros((T_all, 2), dtype=torch.float32)}),
            ("rank1", {"horizon": FAULT_HORIZON})):
        try:
            fc.predict(_request(fc, 6), **kwargs)
            out[f"fault|{name}"] = np.array("")
        except (ValueError, RuntimeError) as e:
            out[f"fault|{name}"] = np.array(f"{type(e).__name__}: {e}")
    out.update(_frame_arrays(fc.predict(_request(fc, 6), horizon=HORIZON),
                             "curve|after_fault|6"))
    fc.disable_mesh()

    # a curve model with Monte-Carlo intervals and a composite: no mesh
    # predict, and the replica's refusal reason for each
    mc = BatchForecaster(
        model="curve", config=dataclasses.replace(
            curve.config, uncertainty_samples=50),
        params=curve.params, keys=curve.keys, key_names=curve.key_names,
        day0=curve.day0, day1=curve.day1)
    try:
        mc.enable_mesh(mesh)
        out["mc_error"] = np.array("")
    except ValueError as e:
        out["mc_error"] = np.array(str(e))
    out["mc_refusal"] = np.array(mesh_refusal(mc) or "")
    ens = MultiModelForecaster(
        {"theta": fcs["theta"], "holt_winters": fcs["holt_winters"]},
        np.array(["theta", "holt_winters"] * 3))
    out["ensemble_refusal"] = np.array(mesh_refusal(ens) or "")
    out["theta_refusal"] = np.array(mesh_refusal(fcs["theta"]) or "None")
    mc_frame = mc.predict(_request(mc, 3), horizon=HORIZON)
    out["mc_rows"] = np.array(len(mc_frame))

    last = fcs["theta"]
    last.enable_mesh(mesh)
    out["reports"] = np.array(repr(last.stop_mesh()))
    out["stopped_mesh"] = np.array(last.mesh is None)
    dist.destroy_process_group()
    return out


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of the mesh group")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = _rank_outputs(args.rank, args.world, args.port,
                        os.path.join(args.out, "art"))
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    return 0


# -- the parent ------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir():
    with tempfile.TemporaryDirectory(prefix="dftt-mesh-") as tmp:
        yield tmp


@pytest.fixture(scope="module")
def artifacts(workdir):
    """Every family fit by the port on the CPU and saved under
    ``<workdir>/art/<family>``; the data's scale."""
    import distributed_forecasting_tpu_torch.data as tdata
    from distributed_forecasting_tpu_torch.engine import fit_forecast
    from distributed_forecasting_tpu_torch.models import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    batch = tdata.tensorize(tdata.synthetic_store_item_sales(**SALES),
                            device="cpu")
    for model in FAMILIES:
        cfg = get_model(model).config_cls()
        params, _ = fit_forecast(batch, model, config=cfg, horizon=HORIZON)
        BatchForecaster.from_fit(batch, params, model, cfg).save(
            os.path.join(workdir, "art", model))
    return os.path.join(workdir, "art"), float(batch.y.abs().max())


@pytest.fixture(scope="module")
def ranks(artifacts, workdir):
    """The three ranks, started before the reference below runs."""
    from test_torch_parallel import Ranks

    group = Ranks(os.path.abspath(__file__), WORLD, workdir)
    try:
        yield group
    finally:
        group.close()


@pytest.fixture(scope="module")
def reference(artifacts, ranks):
    """The reference's mesh predicts of each artifact on a 3-device mesh,
    and its ``shard_forecast_inputs`` shards of each case by device."""
    import jax
    import jax.numpy as jnp

    from distributed_forecasting_tpu.parallel import (
        make_mesh,
        shard_forecast_inputs,
    )
    from distributed_forecasting_tpu.serving import predictor as jpred

    art, _ = artifacts
    mesh = make_mesh(WORLD)
    out = {"predict": {}, "sfi": {}}
    for model in FAMILIES:
        fc = jpred.BatchForecaster.load(os.path.join(art, model))
        fc.enable_mesh(mesh)
        S = fc.n_series
        for k in _sizes(S):
            out["predict"][(model, k)] = fc.predict(_request(fc, k),
                                                    horizon=HORIZON)
        out["predict"][(model, f"q{S - 1}")] = fc.predict_quantiles(
            _request(fc, S - 1), quantiles=QS, horizon=HORIZON)
        fc.disable_mesh()
    curve = jpred.BatchForecaster.load(os.path.join(art, "curve"))
    S = curve.n_series
    for case in SFI_CASES:
        x = sfi_inputs(case)
        rows = jnp.asarray(x["rows"])
        params = jax.tree_util.tree_map(
            lambda v: v[rows] if v.ndim >= 1 and v.shape[0] == S else v,
            curve.params)
        placed = shard_forecast_inputs(
            params, jnp.asarray(x["day_all"]), jnp.asarray(x["scale"]),
            {"xreg": jnp.asarray(x["xreg"])}, mesh, 6)
        p, day_all, scale, kw = placed
        leaves = {f"params|{name}": getattr(p, name)
                  for name in p.__dataclass_fields__}
        leaves.update({"day_all": day_all, "scale": scale,
                       "xreg": kw["xreg"]})
        for name, arr in leaves.items():
            by_dev = {s.device: np.asarray(s.data)
                      for s in arr.addressable_shards}
            out["sfi"][(case, name)] = [by_dev[d] for d in mesh.devices.flat]
    return out


@pytest.fixture(scope="module")
def outputs(ranks, reference):
    """Every rank's outputs in rank order (the reference computed while
    the ranks ran)."""
    return ranks.wait()


def _frame(out: dict, prefix: str) -> pd.DataFrame:
    cols = {key.split("|")[-1]: out[key] for key in out
            if key.startswith(prefix + "|")}
    return pd.DataFrame(cols)


def _assert_byte_equal(got: pd.DataFrame, want: pd.DataFrame, what: str):
    assert list(got.columns) == list(want.columns), what
    for col in got.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, col)
        assert g.tobytes() == w.tobytes(), (what, col)


@pytest.mark.parametrize("model", FAMILIES)
def test_mesh_predict_is_byte_equal_to_single_device(outputs, model):
    """Every family at 1, S - 1 and S series (S 6 over 3 ranks: buckets 3,
    6, 6, the padding rows repeating the first series)."""
    out = outputs[0]
    for k in _sizes(6):
        _assert_byte_equal(_frame(out, f"{model}|mesh|{k}"),
                           _frame(out, f"{model}|single|{k}"),
                           f"{model} k={k}")
    assert out[f"{model}|buckets"].tolist() == [3, 6, 6]


@pytest.mark.parametrize("model", FAMILIES)
def test_mesh_predict_quantiles_is_byte_equal_to_single_device(outputs,
                                                               model):
    out = outputs[0]
    for k in _sizes(6):
        got = _frame(out, f"{model}|mesh|q{k}")
        assert [c for c in got.columns if c.startswith("q")] == [
            "q0.1", "q0.5", "q0.9"]
        _assert_byte_equal(got, _frame(out, f"{model}|single|q{k}"),
                           f"{model} quantiles k={k}")


@pytest.mark.parametrize("model", FAMILIES)
def test_mesh_predict_matches_the_reference_mesh(outputs, reference,
                                                 artifacts, model):
    _, scale = artifacts
    rtol, rel, atol = TOL[model]
    out = outputs[0]
    for k in (*_sizes(6), "q5"):
        got = _frame(out, f"{model}|mesh|{k}")
        want = reference["predict"][(model, k)]
        assert list(got.columns) == list(want.columns)
        np.testing.assert_array_equal(got["ds"].to_numpy(),
                                      want["ds"].to_numpy())
        for col in got.columns:
            if col == "ds":
                continue
            np.testing.assert_allclose(
                got[col].to_numpy(), want[col].to_numpy(), rtol=rtol,
                atol=atol + rel * scale, err_msg=f"{model} {k} {col}")


@pytest.mark.parametrize("case", SFI_CASES)
def test_shard_forecast_inputs_blocks_are_the_reference_shards(
        outputs, reference, case):
    """Rank ``r``'s block of every leaf equals the reference's shard on
    device ``r``: row leaves (the params' series rows, the scale, a
    per-series xreg) by block, the rest (the grid, 0-d and empty params
    leaves, a shared calendar with T_all == bucket) whole."""
    names = {key for (c, key) in reference["sfi"] if c == case}
    assert {"day_all", "scale", "xreg"} <= names
    for name in sorted(names):
        for r in range(WORLD):
            got = outputs[r][f"sfi|{case}|{name}"]
            want = reference["sfi"][(case, name)][r]
            assert got.shape == want.shape, (case, name, r)
            assert got.dtype == want.dtype, (case, name, r, got.dtype,
                                             want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} r{r}")
    xreg = [outputs[r][f"sfi|{case}|xreg"] for r in range(WORLD)]
    if case == "per_series":
        assert all(x.shape == (2, T_SFI, 2) for x in xreg)
    else:
        assert all(x.shape == (6, 2) for x in xreg)


def test_mesh_buckets_entry_and_the_refused_bucket(outputs):
    out = outputs[0]
    assert str(out["theta|entry"]) == "serving_predict:theta@mesh3"
    assert "not a multiple of the mesh size 3" in str(out["off_mesh_error"])


def test_followers_serve_every_dispatch_and_stop(outputs):
    """Each follower ran every mesh dispatch (6 a family: a predict and a
    quantile predict at 3 sizes, plus the bucket probes' none; then the
    curve model's two dispatches that raise and the one after them) and
    returned on the stop message, whose reports reach rank 0 in order."""
    n = len(FAMILIES) * 2 * len(_sizes(6)) + FAULT_DISPATCHES
    assert [int(outputs[r]["served"]) for r in (1, 2)] == [n, n]
    assert str(outputs[0]["reports"]) == repr([{"rank": 1}, {"rank": 2}])
    assert bool(outputs[0]["stopped_mesh"])


def test_a_block_that_raises_keeps_the_ranks_in_step(outputs):
    """A malformed request raises on every rank: the serving rank raises
    the request's own error, as on one device, and the followers log it
    and serve on (their count includes it,
    ``test_followers_serve_every_dispatch_and_stop``).  A block that raises
    on follower rank 1 alone makes the serving rank raise an error naming
    the rank instead of answering with its rows.  The predict after both
    is byte-equal to single-device."""
    out = outputs[0]
    assert str(out["fault|xreg"]).startswith(
        "ValueError: xreg passed but config.n_regressors == 0")
    assert str(out["fault|rank1"]).startswith(
        "RuntimeError: mesh rank(s) [1] raised on their block")
    _assert_byte_equal(_frame(out, "curve|after_fault|6"),
                       _frame(out, "curve|single|6"), "after the faults")


def test_monte_carlo_and_composites_serve_on_one_device(outputs):
    out = outputs[0]
    assert "Monte-Carlo" in str(out["mc_error"])
    assert "Monte-Carlo" in str(out["mc_refusal"])
    assert "composite" in str(out["ensemble_refusal"])
    assert str(out["theta_refusal"]) == "None"
    assert int(out["mc_rows"]) == 3 * HORIZON


class _FourRanks:
    """What ``_bucket`` and ``_aot_entry`` read of a mesh: its size along
    the series axis (4) and this process's rank on it (0)."""

    mesh_dim_names = ("series",)

    def size(self, dim=None):
        return 4

    def get_local_rank(self, name=None):
        return 0


def test_bucket_and_entry_follow_the_reference_with_a_mesh_of_four(
        artifacts):
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    art, _ = artifacts
    fc = BatchForecaster.load(os.path.join(art, "theta"), device="cpu")
    assert fc._bucket(1) == 1 and fc._bucket(5) == 6
    assert fc._aot_entry("serving_predict") == "serving_predict:theta"
    fc.enable_mesh(_FourRanks())
    assert fc.mesh is not None
    # the ladder value first, then rounded up to a mesh multiple
    assert (fc._bucket(1), fc._bucket(3), fc._bucket(5)) == (4, 4, 8)
    assert fc._aot_entry("serving_predict") == "serving_predict:theta@mesh4"
    fc.disable_mesh()
    assert fc._bucket(5) == 6
    assert fc._aot_entry("serving_predict") == "serving_predict:theta"


if __name__ == "__main__":
    sys.exit(_rank_main())
