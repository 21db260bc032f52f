"""Port parity and invariants: the batched gradient trainer
(``engine/gradfit.py``) and the optimizer twins (``ops/optim.py``).

* ``torch.optim`` (what the trainer steps with) against the port's plain
  twins and against the reference's own transforms (``ops/optim.py``'s
  jax fallbacks and optax, which the reference prefers), one step and 50
  steps on the same gradients.  The plain twins are the reference's own
  arithmetic: within atol 1e-7 of its fallbacks (measured 3e-8).
  ``torch.optim``: SGD and momentum step ``p + (-lr)·v`` in one fused op,
  within an ulp of the parameters (atol 1e-7 after one step; 2.5e-7 and
  5e-7 after 50, where momentum's parameters reach 4.6: measured 1.2e-7
  and 2.4e-7); Adam rounds differently (``m/(sqrt(v)/sqrt(bc2)+eps) ·
  lr/bc1`` against ``lr·(m/bc1)/(sqrt(v/bc2)+eps)``): atol 1e-6 after one
  step and 1e-5 after 50 (measured 3.6e-7 and 4.6e-6).
* The trainer's invariants, bitwise on the CPU (``tests/test_torch_cuda.py``
  holds them on the card): the engine path (padded to the bucket,
  host-assembled minibatches, prefetched copies) equals the family's own
  trainer; bucket growth changes nothing; two fits with one seed are
  equal; a lone series trains as it does beside others.
* The conf block, the ladder and the optimizer factory behave as the
  reference's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_forecasting_tpu.engine import gradfit as jg
from distributed_forecasting_tpu.models import arnet as ja
from distributed_forecasting_tpu.ops import optim as jopt
from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.engine import gradfit as tg
from distributed_forecasting_tpu_torch.models import arnet as ta
from distributed_forecasting_tpu_torch.ops import optim as topt

torch.set_num_threads(1)

LR = 0.05


def _grads(step, n=8):
    """Deterministic, changing gradients for step ``step``."""
    rng = np.random.default_rng(step)
    return {"w": rng.normal(size=n).astype(np.float32),
            "b": rng.normal(size=()).astype(np.float32)}


def _torch_optim(name, params):
    cfg = ta.ArnetConfig(optimizer=name, learning_rate=LR)
    return tg.make_optimizer(cfg, list(params.values()))


def _run_torch(name, steps):
    p0 = {"w": np.linspace(-1.0, 1.0, 8, dtype=np.float32),
          "b": np.float32(0.3)}
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = _torch_optim(name, params)
    for s in range(steps):
        for k, g in _grads(s).items():
            params[k].grad = torch.tensor(g)
        opt.step()
    return {k: v.detach().numpy() for k, v in params.items()}


def _run_transform(tx, apply, steps, to, frm):
    params = {"w": to(np.linspace(-1.0, 1.0, 8, dtype=np.float32)),
              "b": to(np.float32(0.3))}
    state = tx.init(params)
    for s in range(steps):
        grads = {k: to(g) for k, g in _grads(s).items()}
        updates, state = tx.update(grads, state)
        params = apply(params, updates)
    return {k: frm(v) for k, v in params.items()}


TWINS = {"adam": (topt.adam, jopt.adam, lambda lr: optax.adam(lr)),
         "sgd": (topt.sgd, jopt.sgd, lambda lr: optax.sgd(lr)),
         "momentum": (topt.momentum, jopt.momentum,
                      lambda lr: optax.sgd(lr, momentum=0.9))}
ATOL = {("adam", 1): 1e-6, ("adam", 50): 1e-5, ("sgd", 1): 1e-7,
        ("sgd", 50): 2.5e-7, ("momentum", 1): 1e-7, ("momentum", 50): 5e-7}


@pytest.mark.parametrize("steps", [1, 50])
@pytest.mark.parametrize("name", ["adam", "sgd", "momentum"])
def test_torch_optim_matches_twin_and_reference(name, steps):
    got = _run_torch(name, steps)
    twin, jfallback, jox = TWINS[name]
    plain = _run_transform(twin(LR), topt.apply_updates, steps,
                           lambda a: torch.tensor(a), lambda t: t.numpy())
    jfb = _run_transform(jfallback(LR), jopt.apply_updates, steps,
                         jnp.asarray, np.asarray)
    jox = _run_transform(jox(LR), optax.apply_updates, steps,
                         jnp.asarray, np.asarray)
    atol = ATOL[name, steps]
    for k in got:
        np.testing.assert_allclose(plain[k], jfb[k], rtol=0, atol=1e-7)
        np.testing.assert_allclose(got[k], plain[k], rtol=0, atol=atol)
        np.testing.assert_allclose(got[k], jox[k], rtol=0, atol=atol)


def test_make_optimizer_rejects_unknown_name():
    with pytest.raises(ValueError, match="optimizer") as err:
        tg.make_optimizer(ta.ArnetConfig(optimizer="lion"),
                          [torch.zeros(1, requires_grad=True)])
    with pytest.raises(ValueError) as ref:
        jg.make_optimizer(ja.ArnetConfig(optimizer="lion"))
    assert str(err.value) == str(ref.value)


def test_gradfit_conf_like_reference():
    for bad in ({"series_bucet": 64}, {"prefetch_depth": -1},
                {"series_bucket": 0}):
        with pytest.raises(ValueError) as err:
            tg.GradFitConfig.from_conf(bad)
        with pytest.raises(ValueError) as ref:
            jg.GradFitConfig.from_conf(bad)
        assert str(err.value) == str(ref.value)
    cfg = tg.GradFitConfig.from_conf({"enabled": True, "series_bucket": 128})
    assert cfg == tg.GradFitConfig(enabled=True, series_bucket=128)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jg.GradFitConfig.from_conf({"enabled": True, "series_bucket": 128}))


def test_series_bucket_ladder():
    for n, base in ((1, 64), (64, 64), (65, 64), (1000, 64), (5, 8), (9, 8)):
        assert tg.series_bucket(n, base) == jg.series_bucket(n, base)
    assert [tg.series_bucket(n, 64) for n in (1, 64, 65, 1000)] == [
        64, 64, 128, 1024]


def test_configure_gradfit_installs_the_block():
    try:
        cfg = tg.configure_gradfit({"enabled": True, "prefetch_depth": 0})
        assert tg.gradfit_config() is cfg and cfg.prefetch_depth == 0
    finally:
        tg.configure_gradfit(tg.GradFitConfig())
    assert not tg.gradfit_config().enabled


# -- the invariants ------------------------------------------------------------

def _batch(S=5, T=400, seed=4, R=0, per_series=False):
    rng = np.random.default_rng(seed)
    y = np.zeros((S, T))
    for t in range(2, T):
        y[:, t] = 0.5 * y[:, t - 1] - 0.2 * y[:, t - 2] + 0.3 * rng.normal(
            size=S)
    y += 20.0 * (1 + np.arange(S))[:, None]
    mask = (rng.random((S, T)) > 0.05).astype(np.float32)
    batch = SeriesBatch(
        y=torch.tensor(y * mask, dtype=torch.float32),
        mask=torch.from_numpy(mask),
        day=torch.arange(T, dtype=torch.int32) + 18000,
        keys=np.arange(S)[:, None], key_names=("id",),
        start_date="2019-04-14", freq="D")
    xreg = None
    if R:
        shape = (S, T + 30, R) if per_series else (T + 30, R)
        xreg = torch.tensor(rng.normal(size=shape), dtype=torch.float32)
    return batch, xreg


CASES = {"plain": {}, "shared_xreg": dict(R=2),
         "per_series_xreg": dict(R=2, per_series=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_eager_path_equals_family_trainer_bitwise(case):
    """The engine path (padded to a bucket, host minibatches, prefetched
    copies) reproduces the family's own trainer exactly."""
    batch, xreg = _batch(S=3, **CASES[case])
    cfg = ta.ArnetConfig(lags=7, epochs=5, seed=0,
                         n_regressors=0 if xreg is None else 2)
    p_in, r_in = tfit.fit_forecast(batch, model="arnet", config=cfg,
                                   horizon=30, xreg=xreg)
    for depth in (0, 2):
        p_eg, r_eg = tg.gradfit_fit_forecast(
            batch, config=cfg, horizon=30, xreg=xreg,
            gcfg=tg.GradFitConfig(enabled=True, series_bucket=4,
                                  prefetch_depth=depth))
        for name in ("yhat", "lo", "hi"):
            assert torch.equal(getattr(r_eg, name), getattr(r_in, name))
        assert torch.equal(p_eg.w, p_in.w)
        assert torch.equal(p_eg.beta, p_in.beta)


@pytest.mark.parametrize("case", list(CASES))
def test_bucket_growth_changes_nothing(case):
    """S = 5 series trained inside buckets of 8, 16 and 64 rows give the
    same bytes: padded rows shed zero gradient, and every sum adds a
    series' terms in one order whatever the rows beside it."""
    batch, xreg = _batch(S=5, **CASES[case])
    cfg = ta.ArnetConfig(lags=7, epochs=5, seed=0,
                         n_regressors=0 if xreg is None else 2)
    outs = [tg.gradfit_fit_forecast(
        batch, config=cfg, horizon=30, xreg=xreg,
        gcfg=tg.GradFitConfig(enabled=True, series_bucket=base))
        for base in (8, 16, 64)]
    for params, res in outs[1:]:
        assert torch.equal(params.w, outs[0][0].w)
        assert torch.equal(res.yhat, outs[0][1].yhat)


def test_fixed_seed_fits_are_bitwise_identical():
    batch, _ = _batch(S=3, seed=2)
    cfg = ta.ArnetConfig(lags=5, epochs=8, seed=7)
    p1, r1 = tfit.fit_forecast(batch, model="arnet", config=cfg, horizon=21)
    p2, r2 = tfit.fit_forecast(batch, model="arnet", config=cfg, horizon=21)
    assert torch.equal(r1.yhat, r2.yhat) and torch.equal(r1.lo, r2.lo)
    assert torch.equal(p1.w, p2.w)
    p3, _ = tfit.fit_forecast(batch, model="arnet",
                              config=dataclasses.replace(cfg, seed=8),
                              horizon=21)
    assert not torch.equal(p1.w, p3.w)


def test_series_train_alone_as_beside_others():
    """A series' weights, fitted path and forecast do not depend on the
    series trained with it: alone (S = 1), in the first rows, or beside
    many more."""
    batch, _ = _batch(S=20, seed=5)
    cfg = ta.ArnetConfig(lags=7, epochs=4, seed=1)
    full, rf = tfit.fit_forecast(batch, model="arnet", config=cfg, horizon=30)
    for n in (1, 2, 7):
        sub = dataclasses.replace(batch, y=batch.y[:n], mask=batch.mask[:n],
                                  keys=batch.keys[:n])
        p, r = tfit.fit_forecast(sub, model="arnet", config=cfg, horizon=30)
        assert torch.equal(p.w, full.w[:n])
        assert torch.equal(p.fitted, full.fitted[:n])
        assert torch.equal(r.hi, rf.hi[:n])


def test_engine_block_routes_fit_forecast():
    """Armed, ``engine.gradfit`` sends an arnet ``fit_forecast`` through
    the engine path; a schedule handed to both trainers trains both."""
    batch, _ = _batch(S=3, seed=6)
    cfg = ta.ArnetConfig(lags=7, epochs=3, seed=0)
    calls = []
    real = tg.gradfit_fit_forecast
    try:
        tg.configure_gradfit({"enabled": True, "series_bucket": 4})
        tg.gradfit_fit_forecast = lambda *a, **k: calls.append(1) or real(
            *a, **k)
        p_on, _ = tfit.fit_forecast(batch, model="arnet", config=cfg,
                                    horizon=10)
    finally:
        tg.gradfit_fit_forecast = real
        tg.configure_gradfit(tg.GradFitConfig())
    assert calls == [1]
    p_off, _ = tfit.fit_forecast(batch, model="arnet", config=cfg, horizon=10)
    assert torch.equal(p_on.w, p_off.w)
    sched = torch.randint(0, 400, (6, 64),
                          generator=torch.Generator().manual_seed(0))
    z, _, _, xz, valid, _, _ = ta.prep_training(batch.y, batch.mask, cfg)
    w_scan, losses = tg.train_scan(z, xz, valid, cfg, schedule=sched)
    w_host = tg.host_train(batch.y, batch.mask, batch.day, cfg,
                           gcfg=tg.GradFitConfig(series_bucket=8),
                           schedule=sched)
    assert losses.shape == (6,)
    for k in ("w", "beta", "b"):
        assert torch.equal(w_scan[k], w_host[k])


def test_chunked_and_bucketed_entry_points_run_arnet():
    """The chunked fit equals the whole fit to the bit (each series trains
    alone as beside others); the span-bucketed fit trains each bucket on
    its own trimmed grid and forecasts every series."""
    from distributed_forecasting_tpu_torch.engine.fit import (
        fit_forecast_bucketed,
        fit_forecast_chunked,
    )

    batch, _ = _batch(S=7, seed=8)
    cfg = ta.ArnetConfig(lags=7, epochs=3, seed=2)
    whole, rw = tfit.fit_forecast(batch, model="arnet", config=cfg,
                                  horizon=20)
    chunked, rc = fit_forecast_chunked(batch, model="arnet", config=cfg,
                                       horizon=20, chunk_size=3)
    assert torch.equal(chunked.w, whole.w) and torch.equal(rc.hi, rw.hi)
    late = batch.mask.clone()
    late[:3, :200] = 0.0
    ragged = dataclasses.replace(batch, mask=late, y=batch.y * late)
    buckets, rb = fit_forecast_bucketed(ragged, model="arnet", config=cfg,
                                        horizon=20)
    assert len(buckets) == 2 and rb.yhat.shape == rw.yhat.shape
    assert bool(rb.ok.all()) and bool(torch.isfinite(rb.yhat).all())
