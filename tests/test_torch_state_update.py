"""Port parity: the streaming ``update_state`` of holt_winters, theta and
croston (``ops/update.py``, ``models/*.update_state``).

The port's claims, mirroring the reference's ``tests/unit/test_state_update
.py``, and how each is held:

- **within the port, bitwise** (``torch.equal``): each family's update
  steps through the function its fit runs (``_hw_step``, ``_ses_step``,
  ``_croston_step`` / ``_tsb_step``), so
  - Holt-Winters after k streamed columns equals the port's fit of the
    extended series (a pinned 1-candidate grid, so the grid search cannot
    pick another winner; ``filter: scan``, the CPU's route);
  - theta's level and fitted tail equal the port's own SES (``ses_paths``)
    run over the extended theta line under the original decomposition;
  - two updates of k1 and k2 columns equal one of k1 + k2, for all three
    families; padding columns (``valid`` 0) leave every carry unchanged;
  - croston's ``init_update_aux`` q equals a replay of the fit's interval
    count.
- **against a float32 replay**: croston / SBA / TSB states within rtol
  1e-6 of a numpy float32 replay of the recursion (the reference's own
  check; the replay forms ``1 - alpha`` in float32 where both packages
  form it in double, a one-ulp difference at most).
- **against the reference** on the same params and carries (the
  reference's, carried over by ``convert.py``) and the same columns:
  Holt-Winters states and preds within 1e-5 of each row's scale (XLA
  contracts the filter into FMAs, ROADMAP Queue 3), sigma within rtol
  1e-5; theta and croston within 2.4e-6 of scale (the fuzzed bound of
  ROADMAP Queue 3); the carries' ``n_obs`` and croston's ``q`` exactly
  (0/1 counts).
- sigma continues from ``sse = sigma^2 n`` (a square of a square root),
  so it matches a refit within rtol 1e-5, never bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_forecasting_tpu.engine  # noqa: F401 — before ops.update (import cycle)
from distributed_forecasting_tpu.models import base as jbase
from distributed_forecasting_tpu.ops import update as jupdate
from distributed_forecasting_tpu_torch import convert
from distributed_forecasting_tpu_torch.models import croston, holt_winters
from distributed_forecasting_tpu_torch.models import theta
from distributed_forecasting_tpu_torch.models.base import get_model
from distributed_forecasting_tpu_torch.ops.update import (
    apply_update,
    column_bucket,
)

torch.set_num_threads(1)

S, T0, M = 5, 70, 7
DAY0 = 1000  # absolute day ordinals, deliberately not starting at 0

# one candidate: the argmin is forced, so an extended fit runs the same
# (alpha, beta, gamma, phi) recursion
HW_PINNED = dict(n_alpha=1, n_beta=1, n_gamma=1, damped=False, filter="scan")


def _mk_series(seed=0, t=T0, intermittent=False):
    rng = np.random.default_rng(seed)
    day = np.arange(DAY0, DAY0 + t, dtype=np.int32)
    if intermittent:
        y = np.where(rng.random((S, t)) < 0.3,
                     rng.gamma(2.0, 3.0, (S, t)), 0.0)
    else:
        seas = 1.0 + 0.3 * np.sin(2 * np.pi * (day % M) / M)
        y = (10 + 0.05 * np.arange(t))[None, :] * seas[None, :] \
            + rng.normal(0, 0.5, (S, t))
    mask = (rng.random((S, t)) > 0.05).astype(np.float32)
    return y.astype(np.float32), mask, day


def _extend(y, mask, day, k, seed=1):
    y2, m2, _ = _mk_series(seed=seed, t=k)
    day_new = np.arange(day[-1] + 1, day[-1] + 1 + k, dtype=np.int32)
    return (np.concatenate([y, y2], 1), np.concatenate([mask, m2], 1),
            np.concatenate([day, day_new]), y2, m2, day_new)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _fit(model, cfg, y, mask, day):
    fns = get_model(model)
    params = fns.fit(_t(y), _t(mask), _t(day), cfg)
    return params, fns.init_update_aux(params, y=_t(y), mask=_t(mask))


def _update(model, cfg, params, aux, y_new, m_new, day_new, k_alloc=None):
    """The port's update, with the columns padded to ``k_alloc`` as the
    reference's store pads them."""
    k = y_new.shape[1]
    k_alloc = k_alloc or k
    pad = ((0, 0), (0, k_alloc - k))
    valid = np.concatenate([np.ones(k, np.float32),
                            np.zeros(k_alloc - k, np.float32)])
    days = np.concatenate([day_new, np.zeros(k_alloc - k, np.int32)])
    return apply_update(model, cfg, params, aux, _t(np.pad(y_new, pad)),
                        _t(np.pad(m_new, pad)), valid, days)


def _equal(a, b, what):
    assert torch.equal(a, b), what


# ---------------------------------------------------------------- HW ------

@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
@pytest.mark.parametrize("k", [1, 3, 11])
def test_hw_update_bitwise_vs_full_refit(mode, k):
    cfg = holt_winters.HoltWintersConfig(seasonality_mode=mode, **HW_PINNED)
    y, mask, day = _mk_series()
    y_ext, m_ext, day_ext, y_new, m_new, day_new = _extend(y, mask, day, k)
    params, aux = _fit("holt_winters", cfg, y, mask, day)
    p2, _, preds = _update("holt_winters", cfg, params, aux, y_new, m_new,
                           day_new)
    ref, _ = _fit("holt_winters", cfg, y_ext, m_ext, day_ext)
    _equal(p2.level, ref.level, "level")
    _equal(p2.trend, ref.trend, "trend")
    _equal(p2.season, ref.season, "season")
    _equal(preds, ref.fitted[:, -k:], "preds vs the refit's fitted tail")
    assert float(p2.t_fit_end) == float(ref.t_fit_end)
    # the installed params are left as they were: the update writes none
    again, _ = _fit("holt_winters", cfg, y, mask, day)
    _equal(params.season, again.season, "installed season untouched")
    np.testing.assert_allclose(p2.sigma.numpy(), ref.sigma.numpy(),
                               rtol=1e-5)


def test_hw_update_with_padding_bitwise():
    cfg = holt_winters.HoltWintersConfig(**HW_PINNED)
    y, mask, day = _mk_series()
    _, _, _, y_new, m_new, day_new = _extend(y, mask, day, 3)
    params, aux = _fit("holt_winters", cfg, y, mask, day)
    a = _update("holt_winters", cfg, params, aux, y_new, m_new, day_new,
                k_alloc=3)
    b = _update("holt_winters", cfg, params, aux, y_new, m_new, day_new,
                k_alloc=column_bucket(3))  # 4: one padding column
    for f in dataclasses.fields(a[0]):
        _equal(getattr(a[0], f.name), getattr(b[0], f.name), f.name)
    for key in a[1]:
        _equal(a[1][key], b[1][key], key)
    _equal(a[2], b[2][:, :3], "preds")


# ------------------------------------------------------------- theta ------

def _theta_frozen(y_ext, m_ext, day_ext, params, cfg):
    """The port's own SES over the extended theta line under the original
    decomposition (the first seven observed values lie in the original
    window, so the SES starts where the fit's did)."""
    dow = _t(day_ext % cfg.season_length).long()
    si = params.seas[:, dow]
    y_sa = _t(y_ext) / torch.clamp_min(si, theta._EPS)
    t = _t((day_ext - day_ext[0]).astype(np.float32))
    trend = params.intercept[:, None] + params.slope[:, None] * t[None, :]
    th = cfg.theta
    zline = th * y_sa + (1.0 - th) * trend
    buf = theta.ses_paths(zline, _t(m_ext), params.alpha[:, None])
    w = 1.0 / th
    fitted = (w * buf[:-1, :, 0].t() + (1.0 - w) * trend) * si
    return buf[-1, :, 0], fitted


@pytest.mark.parametrize("k", [1, 8])
def test_theta_update_bitwise_vs_frozen_continuation(k):
    cfg = theta.ThetaConfig()
    y, mask, day = _mk_series(seed=3)
    y_ext, m_ext, day_ext, y_new, m_new, day_new = _extend(y, mask, day, k,
                                                           seed=4)
    params, aux = _fit("theta", cfg, y, mask, day)
    p2, _, preds = _update("theta", cfg, params, aux, y_new, m_new, day_new,
                           k_alloc=column_bucket(k))
    level_ref, fitted_ref = _theta_frozen(y_ext, m_ext, day_ext, params, cfg)
    _equal(p2.level, level_ref, "ses level")
    _equal(preds[:, :k], fitted_ref[:, -k:], "fitted tail")
    _equal(fitted_ref[:, :T0], params.fitted, "the replay is the fit's")


# ----------------------------------------------------------- croston ------

def _croston_replay(y_new, m_new, params, cfg, aux0):
    """A numpy float32 replay of the recursion from the fit's final carry,
    every scalar a float32 (the reference's helper)."""
    f32, one = np.float32, np.float32(1.0)
    a, eps = f32(cfg.alpha), f32(croston._EPS)
    z = params.z_level.numpy().copy()
    out_z, out_p = np.empty(S, np.float32), np.empty(S, np.float32)
    if cfg.variant == "tsb":
        bta = f32(cfg.beta)
        b = aux0["b"].numpy()
        for s in range(S):
            zs, bs = f32(z[s]), f32(b[s])
            for t in range(y_new.shape[1]):
                yt, mt = f32(y_new[s, t]), f32(m_new[s, t])
                demand = (yt > eps) and (mt > 0)
                if mt > 0:
                    bs = f32(bta * (one if demand else f32(0.0))
                             + (one - bta) * bs)
                if demand:
                    zs = f32(a * yt + (one - a) * zs)
            out_z[s], out_p[s] = zs, f32(one / max(bs, eps))
    else:
        p, q = params.p_level.numpy(), aux0["q"].numpy()
        for s in range(S):
            zs, ps, qs = f32(z[s]), f32(p[s]), f32(q[s])
            for t in range(y_new.shape[1]):
                yt, mt = f32(y_new[s, t]), f32(m_new[s, t])
                qn = f32(qs + mt)
                if (yt > eps) and (mt > 0):
                    zs = f32(a * yt + (one - a) * zs)
                    ps = f32(a * qn + (one - a) * ps)
                    qs = f32(0.0)
                else:
                    qs = qn
            out_z[s], out_p[s] = zs, ps
    return out_z, out_p


def _intermittent_columns(seed, k):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random((S, k)) < 0.4, rng.gamma(2.0, 3.0, (S, k)), 0.0)
    return (y.astype(np.float32),
            (rng.random((S, k)) > 0.1).astype(np.float32))


@pytest.mark.parametrize("variant", ["croston", "sba", "tsb"])
def test_croston_update_bitwise_vs_frozen_continuation(variant):
    cfg = croston.CrostonConfig(variant=variant)
    y, mask, day = _mk_series(seed=5, intermittent=True)
    k = 6
    y_new, m_new = _intermittent_columns(6, k)
    day_new = np.arange(day[-1] + 1, day[-1] + 1 + k, dtype=np.int32)
    params, aux = _fit("croston", cfg, y, mask, day)
    p2, _, _ = _update("croston", cfg, params, aux, y_new, m_new, day_new,
                       k_alloc=column_bucket(k))
    z_ref, p_ref = _croston_replay(y_new, m_new, params, cfg, aux)
    np.testing.assert_allclose(p2.z_level.numpy(), z_ref, rtol=1e-6)
    np.testing.assert_allclose(p2.p_level.numpy(), p_ref, rtol=1e-6)


def test_croston_init_aux_q_matches_fit_carry():
    """``init_update_aux``'s reversed running count equals the fit loop's
    interval count, replayed."""
    y, mask, day = _mk_series(seed=7, intermittent=True)
    params, aux = _fit("croston", croston.CrostonConfig(), y, mask, day)
    for s in range(S):
        q = 0.0
        for t in range(T0):
            q += mask[s, t]
            if y[s, t] > croston._EPS and mask[s, t] > 0:
                q = 0.0
        assert float(aux["q"][s]) == q


# ---------------------------------------------------------- chaining ------

CHAINED = [
    ("holt_winters", holt_winters.HoltWintersConfig(**HW_PINNED), False),
    ("theta", theta.ThetaConfig(), False),
    ("croston", croston.CrostonConfig(variant="sba"), True),
    ("croston", croston.CrostonConfig(variant="tsb"), True),
]


@pytest.mark.parametrize("model,cfg,intermittent", CHAINED)
def test_chained_dispatches_bitwise_equal_single(model, cfg, intermittent):
    y, mask, day = _mk_series(seed=8, intermittent=intermittent)
    k1, k2 = 3, 5
    _, _, _, y_new, m_new, day_new = _extend(y, mask, day, k1 + k2, seed=9)
    params, aux = _fit(model, cfg, y, mask, day)
    pa, auxa, pr_a = _update(model, cfg, params, aux, y_new[:, :k1],
                             m_new[:, :k1], day_new[:k1])
    pb, auxb, pr_b = _update(model, cfg, pa, auxa, y_new[:, k1:],
                             m_new[:, k1:], day_new[k1:])
    pc, auxc, pr_c = _update(model, cfg, params, aux, y_new, m_new, day_new)
    for f in dataclasses.fields(pb):
        _equal(getattr(pb, f.name), getattr(pc, f.name), f"{model} {f.name}")
    for key in auxb:
        _equal(auxb[key], auxc[key], f"{model} aux {key}")
    _equal(torch.cat([pr_a, pr_b], dim=1), pr_c, f"{model} preds")


@pytest.mark.parametrize("model,cfg,intermittent", CHAINED[1:])
def test_padding_leaves_the_carry_unchanged(model, cfg, intermittent):
    """Theta and croston with padding columns (valid 0), between and after
    the real ones, equal the update of the real columns alone."""
    y, mask, day = _mk_series(seed=10, intermittent=intermittent)
    _, _, _, y_new, m_new, day_new = _extend(y, mask, day, 3, seed=11)
    params, aux = _fit(model, cfg, y, mask, day)
    a = _update(model, cfg, params, aux, y_new, m_new, day_new)
    b = _update(model, cfg, params, aux, y_new, m_new, day_new, k_alloc=8)
    for f in dataclasses.fields(a[0]):
        _equal(getattr(a[0], f.name), getattr(b[0], f.name), f.name)
    for key in a[1]:
        _equal(a[1][key], b[1][key], key)
    _equal(a[2], b[2][:, :3], "preds")


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="update_state"):
        apply_update("curve", None, None, None, torch.zeros((1, 1)),
                     torch.zeros((1, 1)), np.ones(1), np.zeros(1, np.int32))


def test_column_bucket_ladder():
    assert [column_bucket(k) for k in (1, 2, 3, 4, 5, 9)] == \
        [1, 2, 4, 4, 8, 16]
    assert [column_bucket(k) for k in range(1, 40)] == \
        [jupdate.column_bucket(k) for k in range(1, 40)]
    with pytest.raises(ValueError):
        column_bucket(0)


# ----------------------------------------------------- against the ref ----

PARITY = [
    ("holt_winters", {}, False, 1e-5),
    ("holt_winters", {"seasonality_mode": "multiplicative"}, False, 1e-5),
    ("holt_winters", {"damped": True}, False, 1e-5),
    ("theta", {}, False, 2.4e-6),
    ("croston", {"variant": "croston"}, True, 2.4e-6),
    ("croston", {"variant": "sba"}, True, 2.4e-6),
    ("croston", {"variant": "tsb"}, True, 2.4e-6),
]


@pytest.mark.parametrize("model,conf,intermittent,tol", PARITY,
                         ids=[f"{m}-{c.get('variant', c.get('seasonality_mode', 'damped' if c else 'default'))}"
                              for m, c, _, _ in PARITY])
def test_update_matches_the_reference(model, conf, intermittent, tol):
    """The reference fits; both packages update from the reference's params
    and carries over the same 13 columns, 3 of them gap days (mask 0)
    and 3 padding columns."""
    jfns = jbase.get_model(model)
    jcfg = jfns.config_cls(**conf)
    tfns = get_model(model)
    tcfg = tfns.config_cls(**{**conf, **({"filter": "scan"}
                                         if model == "holt_winters" else {})})
    y, mask, day = _mk_series(seed=12, t=120, intermittent=intermittent)
    k, k_alloc = 13, 16
    y_new, m_new = (_intermittent_columns(13, k) if intermittent
                    else _mk_series(seed=13, t=k)[:2])
    m_new[:, 4:7] = 0.0
    day_new = np.arange(day[-1] + 1, day[-1] + 1 + k, dtype=np.int32)
    jp = jfns.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day), jcfg)
    jaux = jfns.init_update_aux(jp, y=jnp.asarray(y), mask=jnp.asarray(mask))
    tp = convert.params_from_numpy(
        type(tfns.fit(_t(y[:1]), _t(mask[:1]), _t(day), tcfg)),
        {f.name: np.asarray(getattr(jp, f.name))
         for f in dataclasses.fields(jp)}, "cpu")
    taux = convert.update_aux_from_numpy(
        {key: np.asarray(v) for key, v in jaux.items()}, "cpu")
    # the carries seeded by each package agree: counts exactly
    own = tfns.init_update_aux(tp, y=_t(y), mask=_t(mask))
    for key in own:
        np.testing.assert_allclose(own[key].numpy(), taux[key].numpy(),
                                   rtol=0 if key in ("n_obs", "q") else 1e-6)
    pad = ((0, 0), (0, k_alloc - k))
    valid = np.r_[np.ones(k), np.zeros(k_alloc - k)].astype(np.float32)
    days = np.r_[day_new, np.zeros(k_alloc - k, np.int32)].astype(np.int32)
    jp2, jaux2, jpreds = jupdate.apply_update(
        model, jcfg, jp, {key: jnp.array(v) for key, v in jaux.items()},
        jnp.asarray(np.pad(y_new, pad)), jnp.asarray(np.pad(m_new, pad)),
        jnp.asarray(valid), jnp.asarray(days))
    tp2, taux2, tpreds = apply_update(
        model, tcfg, tp, taux, _t(np.pad(y_new, pad)), _t(np.pad(m_new, pad)),
        valid, days)
    scale = np.maximum(np.abs(y).max(1), 1.0)
    for f in dataclasses.fields(tp2):
        if f.name in ("fitted", "sigma"):
            continue
        got = getattr(tp2, f.name).numpy()
        want = np.asarray(getattr(jp2, f.name))
        rows = scale.reshape((-1,) + (1,) * (got.ndim - 1)) if got.ndim \
            else scale.max()
        assert np.all(np.abs(got - want) <= tol * rows), f.name
    np.testing.assert_allclose(tp2.sigma.numpy(), np.asarray(jp2.sigma),
                               rtol=1e-5)
    assert np.all(np.abs(tpreds.numpy()[:, :k] - np.asarray(jpreds)[:, :k])
                  <= tol * scale[:, None])
    np.testing.assert_array_equal(taux2["n_obs"].numpy(),
                                  np.asarray(jaux2["n_obs"]))
    if model == "croston":
        np.testing.assert_array_equal(taux2["q"].numpy(),
                                      np.asarray(jaux2["q"]))
