"""Port parity: the precision gate (``ops/precision.py``) and the bf16
candidate scoring it switches on in the Holt-Winters fit, against the JAX
reference on the CPU.

Tolerances and why:
- bf16 scores (``filter='scan'``): within 2^-7 relative of the
  reference's.  Both run the filter on bf16 tensors, but torch rounds each
  elementwise op to bf16 while XLA's CPU backend may keep intermediates of
  a fused step wider; measured 3.8e-3 here, one bf16 ulp (2^-8 = 3.9e-3).
- bf16 scores (``filter='pscan'``): within 1e-5 relative.  In both
  packages only the inputs are bf16: the affine maps come out float32 by
  type promotion (float32 slot one-hots), so the scan runs in float32
  (measured 1.3e-6).
- Winners: equal on every row whose two best reference bf16 scores lie
  further apart than twice the score tolerance (a closer pair may swap
  under one rounding); the refit is float32 in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.models import holt_winters as jh
from distributed_forecasting_tpu.ops import precision as jprec
from distributed_forecasting_tpu_torch.models import holt_winters as th
from distributed_forecasting_tpu_torch.ops import precision as tprec

torch.set_num_threads(1)

S, T, M = 8, 200, 7
SCORE_RTOL = {"scan": 2.0 ** -7, "pscan": 1e-5}


@pytest.fixture(autouse=True)
def _ungated():
    """The gate is process-wide in both packages, and the reference's jit
    caches do not key on it: every test starts and ends ungated, with the
    reference's traces dropped."""
    jprec.configure_precision(jprec.PrecisionConfig())
    tprec.configure_precision(tprec.PrecisionConfig())
    jax.clear_caches()
    yield
    jprec.configure_precision(jprec.PrecisionConfig())
    tprec.configure_precision(tprec.PrecisionConfig())
    jax.clear_caches()


def _series(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    y = (50 + 0.05 * t[None]
         + 8 * np.sin(2 * np.pi * t / M + rng.uniform(0, 6, (S, 1)))
         + 2 * rng.normal(size=(S, T))).astype(np.float32)
    mask = (rng.random((S, T)) > 0.05).astype(np.float32)
    return y * mask, mask, np.arange(18_000, 18_000 + T, dtype=np.int32)


def _gate(on: bool):
    jprec.configure_precision(jprec.PrecisionConfig(bf16_scoring=on))
    tprec.configure_precision(tprec.PrecisionConfig(bf16_scoring=on))
    jax.clear_caches()


def _port_scores(y, mask, filt, dtype):
    """The port's scoring pass as ``fit`` runs it, in ``dtype``."""
    A, B, G, P = (x.to(dtype) for x in th._candidate_grid(
        th.HoltWintersConfig()))
    yt, mt = torch.from_numpy(y).to(dtype), torch.from_numpy(mask).to(dtype)
    if filt == "scan":
        _, msec, _ = th._filter(yt, mt, A[None], B[None], G[None], M,
                                "additive", P[None], keep_path=False)
    else:
        msec = torch.stack([th.parallel_filter(yt, mt, A[c], B[c], G[c], M,
                                               P[c])[1]
                            for c in range(A.shape[0])], dim=1)
    return msec.to(torch.float32).numpy()


def _reference_scores(y, mask, filt):
    """The reference's gated scoring (``holt_winters.fit``'s
    ``per_series``), vmapped over series and candidates in bf16."""
    A, B, G, P = jh._candidate_grid(jh.HoltWintersConfig())
    sd = jnp.bfloat16
    one = (jh._filter if filt == "scan" else jh.parallel_filter)

    def per_series(ys, ms):
        def score(a, b, g, p):
            if filt == "scan":
                out = one(ys.astype(sd), ms.astype(sd), a.astype(sd),
                          b.astype(sd), g.astype(sd), M, "additive",
                          p.astype(sd))
            else:
                out = one(ys.astype(sd), ms.astype(sd), a.astype(sd),
                          b.astype(sd), g.astype(sd), M, p.astype(sd))
            return out[1].astype(jnp.float32)
        return jax.vmap(score)(A, B, G, P)

    return np.asarray(jax.jit(jax.vmap(per_series))(jnp.asarray(y),
                                                     jnp.asarray(mask)))


def _separated(scores, rtol):
    """Rows whose two best scores are further apart than 2 * rtol."""
    best2 = np.sort(scores, axis=1)[:, :2]
    return (best2[:, 1] - best2[:, 0]) > 2 * rtol * np.abs(best2[:, 0])


def test_from_conf_and_its_errors_match_reference():
    for conf in (None, {}, {"bf16_scoring": True}, {"bf16_scoring": 0},
                 {"bf16_scoring": None}):
        got = tprec.PrecisionConfig.from_conf(conf)
        want = jprec.PrecisionConfig.from_conf(conf)
        assert got.bf16_scoring == want.bf16_scoring
    for bad in ({"bf16": True}, {"bf16_scoring": True, "fp8": True}):
        with pytest.raises(ValueError) as want:
            jprec.PrecisionConfig.from_conf(bad)
        with pytest.raises(ValueError) as got:
            tprec.PrecisionConfig.from_conf(bad)
        assert str(got.value) == str(want.value)


def test_configure_and_fingerprint_round_trip():
    assert tprec.scoring_dtype() is None
    assert tprec.fingerprint_extra() is None is jprec.fingerprint_extra()
    _gate(True)
    assert tprec.get_precision().bf16_scoring
    assert tprec.scoring_dtype() is torch.bfloat16
    assert jprec.scoring_dtype() == jnp.bfloat16
    assert tprec.fingerprint_extra() == jprec.fingerprint_extra() == {
        "bf16_scoring": True}


@pytest.mark.parametrize("filt", ["scan", "pscan"])
def test_bf16_scores_match_reference(filt):
    y, mask, _ = _series()
    got = _port_scores(y, mask, filt, torch.bfloat16)
    want = _reference_scores(y, mask, filt)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL[filt])
    f32 = _port_scores(y, mask, filt, torch.float32)
    assert not np.array_equal(got, f32)  # the gate did change the scores


@pytest.mark.parametrize("filt", ["scan", "pscan", "auto"])
def test_gated_fit_matches_reference(filt):
    """``fit`` under the gate in both packages (``auto`` is ``scan`` on the
    CPU in both): the winners on separated rows, and the float32 refit."""
    y, mask, day = _series(seed=1)
    _gate(True)
    jp = jh.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                jh.HoltWintersConfig(filter=filt))
    tp = th.fit(torch.from_numpy(y), torch.from_numpy(mask),
                torch.from_numpy(day), th.HoltWintersConfig(filter=filt))
    route = "pscan" if filt == "pscan" else "scan"
    ref = _reference_scores(y, mask, route)
    rows = _separated(ref, SCORE_RTOL[route])
    assert rows.sum() >= S // 2
    for f in ("alpha", "beta", "gamma", "phi"):
        np.testing.assert_allclose(getattr(tp, f).numpy()[rows],
                                   np.asarray(getattr(jp, f))[rows],
                                   rtol=1e-6, err_msg=f)
    # the refit is float32 in both, and is the float32 filter of the winner
    for f in ("level", "trend", "season", "sigma", "fitted"):
        assert getattr(tp, f).dtype == torch.float32
        assert np.asarray(getattr(jp, f)).dtype == np.float32
    (l, b, s), mse, fitted = th._filter(
        torch.from_numpy(y), torch.from_numpy(mask), tp.alpha, tp.beta,
        tp.gamma, M, "additive", tp.phi)
    assert torch.equal(tp.fitted, fitted) and torch.equal(tp.level, l)
    np.testing.assert_allclose(tp.fitted.numpy()[rows],
                               np.asarray(jp.fitted)[rows], rtol=1e-4,
                               atol=1e-3)


def test_gate_off_leaves_the_fit_unchanged():
    """Armed then disarmed, the fit is bitwise today's; the kernel route
    (``filter='pallas'``, the card's ``auto``) ignores the gate, as the
    reference's Pallas route does."""
    y, mask, day = (torch.from_numpy(a) for a in _series(seed=2))
    fits = {}
    for filt in ("scan", "pallas"):
        cfg = th.HoltWintersConfig(filter=filt)
        before = fits[filt] = th.fit(y, mask, day, cfg)
        _gate(True)
        gated = th.fit(y, mask, day, cfg)
        _gate(False)
        after = th.fit(y, mask, day, cfg)
        for f in ("alpha", "beta", "gamma", "phi", "level", "fitted"):
            assert torch.equal(getattr(before, f), getattr(after, f)), f
            if filt == "pallas":
                assert torch.equal(getattr(before, f), getattr(gated, f)), f
    want = _port_scores(*_series(seed=2)[:2], "scan", torch.float32)
    np.testing.assert_array_equal(fits["scan"].alpha.numpy(), th._candidate_grid(
        th.HoltWintersConfig())[0].numpy()[want.argmin(axis=1)])
