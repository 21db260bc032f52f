"""The port's failpoint registry (``monitoring/failpoints.py``) and its
sites.

Parity with the reference, exact: every spec of the reference's own tests
parses to the same armed state in both packages (or both refuse it with
the same message), and one spec and seed fires at the same evaluations.
Then the registry's behaviour as the reference's tests hold it (actions,
count / prob modifiers, data sites, both activation routes, a child
process arming at import), and every site the port carries fires where
the reference's does: ``wal.read`` and ``store.append``
(``monitoring/store.py``), ``wal.roll`` and ``wal.append.enospc``
(``serving/ingest.py``), ``state.swap`` and ``refit.install``
(``engine/state_store.py``), ``refit.submit`` (``serving/refit.py``),
``wal.shard.append`` (``serving/sharding.py``) and ``aot.load`` /
``aot.store`` / ``aot.load.payload`` (``engine/compile_cache.py``).
``fleet.forward`` is held in ``tests/test_torch_fleet.py``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.monitoring import failpoints as jfp
from distributed_forecasting_tpu_torch.monitoring import failpoints as fp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_registry():
    fp.deactivate()
    jfp.deactivate()
    yield
    fp.deactivate()
    jfp.deactivate()


def _armed(mod) -> dict:
    with mod._lock:
        return {name: (a.action, a.arg, a.prob, a.count)
                for name, a in mod._armed.items()}


# -- parity with the reference ------------------------------------------------

SPECS = [
    "a.b=raise; c.d=sleep 5:0.5:3",
    "a.b=raise\nc.d=sleep 1",
    "wal.append.enospc=raise OSError:0.01",
    "fleet.forward=raise:0.1",
    "aot.load.payload=corrupt",
    "aot.load.payload=corrupt truncate",
    "state.swap=sleep 250:0.5:3",
    "wal.append.enospc=kill9",
    "a.b=raise:1x",
    "a.b=raise:1.0",
    "a.b=raise OSError:2",
    "",
    # refused, with the reference's messages
    "noequals",
    "a.b=",
    "a.b=explode",
    "a.b=raise NoSuchExc",
    "a.b=raise OSError:1.5",
    "a.b=raise OSError:0",
    "a.b=sleep",
    "a.b=corrupt sideways",
]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parser_matches_the_reference(spec):
    def parse(mod):
        try:
            return mod.configure(spec, seed=3), _armed(mod), mod.is_active()
        except ValueError as e:
            return "ValueError", str(e), mod.is_active()
    assert parse(fp) == parse(jfp)


def _firings(mod, spec, seed, names=("a.b", "c.d"), evals=300):
    mod.configure(spec, seed=seed)
    out = []
    for i in range(evals):
        name = names[i % len(names)]
        try:
            got = mod.failpoint_data(name, bytes(range(8)))
            out.append((name, got.hex()))
        except Exception as e:  # noqa: BLE001 — the firing is the record
            out.append((name, type(e).__name__))
    return out, mod.snapshot()


@pytest.mark.parametrize("spec,seed", [
    ("a.b=raise:0.3", 42),
    ("a.b=raise OSError:0.5:7; c.d=corrupt:0.25", 7),
    ("a.b=corrupt truncate:0.6; c.d=raise KeyError:0.1:5x", 0),
])
def test_firings_for_a_spec_and_seed_match_the_reference(spec, seed):
    assert _firings(fp, spec, seed) == _firings(jfp, spec, seed)


# -- the registry --------------------------------------------------------------

def test_configure_counts_sites_and_is_active():
    assert fp.configure("a.b=raise; c.d=sleep 5:0.5:3") == 2
    assert fp.is_active() and fp.is_active("a.b") and fp.is_active("c.d")
    assert not fp.is_active("nope")
    assert fp.configure("") == 0 and not fp.is_active()


def test_bad_spec_leaves_the_registry_disarmed():
    with pytest.raises(ValueError):
        fp.configure("a.b=explode")
    assert not fp.is_active()


def test_actions_raise_sleep_and_the_unarmed_site():
    fp.configure("a.b=raise")
    with pytest.raises(fp.FailpointError, match="a.b"):
        fp.failpoint("a.b")
    fp.failpoint("other.site")
    assert fp.fired("other.site") == 0
    fp.configure("a.b=raise OSError")
    with pytest.raises(OSError):
        fp.failpoint("a.b")
    fp.configure("a.b=sleep 30")
    t0 = time.monotonic()
    fp.failpoint("a.b")
    assert time.monotonic() - t0 >= 0.025


def test_disabled_sites_have_no_side_effects():
    fp.failpoint("a.b")
    assert fp.failpoint_data("a.b", b"payload") == b"payload"
    assert fp.snapshot() == {}


def test_count_caps_then_disarms_and_prob_one_always_fires():
    fp.configure("a.b=raise OSError:2")
    for _ in range(2):
        with pytest.raises(OSError):
            fp.failpoint("a.b")
    fp.failpoint("a.b")
    assert fp.fired("a.b") == 2
    fp.configure("a.b=raise:1.0")
    for _ in range(3):
        with pytest.raises(fp.FailpointError):
            fp.failpoint("a.b")
    assert fp.snapshot() == {"a.b": 3}


def test_data_sites_flip_truncate_and_pass_through():
    fp.configure("a.b=corrupt")
    data = bytes(range(16))
    out = fp.failpoint_data("a.b", data)
    assert [i for i, (x, y) in enumerate(zip(data, out)) if x != y] == [8]
    assert fp.failpoint_data("a.b", b"") == b""
    fp.failpoint("a.b")  # corrupt at a plain site: ignored, counted
    fp.configure("a.b=corrupt truncate")
    assert 0 < len(fp.failpoint_data("a.b", b"x" * 64)) < 64
    fp.configure("a.b=raise OSError")
    with pytest.raises(OSError):
        fp.failpoint_data("a.b", b"payload")


def test_configure_from_env_fires_as_configure_does(monkeypatch):
    monkeypatch.setenv("DFTPU_FAILPOINTS", "a.b=raise:0.3")
    monkeypatch.setenv("DFTPU_FAILPOINTS_SEED", "7")
    assert fp.configure_from_env() == 1
    pattern = []
    for _ in range(50):
        try:
            fp.failpoint("a.b")
            pattern.append(0)
        except fp.FailpointError:
            pattern.append(1)
    fp.configure("a.b=raise:0.3", seed=7)
    again = []
    for _ in range(50):
        try:
            fp.failpoint("a.b")
            again.append(0)
        except fp.FailpointError:
            again.append(1)
    assert pattern == again and 0 < sum(pattern) < 50
    # an empty variable leaves an in-process configure alone
    fp.configure("a.b=raise")
    monkeypatch.delenv("DFTPU_FAILPOINTS")
    assert fp.configure_from_env() == 0 and fp.is_active("a.b")


def test_a_child_process_arms_at_import():
    code = (
        "from distributed_forecasting_tpu_torch.monitoring import "
        "failpoints as fp\n"
        "assert fp.is_active('a.b')\n"
        "try:\n"
        "    fp.failpoint('a.b')\n"
        "except OSError:\n"
        "    print('FIRED')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, timeout=60,
        env={**os.environ, "PYTHONPATH": ROOT,
             "DFTPU_FAILPOINTS": "a.b=raise OSError"})
    assert proc.returncode == 0, proc.stderr
    assert "FIRED" in proc.stdout


# -- the sites ----------------------------------------------------------------

def test_store_sites_fire(tmp_path):
    from distributed_forecasting_tpu_torch.monitoring import store

    ts = store.TimeSeriesStore(str(tmp_path / "qs"))
    fp.configure("store.append=raise OSError:1")
    point = {"ts": 1.0, "name": "m", "value": 1.0}
    with pytest.raises(OSError):
        ts.append([point])
    assert ts.append([point]) == 1
    fp.configure("wal.read=raise OSError")
    with pytest.raises(OSError):
        store.read_segments_from(str(tmp_path / "qs"))
    assert fp.fired("wal.read") == 1


def test_wal_sites_compensate_the_cursor(tmp_path):
    from distributed_forecasting_tpu_torch.serving.ingest import WriteAheadLog

    wal = WriteAheadLog(str(tmp_path / "wal"), max_segment_bytes=64)
    wal.append([{"i": 0, "fill": "x" * 80}])  # fills segment 0
    fp.configure("wal.roll=raise OSError:1")
    with pytest.raises(OSError):
        wal.append([{"i": 1}])  # rolls to segment 1, then fails
    assert fp.fired("wal.roll") == 1
    assert wal._seg_bytes == 0  # nothing reached segment 1
    fp.configure("wal.append.enospc=raise OSError:1")
    with pytest.raises(OSError):
        wal.append([{"i": 2}])
    wal.append([{"i": 3}])
    records, _ = WriteAheadLog(str(tmp_path / "wal")).read_new()
    assert [r["i"] for r in records] == [0, 3]


def _hw_store(S=4, T=60, device="cpu"):
    from distributed_forecasting_tpu_torch.engine.state_store import (
        SeriesStateStore,
    )
    from distributed_forecasting_tpu_torch.models.base import get_model
    from distributed_forecasting_tpu_torch.serving.predictor import (
        BatchForecaster,
    )

    rng = np.random.default_rng(0)
    y = (10 + rng.normal(size=(S, T))).astype(np.float32)
    mask = np.ones((S, T), np.float32)
    day = np.arange(T, dtype=np.int64) + 700_000
    fns = get_model("holt_winters")
    cfg = fns.config_cls()
    params = fns.fit(torch.as_tensor(y), torch.as_tensor(mask),
                     torch.as_tensor(day), cfg)
    fc = BatchForecaster(model="holt_winters", config=cfg, params=params,
                         keys=np.arange(S).reshape(S, 1),
                         key_names=("item",), day0=int(day[0]),
                         day1=int(day[-1]))
    return SeriesStateStore(fc, history_y=y, history_mask=mask,
                            device=device), fc


def test_state_store_and_refit_sites_leave_the_last_good_state():
    from distributed_forecasting_tpu_torch.serving.refit import (
        RefitConfig,
        RefitScheduler,
    )

    st, fc = _hw_store()
    gen0, day_cur = fc.state_generation(), st.day_cur
    fp.configure("state.swap=raise:1")
    st.ingest([(0, day_cur + 1, 11.0)])
    with pytest.raises(fp.FailpointError):
        st.apply_pending()
    assert fc.state_generation() == gen0  # serving never saw the update
    sched = RefitScheduler(st, RefitConfig(enabled=True))
    fp.configure("refit.submit=raise:1")
    with pytest.raises(fp.FailpointError):
        sched.maybe_refit(force=True)
    assert sched._submitting is False  # the claim was released
    params_before = fc._state_snapshot()[0]
    fp.configure("refit.install=raise:1")
    # on the CPU the refit's stages run inline in the submit
    with pytest.raises(fp.FailpointError):
        sched.maybe_refit(force=True)
    assert fp.fired("refit.install") == 1
    assert fc._state_snapshot()[0] is params_before
    assert fc.state_generation() == gen0
    with pytest.raises(fp.FailpointError):
        sched.stop()  # the executor re-raises its first stage error


def test_sharded_wal_site_fails_one_shard_leg(tmp_path):
    from distributed_forecasting_tpu_torch.serving.sharding import (
        ShardedWAL,
        shard_of_key,
    )

    wal = ShardedWAL(str(tmp_path / "wal"), owned_shards=range(4),
                     num_shards=4)
    keys = [[1, k] for k in range(12)]
    shards = sorted({shard_of_key(k, 4) for k in keys})
    assert len(shards) > 1
    fp.configure("wal.shard.append=raise OSError:1")
    with pytest.raises(OSError):
        wal.append([{"k": k, "d": 1, "y": 1.0} for k in keys])
    assert wal.read_new()[0] == []  # the first shard's leg failed first
    wal.append([{"k": k, "d": 2, "y": 1.0} for k in keys])
    assert len(wal.read_new()[0]) == len(keys)
