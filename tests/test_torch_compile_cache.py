"""The port's compile cache (``engine/compile_cache.py``): the kernel
library's persistent store, its key, and ``aot_call``.

The key's static part (``_canon``, ``_shape_signature``) equals the
reference's for the same numpy trees (a torch tensor writes its dtype as
numpy's), and ``CompileCacheConfig`` refuses what the reference refuses,
with its messages.  The store is exercised with a stub builder — ``g++``
compiling a one-function shared library — because this host has no
``nvcc``: a cold store builds and stores, a fresh store over the same
directory (a fresh process) loads without building, a truncated or
corrupt entry is discarded, labelled ``error`` and rebuilt, a changed
source is a new key, concurrent writers never tear an entry for readers in
other threads and processes, and the LRU sweep drops the oldest entries.
Every test puts the process-wide configuration back.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.engine import compile_cache as jcc
from distributed_forecasting_tpu_torch.engine import compile_cache as cc
from distributed_forecasting_tpu_torch.ops import _build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def reset_cache():
    """Tear the process-wide store down after the test."""
    try:
        yield
    finally:
        cc.configure_compile_cache(cc.CompileCacheConfig(enabled=False))


def stub_builder(tmp_path, version: int, calls: list):
    """A builder standing in for nvcc: compiles a shared library whose
    ``version()`` returns ``version`` and returns its path."""
    def build():
        calls.append(version)
        out = tmp_path / f"build-{len(calls)}"
        out.mkdir()
        src = out / "lib.cpp"
        src.write_text('extern "C" int version(void) { return %d; }\n'
                       % version)
        lib = out / "libstub.so"
        subprocess.run(["g++", "-shared", "-fPIC", "-O0", "-o", str(lib),
                        str(src)], check=True, capture_output=True,
                       timeout=120)
        return str(lib)
    return build


def _outcomes(entry: str) -> dict:
    return {label.split("outcome=")[1]: v
            for label, v in cc._entry_requests.snapshot().items()
            if label.startswith(f"entry={entry},")}


# -- the key against the reference --------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Cfg:
    order: tuple = (2, 1, 1)
    scale: float = 0.5
    names: frozenset = frozenset({"b", "a"})
    extra: dict = dataclasses.field(default_factory=lambda: {"k": [1, 2]})


STATICS = [
    {"scale": 3.0, "horizon": 90, "mode": "additive", "flag": True},
    {"cuts": (730, 1090, 1450), "none": None, "nested": {"z": 1, "a": [2]}},
    {"config": _Cfg(), "set": {3, 1, 2}},
    {"odd": np.float32(1.5)},
]


@pytest.mark.parametrize("statics", STATICS, ids=["plain", "nested",
                                                  "dataclass", "numpy"])
def test_canon_equals_the_reference(statics):
    assert cc._canon(statics) == jcc._canon(statics)


def _trees():
    a = np.zeros((3, 5), np.float32)
    b = np.ones((7,), np.int32)
    return [
        (a,),
        (a, b),
        ((a, b), {"xreg": None}),
        ((a,), {"y": a, "mask": b, "xreg": None}),
        [a, (b, None), {"k": [a]}],
        None,
        {"only": a},
        (),
    ]


@pytest.mark.parametrize("i", range(len(_trees())))
def test_shape_signature_equals_the_reference(i):
    tree = _trees()[i]
    assert cc._shape_signature(tree) == jcc._shape_signature(tree)


def test_shape_signature_of_tensors_writes_numpy_dtypes():
    a = np.zeros((3, 5), np.float32)
    b = np.ones((7,), np.int32)
    tree = ((a, b), {"xreg": None})
    ttree = ((torch.as_tensor(a), torch.as_tensor(b)), {"xreg": None})
    assert cc._shape_signature(ttree) == jcc._shape_signature(tree)


def test_key_changes_with_every_part():
    x = torch.ones(8)
    base = cc.fingerprint("toy", statics={"scale": 3.0}, tree=(x,),
                          backend={"torch": "2"})
    assert base == cc.fingerprint("toy", statics={"scale": 3.0}, tree=(x,),
                                  backend={"torch": "2"})
    for other in (
        cc.fingerprint("toy", statics={"scale": 4.0}, tree=(x,),
                       backend={"torch": "2"}),
        cc.fingerprint("toy", statics={"scale": 3.0},
                       tree=(torch.ones(16),), backend={"torch": "2"}),
        cc.fingerprint("toy", statics={"scale": 3.0},
                       tree=(torch.ones(8, dtype=torch.int32),),
                       backend={"torch": "2"}),
        cc.fingerprint("toy", statics={"scale": 3.0},
                       tree=((x,), {"y": None}), backend={"torch": "2"}),
        cc.fingerprint("other", statics={"scale": 3.0}, tree=(x,),
                       backend={"torch": "2"}),
        cc.fingerprint("toy", statics={"scale": 3.0}, tree=(x,),
                       backend={"torch": "3"}),
        cc.fingerprint("toy", statics={"scale": 3.0}, tree=(x,),
                       backend={"torch": "2"}, extra={"bf16_scoring": True}),
    ):
        assert other != base
    # an empty extra leaves the key as it was
    assert base == cc.fingerprint("toy", statics={"scale": 3.0}, tree=(x,),
                                  backend={"torch": "2"}, extra=None)


@pytest.mark.parametrize("conf", [
    {"max_sizemb": 64}, {"eviction_policy": "fifo"}, {"max_size_mb": 0},
    {"min_compile_time_s": -1.0},
], ids=["key", "policy", "size", "threshold"])
def test_config_refuses_what_the_reference_refuses(conf):
    with pytest.raises(ValueError) as want:
        jcc.CompileCacheConfig.from_conf(conf)
    with pytest.raises(ValueError) as got:
        cc.CompileCacheConfig.from_conf(conf)
    assert str(got.value) == str(want.value)


def test_config_parses_as_the_reference(tmp_path):
    conf = {"enabled": True, "max_size_mb": 64, "eviction_policy": "none",
            "aot_store": False, "min_compile_time_s": 2.5}
    for c in (None, {}, conf, {"enabled": True, "directory": "/x/y"}):
        got = cc.CompileCacheConfig.from_conf(c, default_root=str(tmp_path))
        want = jcc.CompileCacheConfig.from_conf(c, default_root=str(tmp_path))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- the store, with a stub builder --------------------------------------------

def test_cold_store_builds_then_a_fresh_store_loads_without_building(
        tmp_path):
    directory = str(tmp_path / "kernels")
    calls = []
    s0 = cc.cache_stats()
    lib = cc.AOTStore(directory).get_or_compile(
        "k" * 32, "kernel_library", stub_builder(tmp_path, 7, calls))
    assert lib.version() == 7 and calls == [7]
    s1 = cc.cache_stats()
    assert s1["misses"] == s0["misses"] + 1
    assert s1["stores"] == s0["stores"] + 1
    entries = [n for n in os.listdir(directory) if n.endswith(".aot")]
    assert entries == ["kernel_library-" + "k" * 32 + ".aot"]
    # a fresh store over the same directory is a fresh process: a hit from
    # disk, no build
    warm = cc.AOTStore(directory)
    lib2 = warm.get_or_compile("k" * 32, "kernel_library",
                               stub_builder(tmp_path, 8, calls))
    assert lib2.version() == 7 and calls == [7]
    s2 = cc.cache_stats()
    assert s2["hits"] == s1["hits"] + 1 and s2["misses"] == s1["misses"]
    # the in-process memo serves the next call
    assert warm.get_or_compile("k" * 32, "kernel_library", None) is lib2
    with open(os.path.join(directory, entries[0]), "rb") as f:
        head = json.loads(f.readline())
    assert head["entry"] == "kernel_library" and head["size"] > 0
    assert head["meta"]["build_seconds"] >= 0


@pytest.mark.parametrize("damage", ["truncate", "flip", "header"])
def test_damaged_entry_is_rebuilt_and_labelled_error(tmp_path, damage):
    directory = str(tmp_path / "kernels")
    calls = []
    key = "d" * 32
    cc.AOTStore(directory).get_or_compile(
        key, "kernel_library", stub_builder(tmp_path, 3, calls))
    (name,) = [n for n in os.listdir(directory) if n.endswith(".aot")]
    path = os.path.join(directory, name)
    with open(path, "rb") as f:
        blob = f.read()
    head_len = blob.index(b"\n") + 1
    if damage == "truncate":
        blob = blob[:head_len + (len(blob) - head_len) // 2]
    elif damage == "flip":
        mid = head_len + (len(blob) - head_len) // 2
        blob = blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:]
    else:
        blob = b"not json\n" + blob[head_len:]
    with open(path, "wb") as f:
        f.write(blob)
    before = _outcomes("kernel_library").get("error", 0.0)
    s0 = cc.cache_stats()
    lib = cc.AOTStore(directory).get_or_compile(
        key, "kernel_library", stub_builder(tmp_path, 4, calls))
    assert lib.version() == 4 and calls == [3, 4]
    s1 = cc.cache_stats()
    assert s1["errors"] == s0["errors"] + 1
    assert s1["misses"] == s0["misses"] + 1
    assert _outcomes("kernel_library")["error"] == before + 1
    # the rebuilt entry is whole again: the next fresh store hits
    assert cc.AOTStore(directory).get_or_compile(
        key, "kernel_library", None).version() == 4


def test_min_compile_time_keeps_fast_builds_out_of_the_store(tmp_path):
    directory = str(tmp_path / "kernels")
    calls = []
    lib = cc.AOTStore(directory).get_or_compile(
        "f" * 32, "kernel_library", stub_builder(tmp_path, 5, calls),
        min_compile_time_s=3600.0)
    assert lib.version() == 5
    assert not [n for n in os.listdir(directory) if n.endswith(".aot")]


def test_lru_eviction_order(tmp_path):
    store = cc.AOTStore(str(tmp_path / "k"), max_size_mb=1,
                        eviction_policy="lru")
    old = os.path.join(store.directory, "old-aaaa.aot")
    new = os.path.join(store.directory, "new-bbbb.aot")
    for path in (old, new):
        with open(path, "wb") as f:
            f.write(b"x" * 512)
    past = os.path.getmtime(new) - 1000
    os.utime(old, (past, past))
    store.max_size_bytes = 512  # force the sweep without MB-scale payloads
    assert store.evict() == 1
    assert not os.path.exists(old) and os.path.exists(new)
    store2 = cc.AOTStore(str(tmp_path / "k2"), max_size_mb=1,
                         eviction_policy="none")
    with open(os.path.join(store2.directory, "a-cccc.aot"), "wb") as f:
        f.write(b"x" * 512)
    store2.max_size_bytes = 1
    assert store2.evict() == 0


READER = """
import sys, time
from distributed_forecasting_tpu_torch.engine.compile_cache import AOTStore
directory, key, want, seconds = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])
want = open(want, "rb").read()
seen, end = 0, time.monotonic() + seconds
while time.monotonic() < end:
    got = AOTStore(directory).read(key)
    if got is not None:
        assert got == want, "torn entry"
        seen += 1
print(seen)
"""


def test_concurrent_writers_never_tear_the_store(tmp_path):
    """Writers racing ``store`` on one key while readers — threads here,
    and two fresh processes booting against the same directory — read it:
    each read sees no entry or a whole one (atomic rename)."""
    directory = str(tmp_path / "kernels")
    writer_store = cc.AOTStore(directory)
    payload = os.urandom(256 * 1024)
    want = tmp_path / "want.bin"
    want.write_bytes(payload)
    key = "cafe" * 8
    s0 = cc.cache_stats()
    stop = threading.Event()
    failures = []

    def writer():
        while not stop.is_set():
            if not writer_store.store(key, payload, entry="kernel_library"):
                failures.append("store() returned False")

    def reader():
        while not stop.is_set():
            try:
                got = cc.AOTStore(directory).read(key)
            except ValueError as e:
                failures.append(repr(e))
                continue
            if got is not None and got != payload:
                failures.append("torn entry")

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", READER, directory, key, str(want), "3"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    threads = [threading.Thread(target=writer) for _ in range(3)]
    threads += [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    outs = [p.communicate(timeout=120) for p in procs]
    stop.set()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:3]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert int(out.strip()) > 0  # each process read whole entries
    assert cc.cache_stats()["errors"] == s0["errors"]
    files = os.listdir(directory)
    assert [f for f in files if f.endswith(".aot")], files
    assert not [f for f in files if f.endswith(".tmp")], "temp files leaked"


# -- the kernel library through the configured store -----------------------------

@pytest.fixture
def stub_library(tmp_path, monkeypatch, reset_cache):
    """``ops/_build`` with a copy of the sources, a stub in place of the
    nvcc build and a fixed card and toolchain; no library loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    calls = []
    version = {"n": 1}

    def build(name, sources, build_directory=None):
        calls.append((name, tuple(sources)))
        return stub_builder(tmp_path, version["n"], [None] * len(calls))()

    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "nvcc_version", lambda: "nvcc 12.9")
    monkeypatch.setattr(_build, "device_identity",
                        lambda: {"device": "H100", "capability": [9, 0]})
    monkeypatch.setattr(_build, "_LIBRARY", None)
    return {"csrc": csrc, "calls": calls, "version": version}


def test_library_loads_through_the_store_and_a_changed_source_rebuilds(
        tmp_path, stub_library):
    store = cc.configure_compile_cache(cc.CompileCacheConfig(
        enabled=True, directory=str(tmp_path / "cc")))
    assert store.directory == str(tmp_path / "cc" / "kernels")
    assert _build._open().version() == 1
    assert len(stub_library["calls"]) == 1
    name, sources = stub_library["calls"][0]
    assert sources == tuple(_build.SOURCES)
    # a fresh process over the same store: loads, no build
    cc.configure_compile_cache(cc.CompileCacheConfig(
        enabled=True, directory=str(tmp_path / "cc")))
    assert _build._open().version() == 1
    assert len(stub_library["calls"]) == 1
    # one source changed: a new key, a rebuild, two entries
    src = stub_library["csrc"] / _build.SOURCES[-1]
    src.write_text(src.read_text() + "\n// changed\n")
    stub_library["version"]["n"] = 2
    cc.configure_compile_cache(cc.CompileCacheConfig(
        enabled=True, directory=str(tmp_path / "cc")))
    assert _build._open().version() == 2
    assert len(stub_library["calls"]) == 2
    assert stub_library["calls"][1][0] != name  # the key names the build
    assert len([n for n in os.listdir(store.directory)
                if n.endswith(".aot")]) == 2


def test_library_key_covers_sources_flags_toolchain_and_card(stub_library,
                                                             monkeypatch):
    backend = _build.library_backend()
    assert set(backend["sources"]) == set(_build.SOURCES)
    assert backend["flags"] == list(_build.CUDA_FLAGS)
    assert backend["nvcc"] == "nvcc 12.9"
    assert backend["torch"] == torch.__version__
    assert backend["device"] == "H100" and backend["capability"] == [9, 0]
    base = cc.fingerprint("kernel_library", backend=backend)
    monkeypatch.setattr(_build, "CUDA_FLAGS", _build.CUDA_FLAGS + ["-G"])
    assert cc.fingerprint("kernel_library",
                          backend=_build.library_backend()) != base


def test_configure_after_the_library_loaded_says_so(tmp_path, monkeypatch,
                                                    reset_cache):
    import logging

    monkeypatch.setattr(_build, "_LIBRARY", object())
    late = cc.cache_stats()["late"]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("compile_cache").addHandler(handler)
    try:
        got = cc.configure_compile_cache(cc.CompileCacheConfig(
            enabled=True, directory=str(tmp_path / "cc")))
    finally:
        logging.getLogger("compile_cache").removeHandler(handler)
    assert got is None and cc.get_store() is None
    assert cc.cache_stats()["late"] == late + 1
    assert any("already loaded" in r.getMessage() for r in records)


def test_disabled_config_tears_the_store_down(tmp_path, monkeypatch,
                                              reset_cache):
    monkeypatch.setattr(_build, "_LIBRARY", None)
    cfg = cc.CompileCacheConfig(enabled=True, directory=str(tmp_path / "cc"))
    assert cc.configure_compile_cache(cfg) is cc.get_store()
    assert cc.get_config() == cfg
    assert cc.configure_compile_cache(cc.CompileCacheConfig()) is None
    assert cc.get_store() is None and cc.get_config() is None


def test_aot_call_runs_the_function_and_charges_the_dispatch(monkeypatch):
    from distributed_forecasting_tpu_torch.monitoring import cost, trace

    monkeypatch.setattr(cost, "_cost_metrics", None)
    trace.configure_tracing(trace.TraceConfig(enabled=True, ring_size=16))
    try:
        def fn(x, y=None, *, scale):
            return x * scale + (0 if y is None else y)

        x = torch.arange(4.0)
        got = cc.aot_call("toy:theta", fn, args=(x,),
                          static_kwargs={"scale": 3.0},
                          dynamic_kwargs={"y": None})
        assert torch.equal(got, x * 3.0)
        label = "entry=toy:theta,family=theta"
        cm = cost.cost_metrics()
        assert cm.dispatches_total.snapshot()[label] == 1.0
        assert cm.device_seconds_total.snapshot()[label] >= 0.0
        (span,) = trace.get_tracer().recorder.snapshot()
        assert span.name == "aot.call"
        assert span.attrs == {"entry": "toy:theta", "outcome": "eager"}
    finally:
        trace.configure_tracing(trace.TraceConfig())
