"""Port parity: the native host data plane (``data/native.py``, the CSV parse
in ``load_sales_csv`` and ``tensorize(backend='native')``) against the
port's pandas path and the JAX reference, on the CPU.

The cases mirror the reference's own check, ``tests/unit/test_native.py``,
at 3 stores x 4 items x 200 days with 10% of the rows dropped.  The native
tensorize is held bit for bit to the pandas one (y, mask, day, keys and
their dtypes, start date): both sum duplicates in float64 in row order and
round to float32 once.  Parsed sales are held within rtol 1e-12 of pandas'
(two decimal parsers; the reference's bound); the committed dataset's
whole-number sales parse exactly.

The loader never writes into ``native/``: a stale or missing committed
binary is compiled from the source into a build directory (here a
temporary one, from a temporary copy of ``native/``), and without a
compiler a stale binary is never loaded.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.data import dataset as jdataset
from distributed_forecasting_tpu.data import native as jnative
from distributed_forecasting_tpu_torch.data import dataset as tdataset
from distributed_forecasting_tpu_torch.data import native

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    df = tdataset.synthetic_store_item_sales(n_stores=3, n_items=4,
                                             n_days=200, seed=9,
                                             missing_rate=0.1)
    p = tmp_path_factory.mktemp("data") / "train.csv"
    df.to_csv(p, index=False, date_format="%Y-%m-%d")
    return str(p), df


def _assert_batches_bitwise(got, want):
    for k in ("y", "mask", "day"):
        a, b = getattr(got, k), getattr(want, k)
        a = a.numpy() if torch.is_tensor(a) else a
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.keys.dtype == np.asarray(want.keys).dtype
    np.testing.assert_array_equal(got.keys, np.asarray(want.keys))
    assert (got.start_date, got.freq, tuple(got.key_names)) == (
        want.start_date, want.freq, tuple(want.key_names))


def test_library_loads(csv_path):
    assert native.is_available()


def test_native_parse_matches_pandas_and_reference(csv_path):
    path, df = csv_path
    day, store, item, sales = native.parse_sales_csv(path)
    assert len(day) == len(df) and day.dtype == np.int32
    expected_day = (df["date"].values.astype("datetime64[D]")
                    - np.datetime64("1970-01-01", "D")).astype(np.int64)
    np.testing.assert_array_equal(day.astype(np.int64), expected_day)
    np.testing.assert_array_equal(store, df["store"].to_numpy())
    np.testing.assert_array_equal(item, df["item"].to_numpy())
    np.testing.assert_allclose(sales, df["sales"].to_numpy(), rtol=1e-12)
    for got, want in zip((day, store, item, sales),
                         jnative.parse_sales_csv(path)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dup", [False, True], ids=["rows", "duplicates"])
def test_native_tensorize_is_bitwise_the_pandas_path(csv_path, dup):
    _, df = csv_path
    if dup:  # duplicate (key, date) rows sum in float64, in row order
        df = pd.concat([df, df.iloc[::7].assign(sales=lambda d: d.sales / 3)],
                       ignore_index=True)
    nat = tdata.tensorize(df, backend="native", device="cpu")
    ref = tdata.tensorize(df, backend="pandas", device="cpu")
    _assert_batches_bitwise(nat, ref)
    _assert_batches_bitwise(nat, jdata.tensorize(df, backend="native"))
    _assert_batches_bitwise(nat, jdata.tensorize(df, backend="pandas"))
    _assert_batches_bitwise(tdata.tensorize(df, device="cpu"), ref)


def test_load_and_tensorize_csv_matches_reference(csv_path):
    path, df = csv_path
    got = native.load_and_tensorize_csv(path, device="cpu")
    _assert_batches_bitwise(got, jnative.load_and_tensorize_csv(path))
    _assert_batches_bitwise(got, tdata.tensorize(df, backend="pandas",
                                                      device="cpu"))


def test_native_duplicate_rows_summed(tmp_path):
    p = tmp_path / "dup.csv"
    p.write_text(
        "date,store,item,sales\n"
        "2020-01-01,1,1,2.5\n"
        "2020-01-01,1,1,3.5\n"
        "2020-01-02,1,1,7\n"
        "2020-01-02,2,1,1\n"
    )
    b = native.load_and_tensorize_csv(str(p), device="cpu")
    assert b.n_series == 2
    np.testing.assert_array_equal(b.y.numpy(), [[6.0, 7.0], [0.0, 1.0]])
    np.testing.assert_array_equal(b.mask.numpy()[1], [0.0, 1.0])


def test_native_no_header(tmp_path):
    p = tmp_path / "nohdr.csv"
    p.write_text("2021-03-05,7,9,1.25\n2021-03-06,7,9,2\n")
    day, store, item, sales = native.parse_sales_csv(str(p))
    assert len(day) == 2
    assert store[0] == 7 and item[0] == 9
    assert day[1] == day[0] + 1


def test_malformed_csv_raises(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("date,store,item,sales\nnot-a-date,xx\n")
    with pytest.raises(ValueError):
        native.parse_sales_csv(str(p))
    with pytest.raises(IOError):
        native.parse_sales_csv(str(tmp_path / "missing.csv"))


def test_tensorize_backend_flag(csv_path):
    _, df = csv_path
    df3 = df.assign(region=1)
    keys3 = ("region", "store", "item")
    b3 = tdata.tensorize(df3, key_cols=keys3, device="cpu")
    assert b3.keys.shape[1] == 3
    assert tdata.resolved_backend(n_keys=3) == "pandas"
    with pytest.raises(RuntimeError, match="2 key columns"):
        tdata.tensorize(df3, key_cols=keys3, backend="native",
                             device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tdata.tensorize(df, backend="arrow", device="cpu")
    with pytest.raises(ValueError, match="freq='D' only"):
        tdata.tensorize(df, backend="native", freq="W", device="cpu")
    # weekly grids take the numpy path under auto
    _assert_batches_bitwise(
        tdata.tensorize(df, freq="W", device="cpu"),
        jdata.tensorize(df, freq="W"))


@pytest.mark.parametrize("env", [None, "pandas", "native"])
@pytest.mark.parametrize("n_keys", [1, 2])
def test_resolved_backend_matches_reference(monkeypatch, env, n_keys):
    if env is None:
        monkeypatch.delenv("DFTPU_TENSORIZE_BACKEND", raising=False)
    else:
        monkeypatch.setenv("DFTPU_TENSORIZE_BACKEND", env)
    from distributed_forecasting_tpu.data.tensorize import (
        resolved_backend as jresolved,
    )

    def outcome(fn):
        try:
            return fn(n_keys=n_keys)
        except RuntimeError as e:
            return type(e)

    assert outcome(tdata.resolved_backend) == outcome(jresolved)
    assert tdata.resolved_backend(n_keys, backend="pandas") == "pandas"


def test_explicit_native_without_the_library_raises(monkeypatch, csv_path):
    _, df = csv_path
    monkeypatch.setattr(native, "is_available", lambda: False)
    monkeypatch.delenv("DFTPU_TENSORIZE_BACKEND", raising=False)
    assert tdata.resolved_backend() == "pandas"
    with pytest.raises(RuntimeError, match="unavailable"):
        tdata.tensorize(df, backend="native", device="cpu")
    # auto degrades to numpy, bit-identically
    _assert_batches_bitwise(
        tdata.tensorize(df, device="cpu"),
        tdata.tensorize(df, backend="pandas", device="cpu"))


@pytest.mark.parametrize("gz", [False, True], ids=["csv", "csv_gz"])
def test_load_sales_csv_routes_agree_with_reference(csv_path, tmp_path,
                                                    monkeypatch, gz):
    path, _ = csv_path
    if gz:
        import gzip

        gz_path = str(tmp_path / "train.csv.gz")
        with open(path, "rb") as src, gzip.open(gz_path, "wb") as dst:
            shutil.copyfileobj(src, dst)
        path = gz_path
    got = tdataset.load_sales_csv(path)
    pd.testing.assert_frame_equal(got, jdataset.load_sales_csv(path))
    monkeypatch.setattr(native, "is_available", lambda: False)
    pandas_route = tdataset.load_sales_csv(path)
    assert list(pandas_route.columns) == list(got.columns)
    # the same values; the date column's unit is each parser's own
    pd.testing.assert_frame_equal(pandas_route, got, check_dtype=False,
                                  check_exact=False, rtol=1e-12)


def test_load_sales_csv_reordered_header_falls_back(tmp_path):
    """The C parser is positional; a reordered header goes to pandas, which
    selects by name (the keys would otherwise parse swapped)."""
    p = tmp_path / "swapped.csv"
    p.write_text("date,item,store,sales\n2020-01-01,7,1,2.5\n"
                 "2020-01-02,7,1,3.5\n")
    df = tdataset.load_sales_csv(str(p))
    assert (df["store"] == 1).all() and (df["item"] == 7).all()
    p2 = tmp_path / "canon.csv"
    p2.write_text("date,store,item,sales\n2020-01-01,1,7,2.5\n"
                  "2020-01-02,1,7,3.5\n")
    df2 = tdataset.load_sales_csv(str(p2))
    assert (df2["store"] == 1).all() and (df2["item"] == 7).all()
    np.testing.assert_allclose(df2["sales"], [2.5, 3.5])
    # a row the native parser calls malformed sends the file to pandas
    p3 = tmp_path / "short_row.csv"
    p3.write_text("date,store,item,sales\n2020-01-01,1,7,2.5\n"
                  "2020-01-02,1,7\n")
    got = tdataset.load_sales_csv(str(p3))
    pd.testing.assert_frame_equal(got, jdataset.load_sales_csv(str(p3)))
    assert got["sales"].isna().tolist() == [False, True]


def _snapshot(directory):
    return {n: (os.path.getsize(os.path.join(directory, n)),
                open(os.path.join(directory, n), "rb").read())
            for n in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("native_build"))


@pytest.mark.parametrize("case", ["stale_sidecar", "missing_so",
                                  "missing_sidecar"])
def test_stale_or_missing_binary_builds_outside_native(tmp_path, build_dir,
                                                       csv_path, case):
    repo_native = os.path.join(ROOT, "native")
    before = _snapshot(repo_native)
    copy = str(tmp_path / "native")
    shutil.copytree(repo_native, copy)
    so = os.path.join(copy, "libdftpu_native.so")
    if case == "stale_sidecar":
        with open(so + ".src.sha256", "w") as f:
            f.write("0" * 64)
    elif case == "missing_so":
        os.remove(so)
    else:
        os.remove(so + ".src.sha256")
    copy_before = _snapshot(copy)

    lib = native._build_and_load(copy, build_dir)
    assert lib is not None
    built = [n for n in os.listdir(build_dir) if n.endswith(".so")]
    digest = native._digest(os.path.join(copy, "dftpu_native.cpp"))
    assert built == [f"libdftpu_native_{digest[:16]}.so"]
    assert os.path.realpath(lib._name).startswith(os.path.realpath(build_dir))
    assert _snapshot(copy) == copy_before
    assert _snapshot(repo_native) == before
    import ctypes

    n = ctypes.c_int64(0)
    assert lib.dftpu_csv_count(csv_path[0].encode(), ctypes.byref(n)) == 0
    assert n.value == len(csv_path[1])


def test_fresh_committed_binary_loads_in_place(tmp_path):
    copy = str(tmp_path / "native")
    shutil.copytree(os.path.join(ROOT, "native"), copy)
    build = str(tmp_path / "build")
    lib = native._build_and_load(copy, build)
    assert lib is not None
    assert lib._name == os.path.join(copy, "libdftpu_native.so")
    assert not os.path.exists(build)


def test_stale_binary_never_loads_without_a_compiler(tmp_path, monkeypatch):
    copy = str(tmp_path / "native")
    shutil.copytree(os.path.join(ROOT, "native"), copy)
    with open(os.path.join(copy, "libdftpu_native.so.src.sha256"), "w") as f:
        f.write("0" * 64)
    monkeypatch.setattr(native, "_CXX", ["dftpu-no-such-compiler"])
    assert native._build_and_load(copy, str(tmp_path / "build")) is None
    assert native._build_and_load(copy, None) is None
    assert not [n for n in os.listdir(tmp_path / "build") if n.endswith(".so")]
