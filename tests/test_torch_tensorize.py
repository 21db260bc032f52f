"""Port parity: tensorize and the dataset loaders against the JAX reference.

The same long frames go through both packages' ``tensorize``; the batches
must be exactly equal — values accumulate in float64 on the host and round
once to float32 in both, so no tolerance applies.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata

torch.set_num_threads(1)

CSV = os.path.join(os.path.dirname(__file__), "..", "datasets",
                   "store_item_demand.csv.gz")


def _assert_batches_equal(jb, tb):
    np.testing.assert_array_equal(np.asarray(jb.y), tb.y.numpy())
    np.testing.assert_array_equal(np.asarray(jb.mask), tb.mask.numpy())
    np.testing.assert_array_equal(np.asarray(jb.day), tb.day.numpy())
    np.testing.assert_array_equal(np.asarray(jb.keys), tb.keys)
    assert tb.y.dtype == tb.mask.dtype == torch.float32
    assert tb.day.dtype == torch.int32
    assert (jb.key_names, jb.start_date, jb.freq) == (
        tb.key_names, tb.start_date, tb.freq)
    assert list(jb.dates()) == list(tb.dates())


@pytest.mark.parametrize("freq", ["D", "W"])
def test_tensorize_synthetic_with_gaps_matches_reference(freq):
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=4, n_days=150,
                                          seed=3, missing_rate=0.1)
    df_ref = jdata.synthetic_store_item_sales(n_stores=2, n_items=4,
                                              n_days=150, seed=3,
                                              missing_rate=0.1)
    # the generator is a copy: same seed, same frame
    assert df.equals(df_ref)
    tb = tdata.tensorize(df, freq=freq, device="cpu")
    if freq == "D":
        assert float(tb.mask.mean()) < 1.0  # the gaps are there
    _assert_batches_equal(jdata.tensorize(df_ref, freq=freq), tb)


def test_tensorize_committed_csv_subset_matches_reference():
    df = tdata.load_sales_csv(CSV)
    df_ref = jdata.load_sales_csv(CSV)
    assert len(df) == len(df_ref) == 913_000
    pick = lambda d: d[(d["store"] == 3) & (d["item"] <= 20)]  # noqa: E731
    tb = tdata.tensorize(pick(df), device="cpu")
    assert tb.y.shape == (20, 1826)
    _assert_batches_equal(jdata.tensorize(pick(df_ref)), tb)


def test_synthetic_series_batch_matches_reference():
    tb = tdata.synthetic_series_batch(n_stores=2, n_items=3, n_days=60,
                                      seed=5, device="cpu")
    _assert_batches_equal(
        jdata.synthetic_series_batch(n_stores=2, n_items=3, n_days=60, seed=5),
        tb,
    )


def test_pad_and_take_series_match_reference():
    df = tdata.synthetic_store_item_sales(n_stores=1, n_items=5, n_days=40,
                                          seed=2)
    tb = tdata.tensorize(df, device="cpu")
    jb = jdata.tensorize(df)
    _assert_batches_equal(jb.pad_series_to(8), tb.pad_series_to(8))
    _assert_batches_equal(jb.take_series([4, 0, 2]), tb.take_series([4, 0, 2]))
    with pytest.raises(ValueError, match="cannot pad"):
        tb.pad_series_to(2)


@pytest.mark.parametrize("freq", ["D", "W", "M"])
def test_ordinals_round_trip_matches_reference(freq):
    # the packages re-export the function tensorize over the module's name
    jt = importlib.import_module("distributed_forecasting_tpu.data.tensorize")
    tt = importlib.import_module("distributed_forecasting_tpu_torch.data.tensorize")

    dates = np.array(["2013-01-01", "2014-02-28", "2016-02-29", "2017-12-31"],
                     dtype="datetime64[D]")
    ords = tt.period_ordinals(dates, freq)
    np.testing.assert_array_equal(ords, jt.period_ordinals(dates, freq))
    assert list(tt.ordinals_to_dates(ords, freq)) == list(
        jt.ordinals_to_dates(ords, freq))
