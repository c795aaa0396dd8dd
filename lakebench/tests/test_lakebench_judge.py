"""The comparison that decides `correct`, on hand-made answers."""

import types

import numpy as np

from lakebench import judge

REF = types.SimpleNamespace(
    COLUMNS=["k", "v", "d"], LIMIT=3, ORDER=[("v", "desc"), ("d", "asc")], IDENT=["k"], EXACT=["d"], MEASURES=["v"])


def want():
    return {"k": np.array([1, 2, 3, 4, 5]), "v": np.array([9.0, 8.0, 7.0, 7.0, 1.0]), "d": np.array([1, 1, 2, 2, 3])}


def got(keys, scale=1.0):
    w = want()
    at = {k: i for i, k in enumerate(w["k"].tolist())}
    idx = np.array([at[k] for k in keys])
    return {"k": w["k"][idx], "v": w["v"][idx] * scale, "d": w["d"][idx]}


def test_the_same_rows_pass_with_no_error():
    assert judge.compare(got([1, 2, 3]), want(), REF) == (False, 0.0, "")


def test_a_tie_across_the_last_row_may_bring_either_member():
    assert not judge.compare(got([1, 2, 4]), want(), REF)[0]


def test_a_row_outside_the_top_is_wrong():
    assert judge.compare(got([1, 2, 5]), want(), REF)[0]


def test_rows_out_of_order_are_wrong():
    assert judge.compare(got([2, 1, 3]), want(), REF)[0]


def test_missing_rows_and_columns_are_wrong():
    assert judge.compare(got([1, 2]), want(), REF)[0]
    g = got([1, 2, 3])
    del g["d"]
    assert judge.compare(g, want(), REF)[0]


def test_an_exact_column_that_differs_is_wrong():
    g = got([1, 2, 3])
    g["d"] = g["d"] + 1
    assert judge.compare(g, want(), REF)[0]


def test_a_measure_off_by_a_share_reads_that_share():
    wrong, err, _ = judge.compare(got([1, 2, 3], 1 + 1e-7), want(), REF)
    assert not wrong and abs(err - 1e-7) < 1e-12


def test_top_keeps_a_tie_that_runs_across_the_limit():
    out = judge.top(want(), REF, np.arange(5))
    assert out["k"].tolist() == [1, 2, 3, 4]


def test_group_sum_in_float32_accumulates_in_float32():
    v = np.full(10_000, 0.1)
    inv = np.zeros(10_000, np.int64)
    exact = judge.group_sum(inv, v, 1, np.float64)[0]
    low = judge.group_sum(inv, v, 1, np.float32)[0]
    assert low.dtype == np.float32 and abs(low - exact) / exact > 1e-6
    assert judge.group_sum(inv, np.arange(10_000), 1, np.int64)[0] == 49_995_000
