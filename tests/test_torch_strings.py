"""Dictionary strings and nulls in the port against the JAX package.

The same values, made with numpy from a fixed seed, go through both packages'
`Column.from_values`, parquet readers (the encoded dictionary-page read and
the flatten read) and writer. Dictionaries, codes and validity masks must be
equal, and written files byte-identical. Tolerance 0.
"""

import hashlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from hyperspace_tpu.engine import io as jax_io
from hyperspace_tpu.engine.table import Column as JaxColumn
from hyperspace_tpu.engine.table import Table as JaxTable
from hyperspace_tpu.engine.table import align_dictionaries as jax_align
from hyperspace_tpu_torch.engine import io as torch_io
from hyperspace_tpu_torch.engine.table import Column, Table, align_dictionaries

SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"])


def assert_same_column(jc: JaxColumn, tc: Column):
    assert tc.dtype == jc.dtype
    np.testing.assert_array_equal(tc.data.cpu().numpy(), jc.data)
    if jc.dictionary is None:
        assert tc.dictionary is None
    else:
        np.testing.assert_array_equal(tc.dictionary, jc.dictionary)
        assert tc.dictionary.dtype.kind == jc.dictionary.dtype.kind
    if jc.validity is None:
        assert tc.validity is None
    else:
        np.testing.assert_array_equal(tc.validity.cpu().numpy(), jc.validity)


def assert_same_table(jt: JaxTable, tt: Table):
    assert tt.column_names == jt.column_names
    for n in jt.column_names:
        assert_same_column(jt.columns[n], tt.columns[n])


def _values(seed=5, n=600):
    rng = np.random.RandomState(seed)
    seg = SEGMENTS[rng.randint(0, 5, n)]
    names = np.array([f"Customer#{i:09d}" for i in rng.permutation(n)])
    nullable_seg = seg.astype(object)
    nullable_seg[rng.rand(n) < 0.2] = None
    ints = rng.randint(-50, 50, n).astype(object)
    ints[rng.rand(n) < 0.3] = None
    floats = rng.randn(n).astype(object)
    floats[::7] = None
    bools = (rng.rand(n) < 0.5).astype(object)
    bools[::5] = None
    return {
        "seg": seg, "name": names, "nseg": nullable_seg, "nint": ints, "nfloat": floats,
        "nbool": bools, "k": np.arange(n, dtype=np.int64),
    }


@pytest.mark.parametrize("name", sorted(_values()))
def test_from_values_matches(name):
    v = _values()[name]
    assert_same_column(JaxColumn.from_values(v), Column.from_values(v, "cpu"))


def test_all_null_and_empty_columns_match():
    for v in (np.array([None, None], dtype=object), np.array(["a", None, "a"], dtype=object),
              np.empty(0, dtype="<U1")):
        assert_same_column(JaxColumn.from_values(v), Column.from_values(v, "cpu"))


def test_decode_take_and_concat_match():
    vals = _values()
    jt = JaxTable.from_pydict({k: vals[k] for k in ("seg", "nseg", "nint")})
    tt = Table.from_pydict({k: vals[k] for k in ("seg", "nseg", "nint")}, "cpu")
    idx = np.random.RandomState(1).permutation(len(vals["k"]))[:200]
    assert_same_table(jt.take(idx), tt.take(torch.from_numpy(idx)))
    for n in ("seg", "nseg", "nint"):
        got = tt.columns[n].decode_objects()
        want = jt.columns[n].decode_objects()
        assert [None if x is None else str(x) for x in got] == [None if x is None else str(x) for x in want]
    # Concat over different dictionaries re-encodes over their union.
    parts_j = [JaxTable.from_pydict({"s": a}) for a in (SEGMENTS[:3], SEGMENTS[2:], np.array(["ZZ", None], object))]
    parts_t = [Table.from_pydict({"s": a}, "cpu") for a in (SEGMENTS[:3], SEGMENTS[2:], np.array(["ZZ", None], object))]
    assert_same_table(JaxTable.concat(parts_j), Table.concat(parts_t))


def test_align_dictionaries_matches():
    a = np.array(["b", "d", "a", "d"])
    b = np.array(["c", "d", "e"])
    ja, jb = jax_align(JaxColumn.from_values(a), JaxColumn.from_values(b))
    ta, tb = align_dictionaries(Column.from_values(a, "cpu"), Column.from_values(b, "cpu"))
    assert_same_column(ja, ta)
    assert_same_column(jb, tb)


def _write_sources(tmp_path, dictionary_pages: bool):
    """Three parquet files of string and nullable columns written by pyarrow,
    with or without dictionary pages; the files hold different value sets."""
    vals = _values(seed=9, n=900)
    paths = []
    for i, sl in enumerate((slice(0, 300), slice(300, 600), slice(600, 900))):
        at = pa.table({
            "seg": pa.array(vals["seg"][sl]),
            "name": pa.array(vals["name"][sl]),
            "nseg": pa.array(list(vals["nseg"][sl]), pa.string()),
            "nint": pa.array(list(vals["nint"][sl]), pa.int64()),
            "nfloat": pa.array(list(vals["nfloat"][sl]), pa.float64()),
            "k": pa.array(vals["k"][sl]),
        })
        if i == 2:  # a file whose nullable string column holds only nulls
            at = at.set_column(2, "nseg", pa.array([None] * 300, pa.string()))
        p = str(tmp_path / f"part-{i:05d}.parquet")
        pq.write_table(at, p, use_dictionary=dictionary_pages)
        paths.append(p)
    return paths


@pytest.mark.parametrize("encoded", ["1", "0"], ids=["encoded", "flatten"])
@pytest.mark.parametrize("dictionary_pages", [True, False], ids=["dict-pages", "plain-pages"])
def test_parquet_read_matches(tmp_path, monkeypatch, encoded, dictionary_pages):
    monkeypatch.setenv("HYPERSPACE_ENCODED_EXEC", encoded)
    paths = _write_sources(tmp_path, dictionary_pages)
    for files, cols in ((paths, None), (paths[:1], ["nseg", "k"]), (paths[2:], ["nseg", "seg"])):
        jt = jax_io.read_files(files, "parquet", cols)
        tt = torch_io.read_files(files, "parquet", cols, "cpu")
        assert_same_table(jt, tt)
    seg = torch_io.read_files(paths, "parquet", ["seg"], "cpu").columns["seg"]
    assert seg.encoded_read == (encoded == "1" and dictionary_pages)


@pytest.mark.parametrize("encoded", ["1", "0"], ids=["encoded", "flatten"])
def test_parquet_write_is_byte_identical(tmp_path, monkeypatch, encoded):
    monkeypatch.setenv("HYPERSPACE_ENCODED_EXEC", encoded)
    vals = _values(seed=11, n=700)
    data = {k: vals[k] for k in ("seg", "name", "nseg", "nint", "nfloat", "nbool", "k")}
    jt = JaxTable.from_pydict(data)
    tt = Table.from_pydict(data, "cpu")
    idx = np.arange(100, 400)  # a slice whose dictionaries compact on write
    jax_io.write_parquet(jt.take(idx), str(tmp_path / "j.parquet"), row_group_rows=128)
    torch_io.write_parquet(tt.take(torch.from_numpy(idx)), str(tmp_path / "t.parquet"), row_group_rows=128)
    digest = [hashlib.sha256(open(tmp_path / f, "rb").read()).hexdigest() for f in ("j.parquet", "t.parquet")]
    assert digest[0] == digest[1]
    # And each package reads the other's file back to the same columns.
    assert_same_table(jax_io.read_files([str(tmp_path / "t.parquet")], "parquet"),
                      torch_io.read_files([str(tmp_path / "j.parquet")], "parquet", None, "cpu"))


def test_schema_reads_strings(tmp_path):
    paths = _write_sources(tmp_path, True)
    assert torch_io.infer_schema(paths, "parquet").to_json_string() == jax_io.infer_schema(paths, "parquet").to_json_string()
