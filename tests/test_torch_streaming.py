"""The streamed scan aggregate in the port against the JAX package.

The `stream_aggregate` cases of `tests/test_streaming_query.py` run in both
packages over the same parquet files (six files of a seeded table with
string, nullable and bool columns): every aggregate function, string and
null group keys, a filter/with_column/project chain, empty and all-filtered
chunks, width promotion, chunk splitting, a single file staying one-pass,
count_distinct declining, `HYPERSPACE_QUERY_STREAMING=0`, the decode pool
knob, serial equal to threaded, a decoder fault that caches nothing, and a
Hive-partitioned multi-file source. The JAX package runs its device program
(`HYPERSPACE_FORCE_DEVICE_OPS=1`, `HYPERSPACE_DISTRIBUTED=0`).

Tolerance: the port's streamed rows equal the JAX package's streamed rows
exactly, in order and schema, float sums and averages included: both fold
each chunk's groups in key64 order and the chunks in file order, and the
port reproduces that order. The one exception is a sum of a computed float
column, rtol 1e-9: the JAX package's compiled expression fuses and
reassociates, so the column itself differs in the last bits
(`test_torch_aggregate`). Against the port's own one-pass answer
(`HYPERSPACE_QUERY_STREAMING=0`) integers, strings and group order are
exact and float sums and averages agree within 1e-9 relative (the JAX
package's `_rows_close`): chunked folding reorders the additions.

`test_streamed_float_sums_are_the_jax_packages` is the probe of the port's
old default: on 60,000 rows in 6 files the JAX device program streams and
gives group 15 a float sum of 75378.58070421377, where its one-pass path,
which the port used to run, gives 75378.58070421372.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from hyperspace_tpu.engine import io as jax_io
from hyperspace_tpu.telemetry.profiling import last_query_stages as jax_last_query_stages
from hyperspace_tpu_torch.engine import io as engine_io
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.engine.scan_cache import global_scan_cache
from hyperspace_tpu_torch.telemetry.profiling import last_query_stages
from test_torch_aggregate import assert_same
from test_torch_udf_setops import Twin

N_FILES = 6


@pytest.fixture(autouse=True)
def _reference_path(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_FORCE_DEVICE_OPS", "1")
    for flag in ("HYPERSPACE_QUERY_STREAMING", "HYPERSPACE_QUERY_CHUNK_ROWS", "HYPERSPACE_BUILD_DECODE_THREADS",
                 "HYPERSPACE_QUERY_PREFETCH_FILES"):
        monkeypatch.delenv(flag, raising=False)
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()


def _rows_close(a, b, tol=1e-9):
    assert len(a) == len(b), (len(a), len(b))
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert abs(x - y) <= tol * max(1.0, abs(x)), (ra, rb)
            else:
                assert x == y, (ra, rb)


def _write_files(twin, name, data, n_files):
    n = len(next(iter(data.values())))
    per = (n + n_files - 1) // n_files
    for i in range(n_files):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= n:
            break
        twin.write(name, {k: v[lo:hi] for k, v in data.items()}, f"part-{i:05d}.parquet")


@pytest.fixture()
def stream_twin(tmp_path):
    rng = np.random.RandomState(7)
    n = 6000
    grp = rng.randint(0, 40, n).astype(np.int64)
    sgrp = np.array([f"g{i:02d}" if i % 7 else None for i in grp], dtype=object)
    amount = rng.randint(-50, 50, n).astype(object)
    amount[::11] = None
    price = (rng.rand(n) * 100).astype(object)
    price[::13] = None
    tag = np.array([f"t{i % 17:02d}" for i in rng.randint(0, 999, n)], dtype=object)
    tag[::19] = None
    flag = rng.randint(0, 2, n).astype(bool)
    twin = Twin(tmp_path)
    _write_files(twin, "src", {"grp": grp, "sgrp": sgrp, "amount": amount, "price": price, "tag": tag,
                               "flag": flag}, N_FILES)
    return twin


ALL_AGGS = dict(
    rows=("*", "count"),
    n=("amount", "count"),
    s=("amount", "sum"),
    sp=("price", "sum"),
    a=("price", "avg"),
    lo=("amount", "min"),
    hi=("amount", "max"),
    tmin=("tag", "min"),
    tmax=("tag", "max"),
    fmin=("flag", "min"),
)


def _last(p):
    return (last_query_stages if p.name == "torch" else jax_last_query_stages)()


def _stats(d):
    return d["chunks"], d["rows"], d["groups"], d["stage_counts"].get("partial")


def on_off(twin, q, monkeypatch, computed=()):
    """Streamed in both packages (equal exactly, but for the `computed`
    float columns: the JAX package's compiled expressions fuse and
    reassociate, so a computed float differs in the last bits, rtol 1e-9 as
    in `test_torch_aggregate`) and the port one-pass: (streamed, one-pass,
    the port's stage summary or None)."""
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    before = twin.both(_last)
    streamed, want = twin.both(lambda p: q(p).collect())
    assert_same(streamed, want, computed)
    after = twin.both(_last)
    ran = [a is not None and a != b for a, b in zip(after, before)]
    assert ran[0] == ran[1]
    if ran[0]:
        assert _stats(after[0]) == _stats(after[1])
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    one_pass = q(twin.t).collect()
    return streamed, one_pass, after[0] if ran[0] else None


def test_every_agg_fn_multi_file(stream_twin, monkeypatch):
    def q(p):
        return p.read("src").group_by("grp").agg(**ALL_AGGS)

    streamed, one_pass, stages = on_off(stream_twin, q, monkeypatch)
    assert stages is not None and stages["chunks"] == N_FILES and stages["stage_counts"]["partial"] == N_FILES
    _rows_close(streamed.sorted_rows(), one_pass.sorted_rows())
    assert [r[0] for r in streamed.rows()] == [r[0] for r in one_pass.rows()]


def test_string_null_group_keys_and_multi_key(stream_twin, monkeypatch):
    def q(p):
        return p.read("src").group_by("sgrp", "flag").agg(n=("*", "count"), s=("amount", "sum"), t=("tag", "max"))

    streamed, one_pass, stages = on_off(stream_twin, q, monkeypatch)
    assert stages is not None
    assert streamed.rows() == one_pass.rows()


def test_filter_withcolumn_project_chain(stream_twin, monkeypatch):
    def q(p):
        c = p.col
        return (
            p.read("src")
            .filter((c("amount") > -20) & c("tag").is_not_null())
            .with_column("rev", c("price") * (1 - c("amount") / 100))
            .select("grp", "rev", "amount")
            .group_by("grp")
            .agg(r=("rev", "sum"), lo=("amount", "min"))
        )

    streamed, one_pass, stages = on_off(stream_twin, q, monkeypatch, computed=("r",))
    assert stages is not None
    _rows_close(streamed.sorted_rows(), one_pass.sorted_rows())


def test_empty_chunks_mid_stream(stream_twin, monkeypatch):
    """A filter that empties whole files leaves empty chunks mid-stream."""
    def q(p):
        return p.read("src").filter(p.col("amount") == 17).group_by("grp").agg(n=("*", "count"), s=("amount", "sum"))

    streamed, one_pass, stages = on_off(stream_twin, q, monkeypatch)
    assert stages is not None
    assert streamed.rows() == one_pass.rows()


def test_all_rows_filtered_empty_result(stream_twin, monkeypatch):
    def q(p):
        return (p.read("src").filter(p.col("amount") == 10_000).group_by("grp")
                .agg(n=("*", "count"), s=("amount", "sum"), t=("tag", "min")))

    streamed, one_pass, _ = on_off(stream_twin, q, monkeypatch)
    assert streamed.num_rows == 0 == one_pass.num_rows
    assert streamed.schema.to_json_string() == one_pass.schema.to_json_string()


def test_mixed_width_promotion_with_filtered_file(tmp_path, monkeypatch):
    """A wider file whose rows are all filtered out still promotes the
    result's type, also for the all-filtered empty result."""
    twin = Twin(tmp_path)
    src = os.path.join(twin.base, "mixed")
    os.makedirs(src)
    pq.write_table(pa.table({"g": pa.array([1, 2, 1], type=pa.int64()), "x": pa.array([5, 6, 7], type=pa.int32()),
                             "keep": pa.array([1, 1, 1], type=pa.int64())}), os.path.join(src, "part-00000.parquet"))
    pq.write_table(pa.table({"g": pa.array([2, 3], type=pa.int64()), "x": pa.array([8, 9], type=pa.int64()),
                             "keep": pa.array([0, 0], type=pa.int64())}), os.path.join(src, "part-00001.parquet"))

    def q(keep):
        return lambda p: p.read("mixed").filter(p.col("keep") == keep).group_by("g").agg(hi=("x", "max"),
                                                                                         sx=("x", "sum"))

    streamed, one_pass, stages = on_off(twin, q(1), monkeypatch)
    assert stages is not None
    assert streamed.rows() == one_pass.rows()
    assert streamed.schema.to_json_string() == one_pass.schema.to_json_string()
    streamed_e, one_pass_e, _ = on_off(twin, q(7), monkeypatch)
    assert streamed_e.num_rows == 0 == one_pass_e.num_rows
    assert streamed_e.schema.to_json_string() == one_pass_e.schema.to_json_string()


def test_chunk_rows_splitting(stream_twin, monkeypatch):
    """Sub-file chunks (`HYPERSPACE_QUERY_CHUNK_ROWS`) change no answer."""
    def q(p):
        return p.read("src").group_by("grp").agg(**ALL_AGGS)

    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    monkeypatch.setenv("HYPERSPACE_QUERY_CHUNK_ROWS", "137")
    chunked = stream_twin.same(q)
    ts, js = stream_twin.both(_last)
    assert ts["chunks"] > N_FILES and ts["chunks"] == js["chunks"]
    monkeypatch.delenv("HYPERSPACE_QUERY_CHUNK_ROWS")
    whole = q(stream_twin.t).collect()
    assert last_query_stages()["chunks"] == N_FILES
    _rows_close(chunked.sorted_rows(), whole.sorted_rows())


def test_single_file_source_stays_one_pass(tmp_path, monkeypatch):
    twin = Twin(tmp_path)
    twin.write("one", {"g": np.array([1, 2, 1]), "x": np.array([1.0, 2.0, 3.0])})
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    before = last_query_stages()
    got = twin.same(lambda p: p.read("one").group_by("g").agg(s=("x", "sum")))
    assert got.sorted_rows() == [(1, 4.0), (2, 2.0)]
    assert last_query_stages() == before


def test_count_distinct_falls_back(stream_twin, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    before = last_query_stages()

    def q(p):
        return p.read("src").group_by("grp").agg(d=("tag", "count_distinct"), n=("*", "count"))

    got = stream_twin.same(q)
    assert last_query_stages() == before
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    assert got.rows() == q(stream_twin.t).collect().rows()


def test_env_zero_disables(stream_twin, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    before = last_query_stages()
    stream_twin.same(lambda p: p.read("src").group_by("grp").agg(n=("*", "count")))
    assert last_query_stages() == before


def test_decode_pool_size_honors_the_shared_knob(monkeypatch):
    for n, knob in ((40, None), (3, None), (40, "1"), (40, "4"), (2, "4")):
        if knob is None:
            monkeypatch.delenv("HYPERSPACE_BUILD_DECODE_THREADS", raising=False)
        else:
            monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", knob)
        assert engine_io.decode_pool_size(n) == jax_io.decode_pool_size(n)
    monkeypatch.delenv("HYPERSPACE_BUILD_DECODE_THREADS")
    assert engine_io.decode_pool_size(40) == 16
    for depth in (None, "3"):
        if depth is not None:
            monkeypatch.setenv("HYPERSPACE_QUERY_PREFETCH_FILES", depth)
        assert engine_io.prefetch_depth() == jax_io.prefetch_depth()


def test_streaming_serial_threads_equivalent(stream_twin, monkeypatch):
    """Serial and pooled decodes give the same fold, floats included."""
    def q(p):
        return p.read("src").group_by("grp").agg(**ALL_AGGS)

    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    serial = q(stream_twin.t).collect()
    scan_cache.clear_scan_caches()
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "3")
    monkeypatch.setenv("HYPERSPACE_QUERY_PREFETCH_FILES", "2")
    pooled = q(stream_twin.t).collect()
    assert serial.rows() == pooled.rows()
    assert_same(pooled, q(stream_twin.j).collect())


def test_decoder_fault_fails_clean_no_poisoned_cache(stream_twin, monkeypatch):
    twin = stream_twin
    src = os.path.join(twin.base, "src")
    victim = os.path.join(src, sorted(os.listdir(src))[3])
    real = engine_io._read_arrow

    def boom(path, *args, **kwargs):
        if path == victim:
            raise RuntimeError("injected decode fault")
        return real(path, *args, **kwargs)

    def q(p):
        return p.read("src").group_by("grp").agg(n=("*", "count"), s=("amount", "sum"))

    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    monkeypatch.setattr(engine_io, "_read_arrow", boom)
    with pytest.raises(RuntimeError, match="injected decode fault"):
        q(twin.t).collect()
    assert global_scan_cache().missing_columns(victim, ["grp", "amount"]) != []
    monkeypatch.setattr(engine_io, "_read_arrow", real)
    streamed = twin.same(q)
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    assert streamed.rows() == q(twin.t).collect().rows()


def test_partitioned_multi_file_source(tmp_path, monkeypatch):
    """A Hive-partitioned source streams file by file with its partition
    columns, a filter on one pruning nothing it should not."""
    twin = Twin(tmp_path)
    rng = np.random.RandomState(5)
    for day in (3, 1, 2):
        for region in ("east", "west"):
            n = 500 + 100 * day
            twin.write(f"events/day={day}/region={region}",
                       {"k": rng.randint(0, 30, n).astype(np.int64), "x": rng.rand(n) * 10,
                        "q": rng.randint(0, 9, n).astype(np.int64)})

    def q(p):
        c = p.col
        return (p.read("events").filter(c("q") > 2).group_by("region", "day")
                .agg(n=("*", "count"), sx=("x", "sum"), mq=("q", "max")))

    streamed, one_pass, stages = on_off(twin, q, monkeypatch)
    assert stages is not None and stages["chunks"] == 6
    _rows_close(streamed.sorted_rows(), one_pass.sorted_rows())
    assert [r[:2] for r in streamed.rows()] == [r[:2] for r in one_pass.rows()]


def test_streamed_float_sums_are_the_jax_packages(tmp_path, monkeypatch):
    """The default-answer probe: the streamed float sum of group 15."""
    twin = Twin(tmp_path)
    rng = np.random.RandomState(11)
    n = 60_000
    data = {"g": rng.randint(0, 40, n).astype(np.int64), "p": rng.rand(n) * 100,
            "v": rng.randint(0, 1000, n).astype(np.int64)}
    _write_files(twin, "src", data, 6)

    def q(p):
        return p.read("src").group_by("g").agg(sp=("p", "sum"), ap=("p", "avg"), sv=("v", "sum"))

    streamed, one_pass, stages = on_off(twin, q, monkeypatch)
    assert stages is not None and stages["chunks"] == 6
    assert [r[0] for r in streamed.rows()] == [r[0] for r in one_pass.rows()]
    assert [r[3] for r in streamed.rows()] == [r[3] for r in one_pass.rows()]
    _rows_close(streamed.rows(), one_pass.rows())
    by_group = {r[0]: r for r in streamed.rows()}
    assert by_group[15][1] == 75378.58070421377 and {r[0]: r for r in one_pass.rows()}[15][1] == 75378.58070421372


def test_a_lone_partial_with_a_null_key_keeps_its_groups(tmp_path, monkeypatch):
    """A null group key hashes as its fill value 0, so null and 0 rows
    interleave in a chunk's key64 sort and the chunk's partial repeats both
    keys. With the other file filtered away that partial is the stream's
    only one: the JAX package keeps it as it is (six rows of three keys
    here, one of them its padding's empty group), the port merges it by
    records and equals the one-pass answer (ROADMAP.md Queue 3)."""
    twin = Twin(tmp_path)
    twin.write("src", {"g": np.array([0, None, 0, None, 1], dtype=object), "v": np.arange(5),
                       "keep": np.ones(5, np.int64)}, "part-00000.parquet")
    twin.write("src", {"g": np.array([2, 3], dtype=object), "v": np.arange(2), "keep": np.zeros(2, np.int64)},
               "part-00001.parquet")

    def q(p):
        return p.read("src").filter(p.col("keep") == 1).group_by("g").agg(n=("*", "count"), s=("v", "sum"))

    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "1")
    streamed, jax_streamed = twin.both(lambda p: q(p).collect().rows())
    assert last_query_stages()["chunks"] == 2
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    one_pass = q(twin.t).collect().rows()
    assert sorted(streamed, key=str) == sorted(one_pass, key=str) == [(0, 2, 2), (1, 1, 4), (None, 2, 4)]
    assert len(jax_streamed) == 6 and {r[0] for r in jax_streamed} == {0, 1, None}


def _row_reprs(rows):
    """Rows as sorted reprs of Python values: a NaN key never equals another
    NaN in a list."""
    return sorted(repr(tuple(x.item() if hasattr(x, "item") else x for x in r)) for r in rows)


def test_nan_float_group_keys_stream_no_phantom_groups(tmp_path, monkeypatch):
    """ROADMAP Queue 3's scan probe: 400 rows of `g` drawn from
    [NaN, 1.5, 2.0] by `RandomState(5)`, rows 0 and 200 (each file's first)
    NaN, 2 files of 200 rows. Each NaN key is a group of its own. The
    port's streamed answer equals both packages' one-pass answers
    (`HYPERSPACE_QUERY_STREAMING=0`). The JAX device program pads each chunk
    to a power of two by repeating its first row, and a first key of NaN
    makes each pad row a phantom group of count 0; the port folds real rows
    only."""
    twin = Twin(tmp_path)
    rng = np.random.RandomState(5)
    g = rng.choice(np.array([np.nan, 1.5, 2.0]), 400)
    g[0] = g[200] = np.nan
    data = {"g": g, "v": rng.randint(0, 100, 400).astype(np.int64)}
    _write_files(twin, "src", data, 2)

    def q(p):
        return p.read("src").group_by("g").agg(c=("*", "count"), s=("v", "sum"))

    streamed, jax_streamed = twin.both(lambda p: q(p).collect().rows())
    assert last_query_stages()["chunks"] == 2
    monkeypatch.setenv("HYPERSPACE_QUERY_STREAMING", "0")
    one_pass, jax_one_pass = twin.both(lambda p: q(p).collect().rows())
    n_nan = int(np.isnan(g).sum())
    assert len(streamed) == n_nan + 2
    assert _row_reprs(streamed) == _row_reprs(one_pass) == _row_reprs(jax_one_pass)
    assert all(r[1] > 0 for r in streamed)
    phantoms = [r for r in jax_streamed if r[1] == 0]
    assert phantoms and len(jax_streamed) == len(streamed) + len(phantoms)
    assert _row_reprs(r for r in jax_streamed if r[1] > 0) == _row_reprs(streamed)
