"""Index builds of the port against the JAX package's, from the same files.

Source tables are made with numpy from a fixed seed and written once, by the
port's parquet writer; both packages index them. The JAX package is pinned to
its single-device serial build (`HYPERSPACE_DISTRIBUTED=0`,
`HYPERSPACE_BUILD_DECODE_THREADS=1`, byte-identical to its other routes by its
own contract). The port must write the same bucket files holding the same rows
in the same order, and a log entry equal apart from ids, timestamps and the
index files' paths and times.
"""

import glob
import hashlib
import json
import os

import numpy as np
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu import IndexConfig as JaxIndexConfig
from hyperspace_tpu import IndexConstants as JaxIndexConstants
from hyperspace_tpu.engine import HyperspaceSession as JaxSession
from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace
from hyperspace_tpu.index.log_entry import LogEntry as JaxLogEntry
from hyperspace_tpu_torch.engine.table import Table

NUM_BUCKETS = 16

INDEXES = [
    ("t", "byKey", ["k"], ["v", "w"]),
    ("t", "byPair", ["k2", "k"], ["v"]),
    ("t", "byFloat", ["v"], ["k"]),
    ("t", "byNarrow", ["n32"], ["w"]),
]


def _source(seed=3, n=20000):
    rng = np.random.RandomState(seed)
    v = np.round(rng.randn(n) * 100, 1)
    v[:4] = [0.0, -0.0, 0.0, -0.0]  # signed zeros bucket and sort as one value
    return {
        "k": rng.randint(0, 3000, n).astype(np.int64),
        "k2": rng.randint(-5, 5, n).astype(np.int64),
        "n32": rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32),
        "v": v,
        "w": rng.rand(n),
    }


@pytest.fixture()
def built(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    src = tmp_path / "src"
    hst.engine.io.write_parquet(Table.from_pydict(_source(), "cpu"), str(src / "t" / "part-00000.parquet"))
    ts = hst.HyperspaceSession(warehouse=str(tmp_path / "torch"), device="cpu")
    ts.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    js = JaxSession(warehouse=str(tmp_path / "jax"))
    js.conf.set(JaxIndexConstants.INDEX_NUM_BUCKETS, NUM_BUCKETS)
    th, jh = hst.Hyperspace(ts), JaxHyperspace(js)
    for table, name, indexed, included in INDEXES:
        th.create_index(ts.read.parquet(str(src / table)), hst.IndexConfig(name, indexed, included))
        jh.create_index(js.read.parquet(str(src / table)), JaxIndexConfig(name, indexed, included))
    return tmp_path / "torch" / "indexes", tmp_path / "jax" / "indexes"


@pytest.mark.parametrize("name", [i[1] for i in INDEXES])
def test_bucket_files_hold_the_same_rows_in_the_same_order(built, name):
    torch_root, jax_root = built
    tf = sorted(glob.glob(str(torch_root / name / "v__=0" / "*.parquet")))
    jf = sorted(glob.glob(str(jax_root / name / "v__=0" / "*.parquet")))
    assert [os.path.basename(f) for f in tf] == [os.path.basename(f) for f in jf]
    assert len(tf) == NUM_BUCKETS
    for a, b in zip(tf, jf):
        ta, tb = pq.read_table(a), pq.read_table(b)  # pyarrow reads the port's files
        assert ta.schema.names == tb.schema.names
        for n in ta.schema.names:
            np.testing.assert_array_equal(ta.column(n).to_numpy(), tb.column(n).to_numpy())
        # Same rows through the same writer arguments: the same bytes.
        assert hashlib.sha256(open(a, "rb").read()).digest() == hashlib.sha256(open(b, "rb").read()).digest()


def _normalized(entry: dict, root: str) -> str:
    """The entry with ids and timestamps dropped and the index files reduced
    to their paths below the index system root (key order kept)."""
    d = json.loads(json.dumps(entry))
    d.pop("id"), d.pop("timestamp")

    def files(node, prefix):
        base = os.path.join(prefix, node["name"]) if prefix else node["name"]
        out = [os.path.relpath(os.path.join(base, f["name"]), root) for f in node["files"]]
        for sub in node["subDirs"]:
            out += files(sub, base)
        return sorted(out)

    d["content"] = files(d["content"]["root"], "")
    return json.dumps(d, indent=2)


@pytest.mark.parametrize("name", [i[1] for i in INDEXES])
def test_log_entries_are_equal_apart_from_ids_times_and_paths(built, name):
    torch_root, jax_root = built
    for log_id in ("0", "1", "latestStable"):
        t_text = open(torch_root / name / "_hyperspace_log" / log_id).read()
        j_text = open(jax_root / name / "_hyperspace_log" / log_id).read()
        t, j = json.loads(t_text), json.loads(j_text)
        assert list(t) == list(j)
        assert _normalized(t, str(torch_root)) == _normalized(j, str(jax_root))
        # The JAX package reads the port's log entry.
        assert JaxLogEntry.from_json(t_text).state == j["state"]
