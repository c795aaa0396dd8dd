"""The port's boundary: what it imports, where it runs, what it refuses.

(a) A fresh process imports the port, builds and joins on the CPU, and ends
    with no JAX module and no `hyperspace_tpu` module loaded.
(b) No file of the port (nor `chip_smoke.py`) imports `jax` or `hyperspace_tpu`.
(c) A session built without `device=` asks for CUDA; with no card it raises
    instead of running on the CPU.
(d) Features outside the slice raise NotImplementedError naming the feature.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import hyperspace_tpu_torch as hst
from hyperspace_tpu_torch.engine.table import Table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hyperspace_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "hyperspace_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_a_fresh_process_runs_the_slice_without_jax(tmp_path):
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import hyperspace_tpu_torch as hst
        from hyperspace_tpu_torch.engine.table import Table
        base = {str(tmp_path)!r}
        rng = np.random.RandomState(0)
        k = rng.randint(0, 500, 3000).astype(np.int64)
        s = hst.HyperspaceSession(warehouse=base, device="cpu")
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
        s.write_parquet({{"a": k, "x": rng.rand(3000)}}, base + "/l")
        s.write_parquet({{"b": np.arange(500, dtype=np.int64), "y": rng.rand(500)}}, base + "/r")
        hs = hst.Hyperspace(s)
        hs.create_index(s.read.parquet(base + "/l"), hst.IndexConfig("li", ["a"], ["x"]))
        hs.create_index(s.read.parquet(base + "/r"), hst.IndexConfig("ri", ["b"], ["y"]))
        hst.enable_hyperspace(s)
        q = s.read.parquet(base + "/l").join(s.read.parquet(base + "/r"), hst.col("a") == hst.col("b"))
        assert q.count() == 3000 and q.select("x", "y").collect().num_rows == 3000
        assert "BucketedIndexScan" in q.explain_string()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not bad, bad
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    bad = [(os.path.relpath(p, REPO), m) for p in files for m in _imports(p) if _forbidden(m)]
    assert bad == []


def test_the_default_device_is_cuda_and_never_falls_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        assert hst.HyperspaceSession(warehouse=str(tmp_path)).device.type == "cuda"
    else:
        with pytest.raises(hst.HyperspaceException, match="CUDA"):
            hst.HyperspaceSession(warehouse=str(tmp_path))


@pytest.fixture()
def session(tmp_path):
    s = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 4)
    s.write_parquet({"a": np.arange(10, dtype=np.int64), "x": np.ones(10)}, str(tmp_path / "l"))
    s.write_parquet({"b": np.arange(10, dtype=np.int64), "y": np.ones(10)}, str(tmp_path / "r"))
    return s, s.read.parquet(str(tmp_path / "l")), s.read.parquet(str(tmp_path / "r"))


CUT_OUTS = {
    "filter": lambda s, l, r: l.filter(hst.col("a") == 1),
    "aggregation": lambda s, l, r: l.group_by("a"),
    "left joins": lambda s, l, r: l.join(r, hst.col("a") == hst.col("b"), "left"),
    "the join without a compatible pair of covering indexes": lambda s, l, r: l.join(
        r, hst.col("a") == hst.col("b")
    ).count(),
    "string columns": lambda s, l, r: Table.from_pydict({"s": np.array(["x", "y"])}, "cpu"),
    "null values": lambda s, l, r: _read_nullable(s),
    "aggregation (agg)": lambda s, l, r: l.agg(n=("*", "count")),
    "computed columns": lambda s, l, r: l.with_column("z", hst.col("a")),
    "order by": lambda s, l, r: l.order_by("a"),
    "limit": lambda s, l, r: l.limit(3),
}


def _read_nullable(s):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = os.path.join(s.warehouse, "nullable")
    os.makedirs(path)
    pq.write_table(pa.table({"a": pa.array([1, None], pa.int64())}), os.path.join(path, "part-0.parquet"))
    return s.read.parquet(path).select("a").collect()


@pytest.mark.parametrize("feature", sorted(CUT_OUTS))
def test_features_outside_the_slice_raise_naming_the_feature(session, feature):
    with pytest.raises(NotImplementedError, match=feature.split()[0]):
        CUT_OUTS[feature](*session)
