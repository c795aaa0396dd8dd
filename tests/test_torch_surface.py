"""The port's public surface against the JAX package's.

A program written for `hyperspace_tpu` runs on `hyperspace_tpu_torch` once
its imports name the port, apart from the names in `JAX_ONLY`: each stands
for a JAX mechanism the port has no counterpart for, with its reason.

- (i) For each package of the JAX package: every name its `__init__`
  exports resolves in the port's package; every public member of an
  exported class exists on the port's class; every public name an
  exported module defines exists in the port's module; and every public
  name or class member a module of the package defines that the JAX
  package never uses itself (its API leaves: what only a caller outside
  the package reaches) exists in the port's module. A name the JAX package
  uses internally is plumbing, whose behaviour the port carries under its
  own structure and the other oracle tests hold.
- (ii) The reference's API members on the same inputs in both packages:
  `IndexConfig.builder()`, `HyperspaceSession.active()`, `SessionConf.unset`
  and `copy`, `Expr.semantic_equals`, `schema.numpy_dtype`,
  `FileSystem.directory_size`, `json_to_map`, `make_absolute`,
  `bloom_probe`, `get_scan_node`, `io_pruning_summary` and
  `profiling.trace` / `annotate`. Answers are exact.
- (iii) The reference's two examples run in a child process under each
  package, the port's with only its imports renamed and its sessions on the
  CPU; their standard output is equal once temporary paths are masked and
  the port's known `(+N appended)` explain suffix is dropped.
- (iv) `Table.from_pydict` with no device and no active session asks for
  CUDA: it raises without a card, and nothing falls back to the CPU.
"""

import ast
import functools
import glob
import gzip
import importlib
import inspect
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch as hst
from chip_smoke import EXAMPLES, port_example_source
from hyperspace_tpu.config import HyperspaceConf as JaxHyperspaceConf
from hyperspace_tpu.config import SessionConf as JaxSessionConf
from hyperspace_tpu.engine import expr as jax_expr
from hyperspace_tpu.engine import schema as jax_schema
from hyperspace_tpu.engine.session import HyperspaceSession as JaxSession
from hyperspace_tpu.engine.table import Column as JaxColumn
from hyperspace_tpu.exceptions import HyperspaceException as JaxHyperspaceException
from hyperspace_tpu.index import dataskipping as jax_dataskipping
from hyperspace_tpu.index.index_config import IndexConfig as JaxIndexConfig
from hyperspace_tpu.rules import rule_utils as jax_rule_utils
from hyperspace_tpu.storage import filesystem as jax_fs
from hyperspace_tpu.telemetry import profiling as jax_profiling
from hyperspace_tpu.util import json_utils as jax_json_utils
from hyperspace_tpu.util import path_utils as jax_path_utils
from hyperspace_tpu_torch.config import HyperspaceConf, SessionConf
from hyperspace_tpu_torch.engine import expr as port_expr
from hyperspace_tpu_torch.engine import schema as port_schema
from hyperspace_tpu_torch.engine.session import HyperspaceSession
from hyperspace_tpu_torch.engine.table import Column, Table
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index import dataskipping as port_dataskipping
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.rules import rule_utils as port_rule_utils
from hyperspace_tpu_torch.storage import filesystem as port_fs
from hyperspace_tpu_torch.telemetry import device_observatory
from hyperspace_tpu_torch.telemetry import profiling as port_profiling
from hyperspace_tpu_torch.util import json_utils as port_json_utils
from hyperspace_tpu_torch.util import path_utils as port_path_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "hyperspace_tpu")

_PACKED_TRACED = (
    "the packed code lanes' traced unpack programs and their device memo (XLA programs over "
    "uint32 words); the port packs and unpacks with eager torch ops (`engine/packed_codes.py` "
    "`pack_rows`, `unpack_rows`)"
)
_BUILD_SORTS = (
    "a build sort the port leaves out by design (ROADMAP item 4): XLA's fused / Pallas / host "
    "variants of the one sort the port runs in `partition._bucket_key_sort` (composite on K1, "
    "packed on K3, the stable chain)"
)
_COMPILE_OBSERVATORY = (
    "XLA's compile observatory (jit wrapping, compile storms, the persistent compilation cache); "
    "torch compiles no program, and the port's `compile_log` records its kernels' builds and launches"
)
_SHIM = (
    "jax's program partitioning (pjit / shard_map across jax versions); the port's mesh is an "
    "ordered tuple of torch devices that one process drives (`parallel/mesh.py`), a sharded "
    "array a list of tensors"
)

#: Every JAX name the port leaves out, with the JAX-only mechanism it stands
#: for. A key is a module, or `module:name`, or `module:Class.member`.
JAX_ONLY = {
    "hyperspace_tpu.ops.backend:device_ops_forced": (
        "the switch between XLA's device sort and a numpy host sort on the CPU backend "
        "(HYPERSPACE_FORCE_DEVICE_OPS); the port runs one path on the tensor's device "
        "(`ops/backend.resolve_device`)"
    ),
    "hyperspace_tpu.ops.backend:use_device_path": "the same device switch (HYPERSPACE_FORCE_DEVICE_OPS)",
    "hyperspace_tpu.ops.backend:pallas_maybe_wanted": (
        "the gate in front of the ~1 s `jax.experimental.pallas` import; the port's kernels build "
        "inside the call that launches them"
    ),
    "hyperspace_tpu.parallel.shim": _SHIM,
    "hyperspace_tpu.parallel:pjit": _SHIM,
    "hyperspace_tpu.parallel:shard_map": _SHIM,
    "hyperspace_tpu.parallel:require_shard_map": _SHIM,
    "hyperspace_tpu.parallel:replicated": "a jax `NamedSharding` spec; a port shard is a tensor on its device",
    "hyperspace_tpu.parallel:row_sharding": "a jax `NamedSharding` spec; a port shard is a tensor on its device",
    "hyperspace_tpu.parallel:force_virtual_cpu": (
        "XLA's host-platform device count; the port's counterpart is `parallel.virtual_devices`"
    ),
    "hyperspace_tpu.parallel.mesh:replicated": "a jax `NamedSharding` spec (as `parallel:replicated`)",
    "hyperspace_tpu.parallel.mesh:row_sharding": "a jax `NamedSharding` spec (as `parallel:row_sharding`)",
    "hyperspace_tpu.parallel.mesh:force_virtual_cpu": "XLA's host-platform device count (`parallel.virtual_devices`)",
    "hyperspace_tpu.telemetry.compile_log:observed_jit": _COMPILE_OBSERVATORY,
    "hyperspace_tpu.telemetry.compile_log:install": _COMPILE_OBSERVATORY,
    "hyperspace_tpu.telemetry.compile_log:storm_threshold": _COMPILE_OBSERVATORY,
    "hyperspace_tpu.telemetry.compile_log:ENV_STORM_THRESHOLD": _COMPILE_OBSERVATORY,
    "hyperspace_tpu.telemetry.compile_log:compile_cache_summary": _COMPILE_OBSERVATORY,
    "hyperspace_tpu.telemetry.profiling:pallas_fallback_summary": (
        "the Pallas kernels' fallback counters; a port wrapper launches its kernel or raises, and "
        "nothing falls back"
    ),
    "hyperspace_tpu.ops.pallas_sort": "the Pallas sort kernels; the port's are CUDA (`ops/cuda_*sort.py`, `csrc/`)",
    "hyperspace_tpu.ops.pallas_probe": "the Pallas probe kernels; the port's are CUDA (`ops/cuda_*probe.py`, `csrc/`)",
    "hyperspace_tpu.engine.device_cache": (
        "the memo of host arrays uploaded as jax device arrays; the port's tables hold device "
        "tensors from the read on, so the scan cache is the upload cache (`engine/scan_cache.py`)"
    ),
    "hyperspace_tpu.engine.packed_codes:pack_rows_traced": _PACKED_TRACED,
    "hyperspace_tpu.engine.packed_codes:unpack_rows_traced": _PACKED_TRACED,
    "hyperspace_tpu.engine.packed_codes:unpack_codes_device": _PACKED_TRACED,
    "hyperspace_tpu.engine.packed_codes:stage_packed_codes": _PACKED_TRACED,
    "hyperspace_tpu.engine.packed_codes:clear_packed_memos": _PACKED_TRACED,
    "hyperspace_tpu.ops.partition:host_sort_perm": _BUILD_SORTS,
    "hyperspace_tpu.ops.partition:fused_bucketize_sort_perm": _BUILD_SORTS,
    "hyperspace_tpu.ops.partition:pallas_packed_build_sort": _BUILD_SORTS,
    "hyperspace_tpu.ops.partition:pallas_composite_build_sort": _BUILD_SORTS,
    "hyperspace_tpu.ops.hashing:ENV_HASH_QUANTIZE": (
        "pow2 row quantization of the jitted hash program's shapes (one XLA compile a shape); the "
        "port's hash runs eagerly, so the planner's `hash_quantize` decision gates nothing"
    ),
    "hyperspace_tpu.ops.join:nonzero_indices": (
        "a workaround of `jnp.nonzero(size=n)` compiling once a survivor count; torch.nonzero "
        "compiles nothing"
    ),
    "hyperspace_tpu.engine.streaming:stream_join_aggregate": (
        "reached only when the JAX fused join aggregate declines (the CPU backend, a mesh, an "
        "expression XLA cannot trace); the port's fused path never declines (ROADMAP item 10)"
    ),
}


def _port_name(module: str) -> str:
    return "hyperspace_tpu_torch" + module[len("hyperspace_tpu"):]


def _source(module: str) -> str:
    rel = module.split(".")[1:]
    path = os.path.join(JAX_ROOT, *rel)
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def _word_counts() -> dict:
    counts: dict = {}
    for path in glob.glob(os.path.join(JAX_ROOT, "**", "*.py"), recursive=True):
        with open(path) as f:
            for w in re.findall(r"\b[A-Za-z_][A-Za-z0-9_]*\b", f.read()):
                counts[w] = counts.get(w, 0) + 1
    return counts


def _is_leaf(name: str) -> bool:
    """Named once in the whole JAX package: at its definition."""
    return _word_counts().get(name, 0) <= 1


def _defined(module: str) -> list:
    """The public names a JAX module defines at its top level."""
    out = []
    for node in ast.parse(_source(module)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, ast.Assign):
            out += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.append(node.target.id)
    return [n for n in out if not n.startswith("_")]


def _exports(package: str) -> list:
    """The names a JAX package's `__init__` exports: its relative imports,
    and the names its module `__getattr__` loads lazily."""
    out = []
    for node in ast.parse(_source(package)).body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1:
            out += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            out += [c.value for c in ast.walk(node)
                    if isinstance(c, ast.Constant) and isinstance(c.value, str) and c.value.isidentifier()]
    return [n for n in dict.fromkeys(out) if not n.startswith("_")]


def _modules(package: str) -> list:
    """The package itself and the modules directly in it."""
    d = os.path.join(JAX_ROOT, *package.split(".")[1:])
    return [package] + [f"{package}.{f[:-3]}" for f in sorted(os.listdir(d))
                        if f.endswith(".py") and f != "__init__.py"]


def _public_members(cls) -> list:
    return [a for a in dir(cls) if not a.startswith("_")]


PACKAGES = ["hyperspace_tpu"] + sorted(
    f"hyperspace_tpu.{d}" for d in os.listdir(JAX_ROOT)
    if os.path.isfile(os.path.join(JAX_ROOT, d, "__init__.py"))
)


def _missing(package: str) -> list:
    missing = []

    def need(key: str, present: bool) -> None:
        if not present and key not in JAX_ONLY:
            missing.append(key)

    jax_pkg = importlib.import_module(package)
    port_pkg = importlib.import_module(_port_name(package))
    for name in _exports(package):
        jv = getattr(jax_pkg, name)
        need(f"{package}:{name}", hasattr(port_pkg, name))
        if not hasattr(port_pkg, name):
            continue
        pv = getattr(port_pkg, name)
        if inspect.isclass(jv):
            for m in _public_members(jv):
                need(f"{jv.__module__}:{jv.__name__}.{m}", hasattr(pv, m))
        elif inspect.ismodule(jv):
            for n in _defined(jv.__name__):
                need(f"{jv.__name__}:{n}", hasattr(pv, n))
    for module in _modules(package):
        if module in JAX_ONLY:
            continue
        try:
            port_mod = importlib.import_module(_port_name(module))
        except ModuleNotFoundError:
            missing.append(module)
            continue
        jax_mod = importlib.import_module(module)
        for n in _defined(module):
            if _is_leaf(n):
                need(f"{module}:{n}", hasattr(port_mod, n))
            jv = getattr(jax_mod, n)
            if inspect.isclass(jv) and hasattr(port_mod, n):
                for m in _public_members(jv):
                    if _is_leaf(m):
                        need(f"{module}:{n}.{m}", hasattr(getattr(port_mod, n), m))
    return missing


# ---------------------------------------------------------------------------
# (i) The surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", PACKAGES)
def test_every_public_name_of_the_jax_package_is_in_the_port(package):
    assert _missing(package) == []


def test_each_jax_only_name_is_a_jax_name_the_port_lacks_with_a_reason():
    for key, reason in JAX_ONLY.items():
        assert isinstance(reason, str) and len(reason) > 20, key
        module, _, attr = key.partition(":")
        jax_mod = importlib.import_module(module)
        if not attr:
            with pytest.raises(ModuleNotFoundError):
                importlib.import_module(_port_name(module))
            continue
        assert hasattr(jax_mod, attr), key
        assert not hasattr(importlib.import_module(_port_name(module)), attr), key


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, hyperspace_tpu_torch, hyperspace_tpu_torch.engine, hyperspace_tpu_torch.index, "
            "hyperspace_tpu_torch.telemetry, hyperspace_tpu_torch.plananalysis, hyperspace_tpu_torch.rules, "
            "hyperspace_tpu_torch.storage\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'hyperspace_tpu.')) "
            "or m == 'hyperspace_tpu')\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# (ii) The API members against the JAX package
# ---------------------------------------------------------------------------


def test_the_builder_gives_the_jax_packages_config():
    for calls in ([("index_name", ("n",)), ("index_by", ("a", "b")), ("include", ("c",))],
                  [("include", ("X", "y")), ("index_by", ("K",)), ("index_name", ("Idx",))],
                  [("index_by", ("k",)), ("index_name", ("only_keys",))]):
        built = {}
        for tag, cfg in (("jax", JaxIndexConfig), ("port", IndexConfig)):
            b = cfg.builder()
            assert isinstance(b, cfg.Builder)
            for method, args in calls:
                b = getattr(b, method)(*args)
            built[tag] = b.create()
        j, p = built["jax"], built["port"]
        assert (p.index_name, p.indexed_columns, p.included_columns) == (j.index_name, j.indexed_columns, j.included_columns)
        assert p == IndexConfig(j.index_name, j.indexed_columns, j.included_columns)


@pytest.mark.parametrize("misuse", [
    lambda c: c.builder().index_name("n").index_name("m"),
    lambda c: c.builder().index_by("a").index_by("b"),
    lambda c: c.builder().include("a").include("b"),
    lambda c: c.builder().index_name(""),
    lambda c: c.builder().index_name("   "),
    lambda c: c.builder().index_by(),
    lambda c: c.builder().include(),
    lambda c: c.builder().index_by("a").create(),
    lambda c: c.builder().index_name("n").create(),
    lambda c: c.builder().index_name("n").index_by("a").include("A").create(),
])
def test_builder_misuse_raises_in_both_packages(misuse):
    with pytest.raises(JaxHyperspaceException) as je:
        misuse(JaxIndexConfig)
    with pytest.raises(HyperspaceException) as pe:
        misuse(IndexConfig)
    assert str(pe.value) == str(je.value)


def test_active_session_is_the_threads_newest_else_the_processes(tmp_path):
    def run(make):
        first = make("a")
        seen = {}

        def other():
            second = make("b")
            seen["other thread"] = type(first).active() is second

        t = threading.Thread(target=other)
        t.start()
        t.join()
        seen["main thread"] = type(first).active() is first
        fresh = threading.Thread(target=lambda: seen.__setitem__(
            "fresh thread", type(first).active().warehouse.endswith("b")))
        fresh.start()
        fresh.join()
        return seen

    jax_seen = run(lambda w: JaxSession(warehouse=str(tmp_path / "jax" / w)))
    port_seen = run(lambda w: HyperspaceSession(warehouse=str(tmp_path / "port" / w), device="cpu"))
    assert port_seen == jax_seen == {"other thread": True, "main thread": True, "fresh thread": True}


def test_hyperspace_with_no_session_takes_the_active_one(tmp_path):
    s = HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    assert hst.Hyperspace()._session is s
    assert s.create_table({"a": [1, 2]}).columns["a"].data.device == torch.device("cpu")


def test_no_session_at_all_raises_in_both_packages():
    code = ("import sys\n"
            "pkg = sys.argv[1]\n"
            "import importlib\n"
            "m = importlib.import_module(pkg)\n"
            "try:\n"
            "    m.HyperspaceSession.active()\n"
            "except m.HyperspaceException as e:\n"
            "    print('raised', e)\n"
            "try:\n"
            "    m.Hyperspace()\n"
            "except m.HyperspaceException as e:\n"
            "    print('raised', e)\n")
    outs = []
    for pkg in ("hyperspace_tpu", "hyperspace_tpu_torch"):
        out = subprocess.run([sys.executable, "-c", code, pkg], capture_output=True, text=True, cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"), timeout=300)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout)
    assert outs[1] == outs[0] == "raised No active HyperspaceSession.\n" * 2


def test_unset_and_copy_equal_the_jax_packages():
    results = []
    for conf_cls, hs_conf_cls in ((JaxSessionConf, JaxHyperspaceConf), (SessionConf, HyperspaceConf)):
        c = conf_cls({"hyperspace.index.num.buckets": "8"})
        c.set("hyperspace.system.path", "/lake/indexes")
        c.set("hyperspace.index.search.paths", "/a,/b")
        c.set("hyperspace.build.mesh.devices", 4)
        d = c.copy()
        c.unset("hyperspace.index.num.buckets")
        c.unset("never.set")
        c.set("hyperspace.system.path", "/elsewhere")
        h, hd = hs_conf_cls(c), hs_conf_cls(d)
        results.append((
            type(d) is conf_cls, c.get("hyperspace.index.num.buckets"), d.get("hyperspace.index.num.buckets"),
            h.num_buckets, hd.num_buckets, h.system_path, hd.system_path, h.search_paths, h.build_mesh_devices,
            hs_conf_cls(conf_cls()).search_paths, hs_conf_cls(conf_cls()).build_mesh_devices,
            hs_conf_cls(conf_cls()).system_path,
        ))
    assert results[1] == results[0]
    for key in ("INDEX_CREATION_PATH", "INDEX_SEARCH_PATHS", "BUILD_MESH_DEVICES"):
        assert getattr(hst.IndexConstants, key) == getattr(hyperspace_tpu.IndexConstants, key)


def _expr_pairs(m):
    c, lit = m.col, m.lit
    return [
        (c("a"), c("a")),
        (c("a"), c("b")),
        (c("a") == 1, c("a") == 1),
        (c("a") == 1, c("a") == 2),
        (c("a") == 1, c("a") == 1.0),
        ((c("a") > 1) & (c("b") < 2), (c("a") > 1) & (c("b") < 2)),
        ((c("a") > 1) & (c("b") < 2), (c("b") < 2) & (c("a") > 1)),
        (c("a").isin(1, 2), c("a").isin([1, 2])),
        (c("a").is_null(), c("a").is_not_null()),
        (~(c("a") == 1), ~(c("a") == 1)),
        (lit("x"), lit("x")),
        (c("a") + c("b"), c("a") + c("b")),
        (c("a") * 2, c("a") * 3),
    ]


def test_semantic_equals_answers_as_the_jax_package():
    jax_answers = [a.semantic_equals(b) for a, b in _expr_pairs(jax_expr)]
    port_answers = [a.semantic_equals(b) for a, b in _expr_pairs(port_expr)]
    assert port_answers == jax_answers
    assert True in port_answers and False in port_answers


def test_numpy_dtype_of_every_type_name():
    for name in ("int32", "int64", "float32", "float64", "bool"):
        assert port_schema.numpy_dtype(name) == jax_schema.numpy_dtype(name)
    for mod in (jax_schema, port_schema):
        with pytest.raises(ValueError, match="dictionary-encoded"):
            mod.numpy_dtype("string")
        with pytest.raises(KeyError):
            mod.numpy_dtype("decimal")


@pytest.mark.parametrize("backend", ["local", "memory"])
def test_directory_size_equals_the_jax_packages(tmp_path, backend):
    rng = np.random.default_rng(3)
    sizes = {}
    for tag, mod in (("jax", jax_fs), ("port", port_fs)):
        fs = mod.LocalFileSystem() if backend == "local" else mod.InMemoryFileSystem()
        root = str(tmp_path / tag) if backend == "local" else f"/mem/{tag}"
        for i, rel in enumerate(["a.bin", "d/b.bin", "d/e/c.bin", "d/e/f/g.bin"]):
            fs.write_bytes(os.path.join(root, rel), rng.bytes(17 * (i + 1) + 3).hex().encode())
        fs.mkdirs(os.path.join(root, "empty"))
        sizes[tag] = (fs.directory_size(root), fs.directory_size(os.path.join(root, "d")),
                      fs.directory_size(os.path.join(root, "empty")))
    assert sizes["port"] == sizes["jax"] and sizes["port"][0] > sizes["port"][1] > 0 == sizes["port"][2]


def test_a_remote_filesystem_has_directory_size():
    pytest.importorskip("fsspec")
    from hyperspace_tpu_torch.storage.remote import FsspecFileSystem

    fs = FsspecFileSystem(protocol="memory")
    fs.write_bytes("memory://surface/x/a", b"12345")
    fs.write_bytes("memory://surface/x/y/b", b"123")
    assert fs.directory_size("memory://surface/x") == 8


def test_json_to_map_and_make_absolute(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for text in ('{"a": 1, "b": [1, 2], "c": {"d": null}}', "{}"):
        assert port_json_utils.json_to_map(text) == jax_json_utils.json_to_map(text)
    for text in ("[1, 2]", "3", '"s"'):
        with pytest.raises(ValueError, match="expected JSON object") as pe:
            port_json_utils.json_to_map(text)
        with pytest.raises(ValueError) as je:
            jax_json_utils.json_to_map(text)
        assert str(pe.value) == str(je.value)
    for p in ("rel/dir", ".", "../up", "/abs/x", "a/./b/../c"):
        assert port_path_utils.make_absolute(p) == jax_path_utils.make_absolute(p)


def test_bloom_probe_over_the_same_bits():
    rng = np.random.default_rng(11)
    columns = {
        "int64": rng.integers(0, 1000, 300).astype(np.int64),
        "float64": rng.normal(size=200),
        "string": np.asarray([f"s{i}" for i in rng.integers(0, 400, 150)]),
    }
    probes = {
        "int64": [0, 5, 999, 1000, 5.0, 5.5, -1, 2**70, "5"],
        "float64": [float(columns["float64"][3]), 0.25, float("nan"), 1, "x"],
        "string": ["s1", "s399", "nope", "", 5],
    }
    for dtype, values in columns.items():
        bits = jax_dataskipping._bloom_bits(JaxColumn.from_values(values), 512, 4)
        assert port_dataskipping.bloom_bits(Column.from_values(values, "cpu"), 512, 4).tolist() == bits.tolist()
        candidates = list(values[:20]) + probes[dtype]
        jax_answers = [jax_dataskipping.bloom_probe(bits, v, dtype, 4) for v in candidates]
        port_answers = [port_dataskipping.bloom_probe(bits, v, dtype, 4) for v in candidates]
        assert port_answers == jax_answers
        assert all(port_answers[:20]) and False in port_answers


def _plan_shapes(m, src_a, src_b):
    s, c = m["session"], m["col"]
    a, b = s.read.parquet(src_a), s.read.parquet(src_b)
    return {
        "scan": a,
        "filter": a.filter(c("k") > 3),
        "project": a.select("k"),
        "filter_project": a.filter(c("k") > 3).select("v"),
        "with_column": a.with_column("w", c("k") + 1).filter(c("w") > 2),
        "join": a.join(b, c("k") == c("k2")),
        "union": a.union(a),
        "aggregate": a.group_by("v").agg(n=("k", "count")),
        "order_limit": a.order_by("k").limit(3),
    }


def test_get_scan_node_on_a_plan_of_each_shape(tmp_path):
    from hyperspace_tpu.engine.expr import col as jcol

    s = HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    src_a, src_b = str(tmp_path / "a"), str(tmp_path / "b")
    s.write_parquet({"k": np.arange(8, dtype=np.int64), "v": np.arange(8, dtype=np.int64) % 3}, src_a)
    s.write_parquet({"k2": np.arange(4, dtype=np.int64)}, src_b)
    j = JaxSession(warehouse=str(tmp_path))
    jax_plans = _plan_shapes({"session": j, "col": jcol}, src_a, src_b)
    port_plans = _plan_shapes({"session": s, "col": hst.col}, src_a, src_b)
    found = []
    for shape, jdf in jax_plans.items():
        jn = jax_rule_utils.get_scan_node(jdf.plan)
        pn = port_rule_utils.get_scan_node(port_plans[shape].plan)
        assert (jn is None) == (pn is None), shape
        if jn is not None:
            assert pn.relation.root_paths == jn.relation.root_paths, shape
            found.append(shape)
    assert "scan" in found and "join" not in found


def test_io_pruning_summary_has_the_jax_packages_keys(tmp_path):
    s = HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    src = str(tmp_path / "src")
    s.write_parquet({"k": np.arange(400, dtype=np.int64), "s": np.asarray(["x", "y"] * 200)}, src, row_group_rows=100)
    before = port_profiling.io_pruning_summary()
    from hyperspace_tpu_torch.engine import physical, scan_cache

    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    assert s.read.parquet(src).filter(hst.col("k") < 50).collect().num_rows == 50
    after = port_profiling.io_pruning_summary()
    assert list(after) == list(jax_profiling.io_pruning_summary())
    assert all(isinstance(v, int) for v in after.values())
    d = {k: after[k] - before[k] for k in after}
    assert d["row_groups_scanned"] >= 1 and d["row_groups_skipped"] >= 1 and d["bytes_decoded"] > 0
    assert d["columns_encoded"] + d["columns_flattened"] >= 1


def test_trace_and_annotate_on_the_cpu_name_the_region_in_both_packages(tmp_path):
    import jax.numpy as jnp

    with jax_profiling.trace(str(tmp_path / "jax")):
        with jax_profiling.annotate("surface_region"):
            (jnp.arange(64) + 1).block_until_ready()
    traced = [p for p in glob.glob(str(tmp_path / "jax" / "**" / "*"), recursive=True) if os.path.isfile(p)]
    blobs = [gzip.open(p).read() if p.endswith(".gz") else open(p, "rb").read() for p in traced]
    assert any(b"surface_region" in b for b in blobs)

    with port_profiling.trace(str(tmp_path / "port")):
        with port_profiling.annotate("surface_region"):
            torch.arange(64).sum()
    with open(tmp_path / "port" / device_observatory.CHROME_TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "surface_region" for e in events)


def test_trace_and_annotate_disabled_do_nothing(tmp_path):
    with port_profiling.trace(None):
        with port_profiling.annotate("off", enabled=False):
            pass
    with port_profiling.trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")


def test_trace_lets_a_profiler_that_fails_to_start_raise(tmp_path, monkeypatch):
    def broken(cuda):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(device_observatory, "start_profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with port_profiling.trace(str(tmp_path / "t")):
            pass


def test_stage_histories_read_the_recorded_summaries():
    port_profiling.record_query_stages({"wall_s": 0.5, "mode": "surface-q"})
    port_profiling.record_join_stages({"wall_s": 0.25, "mode": "surface-j"})
    assert port_profiling.query_stages_history()[-1]["mode"] == "surface-q"
    assert port_profiling.join_stages_history()[-1]["mode"] == "surface-j"
    assert port_profiling.query_stages_history()[-1] == port_profiling.last_query_stages()
    assert port_profiling.join_stages_history()[-1] == port_profiling.last_join_stages()


# ---------------------------------------------------------------------------
# (iii) The reference's examples under both packages
# ---------------------------------------------------------------------------

#: Run a rewritten example as `__main__`; the port's sessions default to the
#: CPU, as `HyperspaceSession(device="cpu")` would make them.
_PORT_PRELUDE = (
    "from hyperspace_tpu_torch.engine.session import HyperspaceSession\n"
    "HyperspaceSession.__init__.__defaults__ = ('.', 'cpu', None, None)\n"
)


def _run_example(tmp_path, name: str, port: bool) -> str:
    with open(os.path.join(REPO, "examples", name)) as f:
        source = f.read()
    d = tmp_path / ("port" if port else "jax")
    d.mkdir(exist_ok=True)
    path = d / name
    path.write_text(port_example_source(source) if port else source)
    code = (_PORT_PRELUDE if port else "") + f"import runpy\nrunpy.run_path({str(path)!r}, run_name='__main__')\n"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(d),
                         env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"), timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _masked(text: str) -> str:
    text = re.sub(r"hs_(quickstart|walkthrough)_[A-Za-z0-9_]+", r"hs_\1_<tmp>", text)
    return re.sub(r" \(\+\d+ appended\)", "", text)


def test_the_rewrite_touches_only_imports_and_platform_lines():
    for name, _ in EXAMPLES:
        with open(os.path.join(REPO, "examples", name)) as f:
            source = f.read()
        ported = port_example_source(source)
        assert "jax" not in ported.replace("hyperspace_tpu", "")
        kept = [l for l in source.splitlines() if "hyperspace_tpu" not in l]
        assert [l for l in ported.splitlines() if "hyperspace_tpu" not in l] == [
            l for l in kept if l.strip() != "import jax" and not l.strip().startswith(("jax.config", 'os.environ.setdefault("XLA'))]


@pytest.mark.parametrize("name,success", EXAMPLES)
def test_the_reference_examples_print_the_same_under_both_packages(tmp_path, name, success):
    jax_out = _run_example(tmp_path, name, port=False)
    port_out = _run_example(tmp_path, name, port=True)
    assert success in port_out.splitlines()
    assert _masked(port_out) == _masked(jax_out)


# ---------------------------------------------------------------------------
# (iv) The default device of a table
# ---------------------------------------------------------------------------


def test_from_pydict_with_no_device_and_no_session_asks_for_cuda(monkeypatch):
    monkeypatch.setattr(HyperspaceSession, "_active", None)
    monkeypatch.setattr(HyperspaceSession, "_active_local", threading.local())
    if torch.cuda.is_available():
        assert Table.from_pydict({"a": [1, 2]}).columns["a"].data.device.type == "cuda"
        return
    with pytest.raises(HyperspaceException, match="CUDA"):
        Table.from_pydict({"a": [1, 2]})


def test_from_pydict_with_no_device_takes_the_active_sessions(tmp_path):
    s = HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    t = Table.from_pydict({"a": [1, 2], "s": ["x", "y"]})
    assert all(c.data.device == s.device for c in t.columns.values())
    assert Table.from_pydict({"a": [3]}, "cpu").rows() == [(3,)]
    assert t.rename({"a": "b"}).column_names == ["b", "s"] and t.column_names == ["a", "s"]
