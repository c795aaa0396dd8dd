"""The port's `FileSystem` seam: the operation log over local disk, memory
and fsspec, against the JAX package's.

The JAX package's `TestIndexLogManager` cases (`tests/test_metadata_core.py`
:169-258) run on the port's `IndexLogManagerImpl` over each backend: the OCC
commit refuses an existing id, exactly one of racing writers wins, the
`latestStable` pointer and its fallback scan, a round trip of an entry. An
entry the port commits through fsspec reads back field-equal through the
JAX package's manager over the same store. `FileSystemFactory` picks a
backend by the path's scheme, and the collection manager takes its
filesystem from the factory it is given.
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLogManager
from hyperspace_tpu.storage.remote import FsspecFileSystem as JaxFsspecFileSystem
from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.index.collection_manager import CachingIndexCollectionManager
from hyperspace_tpu_torch.index.data_manager import IndexDataManagerImpl
from hyperspace_tpu_torch.index.factories import FileSystemFactory, IndexDataManagerFactory, IndexLogManagerFactory
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    CoveringIndexProperties,
    Directory,
    FileInfo,
    IndexLogEntry,
    LogEntry,
    LogicalPlanFingerprint,
    Relation,
    Signature,
    Source,
    SourcePlanProperties,
)
from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
from hyperspace_tpu_torch.storage.filesystem import InMemoryFileSystem, LocalFileSystem
from hyperspace_tpu_torch.storage.remote import FsspecFileSystem, filesystem_for_path
from hyperspace_tpu_torch.util import json_utils

BACKENDS = ["local", "memory", "fsspec"]


def _memory_store():
    from fsspec.implementations.memory import MemoryFileSystem

    inst = MemoryFileSystem()
    inst.store = {}  # MemoryFileSystem's state is class-global: one store a test
    inst.pseudo_dirs = [""]
    return inst


def _make_fs(kind: str):
    if kind == "local":
        return LocalFileSystem()
    if kind == "memory":
        return InMemoryFileSystem()
    return FsspecFileSystem(_memory_store())


def _sample_entry(name="idx1", state=states.ACTIVE, sig="deadbeef"):
    content = Content(Directory("/tmp/indexes/idx1/v__=0", files=[FileInfo("part-0.parquet", 100, 1)], subdirs=[]))
    rel = Content(Directory("/data/t1", files=[FileInfo("f1.parquet", 10, 2)]))
    entry = IndexLogEntry(
        name,
        CoveringIndexProperties(["deptId"], ["deptName"], '{"fields":[]}', 8),
        content,
        Source(SourcePlanProperties(
            [Relation(["/data/t1"], rel, '{"fields":[]}', "parquet", {})], None, None,
            LogicalPlanFingerprint(signatures=[Signature("prov", sig)]),
        )),
    )
    entry.state = state
    return entry


@pytest.mark.parametrize("fs_kind", BACKENDS)
def test_occ_write_refuses_existing_id(tmp_path, fs_kind):
    mgr = IndexLogManagerImpl(str(tmp_path / "idx"), _make_fs(fs_kind))
    assert mgr.write_log(0, _sample_entry(state=states.CREATING))
    assert not mgr.write_log(0, _sample_entry(state=states.ACTIVE))
    assert mgr.get_log(0).state == states.CREATING


@pytest.mark.parametrize("fs_kind", BACKENDS)
def test_occ_racing_writers_exactly_one_wins(tmp_path, fs_kind):
    mgr = IndexLogManagerImpl(str(tmp_path / "race"), _make_fs(fs_kind))
    start = threading.Barrier(8)

    def race(_):
        start.wait()
        return mgr.write_log(0, _sample_entry(state=states.CREATING))

    with ThreadPoolExecutor(max_workers=8) as pool:
        wins = list(pool.map(race, range(8)))
    assert sum(bool(w) for w in wins) == 1
    assert mgr.get_latest_id() == 0


@pytest.mark.parametrize("fs_kind", BACKENDS)
def test_full_log_flow_per_backend(tmp_path, fs_kind):
    mgr = IndexLogManagerImpl(str(tmp_path / "flow"), _make_fs(fs_kind))
    mgr.write_log(0, _sample_entry(state=states.CREATING))
    assert mgr.get_latest_stable_log() is None
    mgr.write_log(1, _sample_entry(state=states.ACTIVE))
    assert mgr.get_latest_stable_log().state == states.ACTIVE
    assert mgr.create_latest_stable_log(1)
    assert mgr.get_latest_stable_log().id == 1
    assert mgr.get_latest_id() == 1
    assert mgr.delete_latest_stable_log()
    assert mgr.get_latest_stable_log().id == 1


@pytest.mark.parametrize("fs_kind", BACKENDS)
def test_latest_id_and_log(tmp_path, fs_kind):
    mgr = IndexLogManagerImpl(str(tmp_path / "idx"), _make_fs(fs_kind))
    assert mgr.get_latest_id() is None
    assert mgr.get_latest_log() is None
    mgr.write_log(0, _sample_entry(state=states.CREATING))
    mgr.write_log(1, _sample_entry(state=states.ACTIVE))
    assert mgr.get_latest_id() == 1
    assert mgr.get_latest_log().state == states.ACTIVE


@pytest.mark.parametrize("fs_kind", BACKENDS)
def test_latest_stable_pointer_and_fallback(tmp_path, fs_kind):
    mgr = IndexLogManagerImpl(str(tmp_path / "idx"), _make_fs(fs_kind))
    mgr.write_log(0, _sample_entry(state=states.CREATING))
    assert mgr.get_latest_stable_log() is None
    mgr.write_log(1, _sample_entry(state=states.ACTIVE))
    assert mgr.get_latest_stable_log().state == states.ACTIVE
    assert mgr.create_latest_stable_log(1)
    assert mgr.get_latest_stable_log().id == 1
    mgr.write_log(2, _sample_entry(state=states.DELETING))
    assert not mgr.create_latest_stable_log(2)
    assert mgr.delete_latest_stable_log()
    assert mgr.get_latest_stable_log().id == 1


@pytest.mark.parametrize("fs_kind", BACKENDS)
def test_entry_roundtrip_through_log(tmp_path, fs_kind):
    mgr = IndexLogManagerImpl(str(tmp_path / "idx"), _make_fs(fs_kind))
    e = _sample_entry()
    mgr.write_log(0, e)
    got = mgr.get_log(0)
    assert got.to_json() == e.to_json() and got.id == 0
    assert isinstance(LogEntry.from_json(json_utils.to_json(e.to_json())), IndexLogEntry)


def test_an_entry_committed_through_fsspec_reads_back_in_the_jax_package():
    store = _memory_store()
    IndexLogManagerImpl("/lake/idx", FsspecFileSystem(store)).write_log(0, _sample_entry(state=states.ACTIVE))
    jax_entry = JaxLogManager("/lake/idx", JaxFsspecFileSystem(store)).get_log(0)
    text = FsspecFileSystem(store).read_text("/lake/idx/_hyperspace_log/0")
    assert jax_entry.to_json() == json.loads(text)
    assert not JaxLogManager("/lake/idx", JaxFsspecFileSystem(store)).write_log(0, _sample_entry())


@pytest.mark.parametrize("fs_kind", BACKENDS)
def test_the_data_manager_lists_versions_on_every_backend(tmp_path, fs_kind):
    fs = _make_fs(fs_kind)
    root = str(tmp_path / "idx")
    for v in (0, 3):
        fs.write_text(f"{root}/v__={v}/part-00000.parquet", "x")
    fs.write_text(f"{root}/v__=x/part-00000.parquet", "x")
    mgr = IndexDataManagerImpl(root, fs)
    assert mgr.get_latest_version_id() == 3
    mgr.delete(3)
    assert mgr.get_latest_version_id() == 0


@pytest.mark.parametrize("path, protocol", [
    ("memory://lake/indexes/a", "memory"),
    ("s3://bucket/indexes/a", "s3"),
    ("abfs://c@acct/indexes/a", "abfs"),
    ("/tmp/lake/indexes/a", None),
    ("relative/indexes/a", None),
])
def test_the_factory_picks_a_backend_by_scheme(path, protocol, monkeypatch):
    """The protocol handed to fsspec (recorded, so no cloud backend is
    needed), or the local disk for a plain path."""
    import fsspec

    monkeypatch.setattr(fsspec, "filesystem", lambda proto: ("fsspec", proto))
    fs = FileSystemFactory().create(path)
    if protocol is None:
        assert type(fs) is LocalFileSystem and filesystem_for_path(path) is None
    else:
        assert type(fs) is FsspecFileSystem and fs._fs == ("fsspec", protocol)


def test_an_index_log_on_memory_url_commits_and_refuses_like_local():
    fs = FileSystemFactory().create("memory://hs/indexes/idx")
    mgr = IndexLogManagerFactory().create("memory://hs/indexes/idx", fs)
    assert mgr.write_log(0, _sample_entry(state=states.CREATING))
    assert not mgr.write_log(0, _sample_entry())
    assert FileSystemFactory().create("memory://hs/indexes/idx").exists("memory://hs/indexes/idx/_hyperspace_log/0")
    fs.delete("memory://hs", recursive=True)


def test_the_collection_manager_takes_its_filesystem_from_the_factory(tmp_path):
    asked = []

    class Recording(FileSystemFactory):
        def create(self, path):
            asked.append(path)
            return super().create(path)

    s = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 2)
    s.write_parquet({"k": np.arange(6, dtype=np.int64)}, str(tmp_path / "src"))
    mgr = CachingIndexCollectionManager(s, fs_factory=Recording(), log_manager_factory=IndexLogManagerFactory(),
                                        data_manager_factory=IndexDataManagerFactory())
    mgr.create(s.read.parquet(str(tmp_path / "src")), hst.IndexConfig("fIdx", ["k"], []))
    assert any(p.endswith("fIdx") for p in asked)
    assert [e.name for e in mgr.get_indexes([states.ACTIVE])] == ["fIdx"]


def test_a_backend_without_exclusive_create_commits_by_check_then_put_and_warns_once(monkeypatch):
    """A shared-store backend that refuses mode "x" still commits and still
    refuses an existing id, and the non-atomic fallback is warned about once
    per process; a process-local (memory) backend falls back silently."""
    from fsspec.implementations.memory import MemoryFileSystem

    from hyperspace_tpu_torch.storage import remote

    class NoExclusive(MemoryFileSystem):
        protocol = ("shared",)

        def _open(self, path, mode="rb", **kwargs):
            if "x" in mode:
                raise ValueError("mode 'x' not supported")
            return super()._open(path, mode, **kwargs)

    inst = NoExclusive()
    inst.store, inst.pseudo_dirs = {}, [""]
    monkeypatch.setattr(remote, "_occ_fallback_warned", False)
    fs = FsspecFileSystem(inst)
    with pytest.warns(RuntimeWarning, match="NON-ATOMIC"):
        assert fs.atomic_write_text("/lake/idx/_hyperspace_log/0", "a")
    assert not fs.atomic_write_text("/lake/idx/_hyperspace_log/0", "b")
    assert fs.read_text("/lake/idx/_hyperspace_log/0") == "a" and remote._occ_fallback_warned
    NoExclusive.protocol = ("memory",)
    monkeypatch.setattr(remote, "_occ_fallback_warned", False)
    assert fs.atomic_write_text("/lake/idx/_hyperspace_log/1", "c") and not remote._occ_fallback_warned
