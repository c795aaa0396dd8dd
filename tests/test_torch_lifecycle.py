"""The index lifecycle in the port against the JAX package, on real lakes.

Delete, restore, vacuum and cancel run in both packages over one source
(`test_torch_refresh.Twin`). After every transition the two must hold equal
log entries (apart from the timestamp, the warehouse prefix and the index
files' times), the same `indexes()` table (the JAX package's columns in its
order), the same errors for a transition the state does not allow
(`tests/test_actions.py` TestDeleteRestore :201, TestVacuumAction :238,
TestCancelAction :252), and the same rows for a query, which uses the index
exactly while it is ACTIVE. Then the port's own machinery: the TTL metadata
cache (a hit, its expiry, clearing on a mutation), a transient latest entry
read as the stable generation, `_recover_stable`, and `reclaim_orphans` on
a dead writer's staging directory, which the JAX package's `list_orphans`
must name too.
"""

import os
import socket
import time

import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.actions.lifecycle import VacuumAction as JaxVacuum
from hyperspace_tpu.actions.refresh import RefreshAction as JaxRefresh
from hyperspace_tpu.index.builder import CoveringIndexBuilder as JaxBuilder
from hyperspace_tpu.index.data_manager import IndexDataManagerImpl as JaxData
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLog
from hyperspace_tpu.index.staging import list_orphans as jax_list_orphans
from hyperspace_tpu_torch.actions import states
from hyperspace_tpu_torch.actions.lifecycle import VacuumAction
from hyperspace_tpu_torch.actions.refresh import RefreshAction
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index import collection_manager, staging
from hyperspace_tpu_torch.index.builder import CoveringIndexBuilder
from hyperspace_tpu_torch.index.data_manager import IndexDataManagerImpl
from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
from test_torch_refresh import Twin, _host, _src, point

COLUMNS = ["name", "indexedColumns", "includedColumns", "numBuckets", "schema", "indexLocation", "state"]


@pytest.fixture()
def twin(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    src, tw = _src(tmp_path), Twin(tmp_path)
    tw.create(src, "idx", ["k"], ["v"])
    tw.create(src, "other", ["v"], ["k"])
    return tw, src


def indexes_equal(tw):
    """Both `indexes()` tables, equal apart from the warehouse prefix."""
    got = _host(tw.th.indexes())
    want = _host(tw.jh.indexes())
    assert list(got) == list(want) == COLUMNS
    for pkg, table in (("torch", got), ("jax", want)):
        table["indexLocation"] = [p.replace(os.path.join(tw.base, pkg), "<warehouse>") for p in table["indexLocation"]]
    assert got == want
    return got


def check(tw, src, state):
    """After a transition: equal entries in `state`, equal `indexes()`, and a
    point lookup that scans the index exactly when it is ACTIVE."""
    entry = tw.assert_same("idx")
    assert entry["state"] == state
    listed = indexes_equal(tw)
    assert ("idx" in listed["name"]) == (state != states.DOESNOTEXIST)
    if "idx" in listed["name"]:
        assert listed["state"][listed["name"].index("idx")] == state
    plan = tw.t.read.parquet(src).filter(hst.col("k") == 2).select("k", "v").explain_string()
    assert ("index=idx" in plan) == (state == states.ACTIVE), plan
    assert tw.query(point(src, 2)) == {"k": [2], "v": ["b"]}
    return entry


@pytest.mark.parametrize(
    "steps",
    [
        ["delete"],
        ["delete", "restore"],
        ["delete", "vacuum"],
        ["delete", "restore", "delete", "restore"],
    ],
    ids=lambda steps: "-".join(steps),
)
def test_transitions_leave_equal_lakes(twin, steps):
    tw, src = twin
    check(tw, src, states.ACTIVE)
    final = {"delete": states.DELETED, "restore": states.ACTIVE, "vacuum": states.DOESNOTEXIST}
    for step in steps:
        assert tw.both(f"{step}_index", "idx") is None
        entry = check(tw, src, final[step])
    if steps[-1] == "vacuum":
        for pkg in ("torch", "jax"):
            left = sorted(os.listdir(os.path.join(tw.root(pkg), "idx")))
            assert left == ["_hyperspace_log"], left  # every version directory is gone
    assert entry["id"] == 1 + 2 * len(steps)


@pytest.mark.parametrize(
    "steps,refused,message",
    [
        ([], "restore_index", "Restore is only supported in DELETED"),
        ([], "vacuum_index", "Vacuum is only supported in DELETED"),
        ([], "cancel", "Cancel is only supported when index is in transient states"),
        (["delete_index"], "delete_index", "Delete is only supported in ACTIVE"),
        (["delete_index", "vacuum_index"], "restore_index", "Restore is only supported in DELETED"),
        ([], "refresh_index", "could not be found"),
    ],
)
def test_a_transition_the_state_refuses_raises_the_same_error(twin, steps, refused, message):
    tw, src = twin
    for step in steps:
        tw.both(step, "idx")
    name = "missing" if refused == "refresh_index" else "idx"
    kind, msg = tw.both(refused, name)
    assert kind == "HyperspaceException" and message in msg
    if refused != "refresh_index":
        check(tw, src, {0: states.ACTIVE, 1: states.DELETED, 2: states.DOESNOTEXIST}[len(steps)])


def _dead_writer(tw, pkg, kind):
    """The transient entry a writer killed after begin() leaves: a full
    refresh (REFRESHING) or a vacuum (VACUUMING)."""
    path = os.path.join(tw.root(pkg), "idx")
    if pkg == "torch":
        log, data = IndexLogManagerImpl(path), IndexDataManagerImpl(path)
        builder, refresh, vacuum = CoveringIndexBuilder(tw.t), RefreshAction, VacuumAction
    else:
        log, data = JaxLog(path), JaxData(path)
        builder, refresh, vacuum = JaxBuilder(tw.j), JaxRefresh, JaxVacuum
    if kind == "refresh":
        refresh(builder, log, path, os.path.join(path, "v__=7")).begin()
    else:
        vacuum(data, log).begin()


@pytest.mark.parametrize("kind,stable,final", [
    ("refresh", states.ACTIVE, states.ACTIVE),
    ("vacuum", states.DELETED, states.DOESNOTEXIST),
])
def test_cancel_rolls_a_dead_writer_back(twin, kind, stable, final):
    tw, src = twin
    if stable == states.DELETED:
        tw.both("delete_index", "idx")
    for pkg in ("torch", "jax"):
        _dead_writer(tw, pkg, kind)
    t, j = tw.entries("idx")
    assert t["state"] == j["state"] == {"refresh": states.REFRESHING, "vacuum": states.VACUUMING}[kind]
    assert tw.normalized(t, "torch") == tw.normalized(j, "jax")
    # Readers keep the committed generation while the writer's entry is latest.
    listed = indexes_equal(tw)
    assert listed["state"][listed["name"].index("idx")] == stable
    if stable == states.ACTIVE:
        assert "index=idx" in tw.t.read.parquet(src).filter(hst.col("k") == 2).select("v").explain_string()
        tw.query(point(src, 2), "idx")
    assert tw.both("cancel", "idx") is None
    entry = tw.assert_same("idx")
    assert entry["state"] == final and entry["id"] == {states.ACTIVE: 4, states.DELETED: 6}[stable]
    indexes_equal(tw)
    if kind == "refresh":
        # Cancel commits the dead refresh's entry, whose content (its new,
        # never written version directory) is empty: both packages then
        # answer from no index file (ROADMAP.md Queue 3).
        assert entry["content"]["root"]["files"] == []
        assert tw.query(point(src, 2), "idx") == {"k": [], "v": []}


def test_a_transient_first_create_is_recovered_past(tmp_path, monkeypatch):
    """A create killed after begin() leaves only CREATING: the index is not
    listed, and the next create proceeds over it (`_recover_stable` with
    missing_ok); a refresh of an index whose latest entry is a dead refresh
    judges the stable entry and commits past it."""
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    from hyperspace_tpu.actions.create import CreateAction as JaxCreate
    from hyperspace_tpu import IndexConfig as JaxIndexConfig
    from hyperspace_tpu_torch.actions.create import CreateAction

    src, tw = _src(tmp_path), Twin(tmp_path)
    for pkg, create, builder, log, s, cfg in (
        ("torch", CreateAction, CoveringIndexBuilder, IndexLogManagerImpl, tw.t, hst.IndexConfig),
        ("jax", JaxCreate, JaxBuilder, JaxLog, tw.j, JaxIndexConfig),
    ):
        path = os.path.join(tw.root(pkg), "idx")
        create(s.read.parquet(src), cfg("idx", ["k"], ["v"]), builder(s), log(path), path,
               os.path.join(path, "v__=0")).begin()
    assert _host(tw.th.indexes())["name"] == [] == _host(tw.jh.indexes())["name"]
    tw.create(src, "idx", ["k"], ["v"])
    assert tw.assert_same("idx")["id"] == 2
    for pkg in ("torch", "jax"):
        _dead_writer(tw, pkg, "refresh")
    tw.refresh("idx", "full")
    entry = tw.assert_same("idx")
    assert entry["id"] == 5 and entry["state"] == states.ACTIVE
    tw.query(point(src, 3), "idx")


# ---------------------------------------------------------------------------
# The TTL metadata cache
# ---------------------------------------------------------------------------


def test_the_metadata_cache_hits_expires_and_clears_on_a_mutation(tmp_path, monkeypatch):
    src = _src(tmp_path)
    s = hst.HyperspaceSession(warehouse=str(tmp_path / "wh"), device="cpu")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 2)
    hs = hst.Hyperspace(s)
    other = hst.HyperspaceSession(warehouse=str(tmp_path / "wh"), device="cpu")
    other.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 2)
    hs.create_index(s.read.parquet(src), hst.IndexConfig("a", ["k"], ["v"]))
    mgr = hs._manager
    assert isinstance(mgr, collection_manager.CachingIndexCollectionManager)
    assert [e.name for e in mgr.get_indexes()] == ["a"]  # fills the cache
    # Another manager's create is not seen until the entry list expires.
    hst.Hyperspace(other).create_index(other.read.parquet(src), hst.IndexConfig("b", ["v"], ["k"]))
    assert [e.name for e in mgr.get_indexes()] == ["a"]  # a hit
    s.conf.set(hst.IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS, 0)
    time.sleep(0.01)
    assert [e.name for e in mgr.get_indexes()] == ["a", "b"]  # expired, read again
    s.conf.set(hst.IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS, 300)
    assert mgr.get_indexes([states.ACTIVE])[1].state == states.ACTIVE
    hst.Hyperspace(other).delete_index("b")
    assert mgr.get_indexes([states.DELETED]) == []  # still the cached list
    hs.delete_index("a")  # this manager's own mutation clears its cache
    assert sorted(e.name for e in mgr.get_indexes([states.DELETED])) == ["a", "b"]


def test_the_cache_factory_knows_its_policies():
    with pytest.raises(HyperspaceException, match="Unknown index cache type"):
        collection_manager.IndexCacheFactory.create("NOPE", None)
    clock = [0.0]
    cache = collection_manager.CreationTimeBasedIndexCache(lambda: 5)
    real = time.time
    try:
        time.time = lambda: clock[0]
        cache.set(["e"])
        clock[0] = 5.0
        assert cache.get() == ["e"]
        clock[0] = 5.5
        assert cache.get() is None
    finally:
        time.time = real


# ---------------------------------------------------------------------------
# Staging directories of dead writers
# ---------------------------------------------------------------------------


def _dead_pid():
    pid = 4_000_000
    while True:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return pid
        except OSError:
            pass
        pid += 1


def test_reclaim_orphans_deletes_only_dead_writers_staging(twin, monkeypatch):
    tw, src = twin
    path = os.path.join(tw.root("torch"), "idx")
    host = socket.gethostname()
    dead = os.path.join(path, f".staging-v__=1~{host}~{_dead_pid()}~deadbeef")
    live = os.path.join(path, f".staging-v__=1~{host}~{os.getpid()}~cafecafe")
    foreign = os.path.join(path, ".staging-v__=1~some-other-host~12~0badf00d")
    for d in (dead, live, foreign):
        os.makedirs(d)
        open(os.path.join(d, "part-00000.parquet"), "wb").close()
    assert sorted(staging.list_orphans(path)) == sorted(jax_list_orphans(path)) == [dead]
    tw.th.delete_index("idx")  # every action on the index reclaims first
    assert not os.path.exists(dead) and os.path.exists(live) and os.path.exists(foreign)
    monkeypatch.setenv("HYPERSPACE_STAGING_TTL_S", "0")
    time.sleep(0.01)
    assert staging.list_orphans(path) == jax_list_orphans(path) == [foreign]
    tw.th.vacuum_index("idx")
    assert not os.path.exists(foreign) and os.path.exists(live)
    assert staging.reclaim_orphans(path) == 0
    # The inventory never saw any staging directory.
    assert _host(tw.th.indexes())["name"] == ["other"]
