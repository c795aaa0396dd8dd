"""The port's replica fleet against the JAX package's (`tests/test_replicas.py`
run on the port, and the two packages in one registry).

- Off (`HYPERSPACE_REPLICAS` unset or 0), every hook passes through.
- The registry: join, heartbeat, leave; a dead same-host entry is reclaimed
  by rename, a foreign one lives by its mtime TTL.
- `owner_of` equals the JAX package's over seeded member lists and keys.
- Cross-package: a JAX entry and a port entry in one registry list each
  other; an epoch published by either flips the other's
  `check_invalidation`; a lease either writes the other reads, and breaks
  when its holder is dead.
- The lease serializes foreign decodes, an owned decode takes none, and
  engine answers are the same with the fleet on and off.
- Budgets are apportioned over the live members and rebalance when a member
  leaves; a SIGKILLed port replica (a plain subprocess importing only the
  port) is reclaimed, and the ring and the budget rebalance.
- The replica id rides the ledger, the exporter frame, the Prometheus text
  and the history envelope, which `tools/hsreport.py` splits by replica.
"""

import importlib.util
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import hyperspace_tpu_torch as hst
from hyperspace_tpu.serve import replicas as JR
from hyperspace_tpu_torch.engine import physical, scan_cache
from hyperspace_tpu_torch.exceptions import AdmissionRejectedError
from hyperspace_tpu_torch.serve import QueryServer
from hyperspace_tpu_torch.serve import replicas as R
from hyperspace_tpu_torch.serve.admission import AdmissionController
from hyperspace_tpu_torch.telemetry import accounting, slo

HOST = socket.gethostname()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fleet_state(monkeypatch):
    """Every test starts fleet-off and unjoined in both packages, with a
    fresh id and fast knobs."""
    for k in (R.ENV_REPLICAS, R.ENV_REPLICA_DIR):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(R.ENV_VIEW_S, "0")
    monkeypatch.setenv(R.ENV_EPOCH_CHECK_S, "0")
    monkeypatch.setenv(R.ENV_HEARTBEAT_S, "0.05")
    monkeypatch.setenv("HYPERSPACE_DISTRIBUTED", "0")
    R._reset_for_tests()
    JR._reset_for_tests()
    yield
    R._reset_for_tests()
    JR._reset_for_tests()
    # The served queries' lanes and tenants must not ride later frames.
    slo.reset()
    accounting.reset_tenant_rollup()
    accounting.drain_pending()


def _fleet_on(monkeypatch, tmp_path) -> str:
    d = str(tmp_path / "registry")
    monkeypatch.setenv(R.ENV_REPLICAS, "1")
    monkeypatch.setenv(R.ENV_REPLICA_DIR, d)
    return d


def _fake_member(reg: str, rid: str, host: str = "elsewhere", pid: int = 1234) -> str:
    """A registry entry of a pretend replica on another host (a fresh mtime:
    live under the foreign-host TTL)."""
    os.makedirs(reg, exist_ok=True)
    path = os.path.join(reg, f"{R.REPLICA_PREFIX}{rid}.json")
    with open(path, "w") as f:
        json.dump({"replica_id": rid, "host": host, "pid": pid}, f)
    return path


def _foreign_key(members, me):
    return next(f"file{i}" for i in range(200) if R.owner_of(f"file{i}", members) != me)


# ---------------------------------------------------------------------------
# Off, and the registry
# ---------------------------------------------------------------------------


def test_fleet_off_is_an_exact_passthrough(tmp_path, monkeypatch):
    assert not R.fleet_enabled() and not R.joined()
    calls = []
    assert R.coordinate_decode("k", lambda: calls.append(1) or 41) == 41 and calls == [1]
    assert R.owns("anything", ["somebody-else"]) and R.apportioned_budget(7) == 7
    assert R.check_invalidation({}) is False
    R.publish_invalidation("idx", 3, str(tmp_path / "reg"))
    assert not os.path.exists(tmp_path / "reg")
    monkeypatch.setenv(R.ENV_REPLICAS, "0")
    assert not R.fleet_enabled()
    monkeypatch.setenv(R.ENV_REPLICAS, "1")
    assert R.fleet_enabled()


def test_join_heartbeat_and_leave(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    rid = R.join_fleet()
    assert R.joined() and R.join_fleet() == rid
    entry = os.path.join(reg, f"{R.REPLICA_PREFIX}{rid}.json")
    with open(entry) as f:
        doc = json.load(f)
    assert (doc["replica_id"], doc["host"], doc["pid"]) == (rid, HOST, os.getpid())
    assert R.live_replicas(refresh=True) == [rid]
    m0 = os.stat(entry).st_mtime_ns
    deadline = time.time() + 5
    while os.stat(entry).st_mtime_ns == m0:
        assert time.time() < deadline, "the heartbeat never beat"
        time.sleep(0.02)
    R.leave_fleet()
    assert not R.joined() and not os.path.exists(entry)


def test_the_replica_id_parses_from_its_entry_name(monkeypatch, tmp_path):
    _fleet_on(monkeypatch, tmp_path)
    rid = R.replica_id()
    assert rid == R.replica_id() and rid.startswith(f"{HOST}-{os.getpid()}-")
    assert R._owner_of(f"{R.REPLICA_PREFIX}{rid}.json") == (HOST, os.getpid())
    assert JR._owner_of(f"{R.REPLICA_PREFIX}{rid}.json") == (HOST, os.getpid())


def test_a_dead_same_host_entry_is_reclaimed(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    rid = R.join_fleet()
    dead = _fake_member(reg, f"{HOST}-999999-deadbeef", host=HOST, pid=999999)
    assert R.live_replicas(refresh=True) == [rid]
    assert not os.path.exists(dead)
    assert not [n for n in os.listdir(reg) if n.startswith(R.CLAIMED_PREFIX)]


def test_a_foreign_entry_lives_by_its_ttl(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    monkeypatch.setenv(R.ENV_TTL_S, "30")
    rid = R.join_fleet()
    fresh = _fake_member(reg, "elsewhere-1-aaaaaaaa")
    stale = _fake_member(reg, "elsewhere-2-bbbbbbbb")
    old = time.time() - 3600
    os.utime(stale, (old, old))
    view = R.live_replicas(refresh=True)
    assert "elsewhere-1-aaaaaaaa" in view and rid in view and "elsewhere-2-bbbbbbbb" not in view
    assert os.path.exists(fresh) and not os.path.exists(stale)


def test_an_orphaned_claim_of_a_dead_claimant_is_swept(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    R.join_fleet()
    orphan = os.path.join(reg, f"{R.CLAIMED_PREFIX}{HOST}~999999~{R.REPLICA_PREFIX}x-1-0.json")
    with open(orphan, "w") as f:
        f.write("{}")
    R.live_replicas(refresh=True)
    assert not os.path.exists(orphan)


# ---------------------------------------------------------------------------
# Rendezvous ownership against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_owner_of_equals_the_jax_packages(seed):
    rng = random.Random(seed)
    members = [f"host{rng.randint(0, 9)}-{rng.randint(1, 99999)}-{rng.getrandbits(32):08x}"
               for _ in range(rng.randint(1, 6))]
    keys = [f"/lake/idx/v__=0/part-{rng.randint(0, 199):05d}-{i}.parquet" for i in range(300)]
    assert [R.owner_of(k, members) for k in keys] == [JR.owner_of(k, members) for k in keys]
    assert R.owner_of("k", []) is None and JR.owner_of("k", []) is None


def test_rendezvous_is_stable_balanced_and_moves_only_a_leavers_keys():
    members = ["a", "b", "c"]
    keys = [f"key{i}" for i in range(300)]
    owners = {k: R.owner_of(k, members) for k in keys}
    counts = {m: sum(1 for o in owners.values() if o == m) for m in members}
    assert all(c > len(keys) // 6 for c in counts.values()), counts
    for k in keys:
        new = R.owner_of(k, ["a", "c"])
        assert new == owners[k] if owners[k] != "b" else new in ("a", "c")


# ---------------------------------------------------------------------------
# Cross-package: one registry, one epoch file, one lease namespace
# ---------------------------------------------------------------------------


def test_a_jax_entry_and_a_port_entry_list_each_other(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    rid, jrid = R.join_fleet(), JR.join_fleet()
    assert rid != jrid
    assert R.live_replicas(refresh=True) == JR.live_replicas(refresh=True) == sorted([rid, jrid])
    keys = [f"file{i}" for i in range(100)]
    members = R.live_replicas()
    assert [R.owner_of(k) for k in keys] == [JR.owner_of(k) for k in keys]
    assert {R.owner_of(k, members) for k in keys} == {rid, jrid}
    assert R.apportioned_budget(4) == JR.apportioned_budget(4) == 2
    JR.leave_fleet()
    assert R.live_replicas(refresh=True) == [rid]
    assert R.apportioned_budget(4) == 4
    assert sorted(os.listdir(reg)) == [f"{R.REPLICA_PREFIX}{rid}.json"]


@pytest.mark.parametrize("publisher", ["torch", "jax"])
def test_an_epoch_published_by_either_package_flips_the_other(monkeypatch, tmp_path, publisher):
    reg = _fleet_on(monkeypatch, tmp_path)
    R.join_fleet()
    JR.join_fleet()
    pub, sub = (R, JR) if publisher == "torch" else (JR, R)
    cursor, own = {}, {}
    assert sub.check_invalidation(cursor, reg) is False  # primed at the join
    assert pub.check_invalidation(own, reg) is False
    pub.publish_invalidation("myIdx", 7, reg)
    assert sub.read_epoch(reg)["entries"] == {"myIdx": 7} and sub.read_epoch(reg)["epoch"] == 1
    assert sub.check_invalidation(cursor, reg) is True
    assert sub.check_invalidation(cursor, reg) is False  # consumed
    sub.publish_invalidation("other", 3, reg)
    doc = pub.read_epoch(reg)
    assert doc["epoch"] == 2 and doc["entries"] == {"myIdx": 7, "other": 3}
    assert pub.check_invalidation(own, reg) is True


@pytest.mark.parametrize("holder", ["torch", "jax"])
def test_lease_files_are_read_across_packages(monkeypatch, tmp_path, holder):
    reg = _fleet_on(monkeypatch, tmp_path)
    R.join_fleet()
    _fake_member(reg, "zzzz-1-ffffffff")  # owns most keys: decodes take the lease
    members = R.live_replicas(refresh=True)
    key = _foreign_key(members, R.replica_id())
    assert R._lease_path(reg, key) == JR._lease_path(reg, key)
    path = R._lease_path(reg, key)
    hold, reader = (R, JR) if holder == "torch" else (JR, R)
    JR.join_fleet()
    members = R.live_replicas(refresh=True)
    assert len(members) == 3 and JR.live_replicas(refresh=True) == members
    # A key the third member owns: both packages' replicas decode it foreign.
    key = next(f"file{i}" for i in range(300) if R.owner_of(f"file{i}", members) == "zzzz-1-ffffffff")
    path = R._lease_path(reg, key)
    inside, release = threading.Event(), threading.Event()
    t = threading.Thread(target=lambda: hold.coordinate_decode(key, lambda: (inside.set(), release.wait(10))))
    t.start()
    assert inside.wait(10) and os.path.exists(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["host"] == HOST and doc["pid"] == os.getpid()
    assert reader._lease_holder_dead(path) is False  # a live same-host pid
    release.set()
    t.join(10)
    assert not os.path.exists(path)
    # A lease the other package wrote for a dead pid is broken, not waited out.
    with open(path, "w") as f:
        json.dump({"host": HOST, "pid": 999999}, f)
    t0 = time.time()
    assert reader._lease_holder_dead(path) is True
    assert R.coordinate_decode(key, lambda: "ok") == "ok" and time.time() - t0 < 5
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# Decode coordination and the engine
# ---------------------------------------------------------------------------


def test_foreign_decodes_serialize_under_the_lease(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    R.join_fleet()
    _fake_member(reg, "zzzz-1-ffffffff")
    members = R.live_replicas(refresh=True)
    assert len(members) == 2
    key = _foreign_key(members, R.replica_id())
    inflight, overlaps, results = [0], [0], []

    def attempt():
        inflight[0] += 1
        overlaps[0] = max(overlaps[0], inflight[0])
        time.sleep(0.05)
        inflight[0] -= 1
        return "bytes"

    ts = [threading.Thread(target=lambda: results.append(R.coordinate_decode(key, attempt))) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(15)
    assert results == ["bytes"] * 3 and overlaps[0] == 1
    assert R.fleet_stats()["live"] == 2
    assert not [n for n in os.listdir(reg) if n.startswith(R.LEASE_PREFIX)]


def test_an_owned_decode_takes_no_lease(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    R.join_fleet()
    _fake_member(reg, "aaaa-1-00000000")
    members = R.live_replicas(refresh=True)
    key = next(f"file{i}" for i in range(200) if R.owner_of(f"file{i}", members) == R.replica_id())
    seen = []

    def attempt():
        seen.extend(n for n in os.listdir(reg) if n.startswith(R.LEASE_PREFIX))
        return 1

    assert R.coordinate_decode(key, attempt) == 1 and seen == []


def test_engine_answers_equal_with_the_fleet_on_and_off(monkeypatch, tmp_path):
    wh = str(tmp_path / "wh")
    s = hst.HyperspaceSession(warehouse=wh, device="cpu")
    rng = np.random.RandomState(3)
    for i in range(3):
        s.write_parquet({"k": rng.randint(0, 50, 700).astype(np.int64), "v": rng.rand(700)},
                        os.path.join(wh, "t", f"part-{i:05d}"))
    q = lambda: s.read.parquet(os.path.join(wh, "t")).filter(hst.col("k") == 7).select("k", "v").collect().rows()
    scan_cache.clear_scan_caches()
    oracle = q()
    reg = _fleet_on(monkeypatch, tmp_path)
    R.join_fleet()
    _fake_member(reg, "zzzz-1-ffffffff")  # wins most files: decodes take the lease path
    R.live_replicas(refresh=True)
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    before = R._LEASE_ACQUIRED.value + R._ROUTE_OWNED.value
    assert q() == oracle
    assert R._LEASE_ACQUIRED.value + R._ROUTE_OWNED.value - before == 3  # each file routed once
    assert not [n for n in os.listdir(reg) if n.startswith(R.LEASE_PREFIX)]


def test_an_index_cache_flips_on_a_peers_mutation_with_no_ttl_wait(monkeypatch, tmp_path):
    from hyperspace_tpu.engine import HyperspaceSession as JaxSession
    from hyperspace_tpu.hyperspace import Hyperspace as JaxHyperspace

    _fleet_on(monkeypatch, tmp_path)
    R.join_fleet()
    JR.join_fleet()
    wh = str(tmp_path / "wh")
    s_a = hst.HyperspaceSession(warehouse=wh, device="cpu")
    s_b = hst.HyperspaceSession(warehouse=wh, device="cpu")
    hs_a, hs_b = hst.Hyperspace(s_a), hst.Hyperspace(s_b)
    s_a.write_parquet({"k": np.arange(200, dtype=np.int64), "v": np.arange(200, dtype=np.int64)},
                      os.path.join(wh, "t"))
    hs_a.create_index(s_a.read.parquet(os.path.join(wh, "t")), hst.IndexConfig("fleetIdx", ["k"], ["v"]))

    def states(hs):
        t = hs.indexes()
        return dict(zip(t.column("name").decode_objects(), t.column("state").decode_objects()))

    assert states(hs_b)["fleetIdx"] == "ACTIVE"  # B caches the post-create state
    hs_a.delete_index("fleetIdx")
    assert states(hs_b)["fleetIdx"] != "ACTIVE"
    # A JAX replica's mutation flips the port's cache too.
    hs_a.restore_index("fleetIdx")
    assert states(hs_b)["fleetIdx"] == "ACTIVE"
    JaxHyperspace(JaxSession(warehouse=wh)).delete_index("fleetIdx")
    assert states(hs_b)["fleetIdx"] != "ACTIVE"


# ---------------------------------------------------------------------------
# Fleet admission and a killed replica
# ---------------------------------------------------------------------------


def test_budgets_are_apportioned_and_rebalanced(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    R.join_fleet()
    assert R.apportioned_budget(4) == 4
    fake = _fake_member(reg, "elsewhere-1-aaaaaaaa")
    R.live_replicas(refresh=True)
    assert (R.apportioned_budget(4), R.apportioned_budget(3), R.apportioned_budget(1)) == (2, 2, 1)
    ac = AdmissionController(queue_depth=8, tenant_budget=2)
    assert ac.effective_tenant_budget() == 1
    ac.admit("t1")
    with pytest.raises(AdmissionRejectedError, match="fleet share") as ei:
        ac.admit("t1")
    assert ei.value.reason == "tenant_budget" and ac.stats()["tenant_budget_fleet_share"] == 1
    os.unlink(fake)
    R.live_replicas(refresh=True)
    assert R.apportioned_budget(4) == 4 and ac.effective_tenant_budget() == 2


_CHILD = """
import os, sys, time
sys.path.insert(0, {repo!r})
from hyperspace_tpu_torch.serve import replicas as R
assert "hyperspace_tpu" not in sys.modules and "jax" not in sys.modules
print(R.join_fleet(), flush=True)
time.sleep(120)
"""


def test_a_sigkilled_port_replica_is_reclaimed_and_the_ring_and_budget_rebalance(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    rid = R.join_fleet()
    env = dict(os.environ, **{R.ENV_REPLICAS: "1", R.ENV_REPLICA_DIR: reg})
    p = subprocess.Popen([sys.executable, "-c", _CHILD.format(repo=REPO)], env=env, stdout=subprocess.PIPE,
                         text=True)
    try:
        victim = p.stdout.readline().strip()
        assert victim and victim != rid
        deadline = time.time() + 30
        while set(R.live_replicas(refresh=True)) != {rid, victim}:
            assert time.time() < deadline, R.live_replicas(refresh=True)
            time.sleep(0.05)
        keys = [f"file{i}" for i in range(100)]
        before = {k: R.owner_of(k, [rid, victim]) for k in keys}
        assert victim in before.values() and R.apportioned_budget(4) == 2
        p.send_signal(signal.SIGKILL)
        p.wait(10)
        deadline = time.time() + 20
        while R.live_replicas(refresh=True) != [rid]:
            assert time.time() < deadline
            time.sleep(0.05)
        names = os.listdir(reg)
        assert not [n for n in names if victim in n] and not [n for n in names if n.startswith(R.CLAIMED_PREFIX)]
        assert all(R.owner_of(k, R.live_replicas()) == rid for k in keys)
        assert R.apportioned_budget(4) == 4
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(10)


# ---------------------------------------------------------------------------
# The replica id on every surface
# ---------------------------------------------------------------------------


def test_the_replica_id_rides_ledger_frame_prometheus_and_history(monkeypatch, tmp_path):
    from hyperspace_tpu_torch.telemetry import accounting, exporter, history

    rid = R.replica_id()
    wh = str(tmp_path / "wh")
    s = hst.HyperspaceSession(warehouse=wh, device="cpu")
    s.write_parquet({"k": np.arange(10, dtype=np.int64)}, os.path.join(wh, "t"))
    with QueryServer(max_concurrent=2) as srv:
        srv.run(lambda: s.read.parquet(os.path.join(wh, "t")).collect(), tenant="stamp-test")
    led = [x for x in accounting.drain_pending() if x.get("tenant") == "stamp-test"]
    assert led and all(x["replica_id"] == rid for x in led)
    assert exporter.MetricsExporter(str(tmp_path / "m.jsonl"), 60.0)._frame()["replica_id"] == rid
    text = exporter.prometheus_text()
    assert f'hyperspace_replica_info{{replica_id="{rid}",host="{HOST}",pid="{os.getpid()}"}} 1' in text
    store = history.HistoryStore(str(tmp_path / "hist"), compact_on_open=False)
    store.record("fp1", {"wall_s": 0.1})
    store.close()
    assert next(iter(history.iter_records(str(tmp_path / "hist"))))["replica_id"] == rid


def _hsreport():
    spec = importlib.util.spec_from_file_location("torch_test_hsreport_fleet", os.path.join(REPO, "tools",
                                                                                            "hsreport.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_history_renders_in_hsreports_fleet_split(tmp_path):
    from hyperspace_tpu_torch.telemetry import history

    hsreport = _hsreport()
    hist = str(tmp_path / "hist")
    store = history.HistoryStore(hist, compact_on_open=False)
    for wall in (0.2, 0.3, 0.5):
        store.record("f1", {"fingerprint": "f1", "wall_s": wall, "label": "query:collect", "lane": "batch"})
    store.close()
    report = hsreport.build_report(hist, 5, 5)
    fleet = report["replicas"]
    assert fleet["fleet"]["records"] == 3 and list(fleet["replicas"]) == [R.replica_id()]
    assert fleet["replicas"][R.replica_id()]["slo"]["batch"]["total"] == 3
    assert "replica fleet" in hsreport.render(report)


# ---------------------------------------------------------------------------
# The server as the replica
# ---------------------------------------------------------------------------


def test_a_server_joins_the_fleet_and_reports_it(monkeypatch, tmp_path):
    reg = _fleet_on(monkeypatch, tmp_path)
    with QueryServer(max_concurrent=2) as srv:
        assert R.joined()
        st = srv.stats()["replicas"]
        assert st["live"] == 1 and st["replica_id"] == R.replica_id() and st["registry_dir"] == reg
        assert os.listdir(reg)


def test_a_server_off_the_fleet_makes_no_registry(tmp_path, monkeypatch):
    monkeypatch.setenv(R.ENV_REPLICA_DIR, str(tmp_path / "reg"))
    with QueryServer(max_concurrent=2) as srv:
        assert not R.joined() and "replicas" not in srv.stats()
    assert not os.path.exists(tmp_path / "reg")
