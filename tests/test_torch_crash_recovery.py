"""SIGKILL crash recovery of the port: the five windows of
`tests/test_crash_recovery.py` (:152-160 and :262-275), with the killed child
running `hyperspace_tpu_torch`.

A child process runs one action on the CPU under a `hang` fault aimed at a
window; the parent waits for the window's mark on disk (a staging directory,
or a committed version directory), SIGKILLs the child there, and recovers in
process with the port:

1. `create_index`, killed inside a bucket-file write (`storage.write`);
2. `create_index`, killed at its second log write, after the data directory
   committed and before the final log entry (`log.write:1.0:hang600::1`);
3. an incremental refresh, killed inside a delta bucket-file write;
4. an incremental refresh, killed between its data commit and its log
   commit (`refresh.merge`);
5. `optimize_index`, killed with every compacted bucket staged, before the
   rename (`compact.commit`).

After recovery the latest stable entry is ACTIVE, no staging directory is
left, the next reader answers, and the index files are sha256-identical to
the JAX package's clean build of the same source. Each case waits at most
`_WINDOW_S` seconds for its window and `_CHILD_EXIT_S` for the killed child.
"""

import hashlib
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WINDOW_S = 120.0
_CHILD_EXIT_S = 30.0

_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import hyperspace_tpu_torch as hst

s = hst.HyperspaceSession(warehouse={warehouse!r}, device="cpu")
s.conf.set("hyperspace.system.path", {syspath!r})
s.conf.set("hyperspace.index.num.buckets", "2")
hs = hst.Hyperspace(s)
{action}
print("ACTION DONE", flush=True)
"""

_CREATE = 'hs.create_index(s.read.parquet({src!r}), hst.IndexConfig("idx", ["k"], ["v"]))'


@pytest.fixture(autouse=True)
def _serial(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_BUILD_DECODE_THREADS", "1")
    for k in ("HYPERSPACE_FAULTS", "HYPERSPACE_FAULTS_SEED", "HYPERSPACE_QUERY_TIMEOUT_S"):
        monkeypatch.delenv(k, raising=False)


def _write_source(base, n_files=2, rows=120):
    from hyperspace_tpu_torch.engine import io as eio
    from hyperspace_tpu_torch.engine.table import Table

    src = os.path.join(base, "src")
    for i in range(n_files):
        lo = i * rows
        eio.write_parquet(Table.from_pydict({"k": list(range(lo, lo + rows)), "v": [j % 5 for j in range(lo, lo + rows)]},
                                            "cpu"), os.path.join(src, f"part-{i:05d}.parquet"))
    return src


def _append_batch(src):
    from hyperspace_tpu_torch.engine import io as eio
    from hyperspace_tpu_torch.engine.table import Table

    eio.write_parquet(Table.from_pydict({"k": [9001, 9002, 9003], "v": [1, 2, 3]}, "cpu"),
                      os.path.join(src, "part-00009.parquet"))


def _session(base, syspath):
    import hyperspace_tpu_torch as hst

    s = hst.HyperspaceSession(warehouse=base, device="cpu")
    s.conf.set("hyperspace.system.path", syspath)
    s.conf.set("hyperspace.index.num.buckets", "2")
    return s, hst.Hyperspace(s)


def _jax_clean_shas(base, src) -> dict:
    """The JAX package's from-scratch build of `src`: basename → sha256."""
    from hyperspace_tpu import Hyperspace, IndexConfig
    from hyperspace_tpu.engine.session import HyperspaceSession

    syspath = os.path.join(base, "indexes_jax_clean")
    s = HyperspaceSession(warehouse=base)
    s.conf.set("hyperspace.system.path", syspath)
    s.conf.set("hyperspace.index.num.buckets", "2")
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(src), IndexConfig("idx", ["k"], ["v"]))
    entry = [e for e in hs._manager.get_indexes() if e.name == "idx"][0]
    return _shas(entry.content.files())


def _shas(paths) -> dict:
    return {os.path.basename(p): hashlib.sha256(open(p, "rb").read()).hexdigest() for p in paths}


def _wait_for(predicate, what):
    t0 = time.monotonic()
    while time.monotonic() - t0 < _WINDOW_S:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _kill_in_window(base, syspath, action, fault_spec, ready):
    env = dict(os.environ)
    env.update({"HYPERSPACE_BUILD_DECODE_THREADS": "1", "HYPERSPACE_FAULTS": fault_spec, "PYTHONPATH": REPO})
    script = _CHILD.format(repo=REPO, warehouse=base, syspath=syspath, action=action)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        _wait_for(lambda: ready() or proc.poll() is not None, "the kill window")
        time.sleep(0.3)  # let the child reach, and block inside, the hang
        assert proc.poll() is None, (
            "child finished before the kill window: " + proc.stdout.read().decode() + proc.stderr.read().decode()
        )
    finally:
        proc.kill()  # SIGKILL: no handlers, no cleanup
        proc.wait(timeout=_CHILD_EXIT_S)


def _staging_in(idx_path):
    from hyperspace_tpu_torch.index.staging import STAGING_PREFIX

    return lambda: os.path.isdir(idx_path) and any(n.startswith(STAGING_PREFIX) for n in os.listdir(idx_path))


def _assert_recovered(s, hs, idx_path, src, clean, probe):
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import physical, scan_cache
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
    from hyperspace_tpu_torch.index.staging import STAGING_PREFIX

    assert [n for n in os.listdir(idx_path) if n.startswith(STAGING_PREFIX)] == []
    stable = IndexLogManagerImpl(idx_path).get_latest_stable_log()
    assert stable is not None and stable.state == "ACTIVE"
    entry = [e for e in hs._manager.get_indexes() if e.name == "idx"][0]
    assert _shas(entry.content.files()) == clean
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    hst.enable_hyperspace(s)
    key, value = probe
    assert s.read.parquet(src).filter(hst.col("k") == key).select("k", "v").collect().rows() == [(key, value)]


@pytest.mark.parametrize("fault_spec,window", [
    ("storage.write:1.0:hang600", "staging"),  # inside a bucket-file write
    ("log.write:1.0:hang600::1", "vdir"),  # data committed, final log entry not
], ids=["bucket-write", "final-log-write"])
def test_sigkill_mid_build_is_recoverable(tmp_path, fault_spec, window):
    base = str(tmp_path)
    src = _write_source(base)
    clean = _jax_clean_shas(base, src)
    syspath = os.path.join(base, "indexes_kill")
    idx_path = os.path.join(syspath, "idx")
    ready = _staging_in(idx_path) if window == "staging" else (lambda: os.path.isdir(os.path.join(idx_path, "v__=0")))
    _kill_in_window(base, syspath, _CREATE.format(src=src), fault_spec, ready)
    s, hs = _session(base, syspath)
    hs.create_index(s.read.parquet(src), __import__("hyperspace_tpu_torch").IndexConfig("idx", ["k"], ["v"]))
    _assert_recovered(s, hs, idx_path, src, clean, (7, 2))


@pytest.mark.parametrize("action,fault_spec,window", [
    ('hs.refresh_index("idx", mode="incremental")', "storage.write:1.0:hang600", "staging"),
    ('hs.refresh_index("idx", mode="incremental")', "refresh.merge:1.0:hang600", "vdir1"),
    ('hs.optimize_index("idx")', "compact.commit:1.0:hang600", "staging"),
], ids=["delta-write", "refresh-merge", "compact-commit"])
def test_sigkill_live_table_windows_recover(tmp_path, action, fault_spec, window):
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import physical, scan_cache

    base = str(tmp_path)
    src = _write_source(base)
    syspath = os.path.join(base, "indexes_live")
    idx_path = os.path.join(syspath, "idx")
    s, hs = _session(base, syspath)
    hs.create_index(s.read.parquet(src), hst.IndexConfig("idx", ["k"], ["v"]))
    _append_batch(src)
    if action.startswith("hs.optimize"):
        hs.refresh_index("idx", mode="incremental")  # compaction needs delta files
    ready = _staging_in(idx_path) if window == "staging" else (lambda: os.path.isdir(os.path.join(idx_path, "v__=1")))
    _kill_in_window(base, syspath, action, fault_spec, ready)

    # The next reader stays on a consistent generation.
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    hs._manager.clear_cache()
    hst.enable_hyperspace(s)
    assert s.read.parquet(src).filter(hst.col("k") == 7).select("k", "v").collect().rows() == [(7, 2)]
    # The next refresher and compactor recover, and compaction converges.
    hs._manager.clear_cache()
    if action.startswith("hs.refresh"):
        hs.refresh_index("idx", mode="incremental")
    hs.optimize_index("idx")
    _assert_recovered(s, hs, idx_path, src, _jax_clean_shas(base, src), (9002, 2))
