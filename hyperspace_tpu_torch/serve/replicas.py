"""The replica fleet: several server processes over one lake (counterpart
of `hyperspace_tpu/serve/replicas.py`: the same file names, JSON fields,
env knobs, rendezvous hash and metric names, so a port replica and a JAX
replica in one registry list each other and agree on every owner).

The fleet coordinates through files on the lake, with no service beside it:

- Registry (`<warehouse>/.hyperspace_replicas`, or
  `HYPERSPACE_REPLICA_DIR`): one heartbeat file a replica,
  `replica-<host>-<pid>-<uuid8>.json`, rewritten (tmp + `os.replace`) every
  `HYPERSPACE_REPLICA_HEARTBEAT_S` by a daemon thread. A same-host entry
  lives while its pid does (`util.procs.pid_alive`); a foreign-host entry
  until its mtime is older than `HYPERSPACE_REPLICA_TTL_S`. A dead entry is
  reclaimed by renaming it to `.claimed-<host>~<pid>~<name>` (the rename
  picks one winner among racing reclaimers) and unlinking it;
  `_sweep_orphaned_claims` removes the claims of dead claimants.
- Invalidation (`epoch.json`): a mutation committed by any replica merges
  `{index: log_entry_id}` into the document and bumps `epoch`; every
  caching index manager polls the file's (mtime_ns, size, inode), at most
  once every `HYPERSPACE_REPLICA_EPOCH_CHECK_S`, and drops its cached
  entries when it moved: no TTL wait.
- Cold-file routing and the decode lease: rendezvous hashing (sha256 of
  `member|key`, the highest wins) gives every lake file one owner among the
  live members. An owned file decodes directly; a foreign cold file first
  takes the lease file `lease-<sha256(key)[:16]>.json` (O_CREAT|O_EXCL), so
  the replicas that do not own a file read it one at a time, and a lease
  whose holder died is broken by the registry's liveness rules. Each
  replica still decodes into its own caches: the answers are the same.
- Fleet admission: a tenant budget is the fleet's; each replica enforces
  ceil(budget / live replicas) (`apportioned_budget`).

`HYPERSPACE_REPLICAS` unset or `0` is the exact single-process fallback:
every hook is one env read and a no-op (no registry, no stat, no lease).

Metrics: the `replicas.live` gauge, `replicas.reclaimed`,
`replicas.route.owned` / `replicas.route.foreign`,
`replicas.lease.acquired` / `replicas.lease.waited` /
`replicas.lease.broken`, `replicas.invalidations.published` /
`replicas.invalidations.observed`.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import socket
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

from .. import resilience as _resilience
from ..telemetry import metrics as _metrics
from ..util.procs import pid_alive

ENV_REPLICAS = "HYPERSPACE_REPLICAS"
ENV_REPLICA_DIR = "HYPERSPACE_REPLICA_DIR"
ENV_HEARTBEAT_S = "HYPERSPACE_REPLICA_HEARTBEAT_S"
ENV_TTL_S = "HYPERSPACE_REPLICA_TTL_S"
ENV_VIEW_S = "HYPERSPACE_REPLICA_VIEW_S"
ENV_EPOCH_CHECK_S = "HYPERSPACE_REPLICA_EPOCH_CHECK_S"
ENV_LEASE_TTL_S = "HYPERSPACE_REPLICA_LEASE_TTL_S"

_DEFAULT_HEARTBEAT_S = 1.0
#: Foreign-host liveness horizon (same-host entries are pid-checked and
#: never wait this out). Generous vs the heartbeat so one slow NFS write
#: cannot evict a live peer.
_DEFAULT_TTL_S = 15.0
#: Live-member view refresh period: membership changes (and the budget
#: shares / routing ring derived from them) are visible within this.
_DEFAULT_VIEW_S = 0.25
#: Invalidation poll rate limit: one os.stat per this interval bounds the
#: read-path cost of cross-replica cache coherence.
_DEFAULT_EPOCH_CHECK_S = 0.05
#: A lease whose holder stopped heartbeating its mtime for this long is
#: breakable even cross-host (same-host holders are pid-checked).
_DEFAULT_LEASE_TTL_S = 30.0

REPLICA_PREFIX = "replica-"
CLAIMED_PREFIX = ".claimed-"
LEASE_PREFIX = "lease-"
EPOCH_FILE = "epoch.json"
_TMP_PREFIX = ".tmp-"

#: Follower wake-up slice while waiting on a foreign decode lease (the
#: singleflight module's cadence: long enough to cost nothing, short
#: enough that a query deadline is honored promptly).
_LEASE_WAIT_SLICE_S = 0.05

_LIVE = _metrics.gauge("replicas.live")
_RECLAIMED = _metrics.counter("replicas.reclaimed")
_ROUTE_OWNED = _metrics.counter("replicas.route.owned")
_ROUTE_FOREIGN = _metrics.counter("replicas.route.foreign")
_LEASE_ACQUIRED = _metrics.counter("replicas.lease.acquired")
_LEASE_WAITED = _metrics.counter("replicas.lease.waited")
_LEASE_BROKEN = _metrics.counter("replicas.lease.broken")
_INVAL_PUBLISHED = _metrics.counter("replicas.invalidations.published")
_INVAL_OBSERVED = _metrics.counter("replicas.invalidations.observed")


def fleet_enabled() -> bool:
    """One env read: the fleet hot-path gate. Unset/``0`` = exact
    single-process fallback (the standing flag contract)."""
    return os.environ.get(ENV_REPLICAS, "0") not in ("", "0")


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    try:
        return max(lo, float(os.environ.get(name, "") or default))
    except ValueError:
        return default


def heartbeat_s() -> float:
    return _env_float(ENV_HEARTBEAT_S, _DEFAULT_HEARTBEAT_S, 0.05)


def ttl_s() -> float:
    return _env_float(ENV_TTL_S, _DEFAULT_TTL_S, 0.0)


def view_s() -> float:
    return _env_float(ENV_VIEW_S, _DEFAULT_VIEW_S, 0.0)


def epoch_check_s() -> float:
    return _env_float(ENV_EPOCH_CHECK_S, _DEFAULT_EPOCH_CHECK_S, 0.0)


def lease_ttl_s() -> float:
    return _env_float(ENV_LEASE_TTL_S, _DEFAULT_LEASE_TTL_S, 0.0)


def registry_dir(warehouse: Optional[str] = None) -> str:
    """The on-lake registry location: ``HYPERSPACE_REPLICA_DIR`` when set,
    else ``<warehouse>/.hyperspace_replicas`` (next to the index logs and
    the history store — all metadata lives ON THE LAKE), else the active
    session's warehouse, else the cwd."""
    env = os.environ.get(ENV_REPLICA_DIR)
    if env:
        return env
    if warehouse is None:
        try:
            from ..engine.session import HyperspaceSession

            sess = HyperspaceSession._active
            if sess is not None:
                warehouse = sess.warehouse
        except Exception:
            pass
    return os.path.join(warehouse or ".", ".hyperspace_replicas")


# ---------------------------------------------------------------------------
# Identity
# ---------------------------------------------------------------------------

_id_lock = threading.Lock()
_replica_id: Optional[str] = None


def replica_id() -> str:
    """This process's stable fleet identity: ``<host>-<pid>-<uuid8>``, minted
    once per process. Available fleet-on or -off — exporter frames, closed
    ledgers, and Prometheus info series stamp it unconditionally so fleet
    dashboards can attribute a segment even before (or without) a join."""
    global _replica_id
    if _replica_id is None:
        with _id_lock:
            if _replica_id is None:
                _replica_id = (
                    f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
                )
    return _replica_id


def _owner_of(name: str) -> Tuple[Optional[str], int]:
    """(host, pid) from a ``replica-<host>-<pid>-<uuid8>.json`` name — hosts
    may contain '-', so parse from the RIGHT (the history-segment rule)."""
    stem = name[: -len(".json")] if name.endswith(".json") else name
    parts = stem.split("-")
    try:
        return "-".join(parts[1:-2]) or None, int(parts[-2])
    except (IndexError, ValueError):
        return None, -1


def _claim_parts(name: str) -> Tuple[Optional[str], int, Optional[str]]:
    rest = name[len(CLAIMED_PREFIX):]
    parts = rest.split("~", 2)
    if len(parts) != 3:
        return None, -1, None
    try:
        return parts[0], int(parts[1]), parts[2]
    except ValueError:
        return None, -1, None


def _entry_alive(name: str, path: str) -> bool:
    """The two-rule liveness scheme shared with history segments: same-host
    entries are pid-checked; foreign/unparseable entries live until their
    heartbeat mtime ages past the TTL (0 disables foreign reclaim)."""
    host, pid = _owner_of(name)
    if host == socket.gethostname():
        return pid_alive(pid)
    try:
        ttl = ttl_s()
        return ttl <= 0 or time.time() - os.stat(path).st_mtime <= ttl
    except OSError:
        return False  # vanished: a racing reclaim won


def _reclaim_entry(dir_path: str, name: str) -> bool:
    """Claim-by-rename one dead entry: atomic rename arbitrates racing
    reclaimers (losers get FileNotFoundError and skip), the winner unlinks.
    Returns True when THIS process won the claim."""
    claim = os.path.join(
        dir_path,
        f"{CLAIMED_PREFIX}{socket.gethostname()}~{os.getpid()}~{name}",
    )
    try:
        os.rename(os.path.join(dir_path, name), claim)
    except OSError:
        return False  # lost the race (or already gone)
    try:
        os.unlink(claim)
    except OSError:
        pass  # the orphaned-claim sweep below gets it
    _RECLAIMED.inc()
    return True


def _sweep_orphaned_claims(dir_path: str, names: List[str]) -> None:
    """Unlink claims whose claimant died between rename and unlink (same
    rules as the entries themselves: same-host pid, foreign TTL age)."""
    for n in names:
        if not n.startswith(CLAIMED_PREFIX):
            continue
        host, pid, _orig = _claim_parts(n)
        path = os.path.join(dir_path, n)
        dead = False
        if host == socket.gethostname():
            dead = not pid_alive(pid)
        else:
            try:
                ttl = ttl_s()
                dead = ttl > 0 and time.time() - os.stat(path).st_mtime > ttl
            except OSError:
                continue
        if dead:
            try:
                os.unlink(path)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Registry: join / heartbeat / live view
# ---------------------------------------------------------------------------


class _Membership:
    """This process's join state + the rate-limited live-member view."""

    def __init__(self):
        self.lock = threading.Lock()
        self.dir: Optional[str] = None
        self.file: Optional[str] = None
        self.stop: Optional[threading.Event] = None
        self.thread: Optional[threading.Thread] = None
        self.view: List[str] = []
        self.view_t: float = 0.0


_m = _Membership()


def _entry_payload() -> dict:
    return {
        "replica_id": replica_id(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "ts": round(time.time(), 3),
        "heartbeat_s": heartbeat_s(),
    }


def _write_entry(dir_path: str, name: str) -> None:
    """tmp + `os.replace`: the heartbeat is atomic (a reader never sees a
    torn entry) and bumps mtime (the foreign-host liveness signal)."""
    tmp = os.path.join(dir_path, f"{_TMP_PREFIX}{name}.{uuid.uuid4().hex[:6]}")
    with open(tmp, "w") as f:
        json.dump(_entry_payload(), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dir_path, name))


def _heartbeat_loop(dir_path: str, name: str, stop: threading.Event) -> None:
    while not stop.wait(heartbeat_s()):
        try:
            _write_entry(dir_path, name)
        except OSError:
            pass  # transient lake hiccup: the next beat retries


def join_fleet(dir_path: Optional[str] = None) -> str:
    """Register this process in the on-lake fleet and start its heartbeat;
    idempotent (re-joins the same dir are no-ops). Returns `replica_id()`.
    Called by `QueryServer` construction when the fleet flag is on; safe to
    call directly (a child replica process, tests)."""
    rid = replica_id()
    d = dir_path or registry_dir()
    with _m.lock:
        if _m.thread is not None and _m.dir == d:
            return rid
        _leave_locked()
        os.makedirs(d, exist_ok=True)
        name = f"{REPLICA_PREFIX}{rid}.json"
        _write_entry(d, name)
        _m.dir, _m.file = d, name
        _m.view, _m.view_t = [], 0.0
        _m.stop = threading.Event()
        _m.thread = threading.Thread(
            target=_heartbeat_loop,
            args=(d, name, _m.stop),
            name="hyperspace-replica-heartbeat",
            daemon=True,
        )
        _m.thread.start()
    # Prime the invalidation cursor: epochs published BEFORE this replica
    # built any cache are already visible to its first cold read.
    _epoch_prime(d)
    return rid


def _leave_locked() -> None:
    if _m.stop is not None:
        _m.stop.set()
    if _m.thread is not None:
        _m.thread.join(timeout=2.0)
    if _m.dir and _m.file:
        try:
            os.unlink(os.path.join(_m.dir, _m.file))
        except OSError:
            pass
    _m.dir = _m.file = _m.stop = _m.thread = None
    _m.view, _m.view_t = [], 0.0


def leave_fleet() -> None:
    """Deregister (clean shutdown). A SIGKILLed replica never runs this —
    that is what the claim-by-rename reclaim is for."""
    with _m.lock:
        _leave_locked()


def joined() -> bool:
    return _m.thread is not None


def _scan_live(dir_path: str) -> List[str]:
    """One registry pass: reclaim dead entries, sweep orphaned claims,
    return the sorted live replica ids."""
    try:
        names = sorted(os.listdir(dir_path))
    except OSError:
        return []
    live: List[str] = []
    for n in names:
        if not (n.startswith(REPLICA_PREFIX) and n.endswith(".json")):
            continue
        path = os.path.join(dir_path, n)
        if _entry_alive(n, path):
            live.append(n[len(REPLICA_PREFIX): -len(".json")])
        else:
            _reclaim_entry(dir_path, n)
    _sweep_orphaned_claims(dir_path, names)
    _LIVE.set(len(live))
    return live


def live_replicas(dir_path: Optional[str] = None, refresh: bool = False) -> List[str]:
    """The live-member view, cached for ``HYPERSPACE_REPLICA_VIEW_S`` (every
    admit/route consults this; one listdir per refresh period fleet-wide,
    never per query). `refresh=True` forces a rescan (tests, rebalance
    probes)."""
    d = dir_path or _m.dir or registry_dir()
    now = time.monotonic()
    with _m.lock:
        if (
            not refresh
            and d == _m.dir
            and _m.view
            and now - _m.view_t < view_s()
        ):
            return list(_m.view)
    view = _scan_live(d)
    with _m.lock:
        if d == _m.dir:
            _m.view, _m.view_t = view, now
    return view


def live_count(dir_path: Optional[str] = None) -> int:
    return max(1, len(live_replicas(dir_path)))


# ---------------------------------------------------------------------------
# Rendezvous routing
# ---------------------------------------------------------------------------


def owner_of(key: str, members: Optional[List[str]] = None) -> Optional[str]:
    """The one member that owns `key` under rendezvous (highest-random-
    weight) hashing: every member scores ``sha256(member|key)`` and the
    highest score wins. Stable (same members + key → same owner), balanced
    (scores are uniform), and minimally disruptive: removing a member remaps
    ONLY the keys it owned — the property that keeps a SIGKILL from
    re-routing (and re-decoding) the whole lake."""
    if members is None:
        members = live_replicas()
    best, best_score = None, b""
    for m in members:
        score = hashlib.sha256(f"{m}|{key}".encode()).digest()
        if best is None or score > best_score:
            best, best_score = m, score
    return best


def owns(key: str, members: Optional[List[str]] = None) -> bool:
    """Whether THIS replica owns `key`. Fleet off, not joined, or an
    unreadable registry all answer True — routing degrades to every replica
    owning everything (correct, just not deduplicated), never to a key
    nobody serves."""
    if not fleet_enabled() or not joined():
        return True
    owner = owner_of(key, members)
    return owner is None or owner == replica_id()


# ---------------------------------------------------------------------------
# Cross-replica invalidation (epoch.json)
# ---------------------------------------------------------------------------

_epoch_lock = threading.Lock()
#: Last-seen epoch-file signature per registry dir — the JOIN-time cursor.
#: Per-consumer cursors (each caching manager) live in the `state` dicts
#: passed to `check_invalidation`; this one only primes new consumers.
_epoch_seen: Dict[str, tuple] = {}

_SIG_MISSING = ("missing",)


def _epoch_path(dir_path: str) -> str:
    return os.path.join(dir_path, EPOCH_FILE)


def _epoch_signature(dir_path: str):
    """Cheap change detector: (mtime_ns, size, ino) of epoch.json — one
    `os.stat`, no JSON parse on the read path. `os.replace` always moves the
    inode, so every publish changes the signature even within one mtime
    granule."""
    try:
        st = os.stat(_epoch_path(dir_path))
        return (st.st_mtime_ns, st.st_size, st.st_ino)
    except OSError:
        return _SIG_MISSING


def _epoch_prime(dir_path: str) -> None:
    with _epoch_lock:
        _epoch_seen[dir_path] = _epoch_signature(dir_path)


def read_epoch(dir_path: Optional[str] = None) -> dict:
    """The parsed epoch document: ``{"epoch": N, "entries": {index:
    log_entry_id}, "publisher": replica_id}``; empty-start when missing or
    torn (a torn read means a publish is mid-replace — the next poll sees
    the committed document)."""
    d = dir_path or _m.dir or registry_dir()
    try:
        with open(_epoch_path(d)) as f:
            doc = json.load(f)
        if isinstance(doc, dict):
            return doc
    except (OSError, ValueError):
        pass
    return {"epoch": 0, "entries": {}}


def publish_invalidation(
    index_name: str,
    log_entry_id,
    dir_path: Optional[str] = None,
) -> None:
    """Announce one committed mutation to the fleet: merge ``{index_name:
    log_entry_id}`` into the epoch document, bump the epoch, commit tmp +
    `os.replace`. Racing publishers last-write-win the MERGE — harmless,
    because readers key on the signature moving at all, and both commits
    move it (each racer's reader re-reads the log on its next probe
    anyway). Called by `CachingIndexCollectionManager._mutate` after the
    action commits; no-op when the fleet is off."""
    if not fleet_enabled():
        return
    d = dir_path or _m.dir or registry_dir()
    try:
        os.makedirs(d, exist_ok=True)
        doc = read_epoch(d)
        entries = doc.get("entries") or {}
        entries[str(index_name)] = log_entry_id
        out = {
            "epoch": int(doc.get("epoch") or 0) + 1,
            "entries": entries,
            "publisher": replica_id(),
            "ts": round(time.time(), 3),
        }
        tmp = os.path.join(d, f"{_TMP_PREFIX}epoch.{uuid.uuid4().hex[:6]}")
        with open(tmp, "w") as f:
            json.dump(out, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, _epoch_path(d))
        _INVAL_PUBLISHED.inc()
    except OSError:
        pass  # the lake hiccuped: readers still converge via their TTL


def check_invalidation(state: dict, dir_path: Optional[str] = None) -> bool:
    """Whether the fleet epoch moved since this CONSUMER last looked.
    `state` is the consumer's private cursor dict (each caching manager
    owns one — a shared cursor would let one manager consume the signal
    and starve the rest). Rate-limited to one `os.stat` per
    ``HYPERSPACE_REPLICA_EPOCH_CHECK_S``; fleet off = False at one env
    read."""
    if not fleet_enabled():
        return False
    now = time.monotonic()
    if now - state.get("t", -math.inf) < epoch_check_s():
        return False
    state["t"] = now
    d = dir_path or _m.dir or registry_dir()
    sig = _epoch_signature(d)
    prev = state.get("sig")
    if prev is None:
        # First look: inherit the join-time cursor so an epoch published
        # before this consumer existed doesn't fire a spurious clear, but
        # one published since the join does.
        with _epoch_lock:
            prev = _epoch_seen.get(d, sig)
    state["sig"] = sig
    if sig != prev:
        _INVAL_OBSERVED.inc()
        return True
    return False


# ---------------------------------------------------------------------------
# Cold-file decode coordination (routing fast path + on-lake lease)
# ---------------------------------------------------------------------------

T = TypeVar("T")


def _lease_path(dir_path: str, key: str) -> str:
    return os.path.join(
        dir_path, f"{LEASE_PREFIX}{hashlib.sha256(key.encode()).hexdigest()[:16]}.json"
    )


def _lease_holder_dead(path: str) -> bool:
    """Same two-rule scheme: a same-host holder is pid-checked; a foreign or
    unreadable holder is dead once the lease file ages past the lease TTL."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("host") == socket.gethostname():
            return not pid_alive(int(doc.get("pid") or -1))
    except (OSError, ValueError):
        pass  # racing unlink, or torn write: fall through to age
    try:
        ttl = lease_ttl_s()
        return ttl > 0 and time.time() - os.stat(path).st_mtime > ttl
    except OSError:
        return False  # vanished: the holder finished


def _break_lease(dir_path: str, path: str) -> None:
    """Atomic-rename arbitration (losers get OSError and just re-poll), then
    unlink — the claim-by-rename idiom applied to a dead holder's lease."""
    tomb = os.path.join(
        dir_path, f"{_TMP_PREFIX}broken.{os.getpid()}.{uuid.uuid4().hex[:6]}"
    )
    try:
        os.rename(path, tomb)
    except OSError:
        return
    try:
        os.unlink(tomb)
    except OSError:
        pass
    _LEASE_BROKEN.inc()


def coordinate_decode(key: str, attempt: Callable[[], T]) -> T:
    """Run one cold-decode `attempt` under the fleet's cross-replica
    single-flight discipline. Fleet off / not joined / <2 live members /
    THIS replica owns `key`: `attempt()` verbatim (the owned fast path —
    byte- and accounting-identical to the single-process engine). A FOREIGN
    cold decode first takes the on-lake lease for `key`: concurrent
    cross-replica decodes of one cold file serialize, each waiter honoring
    its own query deadline (`resilience.check_deadline`) at every slice,
    and a lease whose holder died (SIGKILL mid-decode) is broken by the
    same liveness rules the registry uses. The waiter still runs its own
    `attempt` after acquiring — per-process caches mean the bytes must
    land in THIS process — but it reads what the leader's decode left in
    the OS page cache instead of re-pulling the lake."""
    if not fleet_enabled() or not joined():
        return attempt()
    members = live_replicas()
    if len(members) < 2 or owns(key, members):
        _ROUTE_OWNED.inc()
        return attempt()
    _ROUTE_FOREIGN.inc()
    d = _m.dir or registry_dir()
    path = _lease_path(d, key)
    waited = False
    while True:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if not waited:
                waited = True
                _LEASE_WAITED.inc()
            if _lease_holder_dead(path):
                _break_lease(d, path)
                continue
            _resilience.check_deadline("serve.replica_lease")
            time.sleep(_LEASE_WAIT_SLICE_S)
            continue
        except OSError:
            # Registry dir unreachable: degrade to an uncoordinated decode
            # (correct, just not deduplicated) rather than failing the query.
            return attempt()
        try:
            os.write(fd, json.dumps(_entry_payload()).encode())
        finally:
            os.close(fd)
        _LEASE_ACQUIRED.inc()
        try:
            return attempt()
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Fleet admission
# ---------------------------------------------------------------------------


def apportioned_budget(total: int, dir_path: Optional[str] = None) -> int:
    """One replica's share of a fleet-wide tenant budget:
    ``ceil(total / live_replicas)``, floor 1 (a positive fleet budget must
    never round a replica to zero capacity). Fleet off = `total` verbatim;
    membership changes rebalance within one view-refresh period because
    the live count is re-read per admit."""
    if total <= 0 or not fleet_enabled() or not joined():
        return total
    return max(1, math.ceil(total / live_count(dir_path)))


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------


def fleet_stats() -> dict:
    """One snapshot for `QueryServer.stats()`."""
    out = {
        "enabled": fleet_enabled(),
        "replica_id": replica_id(),
        "joined": joined(),
    }
    if joined():
        members = live_replicas()
        out.update(
            {
                "registry_dir": _m.dir,
                "live": len(members),
                "members": members,
                "epoch": read_epoch().get("epoch", 0),
            }
        )
    return out


def _reset_for_tests() -> None:
    """Tear down join state + cursors (test isolation only)."""
    global _replica_id
    leave_fleet()
    with _epoch_lock:
        _epoch_seen.clear()
    _replica_id = None
