"""Workload history store: every closed query ledger, durable, on the lake
(counterpart of `hyperspace_tpu/telemetry/history.py`, same layout, record
fields, env knobs and metric names, so either package reads the other's
directory and `tools/hsreport.py` renders the port's).

Layout of `HYPERSPACE_HISTORY_DIR` (default `<warehouse>/.hyperspace_history`
of the last session made, else `./.hyperspace_history`):

- `seg-<host>-<pid>-<uuid>.jsonl`: one append-only segment per writer
  (a process's store, per package: the uuid keeps two packages in one
  process apart). A line is one record, `{"schema_version", "kind":
  "ledger", "ts", "fingerprint", "ledger", "replica_id"}` (the writer's
  `serve.replicas.replica_id`), written by one write and a
  flush, so a kill tears at most the last line; readers skip torn lines.
- `compact-<host>-<pid>-<uuid>.jsonl`: compaction's output, a
  `compact_manifest` record naming its source segments, then one
  `"kind": "baseline"` checkpoint per fingerprint (a `metrics.Histogram`
  state, sums of squares and field totals).
- A segment rotates at `HYPERSPACE_HISTORY_SEGMENT_MB`. Compaction takes
  the segments whose writer is provably dead (same host, dead pid) or older
  than `HYPERSPACE_HISTORY_TTL_S`: it claims each by an atomic rename to
  `.claimed-<host>~<pid>~<name>` (the loser of a race skips it), folds the
  claims, commits the checkpoint by `os.replace` and deletes the claims. A
  live writer's segments are never claimed, whatever their age.

Per fingerprint the store keeps a rolling baseline (p50 / p99 wall, the
`TRACKED_FIELDS` totals, the stage vectors), folded from disk when the store
opens. Each landing is checked against its class: a wall over
`max(mean + N·std, 1.25·mean)` (N = `HYPERSPACE_HISTORY_ANOMALY_SIGMA`,
default 3), once the class has `ANOMALY_MIN_SAMPLES` queries, ticks
`history.anomalies`, sets the root span's `history_anomaly`, rides the
exporter's next frame, warns once per fingerprint and asks
`device_observatory.maybe_capture` for a profile.

The wall is the ledger's, taken at its close after `collect()`'s copy to the
host, so on the card it includes the device work. Off (the default) the
cost is one env read at a ledger's close.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import threading
import time
import uuid
import warnings
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

from . import metrics as _metrics

SCHEMA_VERSION = 1

ENV_HISTORY = "HYPERSPACE_HISTORY"
ENV_HISTORY_DIR = "HYPERSPACE_HISTORY_DIR"
ENV_SEGMENT_MB = "HYPERSPACE_HISTORY_SEGMENT_MB"
ENV_TTL_S = "HYPERSPACE_HISTORY_TTL_S"
ENV_ANOMALY_SIGMA = "HYPERSPACE_HISTORY_ANOMALY_SIGMA"

_DEFAULT_SEGMENT_MB = 4.0
_DEFAULT_TTL_S = 24 * 3600.0
_DEFAULT_SIGMA = 3.0

#: A class flags anomalies only from this many queries on.
ANOMALY_MIN_SAMPLES = 8
#: Walls under 5 ms never flag: jitter outweighs any signal there.
ANOMALY_MIN_WALL_S = 0.005

SEGMENT_PREFIX = "seg-"
COMPACT_PREFIX = "compact-"
CLAIMED_PREFIX = ".claimed-"
_TMP_PREFIX = ".tmp-"

#: Ledger fields whose per-class totals a baseline keeps besides the wall.
#: `xla_compiles` keeps the JAX package's name; in the port it counts the
#: kernel library's builds (`compile_log.observed_build`).
TRACKED_FIELDS = (
    "bytes_decoded",
    "bytes_skipped",
    "decode_files",
    "io_retries",
    "xla_compiles",
    "rows_produced",
    "device_time_s",
    "device_upload_bytes",
    "d2h_bytes",
    "pad_bytes_payload",
    "pad_bytes_padded",
    "device_code_bytes_flat",
    "device_code_bytes_staged",
    "device_code_bytes_packed",
)

_RECORDS = _metrics.counter("history.records")
_ANOMALIES = _metrics.counter("history.anomalies")
_TORN = _metrics.counter("history.torn_lines")
_ROTATED = _metrics.counter("history.segments_rotated")
_COMPACTED = _metrics.counter("history.segments_compacted")

#: Anomalies waiting for the exporter's next frame.
_PENDING_ANOMALIES: "deque[dict]" = deque(maxlen=64)
_warned_fingerprints: set = set()

_stores_lock = threading.Lock()
_stores: Dict[str, "HistoryStore"] = {}


def enabled() -> bool:
    """One env read: `HYPERSPACE_HISTORY=1`."""
    return os.environ.get(ENV_HISTORY) == "1"


def history_dir() -> str:
    """`HYPERSPACE_HISTORY_DIR`, else `.hyperspace_history` in the warehouse
    of the last session made, else in the working directory."""
    env = os.environ.get(ENV_HISTORY_DIR)
    if env:
        return env
    from ..engine.session import HyperspaceSession

    sess = HyperspaceSession._active
    if sess is not None:
        return os.path.join(sess.warehouse, ".hyperspace_history")
    return os.path.join(".", ".hyperspace_history")


def _env_float(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, "") or default)
    except ValueError:
        return default


def _segment_cap_bytes() -> int:
    return max(4096, int(_env_float(ENV_SEGMENT_MB, _DEFAULT_SEGMENT_MB) * 1_000_000))


def _ttl_s() -> float:
    return max(0.0, _env_float(ENV_TTL_S, _DEFAULT_TTL_S))


def _sigma() -> float:
    return max(0.5, _env_float(ENV_ANOMALY_SIGMA, _DEFAULT_SIGMA))


# -- ownership and claims ------------------------------------------------------


def _owner_of(name: str) -> Tuple[Optional[str], int]:
    """(host, pid) of a `seg-<host>-<pid>-<uuid>.jsonl` name, parsed from the
    right (a host name may hold '-'); (None, -1) if it does not parse."""
    stem = name[: -len(".jsonl")] if name.endswith(".jsonl") else name
    parts = stem.split("-")
    try:
        return "-".join(parts[1:-2]) or None, int(parts[-2])
    except (IndexError, ValueError):
        return None, -1


def _pid_alive(pid: int) -> bool:
    from ..util.procs import pid_alive

    return pid_alive(pid)


def _claim_parts(name: str) -> Tuple[Optional[str], int, Optional[str]]:
    """(claimant host, claimant pid, claimed name) of a
    `.claimed-<host>~<pid>~<name>` file; (None, -1, None) if it does not
    parse. The host rides the name: a pid means nothing on another host."""
    parts = name[len(CLAIMED_PREFIX):].split("~", 2)
    if len(parts) != 3:
        return None, -1, None
    try:
        return parts[0], int(parts[1]), parts[2]
    except ValueError:
        return None, -1, None


def _claim_orphaned(name: str, path: str) -> bool:
    """Whether a claim's compactor is gone: by pid on this host, by the TTL
    on the claim's mtime for another host's or an unparseable claim."""
    host, pid, _orig = _claim_parts(name)
    if host == socket.gethostname():
        return not _pid_alive(pid)
    try:
        ttl = _ttl_s()
        return ttl > 0 and time.time() - os.stat(path).st_mtime > ttl
    except OSError:
        return False


def _root_name(name: str) -> str:
    """The segment name under any number of nested claim prefixes."""
    while name.startswith(CLAIMED_PREFIX):
        orig = _claim_parts(name)[2]
        if not orig:
            break
        name = orig
    return name


def _folded_sources(dir_path: str) -> set:
    """Segment names already in a committed checkpoint (the manifests, each
    the first record of its `compact-*` file). A claim whose root is here
    was left by a compactor that died between commit and unlink: it is
    garbage, never read and deleted by the next compaction."""
    out: set = set()
    try:
        names = os.listdir(dir_path)
    except OSError:
        return out
    for n in names:
        if n.startswith(COMPACT_PREFIX) and n.endswith(".jsonl"):
            for rec in iter_file_records(os.path.join(dir_path, n)):
                if rec.get("kind") == "compact_manifest":
                    out.update(str(s) for s in rec.get("sources") or [])
                break
    return out


# -- per-fingerprint baseline --------------------------------------------------


def _rounded(d: dict) -> dict:
    return {k: round(v, 6) if isinstance(v, float) else v for k, v in sorted(d.items())}


class FingerprintBaseline:
    """The rolling cost of one plan class: a private wall histogram (its
    state is what checkpoints keep), the sum of squared walls for the Nσ
    bound, the `TRACKED_FIELDS` totals and the per-stage vector totals."""

    __slots__ = ("fingerprint", "names", "hist", "wall_sumsq", "fields", "stages")

    def __init__(self, fingerprint: str):
        self.fingerprint = fingerprint
        self.names: set = set()
        self.hist = _metrics.Histogram(f"history.{fingerprint}")  # not registered
        self.wall_sumsq = 0.0
        self.fields: Dict[str, float] = {}
        #: {stage: {"n": queries that labeled it, <field>: total}}.
        self.stages: Dict[str, dict] = {}

    @property
    def count(self) -> int:
        return self.hist.count

    def mean_std(self) -> Tuple[float, float]:
        n = self.hist.count
        if n == 0:
            return 0.0, 0.0
        mean = self.hist.total / n
        return mean, math.sqrt(max(0.0, self.wall_sumsq / n - mean * mean))

    def check_anomaly(self, wall: float) -> Optional[dict]:
        """The Nσ test against the baseline as it stands (before `observe`,
        so a query is never compared with itself)."""
        if self.hist.count < ANOMALY_MIN_SAMPLES or wall < ANOMALY_MIN_WALL_S:
            return None
        mean, std = self.mean_std()
        # Floors: a class of near-identical walls must not flag 1.3x jitter.
        threshold = max(mean + _sigma() * std, mean * 1.25, ANOMALY_MIN_WALL_S)
        if wall <= threshold:
            return None
        return {
            "fingerprint": self.fingerprint,
            "wall_s": round(wall, 6),
            "baseline_mean_s": round(mean, 6),
            "baseline_std_s": round(std, 6),
            "threshold_s": round(threshold, 6),
            "baseline_n": self.hist.count,
        }

    def observe(self, ledger: dict) -> None:
        wall = ledger.get("wall_s")
        if isinstance(wall, (int, float)):
            self.hist.observe(float(wall))
            self.wall_sumsq += float(wall) * float(wall)
        name = ledger.get("name")
        if name and len(self.names) < 8:
            self.names.add(str(name))
        for f in TRACKED_FIELDS:
            v = ledger.get(f)
            if isinstance(v, (int, float)) and v:
                self.fields[f] = self.fields.get(f, 0) + v
        stages = ledger.get("stages")
        if isinstance(stages, dict):
            self._fold_stages(stages)

    def _fold_stages(self, stages: dict) -> None:
        """Add stage vectors; a ledger's count one query a stage, a
        checkpoint's carry their own `n`."""
        for st, vec in stages.items():
            if not isinstance(vec, dict):
                continue
            acc = self.stages.setdefault(st, {"n": 0})
            for k, v in vec.items():
                if k != "n" and isinstance(v, (int, float)):
                    acc[k] = acc.get(k, 0) + v
            n = vec.get("n", 1)
            acc["n"] += n if isinstance(n, int) and n > 0 else 1

    def to_checkpoint(self) -> dict:
        out = {
            "schema_version": SCHEMA_VERSION,
            "kind": "baseline",
            "fingerprint": self.fingerprint,
            "names": sorted(self.names),
            "wall": self.hist.dump_state(),
            "wall_sumsq": round(self.wall_sumsq, 9),
            "fields": _rounded(self.fields),
        }
        if self.stages:
            out["stages"] = {st: _rounded(acc) for st, acc in sorted(self.stages.items())}
        return out

    def merge_checkpoint(self, rec: dict) -> None:
        self.hist.merge_state(rec.get("wall") or {})
        try:
            self.wall_sumsq += float(rec.get("wall_sumsq") or 0.0)
        except (TypeError, ValueError):
            pass
        names = rec.get("names")
        if isinstance(names, (list, tuple)):
            for n in names:
                if len(self.names) < 8:
                    self.names.add(str(n))
        fields = rec.get("fields")
        if isinstance(fields, dict):
            for k, v in fields.items():
                if isinstance(v, (int, float)):
                    self.fields[k] = self.fields.get(k, 0) + v
        stages = rec.get("stages")
        if isinstance(stages, dict):
            self._fold_stages(stages)

    def summary(self) -> dict:
        mean, std = self.mean_std()
        s = self.hist.summary()
        out = {
            "n": s["count"],
            "names": sorted(self.names),
            "wall_total_s": round(s["total"], 6),
            "wall_mean_s": round(mean, 6),
            "wall_std_s": round(std, 6),
        }
        if s["count"]:
            out["wall_p50_s"] = s.get("p50")
            out["wall_p99_s"] = s.get("p99")
            out["wall_max_s"] = s.get("max")
        out.update(_rounded(self.fields))
        if self.stages:
            out["stages"] = {st: _rounded(acc) for st, acc in sorted(self.stages.items())}
        return out


# -- readers -------------------------------------------------------------------


def iter_file_records(path: str, count_torn: bool = False) -> Iterator[dict]:
    """The records of one file. A torn or garbled line is skipped (and
    counted in `history.torn_lines` only by the store's own load pass, so a
    report re-reading one old tear raises no alarm); a future schema
    version parses: unknown keys are tolerated, unknown kinds skipped."""
    try:
        f = open(path, "r")
    except OSError:
        return
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if count_torn:
                    _TORN.inc()
                continue
            if isinstance(rec, dict):
                yield rec


def _store_files(dir_path: str) -> List[str]:
    """Segments, checkpoints and orphaned claims (a dead compactor's claim
    still holds its records, unless a manifest already counted them); a
    live compactor's claim is skipped: its records are about to be
    re-committed."""
    try:
        names = sorted(os.listdir(dir_path))
    except OSError:
        return []
    out = []
    folded: Optional[set] = None
    for n in names:
        if not n.endswith(".jsonl"):
            continue
        path = os.path.join(dir_path, n)
        if n.startswith((SEGMENT_PREFIX, COMPACT_PREFIX)):
            out.append(path)
        elif n.startswith(CLAIMED_PREFIX) and _claim_orphaned(n, path):
            if folded is None:
                folded = _folded_sources(dir_path)
            if _root_name(n) not in folded:
                out.append(path)
    return out


def iter_records(dir_path: str, count_torn: bool = False) -> Iterator[dict]:
    """Every record of a history directory: what `tools/hsreport.py` and
    `tools/bench_compare.py --history` read."""
    for path in _store_files(dir_path):
        yield from iter_file_records(path, count_torn=count_torn)


def fold_baselines(records) -> Dict[str, FingerprintBaseline]:
    """Per-fingerprint baselines of a record stream: ledgers observe,
    checkpoints merge, other kinds are skipped. The one fold: the store's
    load, compaction and the tools all call it."""
    out: Dict[str, FingerprintBaseline] = {}
    for rec in records:
        fp, kind = rec.get("fingerprint"), rec.get("kind")
        if not fp:
            continue
        if kind == "ledger" and isinstance(rec.get("ledger"), dict):
            out.setdefault(fp, FingerprintBaseline(fp)).observe(rec["ledger"])
        elif kind == "baseline":
            out.setdefault(fp, FingerprintBaseline(fp)).merge_checkpoint(rec)
    return out


def split_records(records) -> Tuple[Dict[str, list], Dict[str, list]]:
    """(raw ledger records, checkpoint records) by fingerprint, ledgers in
    time order."""
    raw: Dict[str, list] = {}
    checkpoints: Dict[str, list] = {}
    for rec in records:
        fp = rec.get("fingerprint")
        if not fp:
            continue
        if rec.get("kind") == "ledger" and isinstance(rec.get("ledger"), dict):
            raw.setdefault(fp, []).append(rec)
        elif rec.get("kind") == "baseline":
            checkpoints.setdefault(fp, []).append(rec)
    for recs in raw.values():
        recs.sort(key=lambda r: r.get("ts") or 0.0)
    return raw, checkpoints


def recent_vs_baseline(raw: Dict[str, list], checkpoints: Dict[str, list], recent_k: int,
                       min_baseline: int = 1, require_full_window: bool = False) -> List[dict]:
    """Per class: the p50 wall of its newest `recent_k` ledgers against the
    p50 of everything older (checkpoints included). Classes without both
    are left out."""
    out = []
    for fp in sorted(set(raw) | set(checkpoints)):
        ledgers = raw.get(fp, [])
        recent = [r["ledger"]["wall_s"] for r in ledgers[-recent_k:]
                  if isinstance(r["ledger"].get("wall_s"), (int, float))]
        if not recent or (require_full_window and len(recent) < recent_k):
            continue
        baseline = FingerprintBaseline(fp)
        for rec in checkpoints.get(fp, ()):
            baseline.merge_checkpoint(rec)
        for rec in ledgers[:-recent_k]:
            baseline.observe(rec["ledger"])
        if baseline.count < min_baseline:
            continue
        expected = baseline.hist.quantile(0.5)
        if expected is None:
            continue
        actual = sorted(recent)[len(recent) // 2]
        out.append({
            "fingerprint": fp,
            "names": sorted(baseline.names),
            "baseline_n": baseline.count,
            "recent_n": len(recent),
            "expected_p50_s": round(expected, 6),
            "actual_p50_s": round(actual, 6),
            "ratio": round(actual / expected, 3) if expected else None,
        })
    return out


# -- the store -----------------------------------------------------------------


class HistoryStore:
    """One writer's handle on a history directory: the segment it alone
    appends to, and the baselines folded from everything on disk."""

    def __init__(self, dir_path: str, load: bool = True, compact_on_open: bool = True):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self._lock = threading.RLock()
        self._fh = None
        self._seg_path: Optional[str] = None
        self._seg_bytes = 0
        self.records_written = 0
        self._baselines: Dict[str, FingerprintBaseline] = (
            fold_baselines(iter_records(dir_path, count_torn=True)) if load else {})
        if compact_on_open:
            try:
                self.compact()
            except Exception:
                pass  # compaction saves bytes; it never fails an open

    def _own_name(self, prefix: str) -> str:
        return f"{prefix}{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}.jsonl"

    def _open_segment_locked(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._seg_path = os.path.join(self.dir, self._own_name(SEGMENT_PREFIX))
        self._fh = open(self._seg_path, "a")
        self._seg_bytes = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def record(self, fingerprint: str, ledger: dict) -> Optional[dict]:
        """Land one closed ledger: check it against its class, append its
        record (one write and flush), fold it in. Returns the anomaly
        verdict, or None."""
        rec = {"schema_version": SCHEMA_VERSION, "kind": "ledger", "ts": round(time.time(), 6),
               "fingerprint": fingerprint, "ledger": ledger}
        # The writer's replica id on the envelope: K replicas share one
        # directory and every record says whose it is.
        try:
            from ..serve.replicas import replica_id as _rid

            rec["replica_id"] = _rid()
        except Exception:
            pass
        # ensure_ascii (the default) makes len(line) the bytes written.
        line = json.dumps(rec, default=str) + "\n"
        rotated = wrote = False
        with self._lock:
            bl = self._baselines.get(fingerprint)
            if bl is None:
                bl = self._baselines[fingerprint] = FingerprintBaseline(fingerprint)
            wall = ledger.get("wall_s")
            verdict = bl.check_anomaly(float(wall)) if isinstance(wall, (int, float)) else None
            bl.observe(ledger)
            try:
                if self._fh is None or self._seg_bytes + len(line) > _segment_cap_bytes():
                    rotated = self._fh is not None
                    self._open_segment_locked()
                    if rotated:
                        _ROTATED.inc()
                self._fh.write(line)
                self._fh.flush()
                self._seg_bytes += len(line)
                self.records_written += 1
                wrote = True
            except OSError:
                pass  # history never fails the query it records
        if rotated:
            # Outside the lock: other threads' closes must not wait on a fold.
            try:
                self.compact()
            except Exception:
                pass
        if wrote:
            _RECORDS.inc()  # only what reached the segment: readers reconcile
        if verdict is not None:
            self._flag(fingerprint, ledger, verdict)
        return verdict

    def _flag(self, fingerprint: str, ledger: dict, verdict: dict) -> None:
        _ANOMALIES.inc()
        verdict["query_id"] = ledger.get("query_id")
        verdict["name"] = ledger.get("name")
        _PENDING_ANOMALIES.append(verdict)
        try:
            from . import device_observatory as _devobs

            _devobs.maybe_capture("anomaly", dict(verdict))
        except Exception:
            pass  # a capture is an observer, never a path of the query
        if fingerprint not in _warned_fingerprints:
            _warned_fingerprints.add(fingerprint)
            warnings.warn(
                f"hyperspace history: query class {fingerprint} ({ledger.get('name')}) ran "
                f"{verdict['wall_s']:.3f}s, over its baseline threshold {verdict['threshold_s']:.3f}s "
                f"(mean {verdict['baseline_mean_s']:.3f}s over {verdict['baseline_n']} queries). Further "
                "anomalies in this class tick history.anomalies silently.",
                RuntimeWarning,
                stacklevel=5,
            )

    def baselines(self) -> Dict[str, dict]:
        with self._lock:
            return {fp: bl.summary() for fp, bl in self._baselines.items()}

    def baseline_for(self, fingerprint: str) -> Optional[FingerprintBaseline]:
        with self._lock:
            return self._baselines.get(fingerprint)

    def _compactable(self) -> List[str]:
        """Files safe to fold: orphaned claims, and segments or checkpoints
        other than this store's live segment whose writer is dead on this
        host, or (another host's) older than the TTL. A live writer on this
        host keeps every segment: from outside its live one looks like its
        rotated ones, and claiming it would lose each later record."""
        ttl, now = _ttl_s(), time.time()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for name in names:
            path = os.path.join(self.dir, name)
            if not name.endswith(".jsonl") or path == self._seg_path:
                continue
            if name.startswith(CLAIMED_PREFIX):
                if _claim_orphaned(name, path):
                    out.append(path)
                continue
            if not name.startswith((SEGMENT_PREFIX, COMPACT_PREFIX)):
                continue
            host, pid = _owner_of(name)
            if host == socket.gethostname() and pid > 0:
                if not _pid_alive(pid):
                    out.append(path)
                continue
            try:
                if ttl > 0 and now - os.stat(path).st_mtime > ttl:
                    out.append(path)
            except OSError:
                continue
        return out

    def compact(self) -> int:
        """Fold every compactable file into one checkpoint file; returns the
        files taken (folded or collected as garbage). Only the claim renames
        arbitrate between compactors, so this runs without the store lock."""
        candidates = self._compactable()
        if not candidates:
            return 0
        already_folded = _folded_sources(self.dir)
        claimed: List[str] = []
        garbage: List[str] = []
        me = f"{CLAIMED_PREFIX}{socket.gethostname()}~{os.getpid()}~"
        for path in candidates:
            claim = os.path.join(os.path.dirname(path), me + os.path.basename(path))
            try:
                os.rename(path, claim)
            except OSError:
                continue  # another compactor took it
            # A rename keeps the mtime: restart the TTL clock, or another
            # host would judge this fresh claim orphaned and fold it twice.
            with contextlib.suppress(OSError):
                os.utime(claim, None)
            (garbage if _root_name(os.path.basename(path)) in already_folded else claimed).append(claim)
        for p in garbage:
            with contextlib.suppress(OSError):
                os.unlink(p)
        if not claimed:
            return len(garbage)
        folded = fold_baselines(rec for p in claimed for rec in iter_file_records(p))
        tmp = os.path.join(self.dir, f"{_TMP_PREFIX}{uuid.uuid4().hex[:8]}.jsonl")
        out = os.path.join(self.dir, self._own_name(COMPACT_PREFIX))
        manifest = {"schema_version": SCHEMA_VERSION, "kind": "compact_manifest",
                    "sources": sorted(_root_name(os.path.basename(p)) for p in claimed)}
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(manifest) + "\n")
                for fp in sorted(folded):
                    f.write(json.dumps(folded[fp].to_checkpoint(), default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, out)
        except OSError:
            # Release the claims: a live claimant's file is invisible to
            # readers, so a kept claim would hide its records.
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            for p in claimed:
                orig = _claim_parts(os.path.basename(p))[2]
                if orig:
                    with contextlib.suppress(OSError):
                        os.rename(p, os.path.join(os.path.dirname(p), orig))
            return len(garbage)
        for p in claimed:
            with contextlib.suppress(OSError):
                os.unlink(p)
        _COMPACTED.inc(len(claimed))
        return len(claimed) + len(garbage)


# -- the process's stores ------------------------------------------------------


def get_store(dir_path: Optional[str] = None) -> HistoryStore:
    """This process's store of `dir_path` (default `history_dir()`), made
    and folded on first use."""
    d = os.path.abspath(dir_path or history_dir())
    with _stores_lock:
        st = _stores.get(d)
        if st is None:
            st = _stores[d] = HistoryStore(d)
        return st


def reset_stores() -> None:
    """Close and forget every store (tests): the files stay, and the next
    `get_store` folds them again, as a restarted process would."""
    with _stores_lock:
        for st in _stores.values():
            st.close()
        _stores.clear()
    _PENDING_ANOMALIES.clear()
    _warned_fingerprints.clear()


def land(ledger_dict: dict, root=None) -> Optional[dict]:
    """Land one closed ledger in the ambient store (`accounting` calls it
    at the close under `enabled()`), keyed by its `plan_fingerprint`, or
    `name:<name>` for a ledger without one (an index build). An anomaly
    lands on `root` as `history_anomaly`. Never raises."""
    try:
        fp = ledger_dict.get("plan_fingerprint") or f"name:{ledger_dict.get('name')}"
        verdict = get_store().record(fp, ledger_dict)
    except Exception:
        return None
    if verdict is not None and root is not None:
        try:
            root.set_attr("history_anomaly", verdict)
        except Exception:
            pass
    return verdict


def drain_anomalies() -> List[dict]:
    out: List[dict] = []
    while True:
        try:
            out.append(_PENDING_ANOMALIES.popleft())
        except IndexError:
            return out


def frame_summary() -> Optional[dict]:
    """The exporter frame's `history` key, once a store is open in this
    process: its directories, records written, fingerprints, the anomaly
    total and the anomalies since the last frame."""
    with _stores_lock:
        stores = list(_stores.values())
    if not stores:
        return None
    out = {
        "dirs": [st.dir for st in stores],
        "records_written": sum(st.records_written for st in stores),
        "fingerprints": sum(len(st._baselines) for st in stores),
        "anomalies_total": _ANOMALIES.value,
    }
    anomalies = drain_anomalies()
    if anomalies:
        out["anomalies"] = anomalies
    return out
