"""Deterministic, seeded fault injection at named points of the engine
(counterpart of `hyperspace_tpu/telemetry/faults.py`).

Each lake-touching site calls `check("<point>")` right before its real
operation; a seeded registry decides per call whether to inject there.

Points (`FAULT_POINTS`):

- `io.decode`: a data or index file decode (`engine.io._read_arrow`,
  `_read_other`);
- `io.footer`: a parquet footer parse (`engine.io.footer_metadata`);
- `storage.write`: a parquet file write (`engine.io.checked_write_table`);
- `log.write`: an operation-log write (`index.log_manager`);
- `pool.worker`: a decode pool task body (`engine.io`);
- `device.compile`: the kernel library's build
  (`telemetry.compile_log.observed_build`);
- `serve.admit`: a serving-layer admission decision
  (`serve.admission.AdmissionController.admit`);
- `refresh.merge`: after an incremental refresh's data directory committed,
  before its log entry (`actions.refresh.RefreshIncrementalAction.op`);
- `compact.commit`: after every compacted bucket is staged, before the
  rename publishes it (`actions.optimize.OptimizeAction.op`).

Configuration: `HYPERSPACE_FAULTS` (comma-separated specs) or `configure` /
`inject`, which take precedence over the env:

    point:rate[:kind[:limit[:after]]]

`rate` is the injection probability per eligible call; `kind` is
`transient` (the default: raises `TransientError`), `permanent` (raises
`PermanentError`) or `hang`/`hang<secs>` (sleeps, 30 s by default, then
proceeds); `limit` caps the injections of the spec (blank or 0: no cap);
`after` skips the first N eligible calls.

Determinism: a decision hashes (seed, point, call index), with the seed from
`HYPERSPACE_FAULTS_SEED` (default "0") and the call index from a per-point
counter, bit for bit as the JAX package does, so both packages inject at the
same calls of the same run. `injected_count` and `call_count` read the
module's per-point counters; an injection also ticks the registry's
`faults.injected` and `faults.<point>.injected` and the query ledger's
`faults_injected`.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

from ..exceptions import HyperspaceException, PermanentError, TransientError
from . import accounting as _accounting
from . import metrics as _metrics

ENV_FAULTS = "HYPERSPACE_FAULTS"
ENV_FAULTS_SEED = "HYPERSPACE_FAULTS_SEED"

#: The named points; `FaultSpec` accepts only these, so a misspelt point
#: fails loudly instead of never firing.
FAULT_POINTS = (
    "io.decode",
    "io.footer",
    "storage.write",
    "log.write",
    "pool.worker",
    "device.compile",
    "serve.admit",
    "refresh.merge",
    "compact.commit",
)

_lock = threading.Lock()
_programmatic: Optional[Dict[str, "FaultSpec"]] = None
_env_raw: Optional[str] = None
_env_parsed: Dict[str, "FaultSpec"] = {}
# Call counters live outside the specs: a reconfiguration must not reset
# call indices mid-run.
_calls: Dict[str, int] = {}
_injections: Dict[str, int] = {}


class FaultSpec:
    """One point's injection policy."""

    __slots__ = ("point", "rate", "kind", "limit", "after", "hang_s")

    def __init__(self, point: str, rate: float, kind: str = "transient", limit: Optional[int] = None,
                 after: int = 0, hang_s: float = 30.0):
        if point not in FAULT_POINTS:
            raise ValueError(f"Unknown fault point '{point}'; known: {FAULT_POINTS}")
        if kind.startswith("hang"):
            hang_s = float(kind[4:]) if kind[4:] else hang_s
            kind = "hang"
        if kind not in ("transient", "permanent", "hang"):
            raise ValueError(f"Unknown fault kind '{kind}'")
        self.point = point
        self.rate = float(rate)
        self.kind = kind
        self.limit = limit if limit else None
        self.after = int(after)
        self.hang_s = hang_s


def _parse_specs(raw: str) -> Dict[str, FaultSpec]:
    out: Dict[str, FaultSpec] = {}
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if len(parts) < 2:
            raise ValueError(f"Bad fault spec '{item}' (need point:rate)")
        kind = parts[2] if len(parts) > 2 and parts[2] else "transient"
        limit = int(parts[3]) if len(parts) > 3 and parts[3] else None
        after = int(parts[4]) if len(parts) > 4 and parts[4] else 0
        out[parts[0]] = FaultSpec(parts[0], float(parts[1]), kind, limit, after)
    return out


def _seed() -> str:
    return os.environ.get(ENV_FAULTS_SEED, "0") or "0"


def _active_specs() -> Optional[Dict[str, FaultSpec]]:
    """The effective specs, or None when injection is off (one env read).
    A malformed `HYPERSPACE_FAULTS` raises a `HyperspaceException`, never a
    bare `ValueError` that the corruption guard could take for a bad file."""
    global _env_raw, _env_parsed
    if _programmatic is not None:
        return _programmatic or None
    raw = os.environ.get(ENV_FAULTS)
    if not raw:
        return None
    if raw != _env_raw:
        with _lock:
            if raw != _env_raw:
                try:
                    _env_parsed = _parse_specs(raw)
                except ValueError as e:
                    raise HyperspaceException(f"Bad {ENV_FAULTS} spec {raw!r}: {e}") from e
                _env_raw = raw
    return _env_parsed or None


def _decide(point: str, n: int, rate: float) -> bool:
    """The seeded draw for call `n` of `point` (`faults._decide` :178)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = hashlib.sha256(f"{_seed()}|{point}|{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64) < rate


def check(point: str) -> None:
    """The point's hook: nothing unless a spec names `point`; else count the
    call and, on a seeded hit, raise `TransientError` / `PermanentError` or
    sleep and proceed (`hang`)."""
    specs = _active_specs()
    if specs is None:
        return
    spec = specs.get(point)
    if spec is None:
        return
    with _lock:
        n = _calls.get(point, 0)
        _calls[point] = n + 1
        if n < spec.after:
            return
        if spec.limit is not None and _injections.get(point, 0) >= spec.limit:
            return
        fire = _decide(point, n, spec.rate)
        if fire:
            _injections[point] = _injections.get(point, 0) + 1
    if not fire:
        return
    _metrics.counter("faults.injected").inc()
    _metrics.counter(f"faults.{point}.injected").inc()
    _accounting.add("faults_injected", 1)
    if spec.kind == "hang":
        time.sleep(spec.hang_s)
        return
    msg = f"injected {spec.kind} fault at {point} (call #{n})"
    if spec.kind == "permanent":
        raise PermanentError(msg)
    raise TransientError(msg)


def configure(specs) -> None:
    """Programmatic configuration, over `HYPERSPACE_FAULTS`: a spec string,
    a list of `FaultSpec`s or a dict point → FaultSpec. Counters stay."""
    global _programmatic
    if isinstance(specs, str):
        parsed = _parse_specs(specs)
    elif isinstance(specs, dict):
        parsed = dict(specs)
    else:
        parsed = {s.point: s for s in specs}
    with _lock:
        _programmatic = parsed


def clear() -> None:
    """Drop the programmatic configuration (the env applies again)."""
    global _programmatic
    with _lock:
        _programmatic = None


def reset_counters() -> None:
    """Zero the per-point counters and the registry's fault counters."""
    with _lock:
        _calls.clear()
        _injections.clear()
    _metrics.counter("faults.injected").reset()
    for point in FAULT_POINTS:
        _metrics.counter(f"faults.{point}.injected").reset()


def injected_count(point: Optional[str] = None) -> int:
    with _lock:
        return _injections.get(point, 0) if point is not None else sum(_injections.values())


def call_count(point: str) -> int:
    with _lock:
        return _calls.get(point, 0)


@contextlib.contextmanager
def inject(point: str, rate: float = 1.0, kind: str = "transient", limit: Optional[int] = None,
           after: int = 0) -> Iterator[None]:
    """Inject at `point` for the scope, then restore the configuration."""
    global _programmatic
    with _lock:
        prev = _programmatic
        merged = dict(prev or {})
        merged[point] = FaultSpec(point, rate, kind, limit, after)
        _programmatic = merged
    try:
        yield
    finally:
        with _lock:
            _programmatic = prev
