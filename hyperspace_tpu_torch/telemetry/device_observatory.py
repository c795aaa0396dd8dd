"""Device cost observatory: where device time, transfer bytes and padding go
(counterpart of `hyperspace_tpu/telemetry/device_observatory.py`).

- **Per-kernel device time.** `probe_start` / `probe_finish` bracket each
  kernel launch (`compile_log.observed_launch`). Under
  `HYPERSPACE_DEVICE_TIMING` (`1`: one probe per label per
  `HYPERSPACE_DEVICE_TIMING_INTERVAL_S`, `all`: every launch) a launch gets a
  pair of `torch.cuda.Event(enable_timing=True)` recorded on the current
  stream around it. Nothing waits for them then: the pairs ride the ambient
  query ledger and are read when it closes (`resolve_ledger_probes`), so the
  probes never stall the stream they measure. The seconds feed
  `latency.device.<label>`, `device_summary()` and the ledger's
  `device_time_s` (billed to the stage the launch ran in). A probe outside
  any ledger waits in a process list until `device_summary()` reads it.
  Off (the default) a launch costs one env read: no event, no
  synchronization.
- **Transfers.** `record_h2d` / `record_d2h` count bytes and copies
  (`transfer.h2d.*`, `transfer.d2h.*`) at the scans' copies to the card
  (`engine/io.py`: the port has no separate upload cache) and at `to_host`,
  the device-to-host chokepoint. Seconds only under timing.
- **Padding.** `record_pad(site, payload, padded)` at the join's bucket pads
  (`ops/bucket_join.py`): `pad.bytes_payload|bytes_padded`, per site, and
  on the ledger, which derives `pad_ratio`.
- **Encoded staging.** `record_encoded_stage` keeps the JAX package's
  encoded-vs-flat split and its names.
- **Profile capture.** `maybe_capture(reason, detail)`, called by the
  history store's anomaly, writes `capture.json` into
  `HYPERSPACE_PROFILE_DIR/capture/` at once (reason, kernel launches, device
  time, pads, transfers, the last ledgers) and opens a
  `torch.profiler.profile` window of `HYPERSPACE_PROFILE_WINDOW_S` on a
  daemon thread: CUDA activity (every kernel the process launches in the
  window) when this process holds a CUDA context, the CPU otherwise. The
  window opens once the profiler has started (the first in a process waits
  for CUPTI to initialize; `_trace_started` is set then) and lands as
  `trace.chrome.json`, its status in `trace.json` (`window_s`, `trace`,
  `error`, `started_after_s`). One window at a time per process (CUPTI
  allows one profiler): a capture during a window keeps its manifest and
  skips the trace. Captures are rate limited
  (`HYPERSPACE_PROFILE_MIN_INTERVAL_S`, counted in
  `profiler.captures_suppressed`) and keep `HYPERSPACE_PROFILE_KEEP`
  directories. A capture never raises into the query.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from . import metrics as _metrics

ENV_DEVICE_TIMING = "HYPERSPACE_DEVICE_TIMING"
ENV_TIMING_INTERVAL_S = "HYPERSPACE_DEVICE_TIMING_INTERVAL_S"
_DEFAULT_TIMING_INTERVAL_S = 0.25
ENV_PROFILE_DIR = "HYPERSPACE_PROFILE_DIR"
ENV_PROFILE_KEEP = "HYPERSPACE_PROFILE_KEEP"
ENV_PROFILE_WINDOW_S = "HYPERSPACE_PROFILE_WINDOW_S"
ENV_PROFILE_MIN_INTERVAL_S = "HYPERSPACE_PROFILE_MIN_INTERVAL_S"
_DEFAULT_PROFILE_KEEP = 3
_DEFAULT_PROFILE_WINDOW_S = 2.0
_DEFAULT_PROFILE_MIN_INTERVAL_S = 60.0
#: The window's Chrome trace, beside `trace.json` in a capture directory.
CHROME_TRACE_NAME = "trace.chrome.json"

_H2D_BYTES = _metrics.counter("transfer.h2d.bytes")
_H2D_COUNT = _metrics.counter("transfer.h2d.count")
_D2H_BYTES = _metrics.counter("transfer.d2h.bytes")
_D2H_COUNT = _metrics.counter("transfer.d2h.count")
_PAD_PAYLOAD = _metrics.counter("pad.bytes_payload")
_PAD_PADDED = _metrics.counter("pad.bytes_padded")
_ENC_FLAT = _metrics.counter("device.encoded.bytes_flat")
_ENC_STAGED = _metrics.counter("device.encoded.bytes_staged")
_ENC_PACKED = _metrics.counter("device.encoded.bytes_packed")
_CAPTURES = _metrics.counter("profiler.captures")
_CAPTURES_SUPPRESSED = _metrics.counter("profiler.captures_suppressed")

_lock = threading.Lock()
_last_probe: Dict[str, float] = {}
_device_programs: Dict[str, dict] = {}
_pad_sites: Dict[str, list] = {}
_encoded_sites: Dict[str, list] = {}
_transfers: Dict[str, list] = {"h2d": [0, 0, 0.0], "d2h": [0, 0, 0.0]}
#: Probes taken outside any ledger: (label, start, end, stage).
_pending: List[tuple] = []
_last_capture: list = [-1e18]
_capture_seq = 0
#: Set while a profiler window runs: one at a time per process.
_trace_in_flight = threading.Event()
#: Set once the newest window's profiler has started recording.
_trace_started = threading.Event()
#: The window's thread, joined (bounded) at exit.
_trace_thread: list = [None]


def timing_mode() -> str:
    """'' = off (the default), '1' = sampled, 'all' = every launch."""
    return os.environ.get(ENV_DEVICE_TIMING, "") or ""


def _timing_interval_s() -> float:
    try:
        return max(0.0, float(os.environ.get(ENV_TIMING_INTERVAL_S, "") or _DEFAULT_TIMING_INTERVAL_S))
    except ValueError:
        return _DEFAULT_TIMING_INTERVAL_S


def _make_event(device):
    """A timing CUDA event recorded now on `device`'s current stream."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def probe_start(label: str, device=None):
    """Decide, before the launch, whether it is probed; the start event, or
    None. Off: one env read."""
    mode = timing_mode()
    if not mode:
        return None
    if mode != "all":
        now = time.monotonic()
        interval = _timing_interval_s()
        with _lock:
            if now - _last_probe.get(label, -1e18) < interval:
                return None
            _last_probe[label] = now
    return _make_event(device)


def probe_finish(label: str, start, device=None) -> None:
    """Record the end event after the launch and queue the pair on the
    ambient ledger (read at its close), else on the process list."""
    from . import accounting as _accounting
    from . import stage_ledger as _stage_ledger

    probe = (label, start, _make_event(device), _stage_ledger.current_stage())
    led = _accounting.current_ledger()
    if led is not None:
        with led._lock:
            led.probes.append(probe)
    else:
        with _lock:
            _pending.append(probe)


def _elapsed_s(start, end) -> float:
    end.synchronize()
    return max(0.0, start.elapsed_time(end) / 1e3)


def _bill(label: str, dt: float) -> None:
    _metrics.histogram(f"latency.device.{label}").observe(dt)
    with _lock:
        p = _device_programs.setdefault(label, {"calls": 0, "device_s": 0.0})
        p["calls"] += 1
        p["device_s"] += dt


def resolve_ledger_probes(led) -> float:
    """Read the ledger's probe pairs (waiting for their end events) into
    `device_time_s` and the stages; returns the seconds billed."""
    from . import stage_ledger as _stage_ledger

    with led._lock:
        probes, led.probes = led.probes, []
    total = 0.0
    for label, start, end, stage in probes:
        dt = _elapsed_s(start, end)
        _bill(label, dt)
        total += dt
        led.add("device_time_s", dt)
        if led.stage_attr:
            _stage_ledger.stamp_counter("device_time_s", dt, stage)
    return total


def _resolve_pending() -> None:
    with _lock:
        probes, _pending[:] = list(_pending), []
    for label, start, end, _stage in probes:
        _bill(label, _elapsed_s(start, end))


def device_summary() -> dict:
    """Per kernel label: probed launches and their device seconds. Empty
    when timing never ran."""
    _resolve_pending()
    with _lock:
        return {lbl: {"calls": p["calls"], "device_s": round(p["device_s"], 6)}
                for lbl, p in sorted(_device_programs.items())}


def record_h2d(nbytes: int, seconds: Optional[float] = None) -> None:
    """One host-to-device copy of `nbytes`."""
    _H2D_BYTES.inc(int(nbytes))
    _H2D_COUNT.inc()
    with _lock:
        t = _transfers["h2d"]
        t[0] += int(nbytes)
        t[1] += 1
        if seconds is not None:
            t[2] += seconds
    if seconds is not None:
        _metrics.histogram("transfer.h2d.seconds").observe(seconds)


def record_d2h(nbytes: int, seconds: Optional[float] = None) -> None:
    """One device-to-host materialization of `nbytes`, charged to the
    ambient ledger's `d2h_bytes`."""
    from . import accounting as _accounting

    _D2H_BYTES.inc(int(nbytes))
    _D2H_COUNT.inc()
    _accounting.add("d2h_bytes", int(nbytes))
    with _lock:
        t = _transfers["d2h"]
        t[0] += int(nbytes)
        t[1] += 1
        if seconds is not None:
            t[2] += seconds
    if seconds is not None:
        _metrics.histogram("transfer.d2h.seconds").observe(seconds)


def to_host(tensor):
    """THE device-to-host chokepoint: `tensor` on the CPU, its bytes and
    copies counted when it came from the card (seconds under timing, which
    the copy's own synchronization bounds). A CPU tensor passes through."""
    if tensor.device.type == "cpu":
        return tensor
    nbytes = int(tensor.numel() * tensor.element_size())
    if timing_mode():
        t0 = time.monotonic()
        host = tensor.cpu()
        record_d2h(nbytes, time.monotonic() - t0)
    else:
        host = tensor.cpu()
        record_d2h(nbytes)
    return host


def table_to_host(table):
    """A result table on the CPU, its device columns' bytes counted as one
    device-to-host materialization (`to_host` for a whole table)."""
    nbytes = sum(int(c.data.nbytes) + (int(c.validity.nbytes) if c.validity is not None else 0)
                 for c in table.columns.values() if c.data.device.type != "cpu")
    if not nbytes:
        return table.to("cpu")
    t0 = time.monotonic()
    host = table.to("cpu")
    record_d2h(nbytes, time.monotonic() - t0 if timing_mode() else None)
    return host


def record_pad(site: str, payload_bytes: int, padded_bytes: int) -> None:
    """One padding event at `site`: `payload_bytes` of real data staged in
    `payload + padded` bytes of buffer."""
    from . import accounting as _accounting

    payload_bytes = int(payload_bytes)
    padded_bytes = max(0, int(padded_bytes))
    _PAD_PAYLOAD.inc(payload_bytes)
    _PAD_PADDED.inc(padded_bytes)
    _metrics.counter(f"pad.{site}.bytes_payload").inc(payload_bytes)
    _metrics.counter(f"pad.{site}.bytes_padded").inc(padded_bytes)
    with _lock:
        s = _pad_sites.setdefault(site, [0, 0])
        s[0] += payload_bytes
        s[1] += padded_bytes
    _accounting.add("pad_bytes_payload", payload_bytes)
    _accounting.add("pad_bytes_padded", padded_bytes)


def record_encoded_stage(site: str, flat_bytes: int, staged_bytes: int, packed_bytes=None) -> None:
    """One code-space staging event at `site`: `flat_bytes` the flat path
    would have moved, `staged_bytes` moved, `packed_bytes` of them as packed
    sub-byte words."""
    from . import accounting as _accounting

    flat_bytes, staged_bytes = int(flat_bytes), int(staged_bytes)
    _ENC_FLAT.inc(flat_bytes)
    _ENC_STAGED.inc(staged_bytes)
    _metrics.counter(f"device.encoded.{site}.bytes_flat").inc(flat_bytes)
    _metrics.counter(f"device.encoded.{site}.bytes_staged").inc(staged_bytes)
    if packed_bytes is not None:
        packed_bytes = int(packed_bytes)
        _ENC_PACKED.inc(packed_bytes)
        _metrics.counter(f"device.encoded.{site}.bytes_packed").inc(packed_bytes)
    with _lock:
        s = _encoded_sites.setdefault(site, [0, 0, 0, 0])
        s[0] += flat_bytes
        s[1] += staged_bytes
        s[2] += 1
        s[3] += packed_bytes or 0
    _accounting.add("device_code_bytes_flat", flat_bytes)
    _accounting.add("device_code_bytes_staged", staged_bytes)
    if packed_bytes is not None:
        _accounting.add("device_code_bytes_packed", packed_bytes)


def encoded_stage_summary() -> dict:
    """Per site: bytes_flat, bytes_staged, count, saved_ratio[, bytes_packed]."""
    with _lock:
        out = {}
        for site, (flat, staged, count, packed) in sorted(_encoded_sites.items()):
            e = {"bytes_flat": flat, "bytes_staged": staged, "count": count,
                 "saved_ratio": round((flat - staged) / flat, 4) if flat else 0.0}
            if packed:
                e["bytes_packed"] = packed
            out[site] = e
        return out


def pad_summary() -> dict:
    """Per site: bytes_payload, bytes_padded and pad_ratio (the share of
    staged bytes that is padding)."""
    with _lock:
        out = {}
        for site, (payload, padded) in sorted(_pad_sites.items()):
            total = payload + padded
            out[site] = {"bytes_payload": payload, "bytes_padded": padded,
                         "pad_ratio": round(padded / total, 4) if total else 0.0}
        return out


def transfer_summary() -> dict:
    """Per direction: bytes, count and, once something was timed, seconds
    and gb_per_s."""
    with _lock:
        out = {}
        for d, (nbytes, count, seconds) in sorted(_transfers.items()):
            e = {"bytes": nbytes, "count": count}
            if seconds > 0:
                e["seconds"] = round(seconds, 6)
                e["gb_per_s"] = round(nbytes / seconds / 1e9, 3)
            out[d] = e
        return out


def reset() -> None:
    """Zero the summaries and the probe rate limit (tests)."""
    with _lock:
        _device_programs.clear()
        _pad_sites.clear()
        _encoded_sites.clear()
        _last_probe.clear()
        _pending.clear()
        for t in _transfers.values():
            t[0] = t[1] = 0
            t[2] = 0.0
        _last_capture[0] = -1e18


def _env_num(key: str, default, cast, floor):
    try:
        return max(floor, cast(os.environ.get(key, "") or default))
    except ValueError:
        return default


def profile_keep() -> int:
    return _env_num(ENV_PROFILE_KEEP, _DEFAULT_PROFILE_KEEP, int, 1)


def _profile_window_s() -> float:
    return _env_num(ENV_PROFILE_WINDOW_S, _DEFAULT_PROFILE_WINDOW_S, float, 0.05)


def _profile_min_interval_s() -> float:
    return _env_num(ENV_PROFILE_MIN_INTERVAL_S, _DEFAULT_PROFILE_MIN_INTERVAL_S, float, 0.0)


def _drain_trace_thread() -> None:
    t = _trace_thread[0]
    if t is not None and t.is_alive():
        t.join(timeout=_profile_window_s() + 15.0)


def maybe_capture(reason: str, detail: Optional[dict] = None) -> Optional[str]:
    """One capture into `HYPERSPACE_PROFILE_DIR`: its directory, or None when
    the knob is unset, the rate limit holds or the capture failed."""
    global _capture_seq
    base_dir = os.environ.get(ENV_PROFILE_DIR)
    if not base_dir:
        return None
    now = time.monotonic()
    with _lock:
        if now - _last_capture[0] < _profile_min_interval_s():
            _CAPTURES_SUPPRESSED.inc()
            return None
        _last_capture[0] = now
        _capture_seq += 1
        seq = _capture_seq
    try:
        from . import accounting as _accounting
        from . import compile_log as _compile_log
        from . import rotation as _rotation

        cap_dir = os.path.join(base_dir, "capture")
        os.makedirs(base_dir, exist_ok=True)
        _rotation.rotate_dir(cap_dir, keep=profile_keep())
        os.makedirs(cap_dir, exist_ok=True)
        window_s = _profile_window_s()
        manifest = {
            "schema_version": 1,
            "reason": reason,
            "seq": seq,
            "ts": time.time(),
            "window_s": window_s,
            "detail": detail or {},
            "programs": _compile_log.program_summary(),
            "device": device_summary(),
            "pads": pad_summary(),
            "transfers": transfer_summary(),
            "recent_ledgers": [led.to_dict() for led in _accounting.recent_ledgers()[-8:]],
        }
        with open(os.path.join(cap_dir, "capture.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True, default=str)
        _CAPTURES.inc()
        with _lock:
            start_trace = not _trace_in_flight.is_set()
            if start_trace:
                _trace_in_flight.set()
        if start_trace:
            _trace_started.clear()
            t = threading.Thread(target=_trace_window, args=(cap_dir, window_s),
                                 name="hyperspace-profile-capture", daemon=True)
            if _trace_thread[0] is None:
                import atexit

                atexit.register(_drain_trace_thread)
            _trace_thread[0] = t
            t.start()
        else:
            with open(os.path.join(cap_dir, "trace.json"), "w") as f:
                json.dump({"window_s": window_s, "trace": False, "error": "skipped: trace already in flight"}, f)
        return cap_dir
    except Exception:
        return None


def start_profile(cuda: bool):
    """A started `torch.profiler.profile` of the CPU, and of CUDA when
    `cuda`: one cycle a window (accumulating changes nothing and keeps the
    profiler from warning that it clears events between cycles). Stop it
    and write it with `export_chrome_trace`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    p = profile(activities=activities, acc_events=True)
    p.start()
    return p


def _trace_window(cap_dir: str, window_s: float) -> None:
    """One `torch.profiler` window into `cap_dir` (the daemon thread): CUDA
    activity too when this process holds a CUDA context. The window runs
    `window_s` from the profiler's start, which on the first window of a
    process waits for CUPTI's initialization (`started_after_s`); the status,
    an error included, lands in `trace.json`."""
    status = {"window_s": window_s, "trace": False}
    prof = None
    t0 = time.monotonic()
    try:
        import torch

        prof = start_profile(torch.cuda.is_initialized())
        status["activities"] = sorted(a.name for a in prof.activities)
        status["started_after_s"] = round(time.monotonic() - t0, 3)
        _trace_started.set()
        time.sleep(window_s)
    except Exception as e:
        status["error"] = f"{type(e).__name__}: {e}"
    finally:
        if prof is not None:
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(cap_dir, CHROME_TRACE_NAME))
                status["trace"] = True
                status["chrome_trace"] = CHROME_TRACE_NAME
            except Exception as e:
                status["error"] = f"{type(e).__name__}: {e}"
        _trace_in_flight.clear()
        try:
            with open(os.path.join(cap_dir, "trace.json"), "w") as f:
                json.dump(status, f)
        except OSError:
            pass
