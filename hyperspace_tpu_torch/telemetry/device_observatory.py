"""Device cost observatory: where device time, transfer bytes and padding go
(counterpart of `hyperspace_tpu/telemetry/device_observatory.py`, without
its profile capture, which waits for the history and SLO layers).

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
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from . import metrics as _metrics

ENV_DEVICE_TIMING = "HYPERSPACE_DEVICE_TIMING"
ENV_TIMING_INTERVAL_S = "HYPERSPACE_DEVICE_TIMING_INTERVAL_S"
_DEFAULT_TIMING_INTERVAL_S = 0.25

_H2D_BYTES = _metrics.counter("transfer.h2d.bytes")
_H2D_COUNT = _metrics.counter("transfer.h2d.count")
_D2H_BYTES = _metrics.counter("transfer.d2h.bytes")
_D2H_COUNT = _metrics.counter("transfer.d2h.count")
_PAD_PAYLOAD = _metrics.counter("pad.bytes_payload")
_PAD_PADDED = _metrics.counter("pad.bytes_padded")
_ENC_FLAT = _metrics.counter("device.encoded.bytes_flat")
_ENC_STAGED = _metrics.counter("device.encoded.bytes_staged")
_ENC_PACKED = _metrics.counter("device.encoded.bytes_packed")

_lock = threading.Lock()
_last_probe: Dict[str, float] = {}
_device_programs: Dict[str, dict] = {}
_pad_sites: Dict[str, list] = {}
_encoded_sites: Dict[str, list] = {}
_transfers: Dict[str, list] = {"h2d": [0, 0, 0.0], "d2h": [0, 0, 0.0]}
#: Probes taken outside any ledger: (label, start, end, stage).
_pending: List[tuple] = []


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
