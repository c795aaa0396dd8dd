"""Reducing a `torch.profiler` stretch to device numbers.

The profiler's raw events (`kineto_results.events()`) carry start and length
in nanoseconds of the host's wall clock. Device events are kernels, copies and
memsets. Busy time is the union of their intervals over the stretch, so
overlapping streams count once; idle gaps are the rest, each named by the
innermost host span of the program that covers the gap's middle.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]


@dataclass
class Stretch:
    """One profiled stretch: its bounds (ns, host wall clock), its device
    events (start, end, name) and the program's host spans (start, end,
    name, depth) that overlap it."""

    t0: int
    t1: int
    device: List[Tuple[int, int, str]] = field(default_factory=list)
    host: List[Tuple[int, int, str, int]] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def from_profiler(prof, t0: int, t1: int) -> Stretch:
    """The device events of a stopped `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            dev.append((int(e.start_ns()), int(e.start_ns() + e.duration_ns()), e.name()))
    return Stretch(t0, t1, sorted(dev))


def union(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The union of `intervals` clipped to [lo, hi], sorted and disjoint."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_seconds(st: Stretch) -> float:
    return sum(b - a for a, b in union([(a, b) for a, b, _ in st.device], st.t0, st.t1)) / 1e9


def gaps(st: Stretch) -> List[Interval]:
    busy = union([(a, b) for a, b, _ in st.device], st.t0, st.t1)
    out, cur = [], st.t0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < st.t1:
        out.append((cur, st.t1))
    return out


def kernel_seconds(st: Stretch, names: Sequence[str]) -> float:
    """Summed device time of the events whose name contains any of `names`
    (a kernel's templated name starts with its function's)."""
    return sum(b - a for a, b, n in st.device if any(k in n for k in names)) / 1e9


def host_activity(st: Stretch, points: Sequence[int]) -> List[str]:
    """For each instant, the innermost program span covering it, or "no
    program span" (one sweep over the spans in start order)."""
    spans = sorted(st.host)
    order = sorted(range(len(points)), key=lambda i: points[i])
    out = ["no program span"] * len(points)
    active: list = []
    i = 0
    for k in order:
        t = points[k]
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > t]
        if active:
            out[k] = max(active, key=lambda s: s[3])[2]
    return out


def breakdown(st: Stretch, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by what
    the host was doing, each at most `top` entries of [name, seconds]."""
    ops: Dict[str, float] = defaultdict(float)
    for a, b, n in st.device:
        a, b = max(a, st.t0), min(b, st.t1)
        if b > a:
            ops[n] += (b - a) / 1e9
    idle: Dict[str, float] = defaultdict(float)
    holes = gaps(st)
    for (a, b), name in zip(holes, host_activity(st, [(a + b) // 2 for a, b in holes])):
        idle[name] += (b - a) / 1e9
    by = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": by(ops), "idle_gaps": by(idle)}


def host_spans(spans: List[dict], t0: int, t1: int, offset_ns: int = 0) -> List[Tuple[int, int, str, int]]:
    """The program's spans (its JSONL records: `start_s` on the wall clock,
    `duration_s`) that overlap [t0, t1], as (start, end, name, depth) in
    ns, shifted by `offset_ns` onto the profiler's clock."""
    by_id = {(s["query_id"], s["span_id"]): s for s in spans}

    def depth(s) -> int:
        d, seen = 0, s
        while seen.get("parent_id") is not None and d < 64:
            seen = by_id.get((seen["query_id"], seen["parent_id"]))
            if seen is None:
                break
            d += 1
        return d

    out = []
    for s in spans:
        if s.get("duration_s") is None:
            continue
        a = int(s["start_s"] * 1e9) + offset_ns
        b = a + int(s["duration_s"] * 1e9)
        if b > t0 and a < t1:
            out.append((a, b, s["name"], depth(s)))
    return out
