"""Knob -> stage ownership: which pipeline stages a governed knob can move
(counterpart of `hyperspace_tpu/plananalysis/attribution.py`).

- `KNOB_STAGES` declares, for each knob of `costmodel.KNOBS`, the stages
  whose seconds it governs.
- `knob_stage_seconds(knob, stage_walls)` reduces one query's per-stage
  walls to that knob's subtotal (None when none of its stages ran).
- `explain_lines(ledger)` renders the Attribution section of
  `explain(analyze=True)`: per-stage cost vectors with the knobs that own
  each stage, and the planner's stage-grain predicted against actual.

Stage walls are busy time (concurrent workers sum), so a subtotal can
exceed the wall of an overlapped pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..telemetry import stage_ledger as _stage_ledger
from .costmodel import KNOBS

KNOB_STAGES: Dict[str, tuple] = {
    "pushdown": ("decode",),
    "streaming": ("decode", "filter", "partial", "merge"),
    "chunk_rows": ("decode", "pad", "probe"),
    "encoded_exec": ("decode", "h2d"),
    "packed_codes": ("h2d", "exchange"),
    "join_size_classes": ("pad", "probe", "verify"),
    "multiway": ("probe", "expand", "verify"),
    "hash_quantize": ("probe", "partial", "merge"),
}
assert set(KNOB_STAGES) == set(KNOBS), "every governed knob owns a stage set"


def knob_stage_seconds(knob: str, stage_walls: Optional[Dict[str, float]]) -> Optional[float]:
    """The seconds of `knob`'s stages in one query's walls; None when the
    knob has no stage set or none of its stages ran."""
    if not stage_walls:
        return None
    stages = KNOB_STAGES.get(knob)
    if not stages:
        return None
    total, seen = 0.0, False
    for st in stages:
        v = stage_walls.get(st)
        if v:
            total += float(v)
            seen = True
    return total if seen and total > 0.0 else None


def query_stage_walls() -> Optional[Dict[str, float]]:
    """The running query's per-stage busy walls (None: attribution off or
    nothing labeled)."""
    return _stage_ledger.query_stage_walls()


def stages_of(ledger: Optional[dict]) -> Dict[str, dict]:
    """The per-stage vectors of one closed ledger dict ({} without)."""
    if not isinstance(ledger, dict):
        return {}
    stages = ledger.get("stages")
    return stages if isinstance(stages, dict) else {}


def _owners(stage: str) -> List[str]:
    return sorted(k for k, sts in KNOB_STAGES.items() if stage in sts)


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _fmt_cell(field: str, v) -> str:
    if field.endswith("_s"):
        return f"{v * 1e3:.2f}ms"
    if field.startswith("bytes_"):
        return _fmt_bytes(v)
    return str(v)


def explain_lines(ledger: Optional[dict]) -> List[str]:
    """The Attribution section; [] when the query carried no stage data."""
    stages = stages_of(ledger)
    if not stages:
        return []
    lines: List[str] = ["Attribution (per-stage cost vectors):"]
    for st in sorted(stages):
        vec = stages[st]
        parts = [f"{f}={_fmt_cell(f, vec[f])}" for f in _stage_ledger.VECTOR_FIELDS if vec.get(f)]
        owners = _owners(st)
        own = f"  [knobs: {', '.join(owners)}]" if owners else ""
        lines.append(f"  {st:<12} {' '.join(parts)}{own}")
    planner = ledger.get("planner")
    if isinstance(planner, dict):
        walls = {st: vec.get("wall_s", 0.0) for st, vec in stages.items() if isinstance(vec, dict) and vec.get("wall_s")}
        grain: List[str] = []
        for knob in sorted(planner):
            d = planner[knob]
            if not isinstance(d, dict) or "arm" not in d:
                continue
            sub = d.get("stage_actual_s")
            if not isinstance(sub, (int, float)):
                sub = knob_stage_seconds(knob, walls)
            if sub is None:
                continue
            cell = f"{knob}[{d['arm']}]: stage_actual={sub * 1e3:.2f}ms"
            pred = d.get("predicted_s")
            if isinstance(pred, (int, float)) and pred > 0:
                cell += f" predicted={pred * 1e3:.2f}ms"
                sd = d.get("stage_drift_x")
                if not isinstance(sd, (int, float)):
                    sd = round(sub / pred, 3)
                cell += f" drift={sd:g}x"
            grain.append(cell)
        if grain:
            lines.append("  knob-relevant subtotals (busy time, stages overlap):")
            lines.extend(f"    {g}" for g in grain)
    return lines
