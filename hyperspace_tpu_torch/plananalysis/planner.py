"""The planner's decision path: every governed knob decided per plan
(counterpart of `hyperspace_tpu/plananalysis/planner.py`, without its
outcome store).

A knob's env flag that is set pins it: the planner reports it as "pinned"
and the gate never asks. An unset flag hands the knob to the planner, which
takes the cost model's arm (`costmodel.estimate`). `decide` runs after
physical planning; `decisions_scope` installs its `PlanDecisions` on this
thread and on the query's `resilience.QueryScope`, so every pool worker that
adopts the scope sees the same decisions. The gates
(`streaming.streaming_enabled`, `multiway_enabled`, `query_chunk_rows`,
`pushdown.pushdown_enabled`, `encoding.encoded_exec_enabled`,
`packed_codes.packed_codes_enabled`, `bucket_join.size_classes_enabled`)
read `decided_value(knob)` only when their flag is unset.
`HYPERSPACE_PLANNER=0` turns the planner off: one env read, and every gate
answers its flag's default.

`hash_quantize` is decided and recorded (on for a CUDA session), but the
port has no gate for it: its kernels are built once for every shape, so a
pow2 padding of hashed batches buys nothing.

The decisions land on the query's ledger and root span (`_record`, the
ledger's `planner` field), and at the ledger's close `annotate_close` adds
the measured wall and each knob's drift, at stage grain too. `observe`
feeds a measured wall to the outcome store, which is not ported yet (ROADMAP
Queue 1 item 6): it returns where the JAX package's returns with no store
configured. Until the store comes, a query planned with
`HYPERSPACE_PLANNER_DIR` set or `HYPERSPACE_HISTORY=1` raises
`not_in_slice` rather than model without learning. The decisions of the
last planned query stay readable for the tests (`last_decisions`).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
from typing import Dict, Iterator, Optional

from ..exceptions import not_in_slice
from .costmodel import INT_KNOBS, KNOB_ENV, KNOBS

ENV_PLANNER = "HYPERSPACE_PLANNER"
ENV_PLANNER_DIR = "HYPERSPACE_PLANNER_DIR"
ENV_HISTORY = "HYPERSPACE_HISTORY"


def planner_enabled() -> bool:
    """On unless `HYPERSPACE_PLANNER` is "0"."""
    return os.environ.get(ENV_PLANNER, "") != "0"


def arm_label(value) -> str:
    """Bools as on/off, ints as their decimal value."""
    if isinstance(value, bool):
        return "on" if value else "off"
    return str(int(value))


class Decision:
    """One knob for one plan: the chosen value, its single alternative, both
    arms' predicted seconds, and the source ("model" or "pinned")."""

    __slots__ = ("knob", "value", "alt", "predicted_s", "predicted_alt_s", "source")

    def __init__(self, knob, value, alt, predicted_s, predicted_alt_s, source):
        self.knob = knob
        self.value = value
        self.alt = alt
        self.predicted_s = predicted_s
        self.predicted_alt_s = predicted_alt_s
        self.source = source

    @property
    def arm(self) -> str:
        return arm_label(self.value)


class PlanDecisions:
    """The decisions of one query. A pinned knob answers None in `value`:
    its flag already decided at the gate."""

    __slots__ = ("fingerprint", "decisions", "calibration_source")

    def __init__(self, fingerprint: Optional[str], decisions: Dict[str, Decision],
                 calibration_source: str = "default"):
        self.fingerprint = fingerprint
        self.decisions = decisions
        self.calibration_source = calibration_source

    def value(self, knob: str):
        d = self.decisions.get(knob)
        if d is None or d.source == "pinned":
            return None
        return d.value

    def to_ledger(self) -> dict:
        """The compact dict the JAX package puts on its query ledger."""
        return {
            knob: {"arm": d.arm, "alt": arm_label(d.alt), "predicted_s": d.predicted_s,
                   "predicted_alt_s": d.predicted_alt_s, "source": d.source}
            for knob, d in self.decisions.items()
        }


_ambient: "contextvars.ContextVar[Optional[PlanDecisions]]" = contextvars.ContextVar(
    "hyperspace_torch_plan_decisions", default=None
)


def current_decisions() -> Optional[PlanDecisions]:
    """This thread's decisions, else the adopted query scope's, else None."""
    pd = _ambient.get()
    if pd is not None:
        return pd
    from .. import resilience as _resilience

    sc = _resilience.current_scope()
    return None if sc is None else sc.plan_decisions


def decided_value(knob: str):
    """The planner's value of `knob`, or None (undecided, pinned or off).
    A gate asks only after its own flag came back unset."""
    pd = current_decisions()
    return None if pd is None else pd.value(knob)


@contextlib.contextmanager
def decisions_scope(pd: Optional[PlanDecisions]) -> Iterator[None]:
    """Install `pd` on this thread and on the current query scope."""
    if pd is None:
        yield
        return
    from .. import resilience as _resilience

    token = _ambient.set(pd)
    sc = _resilience.current_scope()
    prev = None
    if sc is not None:
        prev, sc.plan_decisions = sc.plan_decisions, pd
    try:
        yield
    finally:
        _ambient.reset(token)
        if sc is not None:
            sc.plan_decisions = prev


def refuse_outcome_store() -> None:
    """Raise `not_in_slice` when the planner is on and asked to learn
    (`HYPERSPACE_PLANNER_DIR` set, or `HYPERSPACE_HISTORY=1`, the JAX
    package's `outcome_dir` :450): the port must not quietly model without
    the store that would learn."""
    if planner_enabled() and (os.environ.get(ENV_PLANNER_DIR) or os.environ.get(ENV_HISTORY) == "1"):
        raise not_in_slice("the planner's outcome store (HYPERSPACE_PLANNER_DIR, HYPERSPACE_HISTORY)")


def _pinned_value(knob: str, raw: str):
    if knob in INT_KNOBS:
        try:
            return int(raw)
        except ValueError:
            return raw
    return raw != "0"


_last: Optional[PlanDecisions] = None
_activity: Dict[str, dict] = {}
_activity_lock = threading.Lock()


def decide(phys, fingerprint: Optional[str] = None, device=None) -> Optional[PlanDecisions]:
    """Every governed knob of one physical plan on a session's `device`;
    None when the planner is off. Never raises: a broken model must never
    break a query."""
    if not planner_enabled():
        return None
    try:
        return _decide(phys, fingerprint, device)
    except Exception:
        return None


def _decide(phys, fingerprint: Optional[str], device) -> PlanDecisions:
    global _last
    from . import costmodel

    cal = costmodel.current_calibration(device)
    est = costmodel.estimate(costmodel.collect_stats(phys), cal)
    decisions: Dict[str, Decision] = {}
    for knob in KNOBS:
        raw = os.environ.get(KNOB_ENV[knob], "")
        model_v, alt_v, pred_m, pred_a = est.get(knob, (True, False, 0.0, 0.0))
        if raw != "":
            decisions[knob] = Decision(knob, _pinned_value(knob, raw), alt_v, pred_m, pred_a, "pinned")
        else:
            decisions[knob] = Decision(knob, model_v, alt_v, pred_m, pred_a, "model")
    pd = PlanDecisions(fingerprint, decisions, cal.source)
    _record(pd)
    with _activity_lock:
        for knob, d in decisions.items():
            if d.source != "pinned":
                a = _activity.setdefault(knob, {"decisions": 0, "explorations": 0, "measured_flips": 0})
                a["decisions"] += 1
        _last = pd
    return pd


def _record(pd: PlanDecisions) -> None:
    """The decisions on the ambient ledger and span, at decide time."""
    try:
        from ..telemetry import accounting, tracing

        d = pd.to_ledger()
        accounting.set_value("planner", d)
        sp = tracing.current_span()
        if sp is not None:
            sp.set_attr("planner", d)
    except Exception:
        pass


def observe(pd: Optional[PlanDecisions], wall_s: float, pruning=None, stages=None) -> None:
    """Feed one query's measured wall (and stage walls) to the outcome
    store. No store is ported, so this returns as the JAX package's does
    with none configured (`planner.observe` :677-681)."""


def annotate_close(led, wall_s: float) -> None:
    """At the ledger's close: the measured wall beside the decisions, each
    knob's `drift_x`, and with stage vectors its `stage_actual_s` and
    `stage_drift_x` (`planner.annotate_close`; no history baseline)."""
    from . import attribution as _attribution

    p = led.get("planner")
    if not isinstance(p, dict):
        return
    p["actual_wall_s"] = round(float(wall_s), 6)
    stages = led.get("stages")
    stage_walls = None
    if isinstance(stages, dict) and stages:
        stage_walls = {st: vec.get("wall_s", 0.0) for st, vec in stages.items()
                       if isinstance(vec, dict) and vec.get("wall_s")}
    for knob, d in p.items():
        if isinstance(d, dict) and isinstance(d.get("predicted_s"), (int, float)):
            pred = d["predicted_s"]
            d["drift_x"] = round(wall_s / pred, 3) if pred and pred > 0 else None
            if stage_walls:
                stage_s = _attribution.knob_stage_seconds(knob, stage_walls)
                if stage_s is not None:
                    d["stage_actual_s"] = round(stage_s, 6)
                    d["stage_drift_x"] = round(stage_s / pred, 3) if pred and pred > 0 else None


def last_decisions() -> Optional[PlanDecisions]:
    """The decisions of the last query planned in this process."""
    with _activity_lock:
        return _last


def activity_summary() -> Dict[str, dict]:
    """Per knob: decisions, explorations and measured flips (the last two
    stay 0 without the outcome store)."""
    with _activity_lock:
        return {k: dict(v) for k, v in sorted(_activity.items())}


def reset() -> None:
    """Forget the activity and the last decisions (tests)."""
    global _last
    with _activity_lock:
        _activity.clear()
        _last = None
