"""The planner: every governed knob decided per plan, and learned from the
measured walls (counterpart of `hyperspace_tpu/plananalysis/planner.py`).

A knob's env flag that is set pins it: the planner reports it as "pinned"
and the gate never asks. An unset flag hands the knob to the planner, which
takes the cost model's arm (`costmodel.estimate`) unless its outcome store
has learned otherwise. `decide` runs after physical planning;
`decisions_scope` installs its `PlanDecisions` on this thread and on the
query's `resilience.QueryScope`, so every pool worker that adopts the scope
sees the same decisions. The gates (`streaming.streaming_enabled`,
`multiway_enabled`, `query_chunk_rows`, `pushdown.pushdown_enabled`,
`encoding.encoded_exec_enabled`, `packed_codes.packed_codes_enabled`,
`bucket_join.size_classes_enabled`) read `decided_value(knob)` only when
their flag is unset. `HYPERSPACE_PLANNER=0` turns the planner off: one env
read, and every gate answers its flag's default.

`hash_quantize` is decided and recorded (on for a CUDA session), but the
port has no gate for it: its kernels are built once for every shape, so a
pow2 padding of hashed batches buys nothing.

**Learning.** With a persistent home (`outcome_dir`: `HYPERSPACE_PLANNER_DIR`,
else `<history_dir>/planner` under `HYPERSPACE_HISTORY=1`) every decided
query's measured wall, its knob stage subtotals and its row-group pruning
delta land in the `OutcomeStore` (`planner-<host>-<pid>-<uuid>.jsonl`
segments, the JAX package's records, re-folded when a store opens). Per
(fingerprint, knob, arm):
- once both arms hold `HYPERSPACE_PLANNER_MIN_SAMPLES` samples, the alternative
  wins ("measured") when its mean is under 0.9 of the model arm's (stage
  subtotals when both arms have them, else walls);
- before that, a chosen arm whose measured cost drifts past
  `HYPERSPACE_PLANNER_DRIFT_X` times its prediction (at least 5 ms) sends
  one knob per query to its alternative ("explore");
- the measured scanned share of the class's row groups replaces the
  pushdown arm's half-prune prior.
An arm stops appending after `_PERSIST_CAP` samples, so the store grows
with the classes, not the queries. Every arm gives the same rows (the
flags' contract), so learning changes times, never answers.

The session measures the wall it feeds `observe` around the run, after
`collect()`'s copy to the host: on the card it includes the device work.
The decisions land on the query's ledger and root span (`_record`); at the
ledger's close `annotate_close` adds the measured wall, each knob's drift
at query and stage grain and, with history on, the class baseline.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import socket
import threading
import time
import uuid
from typing import Dict, Iterator, Optional

from .costmodel import INT_KNOBS, KNOB_ENV, KNOBS

ENV_PLANNER = "HYPERSPACE_PLANNER"
ENV_PLANNER_DIR = "HYPERSPACE_PLANNER_DIR"
ENV_MIN_SAMPLES = "HYPERSPACE_PLANNER_MIN_SAMPLES"
ENV_DRIFT_X = "HYPERSPACE_PLANNER_DRIFT_X"

_DEFAULT_MIN_SAMPLES = 4
_DEFAULT_DRIFT_X = 1.5
#: An arm appends outcome records until it holds this many samples.
_PERSIST_CAP = 64
#: The alternative must measure under this share of the model arm to win.
_FLIP_MARGIN = 0.9
#: Drift below this predicted cost is not evidence.
_MIN_PRED_S = 0.005


def planner_enabled() -> bool:
    """On unless `HYPERSPACE_PLANNER` is "0"."""
    return os.environ.get(ENV_PLANNER, "") != "0"


def _min_samples() -> int:
    raw = os.environ.get(ENV_MIN_SAMPLES, "")
    try:
        return max(1, int(raw)) if raw else _DEFAULT_MIN_SAMPLES
    except ValueError:
        return _DEFAULT_MIN_SAMPLES


def _drift_x() -> float:
    raw = os.environ.get(ENV_DRIFT_X, "")
    try:
        return max(1.0, float(raw)) if raw else _DEFAULT_DRIFT_X
    except ValueError:
        return _DEFAULT_DRIFT_X


def arm_label(value) -> str:
    """Bools as on/off, ints as their decimal value."""
    if isinstance(value, bool):
        return "on" if value else "off"
    return str(int(value))


class Decision:
    """One knob for one plan: the chosen value, its single alternative, both
    arms' predicted seconds, and the source: "model", "measured" (the store's
    flip), "explore" (sampling the alternative after drift) or "pinned"."""

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


class _ArmStat:
    """Folded samples of one (fingerprint, knob, arm): walls, predictions
    and, when the query carried stage attribution, the knob's stage
    subtotals."""

    __slots__ = ("n", "wall_sum", "pred_sum", "stage_n", "stage_sum")

    def __init__(self):
        self.n = 0
        self.wall_sum = 0.0
        self.pred_sum = 0.0
        self.stage_n = 0
        self.stage_sum = 0.0

    def fold(self, wall_s: float, predicted_s: float, stage_s=None) -> None:
        self.n += 1
        self.wall_sum += float(wall_s)
        self.pred_sum += float(predicted_s)
        if isinstance(stage_s, (int, float)) and stage_s > 0:
            self.stage_n += 1
            self.stage_sum += float(stage_s)

    def mean_wall(self) -> float:
        return self.wall_sum / self.n if self.n else 0.0

    def mean_pred(self) -> float:
        return self.pred_sum / self.n if self.n else 0.0

    def mean_stage(self) -> float:
        return self.stage_sum / self.stage_n if self.stage_n else 0.0


class OutcomeStore:
    """The folded outcome stats of one directory and this writer's append
    segment (one write and flush a record; a torn last line is skipped on
    read, as in the history store). Also folds each class's row-group
    pruning counters, `[scanned, skipped]`."""

    def __init__(self, dir_path: str):
        self.dir = dir_path
        self._lock = threading.Lock()
        self._stats: Dict[tuple, _ArmStat] = {}
        self._prune: Dict[str, list] = {}
        self._fh = None
        os.makedirs(dir_path, exist_ok=True)
        self._load()

    def _load(self) -> None:
        from ..telemetry import history as _history

        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            names = []
        for n in names:
            if not (n.startswith("planner-") and n.endswith(".jsonl")):
                continue
            for rec in _history.iter_file_records(os.path.join(self.dir, n)):
                fp, outcomes = rec.get("fingerprint"), rec.get("outcomes")
                if rec.get("kind") != "planner_outcome" or not fp or not isinstance(outcomes, dict):
                    continue
                pr = rec.get("pruning")
                if isinstance(pr, (list, tuple)) and len(pr) == 2:
                    try:
                        self._fold_prune(fp, int(pr[0]), int(pr[1]))
                    except (TypeError, ValueError):
                        pass
                for knob, o in outcomes.items():
                    if not isinstance(o, dict):
                        continue
                    try:
                        # A version-1 record has no stage_s: it folds walls only.
                        self._fold(fp, knob, str(o["arm"]), float(o["wall_s"]), float(o.get("predicted_s", 0.0)),
                                   stage_s=o.get("stage_s"))
                    except (KeyError, TypeError, ValueError):
                        continue

    def _fold(self, fp, knob, arm, wall_s, predicted_s, stage_s=None) -> _ArmStat:
        st = self._stats.get((fp, knob, arm))
        if st is None:
            st = self._stats[(fp, knob, arm)] = _ArmStat()
        st.fold(wall_s, predicted_s, stage_s=stage_s)
        return st

    def _fold_prune(self, fp: str, scanned: int, skipped: int) -> None:
        p = self._prune.setdefault(fp, [0, 0])
        p[0] += max(0, scanned)
        p[1] += max(0, skipped)

    def stat(self, fp: str, knob: str, arm: str) -> _ArmStat:
        with self._lock:
            return self._stats.get((fp, knob, arm)) or _ArmStat()

    def prune_selectivity(self, fp: str) -> Optional[float]:
        """The class's measured scanned share of its row groups; None before
        any of its queries pruned through a zone map."""
        with self._lock:
            p = self._prune.get(fp)
        if not p or p[0] + p[1] <= 0:
            return None
        return p[0] / (p[0] + p[1])

    def observe(self, fp: str, outcomes: Dict[str, dict], pruning=None) -> None:
        """Fold one query's outcomes and append its record, without the arms
        that already hold `_PERSIST_CAP` samples. `pruning` is its
        `(scanned, skipped)` row-group delta, folded even when no arm
        appends."""
        persist = {}
        with self._lock:
            if isinstance(pruning, (list, tuple)) and len(pruning) == 2:
                try:
                    self._fold_prune(fp, int(pruning[0]), int(pruning[1]))
                except (TypeError, ValueError):
                    pruning = None
            else:
                pruning = None
            for knob, o in outcomes.items():
                st = self._fold(fp, knob, o["arm"], o["wall_s"], o.get("predicted_s", 0.0), stage_s=o.get("stage_s"))
                if st.n <= _PERSIST_CAP:
                    persist[knob] = o
            if not persist:
                return
            # A record with stage subtotals is version 2; each version's
            # reader tolerates the other.
            versioned = any(isinstance(o.get("stage_s"), (int, float)) for o in persist.values())
            rec = {"schema_version": 2 if versioned else 1, "kind": "planner_outcome",
                   "ts": round(time.time(), 6), "fingerprint": fp, "outcomes": persist}
            if pruning is not None:
                rec["pruning"] = [int(pruning[0]), int(pruning[1])]
            try:
                if self._fh is None:
                    name = f"planner-{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}.jsonl"
                    self._fh = open(os.path.join(self.dir, name), "a")
                self._fh.write(json.dumps(rec, default=str) + "\n")
                self._fh.flush()
            except OSError:
                pass  # learning never fails the query it observed

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def summary(self) -> Dict[tuple, dict]:
        with self._lock:
            out = {}
            for key, st in self._stats.items():
                row = {"n": st.n, "mean_wall_s": round(st.mean_wall(), 6),
                       "mean_predicted_s": round(st.mean_pred(), 6)}
                if st.stage_n:
                    row["stage_n"] = st.stage_n
                    row["mean_stage_s"] = round(st.mean_stage(), 6)
                out[key] = row
            return out


_stores: Dict[str, OutcomeStore] = {}
_stores_lock = threading.Lock()


def outcome_dir() -> Optional[str]:
    """`HYPERSPACE_PLANNER_DIR`, else `<history_dir>/planner` under
    `HYPERSPACE_HISTORY=1`, else None: no persistent home, no learning."""
    env = os.environ.get(ENV_PLANNER_DIR, "")
    if env:
        return env
    from ..telemetry import history as _history

    if _history.enabled():
        return os.path.join(_history.history_dir(), "planner")
    return None


def _outcome_store() -> Optional[OutcomeStore]:
    d = outcome_dir()
    if d is None:
        return None
    d = os.path.abspath(d)
    with _stores_lock:
        st = _stores.get(d)
        if st is None:
            try:
                st = _stores[d] = OutcomeStore(d)
            except OSError:
                return None
        return st


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

    stats = costmodel.collect_stats(phys)
    cal = costmodel.current_calibration(device)
    store = _outcome_store() if fingerprint else None
    sel = store.prune_selectivity(fingerprint) if store is not None else None
    if sel is None:
        est = costmodel.estimate(stats, cal)
    else:
        try:
            est = costmodel.estimate(stats, cal, prune_selectivity=sel)
        except TypeError:  # a test's two-argument estimator
            est = costmodel.estimate(stats, cal)
    min_n, drift_x = _min_samples(), _drift_x()
    decisions: Dict[str, Decision] = {}
    explore_claimed = False
    for knob in KNOBS:
        raw = os.environ.get(KNOB_ENV[knob], "")
        model_v, alt_v, pred_m, pred_a = est.get(knob, (True, False, 0.0, 0.0))
        if raw != "":
            decisions[knob] = Decision(knob, _pinned_value(knob, raw), alt_v, pred_m, pred_a, "pinned")
            continue
        value, source = model_v, "model"
        if store is not None:
            sm = store.stat(fingerprint, knob, arm_label(model_v))
            sa = store.stat(fingerprint, knob, arm_label(alt_v))
            if sm.n >= min_n and sa.n >= min_n:
                # Both arms measured: stage subtotals when both have enough,
                # so a stage the knob does not govern cannot mask it.
                if sm.stage_n >= min_n and sa.stage_n >= min_n:
                    flip = sa.mean_stage() < sm.mean_stage() * _FLIP_MARGIN
                else:
                    flip = sa.mean_wall() < sm.mean_wall() * _FLIP_MARGIN
                if flip:
                    value, source = alt_v, "measured"
            elif (not explore_claimed and sm.n >= min_n and sa.n < min_n and sm.mean_pred() >= _MIN_PRED_S
                  and (sm.mean_stage() if sm.stage_n >= min_n else sm.mean_wall()) > drift_x * sm.mean_pred()):
                # The model misprices this class: sample the alternative, one
                # knob a query so a whole wall still tells the arms apart.
                value, source, explore_claimed = alt_v, "explore", True
        if value == model_v:
            decisions[knob] = Decision(knob, value, alt_v, pred_m, pred_a, source)
        else:
            decisions[knob] = Decision(knob, value, model_v, pred_a, pred_m, source)
    pd = PlanDecisions(fingerprint, decisions, cal.source)
    _record(pd)
    with _activity_lock:
        for knob, d in decisions.items():
            if d.source == "pinned":
                continue
            a = _activity.setdefault(knob, {"decisions": 0, "explorations": 0, "measured_flips": 0})
            a["decisions"] += 1
            if d.source == "explore":
                a["explorations"] += 1
            elif d.source == "measured":
                a["measured_flips"] += 1
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


def prune_counters(base=None):
    """The `io.pruning` row-group counters as `(scanned, skipped)`: absolute
    when `base` is None, else the delta since `base`, clamped at 0. None if
    they cannot be read. Never raises."""
    try:
        from ..telemetry import metrics as _metrics

        s = int(_metrics.counter("io.pruning.row_groups_scanned").value)
        k = int(_metrics.counter("io.pruning.row_groups_skipped").value)
    except Exception:
        return None
    if base is not None:
        try:
            s, k = max(0, s - int(base[0])), max(0, k - int(base[1]))
        except (TypeError, ValueError, IndexError):
            return None
    return (s, k)


def observe(pd: Optional[PlanDecisions], wall_s: float, pruning=None, stages=None) -> None:
    """Feed one query's measured wall to the outcome store: it lands on every
    decided knob's chosen arm (the fingerprint holds all else fixed, and one
    knob explores at a time), with each knob's stage subtotal from `stages`
    (`attribution.query_stage_walls()`) and the class's row-group `pruning`
    delta (`prune_counters`). No store, no work. Never raises."""
    if pd is None or pd.fingerprint is None:
        return
    try:
        store = _outcome_store()
        if store is None:
            return
        from . import attribution as _attribution

        outcomes = {}
        for knob, d in pd.decisions.items():
            if d.source == "pinned":
                continue
            o = {"arm": d.arm, "wall_s": round(float(wall_s), 6), "predicted_s": d.predicted_s}
            stage_s = _attribution.knob_stage_seconds(knob, stages)
            if stage_s is not None:
                o["stage_s"] = round(float(stage_s), 6)
            outcomes[knob] = o
        if outcomes:
            store.observe(pd.fingerprint, outcomes, pruning=pruning)
    except Exception:
        pass


def annotate_close(led, wall_s: float) -> None:
    """At the ledger's close: the measured wall beside the decisions, each
    knob's `drift_x`, with stage vectors its `stage_actual_s` and
    `stage_drift_x`, and with history on the class's `baseline_mean_s` and
    `vs_baseline_x`."""
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
    try:
        from ..telemetry import history as _history

        fp = led.get("plan_fingerprint")
        if fp and _history.enabled():
            bl = _history.get_store().baseline_for(fp)
            if bl is not None and bl.count:
                mean, _ = bl.mean_std()
                p["baseline_mean_s"] = round(mean, 6)
                p["vs_baseline_x"] = round(wall_s / mean, 3) if mean else None
    except Exception:
        pass


def last_decisions() -> Optional[PlanDecisions]:
    """The decisions of the last query planned in this process."""
    with _activity_lock:
        return _last


def activity_summary() -> Dict[str, dict]:
    """Per knob: decisions, explorations and measured flips."""
    with _activity_lock:
        return {k: dict(v) for k, v in sorted(_activity.items())}


def outcome_summary() -> Dict[tuple, dict]:
    """The active store's folded (fingerprint, knob, arm) stats; empty with
    no persistent home."""
    store = _outcome_store()
    return store.summary() if store is not None else {}


def reset() -> None:
    """Close and forget every outcome store, the activity and the last
    decisions (tests). The files stay: the next store folds them again."""
    global _last
    with _stores_lock:
        for st in _stores.values():
            st.close()
        _stores.clear()
    with _activity_lock:
        _activity.clear()
        _last = None
