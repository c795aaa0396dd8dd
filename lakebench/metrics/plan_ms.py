"""Planning and rewrite (`engine/session.py`, `rules/`, `plananalysis/`): the
median over the window's queries of their `plan` span, in ms (the program's
tracing is on in a traced run)."""

import statistics


def read(run):
    plans = [s["duration_s"] for s in run.spans if s["name"] == "plan" and s.get("duration_s") is not None]
    return 1e3 * statistics.median(plans) if plans else None
