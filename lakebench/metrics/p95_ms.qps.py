"""serve (`serve/scheduler.py`): the 95th percentile latency, `submit` to the
rows on the host, of the queries completed in the window, in ms. A closed
loop runs at capacity and the host paces these cells, so the tail is a
per-layer reading here; throughput is the end-to-end metric it moves."""

import numpy as np


def read(run):
    lat = [q.latency_s for q in run.completed()]
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) >= 200 else None
