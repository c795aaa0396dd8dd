"""Join memos (`engine/physical.py`): the share of the pairs memo's lookups
over the window that hit (`physical.memo_stats()["pairs"]`), in percent."""


def read(run):
    hits = run.after["memo"]["pairs"]["hits"] - run.before["memo"]["pairs"]["hits"]
    misses = run.after["memo"]["pairs"]["misses"] - run.before["memo"]["pairs"]["misses"]
    return 100.0 * hits / (hits + misses) if hits + misses else None
