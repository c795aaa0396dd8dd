"""Scan (`engine/io.py`, `engine/scan_cache.py`): parquet files the scans
decoded over the window (`io.io_stats()["decode_files"]`), per query sent."""


def read(run):
    if not run.queries:
        return None
    return (run.after["io"]["decode_files"] - run.before["io"]["decode_files"]) / len(run.queries)
