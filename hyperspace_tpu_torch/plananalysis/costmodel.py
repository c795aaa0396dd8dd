"""Plan-time cost model: both arms of every governed knob priced in seconds
of bytes moved (counterpart of `hyperspace_tpu/plananalysis/costmodel.py`).

    predicted_s = bytes_moved / measured_bandwidth  (+ per-event constants)

`collect_stats` walks one physical plan and peeks the footer entries the
scan cache already holds (`engine.scan_cache.get_meta`): row counts,
row-group bytes and which columns are dictionary-encoded. It never opens a
file: a cold file contributes its listed size only. `current_calibration`
reads the copy rate (pinned by `HYPERSPACE_PLANNER_MEMCPY_GBPS`, else the
host-to-device rate the port's scans measured, else a default) and
`estimate` prices both arms of every knob with the JAX package's constants
and arithmetic. The model keeps each flag's default unless the stats are
warm and decisive: on an aggregate over at least a million warm rows it
shapes `chunk_rows` to the power of two nearest 64 MiB of decoded rows.
Choosing lives in `plananalysis/planner.py`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

#: Every knob the planner governs, in exploration-priority order.
KNOBS = (
    "hash_quantize",
    "streaming",
    "chunk_rows",
    "encoded_exec",
    "packed_codes",
    "pushdown",
    "join_size_classes",
    "multiway",
)

#: knob → the env flag that pins it (set: pinned; unset: the planner's).
KNOB_ENV = {
    "hash_quantize": "HYPERSPACE_HASH_QUANTIZE",
    "streaming": "HYPERSPACE_QUERY_STREAMING",
    "chunk_rows": "HYPERSPACE_QUERY_CHUNK_ROWS",
    "encoded_exec": "HYPERSPACE_ENCODED_EXEC",
    "packed_codes": "HYPERSPACE_PACKED_CODES",
    "pushdown": "HYPERSPACE_SCAN_PUSHDOWN",
    "join_size_classes": "HYPERSPACE_JOIN_SIZE_CLASSES",
    "multiway": "HYPERSPACE_MULTIWAY",
}

INT_KNOBS = ("chunk_rows",)

#: Pins the copy rate the pricing divides by (GB/s).
ENV_MEMCPY_GBPS = "HYPERSPACE_PLANNER_MEMCPY_GBPS"

_DEFAULT_MEMCPY_GBPS = 8.0
_DEFAULT_DECODE_GBPS = 1.5
_HOST_COMPILE_S = 0.03
_DEVICE_COMPILE_S = 0.5
_CHUNK_OVERHEAD_S = 0.0008
_TARGET_CHUNK_BYTES = 64 << 20
_DEFAULT_CHUNK_ROWS = 4_000_000  # streaming._DEFAULT_QUERY_CHUNK_ROWS
_MIN_CHUNK_ROWS = 65_536
#: Below this many warm rows the chunk shaper keeps the default.
_CHUNK_SHAPE_MIN_ROWS = 1_000_000
_EST_ROW_BYTES = 50  # cold: rows from file bytes
_EST_DECODE_RATIO = 3.0  # cold: decoded from compressed bytes
_CODE_BYTES_PER_ROW = 1.25  # narrow codes + validity, per dictionary column


@dataclass
class Calibration:
    """The constants the pricing uses; `source` says where the bandwidth came
    from ("env", "measured" or "default")."""

    memcpy_gbps: float = _DEFAULT_MEMCPY_GBPS
    decode_gbps: float = _DEFAULT_DECODE_GBPS
    compile_s: float = _HOST_COMPILE_S
    chunk_overhead_s: float = _CHUNK_OVERHEAD_S
    device: bool = False
    source: str = "default"


def current_calibration(device=None) -> Calibration:
    """The calibration of a session on `device`: `device` is true on CUDA;
    the bandwidth is `HYPERSPACE_PLANNER_MEMCPY_GBPS` when set ("env"), else
    the host-to-device rate of the scans' copies so far (`io.h2d_stats`,
    "measured"; none on the CPU), else the default. Never raises."""
    cal = Calibration()
    env = os.environ.get(ENV_MEMCPY_GBPS, "")
    if env:
        try:
            cal.memcpy_gbps = max(0.01, float(env))
            cal.source = "env"
        except ValueError:
            pass
    else:
        try:
            from ..engine.io import h2d_stats

            gbps = h2d_stats()["gb_per_s"]
            if gbps:
                cal.memcpy_gbps = max(0.01, float(gbps))
                cal.source = "measured"
        except Exception:
            pass
    cal.device = device is not None and getattr(device, "type", str(device)) == "cuda"
    cal.compile_s = _DEVICE_COMPILE_S if cal.device else _HOST_COMPILE_S
    return cal


@dataclass
class PlanStats:
    """The plan's shape and the footer facts of its warm files."""

    n_scans: int = 0
    n_files: int = 0
    warm_files: int = 0
    file_bytes: int = 0  # on-disk bytes (every file)
    rows: int = 0  # footer rows (warm files)
    decoded_bytes: int = 0  # uncompressed row-group bytes (warm files)
    dict_cols: int = 0  # distinct dictionary-encoded columns
    dict_col_bytes: int = 0  # their uncompressed bytes
    row_shapes: Set[int] = field(default_factory=set)  # per-file row counts
    has_agg: bool = False
    has_join: bool = False
    has_filter: bool = False
    star_dims: int = 0  # dimensions of the plan's MultiwayJoinExec (0: none)

    def est_rows(self) -> int:
        return self.rows if self.rows else max(1, self.file_bytes // _EST_ROW_BYTES)

    def est_decoded_bytes(self) -> int:
        return self.decoded_bytes if self.decoded_bytes else int(self.file_bytes * _EST_DECODE_RATIO)

    def fully_warm(self) -> bool:
        return self.n_files > 0 and self.warm_files == self.n_files


def collect_stats(phys) -> PlanStats:
    """Walk one physical plan and peek the footer cache for every scanned
    file. A `MultiwayJoinExec` carries its cascade as a child, so one
    relation is reached twice: it is counted once."""
    from ..engine.scan_cache import global_scan_cache

    cache = global_scan_cache()
    st = PlanStats()
    dict_col_names: Set[str] = set()
    seen_rels: Set[int] = set()
    for node in phys.collect_nodes():
        kind = type(node).__name__
        if kind == "HashAggregateExec":
            st.has_agg = True
        elif kind == "SortMergeJoinExec":
            st.has_join = True
        elif kind == "MultiwayJoinExec":
            st.has_join = True
            st.star_dims = max(st.star_dims, len(node.dims))
        elif kind == "FilterExec":
            st.has_filter = True
        rel = getattr(node, "relation", None)
        if rel is None or id(rel) in seen_rels:
            continue
        seen_rels.add(id(rel))
        st.n_scans += 1
        for f in getattr(rel, "files", None) or ():
            st.n_files += 1
            st.file_bytes += int(getattr(f, "size", 0) or 0)
            try:
                # The listing's (path, size, mtime) is the cache's freshness
                # key: a peek costs no stat.
                meta = cache.get_meta(f.path, (f.path, int(f.size), int(f.modified_time)))
            except Exception:
                meta = None
            if meta is None:
                continue
            st.warm_files += 1
            st.rows += int(meta.num_rows or 0)
            st.row_shapes.add(int(meta.num_rows or 0))
            for rg in meta.row_groups:
                st.decoded_bytes += int(rg.total_bytes or 0)
                for c, b in rg.col_bytes.items():
                    if meta.dict_cols.get(c):
                        st.dict_col_bytes += int(b or 0)
                        dict_col_names.add(c)
    st.dict_cols = len(dict_col_names)
    return st


def _pow2(n: int) -> int:
    return 1 << max(1, int(n) - 1).bit_length()


def _copy_s(nbytes: float, cal: Calibration) -> float:
    return float(nbytes) / (cal.memcpy_gbps * 1e9)


def _decode_s(nbytes: float, cal: Calibration) -> float:
    return float(nbytes) / (cal.decode_gbps * 1e9)


def shaped_chunk_rows(stats: PlanStats) -> int:
    """The model's `chunk_rows`: pow2(64 MiB / decoded bytes a row), within
    [65,536, 4,000,000], for an aggregate over at least a million rows whose
    every footer is warm; the default otherwise."""
    rows, decoded = stats.est_rows(), stats.est_decoded_bytes()
    if not (stats.has_agg and stats.fully_warm() and rows >= _CHUNK_SHAPE_MIN_ROWS and decoded > 0):
        return _DEFAULT_CHUNK_ROWS
    chunk = int(_TARGET_CHUNK_BYTES / max(1.0, decoded / max(1, rows)))
    return max(_MIN_CHUNK_ROWS, min(_DEFAULT_CHUNK_ROWS, _pow2(chunk)))


def estimate(
    stats: PlanStats, cal: Calibration, prune_selectivity: Optional[float] = None
) -> Dict[str, Tuple[object, object, float, float]]:
    """``{knob: (model_value, alt_value, predicted_s_model, predicted_s_alt)}``
    for this plan (`costmodel.estimate` :237): marginal attributable seconds
    of each arm; equal predictions mean the plan does not exercise the knob.
    `prune_selectivity` replaces the pushdown's half-prune prior."""
    out: Dict[str, Tuple[object, object, float, float]] = {}
    rows = stats.est_rows()
    decoded = stats.est_decoded_bytes()

    # Streamed against materialized: the materialized arm copies the whole
    # concatenation once more before reducing.
    stream_s = _decode_s(decoded, cal)
    alt = stream_s + _copy_s(decoded, cal) if stats.has_agg else stream_s
    out["streaming"] = (True, False, round(stream_s, 9), round(alt, 9))

    chunk = shaped_chunk_rows(stats)

    def _chunk_cost(v: int) -> float:
        n_chunks = max(1, -(-rows // v))
        row_bytes = max(1.0, decoded / max(1, rows))
        spill = max(0.0, v * row_bytes - _TARGET_CHUNK_BYTES) * n_chunks
        return n_chunks * cal.chunk_overhead_s + _copy_s(spill, cal)

    out["chunk_rows"] = (chunk, _DEFAULT_CHUNK_ROWS, round(_chunk_cost(chunk), 9),
                         round(_chunk_cost(_DEFAULT_CHUNK_ROWS), 9))

    # Codes and a dictionary against decoded values, per dictionary column.
    code_bytes = rows * stats.dict_cols * _CODE_BYTES_PER_ROW
    out["encoded_exec"] = (True, False, round(_copy_s(code_bytes, cal), 9),
                           round(_copy_s(max(stats.dict_col_bytes, code_bytes), cal), 9))

    # Sub-byte lanes: the 4-bit midpoint against one byte a code.
    narrow_bytes = rows * stats.dict_cols
    out["packed_codes"] = (True, False, round(_copy_s(narrow_bytes / 2.0, cal), 9),
                           round(_copy_s(narrow_bytes, cal), 9))

    # Row-group pruning: every pruned row group's decode is saved.
    full = round(_decode_s(decoded, cal), 9)
    if stats.has_filter and stats.warm_files:
        sel = 0.5
        if prune_selectivity is not None:
            try:
                sel = min(1.0, max(0.0, float(prune_selectivity)))
            except (TypeError, ValueError):
                sel = 0.5
        out["pushdown"] = (True, False, round(_decode_s(decoded * sel, cal), 9), full)
    else:
        out["pushdown"] = (True, False, full, full)

    # Hash quantization: pow2 padded copies against one build per row shape
    # on a device. The port decides and records it, but no gate reads it.
    if stats.has_agg or stats.has_join:
        hashed_rows = min(rows, chunk)
        n_batches = max(1, -(-rows // max(1, hashed_rows)))
        quant_on = _copy_s((_pow2(hashed_rows) - hashed_rows) * 8.0 * n_batches, cal)
        quant_off = max(1, len(stats.row_shapes) or 1) * cal.compile_s if cal.device else 0.0
        pair = (round(quant_on, 9), round(quant_off, 9)) if cal.device else (round(quant_off, 9), round(quant_on, 9))
        out["hash_quantize"] = (cal.device, not cal.device) + pair
    else:
        out["hash_quantize"] = (cal.device, not cal.device, 0.0, 0.0)

    # Size classes: per-class dispatch against a representative pad risk.
    if stats.has_join:
        classed_s = 8 * cal.chunk_overhead_s
        out["join_size_classes"] = (True, False, round(classed_s, 9),
                                    round(classed_s + _copy_s(decoded * 0.25, cal), 9))
    else:
        out["join_size_classes"] = (True, False, 0.0, 0.0)

    # The star pass's key64 probes against the cascade's intermediate tables.
    if stats.star_dims >= 2:
        row_bytes = max(1.0, decoded / max(1, rows))
        inter_bytes = rows * row_bytes * (stats.star_dims - 1)
        probe_bytes = rows * 8.0 * stats.star_dims
        out["multiway"] = (True, False, round(_copy_s(probe_bytes, cal), 9), round(_copy_s(inter_bytes, cal), 9))
    else:
        out["multiway"] = (True, False, 0.0, 0.0)
    return out
