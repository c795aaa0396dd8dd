"""DataSkippingFilterRule: prune source files from scans by per-file sketches.

Counterpart of `hyperspace_tpu/rules/data_skipping_rule.py` (BASELINE.md
config 4). Unlike the covering-index rules, which replace the relation, this
rule keeps the source relation and shrinks its file list: for each filter
conjunct on a sketched column, the files whose MinMax range (or every
row-group zone) excludes the literal, or whose bloom filter rejects it, are
dropped, and the scan names the indexes that pruned it (`pruned_by`). It runs
after `JoinIndexRule` and `FilterIndexRule`, on the scans they left in place.

Conjuncts are normalized and zones decided by the scan layer's evaluator
(`engine/pushdown.normalize_conjunct`, `minmax_keeps`), so the rule and the
row-group pushdown share one soundness contract. The port departs from the
JAX package where that package prunes a file holding a match: a NaN or null
bound (an all-NaN or all-null file, see `index/dataskipping.py`) and a NaN
literal always keep. The bloom probe hashes each literal once per query,
not once per file.

A failure leaves the plan as it was. The JAX package's rule-decision record
and index-usage event wait for the port's telemetry (ROADMAP.md Queue 1,
item 12).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

import numpy as np

from ..engine import io as engine_io
from ..engine.expr import split_conjuncts
from ..engine.logical import FilterNode, LogicalPlan, ScanNode, SourceRelation
from ..engine.pushdown import minmax_keeps, normalize_conjunct
from ..index.dataskipping import (
    DATA_SKIPPING_KIND,
    FILE_COLUMN,
    BloomFilterSketch,
    MinMaxSketch,
    bloom_positions,
    hex_to_bits,
    literal_hashes,
    sketches_of,
)
from ..index.log_entry import IndexLogEntry
from ..util.resolver_utils import resolution_key
from ..telemetry.event_logging import log_event
from ..telemetry.events import HyperspaceIndexUsageEvent
from .rule_utils import get_candidate_indexes, log_rule_failure, record_rule_decision

_MINMAX_OPS = ("==", "<", "<=", ">", ">=")
_BLOOM_OPS = ("==", "in")


def _unknown(v) -> bool:
    """A bound or literal no comparison can decide: null or NaN."""
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def _zones_exclude(zones, op: str, value) -> bool:
    """True when EVERY recorded row-group zone of a file excludes `col op
    value` (`data_skipping_rule._zones_exclude` :38). No zones ([]), a
    zone without statistics (None) or a NaN bound keeps the file."""
    if not zones:
        return False
    for z in zones:
        if z is None or _unknown(z[0]) or _unknown(z[1]) or minmax_keeps(op, value, z[0], z[1]):
            return False
    return True


class _Sketches:
    """One index version's sketch table on the host: the columns by name,
    each source file's row, and the parsed row-group zones and bloom bit
    matrices, made on first use."""

    def __init__(self, entry: IndexLogEntry):
        t = engine_io.read_files(entry.content.files(), "parquet", None, "cpu")
        self.columns = t.to_numpy()
        self.row_of = {p: i for i, p in enumerate(self.columns.get(FILE_COLUMN, []))}
        self._zones: Dict[str, list] = {}
        self._bits: Dict[str, np.ndarray] = {}

    def zones(self, column: str) -> list:
        if column not in self._zones:
            raw = self.columns.get(f"rgzm_{column}")
            self._zones[column] = [] if raw is None else [json.loads(z) for z in raw]
        return self._zones[column]

    def bits(self, s: BloomFilterSketch) -> np.ndarray:
        """[files, num_bits] uint8: row i is file i's bloom bitset."""
        if s.column not in self._bits:
            self._bits[s.column] = np.stack([hex_to_bits(h, s.num_bits) for h in self.columns[f"bloom_{s.column}"]])
        return self._bits[s.column]

    def minmax_keep(self, s: MinMaxSketch, op: str, value, rows: np.ndarray) -> np.ndarray:
        """Per sketch row in `rows`: can the file hold a row with `col op value`?"""
        if _unknown(value):
            return np.ones(len(rows), bool)
        mins, maxs = self.columns[f"min_{s.column}"], self.columns[f"max_{s.column}"]
        zones = self.zones(s.column) if s.granularity == "rowgroup" else []
        out = np.ones(len(rows), bool)
        for j, i in enumerate(rows):
            mn, mx = mins[i], maxs[i]
            if _unknown(mn) or _unknown(mx):
                continue
            if not minmax_keeps(op, value, mn, mx):
                out[j] = False
            elif zones and _zones_exclude(zones[i], op, value):
                # The file's range straddles the literal, but no row group's does.
                out[j] = False
        return out

    def bloom_keep(self, s: BloomFilterSketch, values: list, column_dtype: str, rows: np.ndarray) -> np.ndarray:
        """Per sketch row in `rows`: may the file hold any of `values`? Each
        literal is hashed once for all files."""
        bits = self.bits(s)[rows]
        out = np.zeros(len(rows), bool)
        for v in values:
            hashes = literal_hashes(v, column_dtype)
            if hashes is None:
                return np.ones(len(rows), bool)  # cannot be probed: keep
            out |= bits[:, bloom_positions(hashes, s.num_bits, s.num_hashes)].all(axis=1)
        return out


class DataSkippingFilterRule:
    """Rule protocol: apply(plan, session) -> plan."""

    def __init__(self):
        # Sketch tables cached across queries, keyed by the index name and its
        # content files with their sizes and modification times: a refresh
        # writes new files, so a stale sketch is never read again.
        self._sketch_cache: Dict[tuple, _Sketches] = {}

    def _sketches(self, entry: IndexLogEntry) -> _Sketches:
        key = (entry.name, tuple((f.name, f.size, f.modified_time) for f in entry.content.file_infos()))
        hit = self._sketch_cache.get(key)
        if hit is None:
            hit = _Sketches(entry)
            self._sketch_cache = {k: v for k, v in self._sketch_cache.items() if k[0] != entry.name}
            self._sketch_cache[key] = hit
        return hit

    def apply(self, plan: LogicalPlan, session) -> LogicalPlan:
        from ..hyperspace import _index_manager_for

        try:
            index_manager = _index_manager_for(session)
            cs = session.hs_conf.case_sensitive

            def rewrite(node: LogicalPlan) -> LogicalPlan:
                if not (isinstance(node, FilterNode) and isinstance(node.child, ScanNode)):
                    return node
                scan = node.child
                if scan.relation.index_name is not None:
                    return node  # a covering-index scan has no per-file sketches
                # Sketches are per source file: under Hybrid Scan an appended
                # file is unknown to them and always kept, and a vanished one
                # leaves the scan itself, so deletes need no lineage.
                candidates = get_candidate_indexes(
                    index_manager, scan, hybrid_scan=session.hs_conf.hybrid_scan_enabled,
                    kind=DATA_SKIPPING_KIND, deletes_without_lineage_ok=True, rule_name="DataSkippingFilterRule",
                )
                if not candidates:
                    return node
                conjuncts = [c for c in map(normalize_conjunct, split_conjuncts(node.condition)) if c is not None]
                if not conjuncts:
                    return node
                kept = self._kept_files(scan.relation, candidates, conjuncts, cs)
                if kept is None:
                    record_rule_decision("DataSkippingFilterRule", False, reason="no-files-pruned",
                                         candidates=[c.entry.name for c in candidates])
                    return node
                files, used = kept
                rel = scan.relation
                pruned = SourceRelation(
                    root_paths=list(rel.root_paths), file_format=rel.file_format, schema=rel.schema,
                    files=files, options=dict(rel.options), pruned_by=used, partition_spec=rel.partition_spec,
                )
                new_node = FilterNode(node.condition, ScanNode(pruned))
                n_pruned = len(rel.files) - len(files)
                record_rule_decision("DataSkippingFilterRule", True, indexes=used, files_pruned=n_pruned,
                                     files_total=len(rel.files))
                log_event(session, HyperspaceIndexUsageEvent(
                    index_names=used, plan_before=node.tree_string(), plan_after=new_node.tree_string(),
                    message=f"Data skipping index applied ({n_pruned} of {len(rel.files)} files pruned).",
                ))
                return new_node

            return plan.transform_up(rewrite)
        except Exception as e:  # never break the user's query over an index problem
            log_rule_failure(session, "DataSkippingFilterRule", e)
            return plan

    def _kept_files(self, rel: SourceRelation, candidates, conjuncts, cs: bool) -> Optional[tuple]:
        """(kept files, sorted names of the indexes that pruned) or None
        when no file is pruned. Candidates prune in order; an index counts
        as used when it drops a file the ones before it kept."""
        files = rel.files
        keep = np.ones(len(files), bool)
        used: List[str] = []
        for cand in candidates:
            data = self._sketches(cand.entry)
            idx = np.asarray([data.row_of.get(f.path, -1) for f in files], dtype=np.int64)
            applied = False
            for s in sketches_of(cand.entry):
                for op, col_name, value in conjuncts:
                    if resolution_key(col_name, cs) != resolution_key(s.column, cs):
                        continue
                    live = np.flatnonzero(keep & (idx >= 0))  # files unknown to the sketch keep
                    if live.size == 0:
                        continue
                    if isinstance(s, MinMaxSketch) and op in _MINMAX_OPS:
                        ok = data.minmax_keep(s, op, value, idx[live])
                    elif isinstance(s, BloomFilterSketch) and op in _BLOOM_OPS:
                        values = value if op == "in" else [value]
                        ok = data.bloom_keep(s, values, rel.schema.field(col_name).dtype, idx[live])
                    else:
                        continue
                    if not ok.all():
                        keep[live[~ok]] = False
                        applied = True
            if applied:
                used.append(cand.entry.name)
        if keep.all():
            return None
        return [f for f, k in zip(files, keep) if k], sorted(set(used))
