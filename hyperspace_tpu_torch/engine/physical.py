"""Physical plan + executor (counterpart of `hyperspace_tpu/engine/physical.py`).

The operators of the slice: file scans, bucketed index scans (with Hybrid
Scan's appended rows merged into their buckets), filters, projections, row
unions, the DISTINCT set operations, computed columns, grouped aggregates,
ORDER BY, LIMIT, the sort-merge join of every type and the multiway star
join. A grouped aggregate over a multi-file scan or a star join streams
(`engine/streaming.py`): the scan, filter, projection and computed column
also run chunk by chunk (`execute_stream`). A filter evaluates
its predicate on the device (`engine/evaluate.py`) and keeps the surviving
rows in order; a filter directly over a plain scan hands its condition to
the scan, which skips the parquet row groups that cannot match
(`engine/pushdown.py`).

The join has two paths. When `JoinIndexRule` has put both sides on
compatible covering indexes, they arrive hash-partitioned into the same
buckets on the join keys, so the merge runs per bucket pair with no exchange
(reference `JoinIndexRule.scala:137-162`): `ops.bucket_join` probes all bucket
pairs at once. Any other equi-join takes the general path: both sides' key64
hashes are sorted and merged whole (`ops.join.merge_join_pairs`). Either way
candidate pairs are verified by exact key equality (a 64-bit hash collision
can never join unequal rows, and a null key matches nothing), and the payload
columns are gathered, all as torch ops on the tables' device. The verified
inner pairs are the one product of both paths: outer joins add the unmatched
rows of a side beside all-null columns of the other, semi and anti joins keep
left rows (`_assemble_join`), and every type's `count()` comes from the pair
count and the matched rows of each side (`_count_from_match_stats`).

Scans return their tables through the scan caches (`engine/scan_cache.py`),
so a repeated query gets the same device tables, and the join's key64, layout,
probe ranges and verified pairs are kept in the join memos below. Concurrent
queries share a cold bucketed or filtered concatenation and a cold memo
entry under single-flight (`serve.singleflight`): one computes, the others
wait and read its entry.

Over a device mesh (`session.mesh_for`, `parallel/`), the general join
exchanges both sides for real (`ShuffleExchangeExec.exchange_table`) and
probes the co-partitioned key blocks where they landed, and the co-bucketed
join probes each shard's bucket range with K1 and K2 (`_mesh_pairs`); the
fused join aggregate and both joins' count fast paths then decline, as in
the JAX package, so the rows come in the mesh probe's order.

Every read of an index relation runs under `_corruption_guard`: a decode
failure of an index data file becomes a `CorruptIndexError` naming the
index, on which `DataFrame.collect`/`count` quarantine it and re-plan over
the source.

While a trace records, every operator's `execute`, `execute_count` and
`execute_concat` opens an `op:<name>` span carrying `node_id` (what
`explain(analyze=True)` joins the tree on) and `rows_out`; scans add their
cache verdict (`bucketed_cache`) and row-group pruning, the co-bucketed join
its pair-memo verdict (`pairs_memo`). Off, the wrapper is one predicate.
The memos count into the metrics registry (`memo.<tag>.hits|misses`).
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEVICE_CACHE_BUDGET_DEFAULT, ENV_DEVICE_CACHE_BUDGET, env_bytes
from .. import resilience as _resilience
from ..exceptions import CorruptIndexError, HyperspaceException, not_in_slice
from ..ops.aggregate import hash_aggregate
from ..ops.hashing import key64
from ..ops.join import merge_join_pairs
from ..ops.partition import bucketize_table, sortable_lane
from ..serve import singleflight as _singleflight
from ..telemetry import metrics as _metrics
from ..telemetry import tracing as _tracing
from . import io as engine_io
from .evaluate import evaluate_column, evaluate_predicate
from .expr import Expr, canonical_condition_repr, extract_equi_join_keys
from .logical import (
    AggregateNode,
    ExceptNode,
    FilterNode,
    IntersectNode,
    JoinNode,
    LimitNode,
    LogicalPlan,
    OrderByNode,
    ProjectNode,
    ScanNode,
    SourceRelation,
    StarJoinNode,
    UnionNode,
    WithColumnNode,
    internal_column,
)
from .pushdown import ScanPredicate, pushdown_enabled
from .scan_cache import global_bucketed_cache, global_filtered_cache
from .schema import TORCH_DTYPES, Schema
from .table import Column, Table, align_dictionaries

_BUCKET_FILE_RE = re.compile(r"part-(\d+)")


class ExecContext:
    def __init__(self, session):
        self.session = session
        self._file_stats: Dict[tuple, Optional[tuple]] = {}

    def file_stats(self, paths: List[str]) -> Optional[tuple]:
        """Each file's (path, size, mtime), stat'ed once per execution."""
        key = tuple(paths)
        if key not in self._file_stats:
            self._file_stats[key] = engine_io.file_stats(paths)
        return self._file_stats[key]

    @property
    def device(self) -> torch.device:
        return self.session.device


def _traced_node_method(kind: str, fn):
    """`fn` (an executor entry point) in an `op:<name>` span while tracing
    records; one predicate otherwise."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, ctx):
        if not _tracing.active():
            return fn(self, ctx)
        with _tracing.span(f"op:{self.name}", node_id=id(self), op=self.simple_string(), kind=kind) as sp:
            out = fn(self, ctx)
            rows = getattr(out, "num_rows", None)
            if rows is None and isinstance(out, tuple) and out:
                rows = getattr(out[0], "num_rows", None)  # execute_concat
            if rows is None and isinstance(out, int):
                rows = out  # execute_count
            if rows is not None:
                sp.set_attr("rows_out", int(rows))
            return out

    wrapper._hyperspace_traced = True
    return wrapper


class PhysicalNode:
    name = "Physical"

    def __init_subclass__(cls, **kwargs):
        # Every operator's entry points are span-wrapped at class creation.
        super().__init_subclass__(**kwargs)
        for m in ("execute", "execute_count", "execute_concat"):
            fn = cls.__dict__.get(m)
            if callable(fn) and not getattr(fn, "_hyperspace_traced", False):
                setattr(cls, m, _traced_node_method(m, fn))

    def children(self) -> Sequence["PhysicalNode"]:
        return ()

    def execute(self, ctx: ExecContext) -> Table:
        raise NotImplementedError

    def execute_count(self, ctx: ExecContext) -> int:
        return self.execute(ctx).num_rows

    def simple_string(self) -> str:
        return self.name

    def format_line(self, indent: int) -> str:
        """This node's line of the tree, the one place of its format (the
        explain renderer highlights lines of it)."""
        return "  " * indent + ("+- " if indent else "") + self.simple_string()

    def tree_string(self, indent: int = 0) -> str:
        lines = [self.format_line(indent)]
        for c in self.children():
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def collect_nodes(self) -> List["PhysicalNode"]:
        out: List[PhysicalNode] = [self]
        for c in self.children():
            out.extend(c.collect_nodes())
        return out


def _resolution_case_sensitive(ctx, schema_names) -> bool:
    """Case sensitivity of conjunct resolution and cache-key spelling: the
    session's conf, forced on when the schema holds two spellings of one
    name (then `X` and `x` read different columns)."""
    cs = ctx.session.hs_conf.case_sensitive if ctx is not None and ctx.session is not None else False
    return cs or len({n.lower() for n in schema_names}) != len(schema_names)


def partitions_of(relation) -> Optional[tuple]:
    """The (PartitionSpec, root paths) a read of a Hive-partitioned source
    takes, None for any other source."""
    spec = relation.partition_spec
    return None if spec is None else (spec, relation.root_paths)


def _set_pruning_attrs(stats: Dict[str, int]) -> None:
    """One scan's row-group pruning on the ambient span (nothing pruned:
    nothing set)."""
    if stats:
        _tracing.set_attr("row_groups_scanned", int(stats.get("row_groups_scanned", 0)))
        _tracing.set_attr("row_groups_skipped", int(stats.get("row_groups_skipped", 0)))


@contextlib.contextmanager
def _corruption_guard(relation: SourceRelation):
    """Re-raise a decode failure of an index relation's data as a
    `CorruptIndexError` naming the index (`physical._corruption_guard` :200).
    Only decode-layer types count: the pyarrow family, `ValueError`,
    `OSError` and `EOFError`. A classified `HyperspaceException` (an
    exhausted transient fault, a timeout, a spent retry budget) passes
    unchanged, and an engine bug (a bare `TypeError`, ...) stays raw."""
    try:
        yield
    except HyperspaceException:
        raise
    except Exception as e:
        import pyarrow as pa

        if relation.index_name and isinstance(e, (ValueError, OSError, EOFError, pa.lib.ArrowException)):
            raise CorruptIndexError(
                f"index '{relation.index_name}' data failed to decode ({type(e).__name__}: {e})",
                index_name=relation.index_name,
            ) from e
        raise


def _default_scan_columns(relation: SourceRelation, columns: Optional[List[str]]) -> Optional[List[str]]:
    """The columns a scan reads when `columns` is None ("everything"): for an
    index relation its visible schema, since the lineage column is read only
    when a filter names it (physical.py:233). None when nothing is hidden."""
    if columns is not None or not relation.index_name:
        return columns
    names = relation.schema.names
    visible = [n for n in names if not internal_column(n)]
    return visible if len(visible) != len(names) else None


class ScanExec(PhysicalNode):
    name = "Scan"

    def __init__(self, relation: SourceRelation, columns: Optional[List[str]] = None):
        self.relation = relation
        self.columns = columns
        #: The condition of the FilterExec directly above, set by the planner.
        #: Advisory: the scan may leave out row groups whose zone maps show
        #: that no row passes it (the filter drops those rows anyway).
        self.pushdown: Optional[Expr] = None
        #: Row groups scanned and skipped by the last execute (pushdown only).
        self.pruning: Dict[str, int] = {}

    def _pushdown_pred(self, ctx):
        """The compiled `ScanPredicate`, or None when pushdown cannot apply
        (disabled, a bucketed relation, or no prunable conjunct)."""
        rel = self.relation
        if self.pushdown is None or rel.bucket_spec is not None or rel.file_format not in engine_io.PARQUET_SHAPED:
            return None
        if not pushdown_enabled():
            return None
        return ScanPredicate.from_condition(self.pushdown, _resolution_case_sensitive(ctx, self.relation.schema.names))

    def _hybrid_bucketed(self) -> Optional["BucketedIndexScanExec"]:
        """The bucketed scan this scan reads through when it is a demoted
        index scan (the general join reads a bucketed relation as a plain
        scan) whose relation carries appended files: they are still merged
        (physical.py:283-287). None otherwise."""
        rel = self.relation
        if rel.hybrid_append is None or rel.bucket_spec is None:
            return None
        return BucketedIndexScanExec(rel, self.columns)

    def execute(self, ctx) -> Table:
        bucketed = self._hybrid_bucketed()
        if bucketed is not None:
            return bucketed.execute(ctx)
        files = [f.path for f in self.relation.files]
        if not files:
            return _empty_table(self.relation, self.columns, ctx.device)
        self.pruning = {}
        with _corruption_guard(self.relation):
            out = engine_io.read_files(
                files, self.relation.file_format, _default_scan_columns(self.relation, self.columns), ctx.device,
                pushdown=self._pushdown_pred(ctx), pruning_stats=self.pruning, partitions=partitions_of(self.relation),
            )
        _set_pruning_attrs(self.pruning)
        return out

    def can_stream(self) -> bool:
        """A plain file read feeds the streamed aggregate; a demoted index
        scan with appended rows merges buckets, whole-scan work
        (physical.py:319)."""
        return self.relation.hybrid_append is None and bool(self.relation.files)

    def execute_stream(self, ctx, stages=None):
        """The scan as ordered chunks (physical.py:325): each file's table
        (decoded ahead of the consumer, through the per-file scan cache,
        pruned by the pushdown) in row slices of `query_chunk_rows()`.
        Concatenating the chunks gives `execute`'s table."""
        from .streaming import query_chunk_rows, split_chunks

        on_decode = None if stages is None else (lambda s: stages.add("decode", s))
        chunk_rows = query_chunk_rows()
        self.pruning = {}
        with _corruption_guard(self.relation):
            for t in engine_io.iter_file_tables(
                [f.path for f in self.relation.files], self.relation.file_format,
                _default_scan_columns(self.relation, self.columns), ctx.device, partitions_of(self.relation),
                on_decode=on_decode, pushdown=self._pushdown_pred(ctx), pruning_stats=self.pruning,
            ):
                yield from split_chunks(t, chunk_rows)
        _set_pruning_attrs(self.pruning)

    def execute_count(self, ctx) -> int:
        """Footer row counts; a format without them is read (physical.py:310)."""
        bucketed = self._hybrid_bucketed()
        if bucketed is not None:
            return bucketed.execute_count(ctx)
        n = engine_io.footer_row_count(self.relation.files, self.relation.file_format)
        return n if n is not None else self.execute(ctx).num_rows

    def simple_string(self):
        cols = f" [{', '.join(self.columns)}]" if self.columns else ""
        tag = f" index={self.relation.index_name}" if self.relation.index_name else ""
        if self.relation.pruned_by:
            tag += f" (files pruned by {','.join(self.relation.pruned_by)})"
        return f"Scan{tag} {','.join(self.relation.root_paths)}{cols}"


class BucketedIndexScanExec(PhysicalNode):
    """Reads index data preserving bucket structure: bucket ids come from the
    `part-<bucket>` file naming contract of the bucketed writer. An index
    refreshed incrementally spreads a bucket over several version
    directories: its files are concatenated in `relation.files` order, as the
    JAX package's `_assemble_buckets` does (physical.py:378). Under Hybrid
    Scan the relation carries the source files appended since the build
    (`hybrid_append`): their rows are bucketized by the index's own hash and
    each bucket's go after its index rows (`_merge_appended`)."""

    name = "BucketedIndexScan"

    def __init__(self, relation: SourceRelation, columns: Optional[List[str]] = None):
        assert relation.bucket_spec is not None
        self.relation = relation
        self.columns = columns

    def _bucket_files(self) -> List[Tuple[int, str]]:
        """(bucket, path) of each file, by bucket and, within a bucket, in
        `relation.files` order (a stable sort)."""
        out = []
        for f in self.relation.files:
            m = _BUCKET_FILE_RE.search(os.path.basename(f.path))
            if m is None:
                raise HyperspaceException(f"Not a bucketed index file: {f.path}")
            out.append((int(m.group(1)), f.path))
        out.sort(key=lambda bp: bp[0])
        return out

    def _assemble(self, ctx, selections=None) -> Tuple[Table, np.ndarray]:
        """One contiguous table in bucket order and the bucket start offsets
        (bucket b = rows[starts[b]:starts[b+1]]). Cold files decode
        concurrently through the scan cache; `selections` (path → (meta, sel))
        reads only the kept row groups of each file."""
        bucket_files = self._bucket_files()
        sel_of = selections or {}
        cols = _default_scan_columns(self.relation, self.columns)
        jobs = [(p, cols) + sel_of.get(p, (None, None)) for _, p in bucket_files]
        with _corruption_guard(self.relation):
            tables = engine_io.decode_files(jobs, ctx.device, ctx.file_stats([p for _, p in bucket_files]))
        starts = np.zeros(self.relation.bucket_spec.num_buckets + 1, dtype=np.int64)
        for (b, _), t in zip(bucket_files, tables):
            starts[b + 1] += t.num_rows
        np.cumsum(starts, out=starts)
        kept = [t for t in tables if t.num_rows > 0]
        table = engine_io.concat_tables(kept) if kept else self.empty_table(ctx)
        if self.relation.hybrid_append is not None:
            return self._merge_appended(ctx, table, starts)
        return table, starts

    def _appended_rows(self, ctx) -> Table:
        """The appended source files' rows in this scan's columns, file by
        file in `hybrid_append.files` order, in the source's format and
        partition layout; a requested lineage column holds each row's file
        path (physical.py:438-464)."""
        ha = self.relation.hybrid_append
        wanted = _default_scan_columns(self.relation, self.columns) or self.relation.schema.names
        source_cols = [c for c in wanted if not internal_column(c)]
        lineage = [c for c in wanted if internal_column(c)]
        paths = [f.path for f in ha.files]
        t, counts = engine_io.read_in_order(
            paths, ha.file_format, source_cols, ctx.device, partitions_of(ha), bases=ctx.file_stats(paths),
        )
        if lineage:
            t = Table({**t.columns, lineage[0]: lineage_column(paths, counts, ctx.device)})
        return t.select(wanted)

    def _merge_appended(self, ctx, table: Table, starts: np.ndarray) -> Tuple[Table, np.ndarray]:
        """Hybrid Scan's merge (`_merge_appended`, physical.py:421): the
        appended rows bucketized with the index's bucket columns and count,
        then one concatenation (the string columns' dictionaries unite) and
        one gather that puts each bucket's appended rows after its index rows,
        in `bucketize_table` order. The bucket is then no longer sorted by
        key, so the join pads it by hash (K1)."""
        spec = self.relation.bucket_spec
        _resilience.check_deadline("hybrid.merge_appended")
        appended = self._appended_rows(ctx)
        if appended.num_rows == 0:
            return table, starts
        sorted_a, a_starts = bucketize_table(appended, list(spec.bucket_columns), spec.num_buckets)
        merged = engine_io.concat_tables([table, sorted_a])
        perm = interleave_perm(starts, a_starts, merged.num_rows, ctx.device)
        return merged.take(perm), starts + a_starts

    def execute_pruned_concat(self, ctx, condition: Expr) -> Optional[Tuple[Table, np.ndarray]]:
        """The scan under `condition` with each `part-<bucket>` file decoded
        only in the row groups whose zone maps can satisfy it (the build
        writes bounded, key-sorted row groups for this): a row subset of
        `execute_concat`'s table in the same order, so the condition applied
        afterwards gives identical rows and bucket bounds. None when pushdown
        cannot apply (Hybrid Scan's appended rows included) or prunes nothing
        (the caller takes the plain path)."""
        if not pushdown_enabled() or self.relation.hybrid_append is not None:
            return None
        pred = ScanPredicate.from_condition(condition, _resolution_case_sensitive(ctx, self.relation.schema.names))
        if pred is None:
            return None
        paths = [f.path for f in self.relation.files]
        selections = engine_io.pushdown_selections(paths, pred)
        if selections is None:
            return None
        stats: Dict[str, int] = {}
        engine_io.record_pruning(selections, stats)
        out = self._assemble(ctx, dict(zip(paths, selections)))
        # The pruned path never consults the bucketed-concat cache.
        _tracing.set_attr("bucketed_cache", "pruned-bypass")
        _set_pruning_attrs(stats)
        return out

    def empty_table(self, ctx) -> Table:
        return _empty_table(self.relation, self.columns, ctx.device)

    def rows_token(self, ctx) -> Optional[tuple]:
        """Identity of this scan's rows and their order, whatever its columns:
        the index log entry id and every file's (path, size, mtime) as it is
        on disk now, and so the appended files' under Hybrid Scan
        (physical.py:550-571). Join pairs computed against one projection of
        the scan serve every other; a rewritten or appended file changes the
        token. None when a file cannot be stat'ed."""
        stats = ctx.file_stats([p for _, p in self._bucket_files()])
        if stats is None:
            return None
        token = (("log", self.relation.index_name, self.relation.log_entry_id), stats)
        ha = self.relation.hybrid_append
        if ha is None:
            return token
        appended = ctx.file_stats([f.path for f in ha.files])
        return None if appended is None else token + (("appended",) + appended,)

    def _concat_cache_key(self, ctx) -> Optional[tuple]:
        token = self.rows_token(ctx)
        if token is None:
            return None
        return token + (("<all>",) if self.columns is None else tuple(self.columns), str(ctx.device))

    def execute_concat(self, ctx) -> Tuple[Table, np.ndarray]:
        """The scan as one contiguous table + bucket start offsets, cached
        across queries (`BucketedConcatCache`)."""
        key = self._concat_cache_key(ctx)
        if key is not None:
            hit = global_bucketed_cache().get(key)
            if hit is not None:
                _tracing.set_attr("bucketed_cache", "hit")
                return hit
            _tracing.set_attr("bucketed_cache", "miss")
        else:
            _tracing.set_attr("bucketed_cache", "uncacheable")

        def assemble() -> Tuple[Table, np.ndarray]:
            table, starts = self._assemble(ctx)
            if key is not None:
                global_bucketed_cache().put(key, table, starts)
            return table, starts

        if key is None:
            return assemble()

        def reprobe():
            hit = global_bucketed_cache().get(key)
            if hit is not None:  # another query's flight assembled it
                _tracing.set_attr("bucketed_cache", "dedup_hit")
            return hit

        # Two concurrent cold indexed queries assemble the bucket files once.
        return _singleflight.shared(("bucketed", key), assemble, reprobe)

    def execute(self, ctx) -> Table:
        return self.execute_concat(ctx)[0]

    def execute_count(self, ctx) -> int:
        """Footer row counts, the appended files' included (physical.py:627)."""
        ha = self.relation.hybrid_append
        appended = 0 if ha is None else engine_io.footer_row_count(ha.files, ha.file_format)
        n = engine_io.footer_row_count(self.relation.files)
        if appended is None or n is None:
            return self.execute(ctx).num_rows
        return n + appended

    def simple_string(self):
        spec = self.relation.bucket_spec
        ha = self.relation.hybrid_append
        return (
            f"BucketedIndexScan index={self.relation.index_name} "
            f"buckets={spec.num_buckets} by {list(spec.bucket_columns)}"
            + ("" if ha is None else f" (+{len(ha.files)} appended)")
        )


def lineage_column(paths: List[str], counts: List[int], device) -> Column:
    """The `_data_file_name` column of consecutive runs of rows, run i
    holding `counts[i]` rows of file `paths[i]`: what concatenating each
    file's one-value column gives, a dictionary over the union of the paths,
    built by one `repeat_interleave`."""
    names = np.asarray(paths)
    dictionary = np.unique(names)
    codes = torch.as_tensor(np.searchsorted(dictionary, names).astype(np.int32), device=device)
    reps = torch.as_tensor(np.asarray(counts, dtype=np.int64), device=device)
    return Column("string", torch.repeat_interleave(codes, reps, output_size=int(sum(counts))), dictionary)


def interleave_perm(starts: np.ndarray, a_starts: np.ndarray, n: int, device) -> torch.Tensor:
    """The gather that turns [index rows in bucket order | appended rows in
    bucket order] into bucket-major order with each bucket's index rows
    first: output row p of bucket b, at offset o from the bucket's new start,
    takes index row starts[b] + o while o is below the bucket's index rows,
    else appended row a_starts[b] + o - (its index rows)."""
    idx_counts = np.diff(starts)
    new_starts = torch.as_tensor(starts + a_starts, device=device)
    counts = torch.as_tensor(idx_counts + np.diff(a_starts), device=device)
    b = torch.repeat_interleave(torch.arange(len(idx_counts), device=device), counts, output_size=n)
    off = torch.arange(n, device=device) - new_starts[b]
    idx_t = torch.as_tensor(starts, device=device)
    own = torch.as_tensor(idx_counts, device=device)[b]
    a_t = torch.as_tensor(a_starts, device=device)
    return torch.where(off < own, idx_t[b] + off, int(starts[-1]) + a_t[b] + off - own)


def _empty_column(dtype: str, device) -> Column:
    if dtype == "string":
        return Column(dtype, torch.empty(0, dtype=torch.int32, device=device), np.empty(0, dtype="<U1"))
    return Column.from_values(np.empty(0, np.dtype(dtype)), device)


def _empty_table(relation: SourceRelation, columns, device) -> Table:
    names = _default_scan_columns(relation, columns) or relation.schema.names
    return Table({n: _empty_column(relation.schema.field(n).dtype, device) for n in names})


class FilterExec(PhysicalNode):
    """Keeps the rows whose predicate is true and known, in order
    (physical.py:653)."""

    name = "Filter"

    def __init__(self, condition: Expr, child: PhysicalNode):
        self.condition = condition
        self.child = child

    def children(self):
        return (self.child,)

    @property
    def relation(self) -> SourceRelation:
        return self.child.relation

    def _keep(self, t: Table) -> torch.Tensor:
        return torch.nonzero(evaluate_predicate(self.condition, t)).squeeze(1)

    def execute(self, ctx) -> Table:
        t = self.child.execute(ctx)
        if t.num_rows:
            with _tracing.step("filter.predicate"):
                mask = evaluate_predicate(self.condition, t)
            with _tracing.step("filter.compact"):
                t = t.take(torch.nonzero(mask).squeeze(1))
        return self._strip_internal(t)

    def execute_stream(self, ctx, stages=None):
        """The filter chunk by chunk (physical.py:692); an empty chunk still
        flows, carrying the schema of an empty result."""
        from ..telemetry.profiling import timed

        for t in self.child.execute_stream(ctx, stages):
            if t.num_rows == 0:
                yield self._strip_internal(t)
                continue
            with timed(stages, "eval"):
                out = self._strip_internal(t.take(self._keep(t)))
            yield out

    def _strip_internal(self, t: Table) -> Table:
        """Drop an index scan's lineage column once this filter, the delete
        prune and the column's only reader, has evaluated: the logical schema
        hides it from everything above (physical.py:670)."""
        rel = getattr(self.child, "relation", None)
        if rel is None or not rel.index_name:
            return t
        refs = {r.lower() for r in self.condition.references()}
        drop = [c for c in t.column_names if internal_column(c) and c.lower() in refs]
        return t.select([c for c in t.column_names if c not in drop]) if drop else t

    def execute_concat(self, ctx) -> Tuple[Table, np.ndarray]:
        """A filtered bucketed scan with its bucket structure kept: a filter
        moves no row across buckets and keeps the order within one, so the
        co-bucketed join stays sound over it. Cached beside the bucketed
        concats, keyed by the scan's key and the condition. A cold run reads
        only the row groups the condition can match, unless the whole scan is
        already cached (filtering it in memory beats decoding again)."""
        child = self.child
        with _tracing.step("filter.key"):
            base_key = child._concat_cache_key(ctx)
            key = None if base_key is None else ("filtered", base_key, self._condition_key(ctx))
        if key is not None:
            with _tracing.step("filter.cache_get"):
                hit = global_filtered_cache().get(key)
            if hit is not None:
                return hit

        def assemble() -> Tuple[Table, np.ndarray]:
            pruned = None
            if base_key is None or not global_bucketed_cache().contains(base_key):
                pruned = child.execute_pruned_concat(ctx, self.condition)
            table, starts = pruned if pruned is not None else child.execute_concat(ctx)
            if table.num_rows:
                with _tracing.step("filter.predicate"):
                    mask = evaluate_predicate(self.condition, table)
                with _tracing.step("filter.compact"):
                    keep = torch.nonzero(mask).squeeze(1)
                    bounds = torch.as_tensor(np.asarray(starts, np.int64), device=keep.device)
                    starts = torch.searchsorted(keep, bounds).cpu().numpy().astype(np.int64)
                    table = table.take(keep)
            table = self._strip_internal(table)
            if key is not None:
                with _tracing.step("filter.cache_put"):
                    global_filtered_cache().put(key, table, starts)
            return table, starts

        if key is None:
            return assemble()
        return _singleflight.shared(("filtered_concat", key), assemble, lambda: global_filtered_cache().get(key))

    def _condition_key(self, ctx) -> str:
        cs = _resolution_case_sensitive(ctx, self.child.relation.schema.names)
        return canonical_condition_repr(self.condition, cs)

    def rows_token(self, ctx) -> Optional[tuple]:
        """The filtered scan's row identity: the scan's and the condition;
        None over a scan that states none (physical.py:787)."""
        child_token = getattr(self.child, "rows_token", None)
        token = None if child_token is None else child_token(ctx)
        return None if token is None else ("filtered-rows", token, self._condition_key(ctx))

    def simple_string(self):
        return f"Filter {self.condition!r}"


def _bucketed(node: PhysicalNode) -> bool:
    """A bucketed index scan, or a filter over one."""
    if isinstance(node, FilterExec):
        node = node.child
    return isinstance(node, BucketedIndexScanExec)


class ProjectExec(PhysicalNode):
    name = "Project"

    def __init__(self, column_names: Sequence[str], child: PhysicalNode):
        self.column_names = list(column_names)
        self.child = child

    def children(self):
        return (self.child,)

    def execute(self, ctx) -> Table:
        return self.child.execute(ctx).select(self.column_names)

    def execute_count(self, ctx) -> int:
        return self.child.execute_count(ctx)

    def execute_stream(self, ctx, stages=None):
        for t in self.child.execute_stream(ctx, stages):
            yield t.select(self.column_names)

    def simple_string(self):
        return f"Project [{', '.join(self.column_names)}]"


class UnionExec(PhysicalNode):
    """Row union (physical.py:827): each child's table with the first
    child's column order, concatenated; the count sums the children's."""

    name = "Union"

    def __init__(self, children: Sequence[PhysicalNode]):
        self._children = list(children)

    def children(self):
        return tuple(self._children)

    def execute(self, ctx) -> Table:
        tables = [c.execute(ctx) for c in self._children]
        names = tables[0].column_names
        return Table.concat([t if t.column_names == names else t.select(names) for t in tables])

    def execute_count(self, ctx) -> int:
        return sum(c.execute_count(ctx) for c in self._children)

    def simple_string(self):
        return f"Union ({len(self._children)})"


def _column_codes(c: Column) -> Tuple[torch.Tensor, int]:
    """Int64 codes of a column's values under the set operations' row
    equality, and a bound above them: a null equals a null, -0.0 equals 0.0,
    and a NaN equals nothing, not even another NaN (the JAX package's
    `np.unique` over `_key_records`, `ops/aggregate.py:375`). Values get
    codes 0..m-1 by `torch.unique`, every null m, and each NaN row a code of
    its own above that."""
    data = c.data
    nan = None
    if data.is_floating_point():
        d = data.to(torch.float64)
        nan = torch.isnan(d)
        d = torch.where(d == 0.0, torch.zeros((), dtype=d.dtype, device=d.device), d)  # -0.0 as 0.0
        lane = d.view(torch.int64)
    else:
        lane = data.to(torch.int64)
    uniq, codes = torch.unique(lane, return_inverse=True)
    m = uniq.numel()
    if c.validity is not None:
        codes = torch.where(c.validity, codes, torch.full((), m, dtype=codes.dtype, device=codes.device))
    if nan is not None:
        if c.validity is not None:
            nan &= c.validity
        rows = torch.arange(len(codes), dtype=codes.dtype, device=codes.device)
        return torch.where(nan, m + 1 + rows, codes), m + 1 + len(codes)
    return codes, m + 1


def _row_ids(table: Table) -> Tuple[torch.Tensor, int]:
    """Dense ids of a table's whole rows and their count: equal rows share an
    id, unequal rows never do. The columns fold in one at a time, each step a
    `torch.unique` over (ids so far, the column's codes), so the ids stay
    dense: no hash, no collision and no overflow. Rows on the table's device."""
    ids, n_ids = None, 1
    for c in table.columns.values():
        codes, bound = _column_codes(c)
        key = codes if ids is None else ids * bound + codes
        uniq, ids = torch.unique(key, return_inverse=True)
        n_ids = uniq.numel()
    return ids, n_ids


class SetOpExec(PhysicalNode):
    """INTERSECT and EXCEPT with DISTINCT semantics over whole rows
    (`physical.SetOpExec` :850), on the tables' device. The two sides go
    through one `Table.concat`, so string codes share a dictionary; each row
    gets a dense id (`_row_ids`); the first left row of each id is found by a
    `scatter_reduce` "amin", and the ids present on the right are marked by
    `index_fill_`. The survivors are the left side's first occurrences, in
    left order."""

    def __init__(self, op: str, left: PhysicalNode, right: PhysicalNode):
        self.op = op  # "intersect" | "except"
        self.left = left
        self.right = right

    @property
    def name(self):
        return self.op.capitalize()

    def children(self):
        return (self.left, self.right)

    def execute(self, ctx) -> Table:
        lt = self.left.execute(ctx)
        rt = self.right.execute(ctx)
        nl = lt.num_rows
        if nl == 0:
            return lt
        combined = lt if rt.num_rows == 0 else Table.concat([lt, rt.select(lt.column_names)])
        ids, n_ids = _row_ids(combined)
        device = ids.device
        first = torch.full((n_ids,), nl, dtype=torch.int64, device=device).scatter_reduce_(
            0, ids[:nl], torch.arange(nl, device=device), "amin"
        )
        on_right = torch.zeros(n_ids, dtype=torch.bool, device=device).index_fill_(0, ids[nl:], True)
        keep = (first < nl) & (on_right if self.op == "intersect" else ~on_right)
        return lt.take(torch.sort(first[keep]).values)


def _null_table_like(table: Table, n: int, device) -> Table:
    """n rows of all-null columns with `table`'s schema, the fill side of an
    outer join (physical.py:1573). A string column keeps its dictionary, or
    takes [""] when it has none, so the concatenated dictionaries are the JAX
    package's."""
    invalid = torch.zeros(n, dtype=torch.bool, device=device)
    out: Dict[str, Column] = {}
    for name, c in table.columns.items():
        if c.is_string:
            d = c.dictionary if len(c.dictionary) else np.array([""], dtype="<U1")
            out[name] = Column(c.dtype, torch.zeros(n, dtype=torch.int32, device=device), d, invalid)
        else:
            out[name] = Column(c.dtype, torch.zeros(n, dtype=c.data.dtype, device=device), None, invalid)
    return Table(out)


def _matched_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The n rows of a side that a verified pair names."""
    mask = torch.zeros(n, dtype=torch.bool, device=idx.device)
    mask[idx] = True
    return mask


def _assemble_join(left: Table, right: Table, li: torch.Tensor, ri: torch.Tensor, how: str) -> Table:
    """The join's output from VERIFIED inner pairs (physical.py:1586): semi
    keeps the left rows some pair names, anti the others, both ascending; the
    outer types give the pairs, then the unmatched left rows (left, full),
    then the unmatched right rows (right, full), beside all-null columns of
    the other side. Null-key and hash-collision pairs were dropped by
    verification, so their rows are unmatched: SQL's outer semantics for null
    keys. Left columns come first; a right name already on the left gets the
    `_r` suffix."""
    if how == "left_semi":
        return left.take(torch.unique(li))
    if how == "left_anti":
        return left.take(torch.nonzero(~_matched_mask(li, left.num_rows)).squeeze(1))
    lt_parts, rt_parts = [left.take(li)], [right.take(ri)]
    if how in ("left", "full"):
        idx = torch.nonzero(~_matched_mask(li, left.num_rows)).squeeze(1)
        if len(idx):
            lt_parts.append(left.take(idx))
            rt_parts.append(_null_table_like(right, len(idx), idx.device))
    if how in ("right", "full"):
        idx = torch.nonzero(~_matched_mask(ri, right.num_rows)).squeeze(1)
        if len(idx):
            lt_parts.append(_null_table_like(left, len(idx), idx.device))
            rt_parts.append(right.take(idx))
    lt = Table.concat(lt_parts) if len(lt_parts) > 1 else lt_parts[0]
    rt = Table.concat(rt_parts) if len(rt_parts) > 1 else rt_parts[0]
    out: Dict[str, Column] = dict(lt.columns)
    for n, c in rt.columns.items():
        out[n if n not in out else f"{n}_r"] = c
    return Table(out)


def _count_from_match_stats(how: str, n_pairs: int, lm: int, rm: int, n_left: int, n_right: int) -> int:
    """The join's row count from (verified pairs, matched left rows, matched
    right rows): the one home of each type's arithmetic (physical.py:2413),
    all-zero stats for an empty side."""
    if how == "inner":
        return n_pairs
    if how == "left_semi":
        return lm
    if how == "left_anti":
        return n_left - lm
    n = n_pairs
    if how in ("left", "full"):
        n += n_left - lm
    if how in ("right", "full"):
        n += n_right - rm
    return n


def _verified_keep(
    left: Table, right: Table, left_keys: List[str], right_keys: List[str],
    li: torch.Tensor, ri: torch.Tensor,
) -> torch.Tensor:
    """The candidate pairs whose keys are equal and valid: exact key equality
    drops 64-bit hash collisions, and validity drops pairs with a null key
    (null equals nothing, itself included, and null slots share a fill value,
    so equality alone cannot see them; physical.py:1624). String keys compare
    as codes over the two columns' union dictionary (`_aligned_key_codes`);
    numeric keys compare in numpy's promoted type, as the JAX package's host
    arrays do."""
    from ..ops.bucket_join import probe_keys_promoted

    keep = torch.ones(li.shape[0], dtype=torch.bool, device=li.device)
    for lk, rk in zip(left_keys, right_keys):
        lc, rc = left.column(lk), right.column(rk)
        if lc.is_string != rc.is_string:
            raise HyperspaceException("Join key type mismatch (string vs numeric)")
        if lc.is_string:
            la, ra = _aligned_key_codes(left, right, lk, rk)
            keep &= la[li] == ra[ri]
        else:
            a, b = probe_keys_promoted(lc.data[li], rc.data[ri])
            keep &= a == b
        if lc.validity is not None:
            keep &= lc.validity[li]
        if rc.validity is not None:
            keep &= rc.validity[ri]
    return keep


def _verify_pairs(
    left: Table, right: Table, left_keys: List[str], right_keys: List[str],
    li: torch.Tensor, ri: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate pairs that `_verified_keep` keeps."""
    if len(li):
        keep = _verified_keep(left, right, left_keys, right_keys, li, ri)
        if not bool(keep.all()):
            li, ri = li[keep], ri[keep]
    return li, ri


def _verified_match_counts(keep: torch.Tensor, li: torch.Tensor, ri: torch.Tensor, n_left: int, n_right: int):
    """(verified pairs, distinct matched left rows, distinct matched right
    rows) of candidate pairs and their keep mask, by scatter-max masks and
    one host sync (physical.py:2358): what every join type's count needs,
    from candidates or, with an all-true mask, from verified pairs."""
    k32 = keep.to(torch.int32)
    lmask = torch.zeros(n_left, dtype=torch.int32, device=li.device).scatter_reduce_(0, li, k32, "amax")
    rmask = torch.zeros(n_right, dtype=torch.int32, device=ri.device).scatter_reduce_(0, ri, k32, "amax")
    stats = torch.stack([keep.sum(), lmask.sum(), rmask.sum()]).tolist()
    return int(stats[0]), int(stats[1]), int(stats[2])


def _value_inner_count(lv: torch.Tensor, rv: torch.Tensor) -> int:
    """The inner join's count over one null-free numeric key pair, on the
    values (physical.py:2376): the right side sorted, the left values probed
    by a left and a right `searchsorted`, the ranges summed. Both sides
    compare in numpy's promoted type, as verification does. NaN equals
    nothing: NaN probes count zero, and right NaNs are dropped before the
    sort, since `torch.searchsorted` is not NaN-aware as numpy's is (an
    infinite probe's range would take them in)."""
    from ..ops.bucket_join import probe_keys_promoted

    lv, rv = probe_keys_promoted(lv, rv)
    if rv.is_floating_point():
        rv = rv[~torch.isnan(rv)]
    r_sorted = torch.sort(rv).values
    counts = torch.searchsorted(r_sorted, lv, side="right") - torch.searchsorted(r_sorted, lv, side="left")
    if lv.is_floating_point():
        counts = torch.where(torch.isnan(lv), torch.zeros_like(counts), counts)
    return int(counts.sum())


# ---------------------------------------------------------------------------
# The join memos (physical.py:1678-2101): device work that is a pure function
# of the joined rows, kept across queries under one byte budget.
# ---------------------------------------------------------------------------
#
# - "k64": a table's join key64, per table identity (`_cached_by_table`).
# - "pad": a table's dense padded rep (`PaddedBuckets`), per table identity.
# - "cpad": a join pair's size-classed layout (`_cached_two_table`).
# - "pairs": a pair's probe ranges (dense or classed, under subkeys of their
#   own) and its verified (li, ri) pairs, bucketed or general.
# - "ver": a string key pair's codes over the union dictionary.
#
# Bucketed two-table entries are keyed by the two scans' `rows_token`s when
# both have one (projection-independent: pairs computed against one column
# pruning serve every other); general-join and "ver" entries by table
# identity, the general pairs also by each side's `_relation_sig`. Every
# entry holds weak references to its tables and dies with them: the tables
# are owned by the scan caches. One LRU order over all entries (`_recency`) evicts under
# `HYPERSPACE_DEVICE_CACHE_BUDGET` (2 GiB). The JAX package's single-flight
# around each computation belongs to serving and is not ported.

_key64_cache: Dict[int, tuple] = {}
_padded_cache: Dict[int, tuple] = {}
_classed_cache: Dict[tuple, tuple] = {}
_pairs_cache: Dict[tuple, tuple] = {}
_verify_cache: Dict[tuple, tuple] = {}
_CACHES = {"k64": _key64_cache, "pad": _padded_cache, "cpad": _classed_cache, "pairs": _pairs_cache,
           "ver": _verify_cache}
_TWO_TABLE_TAGS = ("cpad", "pairs", "ver")
_MEMO_COUNTS = {t: {"hits": 0, "misses": 0} for t in _CACHES}
_MEMO_HITS = {t: _metrics.counter(f"memo.{t}.hits") for t in _CACHES}
_MEMO_MISSES = {t: _metrics.counter(f"memo.{t}.misses") for t in _CACHES}
_MEMO_PEEK_HITS = {t: _metrics.counter(f"memo.{t}.peek_hits") for t in _CACHES}
_MEMO_EVICTIONS = _metrics.counter("memo.evictions")
_MEMO_BYTES = _metrics.gauge("memo.device_cache.bytes")
_MEMO_BYTES_PEAK = _metrics.gauge("memo.device_cache.bytes_peak")
_cache_lock = threading.RLock()  # weakref callbacks may fire inside a guarded section
_DEVICE_CACHE_BUDGET_BYTES = env_bytes(ENV_DEVICE_CACHE_BUDGET, DEVICE_CACHE_BUDGET_DEFAULT)
_device_cache_bytes = 0
_device_cache_evictions = 0
_MISS = object()
#: (tag, key) of every entry, least recently used first.
_recency: Dict[tuple, None] = {}


def device_cache_stats() -> Dict[str, int]:
    """Entries and bytes the memos hold, lifetime evictions and the budget."""
    with _cache_lock:
        return {"entries": len(_recency), "bytes": _device_cache_bytes, "evictions": _device_cache_evictions,
                "budget": _DEVICE_CACHE_BUDGET_BYTES}


def memo_stats() -> Dict[str, Dict[str, int]]:
    """Hits and misses of each memo, and `device_cache_stats()`."""
    with _cache_lock:
        out = {t: dict(c) for t, c in _MEMO_COUNTS.items()}
    out["device_cache"] = device_cache_stats()
    return out


def set_device_cache_budget(n_bytes: int) -> None:
    global _DEVICE_CACHE_BUDGET_BYTES
    with _cache_lock:
        _DEVICE_CACHE_BUDGET_BYTES = int(n_bytes)


def clear_device_memos() -> None:
    """Drop every memo entry (a cold-executor measurement keeps the scan
    caches and clears these)."""
    global _device_cache_bytes
    with _cache_lock:
        for c in _CACHES.values():
            c.clear()
        _recency.clear()
        _device_cache_bytes = 0
        _MEMO_BYTES.set(0)


def _val_nbytes(val) -> int:
    total, stack = 0, [val]
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        else:
            total += int(getattr(x, "nbytes", 0) or 0)
    return total


def _entry_nbytes(tag: str, ent) -> int:
    if tag in _TWO_TABLE_TAGS:  # (wr_left, wr_right, value)
        return _val_nbytes(ent[2])
    return sum(_val_nbytes(v) for v in ent[1].values())  # (wr, {subkey: value})


def _touch(tag, key) -> None:
    _recency.pop((tag, key), None)
    _recency[(tag, key)] = None


def _drop_entry(tag: str, key) -> None:
    global _device_cache_bytes
    with _cache_lock:
        _recency.pop((tag, key), None)
        dropped = _CACHES[tag].pop(key, None)
        if dropped is not None:
            _device_cache_bytes -= _entry_nbytes(tag, dropped)
            _MEMO_BYTES.set(_device_cache_bytes)


def _evict_over_budget(protect: tuple) -> None:
    """Evict the least recently used entry across all memos until under the
    budget, never the entry just inserted (`protect`)."""
    global _device_cache_evictions
    with _cache_lock:
        _MEMO_BYTES.set(_device_cache_bytes)
        _MEMO_BYTES_PEAK.set_max(_device_cache_bytes)
        while _device_cache_bytes > _DEVICE_CACHE_BUDGET_BYTES:
            victim = next((rk for rk in _recency if rk != protect), None)
            if victim is None:
                return
            _drop_entry(*victim)
            _device_cache_evictions += 1
            _MEMO_EVICTIONS.inc()


def _count(tag: str, what: str) -> None:
    with _cache_lock:
        _MEMO_COUNTS[tag][what] += 1
    (_MEMO_HITS if what == "hits" else _MEMO_MISSES)[tag].inc()


def _cached_by_table(tag: str, table: Table, subkey, compute):
    """A per-table-identity memo, weakref-keyed so that an entry dies with
    its table (`physical._cached_by_table` :1817), computed under
single-flight."""
    cache, key = _CACHES[tag], id(table)
    with _cache_lock:
        ent = cache.get(key)
        if ent is not None and ent[0]() is table:
            hit = ent[1].get(subkey, _MISS)
            if hit is not _MISS:
                _touch(tag, key)
                _count(tag, "hits")
                return hit
    _count(tag, "misses")

    def probe():
        with _cache_lock:
            ent = cache.get(key)
            if ent is not None and ent[0]() is table:
                hit = ent[1].get(subkey, _MISS)
                if hit is not _MISS:
                    _touch(tag, key)
                    return hit
        return None

    def compute_and_insert():
        # Inside the flight: a follower wakes to the inserted entry.
        global _device_cache_bytes
        val = compute()
        nbytes = _val_nbytes(val)
        with _cache_lock:
            ent = cache.get(key)
            if ent is None or ent[0]() is not table:
                if ent is not None:  # a dead table's id, reused before its callback ran
                    _device_cache_bytes -= _entry_nbytes(tag, ent)

                def _evict(wr, key=key, finalizing=sys.is_finalizing):
                    if finalizing():  # interpreter exit: the module's globals may be gone
                        return
                    ent_now = cache.get(key)
                    if ent_now is not None and ent_now[0] is wr:
                        _drop_entry(tag, key)

                cache[key] = (weakref.ref(table, _evict), {subkey: val})
                _device_cache_bytes += nbytes
            elif subkey not in ent[1]:
                ent[1][subkey] = val
                _device_cache_bytes += nbytes
            else:
                val = ent[1][subkey]
            _touch(tag, key)
            _evict_over_budget((tag, key))
        return val

    # Queries racing the same cold entry run one device computation.
    return _singleflight.shared(("memo", tag, key, subkey), compute_and_insert, probe)


def _two_table_key(left: Table, right: Table, subkey: tuple, rows_key):
    """Key and validity test of a two-table entry: by table identity, or by
    the scans' row identity when they have one (the weak references then
    only bound the entry's life)."""
    if rows_key is None:
        return (id(left), id(right)) + subkey, lambda ent: ent[0]() is left and ent[1]() is right
    return rows_key + subkey, lambda ent: ent[0]() is not None and ent[1]() is not None


def _cached_two_table(tag: str, left: Table, right: Table, subkey: tuple, compute, rows_key=None):
    """A per-table-pair memo with the same accounting; an entry dies with
    either table (`physical._cached_two_table`)."""
    cache = _CACHES[tag]
    key, valid = _two_table_key(left, right, subkey, rows_key)
    with _cache_lock:
        ent = cache.get(key)
        if ent is not None and valid(ent):
            _touch(tag, key)
            _count(tag, "hits")
            return ent[2]
    _count(tag, "misses")

    def probe():
        with _cache_lock:
            ent = cache.get(key)
            if ent is not None and valid(ent):
                _touch(tag, key)
                return ent[2]
        return None

    def compute_and_insert():
        # Inside the flight: a follower wakes to the inserted entry.
        global _device_cache_bytes
        val = compute()

        def _evict(wr, key=key, finalizing=sys.is_finalizing):
            if finalizing():  # interpreter exit: the module's globals may be gone
                return
            ent_now = cache.get(key)
            if ent_now is not None and (ent_now[0] is wr or ent_now[1] is wr):
                _drop_entry(tag, key)

        with _cache_lock:
            ent = cache.get(key)
            if ent is not None:
                if valid(ent):
                    _touch(tag, key)
                    return ent[2]
                _device_cache_bytes -= _val_nbytes(ent[2])
            cache[key] = (weakref.ref(left, _evict), weakref.ref(right, _evict), val)
            _device_cache_bytes += _val_nbytes(val)
            _touch(tag, key)
            _evict_over_budget((tag, key))
        return val

    return _singleflight.shared(("memo", tag, key), compute_and_insert, probe)


def _peek_two_table(tag: str, left: Table, right: Table, subkey: tuple, rows_key=None):
    """(hit, value) of a two-table entry, computing nothing on a miss."""
    key, valid = _two_table_key(left, right, subkey, rows_key)
    with _cache_lock:
        ent = _CACHES[tag].get(key)
        if ent is not None and valid(ent):
            _touch(tag, key)
            _MEMO_COUNTS[tag]["hits"] += 1
            _MEMO_PEEK_HITS[tag].inc()
            return True, ent[2]
    return False, None


def _pair_rows_key(lnode, rnode, ctx) -> Optional[tuple]:
    """The two children's row identities, when both state one (a plain
    scan states none, physical.py:1993)."""
    lt, rt = getattr(lnode, "rows_token", None), getattr(rnode, "rows_token", None)
    if lt is None or rt is None:
        return None
    ltok, rtok = lt(ctx), rt(ctx)
    return None if ltok is None or rtok is None else (ltok, rtok)


def _node_relation_names(node) -> Optional[List[str]]:
    """The schema names of a join side's underlying relation (a scan, or a
    filter over one); None when the side has no single relation."""
    rel = getattr(node, "relation", None)
    if rel is None:
        rel = getattr(getattr(node, "child", None), "relation", None)
    return None if rel is None else list(rel.schema.names)


def _relation_sig(node) -> Optional[tuple]:
    """The identity of a general-join side's underlying relation for the
    general pairs memo (physical.py:2103): the index name, its log entry id
    and every file's (path, size, mtime), the appended files' included, so a
    refreshed index whose files alias the old stats still misses."""
    while node is not None and getattr(node, "relation", None) is None:
        node = getattr(node, "child", None)
    rel = getattr(node, "relation", None)
    if rel is None:
        return None
    sig = (rel.index_name, rel.log_entry_id, tuple((f.path, f.size, f.modified_time) for f in rel.files))
    ha = rel.hybrid_append
    return sig if ha is None else sig + (tuple((f.path, f.size, f.modified_time) for f in ha.files),)


def _pair_subkey(left_keys, right_keys, lnode, rnode, left: Optional[Table] = None,
                 right: Optional[Table] = None) -> tuple:
    """The join keys of a pair-memo key: lowercased only when no column name
    of either underlying relation collides with another case-insensitively
    (physical.py:2133). A side with no single relation reads its table's
    names."""
    l_names = _node_relation_names(lnode)
    r_names = _node_relation_names(rnode)
    names = (l_names if l_names is not None else left.column_names) + (
        r_names if r_names is not None else right.column_names
    )
    if len({n.lower() for n in names}) != len(set(names)):
        return tuple(left_keys), tuple(right_keys)
    return tuple(k.lower() for k in left_keys), tuple(k.lower() for k in right_keys)


def _dist_blocks(table: Table, starts: np.ndarray, keys: List[str], mesh):
    """A bucketed side's key layout on the mesh, kept per table identity
    (physical.py:2208): a steady-state sharded join starts at the probe."""
    from ..parallel.table_ops import build_dist_blocks

    subkey = ("dist", tuple(k.lower() for k in keys), id(mesh), mesh.size)
    return _cached_by_table("k64", table, subkey,
                            lambda: build_dist_blocks(mesh, _table_key64(table, list(keys)), starts))


def _table_key64(table: Table, keys: List[str], force_float=None) -> torch.Tensor:
    """Join key64 of a table's key columns, kept per table identity
    (physical.py:2222): a bucketed scan returns the same table across
    queries, so the hashed keys stay on the device. String keys hash their
    values through the dictionary; `force_float[i]` hashes numeric key i in
    the float64 space of a mixed int/float key pair (`_joint_float_flags`)."""
    subkey = (tuple(k.lower() for k in keys), None if force_float is None else tuple(force_float))
    return _cached_by_table(
        "k64", table, subkey, lambda: key64([table.column(k) for k in keys], force_float)
    )


def _joint_float_flags(lt: Table, rt: Table, lkeys: List[str], rkeys: List[str]):
    """Per-side flags of the keys that hash in float64 (physical.py:2249): a
    pair of an int key and a float key compares as float64, so the int side
    hashes there too. Float keys hash in float64 anyway, so only the int side
    of a mixed pair is flagged, and the float side keeps the key64 memo entry
    it shares with same-kind joins. Each side's list is None when nothing on
    it is flagged."""
    l_flags, r_flags = [], []
    for lk, rk in zip(lkeys, rkeys):
        lc, rc = lt.column(lk), rt.column(rk)
        if lc.is_string or rc.is_string:
            l_flags.append(False)
            r_flags.append(False)
            continue
        lf, rf = lc.data.is_floating_point(), rc.data.is_floating_point()
        l_flags.append(rf and not lf)
        r_flags.append(lf and not rf)
    return (l_flags if any(l_flags) else None, r_flags if any(r_flags) else None)


def _candidate_pairs(left: Table, right: Table, left_keys: List[str], right_keys: List[str]):
    """The general join's candidate pairs: a merge of the two sides' key64,
    hashed in the joint float64 space where a key pair mixes kinds."""
    with _tracing.step("join.hash"):
        l_flags, r_flags = _joint_float_flags(left, right, left_keys, right_keys)
        lk, rk = _table_key64(left, left_keys, l_flags), _table_key64(right, right_keys, r_flags)
    return merge_join_pairs(lk, rk)


def _join_pairs(left: Table, right: Table, left_keys: List[str], right_keys: List[str]):
    """The general join's verified pairs (physical.py:2274)."""
    li, ri = _candidate_pairs(left, right, left_keys, right_keys)
    with _tracing.step("join.verify"):
        return _verify_pairs(left, right, left_keys, right_keys, li, ri)


def _aligned_key_codes(left: Table, right: Table, lkey: str, rkey: str):
    """A string key pair's codes over the two columns' union dictionary, kept
    per table pair (physical.py:2159): aligned codes are equal exactly when
    the strings are, so verification never decodes a string."""

    def compute():
        lc, rc = align_dictionaries(left.column(lkey), right.column(rkey))
        return lc.data, rc.data

    return _cached_two_table("ver", left, right, (lkey.lower(), rkey.lower()), compute)


def _value_mode_column(table: Table, keys: List[str]) -> Optional[Column]:
    """The single join-key column when the side may run in value mode: one
    numeric, non-bool, null-free key (physical.py:2032). A nullable key pads
    by hash, so its null slots' fill values never meet in the probe as
    values; verification drops their pairs."""
    if len(keys) != 1:
        return None
    c = table.column(keys[0])
    if c.is_string or c.dtype == "bool" or c.validity is not None:
        return None
    return c


def _padded_rep(table: Table, starts: np.ndarray, keys: List[str], force_hash: bool = False):
    """One side's dense padded rep, kept per table identity (physical.py:2174):
    value-direct when `_value_mode_column` and the data allow it, else by
    key64 hash. `force_hash` derives the hash rep of a side that could go by
    value when the other side cannot: the probe needs both in one key space."""
    from ..ops.bucket_join import pad_buckets_by_hash, pad_buckets_by_value

    def compute():
        if not force_hash:
            c = _value_mode_column(table, keys)
            if c is not None:
                rep = pad_buckets_by_value(c.data, starts)
                if rep is not None:
                    return rep
        return pad_buckets_by_hash(_table_key64(table, list(keys)), starts)

    return _cached_by_table("pad", table, (tuple(k.lower() for k in keys), force_hash), compute)


def _probe_ranges_cached(l_rep, r_rep, left: Table, right: Table, subkey: tuple, rows_key):
    """K2's (lo, counts) of a dense pair in `probe_orientation`'s orientation,
    through the pairs memo under ("probe", mode) (physical.py:2007): a key of
    its own beside the classed ("cprobe", mode), so a flip of the layout's
    flag mid-session never hands one layout's ranges to the other."""
    from ..ops.bucket_join import probe_keys_promoted, probe_orientation, probe_ranges

    a, b, _ = probe_orientation(l_rep, r_rep)

    def compute():
        ak, bk = probe_keys_promoted(a.keys, b.keys)
        return probe_ranges(ak, bk, a.lengths, b.lengths)

    return _cached_two_table("pairs", left, right, ("probe", l_rep.mode) + subkey, compute, rows_key)


def _classed_plan(left: Table, right: Table, l_keys, r_keys, l_starts, r_starts):
    """The joint size-classed layout: value mode only when both sides qualify,
    else both sides pad by key64 hash (physical.py:2044)."""
    from ..ops.bucket_join import build_classed_plan, value_mode_vals

    lc = _value_mode_column(left, l_keys)
    rc = _value_mode_column(right, r_keys)
    if lc is not None and rc is not None:
        lv = value_mode_vals(lc.data, l_starts)
        rv = value_mode_vals(rc.data, r_starts)
        if lv is not None and rv is not None:
            return build_classed_plan(lv, rv, l_starts, r_starts, "value")
    lk = _table_key64(left, list(l_keys))
    rk = _table_key64(right, list(r_keys))
    return build_classed_plan(lk, rk, l_starts, r_starts, "hash")


class _PassThroughExec(PhysicalNode):
    """A plan marker on the join keys that passes its child's rows through."""

    def __init__(self, keys: Sequence[str], child: PhysicalNode):
        self.keys = list(keys)
        self.child = child

    def children(self):
        return (self.child,)

    def execute(self, ctx) -> Table:
        return self.child.execute(ctx)

    def execute_count(self, ctx) -> int:
        return self.child.execute_count(ctx)


class ExchangeInfo:
    """The partition layout a real exchange attaches to its output table
    (physical.py:897): rows grouped into `len(starts) - 1` hash partitions,
    key64-sorted within each, and `blocks`, the exchanged keys where they
    landed on the mesh, which the co-partitioned probe reads directly."""

    __slots__ = ("mesh", "keys", "starts", "blocks")

    def __init__(self, mesh, keys: List[str], starts: np.ndarray, blocks):
        self.mesh = mesh
        self.keys = keys
        self.starts = starts
        self.blocks = blocks


def _mesh_for(ctx, num_rows: int):
    return ctx.session.mesh_for(num_rows) if ctx.session is not None else None


class ShuffleExchangeExec(_PassThroughExec):
    """Hash repartitioning on the join keys (physical.py:913): the operator
    the bucketed index path eliminates. Over a device mesh it is a real
    exchange: rows ride the all-to-all to their partition's device and come
    back grouped by partition, the layout attached (`exchange_info`) for
    the join above. On one device it moves nothing."""

    name = "ShuffleExchange"

    def exchange_table(self, mesh, t: Table, partitions_per_device: int) -> Table:
        from ..parallel.table_ops import distributed_exchange_table

        exchanged, starts, blocks = distributed_exchange_table(mesh, t, self.keys, partitions_per_device)
        exchanged.exchange_info = ExchangeInfo(mesh, [k.lower() for k in self.keys], starts, blocks)
        return exchanged

    def execute(self, ctx) -> Table:
        # Run alone (physical.py:945). Under a join, the join decides for
        # both sides at once: a one-sided exchange is traffic for nothing.
        t = self.child.execute(ctx)
        mesh = _mesh_for(ctx, t.num_rows)
        if mesh is None or t.num_rows == 0:
            return t
        return self.exchange_table(mesh, t, ctx.session.hs_conf.partitions_per_device)

    def simple_string(self):
        return f"ShuffleExchange hashpartitioning({', '.join(self.keys)})"


class SortExec(_PassThroughExec):
    """The sort-merge join's required child ordering (physical.py:962): the
    general join sorts the key hashes itself (`merge_join_pairs`)."""

    name = "Sort"

    def simple_string(self):
        return f"Sort [{', '.join(self.keys)}]"


class SortMergeJoinExec(PhysicalNode):
    """The sort-merge join of every type: inner, left, right and full outer,
    left semi and left anti (`how`). `bucketed`: the co-bucketed join over
    two bucketed index scans, whose layout, probe ranges and verified pairs
    ride the join memos. Otherwise the general join (physical.py:2502): both
    children execute whole, a merge of their key64 gives the candidate pairs,
    and the verified pairs are kept per table pair and relation signature.
    Either way the verified inner pairs are assembled into the type's rows
    (`_assemble_join`)."""

    name = "SortMergeJoin"

    def __init__(self, left: PhysicalNode, right: PhysicalNode, left_keys: List[str], right_keys: List[str],
                 bucketed: bool = False, how: str = "inner"):
        self.left = left
        self.right = right
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.bucketed = bucketed
        self.how = how

    def children(self):
        return (self.left, self.right)

    @staticmethod
    def _unwrap_exchange(node: PhysicalNode) -> Optional[ShuffleExchangeExec]:
        if isinstance(node, SortExec):
            node = node.child
        return node if isinstance(node, ShuffleExchangeExec) else None

    def _general_children(self, ctx):
        """(lex, rex, lt, rt): both children executed below their exchange
        markers, with the markers (physical.py:2493); lex and rex are None
        where no joint exchange can apply."""
        lex, rex = self._unwrap_exchange(self.left), self._unwrap_exchange(self.right)
        if lex is not None and rex is not None and ctx.session is not None:
            return lex, rex, lex.child.execute(ctx), rex.child.execute(ctx)
        return None, None, self.left.execute(ctx), self.right.execute(ctx)

    def _exchanged(self, ctx, pre):
        """Both sides exchanged over the mesh where one applies to both
        together (physical.py:2510), else as they are: never a one-sided
        exchange, and not for a key pair mixing int and float, which each
        side would hash in its own kind's space."""
        lex, rex, lt, rt = pre
        if lex is None or rex is None or lt.num_rows == 0 or rt.num_rows == 0:
            return lt, rt
        if any(f is not None for f in _joint_float_flags(lt, rt, self.left_keys, self.right_keys)):
            return lt, rt
        mesh = ctx.session.mesh_for(lt.num_rows + rt.num_rows)
        if mesh is None:
            return lt, rt
        ppd = ctx.session.hs_conf.partitions_per_device
        return lex.exchange_table(mesh, lt, ppd), rex.exchange_table(mesh, rt, ppd)

    def _copartitioned_pairs(self, lt: Table, rt: Table):
        """Candidate pairs of two tables that came through real exchanges on
        this join's keys over one mesh (physical.py:2565): partition p of
        both lives on one shard, and the exchanged key blocks are probed
        where they are. None otherwise."""
        li, ri = getattr(lt, "exchange_info", None), getattr(rt, "exchange_info", None)
        if li is None or ri is None or li.mesh is not ri.mesh or len(li.starts) != len(ri.starts):
            return None
        if li.keys != [k.lower() for k in self.left_keys] or ri.keys != [k.lower() for k in self.right_keys]:
            return None
        from ..parallel.table_ops import probe_dist_blocks

        return probe_dist_blocks(li.mesh, li.blocks, ri.blocks)

    def _general_pairs(self, ctx, pre=None):
        """Both children's tables and their verified pairs (`pre`: the
        children already executed): over the mesh, from the co-partitioned
        probe of the exchanged tables (fresh tables every query, so nothing
        is kept); otherwise through the general pairs memo
        (physical.py:2502-2562)."""
        lt, rt = self._exchanged(ctx, pre if pre is not None else self._general_children(ctx))
        pairs = self._copartitioned_pairs(lt, rt)
        if pairs is not None:
            return (lt, rt) + _verify_pairs(lt, rt, self.left_keys, self.right_keys, *pairs)
        if getattr(lt, "exchange_info", None) is not None or getattr(rt, "exchange_info", None) is not None:
            return (lt, rt) + _join_pairs(lt, rt, self.left_keys, self.right_keys)
        with _tracing.step("join.keys"):
            subkey = (
                ("general",)
                + _pair_subkey(self.left_keys, self.right_keys, self.left, self.right, lt, rt)
                + (_relation_sig(self.left), _relation_sig(self.right))
            )
        with _tracing.step("join.pairs"):
            li, ri = _cached_two_table(
                "pairs", lt, rt, subkey, lambda: _join_pairs(lt, rt, self.left_keys, self.right_keys)
            )
        return lt, rt, li, ri

    def _sides(self, ctx):
        """Both children's bucketed tables and starts, the pair's memo
        subkey and its rows key (the sides' row tokens)."""
        left, l_starts = self.left.execute_concat(ctx)
        right, r_starts = self.right.execute_concat(ctx)
        with _tracing.step("join.keys"):
            subkey = _pair_subkey(self.left_keys, self.right_keys, self.left, self.right, left, right)
            rows_key = _pair_rows_key(self.left, self.right, ctx)
        return left, right, l_starts, r_starts, subkey, rows_key

    def _plan_and_ranges(self, left, right, l_starts, r_starts, subkey, rows_key):
        """The pair's size-classed layout and its probe, through the memos."""
        from ..ops.bucket_join import probe_classed

        with _tracing.step("join.layout"):
            plan = _cached_two_table(
                "cpad", left, right, ("cplan",) + subkey,
                lambda: _classed_plan(left, right, self.left_keys, self.right_keys, l_starts, r_starts), rows_key,
            )
        with _tracing.step("join.probe"):
            ranges = _cached_two_table("pairs", left, right, ("cprobe", plan.mode) + subkey,
                                       lambda: probe_classed(plan), rows_key)
        return plan, ranges

    def _reconciled_reps(self, left: Table, right: Table, l_starts, r_starts):
        """Both sides' dense reps in one mode (physical.py:2671): when one side
        cannot go by value (several files a bucket after a refresh or a Hybrid
        Scan append, a NaN, a nullable key), both go by hash."""
        l_rep = _padded_rep(left, l_starts, self.left_keys)
        r_rep = _padded_rep(right, r_starts, self.right_keys)
        if l_rep.mode != r_rep.mode:
            if l_rep.mode == "value":
                l_rep = _padded_rep(left, l_starts, self.left_keys, force_hash=True)
            else:
                r_rep = _padded_rep(right, r_starts, self.right_keys, force_hash=True)
        return l_rep, r_rep

    def _single_device_pairs(self, left, right, l_starts, r_starts, subkey, rows_key):
        """Candidate pairs of one device (physical.py:2636-2660) in the layout
        `size_classes_enabled()` names: the size-classed plan, or the dense
        reps probed through the probe memo."""
        from ..ops.bucket_join import classed_pairs, probe_padded, size_classes_enabled

        if size_classes_enabled():
            plan, ranges = self._plan_and_ranges(left, right, l_starts, r_starts, subkey, rows_key)
            with _tracing.step("join.expand"):
                return classed_pairs(plan, ranges)
        with _tracing.step("join.layout"):
            l_rep, r_rep = self._reconciled_reps(left, right, l_starts, r_starts)
        with _tracing.step("join.probe"):
            ranges = _probe_ranges_cached(l_rep, r_rep, left, right, subkey, rows_key)
        with _tracing.step("join.expand"):
            return probe_padded(l_rep, r_rep, ranges=ranges)

    def _pairs(self, ctx, verdict: bool = True, sides=None):
        """Both sides and their verified pairs (li, ri), through the pairs
        memo: in bucket-major order for the bucketed join, in `merge_join_pairs`'
        order for the general one. `verdict`: the bucketed join's memo hit or
        miss goes on the ambient span (`pairs_memo`). `sides`: the bucketed
        join's `_sides`, where the caller has them already."""
        if not self.bucketed:
            return self._general_pairs(ctx)
        left, right, l_starts, r_starts, subkey, rows_key = sides or self._sides(ctx)
        if left.num_rows == 0 or right.num_rows == 0:
            empty = torch.empty(0, dtype=torch.int64, device=ctx.device)
            return left, right, empty, empty

        computed = []

        def compute():
            computed.append(True)
            pairs = self._mesh_pairs(ctx, left, right, l_starts, r_starts)
            if pairs is None:
                pairs = self._single_device_pairs(left, right, l_starts, r_starts, subkey, rows_key)
            with _tracing.step("join.verify"):
                return _verify_pairs(left, right, self.left_keys, self.right_keys, *pairs)

        with _tracing.step("join.pairs"):
            li, ri = _cached_two_table("pairs", left, right, subkey, compute, rows_key)
        # On the operator's span, outside the step: explain(analyze=True) reads it there.
        if verdict:
            _tracing.set_attr("pairs_memo", "miss" if computed else "hit")
        return left, right, li, ri

    def _mesh_pairs(self, ctx, left: Table, right: Table, l_starts, r_starts):
        """The co-bucketed pairs from the mesh's sharded probe
        (physical.py:2612-2633): each shard joins its own bucket range, K1
        and K2 on every shard. None with no mesh, or a layout with an
        outlier bucket while size classes are on (`mesh_probe_skew_safe`),
        which stays on the size-classed executor."""
        from ..ops.bucket_join import mesh_probe_skew_safe
        from ..parallel.table_ops import probe_dist_blocks

        mesh = _mesh_for(ctx, left.num_rows + right.num_rows)
        if mesh is None or not mesh_probe_skew_safe(l_starts, r_starts):
            return None
        l_blocks = _dist_blocks(left, l_starts, self.left_keys, mesh)
        r_blocks = _dist_blocks(right, r_starts, self.right_keys, mesh)
        if l_blocks is None or r_blocks is None:
            return None
        return probe_dist_blocks(mesh, l_blocks, r_blocks)

    def execute(self, ctx) -> Table:
        left, right, li, ri = self._pairs(ctx)
        with _tracing.step("join.gather"):
            return _assemble_join(left, right, li, ri, self.how)

    def execute_count(self, ctx) -> int:
        """The join's row count without assembling its rows (physical.py:2473).
        The general join takes `_general_count_fast`. A bucketed inner join
        that a query collected already holds the verified pairs; otherwise
        value-mode probe counts, of either layout, compare the key values and
        are the exact count with no pair expansion (physical.py:2685-2777),
        and hash mode (or a device mesh) counts the verified pairs. A
        bucketed join of another type counts its verified pairs and the rows
        of each side they name."""
        from ..ops.bucket_join import size_classes_enabled

        if not self.bucketed:
            return self._general_count_fast(ctx)
        if self.how != "inner":
            left, right, li, ri = self._pairs(ctx)
            every = torch.ones(len(li), dtype=torch.bool, device=li.device)
            stats = _verified_match_counts(every, li, ri, left.num_rows, right.num_rows)
            return _count_from_match_stats(self.how, *stats, left.num_rows, right.num_rows)
        left, right, l_starts, r_starts, subkey, rows_key = self._sides(ctx)
        if left.num_rows == 0 or right.num_rows == 0:
            return 0
        hit, val = _peek_two_table("pairs", left, right, subkey, rows_key)
        if hit:
            return len(val[0])
        if _mesh_for(ctx, left.num_rows + right.num_rows) is not None:
            return len(self._pairs(ctx)[2])  # the sharded probe owns mesh-scale counts (physical.py:2716)
        if size_classes_enabled():
            plan, ranges = self._plan_and_ranges(left, right, l_starts, r_starts, subkey, rows_key)
            if plan.mode == "value":
                return ranges.total
        else:
            l_rep, r_rep = self._reconciled_reps(left, right, l_starts, r_starts)
            if l_rep.mode == "value":
                counts = _probe_ranges_cached(l_rep, r_rep, left, right, subkey, rows_key)[1]
                return int(counts.sum(dtype=torch.int64))
        return len(self._pairs(ctx)[2])

    def _general_count_fast(self, ctx) -> int:
        """The general join's count for every type, without the pairs memo
        (physical.py:2780): it neither reads nor fills it, so a later collect
        builds its pairs as it would have. An inner join on one null-free
        numeric key pair counts on the values (`_value_inner_count`); any
        other merges the key64, verifies the candidates and counts the
        verified pairs and the rows of each side they name
        (`_verified_match_counts`). Everything stays on the tables' device
        but the counts. Over a device mesh the exchanged join's pairs are
        counted instead."""
        pre = self._general_children(ctx)
        lt, rt = pre[2], pre[3]
        n_left, n_right = lt.num_rows, rt.num_rows
        if n_left == 0 or n_right == 0:
            return _count_from_match_stats(self.how, 0, 0, 0, n_left, n_right)
        if _mesh_for(ctx, n_left + n_right) is not None:
            # The exchange path owns mesh-scale counts (physical.py:2802).
            _, _, li, ri = self._general_pairs(ctx, pre)
            every = torch.ones(len(li), dtype=torch.bool, device=li.device)
            stats = _verified_match_counts(every, li, ri, n_left, n_right)
            return _count_from_match_stats(self.how, *stats, n_left, n_right)
        if self.how == "inner":
            lc, rc = _value_mode_column(lt, self.left_keys), _value_mode_column(rt, self.right_keys)
            if lc is not None and rc is not None:
                return _value_inner_count(lc.data, rc.data)
        li, ri = _candidate_pairs(lt, rt, self.left_keys, self.right_keys)
        n_pairs = lm = rm = 0
        if len(li):
            keep = _verified_keep(lt, rt, self.left_keys, self.right_keys, li, ri)
            n_pairs, lm, rm = _verified_match_counts(keep, li, ri, n_left, n_right)
        return _count_from_match_stats(self.how, n_pairs, lm, rm, n_left, n_right)

    def simple_string(self):
        how = f" {self.how}" if self.how != "inner" else ""
        pairs = ", ".join(f"{l}={r}" for l, r in zip(self.left_keys, self.right_keys))
        return f"SortMergeJoin{how} [{pairs}]" + (" (bucketed, no exchange)" if self.bucketed else "")


class MultiwayJoinExec(PhysicalNode):
    """An N-way star join planned from a `StarJoinNode` (physical.py:2965).
    `cascade` is the cascade of binary joins planned as if the wrapper did
    not exist; `execute` and `execute_count` run it, so every consumer but
    the streamed star aggregate gets the cascade's answer. `fact` and `dims`
    (dim_exec, fact_keys, dim_keys, index_name, num_buckets per dimension,
    innermost join first) are what `streaming.stream_star_aggregate`
    probes."""

    name = "MultiwayJoin"

    def __init__(self, fact: PhysicalNode, dims, cascade: PhysicalNode):
        self.fact = fact
        self.dims = list(dims)
        self.cascade = cascade

    def children(self):
        return (self.fact,) + tuple(d[0] for d in self.dims) + (self.cascade,)

    def execute(self, ctx) -> Table:
        return self.cascade.execute(ctx)

    def execute_count(self, ctx) -> int:
        return self.cascade.execute_count(ctx)

    def simple_string(self):
        names = ", ".join(d[3] or "?" for d in self.dims)
        return f"MultiwayJoin ({len(self.dims)} dims: {names})"


class WithColumnExec(PhysicalNode):
    """A computed column (physical.py:991): replaces a same-named column in
    place, else appends; the value conforms to the declared type."""

    name = "WithColumn"

    def __init__(self, col_name: str, expr: Expr, child: PhysicalNode, dtype: Optional[str] = None):
        self.col_name = col_name
        self.expr = expr
        self.child = child
        self.dtype = dtype

    def children(self):
        return (self.child,)

    def execute(self, ctx) -> Table:
        return self.apply(self.child.execute(ctx))

    def execute_stream(self, ctx, stages=None):
        """Row-wise, so chunk by chunk equals whole (physical.py:1009)."""
        from ..telemetry.profiling import timed

        for t in self.child.execute_stream(ctx, stages):
            with timed(stages, "eval"):
                out = self.apply(t)
            yield out

    def apply(self, t: Table) -> Table:
        new_col = evaluate_column(self.expr, t)
        if self.dtype not in (None, "string") and not new_col.is_string and new_col.dtype != self.dtype:
            new_col = Column(self.dtype, new_col.data.to(TORCH_DTYPES[self.dtype]), None, new_col.validity)
        out: Dict[str, Column] = {}
        replaced = False
        for n, c in t.columns.items():
            if n.lower() == self.col_name.lower():
                out[n] = new_col
                replaced = True
            else:
                out[n] = c
        if not replaced:
            out[self.col_name] = new_col
        return Table(out)

    def execute_count(self, ctx) -> int:
        return self.child.execute_count(ctx)

    def simple_string(self):
        return f"WithColumn {self.col_name} = {self.expr!r}"


class HashAggregateExec(PhysicalNode):
    """Grouped aggregation by a key64 sort and segment reductions
    (`ops.aggregate.hash_aggregate`), tried in the JAX device program's order
    (physical.py:1236): the streamed star join aggregate, then the streamed
    scan aggregate, then the one-pass aggregate of the child's table (over a
    bucketed join it gives the answer of the JAX package's fused join
    aggregate, which stands in that slot)."""

    name = "HashAggregate"

    def __init__(self, group_keys: Sequence[str], aggs: Sequence[tuple], child: PhysicalNode):
        self.group_keys = list(group_keys)
        self.aggs = [tuple(a) for a in aggs]
        self.child = child

    def children(self):
        return (self.child,)

    def execute(self, ctx) -> Table:
        out = self._try_stream_star_agg(ctx)
        if out is None:
            out = self._try_fused_join_agg(ctx)
        if out is None:
            out = self._try_stream_agg(ctx)
        if out is None:
            out = hash_aggregate(self.child.execute(ctx), self.group_keys, self.aggs)
        return out

    def _try_fused_join_agg(self, ctx) -> Optional[Table]:
        """The JAX device program's fused join aggregate slot
        (physical.py:1350): a grouped aggregate with no count_distinct over a
        WithColumn/Project chain over a bucketed inner join of two non-empty
        sides aggregates the join's rows without executing the join and the
        chain as operators, so they open no span (the JAX package's analyzed
        tree marks them not executed). The rows are `execute`'s; None when
        the shape does not apply or a device mesh takes the join."""
        if not self.group_keys or any(fn == "count_distinct" for _, fn, _ in self.aggs):
            return None
        chain: List[PhysicalNode] = []
        node = self.child
        while isinstance(node, (WithColumnExec, ProjectExec)):
            chain.append(node)
            node = node.child
        if not (isinstance(node, SortMergeJoinExec) and node.bucketed and node.how == "inner"):
            return None
        sides = node._sides(ctx)
        left, right = sides[:2]
        if left.num_rows == 0 or right.num_rows == 0:
            return None
        if _mesh_for(ctx, left.num_rows + right.num_rows) is not None:
            return None  # the sharded probe owns mesh-scale execution (physical.py:1386)
        left, right, li, ri = node._pairs(ctx, verdict=False, sides=sides)
        with _tracing.step("join.gather"):
            t = _assemble_join(left, right, li, ri, "inner")
        for op in reversed(chain):
            t = op.apply(t) if isinstance(op, WithColumnExec) else t.select(op.column_names)
        return hash_aggregate(t, self.group_keys, self.aggs)

    def _streamable(self) -> bool:
        from ..ops.aggregate import streaming_agg_supported
        from .streaming import streaming_enabled

        return streaming_enabled() and streaming_agg_supported(self.group_keys, self.aggs)

    def _try_stream_star_agg(self, ctx) -> Optional[Table]:
        """The streamed star join aggregate when this aggregate sits on a
        WithColumn/Project chain over a `MultiwayJoinExec` and the gates are
        on (physical.py:1253); None otherwise, and the star join runs its
        cascade."""
        from ..ops.bucket_join import size_classes_enabled
        from .streaming import multiway_enabled, stream_star_aggregate

        if not (multiway_enabled() and size_classes_enabled() and self._streamable()):
            return None
        chain: List[PhysicalNode] = []
        node = self.child
        while isinstance(node, (WithColumnExec, ProjectExec)):
            chain.append(node)
            node = node.child
        if not isinstance(node, MultiwayJoinExec):
            return None
        return stream_star_aggregate(self, node, chain, ctx)

    def _try_stream_agg(self, ctx) -> Optional[Table]:
        """The streamed scan aggregate when this aggregate sits on a
        Filter/Project/WithColumn chain over a plain scan of two or more
        files (physical.py:1323); a single file has nothing to overlap and
        stays one-pass."""
        from .streaming import stream_aggregate

        if not self._streamable():
            return None
        node = self.child
        while isinstance(node, (FilterExec, ProjectExec, WithColumnExec)):
            node = node.child
        if type(node) is not ScanExec or not node.can_stream() or len(node.relation.files) < 2:
            return None
        return stream_aggregate(self, ctx)

    def simple_string(self):
        aggs = ", ".join(f"{o}={fn}({c if c is not None else '*'})" for o, fn, c in self.aggs)
        return f"HashAggregate [{', '.join(self.group_keys)}] [{aggs}]"


def _order_lane(c: Column) -> torch.Tensor:
    """An int64 lane whose stable ascending sort orders the column's values as
    `np.lexsort` does (`ops.partition.sortable_lane`): strings by dictionary
    code (the dictionary is sorted), signed zeros tied, NaNs tied after +inf."""
    return sortable_lane(c.data).to(torch.int64)


class OrderByExec(PhysicalNode):
    """A total ORDER BY (physical.py:1464), in `np.lexsort`'s stable order.
    Each key gives a value lane and, when the column has nulls, a validity
    lane above it: nulls first ascending, last descending (Spark's default).
    A descending value lane is the bitwise complement of the ascending one,
    which reverses its order and keeps its ties, as the JAX package's negated
    dense rank does. The rows' order is built on the tables' device by one
    stable sort per lane, least significant first, then one take."""

    name = "OrderBy"

    def __init__(self, keys: Sequence[tuple], child: PhysicalNode):
        self.keys = [(k, bool(asc)) for k, asc in keys]
        self.child = child

    def children(self):
        return (self.child,)

    def execute_count(self, ctx) -> int:
        return self.child.execute_count(ctx)

    def execute(self, ctx) -> Table:
        t = self.child.execute(ctx)
        return t if t.num_rows <= 1 else t.take(self.order(t))

    def order(self, t: Table) -> torch.Tensor:
        """The rows' permutation: the lanes sorted least significant first."""
        lanes = []
        for name, asc in reversed(self.keys):
            c = t.column(name)
            lane = _order_lane(c)
            lanes.append(lane if asc else ~lane)
            if c.validity is not None:
                lanes.append((c.validity if asc else ~c.validity).to(torch.int64))
        perm = torch.sort(lanes[0], stable=True).indices
        for lane in lanes[1:]:
            perm = perm[torch.sort(lane[perm], stable=True).indices]
        return perm

    def simple_string(self):
        keys = ", ".join(f"{k} {'ASC' if a else 'DESC'}" for k, a in self.keys)
        return f"OrderBy [{keys}]"


class LimitExec(PhysicalNode):
    """The child's first n rows (physical.py:1511). Directly over a plain
    multi-file scan it reads only the files that hold them (`_scan_prefix`)."""

    name = "Limit"

    def __init__(self, n: int, child: PhysicalNode):
        self.n = int(n)
        self.child = child

    def children(self):
        return (self.child,)

    def execute(self, ctx) -> Table:
        t = self._scan_prefix(ctx)
        if t is None:
            t = self.child.execute(ctx)
        return t if t.num_rows <= self.n else t.slice(0, self.n)

    def _scan_prefix(self, ctx) -> Optional[Table]:
        """A limit over a plain multi-file scan, through a projection or not
        (physical.py:1529): the files in order until their footers' row
        counts reach n, read as the scan would read them. None when the path
        does not apply, a footer cannot be read, or every file is needed."""
        child, project = self.child, None
        if isinstance(child, ProjectExec):
            project, child = child, child.child
        if type(child) is not ScanExec:
            return None
        rel = child.relation
        if (
            rel.bucket_spec is not None
            or rel.partition_spec is not None
            or rel.file_format not in engine_io.PARQUET_SHAPED
            or len(rel.files) <= 1
        ):
            return None
        picked, total = [], 0
        for f in rel.files:
            picked.append(f)
            n = engine_io.footer_row_count([f])
            if n is None:  # an unreadable footer: the plain read reports it
                return None
            total += n
            if total >= self.n:
                break
        if len(picked) == len(rel.files):
            return None
        cols = _default_scan_columns(rel, child.columns)
        with _corruption_guard(rel):
            t = engine_io.read_files([f.path for f in picked], rel.file_format, cols, ctx.device)
        return t.select(project.column_names) if project is not None else t

    def execute_count(self, ctx) -> int:
        return min(self.n, self.child.execute_count(ctx))

    def simple_string(self):
        return f"Limit {self.n}"


def _orient_join_keys(pairs, left_schema: Schema, right_schema: Schema):
    """Orient each (a, b) condition pair as (left_col, right_col); a name
    resolving on both sides is refused (physical.py:3007)."""
    lkeys, rkeys = [], []
    for a, b in pairs:
        a_in_l, a_in_r = a in left_schema, a in right_schema
        b_in_l, b_in_r = b in left_schema, b in right_schema
        if a.lower() == b.lower() and a_in_l and b_in_r:
            lkeys.append(a)
            rkeys.append(b)
        elif a_in_l and b_in_r and not (a_in_r or b_in_l):
            lkeys.append(a)
            rkeys.append(b)
        elif a_in_r and b_in_l and not (a_in_l or b_in_r):
            lkeys.append(b)
            rkeys.append(a)
        else:
            raise HyperspaceException(f"Cannot resolve join condition column(s) {a!r}/{b!r}")
    return lkeys, rkeys


def _bucketed_join_keys(lbucket, rbucket, lkeys, rkeys, key):
    """The join keys in bucket-column order when both sides are bucketed on
    exactly the join keys, in the same order under the key mapping, with equal
    bucket counts and hash kinds (the planner-side re-check of the join rule's
    compatibility condition); else None, and the join takes the general path
    (an int-bucketed side does not co-locate with a float-bucketed one)."""
    lspec, rspec = lbucket.relation.bucket_spec, rbucket.relation.bucket_spec
    pair_map: Dict[str, str] = {}
    for l, r in zip(lkeys, rkeys):
        if key(pair_map.get(key(l), r)) != key(r):
            return None
        pair_map[key(l)] = r
    lbc, rbc = list(lspec.bucket_columns), list(rspec.bucket_columns)
    if not (
        len({key(k) for k in lkeys}) == len(lkeys)
        and lspec.num_buckets == rspec.num_buckets
        and {key(c) for c in lbc} == {key(k) for k in lkeys}
        and [key(pair_map.get(key(c), "")) for c in lbc] == [key(c) for c in rbc]
    ):
        return None
    jl, jr = lbc, [pair_map[key(c)] for c in lbc]

    def kind(schema, name):
        dt = schema.field(name).dtype
        return "f" if dt in ("float32", "float64") else ("s" if dt == "string" else "i")

    if any(kind(lbucket.relation.schema, a) != kind(rbucket.relation.schema, b) for a, b in zip(jl, jr)):
        return None
    return jl, jr


def plan_physical(
    logical: LogicalPlan, required: Optional[List[str]] = None, case_sensitive: bool = False
) -> PhysicalNode:
    """Compile a logical plan, pushing column pruning into scans (physical.py:3044)."""
    from ..util.resolver_utils import resolution_key

    def key(s: str) -> str:
        return resolution_key(s, case_sensitive)

    if isinstance(logical, ScanNode):
        rel = logical.relation
        cols = None
        if required is not None:
            wanted = {key(r) for r in required}
            cols = [n for n in rel.schema.names if key(n) in wanted] or rel.schema.names[:1]
        if rel.bucket_spec is not None:
            return BucketedIndexScanExec(rel, cols)
        return ScanExec(rel, cols)

    if isinstance(logical, FilterNode):
        child_required = None
        refs = sorted(logical.condition.references())
        if required is not None:
            child_required = list(dict.fromkeys(list(required) + refs))
        else:
            # "Everything" leaves out a scan's hidden lineage column: a
            # condition naming it (the delete prune) asks for it explicitly.
            visible = {n.lower() for n in logical.child.output_schema.names}
            if any(r.lower() not in visible for r in refs):
                child_required = list(dict.fromkeys(list(logical.child.output_schema.names) + refs))
        child = plan_physical(logical.child, child_required, case_sensitive)
        if type(child) is ScanExec:
            # The scan may skip row groups that cannot pass this filter
            # (physical.py:3087); the filter still evaluates all it gets.
            child.pushdown = logical.condition
        return FilterExec(logical.condition, child)

    if isinstance(logical, ProjectNode):
        return ProjectExec(
            logical.column_names,
            plan_physical(logical.child, list(logical.column_names), case_sensitive),
        )

    if isinstance(logical, UnionNode):
        return UnionExec([plan_physical(c, required, case_sensitive) for c in logical.children()])

    if isinstance(logical, (IntersectNode, ExceptNode)):
        # Row equality spans every column, so neither side is pruned to the
        # columns above (physical.py:3103); a projection above prunes the output.
        return SetOpExec(
            "intersect" if isinstance(logical, IntersectNode) else "except",
            plan_physical(logical.left, None, case_sensitive),
            plan_physical(logical.right, None, case_sensitive),
        )

    if isinstance(logical, WithColumnNode):
        if required is not None and all(key(r) != key(logical.name) for r in required):
            return plan_physical(logical.child, required, case_sensitive)  # pruned out above
        child_required = None
        if required is not None:
            keep = [r for r in required if key(r) != key(logical.name)]
            child_required = list(dict.fromkeys(keep + sorted(logical.expr.references())))
        return WithColumnExec(
            logical.name, logical.expr, plan_physical(logical.child, child_required, case_sensitive),
            dtype=logical.output_schema.field(logical.name).dtype,
        )

    if isinstance(logical, AggregateNode):
        # An aggregate reads only its keys and inputs (physical.py:3133).
        child_required = list(dict.fromkeys(logical.references())) or logical.child.output_schema.names[:1]
        return HashAggregateExec(
            logical.group_keys, logical.aggs, plan_physical(logical.child, child_required, case_sensitive)
        )

    if isinstance(logical, OrderByNode):
        child_required = None
        if required is not None:
            child_required = list(dict.fromkeys(list(required) + [k for k, _ in logical.keys]))
        return OrderByExec(logical.keys, plan_physical(logical.child, child_required, case_sensitive))

    if isinstance(logical, LimitNode):
        return LimitExec(logical.n, plan_physical(logical.child, required, case_sensitive))

    if isinstance(logical, JoinNode):
        pairs = extract_equi_join_keys(logical.condition)
        if pairs is None:
            raise HyperspaceException(f"Only equi-joins are supported: {logical.condition!r}")
        lschema, rschema = logical.left.output_schema, logical.right.output_schema
        lkeys, rkeys = _orient_join_keys(pairs, lschema, rschema)
        how = logical.how
        lreq = rreq = None
        if required is not None:
            req = {key(r) for r in required}
            lreq = list(dict.fromkeys([n for n in lschema.names if key(n) in req] + lkeys))
            rreq = list(dict.fromkeys([n for n in rschema.names if key(n) in req] + rkeys))
        if how in ("left_semi", "left_anti"):
            rreq = list(dict.fromkeys(rkeys))  # the output is the left side's (physical.py:3173)
        lphys = plan_physical(logical.left, lreq, case_sensitive)
        rphys = plan_physical(logical.right, rreq, case_sensitive)
        # Every type rides the bucketed path (physical.py:3182): its result
        # derives from the verified inner pairs, as on the general path.
        if _bucketed(lphys) and _bucketed(rphys):
            keys = _bucketed_join_keys(lphys, rphys, lkeys, rkeys, key)
            if keys is not None:
                return SortMergeJoinExec(lphys, rphys, keys[0], keys[1], bucketed=True, how=how)
        # The general join (physical.py:3252): a bucketed scan becomes a plain
        # read of its index files, and each side an exchange and a sort.
        if isinstance(lphys, BucketedIndexScanExec):
            lphys = ScanExec(lphys.relation, lphys.columns)
        if isinstance(rphys, BucketedIndexScanExec):
            rphys = ScanExec(rphys.relation, rphys.columns)
        lside = SortExec(lkeys, ShuffleExchangeExec(lkeys, lphys))
        rside = SortExec(rkeys, ShuffleExchangeExec(rkeys, rphys))
        return SortMergeJoinExec(lside, rside, lkeys, rkeys, bucketed=False, how=how)

    if isinstance(logical, StarJoinNode):
        return _plan_star(logical, required, case_sensitive)

    raise not_in_slice(f"the {type(logical).__name__} operator")


def _plan_star(logical: StarJoinNode, required, case_sensitive: bool) -> PhysicalNode:
    """A `MultiwayJoinExec` of a star join (physical.py:3258): the cascade
    planned as if unwrapped, the fact re-derived from the cascade's left
    spine (later rules may have rewritten it), and each dimension's
    covering-index subplan. The plain cascade when the spine no longer
    matches the dimensions or a dimension lost its bucketed scan."""
    cascade = plan_physical(logical.cascade, required, case_sensitive)
    try:
        chain: List[JoinNode] = []
        cur: LogicalPlan = logical.cascade
        while isinstance(cur, JoinNode):
            chain.append(cur)
            cur = cur.left
        if len(chain) != len(logical.dims) or any(j.how != "inner" for j in chain):
            return cascade
        fact = plan_physical(cur, list(logical.fact_required), case_sensitive)
        dims = []
        for d in logical.dims:
            dim_phys = plan_physical(d.plan, list(d.dim_required), case_sensitive)
            probe = dim_phys.child if isinstance(dim_phys, FilterExec) else dim_phys
            if not isinstance(probe, BucketedIndexScanExec):
                return cascade
            dims.append((dim_phys, list(d.fact_keys), list(d.dim_keys), d.index_name, int(d.num_buckets)))
        return MultiwayJoinExec(fact, dims, cascade)
    except HyperspaceException:
        return cascade
