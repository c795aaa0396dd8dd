"""Session + DataFrame API (counterpart of `hyperspace_tpu/engine/session.py`).

A session carries the conf, the filesystem, the device its tables live on,
its named views and the optimizer extension point (`extra_optimizations`)
that `enable_hyperspace` plugs the rewrite rules into. The device defaults to
CUDA.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from ..config import HyperspaceConf, SessionConf
from ..exceptions import HyperspaceException
from ..ops.backend import resolve_device
from ..storage import delta as delta_log
from ..storage.filesystem import FileStatus, FileSystem, LocalFileSystem
from ..util.resolver_utils import resolution_key
from . import io as engine_io
from .expr import Expr
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
    UnionNode,
    WithColumnNode,
    push_filters_below_computed,
)
from .partitioning import discover
from .physical import ExecContext, PhysicalNode, plan_physical
from .schema import Schema
from .table import Table


class DataFrame:
    def __init__(self, session: "HyperspaceSession", plan: LogicalPlan):
        self.session = session
        self.plan = plan

    # -- transformations ----------------------------------------------------

    def select(self, *columns: str) -> "DataFrame":
        names = list(columns[0]) if len(columns) == 1 and isinstance(columns[0], (list, tuple)) else list(columns)
        missing = [n for n in names if n not in self.plan.output_schema]
        if missing:
            raise HyperspaceException(f"Column(s) not found: {missing}")
        return DataFrame(self.session, ProjectNode(names, self.plan))

    def join(self, other: "DataFrame", on: Expr, how: str = "inner") -> "DataFrame":
        return DataFrame(self.session, JoinNode(self.plan, other.plan, on, how))

    def filter(self, condition: Expr) -> "DataFrame":
        return DataFrame(self.session, FilterNode(condition, self.plan))

    where = filter

    def with_column(self, name: str, expr: Expr) -> "DataFrame":
        """A computed column (Spark `withColumn`): replaces a same-named column
        in place, else appends, e.g. `col("price") * (1 - col("discount"))`."""
        return DataFrame(self.session, WithColumnNode(name, expr, self.plan))

    withColumn = with_column

    def group_by(self, *keys: str) -> "GroupedDataFrame":
        names = list(keys[0]) if len(keys) == 1 and isinstance(keys[0], (list, tuple)) else list(keys)
        for n in names:
            self.plan.output_schema.field(n)  # resolve or raise
        return GroupedDataFrame(self, names)

    groupBy = group_by

    def agg(self, **aggs) -> "DataFrame":
        """A global aggregate (no grouping): `df.agg(total=("qty", "sum"))`."""
        return GroupedDataFrame(self, []).agg(**aggs)

    def order_by(self, *keys, ascending: bool = True) -> "DataFrame":
        """ORDER BY. Keys are column names or (name, ascending) pairs; the
        `ascending` keyword is the default for bare names."""
        parsed = [(k[0], bool(k[1])) if isinstance(k, tuple) else (k, ascending) for k in keys]
        return DataFrame(self.session, OrderByNode(parsed, self.plan))

    orderBy = order_by
    sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, LimitNode(n, self.plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL of frames of one schema; `.distinct()` after it is the
        set union."""
        return DataFrame(self.session, UnionNode([self.plan, other.plan]))

    unionAll = union

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """The distinct rows present in both frames (SQL INTERSECT; a null
        equals a null)."""
        return DataFrame(self.session, IntersectNode(self.plan, other.plan))

    def subtract(self, other: "DataFrame") -> "DataFrame":
        """The distinct rows of this frame absent from `other` (SQL EXCEPT)."""
        return DataFrame(self.session, ExceptNode(self.plan, other.plan))

    def distinct(self) -> "DataFrame":
        """The distinct rows: a group-by of every column with no aggregate."""
        return DataFrame(self.session, AggregateNode(self.plan.output_schema.names, [], self.plan))

    def drop(self, *columns: str) -> "DataFrame":
        """Every column but the named ones (a name not present is ignored, as
        in Spark), matched under `hyperspace.resolution.caseSensitive`."""
        cs = self.session.hs_conf.case_sensitive
        gone = {resolution_key(c, cs) for c in columns}
        keep = [n for n in self.plan.output_schema.names if resolution_key(n, cs) not in gone]
        if not keep:
            raise HyperspaceException("drop() would remove every column")
        return self.select(keep)

    def scalar(self):
        """The one value of a 1x1 result (a scalar subquery composed eagerly):
        `df.filter(col("x") > other.group_by().agg(m=("x", "max")).scalar())`."""
        t = self.collect()
        if t.num_rows != 1 or len(t.column_names) != 1:
            raise HyperspaceException(f"scalar() requires a 1x1 result, got {t.num_rows}x{len(t.column_names)}")
        return t.rows()[0][0]

    # -- actions ------------------------------------------------------------

    @property
    def schema(self):
        return self.plan.output_schema

    def optimized_plan(self) -> LogicalPlan:
        return self.session.optimize(self.plan)

    def physical_plan(self) -> PhysicalNode:
        return plan_physical(
            self.optimized_plan(), case_sensitive=self.session.hs_conf.case_sensitive
        )

    def _run_with_quarantine_fallback(self, runner):
        """Plan (the `plan` span), fingerprint, decide the planner's knobs
        and run (`session.py:173-224`). A `CorruptIndexError` quarantines the
        index it names, warns and re-plans: the rules then skip that index,
        so the query answers from the source. Each round quarantines a new
        index; a repeated mark propagates the error."""
        import time
        import warnings

        from ..exceptions import CorruptIndexError
        from ..index import quarantine
        from ..plananalysis import attribution, planner
        from ..telemetry import accounting, tracing

        accounting.note_device(self.session.device)
        while True:
            with tracing.span("plan"):
                phys = self.physical_plan()
            fp = self._attach_fingerprint(phys)
            decisions = planner.decide(phys, fp, self.session.device)
            try:
                with planner.decisions_scope(decisions):
                    pr0 = planner.prune_counters()
                    t0 = time.monotonic()
                    out = runner(phys)
                # Only a success teaches: a quarantine retry's partial wall
                # would poison the arm.
                planner.observe(decisions, time.monotonic() - t0,
                                pruning=planner.prune_counters(pr0) if pr0 is not None else None,
                                stages=attribution.query_stage_walls())
                return out
            except CorruptIndexError as e:
                if not quarantine.mark(e.index_name, reason=str(e), path=e.path):
                    raise
                warnings.warn(
                    f"hyperspace: index '{e.index_name}' quarantined after a corrupt data file; the query "
                    f"falls back to the source scan and stays correct ({e}). Refresh or rebuild the index "
                    "to lift the quarantine.",
                    RuntimeWarning,
                    stacklevel=3,
                )

    def _attach_fingerprint(self, phys: PhysicalNode) -> Optional[str]:
        """The plan's fingerprint (`plananalysis.fingerprint`) on the ambient
        ledger and span, and returned; None, computed not at all, when no
        history store, ledger, span sink or learning planner would read it.
        Never fails the query."""
        from ..plananalysis import fingerprint, planner
        from ..telemetry import accounting, tracing

        try:
            if not fingerprint.fingerprint_wanted() and not (planner.planner_enabled() and planner.outcome_dir()):
                return None
            fp = fingerprint.plan_fingerprint(phys)
        except Exception:
            return None
        accounting.set_value("plan_fingerprint", fp)
        sp = tracing.current_span()
        if sp is not None:
            sp.set_attr("plan_fingerprint", fp)
        return fp

    def collect(self) -> Table:
        """Execute on the session's device; the result comes back to the host."""
        from .. import resilience
        from ..telemetry import accounting, tracing
        from ..telemetry.device_observatory import table_to_host

        with resilience.query_scope("query:collect"):
            with tracing.query_span("query:collect") as root:
                out = self._run_with_quarantine_fallback(
                    lambda phys: table_to_host(phys.execute(ExecContext(self.session)))
                )
                root.set_attr("rows_out", int(out.num_rows))
                accounting.set_value("rows_produced", int(out.num_rows))
                return out

    def count(self) -> int:
        from .. import resilience
        from ..telemetry import accounting, tracing

        with resilience.query_scope("query:count"):
            with tracing.query_span("query:count") as root:
                n = int(self._run_with_quarantine_fallback(lambda phys: phys.execute_count(ExecContext(self.session))))
                root.set_attr("rows_out", n)
                accounting.set_value("rows_produced", n)
                return n

    def to_pydict(self) -> Dict[str, list]:
        return self.collect().to_pydict()

    def sorted_rows(self):
        return self.collect().sorted_rows()

    def explain_string(self) -> str:
        return self.physical_plan().tree_string()

    def explain(self, analyze: bool = False, redirect=None):
        """The physical plan tree, returned, or passed to `redirect` (e.g.
        `print`) when one is given. `analyze=True` executes the query once
        under a trace and annotates the tree with what each node did
        (`plananalysis.analyze`)."""
        if analyze:
            from ..plananalysis.analyze import explain_analyze_string

            s = explain_analyze_string(self)
        else:
            s = self.explain_string()
        if redirect is not None:
            redirect(s)
            return None
        return s

    def show(self, n: int = 20, redirect=print) -> None:
        """The first `n` rows as Spark's formatted text (`session.show` :308)."""
        t = self.limit(n + 1).collect()
        names = t.column_names
        cells = [["null" if v is None else str(v) for v in t.column(c).decode_objects()[:n]] for c in names]
        widths = [max(len(name), *(len(x) for x in col)) if col else len(name) for name, col in zip(names, cells)]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

        def fmt(vals):
            return "|" + "|".join(f" {v:>{w}} " for v, w in zip(vals, widths)) + "|"

        lines = [sep, fmt(names), sep]
        lines += [fmt([col[i] for col in cells]) for i in range(min(n, t.num_rows))]
        lines.append(sep)
        if t.num_rows > n:
            lines.append(f"only showing top {n} row{'s' if n != 1 else ''}")
        redirect("\n".join(lines))


class GroupedDataFrame:
    """`df.group_by(keys)`: the aggregation builder (`session.GroupedDataFrame`
    :336) over sum, count, count_distinct, min, max and avg."""

    def __init__(self, df: DataFrame, keys: List[str]):
        self._df = df
        self._keys = keys

    def agg(self, **aggs) -> DataFrame:
        """`.agg(out_name=("column", "fn"), ...)`; `("*", "count")` is count(*)."""
        if not aggs:
            raise HyperspaceException("agg() requires at least one aggregate")
        triples = []
        for out_name, spec in aggs.items():
            if not (isinstance(spec, tuple) and len(spec) == 2):
                raise HyperspaceException(f"agg spec must be (column, fn): {out_name}={spec!r}")
            col, fn = spec
            triples.append((out_name, fn.lower(), None if col in ("*", None) else col))
        return DataFrame(self._df.session, AggregateNode(self._keys, triples, self._df.plan))

    def count(self) -> DataFrame:
        return self.agg(count=("*", "count"))

    def sum(self, *cols: str) -> DataFrame:
        return self.agg(**{f"sum({c})": (c, "sum") for c in cols})

    def min(self, *cols: str) -> DataFrame:
        return self.agg(**{f"min({c})": (c, "min") for c in cols})

    def max(self, *cols: str) -> DataFrame:
        return self.agg(**{f"max({c})": (c, "max") for c in cols})

    def avg(self, *cols: str) -> DataFrame:
        return self.agg(**{f"avg({c})": (c, "avg") for c in cols})


class DataFrameReader:
    def __init__(self, session: "HyperspaceSession"):
        self._session = session

    def parquet(self, *paths) -> DataFrame:
        return self._load(list(paths), "parquet")

    def csv(self, *paths) -> DataFrame:
        return self._load(list(paths), "csv")

    def json(self, *paths) -> DataFrame:
        return self._load(list(paths), "json")

    def orc(self, *paths) -> DataFrame:
        return self._load(list(paths), "orc")

    def view(self, name: str) -> DataFrame:
        """A view registered with `session.create_view`."""
        return self._session.view(name)

    def delta(self, path: str) -> DataFrame:
        """A snapshot read of a delta table (`session.py:442`): the files are
        the log's active set (`storage/delta.active_files`), never a listing
        of the directory, which still holds the files a `remove` dropped."""
        files = delta_log.active_files(path, self._session.fs)
        if not files:
            raise HyperspaceException(f"Delta table has no active files: {path}")
        schema = engine_io.infer_schema([f.path for f in files], "delta")
        rel = SourceRelation(
            root_paths=[os.path.abspath(path)], file_format="delta", schema=schema, files=files,
        )
        return DataFrame(self._session, ScanNode(rel))

    def _load(self, path_list: List[str], file_format: str) -> DataFrame:
        """A source over the files under `path_list` (`session._read` :383).
        Paths are made absolute (a URL-scheme path passes through), so the
        spelling of a root never changes the partition discovery; a Hive
        `key=value` layout appends its columns to the schema."""
        files: List[FileStatus] = []
        for p in path_list:
            files.extend(engine_io.list_data_files(p, file_format, self._session.fs))
        if not files:
            raise HyperspaceException(f"No {file_format} files found under {path_list}")
        schema = engine_io.infer_schema([f.path for f in files], file_format)
        roots = [_absolute(p) for p in path_list]
        files = [FileStatus(_absolute(f.path), f.size, f.modified_time, f.is_dir) for f in files]
        spec = discover(roots, [f.path for f in files])
        if spec is not None:
            clash = [c for c in spec.columns if c in schema]
            if clash:
                raise HyperspaceException(f"Partition column(s) also present in data files: {clash}")
            schema = Schema(list(schema.fields) + spec.fields)
        rel = SourceRelation(
            root_paths=roots, file_format=file_format, schema=schema, files=files, partition_spec=spec,
        )
        return DataFrame(self._session, ScanNode(rel))


_URL = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*://")


def _absolute(path: str) -> str:
    """An absolute local path; a URL-scheme path (s3://, memory://) as it is."""
    return path if _URL.match(path) else os.path.abspath(path)


class HyperspaceSession:
    """One session = conf + filesystem + device + optimizer rules + warehouse."""

    #: The last session made: where the history store lives by default
    #: (`telemetry.history.history_dir`).
    _active: Optional["HyperspaceSession"] = None

    def __init__(
        self,
        warehouse: str = ".",
        device=None,
        conf: Optional[SessionConf] = None,
        fs: Optional[FileSystem] = None,
    ):
        self.warehouse = warehouse
        self.device = resolve_device(device)
        self.conf = conf or SessionConf()
        self.hs_conf = HyperspaceConf(self.conf)
        self.fs = fs or LocalFileSystem()
        # Rule protocol: rule.apply(plan, session) -> plan.
        self.extra_optimizations: List = []
        self._views: Dict[str, LogicalPlan] = {}
        HyperspaceSession._active = self

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    def create_view(self, name: str, df: DataFrame, replace: bool = True) -> None:
        """Register `df`'s logical plan under `name` (`session.create_view`
        :569). Reading the view gives that plan, so the rules see straight
        through it. View names are case-insensitive whatever the conf says."""
        key = name.lower()
        if not replace and key in self._views:
            raise HyperspaceException(f"View already exists: {name}")
        self._views[key] = df.plan

    def drop_view(self, name: str) -> bool:
        return self._views.pop(name.lower(), None) is not None

    def view(self, name: str) -> DataFrame:
        plan = self._views.get(name.lower())
        if plan is None:
            raise HyperspaceException(f"View not found: {name}")
        return DataFrame(self, plan)

    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        """Filters sink below computed columns first, so that the rules meet
        `Filter > Scan` (`session.optimize` :593); then each rule runs."""
        from ..telemetry import tracing

        plan = push_filters_below_computed(plan)
        for rule in self.extra_optimizations:
            with tracing.span(f"rule:{type(rule).__name__}"):
                plan = rule.apply(plan, self)
        return plan

    def write_parquet(self, data, path: str, row_group_rows: Optional[int] = None) -> None:
        """Write a Table (or a dict of numpy arrays) as `path/part-00000.parquet`."""
        t = data if isinstance(data, Table) else Table.from_pydict(data, "cpu")
        engine_io.write_parquet(t, os.path.join(path, "part-00000.parquet"), row_group_rows)

    def write_orc(self, data, path: str) -> None:
        """Write a Table (or a dict of numpy arrays) as `path/part-00000.orc`."""
        t = data if isinstance(data, Table) else Table.from_pydict(data, "cpu")
        engine_io.write_orc(t, os.path.join(path, "part-00000.orc"))

    def write_csv(self, data, path: str) -> None:
        t = data if isinstance(data, Table) else Table.from_pydict(data, "cpu")
        engine_io.write_csv(t, os.path.join(path, "part-00000.csv"))

    def write_json(self, data, path: str) -> None:
        """Line-delimited JSON, one object a row."""
        t = data if isinstance(data, Table) else Table.from_pydict(data, "cpu")
        engine_io.write_json(t, os.path.join(path, "part-00000.json"))

    def write_delta(self, data, path: str, mode: str = "append") -> None:
        """Commit a Table (or a dict of numpy arrays) to the delta table at
        `path` as one new data file (mode "append" or "overwrite")."""
        t = data if isinstance(data, Table) else Table.from_pydict(data, "cpu")
        delta_log.write_delta(t, path, mode, self.fs)
