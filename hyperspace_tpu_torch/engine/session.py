"""Session + DataFrame API (counterpart of `hyperspace_tpu/engine/session.py`).

A session carries the conf, the filesystem, the device its tables live on and
the optimizer extension point (`extra_optimizations`) that `enable_hyperspace`
plugs the rewrite rules into. The device defaults to CUDA.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..config import HyperspaceConf, SessionConf
from ..exceptions import HyperspaceException, not_in_slice
from ..ops.backend import resolve_device
from ..storage.filesystem import FileStatus, LocalFileSystem
from . import io as engine_io
from .expr import Expr
from .logical import FilterNode, JoinNode, LogicalPlan, ProjectNode, ScanNode, SourceRelation
from .physical import ExecContext, PhysicalNode, plan_physical
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

    def group_by(self, *keys: str):
        raise not_in_slice("aggregation")

    groupBy = group_by

    def agg(self, **aggs):
        raise not_in_slice("aggregation")

    def with_column(self, name: str, expr: Expr):
        raise not_in_slice("computed columns")

    def order_by(self, *keys, ascending: bool = True):
        raise not_in_slice("order by")

    def limit(self, n: int):
        raise not_in_slice("limit")

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

    def collect(self) -> Table:
        """Execute on the session's device; the result comes back to the host."""
        return self.physical_plan().execute(ExecContext(self.session)).to("cpu")

    def count(self) -> int:
        return int(self.physical_plan().execute_count(ExecContext(self.session)))

    def explain_string(self) -> str:
        return self.physical_plan().tree_string()


class DataFrameReader:
    def __init__(self, session: "HyperspaceSession"):
        self._session = session

    def parquet(self, *paths) -> DataFrame:
        path_list = list(paths)
        files: List[FileStatus] = []
        for p in path_list:
            files.extend(engine_io.list_data_files(p, "parquet", self._session.fs))
        if not files:
            raise HyperspaceException(f"No parquet files found under {path_list}")
        schema = engine_io.infer_schema([f.path for f in files], "parquet")
        files = [
            FileStatus(os.path.abspath(f.path), f.size, f.modified_time, f.is_dir) for f in files
        ]
        rel = SourceRelation(
            root_paths=[os.path.abspath(p) for p in path_list],
            file_format="parquet",
            schema=schema,
            files=files,
        )
        return DataFrame(self._session, ScanNode(rel))


class HyperspaceSession:
    """One session = conf + filesystem + device + optimizer rules + warehouse."""

    def __init__(
        self,
        warehouse: str = ".",
        device=None,
        conf: Optional[SessionConf] = None,
        fs: Optional[LocalFileSystem] = None,
    ):
        self.warehouse = warehouse
        self.device = resolve_device(device)
        self.conf = conf or SessionConf()
        self.hs_conf = HyperspaceConf(self.conf)
        self.fs = fs or LocalFileSystem()
        # Rule protocol: rule.apply(plan, session) -> plan.
        self.extra_optimizations: List = []

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        for rule in self.extra_optimizations:
            plan = rule.apply(plan, self)
        return plan

    def write_parquet(self, data, path: str, row_group_rows: Optional[int] = None) -> None:
        """Write a Table (or a dict of numpy arrays) as `path/part-00000.parquet`."""
        t = data if isinstance(data, Table) else Table.from_pydict(data, "cpu")
        engine_io.write_parquet(t, os.path.join(path, "part-00000.parquet"), row_group_rows)
