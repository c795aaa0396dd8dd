"""The columnar query engine of the port: tables of torch tensors on the
session's device, a logical/physical plan pair, and the DataFrame API."""

from .expr import BinaryOp, Col, Expr, IsIn, Lit, Not, Udf, col, lit, udf  # noqa: F401
from .logical import (  # noqa: F401
    BucketSpec,
    FilterNode,
    JoinNode,
    LogicalPlan,
    ProjectNode,
    ScanNode,
    SourceRelation,
)
from .schema import Field, Schema  # noqa: F401
from .session import DataFrame, DataFrameReader, HyperspaceSession  # noqa: F401
from .table import Column, Table  # noqa: F401
