"""Columnar in-memory table whose columns are torch tensors on one device.

Counterpart of `hyperspace_tpu/engine/table.py` for numeric columns. The JAX
package keeps numpy on the host and uploads to the device per operation; here
the columns live on the session's device from the read on, and only a query's
result crosses back to the host (`Table.to("cpu")`). Strings (dictionary
codes) and nulls (validity masks) are not ported yet: building such a column
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..exceptions import not_in_slice
from .schema import STRING, TORCH_DTYPES, Field, Schema, dtype_from_numpy


@dataclass
class Column:
    """One numeric column: `dtype` names the schema type of `data`."""

    dtype: str
    data: torch.Tensor

    def __post_init__(self):
        if self.dtype == STRING:
            raise not_in_slice("string columns")
        if TORCH_DTYPES[self.dtype] != self.data.dtype:
            raise ValueError(f"column type {self.dtype} holds {self.data.dtype}")

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def take(self, indices: torch.Tensor) -> "Column":
        return Column(self.dtype, self.data[indices])

    def numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    @staticmethod
    def from_numpy(values: np.ndarray, device) -> "Column":
        values = np.asarray(values)
        if values.dtype.kind in ("U", "S", "O"):
            raise not_in_slice("string columns")
        dtype = dtype_from_numpy(values.dtype)
        if not values.flags.writeable or not values.flags.c_contiguous:
            values = np.array(values)
        return Column(dtype, torch.from_numpy(values).to(device))


class Table:
    """Ordered name → Column mapping with equal lengths."""

    def __init__(self, columns: Dict[str, Column]):
        lengths = {len(c) for c in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in columns.items()} }")
        self.columns: Dict[str, Column] = dict(columns)
        self.num_rows: int = lengths.pop() if lengths else 0

    @property
    def schema(self) -> Schema:
        return Schema([Field(n, c.dtype) for n, c in self.columns.items()])

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    def _resolve(self, name: str) -> str:
        if name in self.columns:
            return name
        ci = [n for n in self.columns if n.lower() == name.lower()]
        if len(ci) == 1:
            return ci[0]
        raise KeyError(name)

    def column(self, name: str) -> Column:
        return self.columns[self._resolve(name)]

    def select(self, names: Sequence[str]) -> "Table":
        # Output columns keep the requested spelling (Spark's output naming).
        return Table({n: self.columns[self._resolve(n)] for n in names})

    def take(self, indices: torch.Tensor) -> "Table":
        return Table({n: c.take(indices) for n, c in self.columns.items()})

    def slice(self, lo: int, hi: int) -> "Table":
        """Rows [lo, hi) as views of this table's columns."""
        return Table({n: Column(c.dtype, c.data[lo:hi]) for n, c in self.columns.items()})

    def to(self, device) -> "Table":
        return Table({n: Column(c.dtype, c.data.to(device)) for n, c in self.columns.items()})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {n: c.numpy() for n, c in self.columns.items()}

    @staticmethod
    def from_pydict(data: Dict[str, list], device) -> "Table":
        return Table({n: Column.from_numpy(np.asarray(v), device) for n, v in data.items()})

    def __repr__(self):
        return f"Table({self.schema}, rows={self.num_rows})"
