"""Columnar in-memory table whose columns are torch tensors on one device.

Counterpart of `hyperspace_tpu/engine/table.py`. The JAX package keeps numpy
on the host and uploads to the device per operation; here the columns live on
the session's device from the read on, and only a query's result crosses back
to the host (`Table.to("cpu")`). The representation is the JAX package's:

- **Strings are dictionary-encoded** with a *sorted* host dictionary, so the
  int32 codes on the device are order-preserving: string range filters are
  integer compares and the build's sort by a string is an integer sort.
- **Nulls ride as validity masks** (a bool tensor, True = valid) over dense
  filled storage (numeric fill 0, string fill code 0). `validity=None` means
  all-valid; an all-True mask is normalized to None, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..ops.backend import resolve_device
from .schema import STRING, TORCH_DTYPES, Field, Schema, dtype_from_numpy


@dataclass
class Column:
    """One column: numeric data, or dictionary codes (`data`, int32) into a
    sorted host `dictionary`, plus an optional validity mask on the same
    device as `data`. `encoded_read` marks codes that came through the
    encoded (dictionary-page) read; it survives take and concat."""

    dtype: str
    data: torch.Tensor
    dictionary: Optional[np.ndarray] = None
    validity: Optional[torch.Tensor] = None
    encoded_read: bool = field(default=False, compare=False)

    def __post_init__(self):
        if TORCH_DTYPES[self.dtype] != self.data.dtype:
            raise ValueError(f"column type {self.dtype} holds {self.data.dtype}")
        if (self.dtype == STRING) != (self.dictionary is not None):
            raise ValueError("a string column needs a dictionary, and only a string column has one")
        if self.validity is not None:
            if self.validity.dtype != torch.bool:
                raise ValueError(f"validity must be bool, got {self.validity.dtype}")
            if bool(self.validity.all()):
                self.validity = None  # normalize: all-valid keeps the fast paths

    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def is_string(self) -> bool:
        return self.dtype == STRING

    @property
    def has_nulls(self) -> bool:
        return self.validity is not None

    def _derive(self, data, validity) -> "Column":
        return Column(self.dtype, data, self.dictionary, validity, self.encoded_read)

    def take(self, indices: torch.Tensor) -> "Column":
        v = self.validity[indices] if self.validity is not None else None
        return self._derive(self.data[indices], v)

    def slice(self, lo: int, hi: int) -> "Column":
        v = self.validity[lo:hi] if self.validity is not None else None
        return self._derive(self.data[lo:hi], v)

    def to(self, device) -> "Column":
        v = self.validity.to(device) if self.validity is not None else None
        return self._derive(self.data.to(device), v)

    def numpy(self) -> np.ndarray:
        """`data` on the host (codes for a string column, fills at nulls)."""
        return self.data.cpu().numpy()

    def decode(self) -> np.ndarray:
        """Raw host values (strings decoded through the dictionary). Null slots
        hold the fill value: pair with `validity`, or use `decode_objects`."""
        data = self.numpy()
        return self.dictionary[data] if self.is_string else data

    def decode_objects(self) -> np.ndarray:
        """User-facing host values: an object array with None at null slots
        (the plain `decode()` array when the column has no nulls)."""
        raw = self.decode()
        if self.validity is None:
            return raw
        out = raw.astype(object)
        out[~self.validity.cpu().numpy()] = None
        return out

    @staticmethod
    def from_values(values: np.ndarray, device) -> "Column":
        """Ingest a host numpy array: strings get dictionary-encoded with a
        sorted dictionary; None entries of object arrays become nulls
        (validity mask + fill), as `Column.from_values` in the JAX package."""
        values = np.asarray(values)
        validity = None
        if values.dtype.kind == "O":
            null_mask = np.asarray([v is None for v in values], dtype=bool)
            if null_mask.any():
                validity = ~null_mask
                fill = next((v for v in values if v is not None), "")
                values = np.asarray([fill if v is None else v for v in values])
            else:
                values = np.asarray(values.tolist())
            if values.dtype.kind == "O":
                values = values.astype(str)
        valid_t = None if validity is None else torch.from_numpy(validity).to(device)
        if values.dtype.kind in ("U", "S"):
            dictionary, codes = np.unique(values, return_inverse=True)
            codes = codes.astype(np.int32).reshape(-1)
            if validity is not None:
                codes = np.where(validity, codes, np.int32(0))
            return Column(STRING, torch.from_numpy(codes).to(device), dictionary, valid_t)
        if validity is not None:
            values = np.where(validity, values, np.zeros((), dtype=values.dtype))
        if not values.flags.writeable or not values.flags.c_contiguous:
            values = np.array(values)
        return Column(dtype_from_numpy(values.dtype), torch.from_numpy(values).to(device), None, valid_t)


def _remap_codes(col: Column, new_dictionary: np.ndarray) -> torch.Tensor:
    """A string column's codes remapped into a (sorted) superset dictionary."""
    positions = torch.from_numpy(np.searchsorted(new_dictionary, col.dictionary).astype(np.int32))
    return positions.to(col.data.device)[col.data.long()]


def align_dictionaries(a: Column, b: Column):
    """Two string columns re-encoded over their union dictionary so their codes
    compare directly; untouched when both already share one dictionary."""
    if not (a.is_string and b.is_string):
        raise ValueError("align_dictionaries requires string columns")
    if a.dictionary is b.dictionary or np.array_equal(a.dictionary, b.dictionary):
        return a, b
    union = np.union1d(a.dictionary, b.dictionary)
    return (
        Column(STRING, _remap_codes(a, union), union, a.validity),
        Column(STRING, _remap_codes(b, union), union, b.validity),
    )


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
        return Table({n: c.slice(lo, hi) for n, c in self.columns.items()})

    def to(self, device) -> "Table":
        return Table({n: c.to(device) for n, c in self.columns.items()})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Host values per column: strings decoded, None at null slots."""
        return {n: c.decode_objects() for n, c in self.columns.items()}

    def to_pydict(self) -> Dict[str, list]:
        return {n: c.decode_objects().tolist() for n, c in self.columns.items()}

    def rows(self) -> List[tuple]:
        decoded = [c.decode_objects() for c in self.columns.values()]
        return [tuple(col[i] for col in decoded) for i in range(self.num_rows)]

    def sorted_rows(self) -> List[tuple]:
        """Rows in a canonical order, for comparing results (`table.sorted_rows`
        :199): sorted by each value's string form."""
        return sorted(self.rows(), key=lambda r: tuple(str(x) for x in r))

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self.columns.items()})

    @staticmethod
    def from_pydict(data: Dict[str, list], device=None) -> "Table":
        """A table of `data` on `device`; None means the active session's
        device, else CUDA (which raises without a card: nothing falls back
        to the CPU)."""
        if device is None:
            from .session import HyperspaceSession

            try:
                device = HyperspaceSession.active().device
            except HyperspaceException:
                device = resolve_device(None)
        return Table({n: Column.from_values(np.asarray(v), device) for n, v in data.items()})

    @staticmethod
    def concat(tables: List["Table"]) -> "Table":
        """Concatenate tables with the same column names (multi-file scans).
        String columns are re-encoded over the union dictionary."""
        if not tables:
            return Table({})
        out: Dict[str, Column] = {}
        for n in tables[0].column_names:
            cols = [t.columns[n] for t in tables]
            validity = None
            if any(c.validity is not None for c in cols):
                validity = torch.cat([
                    c.validity if c.validity is not None
                    else torch.ones(len(c), dtype=torch.bool, device=c.data.device)
                    for c in cols
                ])
            encoded = all(c.encoded_read for c in cols)
            if cols[0].is_string and all(c.dictionary is cols[0].dictionary for c in cols):
                # One dictionary object (a column taken apart and put back,
                # as an outer join's assembly does): the union is itself, so
                # the codes stand and nothing is sorted.
                out[n] = Column(STRING, torch.cat([c.data for c in cols]), cols[0].dictionary, validity, encoded)
            elif cols[0].is_string:
                # One sort of all dictionaries: what folding `np.union1d` over
                # them gives, without a sort of the growing union per table.
                union = np.unique(np.concatenate([c.dictionary for c in cols]))
                codes = torch.cat([_remap_codes(c, union) for c in cols])
                out[n] = Column(STRING, codes, union, validity, encoded)
            else:
                # Mixed numeric widths promote in the concatenation; the type
                # label describes the promoted data.
                data = torch.cat([c.data for c in cols])
                out[n] = Column(_dtype_of(data), data, None, validity, encoded)
        return Table(out)

    def __repr__(self):
        return f"Table({self.schema}, rows={self.num_rows})"


def _dtype_of(data: torch.Tensor) -> str:
    return next(k for k, v in TORCH_DTYPES.items() if v == data.dtype and k != STRING)
