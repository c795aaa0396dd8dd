"""Schema model for columnar tables (counterpart of `hyperspace_tpu/engine/schema.py`).

Type names and the JSON form are the JAX package's, so a schema written into
the operation log by one package reads the same in the other. A `string`
column holds int32 dictionary codes on the device (`engine/table.py`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

INT32 = "int32"
INT64 = "int64"
FLOAT32 = "float32"
FLOAT64 = "float64"
BOOL = "bool"
STRING = "string"

_NUMPY_TO_TYPE = {
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.float32): FLOAT32,
    np.dtype(np.float64): FLOAT64,
    np.dtype(np.bool_): BOOL,
}

TORCH_DTYPES = {
    INT32: torch.int32,
    INT64: torch.int64,
    FLOAT32: torch.float32,
    FLOAT64: torch.float64,
    BOOL: torch.bool,
    STRING: torch.int32,  # dictionary codes
}


def dtype_from_numpy(dt: np.dtype) -> str:
    if dt in _NUMPY_TO_TYPE:
        return _NUMPY_TO_TYPE[dt]
    if dt.kind in ("U", "O", "S"):
        return STRING
    raise ValueError(f"Unsupported numpy dtype: {dt}")


_TYPE_TO_NUMPY = {t: dt for dt, t in _NUMPY_TO_TYPE.items()}


def numpy_dtype(type_name: str) -> np.dtype:
    if type_name == STRING:
        raise ValueError("string columns are dictionary-encoded; no direct numpy dtype")
    return _TYPE_TO_NUMPY[type_name]


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str

    def to_json(self) -> dict:
        return {"name": self.name, "type": self.dtype}


@dataclass(frozen=True)
class Schema:
    fields: tuple

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        """Exact match first, then a unique case-insensitive match."""
        for f in self.fields:
            if f.name == name:
                return f
        ci = [f for f in self.fields if f.name.lower() == name.lower()]
        if len(ci) == 1:
            return ci[0]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        try:
            self.field(name)
            return True
        except KeyError:
            return False

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([self.field(n) for n in names])

    def to_json_string(self) -> str:
        return json.dumps({"fields": [f.to_json() for f in self.fields]})

    @staticmethod
    def from_json_string(s: str) -> "Schema":
        d = json.loads(s)
        return Schema([Field(f["name"], f["type"]) for f in d["fields"]])

    def __repr__(self):
        inner = ", ".join(f"{f.name}:{f.dtype}" for f in self.fields)
        return f"Schema({inner})"
