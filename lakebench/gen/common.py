"""What the generators share: one random stream per column, dates as days
since 1970-01-01, and the parquet writer.

Every column draws from a stream of its own (`stream(seed, "table.column")`),
so a column is made only when a configuration asks for it and a column added
later leaves the others as they were.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

#: A column: a numpy array, or a dictionary string column as (sorted
#: dictionary, int32 codes), so that dictionary order is value order.
Values = Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]


@dataclass
class Generated:
    """One table's columns and the row offsets at which its files start and
    end (`bounds[i]:bounds[i + 1]` is file i)."""

    columns: Dict[str, Values]
    bounds: List[int] = field(default_factory=list)

    @property
    def num_rows(self) -> int:
        v = next(iter(self.columns.values()))
        return len(v[1] if isinstance(v, tuple) else v)


def days(date: str) -> int:
    """A date as int32 days since 1970-01-01, the port's date columns."""
    return int(np.datetime64(date, "D").astype(np.int64))


def stream(seed: int, name: str) -> np.random.Generator:
    """The random stream of one column (`name` is "table.column") of one seed."""
    return np.random.default_rng([int(seed) % (1 << 64), zlib.crc32(name.encode())])


def decoded(v: Values) -> np.ndarray:
    """A column's values, a dictionary column's strings included."""
    return v[0][v[1]] if isinstance(v, tuple) else v


def even_bounds(rows: int, files: int) -> List[int]:
    return [int(x) for x in np.linspace(0, rows, max(1, files) + 1).round()]


def _arrow_array(v: Values):
    import pyarrow as pa

    if isinstance(v, tuple):
        return pa.DictionaryArray.from_arrays(pa.array(v[1], pa.int32()), pa.array(v[0], pa.string()))
    return pa.array(v)


def write_table(gen: Generated, directory: str, columns: List[str], row_group_rows: Optional[int] = None,
                threads: int = 8) -> List[str]:
    """`columns` of `gen` as `directory/part-<i>.parquet`, one file per
    bound, written by pyarrow on `threads` threads; the paths written."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(directory, exist_ok=True)
    bounds = gen.bounds or [0, gen.num_rows]

    def write(i: int) -> str:
        lo, hi = bounds[i], bounds[i + 1]
        part ={n: (gen.columns[n][0], gen.columns[n][1][lo:hi]) if isinstance(gen.columns[n], tuple)
                else gen.columns[n][lo:hi] for n in columns}
        table = pa.table({n: _arrow_array(v) for n, v in part.items()})
        path = os.path.join(directory, f"part-{i:05d}.parquet")
        pq.write_table(table, path, row_group_size=row_group_rows)
        return path

    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        return list(pool.map(write, range(len(bounds) - 1)))
