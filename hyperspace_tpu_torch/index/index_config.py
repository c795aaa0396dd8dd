"""Index specification.

Parity: reference `index/IndexConfig.scala:28-175` — name + indexedColumns +
includedColumns; validates non-empty and no case-insensitive duplicates; case-insensitive
equality. Counterpart of `hyperspace_tpu/index/index_config.py` without its fluent
builder.
"""

from __future__ import annotations

from typing import List, Sequence

from ..exceptions import HyperspaceException


class IndexConfig:
    def __init__(
        self,
        index_name: str,
        indexed_columns: Sequence[str],
        included_columns: Sequence[str] = (),
    ):
        if not index_name or not index_name.strip():
            raise HyperspaceException("Index name cannot be empty.")
        if not indexed_columns:
            raise HyperspaceException("Indexed columns cannot be empty.")
        lower_indexed = [c.lower() for c in indexed_columns]
        lower_included = [c.lower() for c in included_columns]
        if len(set(lower_indexed)) != len(lower_indexed) or len(set(lower_included)) != len(
            lower_included
        ):
            raise HyperspaceException("Duplicate column names are not allowed.")
        if set(lower_indexed) & set(lower_included):
            raise HyperspaceException(
                "Duplicate column names in indexed/included columns are not allowed."
            )
        self.index_name = index_name
        self.indexed_columns: List[str] = list(indexed_columns)
        self.included_columns: List[str] = list(included_columns)

    def __eq__(self, other):
        if not isinstance(other, IndexConfig):
            return False
        return (
            self.index_name.lower() == other.index_name.lower()
            and [c.lower() for c in self.indexed_columns]
            == [c.lower() for c in other.indexed_columns]
            and sorted(c.lower() for c in self.included_columns)
            == sorted(c.lower() for c in other.included_columns)
        )

    def __hash__(self):
        return hash(
            (
                self.index_name.lower(),
                tuple(c.lower() for c in self.indexed_columns),
                tuple(sorted(c.lower() for c in self.included_columns)),
            )
        )

    def __repr__(self):
        return (
            f"IndexConfig({self.index_name!r}, indexed={self.indexed_columns}, "
            f"included={self.included_columns})"
        )
