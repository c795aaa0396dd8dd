"""The one traffic generator: a mix file's streams and the parameters of
each query they send, drawn from the seed.

A mix (`mixes/<name>.json`) lists `queries`, each a query module's name, the
indexes its plan must scan and its `params`, each parameter's values given
as `{"choice": [...]}`, `{"int_between": [lo, hi]}` or
`{"date_between": ["YYYY-MM-DD", "YYYY-MM-DD"]}` (both ends in; a date as int
days since 1970-01-01). Stream s sends `queries[(s + k) % n]` as its k-th
query, so the streams alternate the queries and start apart.

Each query's parameters come from a deck: every combination of its
parameters' values, shuffled by the seed and dealt in turn, each stream
starting at its own place in it. So every seed sends the same combinations,
each about as often, in another order: the seed changes the order of the
work, not the work.
"""

from __future__ import annotations

import zlib
from typing import Iterator, List, Tuple

import numpy as np

from .gen.common import days

#: The most parameter combinations a deck holds.
MAX_DECK = 10_000_000


def values(spec: dict) -> list:
    """Every value one parameter can take, in order."""
    if "choice" in spec:
        return list(spec["choice"])
    if "int_between" in spec:
        lo, hi = spec["int_between"]
        return list(range(int(lo), int(hi) + 1))
    if "date_between" in spec:
        lo, hi = (days(d) for d in spec["date_between"])
        return list(range(lo, hi + 1))
    raise ValueError(f"unknown parameter values {spec}")


def _rng(seed: int, purpose: str, query: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), zlib.crc32(purpose.encode()), zlib.crc32(query.encode())])


class _Deck:
    """One query's shuffled parameter combinations."""

    def __init__(self, entry: dict, seed: int, purpose: str):
        self.names = sorted(entry["params"])
        self.values: List[list] = [values(entry["params"][n]) for n in self.names]
        self.size = int(np.prod([len(v) for v in self.values], dtype=np.int64))
        if not 0 < self.size <= MAX_DECK:
            raise ValueError(f"{entry['query']}: {self.size} parameter combinations; a deck holds 1..{MAX_DECK}")
        self.order = _rng(seed, purpose, entry["query"]).permutation(self.size)

    def card(self, i: int) -> dict:
        """The i-th combination dealt (the deck repeats)."""
        code = int(self.order[i % self.size])
        out = {}
        for name, vals in zip(reversed(self.names), reversed(self.values)):
            code, r = divmod(code, len(vals))
            out[name] = vals[r]
        return dict(sorted(out.items()))


def stream_queries(mix: dict, seed: int, stream: int, purpose: str = "window") -> Iterator[Tuple[dict, dict]]:
    """Stream `stream`'s queries in order: (the mix's query entry, its
    parameters). `purpose` separates the warm-up's deck from the window's."""
    queries, streams = mix["queries"], int(mix["streams"])
    decks = [_Deck(q, seed, purpose) for q in queries]
    dealt = [stream * d.size // streams for d in decks]
    k = 0
    while True:
        i = (stream + k) % len(queries)
        yield queries[i], decks[i].card(dealt[i])
        dealt[i] += 1
        k += 1


def param_key(query: str, params: dict) -> tuple:
    return (query,) + tuple(sorted(params.items()))
