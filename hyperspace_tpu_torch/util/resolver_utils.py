"""Column-name resolution honoring case sensitivity (reference
`util/ResolverUtils.scala:26-74`): returns the *available* spelling on match."""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence


def resolve(requested: str, available: Iterable[str], case_sensitive: bool = False) -> Optional[str]:
    for a in available:
        if requested == a if case_sensitive else requested.lower() == a.lower():
            return a
    return None


def resolve_all(
    requested: Sequence[str], available: Iterable[str], case_sensitive: bool = False
) -> Optional[List[str]]:
    """Resolve all requested names; None if any fails to resolve."""
    avail = list(available)
    out: List[str] = []
    for r in requested:
        m = resolve(r, avail, case_sensitive)
        if m is None:
            return None
        out.append(m)
    return out


def resolution_key(name: str, case_sensitive: bool = False) -> str:
    """The canonical comparison key of one column name under the conf."""
    return name if case_sensitive else name.lower()
