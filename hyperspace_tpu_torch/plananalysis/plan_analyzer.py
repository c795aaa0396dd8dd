"""The plan diff of `Hyperspace.explain` (counterpart of
`hyperspace_tpu/plananalysis/plan_analyzer.py`; reference
`PlanAnalyzer.scala:34-410`): the physical plan compiled with the rules on
and off (nothing executes), both trees with the subtrees that differ
highlighted, the indexes the plan uses and, verbose, a table of physical
operator counts. The text is the JAX package's, line for line."""

from __future__ import annotations

from typing import Set

from ..engine.physical import PhysicalNode
from ..engine.session import DataFrame, HyperspaceSession
from .buffer_stream import BufferStream
from .display_mode import create_display_mode
from .op_analyzer import compare_operators

_RULE = "============================================================="


def _subtree_strings(plan: PhysicalNode) -> Set[str]:
    return {n.tree_string() for n in plan.collect_nodes()}


def _write_plan(buffer: BufferStream, plan: PhysicalNode, other: PhysicalNode) -> None:
    """A plan's tree, each node whose subtree the other plan lacks highlighted
    (so a differing subtree is highlighted whole)."""
    other_subtrees = _subtree_strings(other)

    def walk(node: PhysicalNode, indent: int):
        line = node.format_line(indent)
        if node.tree_string() in other_subtrees:
            buffer.write_line(line)
        else:
            buffer.highlight_line(line)
        for c in node.children():
            walk(c, indent + 1)

    walk(plan, 0)


def _with_hyperspace_state(df: DataFrame, session: HyperspaceSession, enabled: bool) -> PhysicalNode:
    """The physical plan with the rules forced on or off, the session's state
    restored afterwards (reference `withHyperspaceState` :341-360)."""
    from ..hyperspace import disable_hyperspace, enable_hyperspace, is_hyperspace_enabled

    was_enabled = is_hyperspace_enabled(session)
    try:
        (enable_hyperspace if enabled else disable_hyperspace)(session)
        return df.physical_plan()
    finally:
        (enable_hyperspace if was_enabled else disable_hyperspace)(session)


def _section(buffer: BufferStream, title: str) -> None:
    buffer.write_line(_RULE)
    buffer.write_line(title)
    buffer.write_line(_RULE)


def explain_string(df: DataFrame, session: HyperspaceSession, indexes_table, verbose: bool = False) -> str:
    buffer = BufferStream(create_display_mode(session.conf))
    plan_with = _with_hyperspace_state(df, session, enabled=True)
    plan_without = _with_hyperspace_state(df, session, enabled=False)

    _section(buffer, "Plan with indexes:")
    _write_plan(buffer, plan_with, plan_without)
    buffer.write_line()
    _section(buffer, "Plan without indexes:")
    _write_plan(buffer, plan_without, plan_with)
    buffer.write_line()

    _section(buffer, "Indexes used:")
    used = {}
    for n in plan_with.collect_nodes():
        rel = getattr(n, "relation", None)
        if rel is not None and rel.index_name:
            used[rel.index_name] = rel.root_paths[0]
    idx = indexes_table.to_pydict()
    for name, location in sorted(used.items()):
        if name in idx.get("name", []):  # the registry's location, as the reference (:209-221)
            location = idx["indexLocation"][idx["name"].index(name)]
        buffer.write_line(f"{name}:{location}")
    buffer.write_line()

    if verbose:
        _section(buffer, "Physical operator stats:")
        comparisons = compare_operators(plan_without, plan_with)
        name_w = max([len("Physical Operator")] + [len(c.name) for c in comparisons]) + 2
        header = f"{'Physical Operator':<{name_w}}|{'Hyperspace Disabled':>21}|{'Hyperspace Enabled':>20}|{'Difference':>12}"
        buffer.write_line(header)
        buffer.write_line("-" * len(header))
        for c in comparisons:
            diff = c.num_occurrences_after - c.num_occurrences_before
            buffer.write_line(
                f"{c.name:<{name_w}}|{c.num_occurrences_before:>21}|{c.num_occurrences_after:>20}|{diff:>12}"
            )
    return buffer.to_string()
