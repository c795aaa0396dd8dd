"""JoinIndexRule: rewrite equi-joins to co-bucketed, shuffle-free index joins.

Parity: reference `index/rules/JoinIndexRule.scala:54-564`, via
`hyperspace_tpu/rules/join_index_rule.py` `JoinIndexRule.apply` :405:
- applicability: the condition is equi-join CNF (`EqualTo`/`And` only), both
  subplans are linear with a single base relation, and the condition columns
  map left ↔ right one to one;
- per side, a usable index has indexed columns set-equal to the side's join
  columns and covers every column of the side the query references;
- a compatible pair lists its indexed columns in the same order under the key
  mapping, so bucket b of the left index holds exactly the keys bucket b of
  the right one holds;
- the best-ranked pair substitutes both relations by bucketed index scans,
  each under the lineage prune filter when its index has folded deletes or,
  under Hybrid Scan, vanished source files (:499-525); the filter keeps the
  buckets, so the join stays co-bucketed;
- Hybrid Scan (`hyperspace.index.hybridscan.enabled`): a side whose source
  gained files since the index was built carries them on its relation
  (`HybridAppend`, :469-490); the scan bucketizes their rows by the index's
  own hash and merges them into its buckets, so the index data moves through
  no exchange.
Any exception returns the original plan.

After the binary rewrite the rule recognizes a star join (`_wrap_star`,
`_try_star` :220-400): a left-deep chain of two or more inner equi-joins of
one fact with dimensions, each dimension a relation under row filters with a
covering bucketed index on exactly its keys, the keys of each join exclusive
to the fact and that dimension, and each key pair of one hash kind. The
chain is wrapped in a `StarJoinNode` that keeps the cascade as its child;
the physical planner makes it a `MultiwayJoinExec`. A dimension whose source
gained files carries them as a `HybridAppend`, and one with deleted files
the lineage prune filter, as the binary rewrite does. `HYPERSPACE_MULTIWAY=0`
turns recognition off (:555-562).

Each matched join records its decision (`record_rule_decision`), an applied
rewrite or a recognized star also a `HyperspaceIndexUsageEvent`; a failure
goes to `log_rule_failure`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..engine.expr import extract_equi_join_keys
from ..engine.logical import (
    AggregateNode,
    FilterNode,
    HybridAppend,
    JoinNode,
    LogicalPlan,
    OrderByNode,
    ProjectNode,
    ScanNode,
    StarDimension,
    StarJoinNode,
    WithColumnNode,
    find_single_relation,
)
from ..engine.streaming import multiway_enabled
from ..util.resolver_utils import resolution_key
from ..telemetry.event_logging import log_event
from ..telemetry.events import HyperspaceIndexUsageEvent
from .rule_utils import (
    _index_relation,
    get_candidate_indexes,
    lineage_prune_condition,
    log_rule_failure,
    record_rule_decision,
)


def _nkey(name: str, cs: bool) -> str:
    return resolution_key(name, cs)


def _norm(names, cs: bool) -> List[str]:
    return [_nkey(n, cs) for n in names]


def _collect_expr_refs(plan: LogicalPlan) -> List[str]:
    refs: List[str] = []
    for node in plan.collect_nodes():
        if isinstance(node, ProjectNode):
            refs.extend(node.column_names)
        elif isinstance(node, (FilterNode, JoinNode)):
            refs.extend(node.condition.references())
        elif isinstance(node, (AggregateNode, OrderByNode, WithColumnNode)):
            refs.extend(node.references())
    return refs


def _orient_pairs(
    pairs: List[Tuple[str, str]], lschema_names: List[str], rschema_names: List[str], cs: bool = False
) -> Optional[List[Tuple[str, str]]]:
    """Orient each (a, b) pair as (left_col, right_col); None if any column is
    ambiguous or unresolvable (reference :287-326)."""
    lset, rset = set(_norm(lschema_names, cs)), set(_norm(rschema_names, cs))
    out = []
    for a, b in pairs:
        al, bl = _nkey(a, cs), _nkey(b, cs)
        a_in_l, a_in_r = al in lset, al in rset
        b_in_l, b_in_r = bl in lset, bl in rset
        if a_in_l and b_in_r and not (a_in_r or b_in_l):
            out.append((a, b))
        elif a_in_r and b_in_l and not (a_in_l or b_in_r):
            out.append((b, a))
        else:
            return None
    return out


def _one_to_one(oriented: List[Tuple[str, str]], cs: bool = False) -> Optional[Dict[str, str]]:
    """Exclusive one-to-one L→R column mapping (reference :287-326)."""
    fwd: Dict[str, str] = {}
    bwd: Dict[str, str] = {}
    for l, r in oriented:
        ll, rl = _nkey(l, cs), _nkey(r, cs)
        if fwd.get(ll, rl) != rl or bwd.get(rl, ll) != ll:
            return None
        fwd[ll] = rl
        bwd[rl] = ll
    return fwd


def _usable_indexes(candidates, join_cols: List[str], required_cols: List[str], cs: bool = False):
    """indexedCols set-equal to the join cols AND required ⊆ index cols (:481-493)."""
    out = []
    jset = set(_norm(join_cols, cs))
    rset = set(_norm(required_cols, cs))
    for c in candidates:
        e = c.entry
        if set(_norm(e.indexed_columns, cs)) == jset and rset <= set(
            _norm(e.indexed_columns + e.included_columns, cs)
        ):
            out.append(c)
    return out


def _compatible_pairs(l_candidates, r_candidates, l_to_r: Dict[str, str], cs: bool = False):
    """Pairs listing indexed columns in the same order under the mapping (:516-563)."""
    out = []
    for lc in l_candidates:
        mapped = [l_to_r[c] for c in _norm(lc.entry.indexed_columns, cs)]
        for rc in r_candidates:
            if _norm(rc.entry.indexed_columns, cs) == [_nkey(m, cs) for m in mapped]:
                out.append((lc, rc))
    return out


def rank_join_pairs(pairs):
    """JoinIndexRanker: exact-match pairs first (source drift, appended files
    to merge and deleted ones to prune, costs work per query), then
    equal-bucket pairs, then higher bucket counts (reference
    `rankers/JoinIndexRanker.scala:40-55`; JAX :135-154)."""

    def key(p):
        lc, rc = p
        li, ri = lc.entry, rc.entry
        return (
            len(lc.appended) + len(rc.appended) + len(lc.deleted) + len(rc.deleted),
            0 if li.num_buckets == ri.num_buckets else 1,
            -(li.num_buckets + ri.num_buckets),
        )

    return sorted(pairs, key=key)


def _rank_single(cands):
    """A star dimension's covering indexes ranked as `rank_join_pairs` ranks
    pairs, on one side: exact-match indexes first (no appended files to
    merge, no deleted ones to prune), then more buckets (:165)."""
    return sorted(cands, key=lambda c: (len(c.appended) + len(c.deleted), -c.entry.num_buckets))


def _only_scan_filter(plan: LogicalPlan) -> bool:
    """A star side is a relation under row filters only: filters keep each
    row's identity, so the side's table is the one the cascade sees (:174)."""
    return all(isinstance(n, (FilterNode, ScanNode)) for n in plan.collect_nodes())


_KIND = {"float32": "f", "float64": "f", "string": "s"}


def _key_kind(schema, name: str, cs: bool) -> Optional[str]:
    """The hash kind ("i", "f" or "s") of one join key: the index hashed each
    column in its own kind, so a fact key must hash in the dimension key's
    kind to land in the dimension's buckets (:189)."""
    for f in schema.fields:
        if _nkey(f.name, cs) == _nkey(name, cs):
            return _KIND.get(f.dtype, "i")
    return None


def _wrap_star(plan: LogicalPlan, root_refs, hybrid: bool, index_manager, cs: bool, session=None) -> LogicalPlan:
    """The plan with the join chain under its single-child spine wrapped in
    a `StarJoinNode` when the chain is a star; untouched otherwise (:201)."""
    spine: List[LogicalPlan] = []
    node = plan
    while not isinstance(node, JoinNode):
        kids = node.children()
        if len(kids) != 1:
            return plan
        spine.append(node)
        node = kids[0]
    star = _try_star(node, root_refs, hybrid, index_manager, cs)
    if star is None:
        return plan
    names = [d.index_name for d in star.dims]
    record_rule_decision("JoinIndexRule", True, star_dims=len(star.dims), indexes=names,
                         buckets=[d.num_buckets for d in star.dims])
    log_event(session, HyperspaceIndexUsageEvent(
        index_names=names, plan_before=node.tree_string(), plan_after=star.tree_string(),
        message="Multiway star-join recognized.",
    ))
    out: LogicalPlan = star
    for op in reversed(spine):
        out = op.with_children([out])
    return out


def _try_star(top: JoinNode, root_refs, hybrid: bool, index_manager, cs: bool):
    """A `StarJoinNode` over the left-deep inner equi-join chain under `top`,
    or None when the shape or the coverage does not hold (:222): two or more
    inner joins; the fact and each dimension a relation under row filters;
    each join's keys exclusive to the fact and that dimension across the
    whole star; one hash kind per key pair; and each dimension covered by a
    bucketed index on exactly its keys (the innermost one may already be an
    index scan of the binary rewrite, kept when it covers)."""
    chain: List[JoinNode] = []
    cur: LogicalPlan = top
    while isinstance(cur, JoinNode):
        if cur.how != "inner":
            return None
        chain.append(cur)
        cur = cur.left
    if len(chain) < 2:
        return None
    fact_scan = find_single_relation(cur)
    if fact_scan is None or not _only_scan_filter(cur):
        return None
    fact_names = fact_scan.output_schema.names
    fact_set = set(_norm(fact_names, cs))

    # Innermost join first: the cascade's fold order, which fixes the
    # output's column naming (collision suffixes) and the dimensions' order.
    dims_raw = []
    for join in reversed(chain):
        dscan = find_single_relation(join.right)
        if dscan is None or not _only_scan_filter(join.right):
            return None
        dims_raw.append((join, dscan))
    dim_name_sets = [set(_norm(d.output_schema.names, cs)) for _, d in dims_raw]

    dims: List[StarDimension] = []
    for i, (join, dscan) in enumerate(dims_raw):
        pairs = extract_equi_join_keys(join.condition)
        if not pairs:
            return None
        dnames = dscan.output_schema.names
        oriented = _orient_pairs(pairs, fact_names, dnames, cs)
        if oriented is None:
            return None
        f_to_d = _one_to_one(oriented, cs)
        if f_to_d is None:
            return None
        fkeys = list(dict.fromkeys(f for f, _ in oriented))
        dkeys = [f_to_d[_nkey(k, cs)] for k in fkeys]
        # A fact key named in a dimension, or a dimension key named in the
        # fact or another dimension, resolves otherwise (or suffixed) in the
        # cascade: such a star stays there.
        if any(_nkey(k, cs) in s for k in fkeys for s in dim_name_sets):
            return None
        for k in dkeys:
            nk = _nkey(k, cs)
            if nk in fact_set or any(nk in s for j, s in enumerate(dim_name_sets) if j != i):
                return None
        for fk, dk in zip(fkeys, dkeys):
            if _key_kind(fact_scan.output_schema, fk, cs) != _key_kind(dscan.output_schema, dk, cs):
                return None
        dim_required = list(dict.fromkeys(
            [n for n in dnames if _nkey(n, cs) in root_refs or _nkey(n + "_r", cs) in root_refs] + dkeys
        ))

        rel = dscan.relation
        if rel.index_name:
            # The binary rewrite's index scan (the innermost join): kept when
            # bucketed on exactly this dimension's keys and covering.
            spec = rel.bucket_spec
            if spec is None or set(_norm(list(spec.bucket_columns), cs)) != set(_norm(dkeys, cs)):
                return None
            if not set(_norm(dim_required, cs)) <= set(_norm(rel.schema.names, cs)):
                return None
            dim_plan: LogicalPlan = join.right
            index_name, num_buckets = rel.index_name, spec.num_buckets
        else:
            cands = get_candidate_indexes(index_manager, dscan, hybrid, rule_name="JoinIndexRule")
            usable = _usable_indexes(cands, dkeys, dim_required, cs)
            if not usable:
                return None
            cand = _rank_single(usable)[0]
            new_rel = _index_relation(cand.entry, with_bucket_spec=True)
            if cand.appended:
                src = dscan.relation
                new_rel.hybrid_append = HybridAppend(
                    files=cand.appended, file_format=src.file_format, schema=src.schema,
                    root_paths=list(src.root_paths), partition_spec=src.partition_spec,
                )

            def replace(n, _scan=dscan, _rel=new_rel, _deleted=cand.deleted):
                if n is _scan or (isinstance(n, ScanNode) and n.relation is _scan.relation):
                    new_scan: LogicalPlan = ScanNode(_rel)
                    if _deleted:
                        new_scan = FilterNode(lineage_prune_condition(_deleted), new_scan)
                    return new_scan
                return n

            dim_plan = join.right.transform_up(replace)
            index_name, num_buckets = cand.entry.name, cand.entry.num_buckets
        dims.append(StarDimension(dim_plan, fkeys, dkeys, dim_required, index_name, num_buckets))

    fact_required = list(dict.fromkeys(
        [n for n in fact_names if _nkey(n, cs) in root_refs] + [k for d in dims for k in d.fact_keys]
    ))
    return StarJoinNode(top, dims, fact_required)


class JoinIndexRule:
    """Rule protocol: apply(plan, session) -> plan."""

    def apply(self, plan: LogicalPlan, session) -> LogicalPlan:
        from ..hyperspace import _index_manager_for

        try:
            index_manager = _index_manager_for(session)
            cs = session.hs_conf.case_sensitive
            hybrid = session.hs_conf.hybrid_scan_enabled
            root_refs = set(_norm(plan.output_schema.names, cs) + _norm(_collect_expr_refs(plan), cs))

            def rewrite(node: LogicalPlan) -> LogicalPlan:
                if not isinstance(node, JoinNode):
                    return node
                pairs = extract_equi_join_keys(node.condition)
                if not pairs:
                    return node
                l_scan = find_single_relation(node.left)
                r_scan = find_single_relation(node.right)
                if l_scan is None or r_scan is None:
                    return node
                if l_scan.relation.index_name or r_scan.relation.index_name:
                    return node  # already rewritten
                lnames = l_scan.output_schema.names
                rnames = r_scan.output_schema.names
                oriented = _orient_pairs(pairs, lnames, rnames, cs)
                if oriented is None:
                    record_rule_decision("JoinIndexRule", False, reason="unresolvable-join-columns")
                    return node
                l_to_r = _one_to_one(oriented, cs)
                if l_to_r is None:
                    record_rule_decision("JoinIndexRule", False, reason="not-one-to-one-keys")
                    return node
                lkeys = list(dict.fromkeys(l for l, _ in oriented))
                rkeys = [l_to_r[_nkey(k, cs)] for k in lkeys]
                # Required = every column of this side the whole query
                # references + this join's keys (reference :407-418).
                l_required = list(dict.fromkeys([n for n in lnames if _nkey(n, cs) in root_refs] + lkeys))
                r_required = list(dict.fromkeys([n for n in rnames if _nkey(n, cs) in root_refs] + rkeys))
                l_cands = get_candidate_indexes(index_manager, l_scan, hybrid, rule_name="JoinIndexRule")
                r_cands = get_candidate_indexes(index_manager, r_scan, hybrid, rule_name="JoinIndexRule")
                l_usable = _usable_indexes(l_cands, lkeys, l_required, cs)
                r_usable = _usable_indexes(r_cands, rkeys, r_required, cs)
                compatible = _compatible_pairs(l_usable, r_usable, l_to_r, cs)
                if not compatible:
                    record_rule_decision(
                        "JoinIndexRule", False,
                        reason="no-compatible-index-pair" if l_cands or r_cands else "no-candidate-index",
                        left_usable=[c.entry.name for c in l_usable], right_usable=[c.entry.name for c in r_usable],
                    )
                    return node
                lc, rc = rank_join_pairs(compatible)[0]

                def substitute(side: LogicalPlan, scan: ScanNode, cand) -> LogicalPlan:
                    new_rel = _index_relation(cand.entry, with_bucket_spec=True)
                    if cand.appended:
                        rel = scan.relation
                        new_rel.hybrid_append = HybridAppend(
                            files=cand.appended, file_format=rel.file_format, schema=rel.schema,
                            root_paths=list(rel.root_paths), partition_spec=rel.partition_spec,
                        )

                    def replace(n: LogicalPlan) -> LogicalPlan:
                        if n is scan or (isinstance(n, ScanNode) and n.relation is scan.relation):
                            new_scan: LogicalPlan = ScanNode(new_rel)
                            if cand.deleted:
                                new_scan = FilterNode(lineage_prune_condition(cand.deleted), new_scan)
                            return new_scan
                        return n

                    return side.transform_up(replace)

                new_plan = JoinNode(
                    substitute(node.left, l_scan, lc), substitute(node.right, r_scan, rc), node.condition, node.how
                )
                li, ri = lc.entry, rc.entry
                record_rule_decision(
                    "JoinIndexRule", True, indexes=[li.name, ri.name], buckets=[li.num_buckets, ri.num_buckets],
                    hybrid_appended=len(lc.appended) + len(rc.appended),
                    lineage_pruned=len(lc.deleted) + len(rc.deleted),
                )
                log_event(session, HyperspaceIndexUsageEvent(
                    index_names=[li.name, ri.name], plan_before=node.tree_string(),
                    plan_after=new_plan.tree_string(), message="Join index rule applied.",
                ))
                return new_plan

            new_plan = plan.transform_up(rewrite)
            if multiway_enabled():
                new_plan = _wrap_star(new_plan, root_refs, hybrid, index_manager, cs, session)
            return new_plan
        except Exception as e:  # the reference's non-fatal rule policy
            log_rule_failure(session, "JoinIndexRule", e)
            return plan
