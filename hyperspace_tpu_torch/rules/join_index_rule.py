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
- the best-ranked pair substitutes both relations by bucketed index scans.
Any exception returns the original plan. Star-join recognition
(`HYPERSPACE_MULTIWAY`) is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..engine.expr import extract_equi_join_keys
from ..engine.logical import JoinNode, LogicalPlan, ProjectNode, ScanNode, find_single_relation
from ..util.resolver_utils import resolution_key
from .rule_utils import _index_relation, get_candidate_indexes


def _nkey(name: str, cs: bool) -> str:
    return resolution_key(name, cs)


def _norm(names, cs: bool) -> List[str]:
    return [_nkey(n, cs) for n in names]


def _collect_expr_refs(plan: LogicalPlan) -> List[str]:
    refs: List[str] = []
    for node in plan.collect_nodes():
        if isinstance(node, ProjectNode):
            refs.extend(node.column_names)
        elif isinstance(node, JoinNode):
            refs.extend(node.condition.references())
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
    """JoinIndexRanker: equal-bucket pairs first, then higher bucket counts
    (reference `rankers/JoinIndexRanker.scala:40-55`)."""

    def key(p):
        li, ri = p[0].entry, p[1].entry
        return (0 if li.num_buckets == ri.num_buckets else 1, -(li.num_buckets + ri.num_buckets))

    return sorted(pairs, key=key)


class JoinIndexRule:
    """Rule protocol: apply(plan, session) -> plan."""

    def apply(self, plan: LogicalPlan, session) -> LogicalPlan:
        from ..hyperspace import _index_manager_for

        try:
            index_manager = _index_manager_for(session)
            cs = session.hs_conf.case_sensitive
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
                    return node
                l_to_r = _one_to_one(oriented, cs)
                if l_to_r is None:
                    return node
                lkeys = list(dict.fromkeys(l for l, _ in oriented))
                rkeys = [l_to_r[_nkey(k, cs)] for k in lkeys]
                # Required = every column of this side the whole query
                # references + this join's keys (reference :407-418).
                l_required = list(dict.fromkeys([n for n in lnames if _nkey(n, cs) in root_refs] + lkeys))
                r_required = list(dict.fromkeys([n for n in rnames if _nkey(n, cs) in root_refs] + rkeys))
                l_usable = _usable_indexes(get_candidate_indexes(index_manager, l_scan), lkeys, l_required, cs)
                r_usable = _usable_indexes(get_candidate_indexes(index_manager, r_scan), rkeys, r_required, cs)
                compatible = _compatible_pairs(l_usable, r_usable, l_to_r, cs)
                if not compatible:
                    return node
                lc, rc = rank_join_pairs(compatible)[0]

                def substitute(side: LogicalPlan, scan: ScanNode, cand) -> LogicalPlan:
                    new_rel = _index_relation(cand.entry, with_bucket_spec=True)

                    def replace(n: LogicalPlan) -> LogicalPlan:
                        if n is scan or (isinstance(n, ScanNode) and n.relation is scan.relation):
                            return ScanNode(new_rel)
                        return n

                    return side.transform_up(replace)

                return JoinNode(
                    substitute(node.left, l_scan, lc),
                    substitute(node.right, r_scan, rc),
                    node.condition,
                    node.how,
                )

            return plan.transform_up(rewrite)
        except Exception as e:  # the reference's non-fatal rule policy
            logging.getLogger("hyperspace_tpu_torch.rules").warning(
                "JoinIndexRule failed; query falls back to the original plan: %s: %s",
                type(e).__name__, e,
            )
            return plan
