"""Physical operator counts of two plans, for the verbose explain table
(counterpart of `hyperspace_tpu/plananalysis/op_analyzer.py`; reference
`PhysicalOperatorAnalyzer.scala:30-57`)."""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List

from ..engine.physical import PhysicalNode


@dataclass
class PhysicalOperatorComparison:
    name: str
    num_occurrences_before: int
    num_occurrences_after: int


def count_operators(plan: PhysicalNode) -> Dict[str, int]:
    return Counter(n.name for n in plan.collect_nodes())


def compare_operators(before: PhysicalNode, after: PhysicalNode) -> List[PhysicalOperatorComparison]:
    b, a = count_operators(before), count_operators(after)
    return [PhysicalOperatorComparison(n, b.get(n, 0), a.get(n, 0)) for n in sorted(set(b) | set(a))]
