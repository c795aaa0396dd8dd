"""Signature providers: fingerprint a plan to decide index applicability.

Parity: reference `FileBasedSignatureProvider.scala:39-79` (md5 fold over every
source file's (length, modTime, path)), `PlanSignatureProvider.scala:36-43`
(fold over operator class names) and `IndexSignatureProvider.scala:33-49`
(combined — the default). Counterpart of `hyperspace_tpu/index/signatures.py`:
the logical node classes carry the same names, so both packages compute the
same signature for the same scan.
"""

from __future__ import annotations

from typing import Optional

from ..engine.logical import LogicalPlan, ScanNode
from ..exceptions import HyperspaceException
from ..util.hashing_utils import md5_hex


class LogicalPlanSignatureProvider:
    @property
    def name(self) -> str:
        return type(self).__name__

    def signature(self, plan: LogicalPlan) -> Optional[str]:
        raise NotImplementedError


class FileBasedSignatureProvider(LogicalPlanSignatureProvider):
    def signature(self, plan: LogicalPlan) -> Optional[str]:
        acc = ""
        found = False
        for node in plan.collect_nodes():
            if isinstance(node, ScanNode):
                found = True
                for f in node.relation.files:
                    acc = md5_hex(acc + f"{f.size}{f.modified_time}{f.path}")
        return acc if found else None


class PlanSignatureProvider(LogicalPlanSignatureProvider):
    def signature(self, plan: LogicalPlan) -> Optional[str]:
        acc = ""
        for node in plan.collect_nodes():
            acc = md5_hex(acc + type(node).__name__)
        return acc


class IndexSignatureProvider(LogicalPlanSignatureProvider):
    def signature(self, plan: LogicalPlan) -> Optional[str]:
        f = FileBasedSignatureProvider().signature(plan)
        if f is None:
            return None
        return md5_hex(f + PlanSignatureProvider().signature(plan))


_BUILTIN = {
    "IndexSignatureProvider": IndexSignatureProvider,
    "FileBasedSignatureProvider": FileBasedSignatureProvider,
    "PlanSignatureProvider": PlanSignatureProvider,
}


def create_provider(name: Optional[str] = None) -> LogicalPlanSignatureProvider:
    """Factory; default = IndexSignatureProvider."""
    if name is None:
        return IndexSignatureProvider()
    if name in _BUILTIN:
        return _BUILTIN[name]()
    raise HyperspaceException(f"Unknown signature provider: {name}")
