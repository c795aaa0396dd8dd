"""Telemetry events (counterpart of `hyperspace_tpu/telemetry/events.py`;
reference `telemetry/HyperspaceEvent.scala:28-123`): the application info,
one event per lifecycle action, `HyperspaceIndexUsageEvent` when a rule
rewrites a plan onto indexes and `HyperspaceRuleFailureEvent` when a rule
raised and the query fell back to its original plan.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List


@dataclass
class AppInfo:
    sparkUser: str = ""
    appId: str = ""
    appName: str = ""


@dataclass
class HyperspaceEvent:
    app_info: AppInfo = field(default_factory=AppInfo)
    message: str = ""
    timestamp: float = field(default_factory=time.time)

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass
class HyperspaceIndexCRUDEvent(HyperspaceEvent):
    index_name: str = ""


class CreateActionEvent(HyperspaceIndexCRUDEvent):
    pass


class DeleteActionEvent(HyperspaceIndexCRUDEvent):
    pass


class RestoreActionEvent(HyperspaceIndexCRUDEvent):
    pass


class VacuumActionEvent(HyperspaceIndexCRUDEvent):
    pass


class RefreshActionEvent(HyperspaceIndexCRUDEvent):
    pass


class OptimizeActionEvent(HyperspaceIndexCRUDEvent):
    pass


class CancelActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class HyperspaceIndexUsageEvent(HyperspaceEvent):
    index_names: List[str] = field(default_factory=list)
    plan_before: str = ""
    plan_after: str = ""


@dataclass
class HyperspaceRuleFailureEvent(HyperspaceEvent):
    rule_name: str = ""
    exception: str = ""
