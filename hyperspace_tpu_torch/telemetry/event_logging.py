"""Pluggable event logging (counterpart of
`hyperspace_tpu/telemetry/event_logging.py`; reference
`telemetry/HyperspaceEventLogging.scala:30-68`).

The logger class is named by its dotted path in the conf key
`hyperspace.eventLoggerClass` (`HyperspaceConf.event_logger_class`); unset
gives the no-op logger. A path that does not load (a typo, a missing module,
a constructor that raises) falls back to the no-op logger, cached under the
bad name, with one warning.
"""

from __future__ import annotations

import importlib
import logging
import threading
from typing import List, Optional

from .events import HyperspaceEvent


class EventLogger:
    def log_event(self, event: HyperspaceEvent) -> None:
        raise NotImplementedError


class NoOpEventLogger(EventLogger):
    def log_event(self, event: HyperspaceEvent) -> None:
        pass


class RecordingEventLogger(EventLogger):
    """Keeps the events in memory (tests)."""

    def __init__(self):
        self.events: List[HyperspaceEvent] = []

    def log_event(self, event: HyperspaceEvent) -> None:
        self.events.append(event)


class EventLoggerFactory:
    """One logger instance per class path."""

    _lock = threading.Lock()
    _cache: dict = {}

    @classmethod
    def get_logger(cls, class_name: Optional[str]) -> EventLogger:
        key = class_name or "noop"
        with cls._lock:
            if key not in cls._cache:
                cls._cache[key] = NoOpEventLogger() if class_name is None else cls._load(class_name)
            return cls._cache[key]

    @staticmethod
    def _load(class_name: str) -> EventLogger:
        try:
            module_name, _, attr = class_name.rpartition(".")
            return getattr(importlib.import_module(module_name), attr)()
        except Exception as e:
            logging.getLogger("hyperspace_tpu_torch.telemetry").warning(
                "Event logger class %r failed to load (%s: %s); falling back to NoOpEventLogger",
                class_name, type(e).__name__, e,
            )
            return NoOpEventLogger()

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._cache.clear()


def log_event(session, event: HyperspaceEvent) -> None:
    """Hand `event` to the session's configured logger; a logger that raises
    never fails the operation it observed."""
    try:
        EventLoggerFactory.get_logger(session.hs_conf.event_logger_class).log_event(event)
    except Exception:
        pass
