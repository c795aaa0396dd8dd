"""Telemetry of the port: the metrics registry (`metrics`), the span tree
(`tracing`), the query ledger (`accounting`), the stage ledger
(`stage_ledger`), the kernel build and launch observatory (`compile_log`),
the device cost observatory and its profile capture (`device_observatory`),
the workload history store (`history`), the metrics exporter (`exporter`),
the sinks' rotation (`rotation`), the events and their logger (`events`,
`event_logging`), fault injection (`faults`) and the stage records of the
streamed executors (`profiling`).

With `HYPERSPACE_METRICS_FILE` set when the package is imported, the
exporter's thread starts here; unset, nothing starts."""

from . import exporter as _exporter

_exporter.maybe_start_from_env()
