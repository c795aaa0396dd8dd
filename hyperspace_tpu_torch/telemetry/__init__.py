"""Telemetry of the port: the metrics registry (`metrics`), the span tree
(`tracing`), the query ledger (`accounting`), the stage ledger
(`stage_ledger`), the kernel build and launch observatory (`compile_log`),
the device cost observatory (`device_observatory`), the events and their
logger (`events`, `event_logging`), fault injection (`faults`) and the stage
records of the streamed executors (`profiling`)."""
