"""Stage records of the streamed executors (`profiling`)."""
