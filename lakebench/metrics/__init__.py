"""One reader per per-layer metric: `read(run)` takes a finished
`harness.Run` and returns the metric's value, or None when the run holds
nothing for it to read (the harness then leaves the metric out)."""
