"""One reader per per-layer metric: metrics/<name>.py defines
`read(t: run.TraceData)`, which returns the metric's value, or None where
the run holds nothing to read it from (the harness then leaves the metric
out of the line)."""
