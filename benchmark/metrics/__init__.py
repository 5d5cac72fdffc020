"""Per-layer metric readers, one module a metric, named as the metric:
`read(w)` takes the traced window (`harness.Window`) and returns the
metric's value, or None where the window holds nothing to read."""
