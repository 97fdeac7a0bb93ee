"""Per-layer metric readers, one file a metric, each ``read(run)``
returning the metric's value or None where the run has nothing to read."""
