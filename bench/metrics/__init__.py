"""Per-layer metric readers, one file a metric: ``read(ctx)`` returns the
value or None where it finds nothing to read."""
