"""Per-layer metric readers: ``<name>.py`` reads metric ``<name>`` from the
run's summary (``read(summary)``) and returns None when there is nothing to
read."""
