"""Metric readers, one file a metric, each with ``read(run)``: the number,
or None where the run holds nothing to read (the harness then leaves the
metric out of the line)."""
