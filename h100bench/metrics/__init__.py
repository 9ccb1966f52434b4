"""One reader a per-layer metric: ``<metric>.py`` holds ``read(records)``,
which returns the metric's number, or ``None`` where the run has nothing
for it to read (the harness then leaves the metric out of the line)."""
