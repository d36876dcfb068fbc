"""One reader a family of per-layer metrics: ``read(run)`` returns the
metric's value, or None where the run has nothing for it to read (the
harness then leaves the metric out).  ``run`` is ``harness.Run``."""
