"""Host utilities of the port: rotating logs, the artifact figures, and
the spans and counters (``spans``)."""
