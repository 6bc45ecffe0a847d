"""The share of the frames the server ran that were padding (serve
cells): 100 x (1 - requested / run) over the traced calls, from the
program's counters ``serve.frames_requested`` (the requests' frames) and
``serve.frames_run`` (``max_batch x frames`` a bucket). Nothing when the
program recorded no such counter."""
from perfbench.program_spans import recorded


def read(record):
    if record.get("kind") != "serve":
        return None
    rec = recorded()
    if rec is None or rec.counters.get("serve.frames_run", 0) <= 0:
        return None
    c = rec.counters
    return 100.0 * (1.0 - c.get("serve.frames_requested", 0)
                    / c["serve.frames_run"])
