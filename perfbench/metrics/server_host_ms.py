"""Host milliseconds a serving call spends in the server's own work on
the host: the program's ``serve.pad``, ``serve.upload`` and
``serve.trim`` spans, summed over the traced calls and divided by their
``serve.call`` spans. In a closed loop the device has nothing queued
while they run, so each of their milliseconds is one a call waits. They
are read in the profiled stretch; ``serve.pad`` and ``serve.trim`` are
numpy, which the profiler does not see, and ``serve.upload`` five
copies. Nothing when the program recorded no call."""
from perfbench.program_spans import per_unit


def read(record):
    if record.get("kind") != "serve":
        return None
    rec, calls = per_unit("serve.call")
    if not calls:
        return None
    return 1e3 * rec.seconds("serve.pad", "serve.upload",
                             "serve.trim") / calls
