"""The program's own spans and counters, for the readers of
``program_span`` and ``program_counter`` metrics, and for the
``device_trace`` readers that divide by the program's steps.

The port records them in its process's default recorder
(``ttsx_torch.utils.spans.recorded()``) while a profiler is active: in
a traced run, the cell's traced stretch (the recorder holds the last
profiler session alone). The readers run after the cell's run, in the
same process. A tree whose port has no such module, or a run that
recorded nothing, gives ``None``."""
from __future__ import annotations


def recorded():
    """The program's default recorder, or ``None`` where it has none or
    it holds nothing."""
    try:
        from ttsx_torch.utils.spans import recorded as program
    except ImportError:
        return None
    rec = program()
    return rec if rec else None


def per_unit(name: str):
    """(recorder, the number of closed ``name`` spans): the spans that
    mark a call or a step; ``(None, 0)`` when there are none."""
    rec = recorded()
    n = len(rec.named(name)) if rec is not None else 0
    return (rec, n) if n else (None, 0)


def per_step_range(record, name: str, idle: bool = False):
    """Device milliseconds an engine step (training cells) of the kernels
    launched while the program's ``name`` span was open (the trace's
    ``ranges``), summed over the traced stretch and divided by the
    program's ``train.step`` spans in it; with ``idle``, plus the device
    idle the trace names after the span (``idle_gaps``, its ten largest
    names). ``None`` when the program recorded no step or the trace has
    no such range."""
    if record.get("kind") != "train":
        return None
    trace = record["trace"]
    ranges = trace.get("ranges", {})
    _, steps = per_unit("train.step")
    if not steps or name not in ranges:
        return None
    s = ranges[name]
    if idle:
        s += sum(v for k, v in trace.get("idle_gaps", []) if k == name)
    return 1e3 * s / steps
