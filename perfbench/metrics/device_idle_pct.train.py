"""The device's idle share of the traced stretch (train cells): 100 x (1 -
busy / wall), where busy is the union of the device's kernel, copy and
set intervals in the profiler's trace and wall the stretch's host time
between two synchronisations. Nothing when the trace saw no device work."""


def read(record):
    if record.get("kind") != "train":
        return None
    busy, wall = record["trace"].get("busy_s", 0.0), record["stretch_s"]
    if busy <= 0.0 or wall <= 0.0:
        return None
    return 100.0 * (1.0 - busy / wall)
