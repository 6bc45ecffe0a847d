"""Device milliseconds a serving call spends in the acoustic: the kernels
launched while the benchmark's host range of the stage was open, summed
over the traced stretch and divided by its calls."""

RANGES = ("stage.acoustic",)


def read(record):
    if record.get("kind") != "serve":
        return None
    ranges = record["trace"].get("ranges", {})
    if not any(r in ranges for r in RANGES):
        return None
    return 1e3 * sum(ranges.get(r, 0.0) for r in RANGES) / record["calls"]
