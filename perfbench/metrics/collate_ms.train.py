"""Host milliseconds of collation per engine step: the ``collate_time``
the collator stamps on each batch it made in the window (every
micro-batch), summed and divided by the window's engine steps."""


def read(record):
    if record.get("kind") != "train":
        return None
    return 1e3 * record["collate_s"] / record["steps"]
