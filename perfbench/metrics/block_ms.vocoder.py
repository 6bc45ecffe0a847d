"""Host milliseconds per engine step in the vocoder block's steps, over the
whole window: the benchmark's wrappers around the block's step methods
synchronise the card before and after each call."""


def read(record):
    if record.get("kind") != "train" or "vocoder" not in record["blocks_s"]:
        return None
    return 1e3 * record["blocks_s"]["vocoder"] / record["steps"]
