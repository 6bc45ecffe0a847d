"""Host milliseconds per engine step in the acoustic block's steps, over the
whole window: the benchmark's wrappers around the block's step methods
synchronise the card before and after each call."""


def read(record):
    if record.get("kind") != "train" or "acoustic" not in record["blocks_s"]:
        return None
    return 1e3 * record["blocks_s"]["acoustic"] / record["steps"]
