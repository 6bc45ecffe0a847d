"""One module per kind of entry point, loaded by the name a cell's file
gives; each has ``run(ctx) -> dict``."""
