"""The acoustic + refiner trainer of the port (``ttsx/train``): losses,
the optimizer with optax's semantics, per-block train states, the blocks
and the unified engine. The vocoder GAN block is not ported yet."""
