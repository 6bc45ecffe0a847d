"""The port's trainer (``ttsx/train``): losses, the optimizer with
optax's semantics, per-block train states (with the generator's EMA),
the acoustic, refiner and vocoder GAN blocks, the unified engine, and
the vocoder's slim export."""
