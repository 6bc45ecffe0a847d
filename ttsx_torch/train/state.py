"""A block's train state (``ttsx/train/state.py``): the module, its
optimizer, the update count and the block's random draws.

PyTorch keeps parameters in the module, so ``apply_gradients`` reads the
parameters' ``.grad``, steps them in place and clears the gradients.
Buffers (the refiner's VQ statistics) are never stepped. The reference's
EMA copy is not kept: the acoustic and refiner blocks run without one,
so they validate on the module itself.
"""
from __future__ import annotations

from torch import nn

from ttsx_torch.nn.draws import Draws
from ttsx_torch.train.optim import ClippedAdamW


class TrainState:
    def __init__(self, module: nn.Module, tx: ClippedAdamW, draws: Draws):
        self.module = module
        self.tx = tx
        self.draws = draws
        self.step = 0

    def apply_gradients(self) -> float:
        """One optimizer update; returns the rate it used."""
        lr = self.tx.step()
        self.module.zero_grad(set_to_none=True)
        self.step += 1
        return lr
