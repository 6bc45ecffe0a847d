"""A block's train state (``ttsx/train/state.py``): the module, its
optimizer, the update count, the block's random draws and, with
``ema_decay > 0``, an EMA copy of the parameters.

PyTorch keeps parameters in the module, so ``apply_gradients`` reads the
parameters' ``.grad``, steps them in place and clears the gradients.
Buffers (the refiner's VQ statistics) are never stepped. After each
update the EMA becomes ``d * ema + (1 - d) * params`` of the *new*
parameters, as the reference's does. Only the vocoder's generator keeps
one (``VocoderConfig.ema_decay``); the acoustic and refiner blocks run
without, so they validate on the module itself.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ttsx_torch.nn.draws import Draws
from ttsx_torch.train.optim import ClippedAdamW


class TrainState:
    def __init__(self, module: nn.Module, tx: ClippedAdamW, draws: Draws,
                 ema_decay: float = 0.0):
        self.module = module
        self.tx = tx
        self.draws = draws
        self.step = 0
        self.ema_decay = ema_decay
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay > 0:
            self.reset_ema()

    def reset_ema(self) -> None:
        """Start the EMA at the module's current parameters."""
        self.ema = {n: p.detach().clone()
                    for n, p in self.module.named_parameters()}

    @torch.no_grad()
    def apply_gradients(self) -> float:
        """One optimizer update; returns the rate it used."""
        lr = self.tx.step()
        self.module.zero_grad(set_to_none=True)
        self.step += 1
        if self.ema is not None:
            d = self.ema_decay
            for n, p in self.module.named_parameters():
                e = self.ema[n]
                e.copy_(d * e + (1.0 - d) * p)
        return lr

    def eval_params(self, use_ema: bool = True) -> Dict[str, torch.Tensor]:
        """The module's state dict with the EMA in place of the parameters
        when ``use_ema`` and an EMA is kept (the reference's
        ``eval_params``); load it into a copy of the module to run it."""
        state = dict(self.module.state_dict())
        if use_ema and self.ema is not None:
            state.update(self.ema)
        return state
