"""Random draws of a training forward, and dropout on them: a frozen copy
of ``ttsx_torch/nn/draws.py`` without the mesh.

A training forward makes every random draw through a draws object, in
the reference's order; ``draws=None`` is the deterministic forward. The
benchmark hands the reference the draws the program's step made
(``ReplayDraws``), checking kind and shape."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch



class Draws:
    def __init__(self, generator: torch.Generator):
        self.gen = generator

    @property
    def device(self) -> torch.device:
        return self.gen.device

    def uniform(self, shape: Sequence[int], low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.gen, device=self.device)
        return torch.clamp_min(u * (high - low) + low, low)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)

    def randint(self, shape: Sequence[int], low: int, high: int
                ) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.gen,
                             device=self.device)

    def bernoulli(self, p: float, shape: Sequence[int]) -> torch.Tensor:
        """Boolean mask, True with probability ``p``."""
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device) < p

    def mark(self):
        return self.gen.get_state()

    def rewind(self, mark) -> None:
        self.gen.set_state(mark)


Record = Tuple[str, Tuple[int, ...], torch.Tensor]


class ReplayDraws:
    """Recorded draws handed back in order on ``device``."""

    def __init__(self, records: Sequence[Record], device="cpu"):
        self.records = list(records)
        self.pos = 0
        self.device = torch.device(device)

    def _next(self, kind, shape):
        if self.pos >= len(self.records):
            raise IndexError(f"no recorded draw left for {kind} {shape}")
        k, s, value = self.records[self.pos]
        if k != kind or tuple(s) != tuple(shape):
            raise ValueError(f"draw {self.pos}: recorded {k} {s}, asked "
                             f"for {kind} {tuple(shape)}")
        self.pos += 1
        return torch.as_tensor(value).to(self.device)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next("uniform", shape).float()

    def normal(self, shape):
        return self._next("normal", shape).float()

    def randint(self, shape, low, high):
        return self._next("randint", shape).long()

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape).bool()

    def mark(self):
        return self.pos

    def rewind(self, mark) -> None:
        self.pos = mark

    def exhausted(self) -> bool:
        return self.pos == len(self.records)


def mesh_draws(draws):
    return draws


def replicated(draws):
    return draws


def dropout(x: torch.Tensor, rate: float, draws, broadcast_dims=()
            ) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the
    kept values by 1 / (1 - rate); a mask dim in ``broadcast_dims`` has
    size 1. No draw when ``draws`` is None or ``rate`` is 0."""
    if draws is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    shape = [1 if d in broadcast_dims else n for d, n in enumerate(x.shape)]
    keep = draws.bernoulli(keep_prob, shape)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
