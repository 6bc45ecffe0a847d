"""Random draws of a training forward, and dropout on them.

A training forward takes a ``Draws`` and makes every random draw through
it, in the reference's order: dropout and stochastic-depth masks, the
diffusion step and noise, the Gumbel uniforms, the refiner's time and
noise. ``draws=None`` is the deterministic (inference) forward.

``Draws`` reads one ``torch.Generator`` on the device. ``RecordingDraws``
keeps what another source drew, and ``ReplayDraws`` hands recorded draws
back in order, checking kind and shape: that is how a test or a second
device runs a step on the same draws (JAX's PRNG streams cannot be
reproduced). ``mark`` / ``rewind`` let a block reuse one window's draws
for every micro-batch, as the reference does with one key per window.

Under a mesh of dp > 1 (``ttsx_torch.core.mesh``) a block draws through
``mesh_draws(draws)``: every draw is made at the global batch's shape
and cut to this rank's rows, as the reference draws one global tensor
and shards it, so a dp run is one process's run. Every draw of a
training forward is batch-major but attention dropout's mask, which is
shared by the whole batch and drawn through ``replicated(draws)``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ttsx_torch.core.mesh import active_mesh, global_rows


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


class RecordingDraws:
    """Draws from ``source``, kept as (kind, shape, value on the CPU)."""

    def __init__(self, source):
        self.source = source
        self.records: List[Record] = []

    def _keep(self, kind, shape, value):
        self.records.append((kind, tuple(shape), value.detach().cpu()))
        return value

    def uniform(self, shape, low=0.0, high=1.0):
        return self._keep("uniform", shape,
                          self.source.uniform(shape, low, high))

    def normal(self, shape):
        return self._keep("normal", shape, self.source.normal(shape))

    def randint(self, shape, low, high):
        return self._keep("randint", shape,
                          self.source.randint(shape, low, high))

    def bernoulli(self, p, shape):
        return self._keep("bernoulli", shape, self.source.bernoulli(p, shape))

    def mark(self):
        return len(self.records), self.source.mark()

    def rewind(self, mark) -> None:
        n, inner = mark
        del self.records[n:]
        self.source.rewind(inner)


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


class ShardedDraws:
    """``inner``'s draws at the global batch's shape, this rank's rows."""

    def __init__(self, inner, mesh):
        self.inner, self.mesh = inner, mesh

    @property
    def gen(self):
        return self.inner.gen

    def _rows(self, draw, shape):
        return global_rows(draw, shape, self.mesh)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._rows(lambda s: self.inner.uniform(s, low, high), shape)

    def normal(self, shape):
        return self._rows(self.inner.normal, shape)

    def randint(self, shape, low, high):
        return self._rows(lambda s: self.inner.randint(s, low, high), shape)

    def bernoulli(self, p, shape):
        return self._rows(lambda s: self.inner.bernoulli(p, s), shape)

    def mark(self):
        return self.inner.mark()

    def rewind(self, mark) -> None:
        self.inner.rewind(mark)


def mesh_draws(draws):
    """``draws`` cut to this rank's rows under an active mesh of dp > 1,
    else ``draws`` itself."""
    mesh = active_mesh()
    if draws is None or mesh is None or mesh.dp == 1:
        return draws
    return ShardedDraws(draws, mesh)


def replicated(draws):
    """The draws behind a ``ShardedDraws``, for a draw that is not
    batch-major (the same tensor on every rank)."""
    return draws.inner if isinstance(draws, ShardedDraws) else draws


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
