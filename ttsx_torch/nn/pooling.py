"""Pooling over time for the speaker encoder (``ttsx/nn/pooling.py``):
[B, T, D] (with an optional [B, T] mask of valid frames) -> one vector
per item. The attentive heads set masked frames' scores to -1e9 before
the softmax over time, as the reference does."""
from __future__ import annotations

import torch
from torch import nn

from ttsx_torch.nn.layers import Dense


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Mean over time of the valid frames (all frames without a mask)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def _masked_moments(x, mask):
    mean = masked_mean(x, mask)
    if mask is None:
        return mean, x.var(dim=1, unbiased=False)
    m = mask[..., None].to(x.dtype)
    var = (((x - mean[:, None]) ** 2 * m).sum(dim=1)
           / m.sum(dim=1).clamp_min(1.0))
    return mean, var


class StatsPooling(nn.Module):
    """[B, T, D] -> [B, 2D]: mean || sqrt(var + 1e-8)."""

    def forward(self, x, mask=None):
        mean, var = _masked_moments(x, mask)
        return torch.cat([mean, torch.sqrt(var + 1e-8)], dim=-1)


def _attend(x, score: torch.Tensor, mask) -> torch.Tensor:
    """sum over time of x weighted by softmax(score) ([B, T, 1])."""
    if mask is not None:
        score = torch.where(mask[..., None], score,
                            torch.full_like(score, -1e9))
    return (x * torch.softmax(score, dim=1)).sum(dim=1)


class SelfAttentivePooling(nn.Module):
    """[B, T, D] -> [B, D], one attentive head."""

    def __init__(self, dim: int, hidden: int = 128):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden)
        self.Dense_1 = Dense(hidden, 1)

    def forward(self, x, mask=None):
        return _attend(x, self.Dense_1(torch.tanh(self.Dense_0(x))), mask)


class MultiHeadAttentivePooling(nn.Module):
    """[B, T, D] -> [B, dim]: ``heads`` attentive heads (Dense_{2i},
    Dense_{2i+1}), concatenated and fused by Dense_{2 heads}."""

    def __init__(self, in_dim: int, dim: int, heads: int = 4,
                 hidden: int = 128):
        super().__init__()
        self.heads = heads
        for i in range(heads):
            self.add_module(f"Dense_{2 * i}", Dense(in_dim, hidden))
            self.add_module(f"Dense_{2 * i + 1}", Dense(hidden, 1))
        self.add_module(f"Dense_{2 * heads}", Dense(heads * in_dim, dim))

    def forward(self, x, mask=None):
        d = dict(self.named_children())
        outs = [_attend(x, d[f"Dense_{2 * i + 1}"](
            torch.tanh(d[f"Dense_{2 * i}"](x))), mask)
            for i in range(self.heads)]
        return d[f"Dense_{2 * self.heads}"](torch.cat(outs, dim=-1))
