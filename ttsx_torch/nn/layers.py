"""The flax.linen basics the port needs, as PyTorch modules over [..., C].

Each module that holds parameters knows how to take them from the flax
tree (``from_flax_leaves``: flax leaf dict -> this module's state-dict
entries), so ``ttsx_torch.weights.from_flax`` can walk any model
mechanically. Norms use flax's eps of 1e-6, not torch's 1e-5.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """flax ``nn.Dense``: kernel [in, out] <-> torch weight [out, in]."""

    def from_flax_leaves(self, leaves):
        out = {"weight": np.asarray(leaves["kernel"]).T}
        if "bias" in leaves:
            out["bias"] = leaves["bias"]
        return out


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` (eps 1e-6, scale/bias) over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def from_flax_leaves(self, leaves):
        return {"weight": leaves["scale"], "bias": leaves["bias"]}


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over channels-last [B, T, C]: statistics per
    (batch, group) over time and the group's channels, eps 1e-6."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        g = x.reshape(B, T, self.num_groups, C // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        g = (g - mean) * torch.rsqrt(var + self.eps)
        return g.reshape(B, T, C) * self.weight + self.bias

    def from_flax_leaves(self, leaves):
        return {"weight": leaves["scale"], "bias": leaves["bias"]}


class Embed(nn.Embedding):
    """flax ``nn.Embed`` (table under ``embedding``)."""

    def from_flax_leaves(self, leaves):
        return {"weight": leaves["embedding"]}


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` defaults to the tanh approximation."""
    return F.gelu(x, approximate="tanh")
