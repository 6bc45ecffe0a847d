"""FiLM-conditioned residual conv block (``ttsx/nn/film.py``) at
inference: dropout and stochastic depth are the identity."""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ttsx_torch.nn.conv import Conv1d
from ttsx_torch.nn.layers import Dense


class ScaleNorm(nn.Module):
    """x / max(||x||, eps) * g along channels."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x * (self.g / norm.clamp_min(self.eps))


class ResidualConvBlock(nn.Module):
    """ScaleNorm -> causal depthwise + pointwise conv -> ScaleNorm + SiLU ->
    FiLM(cond) -> LayerScale -> residual. x [B, T, C]; cond [B, T, Dc]."""

    def __init__(self, channels: int, cond_dim: int, kernel_size: int = 5):
        super().__init__()
        self.ScaleNorm_0 = ScaleNorm(channels)
        self.Conv1d_0 = Conv1d(channels, channels, kernel_size,
                               groups=channels, padding="CAUSAL")
        self.Conv1d_1 = Conv1d(channels, channels, 1)
        self.ScaleNorm_1 = ScaleNorm(channels)
        self.Dense_0 = Dense(cond_dim, channels)
        self.Dense_1 = Dense(channels, 2 * channels)
        self.gamma = nn.Parameter(torch.full((channels,), 1e-4))

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        y = self.Conv1d_1(self.Conv1d_0(self.ScaleNorm_0(x)))
        y = F.silu(self.ScaleNorm_1(y))
        scale, shift = self.Dense_1(F.silu(self.Dense_0(cond))).chunk(2, -1)
        return x + self.gamma * (y * (1.0 + scale) + shift)
