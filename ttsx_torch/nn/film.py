"""FiLM-conditioned residual conv block (``ttsx/nn/film.py``). Dropout
and stochastic depth act only in a training forward (``draws`` given)."""
from __future__ import annotations

import torch
from torch import nn

from ttsx_torch.nn.conv import Conv1d
from ttsx_torch.nn.draws import Draws, dropout
from ttsx_torch.nn.layers import Dense, silu


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
    FiLM(cond) -> dropout -> LayerScale -> stochastic depth (per-sample
    drop of the branch with probability ``sd_prob``) -> residual.
    x [B, T, C]; cond [B, T, Dc]."""

    def __init__(self, channels: int, cond_dim: int, kernel_size: int = 5,
                 dropout: float = 0.1, sd_prob: float = 0.0,
                 ls_init: float = 1e-4):
        super().__init__()
        self.dropout, self.sd_prob, self.ls_init = dropout, sd_prob, ls_init
        self.ScaleNorm_0 = ScaleNorm(channels)
        self.Conv1d_0 = Conv1d(channels, channels, kernel_size,
                               groups=channels, padding="CAUSAL")
        self.Conv1d_1 = Conv1d(channels, channels, 1)
        self.ScaleNorm_1 = ScaleNorm(channels)
        self.Dense_0 = Dense(cond_dim, channels)
        self.Dense_1 = Dense(channels, 2 * channels)
        self.gamma = nn.Parameter(torch.full((channels,), ls_init))

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                draws: Draws | None = None) -> torch.Tensor:
        y = self.Conv1d_1(self.Conv1d_0(self.ScaleNorm_0(x)))
        y = silu(self.ScaleNorm_1(y))
        scale, shift = self.Dense_1(silu(self.Dense_0(cond))).chunk(2, -1)
        y = self.gamma * dropout(y * (1.0 + scale) + shift, self.dropout,
                                 draws)
        if draws is not None and self.sd_prob > 0.0:
            keep = 1.0 - self.sd_prob
            mask = draws.bernoulli(keep, (x.shape[0], 1, 1))
            y = y * (mask.float() / keep)
        return x + y
