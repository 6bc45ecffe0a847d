"""FiLM-conditioned residual conv block, ScaleNorm and stochastic depth
(``ttsx/nn/film.py``). Dropout and stochastic depth act only in a
training forward (``draws`` given)."""
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


def stochastic_depth(x: torch.Tensor, p: float,
                     draws: Draws | None) -> torch.Tensor:
    """Per-sample drop of a residual branch: x times a Bernoulli(1 - p)
    mask of shape [B, 1, ...] over 1 - p; x itself without ``draws`` or
    when p <= 0."""
    if draws is None or p <= 0.0:
        return x
    keep = 1.0 - p
    mask = draws.bernoulli(keep, (x.shape[0],) + (1,) * (x.ndim - 1))
    return x * (mask.to(x.dtype) / keep)


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
        return x + stochastic_depth(y, self.sd_prob, draws)
