"""Style-gated mixture of experts (``ttsx/nn/moe.py``), with the
deterministic softmax gates of inference."""
from __future__ import annotations

import torch
from torch import nn

from ttsx_torch.nn.layers import Dense


class GumbelMoE(nn.Module):
    """x [B, T, D_in], style [B, style_dim] -> [B, T, D_out]."""

    def __init__(self, input_dim: int, output_dim: int, num_experts: int = 4,
                 style_dim: int = 128, tau: float = 1.0):
        super().__init__()
        self.tau = tau
        self.experts_w = nn.Parameter(
            torch.randn(num_experts, input_dim, output_dim) * input_dim ** -0.5)
        self.experts_b = nn.Parameter(torch.zeros(num_experts, output_dim))
        self.gate = Dense(style_dim, num_experts)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gates = torch.softmax(self.gate(style) / self.tau, dim=-1)
        w_mix = torch.einsum("be,eio->bio", gates, self.experts_w)
        b_mix = gates @ self.experts_b
        return torch.bmm(x, w_mix) + b_mix[:, None, :]
