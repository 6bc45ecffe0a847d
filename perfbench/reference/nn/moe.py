"""Style-gated mixture of experts (``ttsx/nn/moe.py``): softmax gates at
inference; in a training forward (``draws`` given) Gumbel-perturbed
gates, then dropout on the gates."""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.nn.draws import Draws, dropout
from perfbench.reference.nn.layers import Dense, matmul, softmax


class GumbelMoE(nn.Module):
    """x [B, T, D_in], style [B, style_dim] -> [B, T, D_out]."""

    def __init__(self, input_dim: int, output_dim: int, num_experts: int = 4,
                 style_dim: int = 128, tau: float = 1.0,
                 dropout: float = 0.1):
        super().__init__()
        self.tau, self.dropout = tau, dropout
        self.experts_w = nn.Parameter(
            torch.randn(num_experts, input_dim, output_dim) * input_dim ** -0.5)
        self.experts_b = nn.Parameter(torch.zeros(num_experts, output_dim))
        self.gate = Dense(style_dim, num_experts)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                draws: Draws | None = None) -> torch.Tensor:
        logits = self.gate(style)
        if draws is not None:
            u = draws.uniform(logits.shape, 1e-20, 1.0)
            logits = logits - torch.log(-torch.log(u))
        gates = dropout(softmax(logits / self.tau, dim=-1),
                        self.dropout, draws)
        w_mix = torch.einsum("be,eio->bio", gates, self.experts_w)
        b_mix = gates @ self.experts_b
        return matmul(x, w_mix) + b_mix[:, None, :]
