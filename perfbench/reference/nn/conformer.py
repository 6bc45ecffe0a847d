"""Conformer layer (``ttsx/nn/conformer.py``): post-norm MHA with the
positional embedding added to the query, GLU conv module, ReLU FFN.
LayerNorm eps is flax's 1e-6. A training forward (``draws`` given) drops
out the attention weights, the attention output and both FFN stages."""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.nn.attention import MHSA
from perfbench.reference.nn.conv import Conv1d
from perfbench.reference.nn.draws import Draws, dropout
from perfbench.reference.nn.layers import Dense, LayerNorm


class ConformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 4, ff_dim: int = 512,
                 kernel_size: int = 5, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.MHSA_0 = MHSA(d_model, num_heads, dropout)
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Conv1d_0 = Conv1d(d_model, 2 * d_model, kernel_size)
        self.Conv1d_1 = Conv1d(d_model, d_model, 1)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, ff_dim)
        self.Dense_1 = Dense(ff_dim, d_model)
        self.LayerNorm_2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor,
                pos_emb: torch.Tensor | None = None,
                draws: Draws | None = None) -> torch.Tensor:
        pos = x if pos_emb is None else pos_emb
        p = self.dropout
        attn = self.MHSA_0(x + pos, x, draws)
        x = self.LayerNorm_0(x + dropout(attn, p, draws))
        a, b = self.Conv1d_0(x).chunk(2, dim=-1)
        x = self.LayerNorm_1(x + self.Conv1d_1(a * torch.sigmoid(b)))
        f = dropout(torch.relu(self.Dense_0(x)), p, draws)
        f = dropout(self.Dense_1(f), p, draws)
        return self.LayerNorm_2(x + f)
