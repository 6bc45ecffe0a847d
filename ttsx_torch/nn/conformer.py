"""Conformer layer (``ttsx/nn/conformer.py``): post-norm MHA with the
positional embedding added to the query, GLU conv module, ReLU FFN.
LayerNorm eps is flax's 1e-6."""
from __future__ import annotations

import torch
from torch import nn

from ttsx_torch.nn.attention import MHSA
from ttsx_torch.nn.conv import Conv1d
from ttsx_torch.nn.layers import Dense, LayerNorm


class ConformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 4, ff_dim: int = 512,
                 kernel_size: int = 5):
        super().__init__()
        self.MHSA_0 = MHSA(d_model, num_heads)
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Conv1d_0 = Conv1d(d_model, 2 * d_model, kernel_size)
        self.Conv1d_1 = Conv1d(d_model, d_model, 1)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, ff_dim)
        self.Dense_1 = Dense(ff_dim, d_model)
        self.LayerNorm_2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor,
                pos_emb: torch.Tensor | None = None) -> torch.Tensor:
        pos = x if pos_emb is None else pos_emb
        x = self.LayerNorm_0(x + self.MHSA_0(x + pos, x))
        a, b = self.Conv1d_0(x).chunk(2, dim=-1)
        x = self.LayerNorm_1(x + self.Conv1d_1(a * torch.sigmoid(b)))
        f = self.Dense_1(torch.relu(self.Dense_0(x)))
        return self.LayerNorm_2(x + f)
