"""Global style tokens (``ttsx/nn/gst.py``): mel [B, T, C] -> style [B, D]."""
from __future__ import annotations

import torch
from torch import nn

from ttsx_torch.nn.conv import Conv1d


class GlobalStyleTokens(nn.Module):
    def __init__(self, channels: int = 80, style_dim: int = 128,
                 num_tokens: int = 10):
        super().__init__()
        self.tokens = nn.Parameter(torch.randn(num_tokens, style_dim))
        self.Conv1d_0 = Conv1d(channels, style_dim, 3)
        self.Conv1d_1 = Conv1d(style_dim, num_tokens, 1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        logits = self.Conv1d_1(torch.relu(self.Conv1d_0(mel)))
        weights = torch.softmax(logits, dim=1)          # over T
        return torch.einsum("btn,nd->bd", weights, self.tokens)
