"""Positional embeddings (``ttsx/nn/embed.py``)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sinusoidal_table(n_pos: int, dim: int) -> np.ndarray:
    """Standard sin/cos table [n_pos, dim]."""
    pos = np.arange(n_pos, dtype=np.float32)[:, None]
    i = np.arange(dim, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, 2.0 * np.floor(i / 2.0) / dim)
    table = np.zeros((n_pos, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class FreqPosEmbed(nn.Module):
    """The fixed sinusoidal table [n_freq, dim] (a constant, no
    parameter)."""

    def __init__(self, n_freq: int, dim: int):
        super().__init__()
        self.register_buffer("table", torch.as_tensor(
            sinusoidal_table(n_freq, dim)), persistent=False)

    def forward(self) -> torch.Tensor:
        return self.table


def rotary_mix(x: torch.Tensor) -> torch.Tensor:
    """cos(emb) * x + sin(emb) * roll(x, 1, -1), emb = [freqs, freqs];
    x [B, T, D]."""
    _, t, d = x.shape
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                               device=x.device) / d))
    freqs = torch.arange(t, dtype=torch.float32,
                         device=x.device)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * x + torch.sin(emb) * torch.roll(x, 1, dims=-1)


def extend_to_length(pe: torch.Tensor, t: int) -> torch.Tensor:
    """Crop a [L, D] table to ``t`` rows, or extend it with copies of its
    last row."""
    if t <= pe.shape[0]:
        return pe[:t]
    return torch.cat([pe, pe[-1:].expand(t - pe.shape[0], -1)], dim=0)
