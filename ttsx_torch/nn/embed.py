"""Positional embeddings (``ttsx/nn/embed.py``)."""
from __future__ import annotations

import numpy as np
import torch


def sinusoidal_table(n_pos: int, dim: int) -> np.ndarray:
    """Standard sin/cos table [n_pos, dim]."""
    pos = np.arange(n_pos, dtype=np.float32)[:, None]
    i = np.arange(dim, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, 2.0 * np.floor(i / 2.0) / dim)
    table = np.zeros((n_pos, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


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
