"""Dual-attention transformer block, the HSF conv stack and the harmonic
source filter (``ttsx/nn/tf_block.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ttsx_torch.nn.attention import MHSA
from ttsx_torch.nn.conv import Conv1d
from ttsx_torch.nn.layers import Dense, LayerNorm, gelu


class TFBlock(nn.Module):
    """Two self-attention banks, summed -> LayerNorm -> GELU MLP -> residual."""

    def __init__(self, channels: int, heads: int = 4, dim_ff: int = 512):
        super().__init__()
        self.MHSA_0 = MHSA(channels, heads)
        self.MHSA_1 = MHSA(channels, heads)
        self.LayerNorm_0 = LayerNorm(channels)
        self.Dense_0 = Dense(channels, dim_ff)
        self.Dense_1 = Dense(dim_ff, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(self.MHSA_0(x) + self.MHSA_1(x))
        return x + self.Dense_1(gelu(self.Dense_0(y)))


class HSFLayer(nn.Module):
    """conv -> relu -> (conv -> relu) x (layers-2) -> conv, all k-wide."""

    def __init__(self, channels: int, hidden: int | None = None,
                 layers: int = 3, kernel_size: int = 3):
        super().__init__()
        hid = hidden or channels
        n_mid = max(0, layers - 2)
        dims = [(channels, hid)] + [(hid, hid)] * n_mid + [(hid, channels)]
        for i, (cin, cout) in enumerate(dims):
            setattr(self, f"Conv1d_{i}", Conv1d(cin, cout, kernel_size))
        self.n_convs = len(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = getattr(self, f"Conv1d_{i}")(x)
            if i < self.n_convs - 1:
                x = torch.relu(x)
        return x


class HarmonicSourceFilter(nn.Module):
    """Harmonic (k=3) and noise (k=5) conv branches over a mel [B, T, C],
    blended by a sigmoid gate of the harmonic branch."""

    def __init__(self, channels: int = 80, filt_ch: int = 64):
        super().__init__()
        self.Conv1d_0 = Conv1d(channels, filt_ch, 3)
        self.Conv1d_1 = Conv1d(filt_ch, channels, 3)
        self.Conv1d_2 = Conv1d(channels, filt_ch, 5)
        self.Conv1d_3 = Conv1d(filt_ch, channels, 5)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = self.Conv1d_1(torch.relu(self.Conv1d_0(mel)))
        n = self.Conv1d_3(torch.relu(self.Conv1d_2(mel)))
        gate = torch.sigmoid(h)
        return h * gate + n * (1.0 - gate)
