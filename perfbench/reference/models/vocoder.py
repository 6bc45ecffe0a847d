"""Multi-band GAN vocoder generator: a frozen copy of
``ttsx_torch/models/vocoder.py`` with its kernel routes taken out.

mel [B, T, 80] + prosody [B, T, 18] + style [B, S] + emotion [B, 6]
(+ scale [B, 160] with ``scale_cond``) -> waveform [B, T*256, 1].

The bands fold into the batch (row ``band * B + b``) and run through one
shared tower. Per stage: ConvTranspose upsample, then 3 FiLM residual
blocks (dilations 1, 3, 5); single-head attention after stage 2. The
config's kernel flags (K1 for the upsample, K2 for a stage's blocks, K5
for one block) are read by nothing here: every stage runs its plain
PyTorch maths, the same parameters either way. ``band_tp`` has no mesh
to split over and changes nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from perfbench.reference.core.config import VocoderConfig
from perfbench.reference.nn.attention import SelfAttention1d
from perfbench.reference.nn.conv import Conv1d, ConvTranspose1d
from perfbench.reference.nn.layers import Dense, LayerNorm, leaky_relu, silu
from perfbench.reference.ops.resblock_stack import nearest_rows


class FiLMResidualBlock(nn.Module):
    """leaky_relu -> dilated k=3 conv C->2C -> GLU -> FiLM -> leaky_relu ->
    k=3 conv -> residual; x [nB, T, C], cond [B, Tc, Dc] at any rate."""

    def __init__(self, channels: int, dilation: int, cond_dim: int,
                 use_pallas: bool = False):
        super().__init__()
        self.dilation, self.use_pallas = dilation, use_pallas
        self.Dense_0 = Dense(cond_dim, 2 * channels, zero_init=True)
        self.Conv1d_0 = Conv1d(channels, 2 * channels, 3, dilation=dilation)
        self.Conv1d_1 = Conv1d(channels, channels, 3)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        film = self.Dense_0(cond)[:, nearest_rows(T, cond.shape[1], x.device)]
        scale, shift = film.repeat(B // cond.shape[0], 1, 1).chunk(2, dim=-1)
        a, b = self.Conv1d_0(leaky_relu(x)).chunk(2, dim=-1)
        y = a * torch.sigmoid(b) * (1.0 + scale) + shift
        return x + self.Conv1d_1(leaky_relu(y))


class BandTower(nn.Module):
    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.hidden_dim
        self.attn_at = len(cfg.upsample_factors) // 2
        for i, f in enumerate(cfg.upsample_factors):
            setattr(self, f"up_{i}", ConvTranspose1d(ch, ch // 2, f))
            ch //= 2
            for j, d in enumerate(cfg.res_dilations):
                setattr(self, f"res_{i}_{j}",
                        FiLMResidualBlock(ch, d, cfg.cond_dim))
            if i == self.attn_at:
                setattr(self, f"attn_{i}", SelfAttention1d(ch))

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        for i, f in enumerate(cfg.upsample_factors):
            up = getattr(self, f"up_{i}")
            x = up(x)
            blocks = [getattr(self, f"res_{i}_{j}")
                      for j in range(len(cfg.res_dilations))]
            if cfg.remat and torch.is_grad_enabled():
                for blk in blocks:
                    x = checkpoint(blk, x, cond, use_reentrant=False)
            else:
                for blk in blocks:
                    x = blk(x, cond)
            if i == self.attn_at:
                x = getattr(self, f"attn_{i}")(x)
        return x

class _Tower(nn.Module):
    def __init__(self, cfg: VocoderConfig, band_size: int):
        super().__init__()
        self.band_stem = Conv1d(band_size, cfg.hidden_dim, 7)
        self.tower = BandTower(cfg)

    def forward(self, bands, cond):
        return self.tower(self.band_stem(bands), cond)


class Generator(nn.Module):
    def __init__(self, cfg: VocoderConfig = VocoderConfig(),
                 prosody_dim: int = 18, emotion_dim: int = 6):
        super().__init__()
        self.cfg = cfg
        self.Dense_0 = Dense(prosody_dim, cfg.cond_dim // 2)
        self.Dense_1 = Dense(cfg.cond_dim // 2, cfg.cond_dim)
        self.style_proj = Dense(cfg.style_dim, cfg.cond_dim)
        self.emotion_proj = Dense(emotion_dim, cfg.cond_dim)
        if cfg.scale_cond:
            self.scale_proj = Dense(2 * cfg.channels, cfg.cond_dim,
                                    zero_init=True)
        self.cond_norm = LayerNorm(cfg.cond_dim)
        self.band_tower = _Tower(cfg, cfg.channels // cfg.num_bands)
        ch_out = cfg.hidden_dim >> len(cfg.upsample_factors)
        self.band_merge = Conv1d(cfg.num_bands * ch_out, 1, 7)

    @property
    def hop(self) -> int:
        return math.prod(self.cfg.upsample_factors)

    def forward(self, mel, prosody, style, emotion,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        B, T, C = mel.shape
        nb = cfg.num_bands
        cond = (self.Dense_1(silu(self.Dense_0(prosody)))
                + self.style_proj(style)[:, None]
                + self.emotion_proj(emotion)[:, None])
        if cfg.scale_cond:
            if scale is None:
                scale = mel.new_zeros(B, 2 * C)
            cond = cond + self.scale_proj(scale)[:, None]
        cond = self.cond_norm(cond)
        bands = mel.reshape(B, T, nb, C // nb).permute(2, 0, 1, 3)
        h = self.band_tower(bands.reshape(-1, T, C // nb), cond)
        ch = h.shape[-1]
        h = (h.reshape(nb, B, T * self.hop, ch).permute(1, 2, 0, 3)
             .reshape(B, T * self.hop, nb * ch))
        return torch.tanh(self.band_merge(h))
