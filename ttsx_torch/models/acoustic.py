"""Acoustic model at inference (``ttsx/models/acoustic.py``).

text_emb [B, T, Dt] + prosody [B, T, 18] + emotion [B, 6] + speaker
[B, Ds] -> mel [B, T, 80], duration, pitch, energy [B, T]. The diffusion
decoder runs once at t=0 (at inference its noise-prediction pass is the
same call). ``MelDiscriminator`` only carries the trained discriminator's
parameters so a zoo file loads whole; synthesis never runs it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
import torch.nn.functional as F

from ttsx_torch.core.config import AcousticConfig
from ttsx_torch.nn.conformer import ConformerLayer
from ttsx_torch.nn.conv import Conv1d, ConvTranspose1d
from ttsx_torch.nn.embed import rotary_mix
from ttsx_torch.nn.film import ResidualConvBlock
from ttsx_torch.nn.layers import Dense, Embed


class AcousticOutput(NamedTuple):
    mel: torch.Tensor
    duration: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor


class EmotionEncoder(nn.Module):
    def __init__(self, prosody_dim: int, emotion_dim: int, hidden: int):
        super().__init__()
        self.Dense_0 = Dense(prosody_dim, hidden)
        self.Dense_1 = Dense(emotion_dim, hidden)
        self.Dense_2 = Dense(2 * hidden, hidden)
        self.Dense_3 = Dense(hidden, hidden)
        self.intensity = nn.Parameter(torch.ones(1))

    def forward(self, prosody, emotion):
        p = torch.relu(self.Dense_0(prosody))
        e = torch.relu(self.Dense_1(emotion))[:, None].expand_as(p)
        h = torch.relu(self.Dense_2(torch.cat([p, e], dim=-1)))
        return F.silu(self.Dense_3(h)) * self.intensity


class VarianceAdaptor(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden)
        self.Dense_1 = Dense(hidden, 1)
        self.Dense_2 = Dense(in_dim, 1)
        self.Dense_3 = Dense(in_dim, 1)

    def forward(self, x, cond):
        h = torch.cat([x, cond], dim=-1)
        duration = F.softplus(self.Dense_1(torch.relu(self.Dense_0(h))))[..., 0]
        return duration, self.Dense_2(h)[..., 0], self.Dense_3(h)[..., 0]


class UNetDiffusion(nn.Module):
    def __init__(self, channels: int, diffusion_steps: int):
        super().__init__()
        self.Embed_0 = Embed(diffusion_steps, channels)
        self.Conv1d_0 = Conv1d(channels, channels, 3)
        self.Conv1d_1 = Conv1d(channels, 2 * channels, 3, stride=2)
        self.ConvTranspose1d_0 = ConvTranspose1d(2 * channels, channels, 2)
        self.Conv1d_2 = Conv1d(channels, channels, 3)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h = x + self.Embed_0(t)[:, None, :]
        h = torch.relu(self.Conv1d_0(h))
        h = torch.relu(self.Conv1d_1(h))
        h = torch.relu(self.ConvTranspose1d_0(h))
        h = torch.relu(self.Conv1d_2(h))
        return h[:, :x.shape[1]]


class MelDiscriminator(nn.Module):
    """Parameter holder of the training-time mel discriminator."""

    def __init__(self, channels: int = 80, periods=(1, 2, 3)):
        super().__init__()
        for i in range(len(periods)):
            setattr(self, f"Conv1d_{2 * i}", Conv1d(channels, channels // 2, 15))
            setattr(self, f"Conv1d_{2 * i + 1}", Conv1d(channels // 2, 1, 15))


class AcousticModel(nn.Module):
    def __init__(self, cfg: AcousticConfig = AcousticConfig()):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_channels
        total_cond = cfg.cond_dim + cfg.emotion_dim + max(cfg.speaker_dim, 0)
        self.EmotionEncoder_0 = EmotionEncoder(cfg.cond_dim, cfg.emotion_dim, H)
        self.Conv1d_0 = Conv1d(cfg.text_emb_dim + H, H, 1)
        for i in range(cfg.conformer_layers):
            setattr(self, f"conformer_{i}", ConformerLayer(
                H, cfg.attention_heads, cfg.transformer_dim, cfg.kernel_size))
        self.VarianceAdaptor_0 = VarianceAdaptor(H + total_cond, H)
        for i in range(cfg.num_layers):
            setattr(self, f"film_{i}", ResidualConvBlock(
                H, total_cond, cfg.kernel_size))
        self.UNetDiffusion_0 = UNetDiffusion(H, cfg.diffusion_steps)
        self.mel_out = Dense(H, cfg.mel_dim)
        self.MelDiscriminator_0 = MelDiscriminator(cfg.mel_dim)

    def forward(self, text_emb, prosody, emotion_probs, speaker=None
                ) -> AcousticOutput:
        cfg = self.cfg
        B, T, _ = text_emb.shape
        emo_emb = self.EmotionEncoder_0(prosody, emotion_probs)
        parts = [prosody]
        if cfg.emotion_dim > 0:
            parts.append(emotion_probs[:, None].expand(B, T, cfg.emotion_dim))
        if cfg.speaker_dim > 0:
            if speaker is None:
                speaker = text_emb.new_zeros(B, cfg.speaker_dim)
            parts.append(speaker[:, None].expand(B, T, cfg.speaker_dim))
        cond = torch.cat(parts, dim=-1)
        h = rotary_mix(self.Conv1d_0(torch.cat([text_emb, emo_emb], dim=-1)))
        for i in range(cfg.conformer_layers):
            h = getattr(self, f"conformer_{i}")(h, pos_emb=h)
        duration, pitch, energy = self.VarianceAdaptor_0(h, cond)
        for i in range(cfg.num_layers):
            h = getattr(self, f"film_{i}")(h, cond)
        t0 = torch.zeros(B, dtype=torch.long, device=h.device)
        mel = self.mel_out(self.UNetDiffusion_0(h, t0))
        return AcousticOutput(mel, duration, pitch, energy)
