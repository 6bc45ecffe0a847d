"""Stage 1, the speaker-embedding reference encoder
(``ttsx/models/reference_encoder.py``): a mel or feature sequence
[B, T, F] (with an optional [B, T] mask of valid frames) -> a unit-norm
speaker embedding [B, speaker_dim].

Backbones: ``ecapa_tdnn`` (a stem conv, three dilated SE-Res2Net blocks
whose squeeze-excitation averages the valid frames only, and the
multi-layer aggregation), ``res2net``, ``conformer`` and ``ssl_host``
(a projection of features computed elsewhere). Then one of the three
poolings, the projection MLP with a LayerNorm, and the division by the
norm floored at 1e-8. Padded frames are zeroed first. Submodules carry
flax's automatic names (``Conv1d_0``, ``SERes2NetBlock_1``, ...), which
depend on the backbone and pooling, so that ``weights.from_flax`` finds
every leaf.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch import nn

from ttsx_torch.core.config import RefEncConfig
from ttsx_torch.nn.conformer import ConformerLayer
from ttsx_torch.nn.conv import Conv1d
from ttsx_torch.nn.layers import Dense, LayerNorm
from ttsx_torch.nn.pooling import (MultiHeadAttentivePooling,
                                   SelfAttentivePooling, StatsPooling,
                                   masked_mean)


class _Named(nn.Module):
    """Adds submodules under flax's names (the type's name and a count)
    and keeps them by role in ``parts``, a plain dict (a module attribute
    would register each twice)."""

    def __init__(self):
        super().__init__()
        self._count = Counter()
        self.parts = {}

    def add(self, kind: str, module: nn.Module, role: str = "") -> nn.Module:
        name = f"{kind}_{self._count[kind]}"
        self._count[kind] += 1
        self.add_module(name, module)
        if role:
            self.parts[role] = module
        return module


class Res2NetBlock(_Named):
    """x + concat(x_0, y_1, ..., y_{s-1}) with y_i = relu(conv(x_i + y_{i-1}))
    over ``scale`` channel groups of x [B, T, C]."""

    def __init__(self, channels: int, scale: int = 4, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        if channels % scale:
            raise ValueError(f"{channels} channels in {scale} groups")
        self.scale = scale
        w = channels // scale
        self.convs = [self.add("Conv1d", Conv1d(w, w, kernel_size,
                                                dilation=dilation))
                      for _ in range(scale - 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = x.chunk(self.scale, dim=-1)
        outs, y = [parts[0]], None
        for part, conv in zip(parts[1:], self.convs):
            y = torch.relu(conv(part if y is None else part + y))
            outs.append(y)
        return x + torch.cat(outs, dim=-1)


class SERes2NetBlock(nn.Module):
    """The ECAPA-TDNN layer: 1x1 conv, dilated Res2Net, 1x1 conv, and a
    squeeze-excitation over the valid frames' mean."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, scale: int = 8):
        super().__init__()
        self.Conv1d_0 = Conv1d(channels, channels, 1)
        self.LayerNorm_0 = LayerNorm(channels)
        self.Res2NetBlock_0 = Res2NetBlock(channels, scale, kernel_size,
                                           dilation)
        self.Conv1d_1 = Conv1d(channels, channels, 1)
        self.LayerNorm_1 = LayerNorm(channels)
        self.Dense_0 = Dense(channels, channels // 4)
        self.Dense_1 = Dense(channels // 4, channels)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        y = torch.relu(self.LayerNorm_0(self.Conv1d_0(x)))
        y = self.Res2NetBlock_0(y)
        y = torch.relu(self.LayerNorm_1(self.Conv1d_1(y)))
        s = torch.relu(self.Dense_0(masked_mean(y, mask)))
        s = torch.sigmoid(self.Dense_1(s))
        return x + y * s[:, None, :]


BACKBONES = ("ecapa_tdnn", "res2net", "conformer", "ssl_host")
POOLINGS = ("self_attentive", "multi_head_attentive", "stats")


class ReferenceEncoder(_Named):
    def __init__(self, cfg: RefEncConfig = RefEncConfig()):
        super().__init__()
        if cfg.backbone not in BACKBONES:
            raise ValueError(f"Unknown backbone '{cfg.backbone}'")
        if cfg.pooling not in POOLINGS:
            raise ValueError(f"Unknown pooling '{cfg.pooling}'")
        self.cfg = cfg
        D, F = cfg.speaker_dim, cfg.audio.n_mels
        add = self.add
        self.layers = []
        if cfg.backbone == "ecapa_tdnn":
            ch = cfg.ecapa_channels
            add("Conv1d", Conv1d(F, ch, 5), "stem")
            add("LayerNorm", LayerNorm(ch), "stem_norm")
            self.layers = [add("SERes2NetBlock",
                               SERes2NetBlock(ch, 3, dilation=d))
                           for d in (2, 3, 4)]
            add("Conv1d", Conv1d(3 * ch, D, 1), "mfa")
        elif cfg.backbone == "res2net":
            add("Conv1d", Conv1d(F, 64, 3), "stem")
            add("LayerNorm", LayerNorm(64), "stem_norm")
            add("Res2NetBlock", Res2NetBlock(64, scale=4), "res2net")
            add("Conv1d", Conv1d(64, D, 1), "proj")
        else:
            add("Dense", Dense(F, D), "proj")
            if cfg.backbone == "conformer":
                self.layers = [add("ConformerLayer", ConformerLayer(
                    D, cfg.conformer_heads, cfg.conformer_ff,
                    dropout=cfg.dropout)) for _ in range(cfg.conformer_layers)]
        if cfg.pooling == "self_attentive":
            add("SelfAttentivePooling", SelfAttentivePooling(D), "pool")
        elif cfg.pooling == "multi_head_attentive":
            add("MultiHeadAttentivePooling", MultiHeadAttentivePooling(
                D, D, heads=cfg.pooling_heads), "pool")
        else:
            add("StatsPooling", StatsPooling(), "pool")
            add("Dense", Dense(2 * D, D), "stats_proj")
        add("Dense", Dense(D, D), "mlp_in")
        add("LayerNorm", LayerNorm(D), "mlp_norm")
        add("Dense", Dense(D, D), "mlp_out")

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x [B, T, F], mask [B, T] of valid frames -> [B, speaker_dim]."""
        p, backbone = self.parts, self.cfg.backbone
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        if backbone == "ecapa_tdnn":
            h = torch.relu(p["stem_norm"](p["stem"](x)))
            hs = []
            for layer in self.layers:
                h = layer(h, mask)
                hs.append(h)
            h = torch.relu(p["mfa"](torch.cat(hs, dim=-1)))
        elif backbone == "res2net":
            h = p["proj"](p["res2net"](torch.relu(p["stem_norm"](
                p["stem"](x)))))
        else:
            h = p["proj"](x)
            for layer in self.layers:
                h = layer(h)
        e = p["pool"](h, mask)
        if "stats_proj" in p:
            e = p["stats_proj"](e)
        e = p["mlp_out"](torch.relu(p["mlp_norm"](p["mlp_in"](e))))
        return e / torch.linalg.vector_norm(e, dim=-1,
                                            keepdim=True).clamp_min(1e-8)
