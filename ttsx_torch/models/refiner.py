"""Score-SDE mel refiner (``ttsx/models/refiner.py``).

mel0 [B, T, 80] + prosody [B, T, 18] + style_id [B] + text_emb [B, T, Dt]
-> RefinerOutput(mel_ref, score, mel_vq, vq_loss). At inference t = 0.5.
Each mel band runs a U-stack of S4 / MoE / TFBlock (levels deep) with
long skips; the HSF correction is scaled by the learned beta(t); the
residual VQ runs beside the continuous path as the discrete-code head.
A training forward (``draws`` given) runs the S4 dropouts, the Gumbel
gates and their dropout, and advances the VQ's EMA codebooks in place.
``sde_sample`` is the reverse-SDE sampler around the refiner.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from ttsx_torch.core.config import RefinerConfig
from ttsx_torch.core.mesh import global_rows
from ttsx_torch.nn.conv import Conv1d
from ttsx_torch.nn.draws import Draws
from ttsx_torch.nn.embed import sinusoidal_table
from ttsx_torch.nn.layers import Dense, Embed, gelu, silu
from ttsx_torch.nn.moe import GumbelMoE
from ttsx_torch.nn.s4 import S4
from ttsx_torch.nn.tf_block import HSFLayer, TFBlock
from ttsx_torch.nn.vq import HierVQ


class RefinerOutput(NamedTuple):
    mel_ref: torch.Tensor   # [B, T, 80] refined mel
    score: torch.Tensor     # [B, T, 80] correction mel_ref - mel0
    mel_vq: torch.Tensor    # [B, T, 80] discrete-code reconstruction
    vq_loss: Optional[torch.Tensor] = None  # commitment loss (scalar)


class BetaScheduler(nn.Module):
    def __init__(self, hidden: int = 64):
        super().__init__()
        self.Dense_0 = Dense(1, hidden)
        self.Dense_1 = Dense(hidden, 1)

    def forward(self, t):
        return torch.sigmoid(self.Dense_1(gelu(self.Dense_0(t))))


class BandNet(nn.Module):
    """Per-band U-stack over [B, T, band + cond]."""

    def __init__(self, cfg: RefinerConfig, in_ch: int, band_size: int):
        super().__init__()
        self.levels = cfg.levels
        ch = in_ch
        for lvl in range(cfg.levels):
            setattr(self, f"down_s4_{lvl}", S4(ch, cfg.s4))
            setattr(self, f"down_moe_{lvl}",
                    GumbelMoE(ch, 2 * ch, style_dim=cfg.style_dim))
            ch *= 2
            setattr(self, f"down_tf_{lvl}",
                    TFBlock(ch, heads=cfg.s4.heads, dim_ff=cfg.cond_dim))
        skip_chs = [in_ch * 2 ** (lvl + 1) for lvl in range(cfg.levels)]
        self.mid_s4 = S4(ch, cfg.s4)
        for lvl in range(cfg.levels):
            setattr(self, f"up_proj_{lvl}", Dense(ch, ch // 2))
            ch //= 2
            setattr(self, f"skip_proj_{lvl}",
                    Dense(skip_chs[cfg.levels - 1 - lvl], ch))
            setattr(self, f"up_tf_{lvl}",
                    TFBlock(ch, heads=cfg.s4.heads, dim_ff=cfg.cond_dim))
            setattr(self, f"up_s4_{lvl}", S4(ch, cfg.s4))
        self.band_out = Conv1d(ch + in_ch, band_size, 3, zero_init=True)

    def forward(self, y, style, draws: Draws | None = None):
        band_in = y
        skips = []
        for lvl in range(self.levels):
            y = getattr(self, f"down_s4_{lvl}")(y, draws)
            y = getattr(self, f"down_moe_{lvl}")(y, style, draws)
            y = getattr(self, f"down_tf_{lvl}")(y)
            skips.append(y)
        y = self.mid_s4(y, draws)
        for lvl in range(self.levels):
            y = getattr(self, f"up_proj_{lvl}")(y)
            y = y + getattr(self, f"skip_proj_{lvl}")(
                skips[self.levels - 1 - lvl])
            y = getattr(self, f"up_tf_{lvl}")(y)
            y = getattr(self, f"up_s4_{lvl}")(y, draws)
        return self.band_out(torch.cat([y, band_in], dim=-1))


class ScoreSDERefiner(nn.Module):
    def __init__(self, cfg: RefinerConfig = RefinerConfig(),
                 text_emb_dim: int = 384, prosody_dim: int = 18):
        super().__init__()
        self.cfg = cfg
        self.BetaScheduler_0 = BetaScheduler(cfg.beta_hidden)
        self.Dense_0 = Dense(prosody_dim, cfg.cond_dim // 2)
        self.Dense_1 = Dense(cfg.cond_dim // 2, cfg.cond_dim)
        self.style_embedding = Embed(cfg.num_styles, cfg.style_dim)
        self.style_proj = Dense(cfg.style_dim, cfg.cond_dim)
        self.seg_proj = Dense(text_emb_dim, cfg.cond_dim)
        for i, bsz in enumerate(cfg.bands):
            setattr(self, f"pe_proj_{i}", Dense(bsz * cfg.cond_dim, cfg.cond_dim))
            setattr(self, f"band_{i}", BandNet(cfg, bsz + cfg.cond_dim, bsz))
        self.hsf = HSFLayer(cfg.cnf_dim, cfg.hsf_hidden, cfg.hsf_layers,
                            cfg.hsf_kernel)
        self.vq = HierVQ(cfg.vq_dims, cfg.vq_codes)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(cfg.cnf_dim, cfg.cond_dim)),
            persistent=False)

    def forward(self, mel0, prosody, style_id, text_emb,
                t: Optional[torch.Tensor] = None,
                draws: Draws | None = None) -> RefinerOutput:
        cfg = self.cfg
        B, T, C = mel0.shape
        if C != cfg.cnf_dim:
            raise ValueError(f"mel has {C} channels, expected {cfg.cnf_dim}")
        if t is None:
            t = (mel0.new_full((B, 1), 0.5) if draws is None
                 else draws.uniform((B, 1)))
        beta = self.BetaScheduler_0(t)                          # [B, 1]
        c_pros = self.Dense_1(silu(self.Dense_0(prosody)))
        style = self.style_embedding(style_id)
        cond = (c_pros + self.style_proj(style)[:, None]
                + self.seg_proj(text_emb.mean(dim=1))[:, None])
        pe = self.pe.to(mel0.dtype)       # as the reference casts it
        outs, offset = [], 0
        for i, bsz in enumerate(cfg.bands):
            band = mel0[..., offset:offset + bsz]
            pe_tok = getattr(self, f"pe_proj_{i}")(
                pe[offset:offset + bsz].reshape(-1))
            y = torch.cat([band, pe_tok + cond], dim=-1)
            outs.append(getattr(self, f"band_{i}")(y, style, draws))
            offset += bsz
        merged = torch.cat(outs, dim=-1)
        delta = merged + beta[:, :, None] * self.hsf(merged)
        dq, vq_loss = self.vq.quantize(delta, train=draws is not None)
        return RefinerOutput(mel_ref=mel0 + delta, score=delta,
                             mel_vq=mel0 + dq, vq_loss=vq_loss)


def sde_sample(refiner: ScoreSDERefiner, mel0: torch.Tensor,
               prosody: torch.Tensor, style_id: torch.Tensor,
               text_emb: torch.Tensor, steps: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """Euler-Maruyama reverse-SDE sampling (``ttsx/models/refiner.py``).

    ``steps`` refiner passes (default ``cfg.sde_steps``) from x = mel0:
    at step k, t = 1 - k dt with dt = 1 / steps, and
    ``x += dt * score(x, t) + sigma * sqrt(dt) * eps_k * (1 - (k + 1) dt)``,
    so the last step adds no noise. eps_k is ``noise[k]`` when the caller
    gives the ``steps`` tensors (the tests give the reference's draws),
    else a standard normal draw from ``generator`` on mel0's device; JAX's
    key stream cannot be reproduced. Under a mesh of dp > 1 the draw is
    the global batch's and this rank keeps its rows
    (``core.mesh.global_rows``), so a dp run samples what one process
    would; ``noise`` is then this rank's rows."""
    cfg = refiner.cfg
    steps = steps or cfg.sde_steps
    if noise is not None and len(noise) != steps:
        raise ValueError(f"{len(noise)} noise tensors for {steps} steps")
    dt = 1.0 / steps
    B = mel0.shape[0]
    x = mel0
    for k in range(steps):
        t = mel0.new_full((B, 1), 1.0 - k * dt)
        out = refiner(x, prosody, style_id, text_emb, t=t)
        eps = (noise[k].to(x) if noise is not None else global_rows(
            lambda s: torch.randn(s, generator=generator, device=x.device,
                                  dtype=x.dtype), x.shape))
        x = x + dt * out.score + cfg.sde_sigma * math.sqrt(dt) * eps * (
            1.0 - (k + 1) * dt)
    return x
