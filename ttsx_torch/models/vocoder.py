"""Multi-band GAN vocoder generator (``ttsx/models/vocoder.py``).

mel [B, T, 80] + prosody [B, T, 18] + style [B, S] + emotion [B, 6]
(+ scale [B, 160] with ``scale_cond``) -> waveform [B, T*256, 1].

The reference vmaps one shared band tower over the 4 mel bands; here the
bands fold into the batch (row ``band * B + b``) and run through the
tower once. The conditioning stays at the mel rate with batch B; each
stage's FiLM rows are gathered with ``(t * Tc) // T`` and the band fold
reads conditioning row ``b % B``.

Per stage: ConvTranspose upsample, then 3 FiLM residual blocks (dilations
1, 3, 5); single-head attention after stage 2. With
``use_pallas_upsample`` the upsample runs kernel K1 and with
``use_pallas_resblock_stack`` each stage's blocks run as kernel K2 (both
in ``ttsx_torch.ops``); with the flags off everything is plain PyTorch.
A ``FiLMResidualBlock(use_pallas=True)`` runs as kernel K5 (no config
sets it, as in the reference). The parameters are the same either way.
The kernels are forward-only: on the card they raise when a call needs a
gradient, so a generator under training runs with both flags off (the
vocoder train block sees to it). With ``cfg.remat`` and a gradient,
each FiLM residual block is recomputed in the backward pass
(``torch.utils.checkpoint``, as ``nn.remat`` in the reference).

Band tensor parallelism (``cfg.band_tp``): under an active mesh of
tp > 1 (``ttsx_torch.core.mesh``) tp rank t runs bands
[t*nb/tp, (t+1)*nb/tp) through the shared tower, so the kernels run on
its rows only, and the towers' outputs are all-gathered over tp, in band
order, before ``band_merge``; ``num_bands % tp`` must be 0. The gather's
backward hands rank t tp x the gradient of its bands: everything before
it (the tower, the conditioning) then holds tp x its share of the
gradient, ``band_merge`` the whole gradient, and the mean over the ranks
that ``TrainState.apply_gradients`` takes is the unsplit gradient for
both. Without a mesh, or at tp = 1, the flag changes nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ttsx_torch.core.config import VocoderConfig
from ttsx_torch.core.mesh import active_mesh
from ttsx_torch.nn.attention import SelfAttention1d
from ttsx_torch.nn.conv import Conv1d, ConvTranspose1d
from ttsx_torch.nn.layers import Dense, LayerNorm, leaky_relu, silu
from ttsx_torch.ops import convt_upsample, film_resblock, film_resblock_stack
from ttsx_torch.ops.resblock_stack import nearest_rows


class _GatherBands(torch.autograd.Function):
    """All-gather over tp in the forward; tp x this rank's slice of the
    gradient in the backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, h, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(h, "tp")

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return grad.chunk(m.tp)[m.tp_rank] * m.tp, None


class FiLMResidualBlock(nn.Module):
    """leaky_relu -> dilated k=3 conv C->2C -> GLU -> FiLM -> leaky_relu ->
    k=3 conv -> residual; x [nB, T, C], cond [B, Tc, Dc] at any rate.

    With ``use_pallas`` the block runs as kernel K5 (``ops.film_resblock``)
    on the FiLM gathered to x's rate; the parameters are the same."""

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
        if self.use_pallas:
            w1, b1, w2, b2 = (w.contiguous() for w in self.kernel_weights())
            return film_resblock(x.contiguous(), scale.contiguous(),
                                 shift.contiguous(), w1, b1, w2, b2,
                                 self.dilation)
        a, b = self.Conv1d_0(leaky_relu(x)).chunk(2, dim=-1)
        y = a * torch.sigmoid(b) * (1.0 + scale) + shift
        return x + self.Conv1d_1(leaky_relu(y))

    def kernel_weights(self):
        """(w1 [3, C, 2C], b1, w2 [3, C, C], b2) in the kernels' layout."""
        return (self.Conv1d_0.weight.permute(2, 1, 0), self.Conv1d_0.bias,
                self.Conv1d_1.weight.permute(2, 1, 0), self.Conv1d_1.bias)


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
            if cfg.use_pallas_upsample:
                x = convt_upsample(x.contiguous(), up.tap_weight(), up.bias, f)
            else:
                x = up(x)
            blocks = [getattr(self, f"res_{i}_{j}")
                      for j in range(len(cfg.res_dilations))]
            if cfg.use_pallas_resblock_stack:
                x = self._fused_stage(x.contiguous(), cond, blocks)
            elif cfg.remat and torch.is_grad_enabled():
                for blk in blocks:
                    x = checkpoint(blk, x, cond, use_reentrant=False)
            else:
                for blk in blocks:
                    x = blk(x, cond)
            if i == self.attn_at:
                x = getattr(self, f"attn_{i}")(x)
        return x

    def _fused_stage(self, x, cond, blocks):
        film = torch.cat([b.Dense_0(cond) for b in blocks], dim=-1)
        w1s, b1s, w2s, b2s = (torch.stack(ws).contiguous() for ws in
                              zip(*(b.kernel_weights() for b in blocks)))
        return film_resblock_stack(x, film.contiguous(), w1s, b1s, w2s, b2s,
                                   self.cfg.res_dilations)


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
        mesh = active_mesh() if cfg.band_tp else None
        split = mesh is not None and mesh.tp > 1
        if split:
            if nb % mesh.tp:
                raise ValueError(f"band_tp: {nb} bands do not split over "
                                 f"tp={mesh.tp}")
            per = nb // mesh.tp
            bands = bands[mesh.tp_rank * per:(mesh.tp_rank + 1) * per]
        h = self.band_tower(bands.reshape(-1, T, C // nb), cond)
        if split:
            h = _GatherBands.apply(h, mesh)               # [nb*B, T*up, ch]
        ch = h.shape[-1]
        h = (h.reshape(nb, B, T * self.hop, ch).permute(1, 2, 0, 3)
             .reshape(B, T * self.hop, nb * ch))
        return torch.tanh(self.band_merge(h))
