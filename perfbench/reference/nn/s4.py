"""Multi-head diagonal S4 layer: a frozen copy of ``ttsx_torch/nn/s4.py``.

The depthwise long convolution is the causal (or centred) convolution of
h with the materialized decay kernel, computed spectrally with
``torch.fft`` in float32, whatever ``kernel_mode`` names: the
recurrence that kernel K4 (``"pallas"``) and ``scan_dw_conv``
(``"scan"``) run is the same linear map, so this is K4's plain maths. A
training forward (``draws`` given) drops out the gated branch and, with
one mask per (batch, channel) shared over time, the low-rank residual.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from perfbench.reference.core.config import S4Config
from perfbench.reference.nn.conv import Conv1d
from perfbench.reference.nn.draws import Draws, dropout
from perfbench.reference.nn.layers import (GroupNorm, LayerNorm, matmul, promote_dtype,
                                  silu)

KERNEL_MODES = ("auto", "fft", "scan", "pallas")


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def ssm_kernel(a_diag: torch.Tensor, b: torch.Tensor, c_full: torch.Tensor,
               length: int) -> torch.Tensor:
    """a_diag [H, d], b [H, d], c_full [H, d, e] -> K [H*e, L] with
    K[(h, e), s] = sum_d exp(clip(a[h, d] * s)) * b[h, d] * c[h, d, e]."""
    t = torch.arange(length, dtype=torch.float32, device=a_diag.device)
    decay = torch.exp(torch.clamp(a_diag[:, None, :] * t[None, :, None],
                                  -50.0, 50.0))
    k = torch.einsum("htd,hde->hte",
                     *promote_dtype(decay * b[:, None, :], c_full))
    h, L, e = k.shape
    return k.permute(0, 2, 1).reshape(h * e, L)


def fft_dw_conv(x: torch.Tensor, w: torch.Tensor, causal: bool) -> torch.Tensor:
    """Depthwise long convolution via rFFT: x [B, T, C], w [C, L],
    transformed in float32; the result in x's dtype."""
    T = x.shape[1]
    L = w.shape[-1]
    n = _next_pow2(T + L - 1)
    xf = torch.fft.rfft(x.float(), n=n, dim=1)
    kf = torch.fft.rfft(w.float(), n=n, dim=-1)
    y = torch.fft.irfft(xf * kf.T[None], n=n, dim=1)
    s = 0 if causal else (L - 1) // 2
    return y[:, s:s + T].to(x.dtype)


class S4(nn.Module):
    def __init__(self, d_model: int, cfg: S4Config = S4Config()):
        super().__init__()
        if cfg.kernel_mode not in KERNEL_MODES:
            raise ValueError(f"S4 kernel_mode {cfg.kernel_mode!r} is not one "
                             f"of {KERNEL_MODES}")
        if cfg.kernel_mode in ("scan", "pallas") and not cfg.causal:
            raise ValueError(f"{cfg.kernel_mode} kernel path is causal-only")
        H, r = cfg.heads, cfg.rank
        if d_model % H:
            raise ValueError("d_model must be divisible by heads")
        d = d_model // H
        self.cfg, self.d = cfg, d
        a_row = -np.linspace(1.0, d, d, dtype=np.float32) / d
        self.register_buffer("a_diag", torch.from_numpy(np.tile(a_row, (H, 1))),
                             persistent=False)
        self.C1 = nn.Parameter(torch.randn(H, d, r) * 0.02)
        self.C2 = nn.Parameter(torch.randn(H, r, d) * 0.02)
        self.C0 = nn.Parameter(torch.zeros(H, d))
        self.U = nn.Parameter(torch.randn(H, d, r) * d ** -0.5)
        self.V = nn.Parameter(torch.randn(H, d, r) * d ** -0.5)
        self.pos_bias = nn.Parameter(torch.zeros(H, cfg.l_max))
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Conv1d_0 = Conv1d(d_model, d_model, 3, groups=H)
        self.Conv1d_1 = Conv1d(d_model, 2 * d_model, 1)
        self.GroupNorm_0 = GroupNorm(cfg.norm_groups, d_model)

    def c_full(self) -> torch.Tensor:
        """The readout [H, d, e]: C1 @ C2 + diag(C0)."""
        return (torch.einsum("hdr,hre->hde", self.C1, self.C2)
                + torch.diag_embed(self.C0))

    def long_conv(self, h: torch.Tensor) -> torch.Tensor:
        """The depthwise SSM convolution of h [B, T, C]."""
        c_full, b = self.c_full(), torch.ones_like(self.a_diag)
        w = ssm_kernel(self.a_diag, b, c_full, h.shape[1])
        return fft_dw_conv(h, w, self.cfg.causal)

    def forward(self, x: torch.Tensor, draws: Draws | None = None
                ) -> torch.Tensor:
        cfg = self.cfg
        _, T, C = x.shape
        h = self.LayerNorm_0(x)
        y = self.long_conv(h)
        pb = self.pos_bias[:, :T]
        if T > cfg.l_max:
            pb = torch.cat([pb, pb[:, -1:].expand(-1, T - cfg.l_max)], dim=1)
        y = y + pb.repeat_interleave(self.d, dim=0).T[None]
        y = self.Conv1d_0(y)
        a_g, b_g = self.Conv1d_1(y).chunk(2, dim=-1)
        y = dropout(a_g * silu(b_g), cfg.dropout, draws)
        res = matmul(matmul(h, self.V.reshape(C, -1)),
                     self.U.reshape(C, -1).T)
        y = y + dropout(res, cfg.dropout, draws, broadcast_dims=(1,))
        return self.GroupNorm_0(y)
