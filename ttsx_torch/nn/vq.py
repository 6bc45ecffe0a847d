"""Residual hierarchical VQ (``ttsx/nn/vq.py``), argmin inference only.

The codebooks live in the ``vq_stats`` collection of the reference as EMA
statistics; the codebook is ``embed_sum / max(cluster_size, eps)``. Both
are buffers here, filled from that collection by ``weights.from_flax``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class VectorQuantizer(nn.Module):
    def __init__(self, dim: int, num_codes: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("embed_sum", torch.randn(num_codes, dim))
        self.register_buffer("cluster_size", torch.ones(num_codes))

    def codebook(self) -> torch.Tensor:
        return self.embed_sum / self.cluster_size.clamp_min(self.eps)[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cb = self.codebook()
        flat = x.reshape(-1, x.shape[-1])
        dist = (flat.square().sum(1, keepdim=True) - 2.0 * flat @ cb.T
                + cb.square().sum(1)[None, :])
        quant = cb[dist.argmin(dim=1)].reshape(x.shape)
        return x + (quant - x)


class HierVQ(nn.Module):
    """Stage k quantizes what stages 1..k-1 missed; returns the summed
    reconstruction (as x + (recon - x), the straight-through value)."""

    def __init__(self, dims: Sequence[int], codes: Sequence[int]):
        super().__init__()
        self.n = len(dims)
        for i, (d, k) in enumerate(zip(dims, codes)):
            setattr(self, f"stage_{i}", VectorQuantizer(d, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual, recon = x, torch.zeros_like(x)
        for i in range(self.n):
            q = getattr(self, f"stage_{i}")(residual)
            recon = recon + q
            residual = residual - q
        return x + (recon - x)
