"""Residual hierarchical VQ (``ttsx/nn/vq.py``).

The codebooks live in the ``vq_stats`` collection of the reference as EMA
statistics; the codebook is ``embed_sum / max(cluster_size, eps)``. Both
are buffers here (filled from that collection by ``weights.from_flax``),
so no optimizer ever steps them. ``quantize(x, train=True)`` advances
them in place, as the reference's training forward does: an EMA k-means
step (decay 0.95) on the codes the batch chose, then a restart of every
code whose EMA usage fell below ``dead_thresh`` from a batch row picked
by a prime stride. The quantized value and the 0.25-weighted commitment
loss read the codebook from before the update. As in the reference, the
codebook is formed in the statistics' dtype (bfloat16 once a server has
cast them) and the distances run in float32; the output takes x's dtype.

Under a mesh of dp > 1 (``ttsx_torch.core.mesh``) the statistics are the
global batch's, as under the reference's sharding: the counts and sums
add over dp, and restart row r of the global batch comes from the rank
that holds it, all in one all-reduce.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ttsx_torch.core.mesh import active_mesh


class VectorQuantizer(nn.Module):
    decay = 0.95        # EMA decay of the codebook statistics
    dead_thresh = 0.1   # EMA usage below which a code is restarted

    def __init__(self, dim: int, num_codes: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("embed_sum", torch.randn(num_codes, dim))
        self.register_buffer("cluster_size", torch.ones(num_codes))

    def codebook(self) -> torch.Tensor:
        return self.embed_sum / self.cluster_size.clamp_min(self.eps)[:, None]

    def quantize(self, x: torch.Tensor, train: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [..., C] -> (straight-through quantized x, commitment loss)."""
        with torch.no_grad():
            cb = self.codebook().float()
            flat = x.detach().reshape(-1, x.shape[-1]).float()
            dist = (flat.square().sum(1, keepdim=True) - 2.0 * flat @ cb.T
                    + cb.square().sum(1)[None, :])
            idx = dist.argmin(dim=1)
            quant = cb[idx].reshape(x.shape).to(x.dtype)
            if train:
                self._ema_update(flat, idx)
        commit = (quant - x).square().mean()
        return x + (quant - x).detach(), 0.25 * commit

    def _ema_update(self, flat: torch.Tensor, idx: torch.Tensor) -> None:
        k = self.cluster_size.shape[0]
        onehot = torch.nn.functional.one_hot(idx, k).float()
        counts, sums = onehot.sum(0), onehot.T @ flat
        codes = torch.arange(k, device=flat.device)
        mesh, n = active_mesh(), flat.shape[0]
        if mesh is None or mesh.dp == 1:
            seed = flat[(codes * 7919) % n]
        else:
            rows = (codes * 7919) % (n * mesh.dp)     # global row indices
            own = (rows // n == mesh.dp_rank)[:, None]
            seed = torch.where(own, flat[rows % n], torch.zeros_like(sums))
            stats = mesh.all_reduce(
                torch.cat([counts[:, None], sums, seed], dim=1), "dp")
            counts = stats[:, 0]
            sums, seed = stats[:, 1:].chunk(2, dim=1)
        d = self.decay
        self.cluster_size.mul_(d).add_((1 - d) * counts)
        self.embed_sum.mul_(d).add_((1 - d) * sums)
        dead = self.cluster_size < self.dead_thresh
        self.cluster_size.copy_(torch.where(
            dead, torch.ones_like(self.cluster_size), self.cluster_size))
        self.embed_sum.copy_(torch.where(dead[:, None], seed,
                                         self.embed_sum))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.quantize(x)[0]


class HierVQ(nn.Module):
    """Stage k quantizes what stages 1..k-1 missed; the output is
    x + (summed reconstruction - x) with the gradient of x alone, and the
    loss is the sum of the stages' commitment losses."""

    def __init__(self, dims: Sequence[int], codes: Sequence[int]):
        super().__init__()
        self.n = len(dims)
        for i, (d, k) in enumerate(zip(dims, codes)):
            setattr(self, f"stage_{i}", VectorQuantizer(d, k))

    def quantize(self, x: torch.Tensor, train: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        residual, recon = x, torch.zeros_like(x)
        total = x.new_zeros(())
        for i in range(self.n):
            q, loss = getattr(self, f"stage_{i}").quantize(residual, train)
            recon = recon + q
            residual = residual - q.detach()
            total = total + loss
        return x + (recon - x).detach(), total

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.quantize(x)[0]
