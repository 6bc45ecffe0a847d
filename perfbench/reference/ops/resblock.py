"""K5's and K2's plain maths: one FiLM residual block (a frozen copy of
``ttsx_torch/ops/resblock.py``'s plain version)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.ops.upsample import as_f32



def conv3(h: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """k=3 conv at dilation d with zero padding: taps at t-d, t, t+d;
    w [3, Cin, Cout]."""
    T = h.shape[1]
    hp = F.pad(h, (0, 0, d, d))
    return (hp[:, :T] @ w[0] + hp[:, d:d + T] @ w[1]
            + hp[:, 2 * d:2 * d + T] @ w[2])


def film_resblock_plain(x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        dilation: int) -> torch.Tensor:
    """x, scale, shift [B, T, C]; w1 [3, C, 2C]; b1 [2C]; w2 [3, C, C];
    b2 [C] -> x + conv3(lrelu(glu(conv3_d(lrelu(x))) * (1 + scale) +
    shift)), computed on the operands cast as the kernel casts them
    (``as_f32``) and returned in x's dtype."""
    dtype = x.dtype
    x, scale, shift, w1, b1, w2, b2 = as_f32(x, scale, shift, w1, b1,
                                                   w2, b2)
    C = x.shape[-1]
    u = conv3(F.leaky_relu(x, 0.1), w1, dilation) + b1
    g = u[..., :C] * torch.sigmoid(u[..., C:])
    g = F.leaky_relu(g * (1.0 + scale) + shift, 0.1)
    return (x + conv3(g, w2, 1) + b2).to(dtype)
