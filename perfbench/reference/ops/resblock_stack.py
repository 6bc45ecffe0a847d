"""K2's plain maths: a generator stage's FiLM residual blocks, block by
block (a frozen copy of ``ttsx_torch/ops/resblock_stack.py``'s plain
version)."""
from __future__ import annotations

from typing import Sequence

import torch

from perfbench.reference.ops.upsample import as_f32
from perfbench.reference.ops.resblock import film_resblock_plain



def nearest_rows(t: int, tc: int, device=None) -> torch.Tensor:
    """Row of a [.., tc, ..] conditioning tensor that time step t of t
    steps reads: ``(t * tc) // t`` in integers (never F.interpolate,
    whose float scale can land on other rows)."""
    idx = torch.arange(t, device=device, dtype=torch.int64) * tc // t
    return idx.clamp_(0, tc - 1)


def film_resblock_stack_plain(x: torch.Tensor, film: torch.Tensor,
                         w1s: torch.Tensor, b1s: torch.Tensor,
                         w2s: torch.Tensor, b2s: torch.Tensor,
                         dilations: Sequence[int]) -> torch.Tensor:
    """x [B, T, C]; film [Bf, Tf, 2nC] (scale_i | shift_i per block, at
    any rate Tf, batch Bf dividing B: row b of x reads film b % Bf);
    w1s [n, 3, C, 2C]; b1s [n, 2C]; w2s [n, 3, C, C]; b2s [n, C].
    Computed on the operands cast as the kernel casts them
    (``as_f32``), returned in x's dtype."""
    dtype = x.dtype
    x, film, w1s, b1s, w2s, b2s = as_f32(x, film, w1s, b1s, w2s, b2s)
    B, T, C = x.shape
    Bf, Tf = film.shape[:2]
    rows = nearest_rows(T, Tf, x.device)
    for i, d in enumerate(dilations):
        fi = film[:, :, 2 * i * C:(2 * i + 2) * C][:, rows]
        fi = fi.repeat(B // Bf, 1, 1)
        x = film_resblock_plain(x, fi[..., :C], fi[..., C:], w1s[i], b1s[i],
                                w2s[i], b2s[i], d)
    return x.to(dtype)
