"""The one-process case of ``ttsx_torch/core/mesh.py``: no mesh is ever
active in the reference, so a draw is the whole batch's and a masked
mean divides by its own mask's sum."""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def active_mesh():
    return None


def global_rows(draw: Callable, shape: Sequence[int], mesh=None
                ) -> torch.Tensor:
    return draw(tuple(shape))


def masked_denominator(mask_sum: torch.Tensor, floor: float = 1.0
                       ) -> torch.Tensor:
    return torch.clamp_min(mask_sum, floor)
