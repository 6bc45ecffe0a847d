"""AdamW with a warmup-cosine schedule and global-norm clipping, with
optax's semantics (``ttsx/train/optim.py``:
``optax.chain(clip_by_global_norm(c), adamw(warmup_cosine, wd))``).

``torch.optim.AdamW`` does optax's ``adamw`` arithmetic (decay on every
parameter, scaled by the rate). What differs is kept here:

* clipping scales by ``max / ||g||`` only when ``||g|| >= max`` (no
  ``+ 1e-6`` in the divisor, unlike ``clip_grad_norm_``);
* a parameter without a gradient is stepped with a zero one (optax
  decays it and its moments), where torch would skip it;
* the schedule is read at the count *before* the update, so the first
  update runs at ``lr(0) = 0`` (the warmup starts at 0).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_scale: float = 0.01) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(total, warmup + 1), lr * final_scale)``."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    alpha = final_scale if lr != 0.0 else 0.0

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * (count / warmup)
        c = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's clip, in place: ``g / ||g|| * max`` when ``||g|| >= max``."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                           max_norm / norm))


class ClippedAdamW:
    """Clip by global norm, then ``torch.optim.AdamW`` at ``schedule(count)``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float = 1e-2,
                 grad_clip: float | None = 1.0):
        self.params = list(params)
        self.schedule, self.grad_clip = schedule, grad_clip
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0),
                                       weight_decay=weight_decay, foreach=True)
        self.count = 0

    @torch.no_grad()
    def step(self) -> float:
        """One update from the parameters' gradients; returns its rate."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip:
            clip_by_global_norm_([p.grad for p in self.params], self.grad_clip)
        lr = self.schedule(self.count)
        self.adamw.param_groups[0]["lr"] = lr
        self.adamw.step()
        self.count += 1
        return lr


def make_optimizer(params, lr: float, warmup_steps: int, total_steps: int,
                   weight_decay: float = 1e-2,
                   grad_clip: float | None = 1.0) -> ClippedAdamW:
    return ClippedAdamW(params, warmup_cosine(lr, warmup_steps, total_steps),
                        weight_decay, grad_clip)
